"""One-token linear-attention decode step: CUDA kernel and plain version.

Replaces the TPU kernels ``repro/kernels/decode_step.py::_kernel`` (B4a)
and ``::_kernel_masked`` (B4b) with one CUDA kernel whose ``active`` mask
is optional (``csrc/decode_step.cu``: one thread-block cluster per kv row,
its blocks splitting the row's feature rows). Per kv row, for its G query
heads:

    S' = S + Ψ(k)ᵀ v,   z' = z + Ψ(k),   y_g = (q_g S') / (q_g z' + δ)

The state is updated **in place**: the returned ``s`` and ``z`` are the
tensors that were passed in, as the TPU kernel aliases them through
``input_output_aliases``. Rows with ``active == 0`` write y = 0 and leave
their state bit-identical.

:func:`decode_linear_attention` chooses by the tensors' device: CUDA
tensors launch the kernel (or raise), CPU tensors run
:func:`decode_linear_attention_plain`. Forward only: the closed-form
backward (``_decode_bwd`` in the JAX package) is on no training path and
waits in ROADMAP Queue B under B4.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def decode_linear_attention_plain(qf, kf, v, s, z, active=None, *,
                                  delta: float = 1e-6):
    """Plain PyTorch twin of the kernel, with the same in-place update."""
    y, s2, z2 = ref.decode_linear_attention_ref(qf, kf, v, s, z, active,
                                                delta=delta)
    s.copy_(s2)
    z.copy_(z2)
    return y, s, z


def _check(qf, kf, v, s, z, active):
    if qf.dim() != 2 or kf.dim() != 2 or v.dim() != 2:
        raise ValueError("qf, kf, v must be (rows, feat)")
    bh, m = qf.shape
    bk, dv = v.shape
    if bk == 0 or bh % bk:
        raise ValueError(f"q rows {bh} not divisible by kv rows {bk}")
    if kf.shape != (bk, m) or s.shape != (bk, m, dv) or z.shape != (bk, m):
        raise ValueError(f"shape mismatch: qf {tuple(qf.shape)}, kf "
                         f"{tuple(kf.shape)}, v {tuple(v.shape)}, s "
                         f"{tuple(s.shape)}, z {tuple(z.shape)}")
    if s.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError("decode state s and z must be float32")
    codes = _build.DTYPE_CODES
    if qf.dtype not in codes or kf.dtype != qf.dtype:
        raise TypeError(f"qf/kf must share dtype float32 or bfloat16, got "
                        f"{qf.dtype}, {kf.dtype}")
    if v.dtype not in codes:
        raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
    named = [("qf", qf), ("kf", kf), ("v", v), ("s", s), ("z", z)]
    if active is not None:
        if active.shape != (bk,):
            raise ValueError(f"active shape {tuple(active.shape)} != ({bk},)")
        if active.dtype != torch.int32:
            raise TypeError(f"active must be int32, got {active.dtype}")
        named.append(("active", active))
    for name, t in named:
        if t.device != qf.device:
            raise ValueError(f"{name} is on {t.device}, qf on {qf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                "decode_linear_attention is forward-only: its autograd "
                "backward (_decode_bwd in the JAX package) is on no training "
                "path and is queued in ROADMAP Queue B under B4")


def _launch(qf, kf, v, s, z, active, delta):
    bh, m = qf.shape
    bk, dv = v.shape
    if dv not in (16, 32, 64, 128):
        raise ValueError(f"kernel takes dv in (16, 32, 64, 128), got {dv}")
    if bh // bk > 8:
        raise ValueError(f"kernel takes at most 8 q heads per kv head, "
                         f"got {bh // bk}")
    lib = _build.load("decode_step")
    y = torch.empty(bh, dv, dtype=v.dtype, device=qf.device)
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slay_decode_step(
            qf.data_ptr(), kf.data_ptr(), v.data_ptr(), s.data_ptr(),
            z.data_ptr(), y.data_ptr(),
            None if active is None else active.data_ptr(),
            bk, bh // bk, m, dv, _build.DTYPE_CODES[qf.dtype],
            _build.DTYPE_CODES[v.dtype], delta, stream)
    _build.check(err, "slay_decode_step")
    # B4a and B4b count apart: the masked variant is the pool's.
    _build.LAUNCHES["slay_decode_step" if active is None
                    else "slay_decode_step_masked"] += 1
    return y, s, z


def residency(bk: int, g: int, m: int, dv: int, q_dtype: torch.dtype,
              v_dtype: torch.dtype) -> dict:
    """How K2 sits on the current card at these shapes: its grid (BK kv
    rows x C blocks, one thread-block cluster of C per row), the feature
    rows per block (``tile``), blocks per SM and resident at once (the
    blocks of the clusters that fit, CUDA's occupancy calculator),
    registers and local-memory bytes per thread, shared memory per block.
    Launches nothing."""
    codes = _build.DTYPE_CODES
    return _build.residency("decode_step", "slay_decode_step_occupancy", g,
                            m, dv, codes[q_dtype], codes[v_dtype], grid=(bk,),
                            clustered=True)


def decode_linear_attention(qf: torch.Tensor, kf: torch.Tensor,
                            v: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                            active: torch.Tensor | None = None, *,
                            delta: float = 1e-6):
    """qf (BH, m), kf (BK, m), v (BK, dv), s (BK, m, dv) fp32, z (BK, m)
    fp32 -> (y (BH, dv) in v's dtype, s', z'), s and z updated in place.
    BH must be a multiple of BK (GQA). ``active`` (BK,) int32 masks
    continuous-batching pool rows: inactive rows get y = 0 and keep their
    state bit-identical."""
    _check(qf, kf, v, s, z, active)
    if qf.device.type == "cuda":
        return _launch(qf, kf, v, s, z, active, delta)
    if qf.device.type != "cpu":
        raise ValueError(f"unsupported device {qf.device}")
    return decode_linear_attention_plain(qf, kf, v, s, z, active, delta=delta)
