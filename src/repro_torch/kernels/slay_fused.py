"""Fused causal SLAY attention forward: CUDA kernel and plain version.

Replaces the TPU megakernel ``repro/kernels/slay_fused.py::_fwd_kernel``
(B1). Ψ(q), Ψ(k) are computed on-chip from raw q/k inside the chunked
causal scan and never written to device memory; see
``csrc/slay_fused.cu`` for the design and what bounds it.

:func:`fused_causal_attention` chooses by the tensors' device: CUDA
tensors launch the kernel (or raise), CPU tensors run
:func:`fused_causal_attention_plain`, which repeats the kernel's fp32
arithmetic in PyTorch. There is no fallback from one to the other.

Forward only: the backward kernels (B2, B3) come with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import _build
from repro_torch.kernels.common import causal_mask, feature_statics, features_fwd

SMEM_LIMIT = 232448         # dynamic shared memory one Hopper block may use


def fused_causal_attention_plain(q, k, v, anchors, omegas,
                                 cfg: SlayFeatureConfig, *,
                                 chunk_size: int = 256, delta: float = 1e-6):
    """Plain PyTorch twin of the kernel: q (BH, L, d), k (BK, L, d),
    v (BK, L, dv) -> (y (BH, L, dv) in v's dtype, den (BH, L) fp32)."""
    bh, L, _ = q.shape
    bk, _, dv = v.shape
    g = bh // bk
    st = feature_statics(cfg)
    qf = features_fwd(q, anchors, omegas, st).reshape(bk, g, L, -1)
    kf = features_fwd(k, anchors, omegas, st)            # (bk, L, m)
    vf = v.float()
    m = qf.shape[-1]
    s = torch.zeros(bk, 1, m, dv, device=q.device)
    z = torch.zeros(bk, 1, m, device=q.device)
    ys, dens = [], []
    for c0 in range(0, L, chunk_size):
        q_c = qf[:, :, c0:c0 + chunk_size]                # (bk, g, T, m)
        k_c = kf[:, None, c0:c0 + chunk_size]             # (bk, 1, T, m)
        v_c = vf[:, None, c0:c0 + chunk_size]             # (bk, 1, T, dv)
        scores = causal_mask(q_c @ k_c.transpose(-1, -2))  # (bk, g, T, T)
        num = q_c @ s + scores @ v_c
        den = (q_c @ z[..., None])[..., 0] + scores.sum(-1)
        ys.append((num / (den[..., None] + delta)).to(v.dtype))
        dens.append(den)
        s = s + k_c.transpose(-1, -2) @ v_c
        z = z + k_c.sum(-2)
    y = torch.cat(ys, dim=2).reshape(bh, L, dv)
    return y, torch.cat(dens, dim=2).reshape(bh, L)


def _check(q, k, v, anchors, omegas, cfg: SlayFeatureConfig, chunk_size):
    cfg.check_supported()
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (rows, L, feat)")
    bh, L, d = q.shape
    bk, _, dv = v.shape
    if bk == 0 or bh % bk:
        raise ValueError(f"q rows {bh} not divisible by kv rows {bk}")
    if k.shape != (bk, L, d) or v.shape[1] != L:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d != cfg.head_dim:
        raise ValueError(f"head dim {d} != cfg.head_dim {cfg.head_dim}")
    if anchors.shape != (cfg.num_anchors, d) or omegas.shape != (cfg.num_prf, d):
        raise ValueError("anchors/omegas shape does not match cfg")
    if L % chunk_size:
        raise ValueError(f"L={L} not divisible by chunk={chunk_size}")
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"q/k/v must share dtype float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if anchors.dtype != torch.float32 or omegas.dtype != torch.float32:
        raise TypeError("anchors and omegas must be float32")
    for name, t in (("q", q), ("k", k), ("v", v), ("anchors", anchors),
                    ("omegas", omegas)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                "fused_causal_attention is forward-only: its backward "
                "kernels (B2, B3) come with the training slice")


def _launch(q, k, v, anchors, omegas, cfg: SlayFeatureConfig, delta):
    bh, L, d = q.shape
    bk, _, dv = v.shape
    if dv not in (16, 32, 64, 128):
        raise ValueError(f"kernel takes dv in (16, 32, 64, 128), got {dv}")
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    if R > 8:
        raise ValueError(f"kernel takes at most 8 quadrature nodes, got {R}")
    lib = _build.load("slay_fused")
    smem = lib.slay_fused_smem_bytes(d, dv, P, D, R)
    if smem > SMEM_LIMIT:
        raise ValueError(f"shapes need {smem} B of shared memory per block, "
                         f"more than {SMEM_LIMIT}")
    st = feature_statics(cfg)
    s_nodes = (ctypes.c_double * R)(*st.s_nodes)
    sqrt_w = (ctypes.c_double * R)(*st.sqrt_w)
    y = torch.empty(bh, L, dv, dtype=v.dtype, device=q.device)
    den = torch.empty(bh, L, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slay_fused_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), anchors.data_ptr(),
            omegas.data_ptr(), y.data_ptr(), den.data_ptr(), bh, bk, L, d, dv,
            P, D, R, s_nodes, sqrt_w, delta, _build.DTYPE_CODES[q.dtype],
            stream)
    _build.check(err, "slay_fused_fwd")
    _build.LAUNCHES["slay_fused_fwd"] += 1
    return y, den


def fused_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           anchors: torch.Tensor, omegas: torch.Tensor,
                           cfg: SlayFeatureConfig, *, chunk_size: int = 256,
                           delta: float = 1e-6):
    """q (BH, L, d), k (BK, L, d), v (BK, L, dv) -> (y (BH, L, dv), den
    (BH, L) fp32, δ not added).

    Raw (pre-feature) q/k; Ψ is computed inside the kernel. BH must be a
    multiple of BK (GQA: q row h reads kv row h // G); L must be a multiple
    of ``chunk_size`` — the ``ops`` wrapper zero-pads ragged L. The CUDA
    kernel walks the sequence in 16-token tiles whatever ``chunk_size``
    is; chunking only orders the evaluation, and ``chunk_size`` is kept for
    parity with the JAX API and the plain version.
    """
    _check(q, k, v, anchors, omegas, cfg, chunk_size)
    if q.device.type == "cuda":
        return _launch(q, k, v, anchors, omegas, cfg, delta)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fused_causal_attention_plain(q, k, v, anchors, omegas, cfg,
                                        chunk_size=chunk_size, delta=delta)
