"""Causal linear attention on precomputed features, forward and backward:
CUDA kernels and plain versions.

Replaces the TPU kernels ``repro/kernels/slay_scan.py::_kernel`` (B5),
``::_bwd_q_kernel`` (B6a) and ``::_bwd_kv_kernel`` (B6b) with
``csrc/slay_scan.cu``, the second dispatch of the two-dispatch path: it
reads the Ψq, Ψk that ``feature_map.py`` wrote and runs the chunked
causal scan of the fused kernels without the chain through Ψ. Each kernel
runs one block per (q row, slice of 128 feature columns).

:func:`causal_linear_attention` is differentiable through
:class:`ScanAttention`, the counterpart of the ``_scan`` custom VJP: its
forward runs B5 (whose num and den shares, one per feature slice, its
epilogue kernel sums) and saves (qf, kf, v, y, den); its backward runs
B6a, then B6b (whose dv shares the wrapper sums), then sums B6b's
per-q-head partials over each GQA group. CUDA tensors launch the
kernels (or raise), CPU tensors run the plain versions, which repeat the
kernels' fp32 arithmetic chunk by chunk; there is no fallback from one to
the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (causal_mask, check_residuals,
                                        cotangents, empty_fp32)

_KINDS = {"slay_scan_fwd": 0, "slay_scan_bwd_q": 1, "slay_scan_bwd_kv": 2}


def causal_linear_attention_plain(qf, kf, v, *, chunk_size: int = 256,
                                  delta: float = 1e-6):
    """Plain twin of B5: qf (BH, L, m), kf (BK, L, m), v (BK, L, dv) ->
    (y (BH, L, dv) in v's dtype, den (BH, L) fp32, δ not added)."""
    bh, L, m = qf.shape
    bk, _, dv = v.shape
    g = bh // bk
    q = qf.float().reshape(bk, g, L, m)
    k, vf = kf.float(), v.float()
    s = torch.zeros(bk, 1, m, dv, device=qf.device)
    z = torch.zeros(bk, 1, m, device=qf.device)
    ys, dens = [], []
    for c0 in range(0, L, chunk_size):
        q_c = q[:, :, c0:c0 + chunk_size]                 # (bk, g, T, m)
        k_c = k[:, None, c0:c0 + chunk_size]              # (bk, 1, T, m)
        v_c = vf[:, None, c0:c0 + chunk_size]             # (bk, 1, T, dv)
        scores = causal_mask(q_c @ k_c.transpose(-1, -2))
        num = q_c @ s + scores @ v_c
        den = (q_c @ z[..., None])[..., 0] + scores.sum(-1)
        ys.append((num / (den[..., None] + delta)).to(v.dtype))
        dens.append(den)
        s = s + k_c.transpose(-1, -2) @ v_c
        z = z + k_c.sum(-2)
    y = torch.cat(ys, dim=2).reshape(bh, L, dv)
    return y, torch.cat(dens, dim=2).reshape(bh, L)


def _per_q_head(kf, v, bh):
    """kv rows repeated for each q head of their GQA group, in fp32, as
    the kernels read them (one block per q head)."""
    g = bh // kf.shape[0]
    return kf.float().repeat_interleave(g, 0), v.float().repeat_interleave(g, 0)


def scan_bwd_q_plain(qf, kf, v, y, den, dy, *, chunk_size: int = 256,
                     delta: float = 1e-6):
    """Plain twin of B6a, the forward re-scan: -> dq (BH, L, m) in qf's
    dtype."""
    bh, L, m = qf.shape
    k, vf = _per_q_head(kf, v, bh)
    gg, hh = cotangents(y, den, dy, delta)
    s = torch.zeros(bh, m, vf.shape[-1], device=qf.device)
    z = torch.zeros(bh, m, device=qf.device)
    dqs = []
    for c0 in range(0, L, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        k_c, v_c, g_c, h_c = k[:, sl], vf[:, sl], gg[:, sl], hh[:, sl]
        # dP = tril(G Vᵀ + h 1ᵀ);  dΨq = G Sᵀ + h zᵀ + dP Ψk.
        dp = causal_mask(g_c @ v_c.transpose(-1, -2) + h_c)
        dqs.append(g_c @ s.transpose(-1, -2) + h_c * z[:, None, :]
                   + dp @ k_c)
        s = s + k_c.transpose(-1, -2) @ v_c
        z = z + k_c.sum(-2)
    return torch.cat(dqs, dim=1).to(qf.dtype)


def scan_bwd_kv_plain(qf, kf, v, y, den, dy, *, chunk_size: int = 256,
                      delta: float = 1e-6):
    """Plain twin of B6b, the reverse scan: -> per-q-head partials dk
    (BH, L, m) in kf's dtype and dv (BH, L, dv) in v's dtype."""
    bh, L, m = qf.shape
    q = qf.float()
    k, vf = _per_q_head(kf, v, bh)
    gg, hh = cotangents(y, den, dy, delta)
    ds = torch.zeros(bh, m, vf.shape[-1], device=qf.device)
    dz = torch.zeros(bh, m, device=qf.device)
    dks, dvs = [], []
    for c0 in reversed(range(0, L, chunk_size)):
        sl = slice(c0, c0 + chunk_size)
        q_c, k_c, v_c = q[:, sl], k[:, sl], vf[:, sl]
        g_c, h_c = gg[:, sl], hh[:, sl]
        scores = causal_mask(q_c @ k_c.transpose(-1, -2))
        dp = causal_mask(g_c @ v_c.transpose(-1, -2) + h_c)
        # dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ;  dV = Pᵀ G + Ψk dS.
        dks.append(dp.transpose(-1, -2) @ q_c + v_c @ ds.transpose(-1, -2)
                   + dz[:, None, :])
        dvs.append(scores.transpose(-1, -2) @ g_c + k_c @ ds)
        # Carry the state cotangents to the previous chunk.
        ds = ds + q_c.transpose(-1, -2) @ g_c
        dz = dz + torch.sum(q_c * h_c, dim=-2)
    return (torch.cat(dks[::-1], dim=1).to(kf.dtype),
            torch.cat(dvs[::-1], dim=1).to(v.dtype))


def _reduce(kf, v, dq, dk_p, dv_p):
    """Sum B6b's per-q-head partials over each GQA group, as
    ``_bwd_impl`` does."""
    bh, L, _ = dk_p.shape
    bk = kf.shape[0]
    dk = dk_p.reshape(bk, bh // bk, L, -1).sum(1).to(kf.dtype)
    dv = dv_p.reshape(bk, bh // bk, L, -1).sum(1).to(v.dtype)
    return dq, dk, dv


def causal_linear_attention_bwd_plain(qf, kf, v, y, den, dy, *,
                                      chunk_size: int = 256,
                                      delta: float = 1e-6):
    """Plain backward: -> (dq, dk, dv), the two scans' fp32 arithmetic
    chunk by chunk. The CPU path and the tests use it."""
    kw = dict(chunk_size=chunk_size, delta=delta)
    args = (qf, kf, v, y, den, dy)
    return _reduce(kf, v, scan_bwd_q_plain(*args, **kw),
                   *scan_bwd_kv_plain(*args, **kw))


def _check(qf, kf, v, chunk_size):
    if qf.dim() != 3 or kf.dim() != 3 or v.dim() != 3:
        raise ValueError("qf, kf, v must be (rows, L, feat)")
    bh, L, m = qf.shape
    bk = v.shape[0]
    if bk == 0 or bh % bk:
        raise ValueError(f"q rows {bh} not divisible by kv rows {bk}")
    if kf.shape != (bk, L, m) or v.shape[1] != L:
        raise ValueError(f"shape mismatch: qf {tuple(qf.shape)}, "
                         f"kf {tuple(kf.shape)}, v {tuple(v.shape)}")
    if L % chunk_size:
        raise ValueError(f"L={L} not divisible by chunk={chunk_size}")
    if (qf.dtype not in _build.DTYPE_CODES or kf.dtype != qf.dtype
            or v.dtype != qf.dtype):
        raise TypeError(f"qf/kf/v must share dtype float32 or bfloat16, got "
                        f"{qf.dtype}, {kf.dtype}, {v.dtype}")
    for name, t in (("qf", qf), ("kf", kf), ("v", v)):
        if t.device != qf.device:
            raise ValueError(f"{name} is on {t.device}, qf on {qf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn, ptrs, qf, v, delta):
    """Launch kernel ``fn`` with its pointer arguments after the host-side
    checks of its shapes and shared memory."""
    bh, L, m = qf.shape
    bk, _, dv = v.shape
    if dv not in (16, 32, 64, 128):
        raise ValueError(f"kernel takes dv in (16, 32, 64, 128), got {dv}")
    lib = _build.load("slay_scan")
    smem = lib.slay_scan_smem_bytes(m, dv, _KINDS[fn])
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"shapes need {smem} B of shared memory per block, "
                         f"more than {_build.SMEM_LIMIT}")
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*ptrs, bh, bk, L, m, dv, delta,
                               _build.DTYPE_CODES[qf.dtype], stream)
    _build.check(err, fn)
    _build.LAUNCHES[fn] += 1


def launch_fwd(qf, kf, v, delta: float = 1e-6):
    """B5 on CUDA tensors: -> (y, den), as
    :func:`causal_linear_attention_plain`. The C entry launches B5 on a
    BH x C grid, which writes each feature slice's fp32 share of num and
    den into scratch allocated here, then the epilogue kernel, which sums
    the shares and divides: one launch counted."""
    bh, L, m = qf.shape
    dv = v.shape[-1]
    slices = _build.load("slay_scan").slay_scan_slices(m)
    y = torch.empty(bh, L, dv, dtype=v.dtype, device=qf.device)
    den = empty_fp32(bh, L, like=qf)
    num_part = empty_fp32(slices, bh, L, dv, like=qf)
    den_part = empty_fp32(slices, bh, L, like=qf)
    ptrs = (qf.data_ptr(), kf.data_ptr(), v.data_ptr(), y.data_ptr(),
            den.data_ptr(), num_part.data_ptr(), den_part.data_ptr())
    _launch("slay_scan_fwd", ptrs, qf, v, delta)
    return y, den


def _res_ptrs(qf, kf, v, y, den, dy):
    return (qf.data_ptr(), kf.data_ptr(), v.data_ptr(), dy.data_ptr(),
            y.data_ptr(), den.data_ptr())


def launch_bwd_q(qf, kf, v, y, den, dy, delta: float = 1e-6):
    """B6a on CUDA tensors: -> dq, as :func:`scan_bwd_q_plain`."""
    dq = torch.empty_like(qf)
    _launch("slay_scan_bwd_q",
            (*_res_ptrs(qf, kf, v, y, den, dy), dq.data_ptr()), qf, v, delta)
    return dq


def launch_bwd_kv(qf, kf, v, y, den, dy, delta: float = 1e-6):
    """B6b on CUDA tensors: -> per-q-head (dk, dv) partials, as
    :func:`scan_bwd_kv_plain`. The kernel writes dk's columns slice by
    slice in qf's dtype and one fp32 share of dv per feature slice; their
    sum over that axis (``torch.sum``, no atomics) is rounded once to v's
    dtype."""
    bh, L, m = qf.shape
    slices = _build.load("slay_scan").slay_scan_slices(m)
    dk = torch.empty(bh, L, m, dtype=kf.dtype, device=qf.device)
    dv = empty_fp32(slices, bh, L, v.shape[-1], like=qf)
    _launch("slay_scan_bwd_kv",
            (*_res_ptrs(qf, kf, v, y, den, dy), dk.data_ptr(), dv.data_ptr()),
            qf, v, delta)
    return dk, dv.sum(0).to(v.dtype)


def residency(fn: str, bh: int, m: int, dv: int,
              dtype: torch.dtype) -> dict:
    """How kernel ``fn`` (``"slay_scan_fwd"``, ``"slay_scan_bwd_q"`` or
    ``"slay_scan_bwd_kv"``: B5, B6a, B6b) sits on the current card at
    these shapes (its grid is BH x C blocks, C feature slices), as
    :func:`repro_torch.kernels._build.residency` reports. Launches
    nothing."""
    lib = _build.load("slay_scan")
    return _build.residency(
        "slay_scan", "slay_scan_occupancy", _KINDS[fn], m, dv,
        _build.DTYPE_CODES[dtype], grid=(bh, lib.slay_scan_slices(m)))


def causal_linear_attention_bwd(qf, kf, v, y, den, dy, *,
                                chunk_size: int = 256, delta: float = 1e-6):
    """Backward of :func:`causal_linear_attention` from its residuals:
    -> (dq, dk, dv). CUDA tensors run B6a then B6b and the GQA sum, CPU
    tensors the plain version."""
    _check(qf, kf, v, chunk_size)
    check_residuals(qf, v, y, den, dy)
    if qf.device.type == "cuda":
        args = (qf, kf, v, y, den, dy, delta)
        return _reduce(kf, v, launch_bwd_q(*args), *launch_bwd_kv(*args))
    if qf.device.type != "cpu":
        raise ValueError(f"unsupported device {qf.device}")
    return causal_linear_attention_bwd_plain(qf, kf, v, y, den, dy,
                                             chunk_size=chunk_size,
                                             delta=delta)


class ScanAttention(torch.autograd.Function):
    """The ``_scan`` custom VJP of the JAX package: the forward runs B5
    (the plain forward on the CPU) and saves (qf, kf, v, y, den); the
    backward runs B6a and B6b (the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, qf, kf, v, chunk_size, delta):
        if qf.device.type == "cuda":
            y, den = launch_fwd(qf, kf, v, delta)
        elif qf.device.type == "cpu":
            y, den = causal_linear_attention_plain(
                qf, kf, v, chunk_size=chunk_size, delta=delta)
        else:
            raise ValueError(f"unsupported device {qf.device}")
        ctx.save_for_backward(qf, kf, v, y, den)
        ctx.chunk_size, ctx.delta = chunk_size, delta
        return y

    @staticmethod
    def backward(ctx, dy):
        grads = causal_linear_attention_bwd(
            *ctx.saved_tensors, dy.contiguous(), chunk_size=ctx.chunk_size,
            delta=ctx.delta)
        return (*grads, None, None)


def causal_linear_attention(qf: torch.Tensor, kf: torch.Tensor,
                            v: torch.Tensor, *, chunk_size: int = 256,
                            delta: float = 1e-6) -> torch.Tensor:
    """qf (BH, L, m), kf (BK, L, m), v (BK, L, dv) -> y (BH, L, dv) in v's
    dtype.

    BH must be a multiple of BK (GQA: q row h reads kv row h // G); L must
    be a multiple of ``chunk_size`` — the ``ops`` wrapper zero-pads ragged
    L. Differentiable with respect to qf, kf and v (:class:`ScanAttention`).
    The CUDA kernels walk 16-token tiles whatever ``chunk_size`` is;
    chunking only orders the evaluation.
    """
    _check(qf, kf, v, chunk_size)
    return ScanAttention.apply(qf, kf, v, chunk_size, delta)
