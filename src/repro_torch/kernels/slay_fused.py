"""Fused causal SLAY attention, forward and backward: CUDA kernels and
plain versions.

Replaces the TPU megakernel ``repro/kernels/slay_fused.py``: the forward
``_fwd_kernel`` (B1) with K1 (``csrc/slay_fused.cu``), and the two
backward scans ``_bwd_q_kernel`` (B2) and ``_bwd_kv_kernel`` (B3) with K3
and K4 (``csrc/slay_fused_bwd.cu``). Ψ(q), Ψ(k) are computed on-chip from
raw q/k inside the chunked causal scans and never written to device
memory; see the CUDA sources for the designs and what bounds them.

:func:`fused_causal_attention` is differentiable through
:class:`FusedAttention`, the counterpart of the ``_fused`` custom VJP: its
forward saves (q, k, v, anchors, omegas, y, den) and its backward runs
K3 then K4. Every wrapper chooses by the tensors' device: CUDA tensors
launch the kernels (or raise); ``meta`` tensors take the same launch
wrappers, which allocate the launch's outputs, launch nothing and record
the launch (``_build.record_meta``); CPU tensors run the plain versions,
which repeat the kernels' fp32 arithmetic in PyTorch. Any other device
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import _build
from repro_torch.kernels.common import (causal_mask, check_kernelizable,
                                        check_residuals, cotangents,
                                        empty_fp32, feature_statics,
                                        features_bwd, features_fwd)


def fused_causal_attention_plain(q, k, v, anchors, omegas,
                                 cfg: SlayFeatureConfig, *,
                                 chunk_size: int = 256, delta: float = 1e-6):
    """Plain PyTorch twin of the kernel: q (BH, L, d), k (BK, L, d),
    v (BK, L, dv) -> (y (BH, L, dv) in v's dtype, den (BH, L) fp32)."""
    bh, L, _ = q.shape
    bk, _, dv = v.shape
    g = bh // bk
    st = feature_statics(cfg)
    qf = features_fwd(q, anchors, omegas, st)[0].reshape(bk, g, L, -1)
    kf = features_fwd(k, anchors, omegas, st)[0]         # (bk, L, m)
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
    check_kernelizable(cfg)
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


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def _floats(*sizes: int) -> int:
    """Floats of a carve-up of these sizes, each rounded up to 16 bytes
    (``csrc/scan_tile_mma.cuh::carve``)."""
    return sum((n + 3) // 4 * 4 for n in sizes)


def fused_smem_bytes(d: int, dv: int, P: int, D: int, es: int = 4) -> int:
    """K1's dynamic shared memory per block, ``csrc/slay_fused.cu::
    fused_layout`` in Python (the C entry ``slay_fused_smem_bytes`` reports
    it at es = 4): one quadrature node's (P·D, dv) fp32 carry and z, two
    16-token tiles of raw rows, projections, φ and Ψ at width P·D, V, the
    scores, then the staging of the next tile. At d = dv = 64, P = 8,
    D = 16 it is 83,584 B in bf16 and 89,728 in fp32; at Table 2's "large"
    budget, d = dv = 32 with P = D = 32, 316,160 B."""
    T, pd = 16, _pad16(P * D)
    floats = _floats(pd * (dv + 4), pd, 2 * T * (d + 4), (P + D) * (d + 4),
                     2 * T * (P + D), 2 * T * (pd + 4), T * (dv + 4),
                     T * (T + 4), T * (T + 4))
    return floats * 4 + T * (2 * _pad16(d * es) + _pad16(dv * es))


def fused_bwd_smem_bytes(d: int, dv: int, P: int, D: int, es: int = 4,
                         kv: bool = True) -> int:
    """K4's (``kv``) or K3's dynamic shared memory per block,
    ``csrc/slay_fused_bwd.cu::bwd_layout`` in Python (the C entry
    ``slay_fused_bwd_smem_bytes`` reports K4's at es = 4; K3 takes no
    more): K1's carry and tiles plus pa, inv, G, h, the dA/dΩ scratch and
    K4's scores, dP and dV. At d = dv = 64, P = 8, D = 16, K4 needs
    104,832 B in bf16 and 115,072 in fp32, K3 98,432 in bf16."""
    T, pd, npd = 16, P * D, P + D
    o = (pd * (dv + 4) + pd + 2 * T * (d + 4) + npd * (d + 4) + 2 * T * npd
         + 2 * T * P + 2 * T + 2 * T * (pd + 4) + 2 * T * (dv + 4) + T)
    o += (max(3 * T * (T + 4) if kv else 0, T * npd) + npd * d
          + (T * dv if kv else 0))
    o = (o + 3) // 4 * 4
    return o * 4 + T * (2 * d + 3 * dv) * es + T * 4


def bwd_shapes_ok(d: int, P: int, D: int) -> bool:
    """The shapes K3 and K4 take beyond K1's (``csrc/slay_fused_bwd.cu::
    bwd_shapes_ok``): a head dim of at most ``_build.MAX_BWD_HEAD_DIM``
    and a multiple of 8, and P·D a multiple of 16."""
    return (8 <= d <= _build.MAX_BWD_HEAD_DIM and d % 8 == 0
            and (P * D) % 16 == 0)


@functools.lru_cache(maxsize=256)
def fused_fits(d: int, dv: int, P: int, D: int, R: int, grad: bool,
               device_type: str) -> bool:
    """Whether K1, and K3/K4 when ``grad``, take a config at these head
    dims: R within ``_build.MAX_NODES``; K1's shared memory (each node's
    whole (P·D, dv) fp32 carry and two tiles of Ψ at width P·D) within
    ``_build.SMEM_LIMIT``; with a gradient also :func:`bwd_shapes_ok` and
    K4's shared memory (K3 takes no more). On the card the kernels' own C
    entries say; on the CPU their copies above, so both devices take the
    same route (``ops.attention_route``). Launches nothing."""
    if R > _build.MAX_NODES or (grad and not bwd_shapes_ok(d, P, D)):
        return False
    if device_type == "cuda":
        fwd = _build.load("slay_fused").slay_fused_smem_bytes
        bwd = _build.load("slay_fused_bwd").slay_fused_bwd_smem_bytes
    else:
        fwd, bwd = fused_smem_bytes, fused_bwd_smem_bytes
    return (fwd(d, dv, P, D) <= _build.SMEM_LIMIT
            and (not grad or bwd(d, dv, P, D) <= _build.SMEM_LIMIT))


def _kernel_args(smem_bytes, q, v, cfg: SlayFeatureConfig):
    """Shape checks shared by K1, K3 and K4, ``smem_bytes(d, dv, P, D)``
    the kernel's shared memory (its C entry, or on ``meta`` its Python
    copy); returns the quadrature constants as C double arrays. A routed
    call never fails them (``ops.attention_route`` sends a config past
    them elsewhere): they stop a wrong route from launching."""
    d, dv = q.shape[-1], v.shape[-1]
    if dv not in (16, 32, 64, 128):
        raise ValueError(f"kernel takes dv in (16, 32, 64, 128), got {dv}")
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    if R > _build.MAX_NODES:
        raise ValueError(f"kernel takes at most {_build.MAX_NODES} "
                         f"quadrature nodes, got {R}")
    smem = smem_bytes(d, dv, P, D)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"shapes need {smem} B of shared memory per block, "
                         f"more than {_build.SMEM_LIMIT}")
    st = feature_statics(cfg)
    return ((ctypes.c_double * R)(*st.s_nodes),
            (ctypes.c_double * R)(*st.sqrt_w))


def _launch(q, k, v, anchors, omegas, cfg: SlayFeatureConfig, delta):
    """K1 on CUDA tensors: -> (y, den), as
    :func:`fused_causal_attention_plain`. The C entry launches K1 on a
    BH x R grid, which writes each quadrature node's fp32 share of num and
    den into scratch allocated here, then the epilogue kernel, which sums
    the shares and divides: one launch counted. On ``meta`` tensors it
    allocates the same and records the launch with ``k1_bound``'s work."""
    _build.local_only("slay_fused_fwd", q, k, v, anchors, omegas)
    bh, L, d = q.shape
    bk, _, dv = v.shape
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    meta = q.device.type == "meta"
    lib = None if meta else _build.load("slay_fused")
    s_nodes, sqrt_w = _kernel_args(
        fused_smem_bytes if meta else lib.slay_fused_smem_bytes, q, v, cfg)
    y = torch.empty(bh, L, dv, dtype=v.dtype, device=q.device)
    den = empty_fp32(bh, L, like=q)
    num_part = empty_fp32(R, bh, L, dv, like=q)
    den_part = empty_fp32(R, bh, L, like=q)
    if meta:
        _build.record_meta("slay_fused_fwd", bh, bk, L, d, dv, P, D, R,
                           q.element_size())
        return y, den
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slay_fused_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), anchors.data_ptr(),
            omegas.data_ptr(), y.data_ptr(), den.data_ptr(),
            num_part.data_ptr(), den_part.data_ptr(), bh, bk, L, d, dv, P, D,
            R, s_nodes, sqrt_w, delta, _build.DTYPE_CODES[q.dtype], stream)
    _build.check(err, "slay_fused_fwd")
    _build.LAUNCHES["slay_fused_fwd"] += 1
    return y, den


def fwd_residency(bh: int, d: int, dv: int, cfg: SlayFeatureConfig,
                  dtype: torch.dtype) -> dict:
    """How K1 sits on the current card at these shapes (its grid is BH x
    R blocks), as :func:`repro_torch.kernels._build.residency` reports.
    Launches nothing."""
    return _build.residency(
        "slay_fused", "slay_fused_fwd_occupancy", d, dv, cfg.num_anchors,
        cfg.num_prf, _build.DTYPE_CODES[dtype],
        grid=(bh, cfg.num_quad_nodes))


# -- backward ------------------------------------------------------------


def _per_q_head(q, k, v, anchors, omegas, st):
    """Ψ of every q row and, repeated for each q head of its GQA group, of
    every kv row, as the kernels recompute them (one block per q head)."""
    g = q.shape[0] // k.shape[0]
    qf, qres = features_fwd(q, anchors, omegas, st)
    kf, kres = features_fwd(k.repeat_interleave(g, 0), anchors, omegas, st)
    return qf, qres, kf, kres, v.float().repeat_interleave(g, 0)


def fused_bwd_q_plain(q, k, v, anchors, omegas, y, den, dy,
                      cfg: SlayFeatureConfig, *, chunk_size: int = 256,
                      delta: float = 1e-6):
    """Plain twin of K3 (B2), the forward re-scan: -> (dq (BH, L, d) in
    q's dtype, dA (BH, P, d), dΩ (BH, D, d) fp32 per-head partials)."""
    st = feature_statics(cfg)
    _, qres, kf, _, vf = _per_q_head(q, k, v, anchors, omegas, st)
    gg, hh = cotangents(y, den, dy, delta)
    bh, L, _ = q.shape
    m, dv = kf.shape[-1], vf.shape[-1]
    s = torch.zeros(bh, m, dv, device=q.device)
    z = torch.zeros(bh, m, device=q.device)
    dqf = []
    for c0 in range(0, L, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        k_c, v_c, g_c, h_c = kf[:, sl], vf[:, sl], gg[:, sl], hh[:, sl]
        # dP = tril(G Vᵀ + h 1ᵀ);  dΨq = G Sᵀ + h zᵀ + dP Ψk.
        dp = causal_mask(g_c @ v_c.transpose(-1, -2) + h_c)
        dqf.append(g_c @ s.transpose(-1, -2) + h_c * z[:, None, :]
                   + dp @ k_c)
        s = s + k_c.transpose(-1, -2) @ v_c
        z = z + k_c.sum(-2)
    dq, da, dw = features_bwd(torch.cat(dqf, dim=1), qres, anchors, omegas,
                              st)
    return dq.to(q.dtype), da, dw


def fused_bwd_kv_plain(q, k, v, anchors, omegas, y, den, dy,
                       cfg: SlayFeatureConfig, *, chunk_size: int = 256,
                       delta: float = 1e-6):
    """Plain twin of K4 (B3), the reverse scan: -> per-q-head partials dk
    (BH, L, d) in k's dtype, dv (BH, L, dv) in v's dtype, dA (BH, P, d)
    and dΩ (BH, D, d) fp32."""
    st = feature_statics(cfg)
    qf, _, kf, kres, vf = _per_q_head(q, k, v, anchors, omegas, st)
    gg, hh = cotangents(y, den, dy, delta)
    bh, L, _ = q.shape
    m, dv = kf.shape[-1], vf.shape[-1]
    ds = torch.zeros(bh, m, dv, device=q.device)
    dz = torch.zeros(bh, m, device=q.device)
    dkf, dvs = [], []
    for c0 in reversed(range(0, L, chunk_size)):
        sl = slice(c0, c0 + chunk_size)
        q_c, k_c, v_c = qf[:, sl], kf[:, sl], vf[:, sl]
        g_c, h_c = gg[:, sl], hh[:, sl]
        scores = causal_mask(q_c @ k_c.transpose(-1, -2))
        dp = causal_mask(g_c @ v_c.transpose(-1, -2) + h_c)
        # dΨk = dPᵀ Ψq + V dSᵀ + 1 dzᵀ;  dV = Pᵀ G + Ψk dS.
        dkf.append(dp.transpose(-1, -2) @ q_c + v_c @ ds.transpose(-1, -2)
                   + dz[:, None, :])
        dvs.append(scores.transpose(-1, -2) @ g_c + k_c @ ds)
        # Carry the state cotangents to the previous chunk.
        ds = ds + q_c.transpose(-1, -2) @ g_c
        dz = dz + torch.sum(q_c * h_c, dim=-2)
    dk, da, dw = features_bwd(torch.cat(dkf[::-1], dim=1), kres, anchors,
                              omegas, st)
    return dk.to(k.dtype), torch.cat(dvs[::-1], dim=1).to(v.dtype), da, dw


def _reduce(k, v, anchors, omegas, dq, da_q, dw_q, dk_p, dv_p, da_k, dw_k):
    """Sum the per-q-head partials as ``_bwd_impl`` does: dk and dv over
    each GQA group, dA and dΩ over heads and over both scans."""
    bh, L, _ = dk_p.shape
    bk = k.shape[0]
    dk = dk_p.reshape(bk, bh // bk, L, -1).sum(1).to(k.dtype)
    dv = dv_p.reshape(bk, bh // bk, L, -1).sum(1).to(v.dtype)
    da = torch.sum(da_q + da_k, dim=0).to(anchors.dtype)
    dw = torch.sum(dw_q + dw_k, dim=0).to(omegas.dtype)
    return dq, dk, dv, da, dw


def fused_causal_attention_bwd_plain(q, k, v, anchors, omegas, y, den, dy,
                                     cfg: SlayFeatureConfig, *,
                                     chunk_size: int = 256,
                                     delta: float = 1e-6):
    """Plain backward: -> (dq, dk, dv, dA, dΩ), the two scans' fp32
    arithmetic chunk by chunk. The CPU path and the tests use it."""
    kw = dict(chunk_size=chunk_size, delta=delta)
    args = (q, k, v, anchors, omegas, y, den, dy, cfg)
    return _reduce(k, v, anchors, omegas, *fused_bwd_q_plain(*args, **kw),
                   *fused_bwd_kv_plain(*args, **kw))


def _check_bwd_shapes(d, cfg: SlayFeatureConfig):
    """K3's and K4's shape limits (:func:`bwd_shapes_ok`). A routed call
    never fails them: ``ops.attention_route`` sends a config that a
    gradient would take past them elsewhere before the forward runs."""
    if d > _build.MAX_BWD_HEAD_DIM or d % 8:
        raise ValueError(f"backward kernels take a head dim <= "
                         f"{_build.MAX_BWD_HEAD_DIM} and a multiple of 8, "
                         f"got {d}")
    if (cfg.num_anchors * cfg.num_prf) % 16:
        raise ValueError(f"backward kernels take P·D a multiple of 16, got "
                         f"{cfg.num_anchors * cfg.num_prf}")


def _check_bwd_inputs(cfg: SlayFeatureConfig, **tensors):
    """The CUDA backward's limits beyond the forward's: the shapes above,
    and every row tensor starting on 16 bytes (K3 and K4 copy rows with
    16-byte cp.async)."""
    _check_bwd_shapes(tensors["q"].shape[-1], cfg)
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch_bwd(fn, outs, q, k, v, anchors, omegas, y, den, dy,
                cfg: SlayFeatureConfig, delta):
    """Launch K3 or K4 into ``outs``, fp32 buffers with a leading axis of
    one share per quadrature node; returns them. On ``meta`` tensors it
    records the launch with ``bwd_bounds``' work instead."""
    _build.local_only(fn, q, k, v, anchors, omegas, y, den, dy)
    bh, L, d = q.shape
    bk, _, dv = v.shape
    _check_bwd_inputs(cfg, q=q, k=k, v=v, y=y, dy=dy)
    meta = q.device.type == "meta"
    lib = None if meta else _build.load("slay_fused_bwd")
    s_nodes, sqrt_w = _kernel_args(
        fused_bwd_smem_bytes if meta else lib.slay_fused_bwd_smem_bytes, q,
        v, cfg)
    if meta:
        _build.record_meta(fn, bh, bk, L, d, dv, cfg.num_anchors,
                           cfg.num_prf, cfg.num_quad_nodes,
                           q.element_size())
        return outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), anchors.data_ptr(),
            omegas.data_ptr(), dy.data_ptr(), y.data_ptr(), den.data_ptr(),
            *(o.data_ptr() for o in outs), bh, bk, L, d, dv,
            cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes, s_nodes, sqrt_w,
            delta, _build.DTYPE_CODES[q.dtype], stream)
    _build.check(err, fn)
    _build.LAUNCHES[fn] += 1
    return outs


def launch_bwd_q(q, k, v, anchors, omegas, y, den, dy,
                 cfg: SlayFeatureConfig, delta: float = 1e-6):
    """K3 on CUDA tensors: -> (dq, dA, dΩ partials), as
    :func:`fused_bwd_q_plain`. The kernel writes one fp32 share per
    quadrature node; their sum over that axis (``torch.sum``, no atomics)
    is rounded once to q's dtype."""
    bh, L, d = q.shape
    R, P, D = cfg.num_quad_nodes, cfg.num_anchors, cfg.num_prf
    dq, da, dw = _launch_bwd(
        "slay_fused_bwd_q", (empty_fp32(R, bh, L, d, like=q),
                             empty_fp32(R, bh, P, d, like=q),
                             empty_fp32(R, bh, D, d, like=q)),
        q, k, v, anchors, omegas, y, den, dy, cfg, delta)
    return dq.sum(0).to(q.dtype), da.sum(0), dw.sum(0)


def launch_bwd_kv(q, k, v, anchors, omegas, y, den, dy,
                  cfg: SlayFeatureConfig, delta: float = 1e-6):
    """K4 on CUDA tensors: -> (dk, dv, dA, dΩ per-q-head partials), as
    :func:`fused_bwd_kv_plain`, from the kernel's per-node fp32 shares as
    in :func:`launch_bwd_q`."""
    bh, L, d = q.shape
    dv, R = v.shape[-1], cfg.num_quad_nodes
    P, D = cfg.num_anchors, cfg.num_prf
    dk, dvp, da, dw = _launch_bwd(
        "slay_fused_bwd_kv", (empty_fp32(R, bh, L, d, like=q),
                              empty_fp32(R, bh, L, dv, like=q),
                              empty_fp32(R, bh, P, d, like=q),
                              empty_fp32(R, bh, D, d, like=q)),
        q, k, v, anchors, omegas, y, den, dy, cfg, delta)
    return (dk.sum(0).to(k.dtype), dvp.sum(0).to(v.dtype), da.sum(0),
            dw.sum(0))


def bwd_residency(kv: bool, bh: int, d: int, dv: int, cfg: SlayFeatureConfig,
                  dtype: torch.dtype) -> dict:
    """How K3 (``kv=False``) or K4 (``kv=True``) sits on the current card
    at these shapes (its grid is BH x R blocks), as
    :func:`repro_torch.kernels._build.residency` reports. Launches
    nothing."""
    _check_bwd_shapes(d, cfg)
    return _build.residency(
        "slay_fused_bwd", "slay_fused_bwd_occupancy", int(kv), d, dv,
        cfg.num_anchors, cfg.num_prf, _build.DTYPE_CODES[dtype],
        grid=(bh, cfg.num_quad_nodes))


def fused_causal_attention_bwd(q, k, v, anchors, omegas, y, den, dy,
                               cfg: SlayFeatureConfig, *,
                               chunk_size: int = 256, delta: float = 1e-6):
    """Backward of :func:`fused_causal_attention` from its residuals:
    -> (dq, dk, dv, dA, dΩ). CUDA tensors run K3 then K4 (``meta`` tensors
    their meta branches), CPU tensors the plain version; any other device
    raises."""
    _check(q, k, v, anchors, omegas, cfg, chunk_size)
    check_residuals(q, v, y, den, dy)
    if q.device.type in _build.KERNEL_DEVICES:
        args = (q, k, v, anchors, omegas, y, den, dy, cfg, delta)
        return _reduce(k, v, anchors, omegas, *launch_bwd_q(*args),
                       *launch_bwd_kv(*args))
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fused_causal_attention_bwd_plain(q, k, v, anchors, omegas, y, den,
                                            dy, cfg, chunk_size=chunk_size,
                                            delta=delta)


# -- entry point ---------------------------------------------------------


def _forward(q, k, v, anchors, omegas, cfg, chunk_size, delta):
    """K1 on CUDA tensors (its meta branch on ``meta`` ones), the plain
    forward on CPU tensors; any other device raises."""
    if q.device.type in _build.KERNEL_DEVICES:
        return _launch(q, k, v, anchors, omegas, cfg, delta)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fused_causal_attention_plain(q, k, v, anchors, omegas, cfg,
                                        chunk_size=chunk_size, delta=delta)


class FusedAttention(torch.autograd.Function):
    """The ``_fused`` custom VJP of the JAX package: the forward runs K1
    (the plain forward on the CPU) and saves (q, k, v, anchors, omegas, y,
    den); the backward runs K3 and K4 (the plain backward on the CPU).
    ``den`` is a residual output and carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, anchors, omegas, cfg, chunk_size, delta):
        y, den = _forward(q, k, v, anchors, omegas, cfg, chunk_size, delta)
        ctx.save_for_backward(q, k, v, anchors, omegas, y, den)
        ctx.cfg, ctx.chunk_size, ctx.delta = cfg, chunk_size, delta
        ctx.mark_non_differentiable(den)
        return y, den

    @staticmethod
    def backward(ctx, dy, _dden):
        grads = fused_causal_attention_bwd(
            *ctx.saved_tensors, dy.contiguous(), ctx.cfg,
            chunk_size=ctx.chunk_size, delta=ctx.delta)
        return (*grads, None, None, None)


def fused_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           anchors: torch.Tensor, omegas: torch.Tensor,
                           cfg: SlayFeatureConfig, *, chunk_size: int = 256,
                           delta: float = 1e-6):
    """q (BH, L, d), k (BK, L, d), v (BK, L, dv) -> (y (BH, L, dv), den
    (BH, L) fp32, δ not added).

    Raw (pre-feature) q/k; Ψ is computed inside the kernel. Differentiable
    with respect to q, k, v, anchors and omegas (:class:`FusedAttention`).
    BH must be a multiple of BK (GQA: q row h reads kv row h // G); L must
    be a multiple of ``chunk_size`` — the ``ops`` wrapper zero-pads ragged
    L. The CUDA kernels walk the sequence in 16-token tiles whatever
    ``chunk_size`` is; chunking only orders the evaluation, and
    ``chunk_size`` is kept for parity with the JAX API and the plain
    versions.
    """
    _check(q, k, v, anchors, omegas, cfg, chunk_size)
    if (q.device.type in _build.KERNEL_DEVICES and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, anchors, omegas))):
        # Refuse before the forward runs what the backward would refuse.
        _check_bwd_inputs(cfg, q=q, k=k, v=v)
    return FusedAttention.apply(q, k, v, anchors, omegas, cfg, chunk_size,
                                delta)
