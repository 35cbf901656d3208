"""The SLAY feature map Ψ(u) and its VJP: CUDA kernels and plain versions.

Replaces the TPU kernels ``repro/kernels/feature_map.py::_kernel`` (B7)
and ``::_bwd_kernel`` (B8) with ``csrc/feature_map.cu``, the first
dispatch of the two-dispatch path: Ψ is written to device memory in u's
dtype and the scan (``slay_scan.py``) reads it back. Both kernels run the
per-element arithmetic of ``csrc/slay_common.cuh`` that the fused
kernels run (B7's Ψ bit for bit theirs, every fp32 operation in
``psi_rows``'s order), and the plain versions run
``common.features_fwd`` / ``features_bwd``, so the two paths share one
feature map.

:class:`FeatureMap` is the counterpart of the ``_fmap`` custom VJP: it
saves (u, anchors, omegas) and its backward runs B8, which emits du and
per-block dA, dΩ partials that the wrapper sums when they are asked
for. CUDA tensors launch the kernels (or raise); ``meta`` tensors take
the same launch wrappers, which allocate the launch's outputs, launch
nothing and record the launch (``_build.record_meta``); CPU tensors run
the plain versions. Any other device raises; there is no fallback from
one to the other. The CUDA
kernels take any number of tokens N (a guarded last tile), so, unlike
the TPU's, they need no padding.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import _build
from repro_torch.kernels.common import (check_kernelizable, feature_statics,
                                        features_bwd, features_fwd)


def feature_map_plain(u, anchors, omegas, cfg: SlayFeatureConfig):
    """Plain twin of B7: u (N, d) -> Ψ(u) (N, m) in u's dtype, fp32
    arithmetic."""
    psi, _ = features_fwd(u, anchors, omegas, feature_statics(cfg))
    return psi.to(u.dtype)


def feature_map_bwd_plain(u, anchors, omegas, dpsi, cfg: SlayFeatureConfig):
    """Plain twin of B8 with its partials summed: -> (du (N, d) in u's
    dtype, dA (P, d), dΩ (D, d) fp32)."""
    st = feature_statics(cfg)
    _, res = features_fwd(u, anchors, omegas, st)
    du, da, dw = features_bwd(dpsi.float(), res, anchors, omegas, st)
    return du.to(u.dtype), da, dw


def _check(u, anchors, omegas, cfg: SlayFeatureConfig):
    check_kernelizable(cfg)
    if u.dim() != 2:
        raise ValueError(f"u must be (N, d), got {tuple(u.shape)}")
    d = u.shape[1]
    if d != cfg.head_dim:
        raise ValueError(f"head dim {d} != cfg.head_dim {cfg.head_dim}")
    if anchors.shape != (cfg.num_anchors, d) or omegas.shape != (cfg.num_prf, d):
        raise ValueError("anchors/omegas shape does not match cfg")
    if u.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    if anchors.dtype != torch.float32 or omegas.dtype != torch.float32:
        raise TypeError("anchors and omegas must be float32")
    for name, t in (("u", u), ("anchors", anchors), ("omegas", omegas)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


_FWD_TILE = 32       # kFwdTile: B7's tokens per tile
_BWD_WARPS = 8       # kBwdWarps: B8's warps per block
_BWD_REG_ROWS = 24   # kRegRows: dA/dΩ rows a B8 lane keeps in registers
_META_SMS = 132      # the H100 SXM5's SMs: B8's grid on meta tensors


def _fwd_smem(d: int, P: int, D: int, R: int, es: int) -> int:
    """``csrc/feature_map.cu::fwd_layout``'s total: two tiles of raw u
    rows, û, the projections, φ and the chunk table."""
    ldu = (d + 3) // 4 * 4
    if (ldu // 4) % 2 == 0:
        ldu += 4
    ldphi = ((P + 3) // 4 * 4 + R * D + 3) // 4 * 4
    chunks = R * P * D * es // 16
    return (2 * _round16(_FWD_TILE * d * es) + _FWD_TILE * ldu * 4
            + (P + D) * ldu * 4 + _FWD_TILE * ldphi * 4 + chunks * 16)


def _bwd_smem(d: int, P: int, D: int, R: int, es: int,
              stage_psi: bool) -> int:
    """``csrc/feature_map.cu::bwd_layout_at``'s total: the projections and
    the block's dA/dΩ sums, then each warp's ring of staged rows (u, and
    dΨ where ``stage_psi``) and per-token scratch."""
    npd = P + D
    kq = 1 if d <= 32 else 2 if d <= 64 else 4
    ldw = 32 * kq
    split = max([s for s in range(2, D + 1)
                 if D % s == 0 and P * s + D <= 32], default=1)
    reg_acc = npd <= _BWD_REG_ROWS and kq <= 2 and stage_psi
    row = _round16(d * es) + (_round16(R * P * D * es) if stage_psi else 0)
    w = (2 * 2 * row + 2 * _round16((2 * P + R * D + 1) * 4)
         + 2 * _round16((P * split + D) * 4) + 2 * _round16(npd * 4)
         + (0 if reg_acc else npd * ldw * 4))
    return (_round16(npd * ldw * 4) + _round16(npd * d * 4)
            + _BWD_WARPS * _round16(w))


def fmap_smem_bytes(d: int, P: int, D: int, R: int, bwd: bool,
                    es: int = 4) -> int:
    """B7's (``bwd`` false) or B8's dynamic shared memory per block,
    ``csrc/feature_map.cu::fm_smem`` in Python (the C entry
    ``slay_feature_map_smem_bytes`` reports it, at es = 4 for fp32 u and
    2 for bf16). B8 stages dΨ rows beside u's where they fit in
    ``_build.SMEM_LIMIT`` and reads dΨ from device memory otherwise. At
    d = 64, P = 8, D = 16, R = 3 in fp32, B7 needs 40,320 B and B8
    77,568; at d = 128, P = D = 32, R = 3, B8 needs 362,752 B even with
    dΨ unstaged, past the limit."""
    if not bwd:
        return _fwd_smem(d, P, D, R, es)
    staged = _bwd_smem(d, P, D, R, es, True)
    return (staged if staged <= _build.SMEM_LIMIT
            else _bwd_smem(d, P, D, R, es, False))


@functools.lru_cache(maxsize=256)
def fmap_fits(d: int, P: int, D: int, R: int, grad: bool,
              device_type: str) -> bool:
    """Whether B7, and B8 when ``grad``, take a config: R within
    ``_build.MAX_NODES``, B7's shared memory (and B8's, whose head dim is
    at most ``_build.MAX_BWD_HEAD_DIM``) within ``_build.SMEM_LIMIT`` in
    fp32, the larger, so one route serves both dtypes. On the card the
    kernels' own C entry says; on the CPU its copy above, so both devices
    take the same route (``ops.attention_route``). Launches nothing."""
    if R > _build.MAX_NODES or (grad and d > _build.MAX_BWD_HEAD_DIM):
        return False
    if device_type == "cuda":
        smem = _build.load("feature_map").slay_feature_map_smem_bytes
    else:
        def smem(d, P, D, R, bwd, _dtype):
            return fmap_smem_bytes(d, P, D, R, bool(bwd))
    return all(smem(d, P, D, R, int(bwd), 0) <= _build.SMEM_LIMIT
               for bwd in ((False, True) if grad else (False,)))


def _kernel_args(lib, u, cfg: SlayFeatureConfig, bwd: bool):
    """Guards of B7 and B8, which a routed call never reaches
    (``ops.attention_route`` sends a config past them to Ψ in PyTorch ops):
    they stop a wrong route from launching. ``lib`` None (``meta``
    tensors) reads the shared memory from the Python copy. Returns the
    shapes and the quadrature constants as C double arrays."""
    d = u.shape[1]
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    if R > _build.MAX_NODES:
        raise ValueError(f"kernel takes at most {_build.MAX_NODES} "
                         f"quadrature nodes, got {R}")
    if bwd and d > _build.MAX_BWD_HEAD_DIM:
        raise ValueError(f"backward kernel takes head dim <= "
                         f"{_build.MAX_BWD_HEAD_DIM}, got {d}")
    if lib is None:
        smem = fmap_smem_bytes(d, P, D, R, bwd, u.element_size())
    else:
        smem = lib.slay_feature_map_smem_bytes(d, P, D, R, int(bwd),
                                               _build.DTYPE_CODES[u.dtype])
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"shapes need {smem} B of shared memory per block, "
                         f"more than {_build.SMEM_LIMIT}")
    st = feature_statics(cfg)
    return (d, P, D, R, (ctypes.c_double * R)(*st.s_nodes),
            (ctypes.c_double * R)(*st.sqrt_w))


def _lib(u):
    """The feature-map library, or None for ``meta`` tensors."""
    return None if u.device.type == "meta" else _build.load("feature_map")


def launch_fwd(u, anchors, omegas, cfg: SlayFeatureConfig):
    """B7 on CUDA tensors: -> Ψ(u) (N, m) in u's dtype. On ``meta``
    tensors it allocates Ψ and records the launch with
    ``feature_map_bounds``' work."""
    _build.local_only("slay_feature_map_fwd", u, anchors, omegas)
    lib = _lib(u)
    d, P, D, R, s_nodes, sqrt_w = _kernel_args(lib, u, cfg, False)
    n = u.shape[0]
    psi = torch.empty(n, cfg.feature_dim, dtype=u.dtype, device=u.device)
    if lib is None:
        _build.record_meta("feature_map_fwd", n, d, P, D, R,
                           u.element_size())
        return psi
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slay_feature_map_fwd(
            u.data_ptr(), anchors.data_ptr(), omegas.data_ptr(),
            psi.data_ptr(), n, d, P, D, R, s_nodes, sqrt_w,
            _build.DTYPE_CODES[u.dtype], stream)
    _build.check(err, "slay_feature_map_fwd")
    _build.LAUNCHES["feature_map_fwd"] += 1
    return psi


@functools.lru_cache(maxsize=256)
def _bwd_blocks(lib, n: int, d: int, P: int, D: int, R: int, dtype: int,
                device: int) -> int:
    """B8's persistent grid for n tokens on CUDA device ``device``
    (``slay_feature_map_bwd_blocks`` of ``lib``), asked once per library,
    shapes and device: the query (the device's SMs, the kernel's
    occupancy) is host time that every launch would pay again."""
    with torch.cuda.device(device):
        nb = lib.slay_feature_map_bwd_blocks(n, d, P, D, R, dtype)
    _build.check(min(nb, 0), "slay_feature_map_bwd_blocks")
    return nb


def launch_bwd(u, anchors, omegas, dpsi, cfg: SlayFeatureConfig):
    """B8 on CUDA tensors: -> (du (N, d) in u's dtype, dA (nb, P, d) and
    dΩ (nb, D, d) fp32 partials, one per block of its persistent grid).
    On ``meta`` tensors it allocates the same, its grid taken at one block
    per SM of the H100 (the card's occupancy query is not asked), and
    records the launch with ``feature_map_bounds``' work."""
    _build.local_only("slay_feature_map_bwd", u, anchors, omegas, dpsi)
    lib = _lib(u)
    d, P, D, R, s_nodes, sqrt_w = _kernel_args(lib, u, cfg, True)
    n, dtype = u.shape[0], _build.DTYPE_CODES[u.dtype]
    if lib is None:
        nb = max(min(-(-n // _BWD_WARPS), _META_SMS), 1)
    else:
        nb = _bwd_blocks(lib, n, d, P, D, R, dtype, u.device.index)
    du = torch.empty_like(u)
    da = torch.empty(nb, P, d, dtype=torch.float32, device=u.device)
    dw = torch.empty(nb, D, d, dtype=torch.float32, device=u.device)
    if lib is None:
        _build.record_meta("feature_map_bwd", n, d, P, D, R,
                           u.element_size())
        return du, da, dw
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slay_feature_map_bwd(
            u.data_ptr(), anchors.data_ptr(), omegas.data_ptr(),
            dpsi.data_ptr(), du.data_ptr(), da.data_ptr(), dw.data_ptr(), n,
            d, nb, P, D, R, s_nodes, sqrt_w, dtype, stream)
    _build.check(err, "slay_feature_map_bwd")
    _build.LAUNCHES["feature_map_bwd"] += 1
    return du, da, dw


def fwd_residency(n: int, cfg: SlayFeatureConfig, dtype: torch.dtype) -> dict:
    """How B7 sits on the current card for n tokens, as
    :func:`repro_torch.kernels._build.residency` reports: ``tile`` is its
    tokens per tile, its grid the persistent one of :func:`launch_fwd`
    (the blocks resident at once, at most one per tile). Launches
    nothing."""
    d, P, D, R = cfg.head_dim, cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    res = _build.residency("feature_map", "slay_feature_map_fwd_occupancy",
                           d, P, D, R, _build.DTYPE_CODES[dtype], grid=(0, 1))
    res["grid"] = (min(-(-n // res["tile"]), res["blocks_resident"]), 1)
    return res


def bwd_residency(n: int, cfg: SlayFeatureConfig, dtype: torch.dtype) -> dict:
    """How B8 sits on the current card for n tokens (its grid is the
    persistent one of :func:`launch_bwd`, each warp carrying two tokens at
    a time; ``tile`` is the warps per block), as
    :func:`repro_torch.kernels._build.residency` reports. Launches
    nothing."""
    lib = _build.load("feature_map")
    d, P, D, R = cfg.head_dim, cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    code = _build.DTYPE_CODES[dtype]
    nb = _bwd_blocks(lib, n, d, P, D, R, code, torch.cuda.current_device())
    return _build.residency("feature_map", "slay_feature_map_bwd_occupancy",
                            d, P, D, R, code, grid=(nb, 1))


def feature_map_bwd(u, anchors, omegas, dpsi, cfg: SlayFeatureConfig, *,
                    proj_grads: bool = True):
    """VJP of the feature map: -> (du in u's dtype, dA, dΩ in the
    projections' dtype), or (du, None, None) when ``proj_grads`` is false.
    CUDA tensors run B8 and sum its partials, CPU tensors the plain
    version; ``meta`` tensors take B8's meta branch, any other device
    raises."""
    _check(u, anchors, omegas, cfg)
    if dpsi.shape != (u.shape[0], cfg.feature_dim) or dpsi.dtype != u.dtype:
        raise ValueError(f"dpsi {tuple(dpsi.shape)} {dpsi.dtype} does not "
                         f"match Ψ of u {tuple(u.shape)} {u.dtype}")
    if u.device.type in _build.KERNEL_DEVICES:
        du, da, dw = launch_bwd(u, anchors, omegas, dpsi.contiguous(), cfg)
        if not proj_grads:
            return du, None, None
        return (du, torch.sum(da, dim=0).to(anchors.dtype),
                torch.sum(dw, dim=0).to(omegas.dtype))
    if u.device.type != "cpu":
        raise ValueError(f"unsupported device {u.device}")
    du, da, dw = feature_map_bwd_plain(u, anchors, omegas, dpsi, cfg)
    return (du, da, dw) if proj_grads else (du, None, None)


class FeatureMap(torch.autograd.Function):
    """The ``_fmap`` custom VJP of the JAX package: the forward runs B7
    (its meta branch on ``meta`` tensors, the plain version on the CPU)
    and saves (u, anchors, omegas); the backward runs B8 (the plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, u, anchors, omegas, cfg):
        ctx.save_for_backward(u, anchors, omegas)
        ctx.cfg = cfg
        if u.device.type in _build.KERNEL_DEVICES:
            return launch_fwd(u, anchors, omegas, cfg)
        if u.device.type != "cpu":
            raise ValueError(f"unsupported device {u.device}")
        return feature_map_plain(u, anchors, omegas, cfg)

    @staticmethod
    def backward(ctx, dpsi):
        need = ctx.needs_input_grad
        du, da, dw = feature_map_bwd(*ctx.saved_tensors, dpsi.contiguous(),
                                     ctx.cfg, proj_grads=need[1] or need[2])
        return (du, da if need[1] else None, dw if need[2] else None, None)


def feature_map(u: torch.Tensor, anchors: torch.Tensor, omegas: torch.Tensor,
                cfg: SlayFeatureConfig) -> torch.Tensor:
    """u (N, d) -> Ψ(u) (N, m) in u's dtype, for any N. Differentiable with
    respect to u, anchors and omegas (:class:`FeatureMap`)."""
    _check(u, anchors, omegas, cfg)
    return FeatureMap.apply(u, anchors, omegas, cfg)


def slay_feature_map(u: torch.Tensor, anchors: torch.Tensor,
                     omegas: torch.Tensor, cfg: SlayFeatureConfig, *,
                     block_tokens: int = 256) -> torch.Tensor:
    """u (N, d) -> Ψ(u) (N, m), the JAX entry's signature and checks: only
    anchor+tensor features, and ``block_tokens`` must divide N. The CUDA
    kernel tiles the tokens its own way; ``block_tokens`` is kept for
    parity with the JAX API."""
    if cfg.poly_kind != "anchor" or cfg.fusion != "tensor":
        raise ValueError("kernelized path supports anchor+tensor only")
    n = u.shape[0]
    if n % block_tokens:
        raise ValueError(f"N={n} not divisible by block={block_tokens}")
    return feature_map(u, anchors, omegas, cfg)
