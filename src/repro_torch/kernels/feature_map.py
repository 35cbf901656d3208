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
for. CUDA tensors launch the kernels (or raise), CPU tensors run the
plain versions; there is no fallback from one to the other. The CUDA
kernels take any number of tokens N (a guarded last tile), so, unlike
the TPU's, they need no padding.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import _build
from repro_torch.kernels.common import (feature_statics, features_bwd,
                                        features_fwd)


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
    cfg.check_supported()
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


def _kernel_args(lib, u, cfg: SlayFeatureConfig, bwd: bool):
    d = u.shape[1]
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    if R > 8:
        raise ValueError(f"kernel takes at most 8 quadrature nodes, got {R}")
    if bwd and d > 128:
        raise ValueError(f"backward kernel takes head dim <= 128, got {d}")
    smem = lib.slay_feature_map_smem_bytes(d, P, D, R, int(bwd),
                                           _build.DTYPE_CODES[u.dtype])
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"shapes need {smem} B of shared memory per block, "
                         f"more than {_build.SMEM_LIMIT}")
    st = feature_statics(cfg)
    return (d, P, D, R, (ctypes.c_double * R)(*st.s_nodes),
            (ctypes.c_double * R)(*st.sqrt_w))


def launch_fwd(u, anchors, omegas, cfg: SlayFeatureConfig):
    """B7 on CUDA tensors: -> Ψ(u) (N, m) in u's dtype."""
    lib = _build.load("feature_map")
    d, P, D, R, s_nodes, sqrt_w = _kernel_args(lib, u, cfg, False)
    n = u.shape[0]
    psi = torch.empty(n, cfg.feature_dim, dtype=u.dtype, device=u.device)
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
    dΩ (nb, D, d) fp32 partials, one per block of its persistent grid)."""
    lib = _build.load("feature_map")
    d, P, D, R, s_nodes, sqrt_w = _kernel_args(lib, u, cfg, True)
    n, dtype = u.shape[0], _build.DTYPE_CODES[u.dtype]
    nb = _bwd_blocks(lib, n, d, P, D, R, dtype, u.device.index)
    du = torch.empty_like(u)
    da = torch.empty(nb, P, d, dtype=torch.float32, device=u.device)
    dw = torch.empty(nb, D, d, dtype=torch.float32, device=u.device)
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
    version."""
    _check(u, anchors, omegas, cfg)
    if dpsi.shape != (u.shape[0], cfg.feature_dim) or dpsi.dtype != u.dtype:
        raise ValueError(f"dpsi {tuple(dpsi.shape)} {dpsi.dtype} does not "
                         f"match Ψ of u {tuple(u.shape)} {u.dtype}")
    if u.device.type == "cuda":
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
    (the plain version on the CPU) and saves (u, anchors, omegas); the
    backward runs B8 (the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, u, anchors, omegas, cfg):
        ctx.save_for_backward(u, anchors, omegas)
        ctx.cfg = cfg
        if u.device.type == "cuda":
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
