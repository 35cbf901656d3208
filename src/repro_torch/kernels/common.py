"""The kernels' shared arithmetic in plain PyTorch.

``features_fwd`` is the fp32 Ψ exactly as the CUDA kernels compute it
(``csrc/slay_common.cuh::psi_rows``): normalize → anchor poly
φ_p = (ûᵀa)²/√P → PRF φ_e = exp(√(2s_r) ωᵀû − s_r)/√D → √w_r (φ_p ⊗ φ_e),
concatenated over r. ``features_bwd`` is its closed-form VJP
(``psi_bwd_rows``). The plain versions of the kernels use both, so a
kernel and its plain version differ only in summation order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quadrature
from repro_torch.core.features import SlayFeatureConfig

NORM_EPS = 1e-6  # matches repro_torch.core.features.normalize


class FeatureStatics(NamedTuple):
    """Hashable static description of the Ψ pipeline (per head)."""

    s_nodes: tuple      # quadrature nodes s_r
    sqrt_w: tuple       # √w_r
    num_anchors: int    # P
    num_prf: int        # D


def check_kernelizable(cfg: SlayFeatureConfig) -> None:
    """Raise unless the kernels compute ``cfg``'s Ψ: they take the anchor
    polynomial with the tensor fusion only, as the TPU kernels do; the
    ``ops`` wrappers send every other config through
    ``core.features.slay_features`` and the scan."""
    if not cfg.kernelizable:
        raise ValueError(f"poly_kind={cfg.poly_kind!r}, fusion={cfg.fusion!r}:"
                         f" the kernels compute anchor+tensor Ψ only")


@functools.lru_cache(maxsize=64)
def feature_statics(cfg: SlayFeatureConfig) -> FeatureStatics:
    """The statics of ``cfg``, computed once per config: the quadrature
    behind them is host time that every kernel launch would pay again.
    Only a kernelizable config (anchor + tensor) has them."""
    check_kernelizable(cfg)
    s_np, w_np = quadrature.yat_quadrature(cfg.num_quad_nodes, cfg.eps)
    return FeatureStatics(
        s_nodes=tuple(float(x) for x in s_np),
        sqrt_w=tuple(float(x) for x in np.sqrt(w_np)),
        num_anchors=cfg.num_anchors, num_prf=cfg.num_prf)


def causal_mask(scores: torch.Tensor) -> torch.Tensor:
    """Zero the strict upper triangle of (..., T, T) score blocks."""
    return torch.tril(scores)


def cotangents(y, den, dy, delta):
    """G = dy/(den+δ) (BH, L, dv) and h = −Σ(dy∘y)/(den+δ) (BH, L, 1), the
    scans' per-token cotangents, fp32."""
    e = den.float()[..., None] + delta
    dyf = dy.float()
    return dyf / e, -torch.sum(dyf * y.float(), dim=-1, keepdim=True) / e


def empty_fp32(*shape, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised fp32 tensor on ``like``'s device: a kernel's fp32
    output or the scratch for its shares."""
    return torch.empty(*shape, dtype=torch.float32, device=like.device)


def check_residuals(rows, v, y, den, dy):
    """Check a scan's saved (y, den) and its cotangent dy against its q
    rows (BH, L, ·) and v (BK, L, dv)."""
    bh, L, _ = rows.shape
    want = (bh, L, v.shape[-1])
    if y.shape != want or dy.shape != want or den.shape != (bh, L):
        raise ValueError(f"y {tuple(y.shape)}, dy {tuple(dy.shape)}, den "
                         f"{tuple(den.shape)} do not match q rows "
                         f"{tuple(rows.shape)}")
    if y.dtype != v.dtype or dy.dtype != v.dtype or den.dtype != torch.float32:
        raise TypeError(f"y and dy must be {v.dtype} and den float32, got "
                        f"{y.dtype}, {dy.dtype}, {den.dtype}")
    for name, t in (("y", y), ("den", den), ("dy", dy)):
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, q on {rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def features_fwd(u: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                 st: FeatureStatics):
    """u (..., d) -> (Ψ(u) (..., m), intermediates for the VJP), all fp32.

    The intermediates are (û, inv, pa, φ_p, [φ_e per node]): the
    backward needs pa itself, not only φ_p = pa²/√P, for its sign.
    """
    u = u.float()
    inv = torch.rsqrt(torch.sum(u * u, dim=-1, keepdim=True) + NORM_EPS)
    uh = u * inv
    pa = uh @ a.float().T                                    # (..., P)
    phi_p = (pa * pa) * float(1.0 / np.sqrt(st.num_anchors))
    pw = uh @ w.float().T                                    # (..., D)
    inv_sqrt_d = float(1.0 / np.sqrt(st.num_prf))
    chunks, phi_es = [], []
    for s, swr in zip(st.s_nodes, st.sqrt_w):
        phi_e = torch.exp(float(np.sqrt(2.0 * s)) * pw - s) * inv_sqrt_d
        phi_es.append(phi_e)
        kron = (phi_p[..., :, None] * phi_e[..., None, :]) * swr
        chunks.append(kron.flatten(-2))
    return torch.cat(chunks, dim=-1), (uh, inv, pa, phi_p, phi_es)


def features_bwd(dpsi: torch.Tensor, res, a: torch.Tensor, w: torch.Tensor,
                 st: FeatureStatics):
    """dΨ (..., T, m) -> (du (..., T, d), dA (..., P, d), dΩ (..., D, d)).

    fp32, in the order of ``repro/kernels/common.py::features_bwd``; dA
    and dΩ sum over the token axis T only, so a (BH, L, m) cotangent
    gives one partial per head, as the kernels write them.
    """
    uh, inv, pa, phi_p, phi_es = res
    P, D = st.num_anchors, st.num_prf
    lead = dpsi.shape[:-1]
    dphi_p = torch.zeros_like(phi_p)                          # (..., P)
    dpw = torch.zeros(*lead, D, device=dpsi.device)
    for r, (s, swr) in enumerate(zip(st.s_nodes, st.sqrt_w)):
        m_r = dpsi[..., r * P * D:(r + 1) * P * D].reshape(*lead, P, D) * swr
        phi_e = phi_es[r]
        # kron = φ_p ⊗ φ_e: split the cotangent.
        dphi_p = dphi_p + torch.einsum("...pd,...d->...p", m_r, phi_e)
        dphi_e = torch.einsum("...pd,...p->...d", m_r, phi_p)
        # φ_e = exp(√(2s) pw − s)/√D → d pw = √(2s)·φ_e∘dφ_e.
        dpw = dpw + float(np.sqrt(2.0 * s)) * phi_e * dphi_e
    dpa = 2.0 * pa * dphi_p * float(1.0 / np.sqrt(P))       # (..., P)
    duh = dpa @ a.float() + dpw @ w.float()
    da = dpa.transpose(-1, -2) @ uh                           # (..., P, d)
    dw = dpw.transpose(-1, -2) @ uh                           # (..., D, d)
    # û = u·rsqrt(‖u‖²+ε):  du = inv·(dû − û (ûᵀdû)).
    du = inv * (duh - uh * torch.sum(uh * duh, dim=-1, keepdim=True))
    return du, da, dw
