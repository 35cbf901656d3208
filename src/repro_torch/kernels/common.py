"""The kernels' shared arithmetic in plain PyTorch.

``features_fwd`` is the fp32 Ψ exactly as the CUDA kernels compute it
(``csrc/slay_common.cuh::psi_tile``): normalize → anchor poly
φ_p = (ûᵀa)²/√P → PRF φ_e = exp(√(2s_r) ωᵀû − s_r)/√D → √w_r (φ_p ⊗ φ_e),
concatenated over r. The plain versions of the kernels use it, so a
kernel and its plain version differ only in summation order.
"""
from __future__ import annotations

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


def feature_statics(cfg: SlayFeatureConfig) -> FeatureStatics:
    cfg.check_supported()
    s_np, w_np = quadrature.yat_quadrature(cfg.num_quad_nodes, cfg.eps)
    return FeatureStatics(
        s_nodes=tuple(float(x) for x in s_np),
        sqrt_w=tuple(float(x) for x in np.sqrt(w_np)),
        num_anchors=cfg.num_anchors, num_prf=cfg.num_prf)


def causal_mask(scores: torch.Tensor) -> torch.Tensor:
    """Zero the strict upper triangle of (..., T, T) score blocks."""
    return torch.tril(scores)


def features_fwd(u: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                 st: FeatureStatics) -> torch.Tensor:
    """u (..., d) -> Ψ(u) (..., m), all in fp32."""
    u = u.float()
    inv = torch.rsqrt(torch.sum(u * u, dim=-1, keepdim=True) + NORM_EPS)
    uh = u * inv
    pa = uh @ a.float().T                                    # (..., P)
    phi_p = (pa * pa) * float(1.0 / np.sqrt(st.num_anchors))
    pw = uh @ w.float().T                                    # (..., D)
    inv_sqrt_d = float(1.0 / np.sqrt(st.num_prf))
    chunks = []
    for s, swr in zip(st.s_nodes, st.sqrt_w):
        phi_e = torch.exp(float(np.sqrt(2.0 * s)) * pw - s) * inv_sqrt_d
        kron = (phi_p[..., :, None] * phi_e[..., None, :]) * swr
        chunks.append(kron.flatten(-2))
    return torch.cat(chunks, dim=-1)
