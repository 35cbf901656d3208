"""SLAY feature map Ψ in PyTorch (paper §2.4), anchor + tensor fusion.

Numerics: the JAX reference path (``repro.core.features`` with
``use_pallas=False``) computes Ψ in the activation dtype, so in bf16 at
slayformer scale; the Pallas kernels compute Ψ in fp32
(``repro.kernels.common.features_fwd``). The port follows the kernels:
:func:`slay_features` always computes and returns fp32, on the CPU and on
the card alike. Parity tests against the JAX reference therefore run in
fp32, where the two agree.

All maps act on the trailing dimension: u (..., d) -> (..., F).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import quadrature
from repro_torch.device import resolve_device

_LATER = "ROADMAP Queue A item 3 (remaining poly kinds and fusions)"


def normalize(u: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize onto the unit sphere (paper Eq. 2), rsqrt in fp32."""
    uf = u.float()
    inv = torch.rsqrt(torch.sum(uf * uf, dim=dim, keepdim=True) + eps)
    return (uf * inv).to(u.dtype)


@dataclasses.dataclass(frozen=True)
class SlayFeatureConfig:
    """Static configuration of the SLAY feature map (per attention head)."""

    head_dim: int
    num_anchors: int = 8          # P
    num_prf: int = 16             # D
    num_quad_nodes: int = 3       # R
    eps: float = 1e-3             # kernel stabilizer (C = 2 + eps)
    poly_kind: str = "anchor"
    fusion: str = "tensor"
    prf_antithetic: bool = True   # pair omega with -omega

    @property
    def poly_dim(self) -> int:
        return self.num_anchors

    @property
    def node_dim(self) -> int:
        return self.poly_dim * self.num_prf

    @property
    def feature_dim(self) -> int:
        """m — final concatenated feature dimension."""
        return self.num_quad_nodes * self.node_dim

    def check_supported(self) -> None:
        if self.poly_kind != "anchor" or self.fusion != "tensor":
            raise NotImplementedError(
                f"poly_kind={self.poly_kind!r}, fusion={self.fusion!r}: the "
                f"port has anchor+tensor only so far; see {_LATER}")


def init_feature_params(cfg: SlayFeatureConfig, generator: torch.Generator,
                        *, device: str | torch.device = "cuda") -> dict:
    """Draw anchors (P, d) with unit rows and omegas (D, d) ~ N(0, I) in
    antithetic pairs (omega, -omega) when enabled. fp32.

    Draws come from ``generator`` (a CPU ``torch.Generator``), so they
    differ from ``jax.random``'s; parity tests inject the JAX draws.
    """
    cfg.check_supported()
    dev = resolve_device(device)
    d = cfg.head_dim
    anchors = torch.randn(cfg.num_anchors, d, generator=generator)
    anchors = anchors / torch.linalg.norm(anchors, dim=-1, keepdim=True)
    if cfg.prf_antithetic and cfg.num_prf % 2 == 0:
        half = torch.randn(cfg.num_prf // 2, d, generator=generator)
        omegas = torch.cat([half, -half], dim=0)
    else:
        omegas = torch.randn(cfg.num_prf, d, generator=generator)
    return {"anchors": anchors.to(dev), "omegas": omegas.to(dev)}


def poly_features(u: torch.Tensor, params: dict,
                  cfg: SlayFeatureConfig) -> torch.Tensor:
    """Anchor map φ_anc(u) = [(uᵀa_i)²]_i / √P — nonnegative."""
    cfg.check_supported()
    proj = u @ params["anchors"].to(u.dtype).T
    return torch.square(proj) / math.sqrt(cfg.num_anchors)


def prf_features(u: torch.Tensor, omegas: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """φ_PRF(u; s) = exp(√(2s) ωᵀu − s)/√D (paper Eq. 9); u unit-norm.

    ``s`` of shape (R,) appends a node axis: (..., R, D).
    """
    d_feat = omegas.shape[0]
    proj = u @ omegas.to(u.dtype).T                       # (..., D)
    logits = (torch.sqrt(2.0 * s)[:, None] * proj[..., None, :]
              - s[:, None])
    return torch.exp(logits) / math.sqrt(d_feat)


@functools.lru_cache(maxsize=16)
def _quadrature_tensors(num_nodes: int, eps: float, device: torch.device):
    s_np, w_np = quadrature.yat_quadrature(num_nodes, eps)
    return (torch.tensor(s_np, dtype=torch.float32, device=device),
            torch.tensor(w_np, dtype=torch.float32, device=device))


def quadrature_tensors(cfg: SlayFeatureConfig, device) -> tuple:
    """(s_r, w_r) as fp32 tensors on ``device`` (cached per device, so the
    decode loop does no host-to-device copy; callers must not mutate)."""
    return _quadrature_tensors(cfg.num_quad_nodes, cfg.eps,
                               torch.device(device))


def slay_features(u: torch.Tensor, params: dict,
                  cfg: SlayFeatureConfig) -> torch.Tensor:
    """Ψ(u) (..., m) fp32: √w_r-weighted Kronecker of the anchor and PRF
    features, concatenated over quadrature nodes (paper Eq. 10). Raw q/k
    are normalized internally."""
    cfg.check_supported()
    u = normalize(u.float())
    s, w = quadrature_tensors(cfg, u.device)
    phi_p = poly_features(u, params, cfg)                 # (..., P)
    phi_e = prf_features(u, params["omegas"], s)          # (..., R, D)
    kron = phi_p[..., None, :, None] * phi_e[..., :, None, :]  # (..,R,P,D)
    fused = torch.sqrt(w)[:, None, None] * kron
    return fused.reshape(*u.shape[:-1], cfg.feature_dim)
