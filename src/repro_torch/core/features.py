"""SLAY feature maps Ψ in PyTorch (paper §2.4): every polynomial kind and
fusion of ``repro.core.features``.

Two ingredients:

* polynomial features for x² = (q̂ᵀk̂)²: ``anchor`` (nonnegative, the
  default), ``exact`` vec(uuᵀ), the signed baselines ``rm`` (Random
  Maclaurin), ``tensorsketch`` and ``nystrom``, and ``laplace`` (no
  polynomial factor, App. F);
* positive random features (PRFs) for e^{2s x}.

They are fused per quadrature node by a Kronecker product (``tensor``,
the default), a sampled subset of its columns (``subsample``) or an
elementwise product (``hadamard``). Only anchor + tensor has CUDA kernels
(``cfg.kernelizable``), as only it has Pallas kernels in the JAX package;
the other configs are computed here, in PyTorch ops, on either device.

Numerics: the JAX reference path computes Ψ in the activation dtype, so
in bf16 at slayformer scale; the Pallas kernels compute Ψ in fp32
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

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import quadrature
from repro_torch.device import resolve_device

POLY_KINDS = ("anchor", "exact", "rm", "tensorsketch", "nystrom", "laplace")
FUSIONS = ("tensor", "subsample", "hadamard")


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
    poly_kind: str = "anchor"     # one of POLY_KINDS
    fusion: str = "tensor"        # one of FUSIONS
    sketch_dim: int = 0           # D_t for fusion="subsample" (0 -> P*D)
    prf_antithetic: bool = True   # pair omega with -omega

    def __post_init__(self):
        if self.poly_kind not in POLY_KINDS:
            raise ValueError(f"unknown poly_kind {self.poly_kind!r}")
        if self.fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {self.fusion!r}")

    @property
    def poly_dim(self) -> int:
        if self.poly_kind == "exact":
            return self.head_dim * self.head_dim
        if self.poly_kind == "laplace":
            return 1
        return self.num_anchors

    @property
    def node_dim(self) -> int:
        if self.fusion == "hadamard":
            return max(self.poly_dim, self.num_prf)
        if self.fusion == "subsample" and self.sketch_dim:
            return self.sketch_dim
        return self.poly_dim * self.num_prf

    @property
    def feature_dim(self) -> int:
        """m — final concatenated feature dimension."""
        return self.num_quad_nodes * self.node_dim

    @property
    def kernelizable(self) -> bool:
        """Whether the CUDA kernels compute this Ψ (anchor + tensor)."""
        return self.poly_kind == "anchor" and self.fusion == "tensor"


def init_feature_params(cfg: SlayFeatureConfig, generator: torch.Generator,
                        *, device: str | torch.device = "cuda") -> dict:
    """Draw the random projections of the feature map, fp32: anchors (P, d)
    with unit rows; omegas (D, d) ~ N(0, I) in antithetic pairs (omega,
    -omega) when enabled; for ``rm`` the signs ``rm_signs`` (2, P, d) of
    ±1; for ``subsample`` (with a ``sketch_dim``) ``subsample_idx``, that
    many distinct columns of the P·D Kronecker product (int64).

    Draws come from ``generator`` (a CPU ``torch.Generator``), so they
    differ from ``jax.random``'s; parity tests inject the JAX draws.
    """
    dev = resolve_device(device)
    d = cfg.head_dim
    anchors = torch.randn(cfg.num_anchors, d, generator=generator)
    anchors = anchors / torch.linalg.norm(anchors, dim=-1, keepdim=True)
    if cfg.prf_antithetic and cfg.num_prf % 2 == 0:
        half = torch.randn(cfg.num_prf // 2, d, generator=generator)
        omegas = torch.cat([half, -half], dim=0)
    else:
        omegas = torch.randn(cfg.num_prf, d, generator=generator)
    params = {"anchors": anchors, "omegas": omegas}
    if cfg.poly_kind == "rm":
        bits = torch.randint(0, 2, (2, cfg.num_anchors, d), generator=generator)
        params["rm_signs"] = 2.0 * bits.float() - 1.0
    if cfg.fusion == "subsample" and cfg.sketch_dim:
        total = cfg.poly_dim * cfg.num_prf
        params["subsample_idx"] = torch.randperm(
            total, generator=generator)[:cfg.sketch_dim]
    return {k: v.to(dev) for k, v in params.items()}


@functools.lru_cache(maxsize=16)
def _sketch_hashes(d: int, dp: int) -> tuple:
    """TensorSketch's hash and sign tables (h1, h2 (d,) int32; s1, s2 (d,)
    fp32 of ±1), numpy: the reference draws them inside its forward from
    the fixed ``jax.random.PRNGKey(17)``; the same bits come from
    ``prng`` on the host, once per (d, P)."""
    kh1, kh2, ks1, ks2 = prng.split(prng.PRNGKey(17), 4)
    return (prng.randint(kh1, (d,), 0, dp), prng.randint(kh2, (d,), 0, dp),
            prng.rademacher(ks1, (d,)), prng.rademacher(ks2, (d,)))


@functools.lru_cache(maxsize=16)
def _sketch_matrices(d: int, dp: int, device: torch.device) -> tuple:
    """The two count sketches as signed one-hot (d, P) fp32 matrices on
    ``device`` (cached; callers must not mutate): column h[i] of row i
    holds s[i], so u @ M adds each u[i]·s[i] into bucket h[i] as the
    reference's scatter-add does, in a fixed order (no atomics)."""
    h1, h2, s1, s2 = _sketch_hashes(d, dp)
    mats = []
    for h, sg in ((h1, s1), (h2, s2)):
        m = np.zeros((d, dp), np.float32)
        m[np.arange(d), h] = sg
        mats.append(torch.from_numpy(m).to(device))
    return tuple(mats)


def _tensorsketch(u: torch.Tensor, cfg: SlayFeatureConfig) -> torch.Tensor:
    """Count sketches of u under two hashes, composed by FFT (Pham & Pagh
    2013), fp32, cast back to u's dtype."""
    dp = cfg.num_anchors
    m1, m2 = _sketch_matrices(cfg.head_dim, dp, u.device)
    uf = u.float()
    c1, c2 = uf @ m1, uf @ m2
    out = torch.fft.irfft(torch.fft.rfft(c1, dim=-1) * torch.fft.rfft(c2, dim=-1),
                          n=dp, dim=-1)
    return out.to(u.dtype)


def _nystrom(u: torch.Tensor, anchors: torch.Tensor,
             cfg: SlayFeatureConfig) -> torch.Tensor:
    """K_xA (K_AA + λI)^{-1/2}, fp32 (signed through the whitening)."""
    a = anchors.float()
    kaa = torch.square(a @ a.T)
    eye = torch.eye(cfg.num_anchors, device=a.device)
    evals, evecs = torch.linalg.eigh(kaa + 1e-4 * eye)
    whiten = (evecs @ torch.diag(torch.rsqrt(torch.clamp(evals, min=1e-12)))
              @ evecs.T)
    kxa = torch.square(u.float() @ a.T)
    return (kxa @ whiten).to(u.dtype)


def poly_features(u: torch.Tensor, params: dict,
                  cfg: SlayFeatureConfig) -> torch.Tensor:
    """φ_poly(u) (..., poly_dim) for the degree-2 kernel (uᵀv)², in u's
    dtype."""
    kind = cfg.poly_kind
    if kind == "anchor":
        # φ_anc(u) = [(uᵀa_i)²]_i / √P — nonnegative.
        proj = u @ params["anchors"].to(u.dtype).T
        return torch.square(proj) / math.sqrt(cfg.num_anchors)
    if kind == "exact":
        outer = u[..., :, None] * u[..., None, :]
        return outer.reshape(*u.shape[:-1], cfg.head_dim * cfg.head_dim)
    if kind == "rm":
        # Random Maclaurin: (rᵀu)(sᵀu), unbiased but signed.
        signs = params["rm_signs"].to(u.dtype)
        pr, ps = u @ signs[0].T, u @ signs[1].T
        return (pr * ps) / math.sqrt(cfg.num_anchors)
    if kind == "nystrom":
        return _nystrom(u, params["anchors"], cfg)
    if kind == "tensorsketch":
        return _tensorsketch(u, cfg)
    # "laplace": no x² factor; the estimator targets Σ w_r e^{2 s_r x}.
    return torch.ones(*u.shape[:-1], 1, dtype=u.dtype, device=u.device)


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


def _pad_to(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The trailing axis cut to ``dim`` or padded with ones up to it."""
    if x.shape[-1] >= dim:
        return x[..., :dim]
    ones = torch.ones(*x.shape[:-1], dim - x.shape[-1], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, ones], dim=-1)


def slay_features(u: torch.Tensor, params: dict,
                  cfg: SlayFeatureConfig) -> torch.Tensor:
    """Ψ(u) (..., m) fp32: the √w_r-weighted fusion of the polynomial and
    PRF features, concatenated over quadrature nodes (paper Eq. 10). Raw
    q/k are normalized internally."""
    u = normalize(u.float())
    s, w = quadrature_tensors(cfg, u.device)
    phi_p = poly_features(u, params, cfg)                 # (..., poly_dim)
    phi_e = prf_features(u, params["omegas"], s)          # (..., R, D)
    sqrt_w = torch.sqrt(w)
    if cfg.fusion == "hadamard":
        # Elementwise fusion (biased baseline, App. F); the shorter factor
        # is padded with ones, as the reference pads it.
        dim = cfg.node_dim
        fused = (sqrt_w[:, None] * _pad_to(phi_p, dim)[..., None, :]
                 * _pad_to(phi_e, dim))                   # (..., R, dim)
    else:
        kron = phi_p[..., None, :, None] * phi_e[..., :, None, :]  # (..,R,P,D)
        fused = sqrt_w[:, None, None] * kron
        fused = fused.reshape(*fused.shape[:-2], cfg.poly_dim * cfg.num_prf)
        if cfg.fusion == "subsample" and cfg.sketch_dim:
            scale = math.sqrt(cfg.poly_dim * cfg.num_prf / cfg.sketch_dim)
            fused = fused[..., params["subsample_idx"]] * scale
    return fused.reshape(*u.shape[:-1], cfg.feature_dim)
