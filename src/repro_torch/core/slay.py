"""SLAY attention — the paper's contribution as a PyTorch function.

spherical normalization → anchor/poly features → PRFs →
Gauss-Laguerre-weighted tensor fusion (Ψ) → linear attention reordering.

q: (..., L, H, Dh), k/v: (..., L, Hkv, Dh/dv). There is no ``use_pallas``
knob: the tensors' device picks the CUDA kernels (card) or their plain
fp32 twins (CPU).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import ops


def slay_attention(params: dict, q, k, v, cfg: SlayFeatureConfig, *,
                   causal: bool = True, chunk_size: int = 256,
                   delta: float = 1e-6, fuse_features: bool = True):
    """Full-sequence causal SLAY attention (training / prefill).

    With ``fuse_features`` (default) Ψ(Q)/Ψ(K) are computed inside the
    fused kernel and never written to device memory. ``fuse_features=False``
    keeps the two-dispatch path for A/B comparison: the feature-map kernel
    writes Ψ(Q), Ψ(K) in the activation dtype, then the scan kernel reads
    them. Both are differentiable. Non-causal attention is not ported yet.
    """
    if not causal:
        raise NotImplementedError(
            "non-causal SLAY attention is not ported yet (ROADMAP Queue A "
            "item 4, linear_attention.noncausal)")
    if fuse_features:
        return ops.slay_fused_attention(q, k, v, params, cfg,
                                        chunk_size=chunk_size, delta=delta)
    qf = ops.slay_features(q, params, cfg)
    kf = ops.slay_features(k, params, cfg)
    return ops.slay_causal_attention(qf, kf, v, chunk_size=chunk_size,
                                     delta=delta)


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Which attention mechanism a model layer uses."""

    kind: str = "slay"           # only "slay" is ported so far
    slay: SlayFeatureConfig | None = None
    chunk_size: int = 256
    fuse_features: bool = True
