"""SLAY attention — the paper's contribution as a PyTorch function.

spherical normalization → anchor/poly features → PRFs →
Gauss-Laguerre-weighted tensor fusion (Ψ) → linear attention reordering.

q: (..., L, H, Dh), k/v: (..., L, Hkv, Dh/dv). There is no ``use_pallas``
knob: the tensors' device picks the fused CUDA kernel (card) or its plain
fp32 twin (CPU).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import ops


def slay_attention(params: dict, q, k, v, cfg: SlayFeatureConfig, *,
                   causal: bool = True, chunk_size: int = 256,
                   delta: float = 1e-6, fuse_features: bool = True):
    """Full-sequence causal SLAY attention (prefill): Ψ(Q)/Ψ(K) are
    computed inside the fused kernel and never written to device memory.

    ``fuse_features=False`` (the two-dispatch feature-map → scan path, B7
    then B5) and non-causal attention are not ported yet.
    """
    if not causal:
        raise NotImplementedError(
            "non-causal SLAY attention is not ported yet (ROADMAP Queue A "
            "item 4, linear_attention.noncausal)")
    if not fuse_features:
        raise NotImplementedError(
            "fuse_features=False needs the feature-map and scan kernels "
            "(B7, B5), still queued in ROADMAP Queue B")
    return ops.slay_fused_attention(q, k, v, params, cfg,
                                    chunk_size=chunk_size, delta=delta)


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Which attention mechanism a model layer uses."""

    kind: str = "slay"           # only "slay" is ported so far
    slay: SlayFeatureConfig | None = None
    chunk_size: int = 256
    fuse_features: bool = True
