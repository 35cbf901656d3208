"""SLAY attention — the paper's contribution as a PyTorch function.

spherical normalization → anchor/poly features → PRFs →
Gauss-Laguerre-weighted tensor fusion (Ψ) → linear attention reordering.

q: (..., L, H, Dh), k/v: (..., L, Hkv, Dh/dv). There is no ``use_pallas``
knob: the tensors' device picks the CUDA kernels (card) or their plain
fp32 twins (CPU).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import linear_attention as la
from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import ops

# The linear kinds: a constant-size (S, z) decode state. SLAY, then the
# paper's linear baselines (Table 5, ``core.baselines``).
LINEAR_KINDS = ("slay", "favor", "cosformer", "elu1")
# The exact quadratic kinds: a KV ring per slot instead of (S, z).
EXACT_KINDS = ("softmax", "yat", "yat_spherical")
# Every attention kind of the port.
ATTN_KINDS = LINEAR_KINDS + EXACT_KINDS


def slay_attention(params: dict, q, k, v, cfg: SlayFeatureConfig, *,
                   causal: bool = True, chunk_size: int = 256,
                   delta: float = 1e-6, fuse_features: bool = True):
    """Full-sequence causal SLAY attention (training / prefill).

    With ``fuse_features`` (default) Ψ(Q)/Ψ(K) are computed inside the
    fused kernel and never written to device memory. ``fuse_features=False``
    keeps the two-dispatch path for A/B comparison: the feature-map kernel
    writes Ψ(Q), Ψ(K) in the activation dtype, then the scan kernel reads
    them. Both are differentiable. Non-causal attention (``causal=False``)
    maps Ψ through the feature-map kernel and contracts it in PyTorch
    (:func:`linear_attention.noncausal`), as the JAX package does in jnp.
    """
    if not causal:
        qf = ops.slay_features(q, params, cfg)
        kf = ops.slay_features(k, params, cfg)
        return la.noncausal(qf, kf, v, delta=delta)
    if fuse_features:
        return ops.slay_fused_attention(q, k, v, params, cfg,
                                        chunk_size=chunk_size, delta=delta)
    qf = ops.slay_features(q, params, cfg)
    kf = ops.slay_features(k, params, cfg)
    return ops.slay_causal_attention(qf, kf, v, chunk_size=chunk_size,
                                     delta=delta)


def slay_cross_attention(params: dict, q, k, v, cfg: SlayFeatureConfig,
                         delta: float = 1e-6):
    """Non-causal cross-attention (whisper's decoder over its encoder):
    q (..., Lq, H, Dh) against k/v (..., Lk, Hkv, *) of another length,
    Ψ through the feature-map kernel, then :func:`linear_attention.
    noncausal`."""
    return slay_attention(params, q, k, v, cfg, causal=False, delta=delta)


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Which attention mechanism a model layer uses."""

    kind: str = "slay"  # slay|softmax|yat|yat_spherical|favor|cosformer|elu1
    slay: SlayFeatureConfig | None = None
    window: int = 0              # sliding window for local softmax layers
    logit_softcap: float = 0.0
    chunk_size: int = 256
    fuse_features: bool = True

    @property
    def is_linear(self) -> bool:
        """Constant-size (S, z) decode state; else a KV ring."""
        return self.kind in LINEAR_KINDS


def feature_dim(spec: AttentionSpec, head_dim: int) -> int:
    """m, the width of a linear kind's features and of its (S, z) state
    (``_baseline_dim`` in the JAX package): SLAY's R·P·D, favor's 64
    random features, cosformer's [cos, sin] halves, elu1's head dim."""
    if spec.kind == "slay":
        return spec.slay.feature_dim
    if spec.kind == "favor":
        return 64
    if spec.kind == "cosformer":
        return 2 * head_dim
    if spec.kind == "elu1":
        return head_dim
    raise ValueError(f"{spec.kind!r} is not a linear kind")
