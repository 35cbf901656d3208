"""SLAY attention — the paper's contribution as PyTorch functions.

spherical normalization → anchor/poly features → PRFs →
Gauss-Laguerre-weighted tensor fusion (Ψ) → linear attention reordering.

Usage (functional), as ``repro.core.slay``::

    cfg   = SlayConfig(head_dim=64)
    prm   = slay_init(cfg, torch.Generator().manual_seed(0))
    y     = slay_attention(prm, q, k, v, cfg, causal=True)

q: (..., L, H, Dh), k/v: (..., L, Hkv, Dh/dv). Decode with
:func:`slay_prefill_state` then :func:`slay_decode_step`. There is no
``use_pallas`` knob: the tensors' device picks the CUDA kernels (card) or
their plain fp32 twins (CPU); ``kernels.ops`` routes each feature config.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import linear_attention as la
from repro_torch.core.features import SlayFeatureConfig, init_feature_params
from repro_torch.kernels import ops

# The feature config under the reference's public name.
SlayConfig = SlayFeatureConfig

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

    With ``fuse_features`` (default) ``ops.slay_fused_attention`` runs
    the route ``ops.attention_route`` picks before any launch: the fused
    kernel, Ψ(Q)/Ψ(K) computed inside it and never written to device
    memory; else the two-dispatch kernels; else Ψ from PyTorch ops and
    the scan kernel (every config but anchor + tensor, and anchor configs
    the kernels' limits refuse). ``fuse_features=False`` keeps the
    two-dispatch path for A/B comparison: Ψ(Q), Ψ(K) written in the
    activation dtype (``ops.slay_features``: the feature-map kernel where
    it takes the config), then the scan kernel reads them. Both are
    differentiable. Non-causal attention (``causal=False``) maps Ψ the
    same way and contracts it in PyTorch
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


def slay_init(cfg: SlayConfig, generator: torch.Generator, *,
              device: str | torch.device = "cuda") -> dict:
    """The random projections (anchors, omegas, and ``rm_signs`` or
    ``subsample_idx`` where the config needs them), drawn from
    ``generator`` (:func:`repro_torch.core.features.init_feature_params`).
    Shared across layers and heads by default (paper App. H); draw again
    to untie."""
    return init_feature_params(cfg, generator, device=device)


def slay_prefill_state(params: dict, k, v, cfg: SlayConfig) -> la.LinearState:
    """Absorb a whole prompt into the decode state: k (..., L, Hkv, d),
    v (..., L, Hkv, dv) -> (S (..., Hkv, m, dv), z (..., Hkv, m)) fp32.
    Ψ(k) goes through ``ops.slay_features`` (B7 on the card where
    ``ops.attention_route`` sends the config); the Ψᵀv sum is a plain
    product, as in the reference."""
    return la.prefill_state(ops.slay_features(k, params, cfg), v)


def slay_decode_step(params: dict, q, k, v, state: la.LinearState,
                     cfg: SlayConfig, delta: float = 1e-6):
    """One token: q (..., H, d), k/v (..., Hkv, d/dv), ``state`` (S, z)
    fp32 -> (y (..., H, dv) in v's dtype, the new state).

    Ψ(q), Ψ(k) go through ``ops.slay_features``, the step through K2
    (``ops.decode_linear_step``; its plain twin on the CPU). K2 updates
    (S, z) in place, so the step runs on a copy: the caller's ``state`` is
    left as it was, as the reference's functional step leaves it. K2 takes
    m up to ``decode_step.max_feature_dim`` (230,120 at one q head per kv
    head and dv = 64) and raises ``ValueError`` past it.
    """
    *lead, H, _ = q.shape
    hkv, dv = k.shape[-2], v.shape[-1]
    m = cfg.feature_dim
    qf = ops.slay_features(q, params, cfg).reshape(-1, H, m)
    kf = ops.slay_features(k, params, cfg).reshape(-1, hkv, m)
    b = qf.shape[0]
    s = state.s.float().reshape(b, hkv, m, dv).clone()
    z = state.z.float().reshape(b, hkv, m).clone()
    y, s, z = ops.decode_linear_step(qf, kf, v.reshape(b, hkv, dv), s, z,
                                     delta=delta)
    return (y.reshape(*lead, H, dv),
            la.LinearState(s.reshape(state.s.shape), z.reshape(state.z.shape)))


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
