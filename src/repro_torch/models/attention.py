"""Attention dispatch for the ported decoder, ``kind="slay"`` only.

Convention as in ``repro.models.attention``: q (..., L, H, Dh),
k/v (..., L, Hkv, Dh) -> (..., L, H, Dh). The decode cache of a linear
kind is the constant-size (S, z) running state. Softmax and the exact yat
kinds come later (ROADMAP Queue A items 7 and 12).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import linear_attention as la
from repro_torch.core import slay as slay_mod
from repro_torch.core.features import slay_features
from repro_torch.core.slay import AttentionSpec
from repro_torch.kernels import ops


class AttnCache(NamedTuple):
    """Decode cache of the SLAY kind: the constant-size (S, z) state.

    ``pos`` counts tokens seen so far, per slot (lead-shaped). The JAX
    package's ring-buffer ``k``/``v`` fields belong to the softmax and yat
    kinds, not ported yet.
    """

    pos: torch.Tensor                # int32, lead-shaped
    s: torch.Tensor                  # (..., Hkv, m, dv) fp32
    z: torch.Tensor                  # (..., Hkv, m)     fp32


def _require_slay(spec: AttentionSpec) -> None:
    if spec.kind != "slay":
        raise NotImplementedError(
            f"attention kind {spec.kind!r} is not ported yet; the port has "
            f"'slay' (ROADMAP Queue A items 7 and 12)")


def init_cache(spec: AttentionSpec, lead_shape, num_kv: int, dv: int, *,
               device: torch.device) -> AttnCache:
    _require_slay(spec)
    st = la.init_state(lead_shape, num_kv, spec.slay.feature_dim, dv,
                       device=device)
    pos = torch.zeros(lead_shape, dtype=torch.int32, device=device)
    return AttnCache(pos, st.s, st.z)


def full_attention(spec: AttentionSpec, params: dict | None, q, k, v, *,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill): the fused SLAY kernel,
    or with ``spec.fuse_features`` False the feature-map kernel then the
    scan kernel."""
    _require_slay(spec)
    return slay_mod.slay_attention(
        params, q, k, v, spec.slay, causal=causal,
        chunk_size=spec.chunk_size, fuse_features=spec.fuse_features)


def prefill_cache(spec: AttentionSpec, params: dict | None, k, v,
                  valid=None) -> AttnCache:
    """Absorb a whole prompt's keys/values into a fresh (S, z) state.

    k/v: (..., L, Hkv, *). ``valid`` (..., L) bool masks a right-padded
    prompt: invalid positions get zero key features and add nothing.
    """
    _require_slay(spec)
    L, lead = k.shape[-3], k.shape[:-3]
    if valid is None:
        pos = torch.full(lead, L, dtype=torch.int32, device=k.device)
    else:
        pos = valid.to(torch.int32).sum(-1).expand(lead)
    kf = slay_features(k, params, spec.slay)
    if valid is not None:
        kf = torch.where(valid[..., None, None], kf, 0.0)
    st = la.prefill_state(kf, v)
    return AttnCache(pos, st.s, st.z)


def prefill_chunk(spec: AttentionSpec, params: dict | None, q, k, v,
                  cache: AttnCache) -> tuple[torch.Tensor, AttnCache]:
    """Absorb one prompt chunk into an existing (S, z) state.

    q (B, Lc, H, Dh), k/v (B, Lc, Hkv, *); ``cache.pos`` (B,) counts the
    tokens absorbed so far. The chunked causal scan in torch seeded with
    the cache's fp32 state, as the JAX package runs it in jnp outside any
    kernel: a prompt fed chunk by chunk ends in the state of a whole-prompt
    prefill, up to the order of the fp32 sums. Returns new tensors; the
    cache's are not written.
    """
    _require_slay(spec)
    Lc = q.shape[1]
    qf = slay_features(q, params, spec.slay)
    kf = slay_features(k, params, spec.slay)
    y, st = la.causal_chunked(
        qf, kf, v, chunk_size=max(min(spec.chunk_size, Lc), 1),
        init_state=la.LinearState(cache.s, cache.z), return_state=True)
    return y, AttnCache(cache.pos + Lc, st.s, st.z)


def decode_step(spec: AttentionSpec, params: dict | None, q, k, v,
                cache: AttnCache, *,
                active=None) -> tuple[torch.Tensor, AttnCache]:
    """One token for a batch of slots. q (B, H, Dh), k/v (B, Hkv, *)
    -> (B, H, dv). The cache's s and z are updated in place by the decode
    kernel (its plain twin on the CPU) and returned in the new cache.

    ``active`` (B,) masks continuous-batching pool rows: drained rows keep
    their (S, z) bit-identical and ``pos`` frozen, and output y = 0.
    """
    _require_slay(spec)
    if q.dim() != 3:
        raise ValueError(f"decode q must be (B, H, Dh), got {tuple(q.shape)}")
    step = 1 if active is None else active.to(torch.int32)
    qf = slay_features(q, params, spec.slay)
    kf = slay_features(k, params, spec.slay)
    y, s2, z2 = ops.decode_linear_step(qf, kf, v, cache.s, cache.z, active)
    return y, AttnCache(cache.pos + step, s2, z2)
