"""The decoder LM (dense, no MoE/SSM/vision) with SLAY attention.

Parameters are a plain dict laid out like the JAX package's pytree, so
``repro_torch.convert`` moves weights across unchanged::

    embed (V, d), final_norm (d,), [unembed (V, d) if untied],
    layers: pre_attn (nl, d), pre_mlp (nl, d),
            attn: wq (nl, d, H, dh), wk/wv (nl, d, Hkv, dh), wo (nl, H, dh, d),
            mlp: up (nl, d, ff), down (nl, ff, d) [, gate (nl, d, ff)],
    slay: anchors (P, dh), omegas (D, dh)   (fp32, shared by every layer)

Layers are stacked along a leading axis and run by a Python loop.
Training is ``loss_fn`` (next-token cross-entropy) under autograd, with
optional per-layer recomputation (``remat``). Serving is ``prefill``
(prompt -> last-token logits + (S, z) cache) then ``decode_step`` (one
token, the cache updated in place).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import init_feature_params
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import embed, mlp, rmsnorm, rope, unembed


def _param_shapes(cfg: ArchConfig) -> dict:
    """name -> (shape, init, scale); scale None = 1/sqrt(fan-in), where the
    fan-in is shape[-2] of the per-layer shape, as the JAX ParamSpec."""
    d, nl, dh = cfg.d_model, cfg.num_layers, cfg.resolved_head_dim
    H, Hkv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {
        "embed": ((cfg.vocab_size, d), "normal", 1.0),
        "final_norm": ((d,), "zeros", None),
        "layers.pre_attn": ((nl, d), "zeros", None),
        "layers.pre_mlp": ((nl, d), "zeros", None),
        "layers.attn.wq": ((nl, d, H, dh), "normal", None),
        "layers.attn.wk": ((nl, d, Hkv, dh), "normal", None),
        "layers.attn.wv": ((nl, d, Hkv, dh), "normal", None),
        "layers.attn.wo": ((nl, H, dh, d), "normal", None),
        "layers.mlp.up": ((nl, d, ff), "normal", None),
        "layers.mlp.down": ((nl, ff, d), "normal", None),
    }
    if cfg.gated_mlp:
        shapes["layers.mlp.gate"] = ((nl, d, ff), "normal", None)
    if not cfg.tie_embeddings:
        shapes["unembed"] = ((cfg.vocab_size, d), "normal", 1.0)
    return shapes


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random weights from ``seed`` (a CPU ``torch.Generator``, so the same
    seed gives the same weights on any device), in the activation dtype;
    the SLAY projections stay fp32."""
    cfg.check_supported()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict = {}
    for name, (shape, init, scale) in _param_shapes(cfg).items():
        if init == "zeros":
            x = torch.zeros(shape)
        else:
            if scale is None:
                scale = 1.0 / np.sqrt(max(shape[-2] if len(shape) >= 2
                                          else shape[-1], 1))
            x = torch.randn(shape, generator=gen) * float(scale)
        node = params
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = x.to(device=dev, dtype=cfg.activation_dtype)
    # Random projections, fp32, shared by every layer and head.
    params["slay"] = init_feature_params(cfg.slay_config(), gen, device=dev)
    return params


def _layer(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked ``layers`` subtree (views)."""
    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i]
                for k, v in node.items()}
    return take(params["layers"])


def _qkv(cfg: ArchConfig, lp: dict, x, positions):
    xa = rmsnorm(lp["pre_attn"], x)
    q = torch.einsum("...d,dhk->...hk", xa, lp["attn"]["wq"])
    k = torch.einsum("...d,dhk->...hk", xa, lp["attn"]["wk"])
    v = torch.einsum("...d,dhk->...hk", xa, lp["attn"]["wv"])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _finish_layer(cfg: ArchConfig, lp: dict, x, y):
    """Output projection, residual, MLP block."""
    x = x + torch.einsum("...hk,hkd->...d", y, lp["attn"]["wo"])
    return x + mlp(lp["mlp"], rmsnorm(lp["pre_mlp"], x), cfg.gated_mlp)


def _logits(params: dict, cfg: ArchConfig, x):
    x = rmsnorm(params["final_norm"], x)
    table = params.get("unembed", params["embed"])
    return unembed(table, x, cfg.final_logit_softcap)


def _layer_fwd(cfg: ArchConfig, slay_params: dict, positions, lp: dict, x):
    q, k, v = _qkv(cfg, lp, x, positions)
    y = attn.full_attention(cfg.attention_spec(), slay_params, q, k, v)
    return _finish_layer(cfg, lp, x, y)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            remat: bool | str = False):
    """tokens (B, L) -> (logits (B, L, V), aux loss 0).

    The SLAY projections are constants of the model (``detach``, as
    ``stop_gradient`` in the JAX package). ``remat=True`` recomputes each
    layer in the backward pass (``torch.utils.checkpoint``) instead of
    keeping its activations, so the fused forward runs twice per layer.
    """
    cfg.check_supported()
    if remat == "save_collectives":
        raise NotImplementedError(
            "remat='save_collectives' differs from remat=True only across "
            "tensor-parallel collectives, which come with sharding (ROADMAP "
            "Queue A item 13)")
    dev = params["embed"].device
    tokens = tokens.to(dev)
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    L = x.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    slay_params = {k: v.detach() for k, v in params["slay"].items()}
    layer = functools.partial(_layer_fwd, cfg, slay_params, positions)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        if remat:
            x = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x = layer(lp, x)
    return _logits(params, cfg, x), torch.zeros((), device=dev)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            remat: bool | str = False) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy: fp32 logits, logsumexp minus the gold
    logit, mean over tokens (+ 0.01 x the MoE aux loss, 0 here)."""
    logits, aux = forward(params, cfg, batch["tokens"], remat=remat)
    labels = batch["labels"].to(logits.device).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    total = nll + 0.01 * aux
    return total, {"nll": nll, "moe_aux": aux}


class DecodeCache(NamedTuple):
    """Stacked (num_layers leading) per-layer decode state; ``pos`` (B,)
    int32 counts the tokens each slot has seen."""

    attn: attn.AttnCache
    pos: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               device: str | torch.device = "cuda") -> DecodeCache:
    """A zero cache for ``batch`` slots. The SLAY state is constant-size,
    so ``max_len`` is accepted for API parity and unused."""
    cfg.check_supported()
    dev = resolve_device(device)
    a = attn.init_cache(cfg.attention_spec(), (cfg.num_layers, batch),
                        cfg.num_kv_heads, cfg.resolved_head_dim, device=dev)
    return DecodeCache(a, torch.zeros(batch, dtype=torch.int32, device=dev))


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            max_len: int | None = None, true_len: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Process a prompt batch; return last-token logits (B, 1, V) and a
    primed cache. ``true_len`` (B,) marks the real lengths of right-padded
    prompts: logits are read at ``true_len - 1`` and pad positions add
    nothing to the cache. ``max_len`` is accepted for API parity."""
    cfg.check_supported()
    dev = params["embed"].device
    tokens = tokens.to(dev)
    B, L = tokens.shape
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    valid = None
    if true_len is not None:
        true_len = true_len.to(dev)
        valid = positions < true_len[:, None]
    spec = cfg.attention_spec()
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        y = attn.full_attention(spec, params["slay"], q, k, v)
        caches.append(attn.prefill_cache(spec, params["slay"], k, v, valid))
        x = _finish_layer(cfg, lp, x, y)
    if true_len is None:
        x_last = x[:, -1]
        pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    else:
        idx = torch.clamp(true_len - 1, min=0).long()
        x_last = x[torch.arange(B, device=dev), idx]
        pos = true_len.to(torch.int32)
    a = attn.AttnCache(torch.stack([c.pos for c in caches]),
                       torch.stack([c.s for c in caches]),
                       torch.stack([c.z for c in caches]))
    return _logits(params, cfg, x_last)[:, None, :], DecodeCache(a, pos)


def decode_step(params: dict, cfg: ArchConfig, cache: DecodeCache,
                tokens: torch.Tensor, active: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step. tokens (B, 1) -> logits (B, 1, V).

    The cache's (S, z) tensors are updated in place (the JAX package
    donates them); the returned cache holds the same tensors and advanced
    positions. ``active`` (B,) freezes drained slots: their state stays
    bit-identical, their logits rows are meaningless.
    """
    cfg.check_supported()
    dev = params["embed"].device
    x = embed(params["embed"], tokens.to(dev)[:, 0]).to(cfg.activation_dtype)
    pos = cache.pos
    spec = cfg.attention_spec()
    ac = cache.attn
    new_pos = []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x[:, None], pos[:, None])
        layer_cache = attn.AttnCache(ac.pos[i], ac.s[i], ac.z[i])
        y, nc = attn.decode_step(spec, params["slay"], q[:, 0], k[:, 0],
                                 v[:, 0], layer_cache, active=active)
        new_pos.append(nc.pos)
        x = _finish_layer(cfg, lp, x, y)
    step = 1 if active is None else active.to(torch.int32)
    a = attn.AttnCache(torch.stack(new_pos), ac.s, ac.z)
    return _logits(params, cfg, x)[:, None, :], DecodeCache(a, pos + step)


# -- the slot surface of a pooled cache (continuous batching) -------------
#
# A pool is an ordinary init_cache(cfg, num_slots); slots are batch rows.
# The decode kernel updates the pool's (S, z) in place, so every slot op
# below writes into the pool's own storage (copy_, zero_, fill_) on slot
# ``slot`` of every layer and returns the same cache: a new tensor would
# leave the next decode writing into a stale buffer. Other slots' bytes
# are untouched (the reference's slot-stable contract).


def prefill_chunk(params: dict, cfg: ArchConfig, cache: DecodeCache,
                  tokens: torch.Tensor) -> tuple[torch.Tensor, DecodeCache]:
    """Absorb one prompt chunk into an existing decode cache.

    tokens (B, Lc); ``cache`` holds the state of the prefix absorbed so
    far (per-slot ``pos``). Returns last-token logits (B, 1, V) and the
    advanced cache (new tensors), so a prompt fed chunk by chunk ends in
    the state of a whole-prompt :func:`prefill` (the fp32 recurrence in
    another order of sums) and the engine can interleave prefill chunks
    with decode ticks.
    """
    cfg.check_supported()
    dev = params["embed"].device
    tokens = tokens.to(dev)
    Lc = tokens.shape[1]
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    positions = (cache.pos[:, None]
                 + torch.arange(Lc, dtype=torch.int32, device=dev)[None, :])
    spec = cfg.attention_spec()
    ac = cache.attn
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        y, nc = attn.prefill_chunk(spec, params["slay"], q, k, v,
                                   attn.AttnCache(ac.pos[i], ac.s[i], ac.z[i]))
        caches.append(nc)
        x = _finish_layer(cfg, lp, x, y)
    a = attn.AttnCache(torch.stack([c.pos for c in caches]),
                       torch.stack([c.s for c in caches]),
                       torch.stack([c.z for c in caches]))
    return (_logits(params, cfg, x[:, -1])[:, None, :],
            DecodeCache(a, cache.pos + Lc))


def reset_slot(cfg: ArchConfig, cache: DecodeCache, slot: int) -> DecodeCache:
    """Zero one slot of a pooled cache (eviction), in place: its (S, z) and
    positions. Constant-state SLAY: a single overwrite of the slot."""
    a = cache.attn
    for t in (a.s, a.z, a.pos):
        t[:, slot].zero_()
    cache.pos[slot] = 0
    return cache


def write_slot(cfg: ArchConfig, cache: DecodeCache, src: DecodeCache,
               slot: int) -> DecodeCache:
    """Install a single-sequence cache (batch 1, e.g. a freshly prefilled
    request) into slot ``slot`` of a pooled cache (admission), in place."""
    a, b = cache.attn, src.attn
    for dst, s in ((a.s, b.s), (a.z, b.z), (a.pos, b.pos)):
        dst[:, slot].copy_(s[:, 0])
    cache.pos[slot] = src.pos[0]
    return cache


def slot_state_finite(cfg: ArchConfig, cache: DecodeCache) -> torch.Tensor:
    """(B,) bool: every float decode-state element of each slot, over all
    layers, is finite (the NaN/Inf quarantine probe). Per-slot reductions
    only; positions are integers and are skipped."""
    ok = None
    for leaf in (cache.attn.s, cache.attn.z):
        f = torch.isfinite(leaf).flatten(2).all(-1).all(0)
        ok = f if ok is None else ok & f
    return ok


def corrupt_slot(cfg: ArchConfig, cache: DecodeCache, slot: int) -> DecodeCache:
    """Overwrite one slot's float state with NaN, in place (the chaos
    harness's fault; never on a production path). Positions stay, so the
    fault is numeric, not bookkeeping."""
    for t in (cache.attn.s, cache.attn.z):
        t[:, slot].fill_(float("nan"))
    return cache


def context_capacity(cfg: ArchConfig, max_len: int) -> int | None:
    """Context rows one slot admits: None (unbounded) for SLAY, whose
    constant-size (S, z) holds any context."""
    cfg.check_supported()
    return None


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    """Chunked prefill continues the fp32 (S, z) recurrence: always True
    for the ported SLAY decoder."""
    cfg.check_supported()
    return True
