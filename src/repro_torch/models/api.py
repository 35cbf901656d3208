"""Family-dispatching model API: the decoder family (dense or top-k MoE,
gemma2's local/global layers, internvl2's vision patch prefix; SLAY, the
linear baselines favor, cosformer, elu1 and the exact kinds softmax,
yat, yat_spherical) and the SSM families ``ssm`` (mamba2, attention-free
SSD layers) and ``hybrid`` (hymba, attention beside SSD heads), all in
``models.transformer``, and ``encdec`` (whisper) in ``models.whisper``,
as in the reference.

    params    = api.init_params(cfg, seed, device="cuda")
    axes      = api.param_axes(cfg)          # logical sharding axes tree
    logits, _ = api.forward(params, cfg, tokens)
    loss, mx  = api.loss_fn(params, cfg, batch)     # batch: tokens, labels
    logits, c = api.prefill(params, cfg, tokens)
    logits, c = api.decode_step(params, cfg, c, tokens)

The reference's ``forward`` and ``prefill`` take a batch dict; the port's
take the tokens and the frontend stand-ins as keywords
(``patch_embeds=`` (B, P, d) for a vision config, ``frame_embeds=`` (B,
enc_seq, d) for encdec, which needs them), so every caller of a plain
decoder keeps its call; ``loss_fn`` reads both from its batch, as the
reference's does.

and the slot surface of a pooled cache for continuous batching
(``reset_slot``, ``write_slot``, ``prefill_chunk``, ...) with its
speculative-decoding part (``verify_chunk``, ``rollback_slots``, ...).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import init_feature_params
from repro_torch.models import transformer, whisper


def _mod(cfg: ArchConfig):
    """The module of ``cfg``'s family: ``whisper`` for encdec,
    ``transformer`` for decoder, ssm and hybrid."""
    cfg.check_supported()
    return whisper if cfg.family == "encdec" else transformer


def layer_kinds(cfg: ArchConfig):
    """Per-layer flags (numpy int32): 1 = a local sliding-window softmax
    layer, 0 = a layer of the config's attention kind (every layer but
    gemma2's local ones)."""
    cfg.check_supported()
    return transformer._layer_kinds(cfg)


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> dict:
    return _mod(cfg).init_params(cfg, seed, device=device)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes at any
    width, nothing allocated."""
    return init_params(cfg, device="meta")


def param_axes(cfg: ArchConfig) -> dict:
    """The logical sharding axes of every parameter leaf (a tree of
    tuples), the reference's ``param_axes``."""
    return _mod(cfg).param_axes(cfg)


def forward(params, cfg: ArchConfig, tokens, *, patch_embeds=None,
            frame_embeds=None):
    if cfg.family == "encdec":
        return whisper.forward(params, cfg, tokens, frame_embeds)
    return _mod(cfg).forward(params, cfg, tokens, patch_embeds=patch_embeds)


def loss_fn(params, cfg: ArchConfig, batch: dict, *, remat=False):
    return _mod(cfg).loss_fn(params, cfg, batch, remat=remat)


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               page_size: int = 0, num_pages: int = 0, device="cuda"):
    """A zero decode cache; ``page_size`` > 0 pages an exact kind's rings
    (ignored where :func:`supports_paging` is False, encdec's among
    them)."""
    return _mod(cfg).init_cache(cfg, batch, max_len, page_size=page_size,
                                num_pages=num_pages, device=device)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
                   page_size: int = 0, num_pages: int = 0):
    """The decode cache's shapes and dtypes without allocation: the cache
    of :func:`init_cache` in ``meta`` tensors (the JAX package's
    ``eval_shape``), e.g. for its bytes (``prefix_cache.tree_bytes``)."""
    return init_cache(cfg, batch, max_len, page_size=page_size,
                      num_pages=num_pages, device=torch.device("meta"))


def prefill(params, cfg: ArchConfig, tokens, *, patch_embeds=None,
            frame_embeds=None, max_len: int | None = None, true_len=None):
    """Absorb a prompt batch; ``true_len`` (B,) marks the real lengths of
    right-padded prompts, a vision prefix's rows included."""
    if cfg.family == "encdec":
        return whisper.prefill(params, cfg, tokens, frame_embeds,
                               max_len=max_len, true_len=true_len)
    return _mod(cfg).prefill(params, cfg, tokens, patch_embeds=patch_embeds,
                             max_len=max_len, true_len=true_len)


def decode_step(params, cfg: ArchConfig, cache, tokens, active=None):
    return _mod(cfg).decode_step(params, cfg, cache, tokens, active)


# -- Slot-pooled cache surface (continuous-batching serving) ---------------
#
# A pool cache is an ordinary init_cache(cfg, num_slots); slots are batch
# rows. Admission and eviction are single-slot overwrites, O(slot bytes):
# SLAY's constant-state (S, z), an exact kind's rings (or the pages a slot
# owns), an SSD block's scan carry and conv tail and the per-slot
# positions. The decode step updates them in
# place, so the slot ops below write into the pool's own storage and
# return it.


def reset_slot(cfg: ArchConfig, cache, slot: int, pages=None):
    """Zero one slot (eviction). Slot-stable: other rows untouched. A
    paged pool also installs ``pages``, the allocator's tables after the
    slot's free."""
    return _mod(cfg).reset_slot(cfg, cache, slot, pages)


def write_slot(cfg: ArchConfig, cache, src, slot: int, pages=None):
    """Install a batch=1 request cache (a freshly prefilled request) into a
    pool slot (admission), copying into the pool's storage. A paged pool
    first installs ``pages``, the allocator's tables after the slot's
    allocation."""
    return _mod(cfg).write_slot(cfg, cache, src, slot, pages)


def supports_paging(cfg: ArchConfig) -> bool:
    """Whether the pooled KV rings can be page-indexed: only non-windowed
    exact quadratic rings of a decoder can. SLAY's per-slot state and an
    SSD carry are O(1) and bypass paging (the paper's serving
    asymmetry)."""
    return _mod(cfg).supports_paging(cfg)


def context_capacity(cfg: ArchConfig, max_len: int) -> int | None:
    """Rows of context (prefix + prompt + decode budget) one slot admits;
    ``None`` = unbounded (constant-state decode, or windowed rings, which
    wrap exactly)."""
    return _mod(cfg).context_capacity(cfg, max_len)


def supports_masked_prefill(cfg: ArchConfig) -> bool:
    """Whether ``prefill`` takes ``true_len`` (right-padded prompts);
    False with windowed rings, where a pad row would evict in-window
    history."""
    return _mod(cfg).supports_masked_prefill(cfg)


def slot_state_finite(cfg: ArchConfig, cache):
    """(B,) bool per-slot finiteness probe over the pooled decode state:
    True where every float state element of that slot is finite (the
    quarantine guard's detection surface). Reductions are per slot."""
    return _mod(cfg).slot_state_finite(cfg, cache)


def corrupt_slot(cfg: ArchConfig, cache, slot: int):
    """Overwrite one slot's float state with NaN (fault injection), with
    ``reset_slot``'s slot-stable write, so injecting a fault never
    perturbs a neighbouring slot."""
    return _mod(cfg).corrupt_slot(cfg, cache, slot)


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    """Whether prefill can be fed chunk by chunk with state continuation."""
    return _mod(cfg).supports_chunked_prefill(cfg)


def prefill_chunk(cfg: ArchConfig, params, cache, tokens, embeds=None):
    """Absorb one prompt chunk into an existing cache; last-token logits.

    Exact continuation for any chunk schedule: SLAY's (S, z) carry and an
    SSD block's scan carry and conv tail are fp32; the exact kinds attend
    to their ring prefix. ``embeds`` (B, Lc, d) feeds pre-embedded rows
    (a vision patch prefix) in place of token ids. encdec raises."""
    return _mod(cfg).prefill_chunk(params, cfg, cache, tokens,
                                   embeds=embeds)


# -- Speculative decoding surface ------------------------------------------


def supports_speculative(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` can verify draft-verify speculative decoding: an
    exact kind's ring (rollback is a ``pos`` rewind) whose parameters are
    the SLAY draft's but for the draft's ``slay`` entry."""
    return _mod(cfg).supports_speculative(cfg)


def draft_config(cfg: ArchConfig) -> ArchConfig:
    """The linear SLAY draft twin of a verifier config: the same
    architecture with ``attn_kind="slay"``, the paper's linearization of
    the verifier's own kernel."""
    return dataclasses.replace(cfg, attn_kind="slay")


def ensure_draft_params(draft_cfg: ArchConfig, params: dict) -> dict:
    """The verifier's parameters with the draft's ``slay`` projections
    (anchors, omegas; fp32, on the parameters' device) added.

    The draft shares every other weight with the verifier. A tree that
    has a ``slay`` entry keeps it: one converted from the JAX package
    after its ``ensure_draft_params`` carries the JAX draft's projections.
    Otherwise they are drawn by :func:`init_feature_params` from a
    ``torch.Generator`` seeded 0, so the draft is fixed per checkpoint;
    those bits differ from ``jax.random.PRNGKey(0)``'s, so only a
    converted tree gives the JAX engine's draft. (The draft decides the
    acceptance rate, never the emitted distribution.)"""
    if "slay" in params:
        return params
    return {**params, "slay": init_feature_params(
        draft_cfg.slay_config(), torch.Generator().manual_seed(0),
        device=params["embed"].device)}


def verify_chunk(cfg: ArchConfig, params, cache, tokens, active=None):
    """Score ``Lc`` candidate tokens per slot in one exact chunk: tokens
    (B, Lc) -> (logits (B, Lc, V), the cache advanced in place). Row j is
    the verifier's distribution after absorbing tokens[:, :j + 1];
    ``active`` masks drained slots as ``decode_step`` does."""
    return _mod(cfg).verify_chunk(params, cfg, cache, tokens, active)


def slot_positions(cfg: ArchConfig, cache) -> torch.Tensor:
    """(B,) int32 per-slot absorbed-context horizons (the cache's own
    tensor)."""
    return cache.pos


def rollback_slots(cfg: ArchConfig, cache, new_pos):
    """Rewind per-slot horizons to ``new_pos`` (B,) in place: a ``pos``
    rewind, no ring bytes moved, a paged pool's tables untouched."""
    return _mod(cfg).rollback_slots(cfg, cache, new_pos)
