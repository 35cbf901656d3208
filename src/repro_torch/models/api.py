"""Family-dispatching model API — the decoder family so far.

    params    = api.init_params(cfg, seed, device="cuda")
    logits, _ = api.forward(params, cfg, tokens)
    loss, mx  = api.loss_fn(params, cfg, batch)     # batch: tokens, labels
    logits, c = api.prefill(params, cfg, tokens)
    logits, c = api.decode_step(params, cfg, c, tokens)

and the slot surface of a pooled cache for continuous batching
(``reset_slot``, ``write_slot``, ``prefill_chunk``, ...).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def _mod(cfg: ArchConfig):
    cfg.check_supported()
    return transformer


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> dict:
    return _mod(cfg).init_params(cfg, seed, device=device)


def forward(params, cfg: ArchConfig, tokens):
    return _mod(cfg).forward(params, cfg, tokens)


def loss_fn(params, cfg: ArchConfig, batch: dict, *, remat=False):
    return _mod(cfg).loss_fn(params, cfg, batch, remat=remat)


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               device="cuda"):
    return _mod(cfg).init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg: ArchConfig, tokens, *, max_len: int | None = None,
            true_len=None):
    return _mod(cfg).prefill(params, cfg, tokens, max_len=max_len,
                             true_len=true_len)


def decode_step(params, cfg: ArchConfig, cache, tokens, active=None):
    return _mod(cfg).decode_step(params, cfg, cache, tokens, active)


# -- Slot-pooled cache surface (continuous-batching serving) ---------------
#
# A pool cache is an ordinary init_cache(cfg, num_slots); slots are batch
# rows. Admission and eviction are single-slot overwrites, O(slot bytes):
# the constant-state (S, z) and the per-slot positions live in contiguous
# batch-indexed tensors. The decode kernel updates them in place, so the
# slot ops below write into the pool's own storage and return it.


def reset_slot(cfg: ArchConfig, cache, slot: int):
    """Zero one slot (eviction). Slot-stable: other rows untouched."""
    return _mod(cfg).reset_slot(cfg, cache, slot)


def write_slot(cfg: ArchConfig, cache, src, slot: int):
    """Install a batch=1 request cache (a freshly prefilled request) into a
    pool slot (admission), copying into the pool's storage."""
    return _mod(cfg).write_slot(cfg, cache, src, slot)


def supports_paging(cfg: ArchConfig) -> bool:
    """Whether the pooled KV rings can be page-indexed: only non-windowed
    exact quadratic rings can. SLAY's per-slot state is O(1) and bypasses
    paging (the paper's serving asymmetry), so False for every ported
    config."""
    _mod(cfg)
    return False


def context_capacity(cfg: ArchConfig, max_len: int) -> int | None:
    """Rows of context (prefix + prompt + decode budget) one slot admits;
    ``None`` = unbounded (constant-state decode)."""
    return _mod(cfg).context_capacity(cfg, max_len)


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


def prefill_chunk(cfg: ArchConfig, params, cache, tokens):
    """Absorb one prompt chunk into an existing cache; last-token logits.

    Exact continuation for any chunk schedule: the linear (S, z) carry is
    fp32."""
    return _mod(cfg).prefill_chunk(params, cfg, cache, tokens)
