"""Token sampling for the serving engines (``repro.serving.sampling``).

The continuous engine samples inside its K-tick decode dispatch, on the
card, so only the (K, S) int32 token buffer crosses to the host.

Determinism contract, as in the JAX package: the Gumbel noise for
request ``rid``'s ``idx``-th generated token is keyed on
``(seed, rid, idx)`` by threefry ``fold_in`` (:mod:`repro_torch.prng`,
``jax.random``'s bits), independent of slot placement, batch
composition and macro-step size K. A request samples the same stream
whether it decodes alone, in a full pool, tick by tick or K ticks per
dispatch, and the same stream as the JAX engine up to near-ties of
``logits / T + g`` (the Gumbel noise's logarithms are each backend's
own, so they may differ from XLA's in the last bit).

Greedy (``temperature <= 0``) is a plain fp32 argmax, the first maximum
on ties, on the card and on the host alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng

# Finish-reason taxonomy. Every request ends with exactly one of these,
# stamped on its RequestStats, passed to its ``on_finish`` callback and
# counted in ``ServingMetrics.summary()``:
#
#   eos        sampled the request's eos_id (natural stop)
#   length     hit the max_new_tokens budget
#   deadline   missed its ttft/total deadline (ticks or wall clock)
#   cancelled  cancelled through ContinuousServingEngine.cancel
#   shed       dropped by the overload policy (queue full / queue wait)
#   fault      non-finite slot state detected and retries exhausted
#
# eos and length are the successful reasons (requests_completed counts
# them); the other four are degraded-mode exits.
FINISH_REASONS = ("eos", "length", "deadline", "cancelled", "shed", "fault")


def stop_hit(tok, gen, eos_id, max_new):
    """Natural-stop predicate: did the just-emitted token end the request?

    One logic for the (S,) device lanes of the macro step and for host
    scalars, so device masking and host eviction never disagree. ``gen``
    counts tokens emitted *including* ``tok``.
    """
    return (tok == eos_id) | (gen >= max_new)


def finish_reason_of(tok: int, eos_id: int) -> str:
    """Reason for a natural stop: ``eos`` wins over ``length`` when the
    budget-exhausting token is also the eos id."""
    return "eos" if tok == eos_id else "length"


def _gumbel_row(seed: int, rid, idx, vocab: int, *, device=None):
    """Gumbel(0, 1) noise keyed on (seed, rid, idx), fp32, (..., vocab).

    ``rid`` and ``idx`` are ints (one numpy row) or (S,) tensors (one row
    per slot on their device, as ``jax.vmap`` over the pool)."""
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), rid), idx)
    return prng.gumbel(key, (vocab,), device=device)


def scale_logits(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``logits / temperature`` with the temperature rounded to the
    logits' dtype first and a true division, as ``jnp`` divides by a
    Python float (a CPU scalar would make CUDA multiply by its
    reciprocal instead, one bit off)."""
    t = torch.full((), temperature, dtype=logits.dtype, device=logits.device)
    return logits / t


def sample_tokens(logits: torch.Tensor, rids: torch.Tensor,
                  idxs: torch.Tensor, *, temperature: float,
                  seed: int) -> torch.Tensor:
    """Per-slot sampling on the logits' device: (S, V) -> (S,) int32.

    ``rids`` and ``idxs`` are (S,) integer tensors, the request id and
    token index each slot samples (values of drained slots are ignored by
    the caller). Greedy argmax when ``temperature <= 0``; Gumbel-max
    otherwise, every row keyed on its own (seed, rid, idx).
    """
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    g = _gumbel_row(seed, rids, idxs, logits.shape[-1])
    return torch.argmax(scale_logits(logits, temperature) + g,
                        dim=-1).to(torch.int32)


def host_sample_token(row: np.ndarray, rid: int, idx: int, *,
                      temperature: float, seed: int) -> int:
    """Host reference sampler in numpy: the same math as
    :func:`sample_tokens` on one logits row; the parity oracle for the
    on-device path."""
    row = np.asarray(row, np.float32)
    if temperature <= 0.0:
        return int(np.argmax(row))
    g = _gumbel_row(seed, rid, idx, row.shape[-1])
    return int(np.argmax(row / np.float32(temperature) + g))
