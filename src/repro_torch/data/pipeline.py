"""Deterministic, step-indexed synthetic LM data, as ``repro.data.pipeline``.

The batch for step t is a pure function of (seed, t), so a restart from a
checkpoint at step t reproduces the token stream with no loader state to
keep. Tokens follow an approximate Zipf law with a learnable bigram gate.

The construction is split from the random draw. ``tokens_from_uniform``
turns uniforms u (B, L + 1) into tokens exactly as the JAX package does
(search of a float32 CDF, clip, bigram gate), so the same u gives the same
batch on both sides. ``make_batch`` draws u from
``np.random.default_rng([seed, step])``: step-indexed and resume-exact,
but a different stream from the JAX package's ``jax.random`` draw, so the
two packages' batches for one (seed, step) differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _zipf_cdf(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_alpha)
    p /= p.sum()
    return np.cumsum(p)


def tokens_from_uniform(u, cdf: np.ndarray, cfg: DataConfig) -> dict:
    """Uniforms u (B, L + 1) in [0, 1) -> {"tokens", "labels"} (B, L) int32
    CPU tensors. The CDF is searched in float32, as JAX searches
    ``jnp.asarray(cdf)`` with 64-bit floats off."""
    u = torch.from_numpy(np.array(u, dtype=np.float32))
    cdf32 = torch.from_numpy(np.asarray(cdf, dtype=np.float32))
    toks = torch.searchsorted(cdf32, u).to(torch.int32)
    toks = torch.clamp(toks, 0, cfg.vocab_size - 1)
    # Every even position repeats a shifted copy of the previous token half
    # the time (learnable bigram signal).
    prev = torch.roll(toks, 1, dims=-1)
    gate = (torch.arange(cfg.seq_len + 1) % 2 == 0) & (u < 0.5)
    toks = torch.where(gate, (prev + 1) % cfg.vocab_size, toks)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(cfg: DataConfig, step: int,
               cdf: np.ndarray | None = None) -> dict:
    """Global batch for ``step``: tokens/labels (B, L) int32, labels the
    next tokens."""
    if cdf is None:
        cdf = _zipf_cdf(cfg)
    rng = np.random.default_rng([cfg.seed, step])
    u = rng.random((cfg.global_batch, cfg.seq_len + 1), dtype=np.float32)
    return tokens_from_uniform(u, cdf, cfg)


def batch_iterator(cfg: DataConfig, start_step: int = 0):
    """Infinite deterministic iterator (resume-exact from any step)."""
    cdf = _zipf_cdf(cfg)
    step = start_step
    while True:
        yield step, make_batch(cfg, step, cdf)
        step += 1
