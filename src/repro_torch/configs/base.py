"""Architecture and serving configuration for the port.

A torch counterpart of ``repro.configs.base.ArchConfig`` holding the
fields the ported decoder uses. MoE, SSM, hybrid, encoder-decoder and
local/global windows are not ported yet (ROADMAP Queue A item 12).
``ServingConfig`` has the reference's fields, defaults and validation.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.core.slay import AttentionSpec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # only "decoder" is ported
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    final_logit_softcap: float = 0.0
    gated_mlp: bool = True
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    attn_kind: str = "slay"          # only "slay" is ported
    slay_anchors: int = 8
    slay_prf: int = 16
    slay_quad_nodes: int = 3
    chunk_size: int = 256
    fuse_attention_features: bool = True
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def slay_config(self) -> SlayFeatureConfig:
        return SlayFeatureConfig(
            head_dim=self.resolved_head_dim, num_anchors=self.slay_anchors,
            num_prf=self.slay_prf, num_quad_nodes=self.slay_quad_nodes)

    def attention_spec(self) -> AttentionSpec:
        return AttentionSpec(kind=self.attn_kind, slay=self.slay_config(),
                             chunk_size=self.chunk_size,
                             fuse_features=self.fuse_attention_features)

    def check_supported(self) -> None:
        if self.family != "decoder" or self.attn_kind != "slay":
            raise NotImplementedError(
                f"{self.name}: family={self.family!r}, attn_kind="
                f"{self.attn_kind!r}; the port has the SLAY decoder only so "
                f"far (ROADMAP Queue A items 7 and 12)")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching engine knobs (``repro_torch.serving.engine``),
    the reference's fields, defaults and validation
    (``repro.configs.base.ServingConfig``).

    The pool has ``num_slots`` decode slots; the SLAY state is constant
    size, so ``max_len`` bounds nothing for it. Prompts are absorbed
    ``prefill_chunk`` tokens per engine tick; ``decode_ticks_per_prefill``
    decode ticks run between two prefill chunks when both kinds of work
    wait. ``macro_ticks`` (K) decode ticks run per dispatch with sampling
    on the card, and the host pulls one (K, num_slots) token buffer per
    dispatch; streams are the same for every K (sampling is keyed on
    (seed, rid, token index)).

    Overload (``max_queue`` > 0): ``reject_new`` raises
    ``QueueFullError``, ``shed_oldest`` sheds the longest-waiting queued
    request, ``queue_wait`` admits all and sheds what has waited more
    than ``queue_wait_ticks``. ``fault_guard`` checks every slot's state
    and logits for NaN/Inf inside the dispatch; a faulted request is
    retried ``fault_retries`` times, then ends as ``fault``.
    ``debug_audit`` checks the slot pool's bookkeeping at the end of
    every ``run()``.

    :meth:`check_supported` rejects the knobs of features the port does
    not have yet; the engine calls it when it is built.
    """

    num_slots: int = 4
    max_len: int = 4096
    prefill_chunk: int = 128          # 0 = absorb whole prompts in one tick
    decode_ticks_per_prefill: int = 1
    max_queue: int = 0                # 0 = unbounded admission queue
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0
    macro_ticks: int = 8              # K decode ticks per device dispatch
    prefill_buckets: bool = True      # pow-2 bucketing of fallback prefill
    prefill_bucket_min: int = 16      # smallest bucket
    slot_shards: int = 0              # data-axis pool shards (0 = auto)
    overload_policy: str = "reject_new"  # reject_new | shed_oldest | queue_wait
    queue_wait_ticks: int = 0         # queue_wait policy: max queue age (ticks)
    fault_guard: bool = True          # NaN/Inf lane in the decode macro-step
    fault_retries: int = 1            # re-admissions after a slot quarantine
    page_size: int = 0                # 0 = unpaged; else ring rows per page
    num_pages: int = 0                # 0 = auto (num_slots * max_len / page)
    prefix_cache_bytes: int = 0       # 0 = prefix cache off; else LRU budget
    checkpoint_every_ticks: int = 0   # 0 = no periodic engine checkpoints
    speculative: bool = False         # draft-verify decode
    spec_gamma: int = 2               # draft tokens per speculative round
    debug_audit: bool = False         # invariant audit at end of run()

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.prefill_chunk < 0 or self.max_len < 1:
            raise ValueError("bad prefill_chunk/max_len")
        if self.macro_ticks < 1:
            raise ValueError("macro_ticks must be >= 1")
        if self.prefill_bucket_min < 1:
            raise ValueError("prefill_bucket_min must be >= 1")
        if self.slot_shards < 0:
            raise ValueError("slot_shards must be >= 0 (0 = auto)")
        if self.slot_shards > 1 and self.num_slots % self.slot_shards:
            raise ValueError(
                f"num_slots ({self.num_slots}) must be divisible by "
                f"slot_shards ({self.slot_shards})")
        if not math.isfinite(self.temperature) or self.temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0 (0 = greedy), got "
                f"{self.temperature!r}")
        if self.overload_policy not in ("reject_new", "shed_oldest",
                                        "queue_wait"):
            raise ValueError(
                f"overload_policy must be one of reject_new | shed_oldest "
                f"| queue_wait, got {self.overload_policy!r}")
        if self.queue_wait_ticks < 0:
            raise ValueError("queue_wait_ticks must be >= 0 (0 = no cap)")
        if self.fault_retries < 0:
            raise ValueError("fault_retries must be >= 0")
        if self.page_size < 0 or self.num_pages < 0:
            raise ValueError("page_size/num_pages must be >= 0")
        if self.page_size and self.max_len % self.page_size:
            raise ValueError(
                f"page_size ({self.page_size}) must divide max_len "
                f"({self.max_len})")
        if self.num_pages and not self.page_size:
            raise ValueError("num_pages requires page_size > 0")
        if self.prefix_cache_bytes < 0:
            raise ValueError("prefix_cache_bytes must be >= 0")
        if self.checkpoint_every_ticks < 0:
            raise ValueError("checkpoint_every_ticks must be >= 0 (0 = off)")
        if self.spec_gamma < 1:
            raise ValueError("spec_gamma must be >= 1")
        if self.speculative and self.prefix_cache_bytes:
            raise ValueError(
                "speculative decoding and the prefix cache are mutually "
                "exclusive (a prefix-seeded verifier slot has no draft-side "
                "snapshot to seed from)")

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for a knob whose feature the port
        has not yet (ROADMAP Queue A item 11), so none is ignored."""
        later = [
            (self.page_size > 0, "page_size > 0 (paged slot memory, "
             "pages.py)"),
            (self.prefix_cache_bytes > 0, "prefix_cache_bytes > 0 (the "
             "prefix cache, prefix_cache.py)"),
            (self.checkpoint_every_ticks > 0, "checkpoint_every_ticks > 0 "
             "(journal, serving/checkpoint.py and restore)"),
            (self.speculative, "speculative=True (speculative.py)"),
            (self.slot_shards > 1, f"slot_shards={self.slot_shards} (a "
             f"sharded slot pool)"),
            (self.prefill_chunk == 0, "prefill_chunk=0 (the bucketed "
             "whole-prompt prefill fallback)"),
        ]
        for bad, what in later:
            if bad:
                raise NotImplementedError(
                    f"ServingConfig {what} is not ported yet (ROADMAP Queue "
                    f"A item 11)")
