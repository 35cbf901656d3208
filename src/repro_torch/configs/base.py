"""Architecture and serving configuration for the port.

A torch counterpart of ``repro.configs.base.ArchConfig`` holding the
fields the port uses: SLAY, the linear baselines (``favor``,
``cosformer``, ``elu1``) and the exact quadratic kinds (``softmax``,
``yat``, ``yat_spherical``) on the decoder, with GQA/MQA, gated or
plain MLPs, tied or untied embeddings, qk-norm, gemma2's local/global
layers (a sliding-window softcapped softmax on every layer but each
``local_global_period``-th) and the top-k MoE layer; the SSM families,
``family="ssm"`` (mamba2: SSD blocks only, ``attn_kind="none"``) and
``family="hybrid"`` (hymba: attention beside SSD heads in every layer),
with the SSD block's ``ssm_*`` fields; the modality frontend stubs,
``frontend="vision"`` (internvl2: ``num_patches`` precomputed patch
embeddings ahead of the tokens) and ``family="encdec"`` with
``frontend="audio"`` (whisper: ``enc_layers`` encoder layers over
``enc_seq`` precomputed frame embeddings, ``models/whisper.py``).
``ServingConfig`` has the reference's fields, defaults and validation.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.core.slay import ATTN_KINDS, AttentionSpec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # decoder | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qk_norm: bool = False            # RMSNorm on q and k over the head dim
    attn_logit_softcap: float = 0.0   # gemma2 attention softcap
    final_logit_softcap: float = 0.0  # gemma2 output softcap
    local_window: int = 0             # sliding window for local layers
    local_global_period: int = 0      # every Nth layer global (0 = all global)
    gated_mlp: bool = True
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    # MoE (0 experts = a dense MLP)
    moe_experts: int = 0
    moe_top_k: int = 2
    # SSM / hybrid: the SSD block (models/ssm.py)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    # Encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                  # precomputed frame embeddings length
    # Modality frontend stub: "" | "audio" | "vision"
    frontend: str = ""
    num_patches: int = 0              # VLM: patch-embedding prefix length
    attn_kind: str = "slay"          # core.slay.ATTN_KINDS; "none" for ssm
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

    @property
    def mixed_layers(self) -> bool:
        """Whether local windowed layers alternate with global ones."""
        return bool(self.local_global_period and self.local_window)

    def attention_spec(self, *, local: bool = False) -> AttentionSpec:
        """The AttentionSpec of a (global|local) layer under this config:
        a local layer is a sliding-window softmax with the attention
        softcap; a global SLAY layer takes no softcap (kernel scores are
        not logits)."""
        if local and self.local_window:
            return AttentionSpec(kind="softmax", window=self.local_window,
                                 logit_softcap=self.attn_logit_softcap,
                                 chunk_size=self.chunk_size)
        if self.attn_kind == "slay":
            return AttentionSpec(kind="slay", slay=self.slay_config(),
                                 chunk_size=self.chunk_size,
                                 fuse_features=self.fuse_attention_features)
        return AttentionSpec(kind=self.attn_kind,
                             logit_softcap=self.attn_logit_softcap,
                             chunk_size=self.chunk_size)

    @property
    def param_count_dense(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6 N D), the
        reference's arithmetic: embeddings, then per layer the attention
        projections and the MLP (every expert and the router for MoE),
        the SSD block's projections for ssm and hybrid, and whisper's
        encoder layers and cross-attention."""
        d, L = self.d_model, self.num_layers
        dh = self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        ssd = 0
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            ssd = d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state
                       + di // self.ssm_head_dim) + di * d
        if self.family == "ssm":
            return n + L * ssd
        attn = d * dh * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * dh * d
        mlp = d * self.d_ff * (3 if self.gated_mlp else 2)
        if self.moe_experts:
            mlp = mlp * self.moe_experts + d * self.moe_experts
        total = n + L * (attn + mlp + ssd)
        if self.family == "encdec":
            total += self.enc_layers * (attn + mlp) + L * attn
        return total

    @property
    def active_param_count(self) -> int:
        """Active parameters per token: the dense count, or for MoE the
        top-k experts (gated, as the reference counts them) and the
        router, the embedding counted once whether tied or not."""
        if not self.moe_experts:
            return self.param_count_dense
        d, L = self.d_model, self.num_layers
        dh = self.resolved_head_dim
        attn = d * dh * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * dh * d
        mlp_active = d * self.d_ff * 3 * self.moe_top_k + d * self.moe_experts
        return self.vocab_size * d + L * (attn + mlp_active)

    def check_supported(self) -> None:
        if self.family not in ("decoder", "ssm", "hybrid", "encdec"):
            raise NotImplementedError(
                f"{self.name}: family={self.family!r}; the port has the "
                f"decoder, ssm, hybrid and encdec families")
        if self.frontend not in ("", "vision", "audio"):
            raise NotImplementedError(
                f"{self.name}: frontend={self.frontend!r}; the port has "
                f"the 'vision' patch prefix and the 'audio' frames of an "
                f"encoder-decoder")
        if (self.family == "ssm") != (self.attn_kind == "none"):
            raise ValueError(
                f"{self.name}: attn_kind={self.attn_kind!r} with family="
                f"{self.family!r}; attn_kind='none' (no attention) goes "
                f"with family='ssm' only, and family='ssm' has no "
                f"attention")
        if self.family != "ssm" and self.attn_kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{self.name}: attn_kind={self.attn_kind!r}; the port has "
                f"{', '.join(ATTN_KINDS)}")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching engine knobs (``repro_torch.serving.engine``),
    the reference's fields, defaults and validation
    (``repro.configs.base.ServingConfig``).

    The pool has ``num_slots`` decode slots. ``max_len`` is the length
    of an exact kind's KV ring, so it bounds prompt + new tokens there;
    a linear kind's (S, z) is constant-size, and ``max_len`` bounds
    nothing for it. ``page_size`` > 0 splits the rings into pages of that
    many rows drawn from one pool of ``num_pages`` (0: every slot's full
    ring), allocated per request by its context (``serving.pages``); the
    linear kinds ignore it. Prompts are absorbed
    ``prefill_chunk`` tokens per engine tick (a vision config's patch
    prefix first, as zero embedding rows); with ``prefill_chunk=0``, or
    for a config that cannot chunk (encdec), a whole prompt is absorbed
    in one tick: right-padded to a pow-2 bucket of at least
    ``prefill_bucket_min`` rows and masked by its true length where the
    config takes a masked prefill and ``prefill_buckets`` is on, else
    prefilled at its own length. ``decode_ticks_per_prefill``
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
    every ``run()``. ``prefix_cache_bytes`` > 0 is the budget of the
    prefix cache of slot-state snapshots; ``checkpoint_every_ticks`` > 0
    writes an engine checkpoint beside the engine's journal every that
    many ticks. ``speculative`` decodes draft-verify rounds of
    ``spec_gamma`` draft tokens (an exact kind's verifier and its SLAY
    twin as the draft; not with the prefix cache). ``slot_shards`` > 1
    demands that many slot-pool shards of the engine's mesh
    (``distributed.sharding.pool_slot_axes``).
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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One workload shape: ``seq_len`` tokens for each of
    ``global_batch`` sequences, in ``mode`` train, prefill or decode."""
    name: str
    seq_len: int
    global_batch: int
    mode: str


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

# The dtype of tokens and labels that the port's forward and loss take
# (``data.pipeline``'s batches).
TOKEN_DTYPE = torch.int32


def get_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Stand-ins for every model input of this cell: tensors on the
    ``meta`` device (shapes and dtypes, nothing allocated), as
    ``models.api.abstract_params`` gives the parameters. Tokens and labels
    in :data:`TOKEN_DTYPE`; a vision config's patch embeddings (which take
    ``num_patches`` of the cell's tokens) and an audio config's frame
    embeddings in ``cfg.activation_dtype``. A decode cell is one new token
    a sequence: its cache, sized for ``seq_len``, is a separate argument
    (``models.api.init_cache``)."""
    B, L = cell.global_batch, cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.mode == "decode":
        return {"tokens": meta((B, 1), TOKEN_DTYPE)}
    specs, lt = {}, L
    if cfg.frontend == "vision":
        specs["patch_embeds"] = meta((B, cfg.num_patches, cfg.d_model),
                                     cfg.activation_dtype)
        lt = L - cfg.num_patches
    if cfg.frontend == "audio":
        specs["frame_embeds"] = meta((B, cfg.enc_seq, cfg.d_model),
                                     cfg.activation_dtype)
    specs["tokens"] = meta((B, lt), TOKEN_DTYPE)
    if cell.mode == "train":
        specs["labels"] = meta((B, lt), TOKEN_DTYPE)
    return specs
