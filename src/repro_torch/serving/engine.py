"""Serving engines over the port's model surface (``repro.serving.engine``).

* :class:`ServingEngine` — the lockstep reference: one prefill per batch,
  then decode steps in lockstep until every request finishes; the parity
  oracle for the continuous engine.
* :class:`ContinuousServingEngine` — continuous batching: a
  :class:`Scheduler` owns a fixed pool of ``num_slots`` decode slots;
  requests queue, are admitted into free slots by *chunked prefill*
  (interleaved with decode ticks, so a long prompt never stalls the
  pool), stream tokens, and on EOS or their budget are evicted by one
  slot overwrite. Decode runs K ticks per dispatch (``macro_ticks``) with
  sampling, the stop test and the NaN/Inf fault lane on the card; the
  host pulls one (K, S) buffer of tokens and flags per dispatch.

SLAY's per-slot decode state is the constant-size (S, z), O(m·dv) per
layer and head whatever the context, so admission is one ``write_slot``
copy and eviction one ``reset_slot`` zero; on the card every decode tick
of the pool launches the masked decode kernel once per layer. The exact
kinds (``softmax``, ``yat``, ``yat_spherical``) hold a KV ring of
``max_len`` rows per slot instead, so a request must fit it
(:class:`RequestTooLargeError`); with ``ServingConfig.page_size`` set the
rings draw pages from a shared :class:`~repro_torch.serving.pages.
PagePool` sized by each request's context, and admission waits for free
pages. A config with local windowed layers (gemma2) holds rings of
``min(max_len, local_window)`` rows that wrap in place, beside its
global layers' state in the same slot (the reference's union layout):
any prompt is admitted and absorbed chunk by chunk, and they are never
paged. The SSM families carry each layer's SSD state per slot (the
(nh, hd, ds) fp32 scan carry and the (W-1, conv_dim) fp32 conv tail;
mamba2 nothing else, hymba beside its attention state): constant-size,
so any prompt is admitted, never paged (a ``page_size`` is ignored), and
not rewindable, so neither family decodes speculatively.

A vision config (internvl2) absorbs each request's patch prefix (zero
stand-ins for the frontend's embeddings) ahead of its prompt, as
pre-embedded chunks of up to ``prefill_chunk`` rows; the prefix counts
in a request's context. With ``prefill_chunk=0``, or for encdec
(whisper, whose encoding has no chunked continuation) a prompt is
absorbed whole in one tick: right-padded to a pow-2 bucket and masked
by its true length where the config takes a masked prefill, else at
its own length (encdec's, behind zero frames); an unbounded capacity
is then capped at ``max_len``, and there is no prefix cache for encdec.

Fault model (DESIGN.md §10): every request ends with exactly one
``finish_reason`` of ``sampling.FINISH_REASONS``. Admission failures are
typed (:class:`AdmissionError` and its subclasses), overload degrades
per ``ServingConfig.overload_policy``, requests carry tick and wall-clock
deadlines and can be cancelled anywhere in their lifecycle, and a
per-slot NaN/Inf lane in the decode dispatch detects numeric faults,
which the host quarantines and retries. ``serving.faults`` holds the
deterministic chaos injector that exercises all of it.

A ``prefix_cache_bytes`` budget (or a shared ``prefix_cache``) turns on
the content-addressed prefix cache (``serving.prefix_cache``): an
admission whose prompt shares a cached prefix seeds its slot from the
stored state snapshot and chunk-prefills only the suffix, or skips
prefill when the whole prompt is cached. With a ``journal`` attached
(``serving.journal``) every admission, token, retry and termination is
journaled, ``checkpoint_every_ticks`` adds periodic atomic checkpoints
(``serving.checkpoint``) beside it, and :meth:`ContinuousServingEngine.
restore` rebuilds an engine from that directory after a crash with
byte-identical streams. Directories are one format with the JAX
package's.

Where the JAX package compiles each serving entry point into one device
program (``jax.jit``), the port captures a CUDA graph (``serving.
graphs``): the continuous engine's K-tick decode dispatch and its full
prefill chunk, and the lockstep engine's decode step per batch size and
temperature. Each runs over tensors the engine allocates once (the slot
pool is one set of tensors for the engine's life, updated in place), so
on the card a dispatch is one copy of the control vectors, one replay and
one read-back; on the CPU the same programs run eagerly.
:meth:`graph_cache_entries` counts the captured graphs, the analogue of
the JAX engine's ``jit_cache_entries``.

With ``ServingConfig.speculative`` the continuous engine decodes by
draft-verify rounds (``serving.speculative``): an exact kind's pool is
the verifier and a second, never-paged pool of its SLAY twin the draft,
the two admitted, evicted and checkpointed in lockstep; a dispatch runs
K rounds of ``spec_gamma`` draft tokens each, every draft step and
resync step the masked decode kernel once per layer.

With ``mesh`` (a ``DeviceMesh`` of :mod:`repro_torch.launch.mesh`, one
process per rank, NCCL on the card or gloo on the CPU) the continuous
engine shards its slot pool over the rules' ``slots`` axes (DESIGN.md
§8): rank k holds the pool block [k·S/N, (k+1)·S/N) of every slot-dim
leaf, its ``pos`` and its page block, and the control vectors of those
slots. Every rank runs the same scheduler on the same requests (the
same decisions), prefills each admission itself (the parameters are
replicated over the slot axes, ``serving_param_rules``) and writes the
slot only where it owns it. A dispatch runs the decode kernel on the
rank's own block and issues no collective on the slot axes; after it
the ranks exchange the (K, S) token, emitted and fault buffers with one
``all_gather`` over the slot group (the port's counterpart of the
reference's ``device_get`` of a slot-sharded array), which keeps every
rank's scheduler identical.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
import types
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import all_reduce
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, ServingConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.serving import checkpoint as checkpoint_lib
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import graphs
from repro_torch.serving import journal as journal_lib
from repro_torch.serving import pages as pages_lib
from repro_torch.serving import prefix_cache as prefix_lib
from repro_torch.serving import sampling
from repro_torch.serving import speculative
from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_map_with_path)


class AdmissionError(RuntimeError):
    """Typed admission failure. ``queue_depth``/``max_queue`` let callers
    report or back off instead of parsing a message."""

    def __init__(self, msg: str, *, queue_depth: int = 0,
                 max_queue: int = 0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class QueueFullError(AdmissionError):
    """Admission queue at ``max_queue`` under the ``reject_new`` overload
    policy. The request was NOT enqueued — the caller keeps it."""


class RequestTooLargeError(AdmissionError, ValueError):
    """prompt + max_new_tokens exceeds the slot's context capacity. Also a
    ValueError, as in the reference."""


@dataclasses.dataclass
class Request:
    """One generation request.

    Deadlines (all optional, checked every tick): the ``*_ticks`` forms
    are measured from ``arrival_time`` on the engine's logical clock; the
    ``*_s`` forms are wall-clock from submission. ``ttft_*`` bounds the
    time to the first emitted token; ``deadline_*`` the whole request. A
    deadline expiring on the tick of a natural stop loses: the emission
    is processed first, so EOS wins. ``on_finish`` fires exactly once per
    request with its ``finish_reason``; on a fault retry ``on_token``
    replays the stream from index 0. The lockstep engine reads only the
    first three fields.
    """

    prompt: np.ndarray               # (Lp,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                 # -1: never stop early
    arrival_time: float = 0.0        # engine ticks (continuous engine only)
    on_token: Callable[[int, int], None] | None = None  # (rid, token)
    ttft_deadline_ticks: float | None = None   # first token by arrival + T
    deadline_ticks: float | None = None        # finished by arrival + T
    ttft_deadline_s: float | None = None       # wall-clock equivalents,
    deadline_s: float | None = None            # measured from submit()
    on_finish: Callable[[int, str], None] | None = None  # (rid, reason)

    def __post_init__(self):
        if np.asarray(self.prompt).size == 0:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if not np.isfinite(self.arrival_time) or self.arrival_time < 0:
            raise ValueError(f"arrival_time must be finite and >= 0, got "
                             f"{self.arrival_time!r}")
        for name in ("ttft_deadline_ticks", "deadline_ticks",
                     "ttft_deadline_s", "deadline_s"):
            v = getattr(self, name)
            if v is not None and (not np.isfinite(v) or v <= 0):
                raise ValueError(f"{name} must be finite and > 0 when "
                                 f"set, got {v!r}")


def _frontend_kw(cfg: ArchConfig, batch: int, dev: torch.device) -> dict:
    """The zero frontend stand-ins of ``batch`` requests, as keywords of
    ``api.prefill``: a vision config's ``patch_embeds`` (B, num_patches,
    d), an audio config's ``frame_embeds`` (B, enc_seq, d), in the
    activation dtype (the reference's ``_model_batch``)."""
    if cfg.frontend == "vision":
        return {"patch_embeds": torch.zeros(
            batch, cfg.num_patches, cfg.d_model, dtype=cfg.activation_dtype,
            device=dev)}
    if cfg.frontend == "audio":
        return {"frame_embeds": torch.zeros(
            batch, cfg.enc_seq, cfg.d_model, dtype=cfg.activation_dtype,
            device=dev)}
    return {}


def _prefix_rows(cfg: ArchConfig) -> int:
    """Rows a request's vision patch prefix takes ahead of its prompt."""
    return cfg.num_patches if cfg.frontend == "vision" else 0


def _bucket_len(n: int, lo: int, cap: int) -> int:
    """Smallest power-of-2 multiple of ``lo`` >= n, capped at ``cap``
    (n itself if ``cap`` < n)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, cap) if cap >= n else n


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``: a static
    buffer that a captured graph reads keeps its storage. A leaf that is
    already ``dst``'s (a ring written in place) is left as it is."""
    for d, s in zip(tree_leaves(_local(dst)), tree_leaves(_local(src))):
        if d is not s:
            d.copy_(s)


def _local(tree):
    """Each rank's own tensors of a tree (a DTensor's local shard): the
    slot ops and static-buffer copies of a tensor-parallel engine write
    through them into the DTensors' storage."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                    else t, tree)


def _serving_tp(cfg: ArchConfig, mesh, rules: shd.ShardingRules,
                slot_axes=()):
    """The tensor-parallel sub-mesh of serving: the one mesh axis (not a
    slot axis) over which ``serving_param_rules`` shard a parameter, or
    None when every rank holds the parameters whole."""
    if mesh is None:
        return None
    pls = shd.logical_to_sharding(mesh, shd.serving_param_rules(rules),
                                  api.abstract_params(cfg),
                                  api.param_axes(cfg))
    ms = shd.mesh_shape(mesh)
    names = list(ms)
    axes = {names[j] for pl in tree_leaves(pls) for j, p in enumerate(pl)
            if isinstance(p, shd.Shard) and ms[names[j]] > 1}
    axes -= set(slot_axes)
    if not axes:
        return None
    spec = cfg.attention_spec() if cfg.family != "ssm" else None
    if (len(axes) > 1 or cfg.family != "decoder" or cfg.frontend
            or cfg.mixed_layers or not spec.is_linear
            or cfg.num_kv_heads % ms[next(iter(axes))]):
        raise NotImplementedError(
            f"tensor-parallel serving over {sorted(axes)}: the port serves "
            f"a decoder of a linear kind whose kv heads the axis divides")
    return mesh[next(iter(axes))]


def _tp_context(tp_mesh, rules):
    """The context of a tensor-parallel engine's model calls (none
    without ``tp_mesh``): its activation sharding, out of inference mode
    (whose tensors DTensor's views cannot version), no autograd."""
    stack = contextlib.ExitStack()
    if tp_mesh is not None:
        stack.enter_context(torch.inference_mode(False))
        stack.enter_context(torch.no_grad())
        stack.enter_context(shd.activation_sharding(tp_mesh, rules))
    return stack


def _tp_params(cfg: ArchConfig, params: dict, tp_mesh, rules):
    """The parameters as DTensors of ``tp_mesh`` in ``serving_param_rules``
    placements (every rank holds them whole and keeps its block)."""
    pls = shd.logical_to_sharding(tp_mesh, shd.serving_param_rules(rules),
                                  params, api.param_axes(cfg))
    return tree_map(lambda x, pl: distribute_tensor(
        x, tp_mesh, pl, src_data_rank=None), params, pls)


def _tp_cache(cache, tp_mesh):
    """A decode cache as DTensors of ``tp_mesh``: (S, z) over their kv
    heads (dim 2 of the stacked leaves), positions replicated; each rank
    keeps its heads' block of its own slots."""
    def one(path, t):
        pl = shd.Shard(2) if path.split("/")[-1] in ("s", "z") \
            else shd.Replicate()
        return distribute_tensor(t.clone(), tp_mesh, [pl],
                                 src_data_rank=None)
    return tree_map_with_path(one, cache)


@dataclasses.dataclass
class _Lockstep:
    """The lockstep decode step of one batch size and temperature over its
    static buffers: the decode cache, the (B, 1) tokens (the step's input,
    overwritten with the tokens it samples) and the (2,) int64 sampling
    key, a device tensor so that a captured graph reads each step's key."""

    cache: object
    tok: torch.Tensor
    key: torch.Tensor
    step: graphs.Program


class ServingEngine:
    """Lockstep engine. Batched ``generate`` left-pads prompts to a common
    length with token 0, so with mixed prompt lengths the pad tokens are
    visible to the model — the JAX engine's behaviour, kept for parity.

    On the card the decode step (model and sampler) is one CUDA graph per
    batch size and temperature; ``_graphs=False`` runs it eagerly there
    too (for holding the graph against eager runs).

    With ``mesh`` (the reference's ``make_serving_fns(mesh=)``) the
    parameters take ``serving_param_rules`` placements: replicated over
    the slot axes, so every rank runs the whole batch; where a model axis
    shards them (tensor parallelism) they and the cache are DTensors of
    that axis and the step runs eagerly under ``activation_sharding``."""

    def __init__(self, cfg: ArchConfig, params: dict, *,
                 device: str | torch.device = "cuda", max_len: int = 4096,
                 mesh=None, rules: shd.ShardingRules = shd.DEFAULT_RULES,
                 _graphs: bool = True):
        cfg.check_supported()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.rules = rules
        self._tp = _serving_tp(cfg, mesh, rules)
        if self._tp is not None:
            self.params = _tp_params(cfg, self.params, self._tp, rules)
        self.max_len = max_len
        self._graphs = _graphs and self._tp is None
        self._steps: dict[tuple[int, float], _Lockstep] = {}

    def _tp_ctx(self):
        return _tp_context(self._tp, self.rules)

    def graph_cache_entries(self) -> dict:
        """Captured CUDA graphs by program, as the JAX engine's
        ``jit_cache_entries``: ``decode``, one per batch size and
        temperature that ``generate`` has decoded; 0 on the CPU or with
        graphing off."""
        return {"decode": sum(st.step.captured for st in self._steps.values())}

    def _lockstep(self, batch: int, temperature: float) -> _Lockstep:
        """The decode step of ``batch`` rows at ``temperature``, built at
        its first use."""
        st = self._steps.get((batch, temperature))
        if st is None:
            dev = self.device
            cache = api.init_cache(self.cfg, batch, self.max_len, device=dev)
            if self._tp is not None:
                with torch.inference_mode(False):
                    cache = _tp_cache(cache, self._tp)
            tok = torch.zeros(batch, 1, dtype=torch.int32, device=dev)
            key = torch.zeros(2, dtype=torch.int64, device=dev)

            def step():
                with self._tp_ctx():
                    logits, _ = api.decode_step(self.params, self.cfg,
                                                cache, tok)
                    logits = shd.full_tensor(logits)
                return tok.copy_(self._sample(logits, temperature, key))

            st = _Lockstep(cache, tok, key,
                           graphs.Program(step, dev, graphed=self._graphs))
            self._steps[(batch, temperature)] = st
        return st

    @torch.inference_mode()
    def generate(self, requests: list[Request], *, temperature: float = 0.0,
                 seed: int = 0) -> list[np.ndarray]:
        """Run a batch of requests to completion.

        Returns one int32 array per request of its *actual* length: up to
        and including the EOS token when ``eos_id`` fires,
        ``max_new_tokens`` otherwise. Greedy is argmax; ``temperature > 0``
        draws ``categorical(key, logits / temperature)`` on the JAX
        engine's keys (:mod:`repro_torch.prng`, jax's threefry bits): the
        first token on ``PRNGKey(seed)``, each later one on the ``sub`` of
        ``key, sub = split(key)``, so the tokens are the JAX engine's up
        to near-ties of ``logits / T + g``.
        """
        B = len(requests)
        lp = max(len(r.prompt) for r in requests)
        over = max(lp + r.max_new_tokens for r in requests)
        if over > self.max_len:
            # An exact kind's ring would silently drop live context.
            raise ValueError(f"prompt+max_new ({over}) exceeds "
                             f"max_len {self.max_len}")
        prompts = np.zeros((B, lp), np.int32)
        for i, r in enumerate(requests):
            prompts[i, lp - len(r.prompt):] = r.prompt
        tokens = torch.from_numpy(prompts).to(self.device)
        with self._tp_ctx():
            logits, cache = api.prefill(
                self.params, self.cfg, tokens, max_len=self.max_len,
                **_frontend_kw(self.cfg, B, self.device))
            logits = shd.full_tensor(logits)
        key = prng.PRNGKey(seed)
        max_new = max(r.max_new_tokens for r in requests)
        out = np.zeros((B, max_new), np.int32)
        lengths = np.zeros(B, np.int64)
        done = np.zeros(B, bool)
        st = self._lockstep(B, temperature)
        _copy_into(st.cache, cache)
        st.tok.copy_(self._sample(logits, temperature, key))
        for t in range(max_new):
            tok_np = st.tok[:, 0].cpu().numpy()
            for i, r in enumerate(requests):
                if done[i]:
                    continue
                out[i, t] = tok_np[i]
                lengths[i] += 1
                if t + 1 >= r.max_new_tokens or int(tok_np[i]) == r.eos_id:
                    done[i] = True
            if done.all():
                break
            key, sub = prng.split(key)
            st.key.copy_(torch.from_numpy(sub.astype(np.int64)))
            st.step()
        return [out[i, :lengths[i]] for i in range(B)]

    @staticmethod
    def _sample(logits, temperature: float, key):
        """(B, 1, V) logits -> (B, 1) int32 tokens; ``key`` a numpy key or
        its two words as a device tensor (the same bits)."""
        logits = logits[:, -1, :]
        if temperature <= 0.0:
            return torch.argmax(logits, -1).to(torch.int32)[:, None]
        g = prng.categorical(key, sampling.scale_logits(logits, temperature))
        return g.to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


def _slots_finite(cfg: ArchConfig, cache, tp_mesh=None) -> torch.Tensor:
    """(S,) bool: ``api.slot_state_finite`` of the pool; a
    tensor-parallel pool probes each rank's heads and takes the minimum
    over the model group (the one reduction the probe needs)."""
    if tp_mesh is None:
        return api.slot_state_finite(cfg, cache)
    ok = api.slot_state_finite(cfg, _local(cache)).to(torch.int32)
    return all_reduce(ok, "min", tp_mesh.get_group()).bool()


def _macro_decode(params, cache, last_tok, active, rids, gen, eos_ids,
                  max_new, *, cfg: ArchConfig, num_ticks: int,
                  temperature: float, seed: int, fault_guard: bool = True,
                  tp_mesh=None):
    """K decode ticks over the slot pool, all on the device, the pool
    updated in place.

    Per tick the pool runs one masked ``api.decode_step`` (drained slots
    are an exact state passthrough), sampling is keyed per (seed, rid,
    token index), and a slot that hits EOS or its ``max_new`` budget is
    masked for the remaining ticks. All K ticks always run, as the
    reference's ``lax.scan`` does.

    Fault lane (``fault_guard``): after each tick the per-slot finiteness
    of the freshly written state and of the logits row is checked on the
    device. A non-finite slot does not emit, is masked like an EOS hit and
    is flagged in the fault plane, which rides the one buffer the host
    pulls, so detection costs no extra host sync.

    last_tok/active/rids/gen/eos_ids/max_new are (S,) device tensors
    (int32; ``active`` bool); ``gen`` counts tokens already emitted per
    slot, which is the sampling index of the next token, so the stream is
    the same for every K. Returns one (3, K, S) int32 tensor: tokens,
    emitted flags and fault flags. A tensor-parallel pool (``tp_mesh``)
    gathers each tick's logits row whole before sampling.
    """
    toks, ems, flts = [], [], []
    for _ in range(num_ticks):
        logits, cache = api.decode_step(params, cfg, cache,
                                        last_tok[:, None], active)
        row = shd.full_tensor(logits[:, -1, :])
        tok = sampling.sample_tokens(row, rids, gen,
                                     temperature=temperature, seed=seed)
        if fault_guard:
            ok = (_slots_finite(cfg, cache, tp_mesh)
                  & torch.isfinite(row.float()).all(-1))
            faulted = active & ~ok
        else:
            ok = torch.ones_like(active)
            faulted = torch.zeros_like(active)
        emitted = active & ok
        tok = torch.where(emitted, tok, last_tok)
        gen = gen + emitted.to(torch.int32)
        hit = emitted & sampling.stop_hit(tok, gen, eos_ids, max_new)
        active = emitted & ~hit
        last_tok = tok
        toks.append(tok)
        ems.append(emitted)
        flts.append(faulted)
    return torch.stack([torch.stack(toks), torch.stack(ems).to(torch.int32),
                        torch.stack(flts).to(torch.int32)])


@dataclasses.dataclass
class RequestStats:
    rid: int
    arrival: float                   # ticks
    prompt_len: int = 0
    slot: int | None = None          # pool slot served in (last, if retried)
    admitted: float | None = None    # prefill started
    first_token: float | None = None
    finished: float | None = None
    first_token_wall: float | None = None
    arrival_wall: float | None = None
    finish_reason: str | None = None  # sampling.FINISH_REASONS; None = live
    retries: int = 0                 # fault-quarantine re-admissions so far
    prefix_cached: bool = False      # seeded from the prefix cache
    prefix_tokens: int = 0           # prompt tokens reused from a snapshot

    @property
    def ttft_ticks(self) -> float | None:
        """Ticks to first token — None until one is emitted (a request
        cancelled, shed or expired before emitting has no TTFT and drops
        out of the percentiles rather than reading as 0)."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_wall is None or self.arrival_wall is None:
            return None
        return self.first_token_wall - self.arrival_wall


@dataclasses.dataclass
class ServingMetrics:
    """Counters the engine updates every tick; ``summary()`` aggregates.

    *Ticks* are the engine's logical clock (one scheduling decision = one
    tick, device-independent); *wall* is the injectable ``clock`` in
    seconds. ``decode_dispatches`` counts K-tick macro steps (one per K
    decode ticks, whole pool); ``host_syncs`` counts blocking
    device-to-host pulls in the decode loop (one per dispatch);
    ``prefill_token_syncs`` the first-token scalar pulls at admission.
    ``requests_terminated`` counts every terminal request,
    ``requests_completed`` the successful ones (eos | length);
    ``fault_events`` records each quarantine as {"rid", "slot", "tick"}.
    ``prefix_hits`` counts admissions seeded from the prefix cache and
    ``prefix_tokens_reused`` the prompt tokens they skipped;
    ``tokens_replayed`` counts tokens regenerated after a restore and
    checked against the journal instead of delivered again,
    ``checkpoints_written`` the atomic checkpoints. ``num_pages``,
    ``pages_in_use`` and ``pages_peak`` mirror the page allocator of a
    paged pool (0 unpaged). In speculative mode ``draft_tokens_proposed``
    counts the draft tokens offered to the verifier in counted rounds
    (slot live, not faulted; ``spec_gamma`` each) and
    ``draft_tokens_accepted`` those it accepted. ``bucket_hits`` and
    ``bucket_misses`` count the bucketed whole-prompt prefills whose
    pow-2 length was seen before and those of a new length (the
    reference's compile-cache counters). ``summary()`` has the
    reference's keys.
    """

    num_slots: int = 0
    macro_ticks: int = 1
    slot_shards: int = 1
    ticks: int = 0
    decode_ticks: int = 0
    prefill_ticks: int = 0
    tokens_generated: int = 0
    prompt_tokens: int = 0
    requests_completed: int = 0
    queue_depth_sum: int = 0
    queue_depth_max: int = 0
    occupancy_sum: int = 0
    decode_dispatches: int = 0
    slot_gathers: int = 0
    host_syncs: int = 0
    prefill_token_syncs: int = 0
    requests_terminated: int = 0
    finish_reasons: dict = dataclasses.field(default_factory=dict)
    faults_detected: int = 0
    fault_retries: int = 0
    fault_retries_succeeded: int = 0
    fault_events: list = dataclasses.field(default_factory=list)
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    num_pages: int = 0
    pages_in_use: int = 0
    pages_peak: int = 0
    tokens_replayed: int = 0
    checkpoints_written: int = 0
    speculative: bool = False
    spec_gamma: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    bucket_hits: int = 0
    bucket_misses: int = 0
    clock: Callable[[], float] = time.perf_counter
    wall_start: float | None = None
    per_request: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.wall_start is None:
            self.wall_start = self.clock()

    def sample(self, queue_depth: int, occupancy: int):
        self.queue_depth_sum += queue_depth
        self.queue_depth_max = max(self.queue_depth_max, queue_depth)
        self.occupancy_sum += occupancy

    def summary(self) -> dict:
        wall = max(self.clock() - self.wall_start, 1e-9)
        ttfts = sorted(s.ttft_ticks for s in self.per_request.values()
                       if s.ttft_ticks is not None)
        ttfts_s = sorted(s.ttft_s for s in self.per_request.values()
                         if s.ttft_s is not None)
        # TTFT split by prefix-cache seeding (cached admissions skip
        # prefill work).
        ttfts_c = sorted(s.ttft_ticks for s in self.per_request.values()
                         if s.ttft_ticks is not None and s.prefix_cached)
        ttfts_w = sorted(s.ttft_ticks for s in self.per_request.values()
                         if s.ttft_ticks is not None and not s.prefix_cached)

        def pct(xs, q):
            return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else None

        t = max(self.ticks, 1)
        return {
            "ticks": self.ticks,
            "decode_ticks": self.decode_ticks,
            "prefill_ticks": self.prefill_ticks,
            "requests_completed": self.requests_completed,
            "tokens_generated": self.tokens_generated,
            "prompt_tokens": self.prompt_tokens,
            "macro_ticks": self.macro_ticks,
            "slot_shards": self.slot_shards,
            "decode_dispatches": self.decode_dispatches,
            "host_syncs": self.host_syncs,
            "prefill_token_syncs": self.prefill_token_syncs,
            "host_syncs_per_token":
                self.host_syncs / max(self.tokens_generated, 1),
            "tokens_per_dispatch":
                self.tokens_generated / max(self.decode_dispatches, 1),
            "dispatches_per_decode_tick":
                self.decode_dispatches / max(self.decode_ticks, 1),
            "bucket_hits": self.bucket_hits,
            "bucket_misses": self.bucket_misses,
            "requests_terminated": self.requests_terminated,
            "finish_reasons": dict(self.finish_reasons),
            # Rates over terminated requests (0.0 when none terminated).
            "shed_rate": self.finish_reasons.get("shed", 0)
            / max(self.requests_terminated, 1),
            "deadline_miss_rate": self.finish_reasons.get("deadline", 0)
            / max(self.requests_terminated, 1),
            "faults_detected": self.faults_detected,
            "fault_retries": self.fault_retries,
            "fault_retries_succeeded": self.fault_retries_succeeded,
            "tokens_replayed": self.tokens_replayed,
            "checkpoints_written": self.checkpoints_written,
            "wall_s": wall,
            "decode_tokens_per_s": self.tokens_generated / wall,
            "total_tokens_per_s":
                (self.tokens_generated + self.prompt_tokens) / wall,
            "mean_queue_depth": self.queue_depth_sum / t,
            "max_queue_depth": self.queue_depth_max,
            "mean_slot_occupancy":
                self.occupancy_sum / (t * max(self.num_slots, 1)),
            "ttft_ticks_p50": pct(ttfts, 0.50),
            "ttft_ticks_p95": pct(ttfts, 0.95),
            "ttft_s_p50": pct(ttfts_s, 0.50),
            "ttft_s_p95": pct(ttfts_s, 0.95),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "ttft_cached_ticks_p50": pct(ttfts_c, 0.50),
            "ttft_cached_ticks_p95": pct(ttfts_c, 0.95),
            "ttft_cold_ticks_p50": pct(ttfts_w, 0.50),
            "ttft_cold_ticks_p95": pct(ttfts_w, 0.95),
            "num_pages": self.num_pages,
            "pages_in_use": self.pages_in_use,
            "pages_peak": self.pages_peak,
            "speculative": self.speculative,
            "spec_gamma": self.spec_gamma,
            "draft_tokens_proposed": self.draft_tokens_proposed,
            "draft_tokens_accepted": self.draft_tokens_accepted,
            "draft_acceptance_rate": self.draft_tokens_accepted
            / max(self.draft_tokens_proposed, 1),
        }


@dataclasses.dataclass
class _Slot:
    """One live sequence in the decode pool."""

    rid: int
    req: Request
    last_tok: int
    tokens: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Prefill:
    """An admission in flight: a prompt absorbed chunk by chunk."""

    rid: int
    req: Request
    slot: int
    cache: object   # the static batch-1 prefill cache, or a full hit's snapshot
    offset: int = 0                  # prompt tokens absorbed so far
    prefix_offset: int = 0           # vision prefix rows absorbed so far
    logits: torch.Tensor | None = None  # (1, 1, V): a full prefix hit
    draft: object = None             # the draft's batch-1 cache (speculative)


class Scheduler:
    """Owns the slot pool and the admission queue.

    FIFO admission order; the *slot* a request lands in is the free slot
    whose shard serves the fewest live requests (ties to the lowest slot,
    which with one shard is the lowest free slot). Ownership is static
    and contiguous: with S slots over N shards, shard k owns slots
    [k*S/N, (k+1)*S/N) for the engine's life, the block rank k of a
    slot-sharded pool holds, so admission and eviction never move state
    across shards. At most one prefill is in flight (chunked, so a long
    prompt yields to decode ticks between chunks); decode and prefill
    interleave per ``decode_ticks_per_prefill`` when both have work.
    Token streams never depend on the slot or shard chosen: sampling is
    keyed on (seed, rid, token index) only.
    """

    def __init__(self, serving: ServingConfig, slot_shards: int = 1):
        self.serving = serving
        self.slot_shards = max(slot_shards, 1)
        self.slots_per_shard = serving.num_slots // self.slot_shards
        self.free: list[int] = list(range(serving.num_slots))
        self.active: dict[int, _Slot] = {}
        self.waiting: collections.deque = collections.deque()  # (rid, req)
        self.ready: collections.deque = collections.deque()
        self._decode_since_prefill = serving.decode_ticks_per_prefill

    def shard_of(self, slot: int) -> int:
        """Static owner shard of ``slot`` (its contiguous block)."""
        return slot // self.slots_per_shard

    def submit(self, rid: int, req: Request) -> list[tuple[int, Request]]:
        """Enqueue a request; returns the (rid, req) pairs shed to make
        room (``shed_oldest``; the engine ends them as ``shed``).

        With the queue at ``max_queue``: ``reject_new`` raises
        :class:`QueueFullError` with the depth (nothing is mutated, the
        caller keeps the request); ``shed_oldest`` drops the
        longest-waiting queued request; ``queue_wait`` admits and leaves
        stale requests to the engine's queue-age sweep."""
        shed: list[tuple[int, Request]] = []
        depth = len(self.waiting) + len(self.ready)
        if self.serving.max_queue and depth >= self.serving.max_queue:
            policy = self.serving.overload_policy
            if policy == "reject_new":
                raise QueueFullError(
                    f"admission queue full: {depth} queued >= max_queue "
                    f"{self.serving.max_queue} (overload_policy="
                    f"'reject_new'; retry later, or configure "
                    f"'shed_oldest' / 'queue_wait' to degrade instead)",
                    queue_depth=depth, max_queue=self.serving.max_queue)
            if policy == "shed_oldest":
                victim = self.pop_oldest()
                if victim is not None:
                    shed.append(victim)
        self.waiting.append((rid, req))
        # Ordered by (arrival, rid), so a late submission with an earlier
        # arrival_time is not blocked behind later arrivals.
        self.waiting = collections.deque(
            sorted(self.waiting, key=lambda t: (t[1].arrival_time, t[0])))
        return shed

    def pop_oldest(self) -> tuple[int, Request] | None:
        """Remove and return the longest-waiting queued request — ready
        queue first, else the earliest-arriving waiting entry."""
        if self.ready:
            return self.ready.popleft()
        if self.waiting:
            return self.waiting.popleft()
        return None

    def cancel(self, rid: int) -> Request | None:
        """Remove a still-queued request; its Request, or None if ``rid``
        is not queued here."""
        for q in (self.ready, self.waiting):
            for item in q:
                if item[0] == rid:
                    q.remove(item)
                    return item[1]
        return None

    def poll_arrivals(self, now: float):
        while self.waiting and self.waiting[0][1].arrival_time <= now:
            self.ready.append(self.waiting.popleft())

    def next_admission(self, slot_ok=None):
        """Pop the request to admit next and reserve a slot in the
        least-loaded shard, or None.

        ``slot_ok(slot, req)`` filters the free slots (a paged pool admits
        only where the slot's shard has the request's pages); when none
        qualifies the head request stays queued, so admission stays FIFO.
        """
        if not self.ready or not self.free:
            return None
        rid, req = self.ready[0]
        cands = (self.free if slot_ok is None
                 else [s for s in self.free if slot_ok(s, req)])
        if not cands:
            return None
        self.ready.popleft()
        load = [0] * self.slot_shards
        for slot in self.active:
            load[self.shard_of(slot)] += 1
        slot = min(cands, key=lambda s: (load[self.shard_of(s)], s))
        self.free.remove(slot)
        return rid, req, slot

    def evict(self, slot: int):
        del self.active[slot]
        self.free.append(slot)
        self.free.sort()

    @property
    def queue_depth(self) -> int:
        return len(self.ready)

    @property
    def occupancy(self) -> int:
        return len(self.active)

    def want_prefill(self, prefill_inflight: bool) -> bool:
        """Interleave policy: prefill only after enough decode ticks,
        unless there is no decode work at all."""
        has_work = prefill_inflight or (bool(self.ready) and bool(self.free))
        if not has_work:
            return False
        if not self.active:
            return True
        return (self._decode_since_prefill
                >= self.serving.decode_ticks_per_prefill)

    def note_decode(self):
        self._decode_since_prefill += 1

    def note_prefill(self):
        self._decode_since_prefill = 0


# The slot-axis resolution of an engine without a mesh: one shard.
_ONE_DEVICE = types.SimpleNamespace(shape={"data": 1, "model": 1})


class ContinuousServingEngine:
    """Continuous-batching engine over a fixed decode-slot pool.

    Usage::

        eng = ContinuousServingEngine(cfg, params,
                                      serving=ServingConfig(num_slots=4))
        rids = [eng.submit(r) for r in requests]
        outs, summary = eng.run()          # rid -> np.ndarray of tokens

    or drive it tick by tick with :meth:`step`. Time is a logical tick
    counter; request ``arrival_time`` is in ticks. With ``macro_ticks``
    K > 1 a decode dispatch covers K ticks: the host replays the returned
    (K, S) buffer tick by tick, so streaming callbacks, TTFT in ticks,
    queue-depth samples and eviction keep per-tick granularity; only
    admission waits for a dispatch boundary. Streams are the same for
    every K.

    Runs on the card unless given ``device="cpu"`` (the plain PyTorch
    versions of the kernels); asking for the card where there is none
    raises. ``prefix_cache`` shares a :class:`~repro_torch.serving.
    prefix_cache.PrefixCache` between engines (else ``serving.
    prefix_cache_bytes`` > 0 builds one); ``journal`` makes the engine
    crash-safe (:meth:`checkpoint`, :meth:`restore`). On the card the
    decode dispatch and a full prefill chunk each replay one CUDA graph,
    captured at their first call (pool shape, K, temperature, seed and
    ``fault_guard`` are fixed per engine, as in the JAX engine's jit);
    ``_graphs=False`` runs them eagerly there too (for holding the graphs
    against eager runs). A vision prefix's chunks and a whole-prompt
    prefill run eagerly (the JAX engine compiles one program per bucket
    or length).
    """

    def __init__(self, cfg: ArchConfig, params: dict, *,
                 serving: ServingConfig = ServingConfig(),
                 device: str | torch.device = "cuda",
                 clock: Callable[[], float] = time.perf_counter,
                 fault_injector=None, prefix_cache=None,
                 journal: journal_lib.Journal | None = None,
                 mesh=None, rules: shd.ShardingRules = shd.DEFAULT_RULES,
                 _graphs: bool = True):
        cfg.check_supported()
        self.device = resolve_device(device)
        self.cfg, self.serving = cfg, serving
        self._clock = clock
        # Chaos harness hook (serving.faults.FaultInjector), tests and
        # benchmarks only.
        self._injector = fault_injector
        S, L = serving.num_slots, serving.max_len
        self._shard_slots(mesh, rules)
        self._tp = _serving_tp(cfg, mesh, rules, self._slot_axes)
        if self._tp is not None and (
                serving.page_size or serving.prefix_cache_bytes
                or prefix_cache is not None or journal is not None
                or serving.speculative):
            raise NotImplementedError(
                "a tensor-parallel engine serves without paging, a prefix "
                "cache, a journal or speculative decoding")
        self.params = _to_device(params, self.device)
        if self._tp is not None:
            self.params = _tp_params(cfg, self.params, self._tp, rules)
        self.sched = Scheduler(serving, self.slot_shards)
        # Paged slot memory: only the exact kinds' rings page; SLAY's (S, z)
        # and an SSD carry are O(1) per slot, so page_size is a no-op for
        # them.
        self.page_pool: pages_lib.PagePool | None = None
        if serving.page_size and api.supports_paging(cfg):
            lp = L // serving.page_size      # the config checks divisibility
            self.page_pool = pages_lib.PagePool(
                S, serving.num_pages or S * lp, serving.page_size, lp,
                shards=self.slot_shards)
        pp = self.page_pool
        # Content-addressed prefix cache; its entries live on this
        # engine's device. _pfx_refs pins the entry each live request was
        # seeded from, so it is never evicted under the request.
        self.prefix_cache = prefix_cache
        if self.prefix_cache is None and serving.prefix_cache_bytes:
            self.prefix_cache = prefix_lib.PrefixCache(
                serving.prefix_cache_bytes)
        # Seeding continues a snapshot chunk by chunk, so encdec (no
        # chunked prefill) never caches; nor does a whole-prompt prefill
        # (prefill_chunk=0) seed or insert.
        self._chunkable = api.supports_chunked_prefill(cfg)
        self._bucketable = (serving.prefill_buckets
                            and api.supports_masked_prefill(cfg))
        self._seen_buckets: set[int] = set()
        if not self._chunkable:
            self.prefix_cache = None
        self._pfx_refs: dict[int, prefix_lib.PrefixEntry] = {}
        self.metrics = ServingMetrics(
            num_slots=S, macro_ticks=serving.macro_ticks,
            slot_shards=self.slot_shards,
            num_pages=pp.num_pages if pp else 0, clock=clock)
        # Speculative decoding: two pools over one parameter dict, the
        # verifier's (self.pool, paged or not) and the SLAY draft's
        # (constant-state, never paged), admitted, evicted and
        # checkpointed in lockstep.
        self._spec = serving.speculative
        self.draft_cfg: ArchConfig | None = None
        if self._spec:
            if not api.supports_speculative(cfg):
                raise ValueError(
                    f"speculative decoding needs a verifier config with "
                    f"api.supports_speculative (a non-windowed exact "
                    f"quadratic attention kind); got attn_kind="
                    f"{cfg.attn_kind!r}, family={cfg.family!r}")
            self.draft_cfg = api.draft_config(cfg)
            self.params = api.ensure_draft_params(self.draft_cfg,
                                                  self.params)
            self.metrics.speculative = True
            self.metrics.spec_gamma = serving.spec_gamma
            # The config refuses a byte budget with speculative decoding;
            # a shared cache is dropped too: a prefix snapshot seeds only
            # the verifier's ring, the draft would have nothing to seed.
            self.prefix_cache = None
        self.tick = 0
        self._next_rid = 0
        self._outputs: dict[int, list] = {}
        self._prefill: _Prefill | None = None
        # Durability. With a journal every admission, token and
        # termination is journaled (one fsync per engine step), and
        # checkpoint_every_ticks > 0 adds periodic atomic checkpoints in
        # the journal's directory. _replay_until[rid] is how many tokens
        # of a restored request the journal already holds: regenerated
        # tokens below it are checked byte-equal and not delivered again.
        self.journal = journal
        self._ckpt_dir = (os.path.dirname(os.path.abspath(journal.path))
                          if journal is not None else None)
        self._last_ckpt_tick = 0
        self._replay_until: dict[int, int] = {}
        self.recovery: dict | None = None
        self._audit = serving.debug_audit or (
            os.environ.get("REPRO_DEBUG_AUDIT", "") not in ("", "0"))
        # The static buffers of the captured programs (serving.graphs),
        # each one set of tensors for the engine's life: the slot pool,
        # the stacked control vectors of a dispatch, and one batch-1
        # prefill cache with one chunk of tokens (one prefill is in flight
        # at a time). A paged pool's page tables are among the pool's
        # tensors, updated in place by the slot ops. A sharded pool is
        # this rank's block of S/N slots (and of the pages).
        Sl, n = self._slots_local, self.slot_shards
        with torch.inference_mode():
            self.pool = api.init_cache(
                cfg, Sl, L, device=self.device,
                page_size=pp.page_size if pp else 0,
                num_pages=pp.num_pages // n if pp else 0)
            self._ctl = torch.zeros(6, Sl, dtype=torch.int32,
                                    device=self.device)
            self._pf_cache = api.init_cache(cfg, 1, serving.max_len,
                                            device=self.device)
            self._pf_tokens = torch.zeros(1, serving.prefill_chunk,
                                          dtype=torch.int32,
                                          device=self.device)

            # Speculative: the draft pool, its round-start scratch twin
            # and its batch-1 prefill cache.
            self.draft_pool = self._draft_scratch = self._pf_draft = None
            if self._spec:
                self.draft_pool, self._draft_scratch = (
                    api.init_cache(self.draft_cfg, Sl, L, device=self.device)
                    for _ in range(2))
                self._pf_draft = api.init_cache(self.draft_cfg, 1, L,
                                                device=self.device)
        # A tensor-parallel engine keeps each rank's heads of its slots in
        # DTensors (made outside inference mode, whose tensors DTensor's
        # views cannot version), and its dispatch (model-group
        # collectives) runs eagerly; every other captures local tensors.
        if self._tp is not None:
            with torch.inference_mode(False):
                self.pool = _tp_cache(self.pool, self._tp)
                self._pf_cache = _tp_cache(self._pf_cache, self._tp)
        _graphs = _graphs and self._tp is None
        self._decode = graphs.Program(self._decode_program, self.device,
                                      graphed=_graphs)
        self._spec_decode = (graphs.Program(self._spec_program, self.device,
                                            graphed=_graphs)
                             if self._spec else None)
        self._chunk = graphs.Program(
            lambda: self._absorb(self._pf_tokens), self.device,
            graphed=_graphs)
        # Host mirrors of the per-slot decode vectors. The replay loop
        # applies the same emit/EOS/budget logic as the device ticks, so
        # mirrors and device never diverge and nothing but the token
        # buffer is read back.
        self._last_tok = np.zeros(S, np.int32)
        self._active = np.zeros(S, bool)
        self._rids = np.zeros(S, np.int32)
        self._gen = np.zeros(S, np.int32)
        self._eos = np.full(S, -1, np.int32)
        self._maxn = np.zeros(S, np.int32)
        if journal is not None and journal.nbytes == 0:
            # A fresh journal: stamp the sampling and geometry contract
            # once. restore() refuses a journal whose stream keying or
            # sampling differ (regenerated tokens would not be equal).
            journal.append({
                "t": "meta", "v": journal_lib.JOURNAL_VERSION,
                "stream_key_v": sampling.STREAM_KEY_VERSION,
                "seed": serving.seed, "temperature": serving.temperature,
                "num_slots": S, "max_len": serving.max_len,
                # Sampled speculative streams draw on other substreams,
                # and gamma decides which indices take the bonus draw.
                "speculative": self._spec,
                "spec_gamma": serving.spec_gamma if self._spec else 0})
            journal.flush()

    # -- slot sharding (DESIGN.md §8) ---------------------------------------

    def _shard_slots(self, mesh, rules: shd.ShardingRules) -> None:
        """Resolve the pool's slot axes once (``pool_slot_axes``; its
        divisibility fallback replicates and is logged in
        ``slot_shard_fallbacks``) and this rank's block [lo, lo + S/N)."""
        S = self.serving.num_slots
        self.mesh, self.rules = mesh, rules
        self.slot_shard_fallbacks: list = []
        saxes, n = shd.pool_slot_axes(
            mesh if mesh is not None else _ONE_DEVICE, rules, S,
            self.serving.slot_shards, self.slot_shard_fallbacks)
        if len(saxes) > 1:
            raise NotImplementedError(
                f"slot axes {saxes}: the port shards the pool over one "
                f"mesh axis")
        self.slot_shards, self._shard, self._slot_group = n, 0, None
        if n > 1:
            self._slot_group = mesh.get_group(saxes[0])
            self._shard = mesh.get_local_rank(saxes[0])
        self._slots_local = S // n
        self._lo = self._shard * self._slots_local
        self._slot_axes = saxes

    def _tp_ctx(self):
        return _tp_context(self._tp, self.rules)

    def _slot_index(self, slot: int) -> int | None:
        """``slot``'s index in this rank's pool block, or None when
        another rank owns it."""
        i = slot - self._lo
        return i if 0 <= i < self._slots_local else None

    def _page_vectors(self):
        """This rank's block of the page tables (local page and slot ids),
        for the slot ops."""
        if self.page_pool is None:
            return None
        return self.page_pool.device_vectors(self._shard)

    def _gather_slots(self, buf: torch.Tensor) -> torch.Tensor:
        """The whole pool's (..., S) buffer from every rank's (..., S/N)
        block: one ``all_gather`` over the slot group (none on one
        shard)."""
        if self._slot_group is None:
            return buf
        parts = [torch.empty_like(buf) for _ in range(self.slot_shards)]
        dist.all_gather(parts, buf.contiguous(), group=self._slot_group)
        self.metrics.slot_gathers += 1
        return torch.cat(parts, dim=-1)

    def _whole_pool(self, cfg: ArchConfig):
        """The whole pool of ``cfg`` (the verifier's, paged or not, or
        the draft's) on the ``meta`` device."""
        sv, pp = self.serving, self.page_pool
        paged = pp is not None and cfg is self.cfg
        return api.abstract_cache(
            cfg, sv.num_slots, sv.max_len,
            page_size=pp.page_size if paged else 0,
            num_pages=pp.num_pages if paged else 0)

    def _slot_dims(self, cfg: ArchConfig) -> list:
        """Per leaf of a pool of ``cfg``, the dim its slot (or page) axis
        shards, from ``serving_cache_sharding``'s placements of the whole
        pool; None for a leaf every rank holds whole."""
        sv, pp = self.serving, self.page_pool
        pls = shd.serving_cache_sharding(
            self.mesh, self.rules, self._whole_pool(cfg),
            num_slots=sv.num_slots,
            num_pages=pp.num_pages if pp else None,
            slot_shards=sv.slot_shards)
        j = list(shd.mesh_shape(self.mesh)).index(self._slot_axes[0])
        return [pl[j].dim if isinstance(pl[j], shd.Shard) else None
                for pl in tree_leaves(pls)]

    def _whole_leaves(self, pool, cfg: ArchConfig) -> list:
        """The numpy leaves of the whole pool, every rank's block gathered
        (each rank must call it); a page table's ids made global."""
        leaves = tree_leaves(pool)
        if self._slot_group is None:
            return [checkpoint_lib.to_numpy(x) for x in leaves]
        pages = ([] if getattr(pool, "pages", None) is None
                 else list(pool.pages))
        out = []
        for x, dim in zip(leaves, self._slot_dims(cfg)):
            if dim is None:
                out.append(checkpoint_lib.to_numpy(x))
                continue
            w = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            parts = [torch.empty_like(w) for _ in range(self.slot_shards)]
            dist.all_gather(parts, w.contiguous(), group=self._slot_group)
            for k, part in enumerate(parts):
                off = self._page_offset(x, pages, k)
                if off:
                    part.copy_(torch.where(part >= 0, part + off, part))
            whole = torch.cat(parts, dim)
            out.append(checkpoint_lib.to_numpy(
                whole.view(torch.bfloat16) if w is not x else whole))
        return out

    def _page_offset(self, leaf, pages: list, k: int) -> int:
        """What turns shard k's ids in page-table leaf ``leaf`` into
        global ones (its first page for the table, its first slot for the
        owners); 0 for any other leaf."""
        if not pages or self.page_pool is None:
            return 0
        if leaf is pages[0]:
            return k * (self.page_pool.num_pages // self.slot_shards)
        if leaf is pages[1]:
            return k * self._slots_local
        return 0

    def _load_block(self, pool, saved: list, cfg: ArchConfig) -> None:
        """Copy this rank's block of the whole-pool numpy leaves ``saved``
        into ``pool``'s tensors; a page table's ids made the block's."""
        leaves = tree_leaves(pool)
        dims = ([None] * len(leaves) if self._slot_group is None
                else self._slot_dims(cfg))
        pages = ([] if getattr(pool, "pages", None) is None
                 else list(pool.pages))
        for dst, src, dim in zip(leaves, saved, dims):
            t = torch.from_numpy(np.array(src))
            if dim is not None:
                n = dst.shape[dim]
                t = t.narrow(dim, self._shard * n, n)
                off = self._page_offset(dst, pages, self._shard)
                if off:
                    t = torch.where(t >= 0, t - off, t)
            dst.copy_(t)

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its request id.

        Raises :class:`RequestTooLargeError` when prompt + max_new exceeds
        the slot's context capacity (an exact kind's ``max_len`` ring;
        never for SLAY, whose state is constant-size, nor for windowed
        rings, which wrap exactly) and
        :class:`QueueFullError` when the queue is at ``max_queue`` under
        ``reject_new``. Under ``shed_oldest`` the
        longest-waiting queued request ends as ``shed`` instead; under
        ``queue_wait`` admission always succeeds. A rejected request is
        never enqueued and consumes no rid."""
        if self._injector is not None:
            delay = self._injector.arrival_delay_for()
            if delay:
                req = dataclasses.replace(
                    req, arrival_time=req.arrival_time + delay)
        need = self._need_rows(req)
        prefix = _prefix_rows(self.cfg)
        # An unbounded capacity (constant-size state, windowed rings)
        # still needs chunked prefill: a whole-prompt prefill runs at the
        # prompt's length into a ring of max_len rows, which it cannot
        # exceed.
        cap = api.context_capacity(self.cfg, self.serving.max_len)
        if cap is None and not (self._chunkable
                                and self.serving.prefill_chunk):
            cap = self.serving.max_len
        if cap is not None and need > cap:
            raise RequestTooLargeError(
                f"request does not fit its decode slot: "
                + (f"{prefix} vision-prefix patches + " if prefix else "")
                + f"{len(req.prompt)} prompt + {req.max_new_tokens} max_new "
                + (f"+ {self.serving.spec_gamma} spec verify headroom "
                   if self._spec else "")
                + f"= {need} > context "
                f"capacity {cap} (the cache ring would overwrite live "
                f"context; shorten the prompt/max_new_tokens or raise "
                f"ServingConfig.max_len)",
                queue_depth=self.sched.queue_depth,
                max_queue=self.serving.max_queue)
        rid = self._next_rid
        shed = self.sched.submit(rid, req)   # may raise QueueFullError
        self._next_rid += 1
        st = RequestStats(rid=rid, arrival=req.arrival_time,
                          prompt_len=len(req.prompt))
        st.arrival_wall = self._clock()
        self.metrics.per_request[rid] = st
        self._outputs[rid] = []
        if self.journal is not None:
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            self.journal.append({
                "t": "admit", "rid": rid,
                "prompt": [int(x) for x in prompt],
                "digest": prefix_lib.token_digest(prompt).hex(),
                "arrival": float(req.arrival_time),
                "max_new": int(req.max_new_tokens),
                "eos": int(req.eos_id),
                "ttft_deadline_ticks": req.ttft_deadline_ticks,
                "deadline_ticks": req.deadline_ticks,
                "ttft_deadline_s": req.ttft_deadline_s,
                "deadline_s": req.deadline_s,
                "ts": self._clock()})
        for srid, sreq in shed:
            self._terminate(srid, sreq, "shed")
        if self.journal is not None:
            # Admission is durable before the caller learns the rid.
            self.journal.flush()
        return rid

    # -- engine ticks -------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduling decision: a prefill chunk (one tick) or a decode
        macro step (K ticks, replayed per tick). Returns False when fully
        idle.

        Tick anatomy: arrivals poll, then the lifecycle sweep (deadline
        expiry and queue-age shedding), then chaos injections if an
        injector is attached, then the scheduling decision. The sweep also
        runs after every replayed decode tick, so deadlines hold at
        per-tick granularity under K-tick macro steps."""
        sched = self.sched
        sched.poll_arrivals(self.tick)
        did = False
        self._lifecycle_sweep()
        if self._injector is not None:
            self._apply_injections()
        if sched.want_prefill(self._prefill is not None):
            self.metrics.sample(sched.queue_depth, sched.occupancy)
            self._prefill_tick()
            sched.note_prefill()
            self.metrics.prefill_ticks += 1
            self.tick += 1
            did = True
        elif sched.active:
            if self._spec:
                self._decode_spec()
            else:
                self._decode_macro()
            did = True
        else:
            self.metrics.sample(sched.queue_depth, sched.occupancy)
            self.tick += 1
        self.metrics.ticks = self.tick
        if self.journal is not None:
            # One fsync per engine step: a K-tick dispatch journals its
            # emissions here.
            self.journal.flush()
            every = self.serving.checkpoint_every_ticks
            if every and self.tick - self._last_ckpt_tick >= every:
                self.checkpoint()
        return did or bool(sched.waiting)

    def run(self, requests: list[Request] | None = None, *,
            max_ticks: int | None = None):
        """Drive to completion. Returns (outputs, metrics summary): outputs
        map rid -> int32 array of that request's generated tokens (through
        EOS inclusive, or max_new_tokens)."""
        for r in requests or ():
            self.submit(r)
        limit = max_ticks if max_ticks is not None else 10_000_000
        while self.tick < limit:
            if not (self.sched.active or self.sched.ready
                    or self.sched.waiting or self._prefill):
                break
            self.step()
        if self.journal is not None:
            self.journal.flush()
        if self._audit:
            self._debug_audit()
        outs = {rid: np.asarray(toks, np.int32)
                for rid, toks in self._outputs.items()}
        summary = self.metrics.summary()
        summary["journal_bytes"] = (self.journal.nbytes
                                    if self.journal is not None else 0)
        # Leak contract: a drained engine holds no live slot and an empty
        # queue, whatever path each request left by.
        summary["final_occupancy"] = self.sched.occupancy
        summary["final_queue_depth"] = self.sched.queue_depth
        # A paged pool: every exit path returned its pages.
        summary["final_pages_in_use"] = (
            self.page_pool.pages_in_use() if self.page_pool else 0)
        return outs, summary

    def graph_cache_entries(self) -> dict:
        """Captured CUDA graphs by program, as the JAX engine's
        ``jit_cache_entries``: ``macro_decode`` (the K-tick decode
        dispatch), ``chunk`` (a full prefill chunk, the draft's with the
        verifier's in speculative mode; a shorter tail runs eagerly) and,
        in speculative mode, ``spec_macro`` (the K-round dispatch), each
        0 or 1; all 0 on the CPU or with graphing off."""
        out = {"macro_decode": int(self._decode.captured),
               "chunk": int(self._chunk.captured)}
        if self._spec:
            out["spec_macro"] = int(self._spec_decode.captured)
        return out

    def contract_traces(self) -> dict:
        """{name: (trace, donated leaf names)} of one eager call of each of
        the engine's programs (``analysis.trace.record``), the counterpart
        of the JAX engine's ``contract_lowerings``, for the contracts of
        ``analysis.trace`` (no collective, no host op, the pool written
        in place): ``macro_decode`` (the K-tick decode dispatch; every
        pool tensor donated), ``spec_macro`` in speculative mode (both
        pools and the draft's scratch twin donated) and ``prefill_chunk``
        (a prefill tick, which writes the static prefill cache by a copy
        and donates nothing, as the reference's prefill chunk donates
        nothing). Each program runs once on the engine's static buffers
        as they are: on an idle engine no slot is active and the
        dispatches leave the pool's state as it was; the engine is for
        analysis after this call."""
        from repro_torch.analysis import trace as trace_lib

        def leaves(**trees):
            def get():
                return {f"{name}/{path}": t for name, tree in trees.items()
                        for path, t in tree_items(_local(tree))}
            return get

        progs = {"macro_decode": (self._decode.fn, leaves(pool=self.pool))}
        if self._spec:
            progs["spec_macro"] = (self._spec_decode.fn, leaves(
                pool=self.pool, draft_pool=self.draft_pool,
                draft_scratch=self._draft_scratch))
        progs["prefill_chunk"] = (self._chunk.fn, None)
        out = {}
        with torch.inference_mode():
            for name, (fn, get) in progs.items():
                tr = trace_lib.record(fn, leaves=get)
                out[name] = (tr, tuple(tr.before))
        return out

    # -- durability: checkpoint / restore ------------------------------------

    def checkpoint(self) -> str:
        """Write an atomic engine checkpoint next to the journal; its path.

        Journal first, checkpoint second: the flush puts on disk every
        token the checkpointed mirrors count as emitted, so a restored
        resident slot's ``gen`` never runs ahead of its journaled stream.
        Called every ``serving.checkpoint_every_ticks`` ticks (at step
        boundaries), or explicitly."""
        if self.journal is None:
            raise RuntimeError(
                "checkpointing requires the engine to have a journal "
                "(ContinuousServingEngine(..., journal=Journal(path)))")
        self.journal.flush()
        state = checkpoint_lib.snapshot_engine(self)
        path = checkpoint_lib.checkpoint_path(self._ckpt_dir, self.tick)
        checkpoint_lib.save(path, state)
        self._last_ckpt_tick = self.tick
        self.metrics.checkpoints_written += 1
        return path

    @classmethod
    def restore(cls, path: str, cfg: ArchConfig, params: dict, *,
                serving: ServingConfig = ServingConfig(),
                device: str | torch.device = "cuda",
                fault_injector=None, prefix_cache=None,
                clock: Callable[[], float] = time.perf_counter,
                on_token: Callable[[int, int], None] | None = None,
                on_finish: Callable[[int, str], None] | None = None,
                redeliver: bool = False, mesh=None,
                rules: shd.ShardingRules = shd.DEFAULT_RULES
                ) -> "ContinuousServingEngine":
        """Rebuild an engine from a durability directory (journal and
        checkpoints) after a crash, with byte-identical streams.

        Recovery: a tolerant journal replay (a torn tail is dropped and
        truncated), the latest *valid* checkpoint (corrupt files
        skipped), a fresh engine on ``device``, then :meth:`_apply_restore`:
        the pool, mirrors, page allocator and prefix cache come from the
        checkpoint when its geometry matches this config; every live rid is rebuilt from
        its journaled admission. Residents of the checkpoint resume
        mid-stream in their slots; every other live request queues again
        in arrival order and prefills from scratch. Sampling is keyed on
        (seed, rid, token index), so both regenerate the pre-crash tokens
        bit for bit; the journal's horizon dedupes them (checked in
        :meth:`_emit`), so callbacks see each token once. A checkpoint of
        another geometry (slot count, max_len, page size) is not used: recovery runs
        from the journal alone, with the same streams and more replay.

        ``on_token``/``on_finish`` attach to every restored live request;
        ``redeliver=True`` also fires them for the journaled tokens (and
        the journaled terminations) at restore time, for a consumer that
        lost its own state with the process. The directory may have been
        written by the JAX package's engine: the formats are one.

        A slot-sharded engine (``mesh``) restores on every rank from that
        rank's own directory: each holds the same journal and the whole
        pool in its checkpoints (gathered at save), and takes its block.
        """
        t0 = clock()
        jpath = os.path.join(path, journal_lib.JOURNAL_NAME)
        jst = journal_lib.replay(jpath)
        meta = jst.meta
        if meta is not None:
            if meta.get("stream_key_v") != sampling.STREAM_KEY_VERSION:
                raise ValueError(
                    f"journal stream keying v{meta.get('stream_key_v')} != "
                    f"engine v{sampling.STREAM_KEY_VERSION}: regenerated "
                    f"tokens would not be byte-identical; cannot resume")
            if (int(meta.get("seed", serving.seed)) != serving.seed
                    or float(meta.get("temperature", serving.temperature))
                    != serving.temperature):
                raise ValueError(
                    "journal was written under a different sampling config "
                    f"(seed={meta.get('seed')}, temperature="
                    f"{meta.get('temperature')}); restore with the same "
                    "seed/temperature or streams diverge")
            if "speculative" in meta and (
                    bool(meta["speculative"]) != bool(serving.speculative)
                    or int(meta.get("spec_gamma", 0))
                    != (serving.spec_gamma if serving.speculative else 0)):
                # Sampled speculative streams draw on tagged substreams and
                # gamma decides the bonus indices: crossing modes (or
                # gammas) would regenerate other tokens.
                raise ValueError(
                    "journal was written under a different speculative "
                    f"config (speculative={meta['speculative']}, "
                    f"spec_gamma={meta.get('spec_gamma')}); restore with "
                    "the same speculative/spec_gamma or streams diverge")
        ck = checkpoint_lib.latest_valid(path)
        jr = journal_lib.Journal(jpath, truncate_to=jst.valid_bytes)
        eng = cls(cfg, params, serving=serving, device=device, clock=clock,
                  fault_injector=fault_injector, prefix_cache=prefix_cache,
                  journal=jr, mesh=mesh, rules=rules)
        eng._apply_restore(jst, ck, on_token=on_token, on_finish=on_finish,
                           redeliver=redeliver)
        eng.recovery["wall_s"] = clock() - t0
        return eng

    def _leaves_from(self, template, saved: list):
        """A new tree shaped as ``template`` from the numpy leaves
        ``saved`` (checked by :meth:`_fits`), in fresh tensors on the
        engine's device (a prefix-cache entry's snapshot)."""
        it = iter(saved)
        return tree_map(lambda t: torch.from_numpy(np.array(next(it))).to(
            self.device, t.dtype), template)

    @staticmethod
    def _fits(template, saved) -> bool:
        cur = tree_leaves(template)
        return (isinstance(saved, list) and len(cur) == len(saved)
                and all(checkpoint_lib.leaf_matches(c, s)
                        for c, s in zip(cur, saved)))

    @torch.inference_mode()
    def _apply_restore(self, jst: journal_lib.JournalState,
                       ck: dict | None, *, on_token, on_finish,
                       redeliver: bool):
        S = self.serving.num_slots
        usable = (
            ck is not None
            and int(ck.get("num_slots", -1)) == S
            and int(ck.get("max_len", -1)) == self.serving.max_len
            and int(ck.get("page_size", -1))
            == (self.page_pool.page_size if self.page_pool else 0)
            and bool(ck.get("speculative", False)) == self._spec
            and int(ck.get("spec_gamma", 0))
            == (self.serving.spec_gamma if self._spec else 0)
            and self._fits(self._whole_pool(self.cfg), ck.get("pool"))
            and (not self._spec
                 or self._fits(self._whole_pool(self.draft_cfg),
                               ck.get("draft_pool"))))
        resident: dict[int, int] = {}       # rid -> slot
        if usable:
            # Into the pool's own tensors, which the decode programs bind
            # (this rank's block of a sharded pool).
            self._load_block(self.pool, ck["pool"], self.cfg)
            if self._spec:
                self._load_block(self.draft_pool, ck["draft_pool"],
                                 self.draft_cfg)
            mir = ck["mirrors"]
            self._last_tok = np.asarray(mir["last_tok"], np.int32).copy()
            self._active = np.asarray(mir["active"], bool).copy()
            self._rids = np.asarray(mir["rids"], np.int32).copy()
            self._gen = np.asarray(mir["gen"], np.int32).copy()
            self._eos = np.asarray(mir["eos"], np.int32).copy()
            self._maxn = np.asarray(mir["maxn"], np.int32).copy()
            if self.page_pool is not None and ck.get("page_pool"):
                self.page_pool.load_snapshot(ck["page_pool"])
            self.tick = int(ck["tick"])
            self.metrics.ticks = self.tick
            self._last_ckpt_tick = self.tick
            resident = {int(r): int(s) for s, r in ck["slots"].items()}
            if self.prefix_cache is not None and ck.get("prefix"):
                # Rebuild the prefix-cache index, oldest first so the LRU
                # order holds. Refcounts restart at zero: restored requests
                # pin again when they re-admit. An entry of another shape
                # is skipped (a later miss).
                one = api.init_cache(self.cfg, 1, self.serving.max_len,
                                     device=self.device)
                V = self.cfg.vocab_size
                for ent in ck["prefix"]:
                    lg = ent["logits"]
                    if not self._fits(one, ent["cache"]) or (
                            lg is not None and lg.shape != (1, 1, V)):
                        continue
                    if lg is not None:
                        lg = torch.from_numpy(np.array(lg)).to(
                            self.device, self.cfg.activation_dtype)
                    self.prefix_cache.insert(
                        ent["tokens"], self._leaves_from(one, ent["cache"]),
                        logits=lg, copy=False)
        nr = int(ck["next_rid"]) if usable else 0
        if jst.admits:
            nr = max(nr, max(jst.admits) + 1)
        self._next_rid = nr
        # Residency is checked against the journal: a resident slot needs
        # a journaled admission, no termination, agreeing mirrors, and a
        # journaled stream at least as long as its gen (which the
        # flush-before-checkpoint order guarantees); otherwise the request
        # re-admits from scratch.
        for rid, slot in list(resident.items()):
            toks = jst.tokens.get(rid, [])
            ok = (rid in jst.admits and rid not in jst.fins
                  and 0 <= slot < S and bool(self._active[slot])
                  and int(self._rids[slot]) == rid
                  and 0 < int(self._gen[slot]) <= len(toks))
            if not ok:
                resident.pop(rid)
        now_wall = self._clock()
        for rid in sorted(jst.admits):
            a = jst.admits[rid]
            toks = [int(t) for t in jst.tokens.get(rid, [])]
            st = RequestStats(rid=rid, arrival=float(a["arrival"]),
                              prompt_len=len(a["prompt"]))
            st.arrival_wall = now_wall   # wall deadlines re-anchor here
            st.retries = int(jst.retries.get(rid, 0))
            self.metrics.per_request[rid] = st
            self._outputs[rid] = list(toks)
            fin = jst.fins.get(rid)
            if fin is not None:
                # Terminal before the crash: its stream is the journal's;
                # not re-admitted, not counted in this engine's counters.
                st.finish_reason = fin
                st.finished = self.tick
                continue
            req = Request(
                np.asarray(a["prompt"], np.int32),
                max_new_tokens=int(a["max_new"]),
                eos_id=int(a["eos"]),
                arrival_time=float(a["arrival"]),
                on_token=on_token, on_finish=on_finish,
                ttft_deadline_ticks=a.get("ttft_deadline_ticks"),
                deadline_ticks=a.get("deadline_ticks"),
                ttft_deadline_s=a.get("ttft_deadline_s"),
                deadline_s=a.get("deadline_s"))
            if toks:
                self._replay_until[rid] = len(toks)
            slot = resident.get(rid)
            if slot is not None:
                gen = int(self._gen[slot])
                rec = _Slot(rid, req, int(self._last_tok[slot]),
                            tokens=list(toks[:gen]))
                self.sched.active[slot] = rec
                self.sched.free.remove(slot)
                st.slot = slot
                st.admitted = self.tick
                st.first_token = self.tick
                st.first_token_wall = now_wall
            else:
                self.sched.waiting.append((rid, req))
        self.sched.waiting = collections.deque(
            sorted(self.sched.waiting,
                   key=lambda t: (t[1].arrival_time, t[0])))
        # Slots the journal shows evicted after the checkpoint (or whose
        # residency failed the check) go idle in the mirrors and return
        # their pages. No device op: idle slots pass through the decode
        # unchanged, write_slot overwrites a slot's pages whole on reuse
        # and installs the allocator's tables.
        for slot in range(S):
            if self._active[slot] and slot not in self.sched.active:
                self._active[slot] = False
                if (self.page_pool is not None
                        and self.page_pool.slot_pages(slot)):
                    self.page_pool.free_slot(slot)
        if self.page_pool is not None:
            self._note_pages()
        if redeliver:
            for rid in sorted(self._outputs):
                if on_token is not None:
                    for tok in self._outputs[rid]:
                        on_token(rid, int(tok))
                fin = jst.fins.get(rid)
                if fin is not None and on_finish is not None:
                    on_finish(rid, fin)
        self.recovery = {
            "checkpoint_used": bool(usable),
            "checkpoint_tick": int(ck["tick"]) if usable else None,
            "journal_records": jst.records,
            "journal_dropped_tail": jst.dropped_tail,
            "resident_resumed": len(self.sched.active),
            "requeued": len(self.sched.waiting),
            "terminal_from_journal": len(jst.fins),
        }

    def _debug_audit(self):
        """Invariant audit (``ServingConfig.debug_audit`` or the
        ``REPRO_DEBUG_AUDIT`` environment variable), run at the end of
        every :meth:`run`: free and resident slots partition the pool, the
        host mirrors mark exactly the resident slots live, the page
        allocator's free and owned pages partition the page pool, every
        prefix-cache refcount is a live request's pin (a leaked pin would
        block eviction for good), and in speculative mode the draft pool
        and the verifier's have absorbed the same context in every live
        slot and no plain decode dispatch was captured (``spec_macro`` is
        the engine's one)."""
        S = self.serving.num_slots
        free, live = set(self.sched.free), set(self.sched.active)
        assert not free & live and free | live | (
            {self._prefill.slot} if self._prefill else set()) == set(
                range(S)), f"slot pool partition broken: {free}, {live}"
        assert set(np.flatnonzero(self._active)) <= live, (
            "a free slot is marked live in the decode mirrors")
        if self.page_pool is not None:
            self.page_pool.check()
        if self.prefix_cache is not None:
            refs = self.prefix_cache.live_refs()
            pins = len(self._pfx_refs)
            assert refs == pins, (
                f"prefix-cache refcount leak: {refs} live refs vs {pins} "
                f"engine pins")
        if self._spec:
            graphs_now = self.graph_cache_entries()
            assert graphs_now["macro_decode"] == 0, (
                f"a speculative engine dispatched the plain macro step: "
                f"{graphs_now}")
            slots = sorted(i for i in map(self._slot_index, live)
                           if i is not None)
            vpos = self.pool.pos.cpu().numpy()[slots]
            dpos = self.draft_pool.pos.cpu().numpy()[slots]
            assert (vpos == dpos).all(), (
                f"draft and verifier pools out of step in slots {slots}: "
                f"positions {dpos} against {vpos}")

    # -- internals ----------------------------------------------------------

    def _need_rows(self, req: Request) -> int:
        """Context rows a request occupies, a vision prefix + prompt +
        decode budget: what the page allocator sizes a slot's pages by.
        Speculative decoding adds ``spec_gamma`` rows: a round writes that
        far past the accept horizon before it rolls back, so the slot's
        pages cover them and rollback never touches the page tables."""
        need = _prefix_rows(self.cfg) + len(req.prompt) + req.max_new_tokens
        return need + self.serving.spec_gamma if self._spec else need

    def _note_pages(self):
        self.metrics.pages_in_use = self.page_pool.pages_in_use()
        self.metrics.pages_peak = self.page_pool.pages_peak

    def _seed_from_prefix(self, pf: _Prefill, C: int):
        """Seed an admission from the longest cached prompt prefix.

        A full-prompt hit skips prefill: the stored last-token logits
        sample token 0 (sampling is keyed on (seed, rid, idx), never on how
        the state was produced) and ``write_slot`` copies the snapshot into
        the pool. A proper-prefix hit clones the snapshot and
        chunk-prefills only the suffix; hits land on chunk multiples only,
        so the suffix's chunks are a cold prefill's and the stream is
        byte-identical."""
        entry = self.prefix_cache.lookup(pf.req.prompt, chunk=C)
        if entry is None:
            return
        self.prefix_cache.acquire(entry)
        self._pfx_refs[pf.rid] = entry
        st = self.metrics.per_request[pf.rid]
        st.prefix_cached = True
        st.prefix_tokens = entry.length
        self.metrics.prefix_hits += 1
        self.metrics.prefix_tokens_reused += entry.length
        if entry.length == len(pf.req.prompt):
            pf.cache = entry.cache   # write_slot copies it into the pool
            pf.logits = entry.logits
        else:
            _copy_into(pf.cache, entry.cache)
        pf.offset = entry.length
        pf.prefix_offset = _prefix_rows(self.cfg)   # the snapshot holds it

    def _decode_program(self) -> torch.Tensor:
        """One decode dispatch over the static buffers: the pool and the
        control vectors in ``_ctl``; the (3, K, S) token buffer."""
        c, sv = self._ctl, self.serving
        with self._tp_ctx():
            return _macro_decode(
                self.params, self.pool, c[0], c[1].bool(), c[2], c[3], c[4],
                c[5], cfg=self.cfg, num_ticks=sv.macro_ticks,
                temperature=sv.temperature, seed=sv.seed,
                fault_guard=sv.fault_guard, tp_mesh=self._tp)

    def _spec_program(self) -> torch.Tensor:
        """One speculative dispatch over the static buffers: both pools,
        the draft's scratch twin and the control vectors in ``_ctl``; the
        (K, 3 (gamma + 1) + 1, S) token buffer."""
        c, sv = self._ctl, self.serving
        return speculative.spec_macro(
            self.params, self.draft_pool, self._draft_scratch, self.pool,
            c[0], c[1].bool(), c[2], c[3], c[4], c[5],
            draft_cfg=self.draft_cfg, cfg=self.cfg,
            num_rounds=sv.macro_ticks, gamma=sv.spec_gamma,
            temperature=sv.temperature, seed=sv.seed,
            fault_guard=sv.fault_guard)

    def _absorb(self, tokens: torch.Tensor) -> torch.Tensor:
        """Absorb one prompt chunk into the static prefill cache, in place
        (and into the draft's, in speculative mode, so both regimes enter
        decoding in agreement); the verifier's last-token logits
        (1, 1, V)."""
        with self._tp_ctx():
            logits, new = api.prefill_chunk(self.cfg, self.params,
                                            self._pf_cache, tokens)
            logits = shd.full_tensor(logits)
        _copy_into(self._pf_cache, new)
        if self._spec:
            _, new = api.prefill_chunk(self.draft_cfg, self.params,
                                       self._pf_draft, tokens)
            _copy_into(self._pf_draft, new)
        return logits

    def _absorb_prefix(self, pf: _Prefill, C: int) -> None:
        """Absorb the next up to ``C`` rows of the vision patch prefix
        (zero stand-ins, as the reference's) into the static prefill cache
        as pre-embedded rows, one engine tick, eagerly."""
        n = min(C, _prefix_rows(self.cfg) - pf.prefix_offset)
        emb = torch.zeros(1, n, self.cfg.d_model,
                          dtype=self.cfg.activation_dtype, device=self.device)
        _, new = api.prefill_chunk(self.cfg, self.params, self._pf_cache,
                                   None, embeds=emb)
        _copy_into(self._pf_cache, new)
        pf.prefix_offset += n

    def _prefill_whole(self, pf: _Prefill, prompt: np.ndarray):
        """Absorb a whole prompt in one tick (``prefill_chunk=0``, or a
        config that cannot chunk), behind its frontend stand-ins: right-
        padded to a pow-2 bucket and masked by its true length where the
        config takes a masked prefill (``bucket_hits``/``bucket_misses``
        count the buckets seen before and new ones), else at its own
        length. The prefill returns a fresh batch-1 cache, which
        ``write_slot`` copies into the pool; the static prefill cache is
        not used. Runs eagerly. The last-token logits (1, 1, V)."""
        cfg, dev, L = self.cfg, self.device, self.serving.max_len
        n = len(prompt)
        kw = _frontend_kw(cfg, 1, dev)
        if self._bucketable:
            # The cap leaves room for the vision prefix: prefix + bucket
            # must fit the ring, or its writes would drop prefix rows
            # still inside the validity horizon (submit() refuses what
            # does not fit, so the cap never falls under the prompt).
            prefix = _prefix_rows(cfg)
            Lb = _bucket_len(n, self.serving.prefill_bucket_min, L - prefix)
            if Lb in self._seen_buckets:
                self.metrics.bucket_hits += 1
            else:
                self._seen_buckets.add(Lb)
                self.metrics.bucket_misses += 1
            padded = np.zeros((1, Lb), np.int32)
            padded[0, :n] = prompt
            tokens = torch.from_numpy(padded).to(dev)
            kw["true_len"] = torch.full((1,), prefix + n, dtype=torch.int32,
                                        device=dev)
        else:
            tokens = torch.from_numpy(prompt[None, :]).to(dev)
        with self._tp_ctx():
            logits, pf.cache = api.prefill(self.params, cfg, tokens,
                                           max_len=L, **kw)
            logits = shd.full_tensor(logits)
        if self._spec:
            _, pf.draft = api.prefill(self.params, self.draft_cfg, tokens,
                                      max_len=L, **kw)
        pf.offset = n
        return logits

    def _prefill_tick(self):
        pf = self._prefill
        C = self.serving.prefill_chunk
        if pf is None:
            slot_ok = None
            if self.page_pool is not None:
                slot_ok = (lambda s, r:
                           self.page_pool.can_alloc(s, self._need_rows(r)))
            admission = self.sched.next_admission(slot_ok)
            if admission is None:
                return
            rid, req, slot = admission
            for t in tree_leaves(_local({"v": self._pf_cache,
                                         "d": self._pf_draft})):
                t.zero_()
            pf = _Prefill(rid, req, slot, self._pf_cache,
                          draft=self._pf_draft)
            if self.page_pool is not None:
                # Host-side reservation only: the device tables learn the
                # mapping at install (write_slot), so an admission that
                # ends mid-prefill frees host-side with no device op.
                self.page_pool.alloc(slot, self._need_rows(req))
                self._note_pages()
            if self.prefix_cache is not None and C:
                self._seed_from_prefix(pf, C)
            self._prefill = pf
            self.metrics.per_request[rid].admitted = self.tick
            self.metrics.per_request[rid].slot = slot
        req, prompt = pf.req, np.asarray(pf.req.prompt, np.int32)
        logits = pf.logits
        if logits is not None:
            pass                     # a full prefix hit: nothing to run
        elif self._chunkable and C:
            if pf.prefix_offset < _prefix_rows(self.cfg):
                self._absorb_prefix(pf, C)
                return
            chunk = torch.from_numpy(prompt[None, pf.offset:pf.offset + C])
            if chunk.shape[1] == C:
                self._pf_tokens.copy_(chunk)
                logits = self._chunk()
            else:
                # A tail shorter than C runs eagerly on the same buffers: the
                # JAX engine compiles one chunk program per length, and one
                # graph per tail length would capture for almost every prompt.
                logits = self._absorb(chunk.to(self.device))
            pf.offset += chunk.shape[1]
            if (self.prefix_cache is not None and pf.offset % C == 0
                    and pf.offset < len(prompt)):
                # Chunk-boundary snapshot (a clone): a later prompt with
                # this prefix seeds from it and prefills only its suffix.
                self.prefix_cache.insert(prompt[:pf.offset], pf.cache)
        else:
            logits = self._prefill_whole(pf, prompt)
        if pf.offset < len(prompt):
            return                       # more chunks; decode may interleave
        # Prompt absorbed: sample the first token on the device (the decode
        # loop's sampler, index 0) and install the request in its slot.
        # One int32 scalar crosses to the host.
        rid_t = torch.full((1,), pf.rid, dtype=torch.int32,
                           device=self.device)
        tok0 = int(sampling.sample_tokens(
            logits[:, -1, :], rid_t, torch.zeros_like(rid_t),
            temperature=self.serving.temperature, seed=self.serving.seed)[0])
        self.metrics.prefill_token_syncs += 1
        if (self.prefix_cache is not None and C and pf.logits is None):
            # Full-prompt entry with its last-token logits: a repeat of
            # this prompt is admitted with no prefill.
            self.prefix_cache.insert(prompt, pf.cache,
                                     logits=logits[:, -1:, :])
        i = self._slot_index(pf.slot)
        if i is not None:            # the owning rank installs the slot
            api.write_slot(self.cfg, _local(self.pool), _local(pf.cache), i,
                           self._page_vectors())
            if self._spec:
                api.write_slot(self.draft_cfg, self.draft_pool, pf.draft, i)
        self._prefill = None
        self.metrics.prompt_tokens += (
            len(prompt) - self.metrics.per_request[pf.rid].prefix_tokens)
        slot_rec = _Slot(pf.rid, req, tok0)
        self.sched.active[pf.slot] = slot_rec
        self._last_tok[pf.slot] = tok0
        self._active[pf.slot] = True
        self._rids[pf.slot] = pf.rid
        self._gen[pf.slot] = 1
        self._eos[pf.slot] = req.eos_id
        self._maxn[pf.slot] = req.max_new_tokens
        self._emit(slot_rec, tok0, 0)
        if tok0 == req.eos_id or req.max_new_tokens <= 1:
            self._finish(pf.slot,
                         sampling.finish_reason_of(tok0, req.eos_id))

    def _load_ctl(self):
        """Copy the host mirrors into the static control buffer."""
        lo = self._lo
        self._ctl.copy_(torch.from_numpy(np.ascontiguousarray(np.stack([
            self._last_tok, self._active.astype(np.int32), self._rids,
            self._gen, self._eos, self._maxn])[:, lo:lo + self._slots_local])))

    def _decode_macro(self):
        """One decode dispatch = K device ticks for the whole pool, then
        its replay on the host (:meth:`_replay`)."""
        self._load_ctl()
        buf = self._gather_slots(self._decode())
        self.metrics.decode_dispatches += 1
        buf = buf.cpu().numpy()[:, :, None]   # ONE host sync per K ticks
        self.metrics.host_syncs += 1
        self._replay(buf[0], buf[1].astype(bool), buf[2].astype(bool))

    def _decode_spec(self):
        """One speculative dispatch = K draft-verify rounds, then its
        replay on the host one round per tick (:meth:`_replay`): a round is
        one engine tick (one scheduling quantum) that emits up to
        gamma + 1 tokens per slot."""
        G = self.serving.spec_gamma
        self._load_ctl()
        buf = self._gather_slots(self._spec_decode())
        self.metrics.decode_dispatches += 1
        buf = buf.cpu().numpy()          # ONE host sync per K rounds
        self.metrics.host_syncs += 1
        self._replay(buf[:, :G + 1], buf[:, G + 1:2 * G + 2].astype(bool),
                     buf[:, 2 * G + 2:3 * G + 3].astype(bool),
                     buf[:, 3 * G + 3])

    def _replay(self, toks, em, flt, acc=None):
        """Replay a dispatch's (K, J, S) token and emitted buffers on the
        host tick by tick, so streaming callbacks, TTFT and queue-depth
        samples and eviction stay exact: per tick up to J tokens a slot (1
        for a decode tick, gamma + 1 for a speculative round), in emission
        order. ``flt[t, 0]`` flags the slots that faulted at tick t; ``acc``
        (K, S), speculative only, is each round's accepted drafts, -1
        where the slot ran no counted round."""
        G = self.serving.spec_gamma
        for t in range(toks.shape[0]):
            if not (em[t].any() or flt[t].any()):
                break   # every slot drained mid-dispatch; suffix unused
            self.sched.poll_arrivals(self.tick)
            self.metrics.sample(self.sched.queue_depth,
                                self.sched.occupancy)
            # Quarantine before emission: a faulted slot emitted nothing
            # at this tick (its token is garbage; a faulted round's
            # verifier rewound and its draft absorbed nothing).
            for slot in np.nonzero(flt[t, 0])[0]:
                if int(slot) in self.sched.active:
                    self._quarantine(int(slot))
            if acc is not None:
                for v in acc[t]:
                    if v >= 0:       # a counted round offered G drafts
                        self.metrics.draft_tokens_proposed += G
                        self.metrics.draft_tokens_accepted += int(v)
            for j in range(toks.shape[1]):
                if not em[t, j].any():
                    break   # per-slot emissions are a j-prefix: done
                for slot in list(self.sched.active):
                    if not em[t, j, slot]:
                        continue
                    rec = self.sched.active.get(slot)
                    if rec is None:      # cancelled by an earlier callback
                        continue
                    tk = int(toks[t, j, slot])
                    rec.last_tok = tk
                    self._last_tok[slot] = tk
                    self._gen[slot] += 1
                    self._emit(rec, tk, int(self._gen[slot]) - 1)
                    if (tk == rec.req.eos_id
                            or len(rec.tokens) >= rec.req.max_new_tokens):
                        self._finish(slot, sampling.finish_reason_of(
                            tk, rec.req.eos_id))
            self.sched.note_decode()
            self.metrics.decode_ticks += 1
            self.tick += 1
            self.metrics.ticks = self.tick
            # Sweep after the tick's emissions: EOS beats a deadline
            # expiring on the same tick.
            self._lifecycle_sweep()

    def _emit(self, rec: _Slot, tok: int, idx: int):
        """Deliver one emitted token; ``idx`` is the request's token index
        (the sampling key index, 0 for the prefill-sampled first token).

        After a restore, tokens with ``idx`` below the request's journaled
        horizon were delivered before the crash. Sampling keyed on (seed,
        rid, idx) regenerates them bit for bit, which is checked here (the
        byte-identity assertion); they count as replayed and are neither
        journaled nor delivered again."""
        st = self.metrics.per_request[rec.rid]
        out = self._outputs[rec.rid]
        if idx < self._replay_until.get(rec.rid, 0):
            if idx >= len(out) or tok != out[idx]:
                raise RuntimeError(
                    f"restore byte-identity violated: rid {rec.rid} token "
                    f"{idx} regenerated {tok} != journaled "
                    f"{out[idx] if idx < len(out) else '<missing>'}")
            rec.tokens.append(tok)
            self.metrics.tokens_generated += 1
            self.metrics.tokens_replayed += 1
            if st.first_token is None:
                st.first_token = self.tick
                st.first_token_wall = self._clock()
            return
        rec.tokens.append(tok)
        out.append(tok)
        self.metrics.tokens_generated += 1
        if st.first_token is None:
            st.first_token = self.tick
            st.first_token_wall = self._clock()
        if self.journal is not None:
            self.journal.append({"t": "tok", "rid": rec.rid,
                                 "tok": int(tok)})
        if rec.req.on_token is not None:
            rec.req.on_token(rec.rid, tok)

    def _evict_slot_state(self, slot: int):
        """Zero a slot's device state, so its next owner starts from zeros
        (never from a previous owner's bytes, nor an injected NaN). A paged
        pool returns the slot's pages to the free list; the reset zeroes
        them under the old tables, then installs the new ones. A
        speculative engine resets the slot's draft state too."""
        i = self._slot_index(slot)
        if self._spec and i is not None:
            api.reset_slot(self.draft_cfg, self.draft_pool, i)
        if self.page_pool is not None:
            self.page_pool.free_slot(slot)
            self._note_pages()
        if i is not None:            # the owning rank zeroes the slot
            api.reset_slot(self.cfg, _local(self.pool), i,
                           self._page_vectors())

    def _finish(self, slot: int, reason: str):
        """Evict a slot-resident request into terminal state ``reason``."""
        rec = self.sched.active[slot]
        self._active[slot] = False
        self._evict_slot_state(slot)
        self.sched.evict(slot)
        self._terminate(rec.rid, rec.req, reason)

    def _terminate(self, rid: int, req: Request, reason: str):
        """Stamp the single terminal state of a request: every exit path
        funnels here, so ``on_finish`` fires exactly once and the
        finish-reason breakdown sums to ``requests_terminated``."""
        st = self.metrics.per_request[rid]
        st.finished = self.tick
        st.finish_reason = reason
        self._replay_until.pop(rid, None)
        if self.journal is not None:
            self.journal.append({"t": "fin", "rid": rid, "reason": reason,
                                 "tick": self.tick})
        entry = self._pfx_refs.pop(rid, None)
        if entry is not None:       # release the seeding snapshot's pin
            self.prefix_cache.release(entry)
        m = self.metrics
        m.requests_terminated += 1
        m.finish_reasons[reason] = m.finish_reasons.get(reason, 0) + 1
        if reason in ("eos", "length"):
            m.requests_completed += 1
            if st.retries:
                m.fault_retries_succeeded += 1
        if req.on_finish is not None:
            req.on_finish(rid, reason)

    def _quarantine(self, slot: int):
        """Non-finite decode state detected in ``slot``: reset the slot and
        either re-admit the request from scratch at the head of the ready
        queue (deterministic (seed, rid, idx) sampling regenerates the same
        stream when the fault was transient) or, with
        ``serving.fault_retries`` spent, end it as ``fault``. The emitted
        prefix is dropped either way."""
        rec = self.sched.active[slot]
        st = self.metrics.per_request[rec.rid]
        m = self.metrics
        m.faults_detected += 1
        m.fault_events.append({"rid": rec.rid, "slot": slot,
                               "tick": self.tick})
        self._active[slot] = False
        self._evict_slot_state(slot)
        self.sched.evict(slot)
        ent = self._pfx_refs.pop(rec.rid, None)
        if ent is not None:
            self.prefix_cache.release(ent)
        if st.retries < self.serving.fault_retries:
            st.retries += 1
            m.fault_retries += 1
            self._outputs[rec.rid] = []
            # A retry restarts the stream at index 0: void the journaled
            # prefix (replay folds a retry record into an empty stream) and
            # any restore horizon with it.
            self._replay_until.pop(rec.rid, None)
            if self.journal is not None:
                self.journal.append({"t": "retry", "rid": rec.rid})
            st.first_token = None
            st.first_token_wall = None
            st.prefix_cached = False
            st.prefix_tokens = 0
            # Head of the ready queue: the request already waited its turn.
            self.sched.ready.appendleft((rec.rid, rec.req))
        else:
            self._terminate(rec.rid, rec.req, "fault")

    def _release_prefill_slot(self, slot: int):
        """Return a mid-prefill slot to the pool (cancel or deadline before
        install); the pool and its page tables were never written, so this
        is host-only."""
        self.sched.free.append(slot)
        self.sched.free.sort()
        if self.page_pool is not None:
            self.page_pool.free_slot(slot)
            self._note_pages()

    # -- lifecycle: cancellation, deadlines, queue-age shedding -------------

    @torch.inference_mode()
    def cancel(self, rid: int) -> bool:
        """Cancel a request anywhere in its lifecycle: queued,
        mid-prefill, or slot-resident (also mid-macro-step: the replay
        re-checks residency per buffered tick, so a cancelled slot's
        remaining device ticks are dropped). True if the request was live
        and now ends as ``cancelled``; False if ``rid`` is unknown or
        already terminal (``on_finish`` never fires twice)."""
        st = self.metrics.per_request.get(rid)
        if st is None or st.finish_reason is not None:
            return False
        req = self.sched.cancel(rid)
        if req is not None:                  # still queued
            self._terminate(rid, req, "cancelled")
            return True
        pf = self._prefill
        if pf is not None and pf.rid == rid:  # admission in flight
            self._prefill = None
            self._release_prefill_slot(pf.slot)
            self._terminate(rid, pf.req, "cancelled")
            return True
        for slot, rec in self.sched.active.items():
            if rec.rid == rid:               # slot-resident
                self._finish(slot, "cancelled")
                return True
        return False                         # pragma: no cover

    def _lifecycle_sweep(self):
        """Deadline expiry plus ``queue_wait`` age shedding over every live
        request (queued, mid-prefill, slot-resident).

        Expiry is strict (``now - arrival > deadline``); TTFT deadlines
        bind only while no token has been emitted."""
        now = self.tick
        wall = self._clock()

        def expired(req: Request, st: RequestStats) -> bool:
            age = now - req.arrival_time
            wage = (wall - st.arrival_wall
                    if st.arrival_wall is not None else 0.0)
            if st.first_token is None:
                if (req.ttft_deadline_ticks is not None
                        and age > req.ttft_deadline_ticks):
                    return True
                if (req.ttft_deadline_s is not None
                        and wage > req.ttft_deadline_s):
                    return True
            if req.deadline_ticks is not None and age > req.deadline_ticks:
                return True
            if req.deadline_s is not None and wage > req.deadline_s:
                return True
            return False

        sched = self.sched
        per = self.metrics.per_request
        for q in (sched.ready, sched.waiting):
            for item in list(q):
                rid, req = item
                if expired(req, per[rid]):
                    q.remove(item)
                    self._terminate(rid, req, "deadline")
        if (self.serving.overload_policy == "queue_wait"
                and self.serving.queue_wait_ticks):
            W = self.serving.queue_wait_ticks
            for q in (sched.ready, sched.waiting):
                for item in list(q):
                    rid, req = item
                    if now - req.arrival_time > W:
                        q.remove(item)
                        self._terminate(rid, req, "shed")
        pf = self._prefill
        if pf is not None and expired(pf.req, per[pf.rid]):
            self._prefill = None
            self._release_prefill_slot(pf.slot)
            self._terminate(pf.rid, pf.req, "deadline")
        for slot, rec in list(sched.active.items()):
            if expired(rec.req, per[rec.rid]):
                self._finish(slot, "deadline")

    def _apply_injections(self):
        """Consult the chaos injector: injected cancellations take the
        public :meth:`cancel` path; slot corruption NaNs a live slot's
        state on the device, and detection is then the macro step's fault
        lane's job, as for an organic fault."""
        inj = self._injector
        if inj.crash_now(self.tick):
            # Simulated process death: out of step() with no cleanup.
            raise faults_lib.EngineCrash(self.tick)
        live_rids = ([rec.rid for rec in self.sched.active.values()]
                     + [rid for rid, _ in self.sched.ready])
        for rid in inj.cancel_rids(self.tick, live_rids):
            self.cancel(rid)
        for slot in inj.corrupt_slots(self.tick, list(self.sched.active)):
            if slot in self.sched.active and self._slot_index(slot) is not None:
                api.corrupt_slot(self.cfg, _local(self.pool),
                                 self._slot_index(slot))
