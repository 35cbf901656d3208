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
copy and eviction one ``reset_slot`` zero. On the card every decode tick
of the pool launches the masked decode kernel once per layer.

Fault model (DESIGN.md §10): every request ends with exactly one
``finish_reason`` of ``sampling.FINISH_REASONS``. Admission failures are
typed (:class:`AdmissionError` and its subclasses), overload degrades
per ``ServingConfig.overload_policy``, requests carry tick and wall-clock
deadlines and can be cancelled anywhere in their lifecycle, and a
per-slot NaN/Inf lane in the decode dispatch detects numeric faults,
which the host quarantines and retries. ``serving.faults`` holds the
deterministic chaos injector that exercises all of it.

Not in the port yet (ROADMAP Queue A item 11), each refused by
``ServingConfig.check_supported`` when the engine is built: paged slot
memory, the prefix cache, journal, checkpoints and ``restore``,
speculative decoding, a sharded slot pool and the bucketed whole-prompt
prefill fallback.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, ServingConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import sampling


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


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class ServingEngine:
    """Lockstep engine. Batched ``generate`` left-pads prompts to a common
    length with token 0, so with mixed prompt lengths the pad tokens are
    visible to the model — the JAX engine's behaviour, kept for parity."""

    def __init__(self, cfg: ArchConfig, params: dict, *,
                 device: str | torch.device = "cuda", max_len: int = 4096):
        cfg.check_supported()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_len = max_len

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
            raise ValueError(f"prompt+max_new ({over}) exceeds "
                             f"max_len {self.max_len}")
        prompts = np.zeros((B, lp), np.int32)
        for i, r in enumerate(requests):
            prompts[i, lp - len(r.prompt):] = r.prompt
        tokens = torch.from_numpy(prompts).to(self.device)
        logits, cache = api.prefill(self.params, self.cfg, tokens,
                                    max_len=self.max_len)
        key = prng.PRNGKey(seed)
        max_new = max(r.max_new_tokens for r in requests)
        out = np.zeros((B, max_new), np.int32)
        lengths = np.zeros(B, np.int64)
        done = np.zeros(B, bool)
        tok = self._sample(logits, temperature, key)
        for t in range(max_new):
            tok_np = tok[:, 0].cpu().numpy()
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
            logits, cache = api.decode_step(self.params, self.cfg, cache, tok)
            tok = self._sample(logits, temperature, sub)
        return [out[i, :lengths[i]] for i in range(B)]

    @staticmethod
    def _sample(logits, temperature: float, key):
        logits = logits[:, -1, :]
        if temperature <= 0.0:
            return torch.argmax(logits, -1).to(torch.int32)[:, None]
        g = prng.categorical(key, sampling.scale_logits(logits, temperature))
        return g.to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


def _macro_decode(params, cache, last_tok, active, rids, gen, eos_ids,
                  max_new, *, cfg: ArchConfig, num_ticks: int,
                  temperature: float, seed: int, fault_guard: bool = True):
    """K decode ticks over the slot pool, all on the device.

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
    the same for every K. Returns the cache and one (3, K, S) int32
    tensor: tokens, emitted flags and fault flags.
    """
    toks, ems, flts = [], [], []
    for _ in range(num_ticks):
        logits, cache = api.decode_step(params, cfg, cache,
                                        last_tok[:, None], active)
        row = logits[:, -1, :]
        tok = sampling.sample_tokens(row, rids, gen,
                                     temperature=temperature, seed=seed)
        if fault_guard:
            ok = (api.slot_state_finite(cfg, cache)
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
    buf = torch.stack([torch.stack(toks), torch.stack(ems).to(torch.int32),
                       torch.stack(flts).to(torch.int32)])
    return cache, buf


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
    ``summary()`` has the reference's keys; those of features the port
    does not have yet (paging, prefix cache, journal and checkpoints,
    speculative decoding, bucketed prefill) read 0 or False.
    """

    num_slots: int = 0
    macro_ticks: int = 1
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
    host_syncs: int = 0
    prefill_token_syncs: int = 0
    requests_terminated: int = 0
    finish_reasons: dict = dataclasses.field(default_factory=dict)
    faults_detected: int = 0
    fault_retries: int = 0
    fault_retries_succeeded: int = 0
    fault_events: list = dataclasses.field(default_factory=list)
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
            "slot_shards": 1,
            "decode_dispatches": self.decode_dispatches,
            "host_syncs": self.host_syncs,
            "prefill_token_syncs": self.prefill_token_syncs,
            "host_syncs_per_token":
                self.host_syncs / max(self.tokens_generated, 1),
            "tokens_per_dispatch":
                self.tokens_generated / max(self.decode_dispatches, 1),
            "dispatches_per_decode_tick":
                self.decode_dispatches / max(self.decode_ticks, 1),
            "bucket_hits": 0,
            "bucket_misses": 0,
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
            "tokens_replayed": 0,
            "checkpoints_written": 0,
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
            "prefix_hits": 0,
            "prefix_tokens_reused": 0,
            # With no prefix cache every admission is cold.
            "ttft_cached_ticks_p50": None,
            "ttft_cached_ticks_p95": None,
            "ttft_cold_ticks_p50": pct(ttfts, 0.50),
            "ttft_cold_ticks_p95": pct(ttfts, 0.95),
            "num_pages": 0,
            "pages_in_use": 0,
            "pages_peak": 0,
            "speculative": False,
            "spec_gamma": 0,
            "draft_tokens_proposed": 0,
            "draft_tokens_accepted": 0,
            "draft_acceptance_rate": 0.0,
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
    cache: object                    # per-request (batch=1) decode cache
    offset: int = 0                  # prompt tokens absorbed so far


class Scheduler:
    """Owns the slot pool and the admission queue.

    FIFO admission into the lowest free slot (the reference's shard-aware
    choice with one shard). At most one prefill is in flight (chunked, so
    a long prompt yields to decode ticks between chunks); decode and
    prefill interleave per ``decode_ticks_per_prefill`` when both have
    work. Token streams never depend on the slot chosen: sampling is
    keyed on (seed, rid, token index) only.
    """

    def __init__(self, serving: ServingConfig):
        self.serving = serving
        self.free: list[int] = list(range(serving.num_slots))
        self.active: dict[int, _Slot] = {}
        self.waiting: collections.deque = collections.deque()  # (rid, req)
        self.ready: collections.deque = collections.deque()
        self._decode_since_prefill = serving.decode_ticks_per_prefill

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

    def next_admission(self):
        """Pop the request to admit next and reserve a slot, or None."""
        if not self.ready or not self.free:
            return None
        rid, req = self.ready.popleft()
        slot = min(self.free)
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
    raises.
    """

    def __init__(self, cfg: ArchConfig, params: dict, *,
                 serving: ServingConfig = ServingConfig(),
                 device: str | torch.device = "cuda",
                 clock: Callable[[], float] = time.perf_counter,
                 fault_injector=None):
        cfg.check_supported()
        serving.check_supported()
        self.device = resolve_device(device)
        self.cfg, self.serving = cfg, serving
        self.params = _to_device(params, self.device)
        self._clock = clock
        # Chaos harness hook (serving.faults.FaultInjector), tests and
        # benchmarks only.
        self._injector = fault_injector
        self.sched = Scheduler(serving)
        self.metrics = ServingMetrics(num_slots=serving.num_slots,
                                      macro_ticks=serving.macro_ticks,
                                      clock=clock)
        self.tick = 0
        self._next_rid = 0
        self._outputs: dict[int, list] = {}
        self._prefill: _Prefill | None = None
        self._audit = serving.debug_audit or (
            os.environ.get("REPRO_DEBUG_AUDIT", "") not in ("", "0"))
        S = serving.num_slots
        with torch.inference_mode():
            self.pool = api.init_cache(cfg, S, serving.max_len,
                                       device=self.device)
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

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its request id.

        Raises :class:`RequestTooLargeError` when prompt + max_new exceeds
        the slot's context capacity (never for SLAY, whose state is
        constant-size) and :class:`QueueFullError` when the queue is at
        ``max_queue`` under ``reject_new``. Under ``shed_oldest`` the
        longest-waiting queued request ends as ``shed`` instead; under
        ``queue_wait`` admission always succeeds. A rejected request is
        never enqueued and consumes no rid."""
        if self._injector is not None:
            delay = self._injector.arrival_delay_for()
            if delay:
                req = dataclasses.replace(
                    req, arrival_time=req.arrival_time + delay)
        need = len(req.prompt) + req.max_new_tokens
        cap = api.context_capacity(self.cfg, self.serving.max_len)
        if cap is not None and need > cap:
            raise RequestTooLargeError(
                f"request does not fit its decode slot: {len(req.prompt)} "
                f"prompt + {req.max_new_tokens} max_new = {need} > context "
                f"capacity {cap}",
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
        for srid, sreq in shed:
            self._terminate(srid, sreq, "shed")
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
            self._decode_macro()
            did = True
        else:
            self.metrics.sample(sched.queue_depth, sched.occupancy)
            self.tick += 1
        self.metrics.ticks = self.tick
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
        if self._audit:
            self._debug_audit()
        outs = {rid: np.asarray(toks, np.int32)
                for rid, toks in self._outputs.items()}
        summary = self.metrics.summary()
        summary["journal_bytes"] = 0
        # Leak contract: a drained engine holds no live slot and an empty
        # queue, whatever path each request left by.
        summary["final_occupancy"] = self.sched.occupancy
        summary["final_queue_depth"] = self.sched.queue_depth
        summary["final_pages_in_use"] = 0
        return outs, summary

    def _debug_audit(self):
        """Invariant audit (``ServingConfig.debug_audit`` or the
        ``REPRO_DEBUG_AUDIT`` environment variable), run at the end of
        every :meth:`run`: free and resident slots partition the pool, and
        the host mirrors mark exactly the resident slots live."""
        S = self.serving.num_slots
        free, live = set(self.sched.free), set(self.sched.active)
        assert not free & live and free | live | (
            {self._prefill.slot} if self._prefill else set()) == set(
                range(S)), f"slot pool partition broken: {free}, {live}"
        assert set(np.flatnonzero(self._active)) <= live, (
            "a free slot is marked live in the decode mirrors")

    # -- internals ----------------------------------------------------------

    def _prefill_tick(self):
        pf = self._prefill
        C = self.serving.prefill_chunk
        if pf is None:
            admission = self.sched.next_admission()
            if admission is None:
                return
            rid, req, slot = admission
            pf = _Prefill(rid, req, slot,
                          api.init_cache(self.cfg, 1, self.serving.max_len,
                                         device=self.device))
            self._prefill = pf
            self.metrics.per_request[rid].admitted = self.tick
            self.metrics.per_request[rid].slot = slot
        req, prompt = pf.req, np.asarray(pf.req.prompt, np.int32)
        chunk = torch.tensor(prompt[None, pf.offset:pf.offset + C])
        logits, pf.cache = api.prefill_chunk(
            self.cfg, self.params, pf.cache,
            chunk.to(self.device, non_blocking=True))
        pf.offset += chunk.shape[1]
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
        api.write_slot(self.cfg, self.pool, pf.cache, pf.slot)
        self._prefill = None
        self.metrics.prompt_tokens += len(prompt)
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

    def _decode_macro(self):
        """One decode dispatch = K device ticks for the whole pool; replay
        the token buffer on the host tick by tick so streaming callbacks,
        TTFT and queue-depth samples and eviction stay exact."""
        ctl = torch.from_numpy(np.stack([
            self._last_tok, self._active.astype(np.int32), self._rids,
            self._gen, self._eos, self._maxn])).to(self.device,
                                                   non_blocking=True)
        sv = self.serving
        self.pool, buf = _macro_decode(
            self.params, self.pool, ctl[0], ctl[1].bool(), ctl[2], ctl[3],
            ctl[4], ctl[5], cfg=self.cfg, num_ticks=sv.macro_ticks,
            temperature=sv.temperature, seed=sv.seed,
            fault_guard=sv.fault_guard)
        self.metrics.decode_dispatches += 1
        buf = buf.cpu().numpy()          # ONE host sync per K ticks
        self.metrics.host_syncs += 1
        toks, em, flt = buf[0], buf[1].astype(bool), buf[2].astype(bool)
        for t in range(toks.shape[0]):
            if not (em[t].any() or flt[t].any()):
                break   # every slot drained mid-macro-step; suffix unused
            self.sched.poll_arrivals(self.tick)
            self.metrics.sample(self.sched.queue_depth,
                                self.sched.occupancy)
            # Quarantine before emission: a faulted slot did not emit at
            # this tick (its sampled token is garbage).
            for slot in np.nonzero(flt[t])[0]:
                if int(slot) in self.sched.active:
                    self._quarantine(int(slot))
            for slot in list(self.sched.active):
                if not em[t, slot]:
                    continue
                rec = self.sched.active.get(slot)
                if rec is None:          # cancelled by an earlier callback
                    continue
                tk = int(toks[t, slot])
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
        (the sampling key index, 0 for the prefill-sampled first token)."""
        st = self.metrics.per_request[rec.rid]
        rec.tokens.append(tok)
        self._outputs[rec.rid].append(tok)
        self.metrics.tokens_generated += 1
        if st.first_token is None:
            st.first_token = self.tick
            st.first_token_wall = self._clock()
        if rec.req.on_token is not None:
            rec.req.on_token(rec.rid, tok)

    def _evict_slot_state(self, slot: int):
        """Zero a slot's device state, so its next owner starts from zeros
        (never from a previous owner's bytes, nor an injected NaN)."""
        api.reset_slot(self.cfg, self.pool, slot)

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
        if st.retries < self.serving.fault_retries:
            st.retries += 1
            m.fault_retries += 1
            self._outputs[rec.rid] = []
            st.first_token = None
            st.first_token_wall = None
            # Head of the ready queue: the request already waited its turn.
            self.sched.ready.appendleft((rec.rid, rec.req))
        else:
            self._terminate(rec.rid, rec.req, "fault")

    def _release_prefill_slot(self, slot: int):
        """Return a mid-prefill slot to the pool (cancel or deadline before
        install); the pool was never written, so this is host-only."""
        self.sched.free.append(slot)
        self.sched.free.sort()

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
            if slot in self.sched.active:
                api.corrupt_slot(self.cfg, self.pool, slot)
