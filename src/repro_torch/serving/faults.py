"""Deterministic chaos injection for the serving engine (DESIGN.md §10).

A copy of ``repro.serving.faults`` (numpy only), so the same chaos
traces drive both packages' engines. Test/bench-only: pass a
:class:`FaultInjector` to ``ContinuousServingEngine(...,
fault_injector=...)`` and the engine
consults it at fixed points — arrival delay at ``submit()``, injected
cancellations and slot NaN-corruption at the top of each tick. Production
engines pass None and none of this code runs.

Every draw is keyed on ``(seed, kind, tick-or-submission-index)`` via
``np.random.SeedSequence`` — no global RNG state, no draw-order
dependence — so a chaos run is a pure function of (trace, seed): replay
the same request trace with the same injector seed and the same faults
land on the same ticks. That determinism is what makes the chaos bench's
degraded-mode rows (shed rate, deadline-miss rate, fault-detect latency,
retry success) trendable in CI rather than flaky.

The injector keeps a ``log`` of every event it fired. The chaos bench
joins the ``nan`` entries against the engine's ``fault_events`` records
(same slot, detect tick >= inject tick) to measure fault-detection
latency in ticks — bounded by K, since detection rides the (K, S) fault
plane of the next decode dispatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# SeedSequence stream tags — one disjoint stream per fault kind.
_ARRIVAL, _CANCEL, _NAN, _CRASH = 1, 2, 3, 4


class EngineCrash(RuntimeError):
    """Injected stand-in for process death (kill -9, preemption).

    Raised out of ``engine.step()`` at the crash tick. The harness must
    *abandon* the engine object — no cleanup runs, exactly as a real
    crash would; buffered journal records are lost with it. An engine
    built with a journal recovers through
    ``ContinuousServingEngine.restore`` on its directory.
    """

    def __init__(self, tick: int):
        super().__init__(f"injected crash at tick {tick}")
        self.tick = int(tick)


@dataclasses.dataclass
class FaultInjector:
    """Seeded fault source. All cadences are in engine ticks; 0 disables
    that fault kind. ``delay_prob`` applies per submission.

    nan_every     corrupt one live slot's device state every N ticks
    cancel_every  cancel one live request every N ticks
    delay_prob    chance a submission's arrival_time is pushed back by
                  Uniform{1..max_delay_ticks} ticks
    crash_window  (lo, hi) tick window: the engine dies (EngineCrash) at
                  one seeded uniform tick in [lo, hi]; () disables. Fires
                  at most once per injector instance.
    """

    seed: int = 0
    nan_every: int = 0
    cancel_every: int = 0
    delay_prob: float = 0.0
    max_delay_ticks: int = 8
    crash_window: tuple = ()
    log: list = dataclasses.field(default_factory=list)
    _submissions: int = 0
    _crashed: bool = False

    def _rng(self, kind: int, n: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, kind, n]))

    def arrival_delay_for(self) -> float:
        """Delay (ticks, possibly 0) for the next submission. Keyed on the
        submission index, so the delay pattern is independent of when in
        wall time requests are submitted."""
        n = self._submissions
        self._submissions += 1
        if not self.delay_prob:
            return 0.0
        rng = self._rng(_ARRIVAL, n)
        if rng.random() >= self.delay_prob:
            return 0.0
        d = int(rng.integers(1, self.max_delay_ticks + 1))
        self.log.append({"kind": "delay", "submission": n, "ticks": d})
        return float(d)

    def cancel_rids(self, tick: int, live_rids) -> list[int]:
        """Request ids to cancel at this tick (at most one). ``live_rids``
        is the engine's view of cancellable requests (slot-resident +
        ready-queued); the choice is uniform over them, keyed on the
        tick so engine-state history cannot perturb later draws."""
        if not self.cancel_every or tick == 0 or tick % self.cancel_every:
            return []
        rids = sorted(live_rids)
        if not rids:
            return []
        rid = rids[int(self._rng(_CANCEL, tick).integers(len(rids)))]
        self.log.append({"kind": "cancel", "tick": tick, "rid": rid})
        return [rid]

    def crash_tick(self) -> int | None:
        """The seeded tick this injector will crash at, or None."""
        if not self.crash_window:
            return None
        lo, hi = int(self.crash_window[0]), int(self.crash_window[1])
        if hi <= lo:
            return lo
        return lo + int(self._rng(_CRASH, 0).integers(hi - lo + 1))

    def crash_now(self, tick: int) -> bool:
        """True exactly once, at the first tick >= the seeded crash tick.
        The engine raises :class:`EngineCrash` out of ``step()`` — no
        flush, no cleanup — simulating process death mid-run."""
        t = self.crash_tick()
        if t is None or self._crashed or tick < t:
            return False
        self._crashed = True
        self.log.append({"kind": "crash", "tick": int(tick)})
        return True

    def corrupt_slots(self, tick: int, live_slots) -> list[int]:
        """Pool slots to NaN-corrupt at this tick (at most one), chosen
        uniformly over the live slots. The engine applies the corruption
        with ``corrupt_slot`` (slot-stable) and then *detects* it
        through the ordinary macro-step fault lane —
        injection exercises the same path an organic NaN would take."""
        if not self.nan_every or tick == 0 or tick % self.nan_every:
            return []
        slots = sorted(live_slots)
        if not slots:
            return []
        slot = slots[int(self._rng(_NAN, tick).integers(len(slots)))]
        self.log.append({"kind": "nan", "tick": tick, "slot": slot})
        return [slot]


def detection_latencies(log: list, fault_events: list) -> list[int]:
    """Join injector ``nan`` events against engine ``fault_events``:
    ticks from injection to quarantine per detected fault (first unmatched
    detection on the same slot at tick >= injection). Undetected
    injections (e.g. the slot finished naturally first — impossible once
    the corruption lands, but possible if it raced an eviction) are
    simply absent."""
    used: set[int] = set()
    out: list[int] = []
    for ev in log:
        if ev.get("kind") != "nan":
            continue
        for i, f in enumerate(fault_events):
            if (i not in used and f["slot"] == ev["slot"]
                    and f["tick"] >= ev["tick"]):
                used.add(i)
                out.append(int(f["tick"] - ev["tick"]))
                break
    return out
