"""The port's ``ContinuousServingEngine`` against the JAX package's on the
same traces, on the CPU, at the smoke config in fp32.

Per request the streams, finish reasons, admitted and first-token ticks
and slots must be identical, and so must every deterministic counter of
``summary()`` (wall-clock keys excluded). The embedding is scaled down
(logits of std about 1) so greedy and sampled streams vary. Identity of
a stream is owed only where no near-tie decides a token (ROADMAP C-2):
each test first checks, teacher-forcing the port alone along the JAX
streams, that the top-2 gap of ``logits / T + g`` stays above 1e-5, and
fails with "near-tie" otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServingConfig as JServingConfig
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import sampling

NAME = "slayformer-124m"
TIE_GAP = 1e-5
PROMPT_LENS = (20, 7, 33, 12, 26)
MAX_NEW = 10
BASE = dict(num_slots=2, max_len=64, prefill_chunk=8)
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot",
             "retries")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, dtype="float32")
    tcfg = get_smoke_config(NAME, dtype="float32")
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    mesh = make_host_mesh()
    # Auto axes: the JAX engine under jax 0.9.0 (ROADMAP C-4).
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    mesh = jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)
    return jcfg, tcfg, jp, tp, mesh


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(3, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _requests(mod, prompts, eos=None, **fields):
    """One Request per prompt of package ``mod``, arriving every 2 ticks;
    ``fields`` maps a Request field to one value or a per-request list."""
    out = []
    for i, p in enumerate(prompts):
        kw = {k: (v[i] if isinstance(v, list) else v)
              for k, v in fields.items()}
        kw.setdefault("max_new_tokens", MAX_NEW)
        kw.setdefault("arrival_time", 2.0 * i)
        out.append(mod.Request(p, eos_id=(eos or {}).get(i, -1), **kw))
    return out


def _engines(models, injector_kw=None, **serving):
    jcfg, tcfg, jp, tp, mesh = models
    kw = {**BASE, **serving}
    inj = injector_kw or {}
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=JServingConfig(**kw),
        fault_injector=jfaults.FaultInjector(**inj) if inj else None)
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**kw), device="cpu",
        fault_injector=tfaults.FaultInjector(**inj) if inj else None)
    return jeng, teng


def _gaps(models, prompt, stream, rid, temperature, seed=0):
    """Top-2 gaps of logits / T + g along ``stream``, the port alone,
    teacher-forced from a whole-prompt prefill."""
    _, tcfg, _, tp, _ = models
    gaps = []
    with torch.inference_mode():
        logits, cache = api.prefill(tp, tcfg, torch.from_numpy(prompt[None]))
        for idx, tok in enumerate(stream):
            row = logits[0, -1].float()
            if temperature > 0:
                row = (sampling.scale_logits(row, temperature)
                       + sampling._gumbel_row(seed, rid, idx, row.shape[-1],
                                              device="cpu"))
            top2 = torch.topk(row, 2).values
            gaps.append(float(top2[0] - top2[1]))
            t = torch.tensor([[int(tok)]], dtype=torch.int32)
            logits, cache = api.decode_step(tp, tcfg, cache, t)
    return gaps


def _compare(models, jres, tres, prompts, temperature, seed=0):
    """Same streams, per-request stats and deterministic counters."""
    (jouts, js, jeng), (touts, ts, teng) = jres, tres
    for rid, want in jouts.items():
        if len(want):
            gap = min(_gaps(models, prompts[rid], want, rid, temperature,
                            seed))
            assert gap > TIE_GAP, f"near-tie in rid {rid} (gap {gap:.2e})"
    assert set(touts) == set(jouts)
    for rid in jouts:
        np.testing.assert_array_equal(touts[rid], jouts[rid], f"rid {rid}")
        jst = jeng.metrics.per_request[rid]
        tst = teng.metrics.per_request[rid]
        for k in STAT_KEYS:
            assert getattr(tst, k) == getattr(jst, k), (rid, k)
    assert set(ts) == set(js)
    for k in set(js) - WALL_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert teng.metrics.fault_events == jeng.metrics.fault_events


def _run(eng, reqs, hook=None):
    """Submit and drive to completion, calling ``hook(eng)`` after every
    step; (outputs, summary, engine)."""
    for r in reqs:
        eng.submit(r)
    while (eng.sched.active or eng.sched.ready or eng.sched.waiting
           or eng._prefill):
        eng.step()
        if hook is not None:
            hook(eng)
    outs, summary = eng.run()
    return outs, summary, eng


def _eos_mid_step(models, prompts, temperature):
    """An eos id that fires mid-macro-step: the first request's token at
    an index i >= 2 that no earlier token of its stream repeats, with
    i % 4 != 0, so with K = 4 it is not the last tick of its dispatch
    (a slot's dispatches cover its indices 1-4, 5-8, ...)."""
    _, teng = _engines(models, macro_ticks=1, temperature=temperature)
    outs = teng.run(_requests(tengine, prompts))[0]
    for rid, stream in outs.items():
        for idx in range(2, len(stream) - 1):
            tok = int(stream[idx])
            if idx % 4 and tok not in stream[:idx].tolist():
                return {rid: tok}, rid, idx
    pytest.fail(f"no usable eos token in {outs}")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("macro_ticks", [1, 4])
def test_trace_matches_jax(models, macro_ticks, temperature):
    prompts = _prompts()
    eos, rid, idx = _eos_mid_step(models, prompts, temperature)
    jeng, teng = _engines(models, macro_ticks=macro_ticks,
                          temperature=temperature)
    jres = _run(jeng, _requests(jengine, prompts, eos))
    tres = _run(teng, _requests(tengine, prompts, eos))
    _compare(models, jres, tres, prompts, temperature)
    outs, s, eng = tres
    assert eng.metrics.per_request[rid].finish_reason == "eos"
    assert len(outs[rid]) == idx + 1
    assert len({int(t) for o in outs.values() for t in o}) > 5
    assert s["host_syncs"] == s["decode_dispatches"]
    assert s["final_occupancy"] == 0 and s["final_queue_depth"] == 0


def test_host_sync_cadence_matches_jax(models):
    # The reference's cadence contract (tests/test_decode_hot_loop.py):
    # with K = 8 and enough decode work, at most one host sync per 8
    # generated tokens and one dispatch per pool tick group.
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, 256, n).astype(np.int32) for n in (5, 7, 4, 6)]
    jeng, teng = _engines(models, prefill_chunk=4, macro_ticks=8)
    fields = dict(max_new_tokens=16, arrival_time=[0.0, 1.0, 2.0, 3.0])
    jres = _run(jeng, _requests(jengine, prompts, **fields))
    tres = _run(teng, _requests(tengine, prompts, **fields))
    _compare(models, jres, tres, prompts, 0.0)
    s = tres[1]
    assert s["requests_completed"] == 4
    assert s["host_syncs"] == s["decode_dispatches"]
    assert s["host_syncs_per_token"] <= 1.0 / 8 + 1e-9
    assert s["tokens_per_dispatch"] >= 8.0
    assert s["dispatches_per_decode_tick"] <= 1.0


def test_reject_new_matches_jax(models):
    jeng, teng = _engines(models, max_queue=2)
    prompts = _prompts()
    errs = []
    for mod, eng in ((jengine, jeng), (tengine, teng)):
        reqs = _requests(mod, prompts, arrival_time=5.0)
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        with pytest.raises(mod.QueueFullError) as e:
            eng.submit(reqs[2])
        errs.append((e.value.queue_depth, e.value.max_queue,
                     isinstance(e.value, mod.AdmissionError), eng._next_rid))
    assert errs[0] == errs[1] == (2, 2, True, 2)


@pytest.mark.parametrize("case", ["shed_oldest", "queue_wait", "ttft"])
def test_overload_and_deadlines_match_jax(models, case):
    prompts = _prompts()
    if case == "shed_oldest":
        kw, fields = dict(max_queue=2, overload_policy="shed_oldest"), {}
    elif case == "queue_wait":
        kw = dict(num_slots=1, overload_policy="queue_wait",
                  queue_wait_ticks=6)
        fields = {"arrival_time": 0.0}
    else:
        kw, fields = dict(num_slots=1), {"ttft_deadline_ticks": 9.0}
    jeng, teng = _engines(models, macro_ticks=4, **kw)
    jres = _run(jeng, _requests(jengine, prompts, **fields))
    tres = _run(teng, _requests(tengine, prompts, **fields))
    _compare(models, jres, tres, prompts, 0.0)
    reasons = tres[1]["finish_reasons"]
    want = {"shed_oldest": "shed", "queue_wait": "shed",
            "ttft": "deadline"}[case]
    assert reasons.get(want, 0) >= 1, reasons


def test_cancel_mid_prefill_and_mid_decode_matches_jax(models):
    # rid 2 (33 tokens, 5 chunks) is cancelled after its first chunk;
    # rid 0 cancels itself from its stream callback at its third token,
    # the second tick of a 4-tick dispatch.
    prompts = _prompts()

    def run(mod, eng):
        def on_token(rid, tok):
            if len(eng._outputs[rid]) == 3:
                eng.cancel(rid)

        def hook(e):
            pf = e._prefill
            if pf is not None and pf.rid == 2 and pf.offset > 0:
                assert e.cancel(2) and not e.cancel(2)

        reqs = _requests(mod, prompts, on_token=[on_token] + [None] * 4)
        return _run(eng, reqs, hook)

    jeng, teng = _engines(models, macro_ticks=4, temperature=0.8)
    jres, tres = run(jengine, jeng), run(tengine, teng)
    _compare(models, jres, tres, prompts, 0.8)
    per = tres[2].metrics.per_request
    assert per[0].finish_reason == per[2].finish_reason == "cancelled"
    assert len(tres[0][0]) == 3 and len(tres[0][2]) == 0
    assert tres[1]["final_occupancy"] == 0


def test_injected_fault_is_quarantined_and_retried_like_jax(models):
    prompts = _prompts()
    inj = dict(seed=7, nan_every=7)
    jeng, teng = _engines(models, injector_kw=inj, macro_ticks=4,
                          temperature=0.8)
    jres = _run(jeng, _requests(jengine, prompts))
    tres = _run(teng, _requests(tengine, prompts))
    _compare(models, jres, tres, prompts, 0.8)
    outs, s, eng = tres
    # Three faults: one retry succeeds, one request faults again on its
    # retry and ends as "fault".
    assert s["faults_detected"] == 3 and s["fault_retries"] == 2
    assert s["fault_retries_succeeded"] == 1
    assert s["finish_reasons"] == {"length": 4, "fault": 1}
    lat = tfaults.detection_latencies(eng._injector.log,
                                      eng.metrics.fault_events)
    assert lat and max(lat) <= 4 * eng.serving.macro_ticks
    # A retried request ends as it would have without the fault.
    _, clean = _engines(models, macro_ticks=4, temperature=0.8)
    base = clean.run(_requests(tengine, prompts))[0]
    for rid, st in eng.metrics.per_request.items():
        if st.finish_reason in ("eos", "length"):
            np.testing.assert_array_equal(outs[rid], base[rid])


def test_unported_knobs_raise_when_the_engine_is_built(models):
    _, tcfg, _, tp, _ = models
    for kw in (dict(page_size=8), dict(prefix_cache_bytes=1 << 20),
               dict(checkpoint_every_ticks=4), dict(speculative=True),
               dict(slot_shards=2), dict(prefill_chunk=0)):
        with pytest.raises(NotImplementedError, match="Queue A item 11"):
            tengine.ContinuousServingEngine(
                tcfg, tp, serving=ServingConfig(**{**BASE, **kw}),
                device="cpu")
    for bad in (dict(num_slots=0), dict(temperature=-1.0),
                dict(overload_policy="drop")):
        with pytest.raises(ValueError):
            ServingConfig(**bad)
    fields = {f.name: f.default for f in dataclasses.fields(ServingConfig)}
    assert fields == {f.name: f.default
                      for f in dataclasses.fields(JServingConfig)}
