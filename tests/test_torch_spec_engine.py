"""The port's speculative ``ContinuousServingEngine`` against the JAX
package's on the same trace, on the CPU.

The setup of the JAX package's ``tests/test_speculative.py``: the
yat_spherical smoke verifier (fp32, ``slay_anchors=16, slay_prf=32``)
and its SLAY draft, 2 slots, rings of 128 rows, chunks of 16, K = 4,
gamma = 2, its four requests. The parameters are the JAX tree after its
``ensure_draft_params`` (so both drafts are one), with the embedding
divided by 8 so that streams vary; the JAX engine runs on a 1x1 mesh
with Auto axes (ROADMAP C-4).

Per request the streams, finish reasons, admission and first-token
ticks and slots must be identical, and so must every deterministic
counter of ``summary()`` (``draft_tokens_proposed/accepted``,
``tokens_per_dispatch`` and the rest; wall-clock keys excluded), greedy,
at T = 0.8, paged and through a quarantined fault. Identity is owed only
where no near-tie decides (ROADMAP C-2): each comparison first replays
every request's rounds on the host (:func:`_replay`, the port's verifier
by decode steps and its draft, teacher-forced), which must give the
engine's stream and counters with every decision's margin above
``TIE_GAP``, else the test fails with "near-tie". The port alone: greedy
speculative streams equal plain exact decoding's, and K-, gamma- (greedy)
and placement invariance.
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
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import sampling, speculative
from repro_torch.tree import tree_map

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
KIND = dict(attn_kind="yat_spherical", slay_anchors=16, slay_prf=32,
            dtype="float32")
TIE_GAP = 1e-5
GAMMA = 2
BASE = dict(num_slots=2, max_len=128, prefill_chunk=16, macro_ticks=4,
            debug_audit=True, speculative=True, spec_gamma=GAMMA)
TRACE = ((12, 20), (5, 16), (30, 24), (9, 12))     # (prompt, max_new)
RUNS = {"greedy": {}, "sampled": dict(temperature=0.8, seed=3),
        "paged": dict(page_size=16),
        "quarantine": dict(temperature=0.8, seed=3)}
FAULTS = dict(nan_every=8, seed=5)
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot",
             "retries")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, **KIND)
    tcfg = get_smoke_config(NAME, **KIND)
    tree = japi.ensure_draft_params(
        japi.draft_config(jcfg), japi.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    tree = jax.device_get(tree)
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    mesh = jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)
    return jcfg, tcfg, jp, tp, mesh


def _trace(mod):
    rng = np.random.default_rng(7)
    return [mod.Request(rng.integers(1, 256, size=n).astype(np.int32),
                        max_new_tokens=m, eos_id=1) for n, m in TRACE]


def _port(models, injector=None, **kw):
    _, tcfg, _, tp, _ = models
    eng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**{**BASE, **kw}), device="cpu",
        fault_injector=tfaults.FaultInjector(**injector) if injector
        else None)
    outs, s = eng.run(_trace(tengine))
    return outs, s, eng


@pytest.fixture(scope="module")
def jax_runs(models):
    jcfg, _, jp, _, mesh = models
    out = {}
    for name, kw in RUNS.items():
        inj = (jfaults.FaultInjector(**FAULTS) if name == "quarantine"
               else None)
        eng = jengine.ContinuousServingEngine(
            jcfg, jp, mesh, serving=JServingConfig(**{**BASE, **kw}),
            fault_injector=inj)
        outs, s = eng.run(_trace(jengine))
        out[name] = (outs, s, eng)
    return out


def _gap(row: torch.Tensor) -> float:
    top2 = torch.topk(row[torch.isfinite(row)], 2).values
    return float(top2[0] - top2[1])


def _replay(models, req, rid, temperature, seed):
    """One request's speculative rounds replayed on the host: the port's
    verifier by decode steps (not ``verify_chunk``) and its draft,
    teacher-forced, the decisions by the port's functions. Returns the
    stream, the rounds, the accepted drafts and the smallest margin of a
    decision: a top-2 gap of every argmax (noise added at T > 0) and,
    at T > 0, |u q(d) - p(d)| / p(d) of every coin that counts."""
    _, tcfg, _, tp, _ = models
    dcfg = api.draft_config(tcfg)
    T, G = temperature, GAMMA
    r = torch.tensor([rid], dtype=torch.int32)
    margins: list = []

    def ix(i):
        return torch.tensor([i], dtype=torch.int32)

    def noisy(row, i, tag=None):
        if T <= 0:
            return row
        g = (sampling._gumbel_row(seed, r, ix(i), row.shape[-1])
             if tag is None else
             sampling.spec_gumbel_row(seed, r, ix(i), tag, row.shape[-1]))
        return sampling.scale_logits(row, T) + g

    def step(c, cfg, tok):
        lg, c = api.decode_step(tp, cfg, c, torch.tensor([[tok]],
                                                         dtype=torch.int32))
        return lg[:, -1].float()

    def done(stream):
        return stream[-1] == req.eos_id or len(stream) >= req.max_new_tokens

    kw = dict(temperature=T, seed=seed)
    with torch.inference_mode():
        prompt = torch.from_numpy(req.prompt[None])
        p, vc = api.prefill(tp, tcfg, prompt, max_len=BASE["max_len"])
        _, dc = api.prefill(tp, dcfg, prompt)
        margins.append(_gap(noisy(p[0, -1].float(), 0)))
        stream = [int(sampling.sample_tokens(p[:, -1], r, ix(0), **kw)[0])]
        rounds = accepted = 0
        while not done(stream):
            g0, last = len(stream), stream[-1]
            rounds += 1
            start = tree_map(torch.clone, dc)
            drafts, qs, tok = [], [], last
            for j in range(G):
                q = step(dc, dcfg, tok)
                margins.append(_gap(noisy(q[0], g0 + j,
                                          sampling.SPEC_TAG_DRAFT)))
                tok = int(speculative.draft_sample(q, r, ix(g0 + j), **kw)[0])
                drafts.append(tok)
                qs.append(q)
            pos0 = vc.pos.clone()
            ps = [step(vc, tcfg, t) for t in [last] + drafts]
            a = 0
            while a < G:
                ok, corr = speculative.accept_and_correct(
                    ps[a], qs[a], torch.tensor([drafts[a]]), r, ix(g0 + a),
                    **kw)
                if T > 0:
                    pp = torch.softmax(sampling.scale_logits(ps[a], T), -1)
                    qq = torch.softmax(sampling.scale_logits(qs[a], T), -1)
                    u = sampling.spec_uniform(seed, r, ix(g0 + a))
                    pd, qd = pp[0, drafts[a]], qq[0, drafts[a]]
                    margins.append(float(abs(u[0] * qd - pd) / pd))
                else:
                    margins.append(_gap(ps[a][0]))
                if not bool(ok[0]):
                    if T > 0:
                        res = torch.clamp(pp - qq, min=0.0)
                        logr = torch.where(res > 0, torch.log(res),
                                           float("-inf"))
                        margins.append(_gap(noisy(
                            logr[0], g0 + a, sampling.SPEC_TAG_RESAMPLE)))
                    break
                a += 1
            accepted += a
            if a < G:
                emit = drafts[:a] + [int(corr[0])]
            else:
                margins.append(_gap(noisy(ps[G][0], g0 + G)))
                emit = drafts + [int(sampling.sample_tokens(
                    ps[G], r, ix(g0 + G), **kw)[0])]
            m = 0
            for t in emit:
                stream.append(t)
                m += 1
                if done(stream):
                    break
            api.rollback_slots(tcfg, vc, pos0 + m)
            dc = start
            for t in [last] + emit[:m - 1]:
                step(dc, dcfg, t)
    return np.asarray(stream, np.int32), rounds, accepted, min(margins)


def _replayed(models, outs, temperature, seed):
    """Hold every stream of ``outs`` to its host replay; (rounds,
    accepted drafts) summed over the requests."""
    rounds = accepted = 0
    for rid, req in enumerate(_trace(tengine)):
        stream, n, a, margin = _replay(models, req, rid, temperature, seed)
        assert margin > TIE_GAP, f"near-tie in rid {rid} ({margin:.2e})"
        np.testing.assert_array_equal(outs[rid], stream, f"rid {rid}")
        rounds += n
        accepted += a
    return rounds, accepted


def _compare(jres, tres):
    (jouts, js, jeng), (touts, ts, teng) = jres, tres
    assert set(touts) == set(jouts)
    for rid in jouts:
        np.testing.assert_array_equal(touts[rid], jouts[rid], f"rid {rid}")
        for k in STAT_KEYS:
            assert (getattr(teng.metrics.per_request[rid], k)
                    == getattr(jeng.metrics.per_request[rid], k)), (rid, k)
    assert set(ts) == set(js)
    for k in set(js) - WALL_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert teng.metrics.fault_events == jeng.metrics.fault_events


@pytest.mark.parametrize("name", ["greedy", "sampled", "paged"])
def test_engine_matches_jax(models, jax_runs, name):
    kw = RUNS[name]
    tres = _port(models, **kw)
    outs, s, eng = tres
    rounds, accepted = _replayed(models, jax_runs[name][0],
                                 kw.get("temperature", 0.0), kw.get("seed", 0))
    _compare(jax_runs[name], tres)
    # The acceptance accounting is the replay's: gamma drafts offered per
    # round a live slot ran.
    assert s["speculative"] and s["spec_gamma"] == GAMMA
    assert s["draft_tokens_proposed"] == GAMMA * rounds
    assert s["draft_tokens_accepted"] == accepted
    assert 0.0 < s["draft_acceptance_rate"] < 1.0
    assert s["tokens_per_dispatch"] > BASE["macro_ticks"]
    assert s["host_syncs"] == s["decode_dispatches"]
    assert s["final_occupancy"] == 0 and s["final_pages_in_use"] == 0
    assert s["requests_completed"] == len(TRACE)
    if name == "paged":
        assert s["num_pages"] == 2 * 128 // 16 and s["pages_peak"] > 0
        eng.page_pool.check()
    if name == "sampled":
        greedy = jax_runs["greedy"][0]
        assert any(not np.array_equal(outs[r], greedy[r]) for r in outs)


def test_quarantine_retry_matches_jax(models, jax_runs):
    # NaN-corrupted verifier slots are caught by the round's fault lane,
    # quarantined before emission and retried to the fault-free streams,
    # with the JAX engine's fault events.
    tres = _port(models, injector=FAULTS, **RUNS["quarantine"])
    _compare(jax_runs["quarantine"], tres)
    outs, s, _ = tres
    assert s["faults_detected"] >= 1
    assert s["fault_retries_succeeded"] == s["faults_detected"]
    clean = jax_runs["sampled"][0]
    for rid in clean:
        np.testing.assert_array_equal(outs[rid], clean[rid], f"rid {rid}")


def test_greedy_spec_equals_plain_exact_decoding(models, jax_runs):
    # Every emitted token is the verifier's argmax, so the plain engine's
    # greedy streams come out, with fewer dispatches.
    spec, s_spec, _ = _port(models)
    plain, s_plain, _ = _port(models, speculative=False)
    for rid in plain:
        np.testing.assert_array_equal(spec[rid], plain[rid], f"rid {rid}")
    assert s_spec["tokens_per_dispatch"] > s_plain["tokens_per_dispatch"]
    assert not s_plain["speculative"] and s_plain["spec_gamma"] == 0
    assert s_plain["draft_tokens_proposed"] == 0


@pytest.mark.parametrize("kw", [
    dict(macro_ticks=1), dict(spec_gamma=3), dict(num_slots=4),
    dict(macro_ticks=2, temperature=0.8, seed=3),
    dict(num_slots=4, temperature=0.8, seed=3)])
def test_port_invariance(models, jax_runs, kw):
    # K- and placement invariance, greedy and sampled; gamma invariance
    # greedy (at T > 0 gamma moves the bonus draws).
    base = jax_runs["sampled" if kw.get("temperature") else "greedy"][0]
    outs, s, _ = _port(models, **kw)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid], f"rid {rid}")
    assert s["requests_completed"] == len(TRACE)


def test_config_validation(models):
    _, tcfg, _, tp, _ = models
    with pytest.raises(ValueError, match="spec_gamma"):
        ServingConfig(**{**BASE, "spec_gamma": 0})
    with pytest.raises(ValueError, match="mutually"):
        ServingConfig(**BASE, prefix_cache_bytes=1 << 20)
    slay = dataclasses.replace(tcfg, attn_kind="slay")
    with pytest.raises(ValueError, match="speculative"):
        tengine.ContinuousServingEngine(slay, tp,
                                        serving=ServingConfig(**BASE),
                                        device="cpu")
    # A request must fit its ring with gamma rows of verify overshoot.
    eng = tengine.ContinuousServingEngine(tcfg, tp,
                                          serving=ServingConfig(**BASE),
                                          device="cpu")
    ok = tengine.Request(np.ones(100, np.int32), max_new_tokens=26)
    eng.submit(ok)
    with pytest.raises(tengine.RequestTooLargeError, match="verify"):
        eng.submit(tengine.Request(np.ones(100, np.int32),
                                   max_new_tokens=27))
