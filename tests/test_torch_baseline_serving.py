"""Serving the linear baselines (favor, cosformer, elu1) in the port
against the JAX package's engines, on the CPU, at the smoke config in
fp32 (the embedding divided by 8 so that streams vary).

Per kind, with one JAX engine of each kind shared across cases (a 1x1
mesh with Auto axes, ROADMAP C-4): the lockstep engine's greedy streams;
the continuous engine's sampled streams, per-request stats and counters
on a trace whose later requests hit the prefix cache (partially and by a
whole prompt), under one fake clock with a journal and checkpoints, the
journal byte for byte and the checkpoints of one format ((S, z) at m =
64, 32 and 16 here); a JAX-written crashed directory restored in the
port, and a port-written one in the JAX engine, to the uncrashed
streams. ``page_size`` is ignored for these constant-state kinds, as in
the reference, and the speculative engine refuses them as verifiers.
cosformer's cache features drop its position weights in the reference
(ROADMAP C-8), so its lockstep first token (a position-weighted prefill)
and its continuous one (chunked prefill, never weighted) come from
different logits; the port matches each engine.

A near-tie of ``logits / T + g`` (top-2 gap under 1e-5, teacher-forcing
the port alone along the JAX stream) fails as such (ROADMAP C-2).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServingConfig as JServingConfig
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.models import transformer as jtr
from repro.serving import checkpoint as jckpt
from repro.serving import engine as jengine
from repro.serving import journal as jjournal
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import checkpoint as ckpt_lib
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults
from repro_torch.serving import journal as journal_lib
from repro_torch.serving import sampling

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
KINDS = ["favor", "cosformer", "elu1"]
TIE_GAP = 1e-5
LOGIT_ATOL = 1e-4
CRASH = (10, 16)                 # lands on tick 12, after a checkpoint
# page_size is set and must be ignored: nothing of (S, z) pages.
SV = dict(num_slots=2, max_len=64, prefill_chunk=4, macro_ticks=4,
          temperature=0.7, checkpoint_every_ticks=6,
          prefix_cache_bytes=1 << 22, page_size=8, debug_audit=True)
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot",
             "retries", "prefix_cached", "prefix_tokens")


class _Clock:
    """A fake wall clock: each read advances it by a quarter second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _prompts():
    """Three prompts on a shared 4-token system prompt (one chunk), then
    the first again, arriving after it ends (a whole-prompt hit)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(3, 256, 4)
    ps = [np.concatenate([shared, rng.integers(3, 256, 5)]).astype(np.int32)
          for _ in range(3)]
    return ps + [ps[0]]


def _trace(mod):
    arrivals = (0.0, 1.0, 2.0, 40.0)
    return [mod.Request(p, max_new_tokens=12, arrival_time=a)
            for p, a in zip(_prompts(), arrivals)]


def _lockstep_prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 256, n).astype(np.int32) for n in (9, 23, 14)]


@pytest.fixture(scope="module", params=KINDS)
def jax_side(request, tmp_path_factory):
    """Per kind: both packages' models and the JAX engines' results: the
    lockstep streams, and the continuous trace uncrashed (streams,
    summary, per-request stats, prefix-cache stats, its directory) and
    its directory as a crash at tick 12 leaves it."""
    kind = request.param
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tcfg = get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    mesh = jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)
    out = dict(kind=kind, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, mesh=mesh)
    lock = jengine.ServingEngine(jcfg, jp, mesh, max_len=64)
    out["lockstep"] = lock.generate([jengine.Request(p, max_new_tokens=10)
                                     for p in _lockstep_prompts()])
    # One JAX run serves both directories: between two engine steps the
    # journal is flushed and the checkpoints whole, so a copy taken there
    # is what a crash at the next step leaves behind.
    whole = str(tmp_path_factory.mktemp(f"{kind}_whole"))
    crashed = str(tmp_path_factory.mktemp(f"{kind}_crashed"))
    jr = jjournal.Journal(os.path.join(whole, jjournal.JOURNAL_NAME))
    eng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=JServingConfig(**SV), journal=jr,
        clock=_Clock())
    eng.run(_trace(jengine), max_ticks=CRASH[0] + 2)
    assert eng.metrics.checkpoints_written >= 1 and eng.sched.active
    shutil.copytree(whole, crashed, dirs_exist_ok=True)
    outs, s = eng.run()
    out.update(streams=outs, summary=s, eng=eng, whole=whole,
               crashed=crashed)
    return out


def _port_engine(side, **kw):
    return tengine.ContinuousServingEngine(
        side["tcfg"], side["tp"], serving=ServingConfig(**SV), device="cpu",
        **kw)


def _same(outs, base):
    assert set(outs) == set(base)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid], f"rid {rid}")


def _gaps(side, prompt, stream, rid, temperature):
    """Top-2 gaps of logits / T + g along ``stream``: the port alone,
    teacher-forced through the continuous engine's programs (chunked
    prefill, then decode steps)."""
    tcfg, tp = side["tcfg"], side["tp"]
    C = SV["prefill_chunk"]
    gaps = []
    with torch.inference_mode():
        cache = api.init_cache(tcfg, 1, SV["max_len"], device="cpu")
        for o in range(0, len(prompt), C):
            chunk = torch.from_numpy(prompt[None, o:o + C])
            logits, cache = api.prefill_chunk(tcfg, tp, cache, chunk)
        for idx, tok in enumerate(stream):
            row = logits[0, -1].float()
            if temperature > 0:
                row = (sampling.scale_logits(row, temperature)
                       + sampling._gumbel_row(0, rid, idx, row.shape[-1],
                                              device="cpu"))
            top2 = torch.topk(row, 2).values
            gaps.append(float(top2[0] - top2[1]))
            t = torch.tensor([[int(tok)]], dtype=torch.int32)
            logits, cache = api.decode_step(tp, tcfg, cache, t)
    return gaps


def _check_lockstep(side):
    """One left-padded batch of three, greedy; the lockstep step launches
    the decode kernel's plain twin here (its kernel on the card)."""
    prompts = _lockstep_prompts()
    teng = tengine.ServingEngine(side["tcfg"], side["tp"], device="cpu",
                                 max_len=64)
    got = teng.generate([tengine.Request(p, max_new_tokens=10)
                         for p in prompts])
    want = side["lockstep"]
    lp = max(map(len, prompts))
    toks = np.zeros((3, lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, lp - len(p):] = p
    gaps = []
    with torch.inference_mode():
        logits, cache = api.prefill(side["tp"], side["tcfg"],
                                    torch.from_numpy(toks))
        for t in range(10):
            top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
            tok = torch.tensor([[int(s[t])] for s in want], dtype=torch.int32)
            logits, cache = api.decode_step(side["tp"], side["tcfg"], cache,
                                            tok)
    assert min(gaps) > TIE_GAP, f"near-tie (gap {min(gaps):.2e})"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len({int(t) for s in got for t in s}) > 3


def _check_continuous(side, d):
    """Streams, per-request stats, every deterministic counter, the prefix
    cache's stats, the journal byte for byte and the checkpoints' format
    (the port's journal and checkpoints written to ``d``)."""
    want, js, jeng = side["streams"], side["summary"], side["eng"]
    prompts = _prompts()
    for rid, stream in want.items():
        gap = min(_gaps(side, prompts[rid], stream, rid, SV["temperature"]))
        assert gap > TIE_GAP, f"near-tie in rid {rid} (gap {gap:.2e})"
    jr = journal_lib.Journal(os.path.join(d, journal_lib.JOURNAL_NAME))
    eng = _port_engine(side, journal=jr, clock=_Clock())
    outs, s = eng.run(_trace(tengine))
    _same(outs, want)
    for rid in want:
        jst, tst = jeng.metrics.per_request[rid], eng.metrics.per_request[rid]
        for k in STAT_KEYS:
            assert getattr(tst, k) == getattr(jst, k), (rid, k)
    assert set(s) == set(js)
    for k in set(js) - WALL_KEYS:
        assert s[k] == js[k], (k, s[k], js[k])
    assert s["prefix_hits"] == 3 and s["num_pages"] == 0
    assert eng.page_pool is None
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    name = journal_lib.JOURNAL_NAME
    with open(os.path.join(d, name), "rb") as f:
        mine = f.read()
    with open(os.path.join(side["whole"], name), "rb") as f:
        assert mine == f.read()
    a, b = ckpt_lib.latest_valid(d), jckpt.latest_valid(side["whole"])
    assert set(a) == set(b) and a["tick"] == b["tick"]
    assert a["page_pool"] is None and b["page_pool"] is None
    assert [(x.shape, x.dtype) for x in a["pool"]] == [
        (x.shape, x.dtype) for x in b["pool"]]
    m = {"favor": 64, "cosformer": 32, "elu1": 16}[side["kind"]]
    assert (2, 2, 4, m, 16) in [x.shape for x in a["pool"]]
    assert [(e["length"], e["tokens"].tolist()) for e in a["prefix"]] == [
        (e["length"], e["tokens"].tolist()) for e in b["prefix"]]


def _check_port_restores_jax_directory(side):
    eng = tengine.ContinuousServingEngine.restore(
        side["crashed"], side["tcfg"], side["tp"],
        serving=ServingConfig(**SV), device="cpu")
    assert eng.recovery["checkpoint_used"] and len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, side["streams"])
    assert s["tokens_replayed"] > 0


def _check_jax_restores_port_directory(side, d):
    jr = journal_lib.Journal(os.path.join(d, journal_lib.JOURNAL_NAME))
    eng = _port_engine(side, journal=jr, fault_injector=faults.FaultInjector(
        seed=3, crash_window=CRASH))
    with pytest.raises(faults.EngineCrash):
        eng.run(_trace(tengine))
    jeng = jengine.ContinuousServingEngine.restore(
        d, side["jcfg"], side["jp"], side["mesh"],
        serving=JServingConfig(**SV))
    rec = jeng.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    assert len(jeng.prefix_cache) > 0
    outs, s = jeng.run()
    _same(outs, side["streams"])
    assert s["tokens_replayed"] > 0


def _check_first_tokens(side):
    """The lockstep engine's first logits come from a whole-prompt
    prefill, the continuous engine's from chunked prefill; the port
    matches the JAX package on each. For favor and elu1 the two agree;
    cosformer's prefill weights by position and its chunks do not
    (ROADMAP C-8), so its two engines' first logits differ, on both sides
    alike."""
    tcfg, tp, jcfg, jp = side["tcfg"], side["tp"], side["jcfg"], side["jp"]
    prompt = _prompts()[0]
    C = SV["prefill_chunk"]
    jwhole, _ = jtr.prefill(jp, jcfg, jnp.asarray(prompt[None]))
    jc = japi.init_cache(jcfg, 1, SV["max_len"])
    with torch.inference_mode():
        twhole, _ = api.prefill(tp, tcfg, torch.from_numpy(prompt[None]))
        tc = api.init_cache(tcfg, 1, SV["max_len"], device="cpu")
        for o in range(0, len(prompt), C):
            chunk = prompt[None, o:o + C]
            tchunk, tc = api.prefill_chunk(tcfg, tp, tc,
                                           torch.from_numpy(chunk))
            jchunk, jc = japi.prefill_chunk(jcfg, jp, jc, jnp.asarray(chunk))
    np.testing.assert_allclose(twhole.numpy(), np.asarray(jwhole), rtol=0.0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(tchunk.numpy(), np.asarray(jchunk), rtol=0.0,
                               atol=LOGIT_ATOL)
    gap = float(np.abs(np.asarray(jwhole) - np.asarray(jchunk)).max())
    if side["kind"] == "cosformer":
        assert gap > 100 * LOGIT_ATOL, gap
    else:
        assert gap < LOGIT_ATOL, gap


def _check_no_speculative_verifier(side):
    with pytest.raises(ValueError, match="speculative"):
        tengine.ContinuousServingEngine(
            side["tcfg"], side["tp"], device="cpu",
            serving=dataclasses.replace(ServingConfig(**SV),
                                        prefix_cache_bytes=0,
                                        speculative=True))
    assert not api.supports_speculative(side["tcfg"])
    assert not api.supports_paging(side["tcfg"])


# Two tests per kind, each over one shared set of JAX engine runs.


def test_lockstep_engine_and_first_tokens_match_jax(jax_side):
    _check_lockstep(jax_side)
    _check_first_tokens(jax_side)
    _check_no_speculative_verifier(jax_side)


def test_continuous_engine_and_checkpoints_match_jax(jax_side, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "crashed").mkdir()
    _check_continuous(jax_side, str(tmp_path / "port"))
    _check_port_restores_jax_directory(jax_side)
    _check_jax_restores_port_directory(jax_side, str(tmp_path / "crashed"))
