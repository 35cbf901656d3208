"""The SSM families mamba2-780m and hymba-1.5b served by the port against
the JAX package, on the CPU, at their smoke configs in fp32: prefill and
decode, chunked prefill, the masked step and the slot operations on the
SSD carry and conv tail, the lockstep and continuous engines, and
mamba2's prefix cache and checkpoints across both packages
(``tests/test_torch_ssm.py`` holds the configs, the SSD block, the
forward pass and training).

Weights come from the JAX init and cross through numpy
(``repro_torch.convert``). Tolerances, as ``tests/test_torch_ssm.py``:
logits to 5e-5 of their largest magnitude, every decode state leaf (the
SSD carry and conv tail, (S, z), ring rows) to 5e-5 of its largest
magnitude. The engines run beside the JAX engines (1x1 mesh with Auto
axes, ROADMAP C-4): streams and counters identical where no near-tie
decides a token (C-2; the tests check the gaps). The reference's
whole-prompt ``prefill`` raises for prompts shorter than the conv's 3
rows of tail (ROADMAP C-11); the port's agrees with the reference's
``prefill_chunk`` from a zero cache there.
"""
import os

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
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import journal as jjournal
from repro_torch import configs, convert
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import journal as tjournal
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

MAMBA = "mamba2-780m"
HYMBA = "hymba-1.5b"
ARCHS = (MAMBA, HYMBA)
LOGIT_REL = 5e-5
STATE_REL = 5e-5
TIE_GAP = 1e-5


def _close(got, want, rel=LOGIT_REL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0.0,
                               atol=rel * (np.abs(want).max() or 1.0),
                               err_msg=err_msg)


def _auto_mesh():
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    return jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)


def _pair(name, scale=1.0, **overrides):
    """(jcfg, tcfg, JAX params, port params) at the smoke config in fp32,
    the embedding divided by ``scale``."""
    jcfg = jax_smoke_config(name, dtype="float32", **overrides)
    tcfg = configs.get_smoke_config(name, dtype="float32", **overrides)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / scale
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


# -- prefill, decode and the slot surface ------------------------------------


def _state_close(tc, jc):
    assert (tc.attn is None) == (jc.attn is None)
    if tc.attn is not None:
        for name in ("s", "z", "k", "v"):
            got, want = getattr(tc.attn, name), getattr(jc.attn, name)
            assert (got is None) == (want is None), name
            if want is not None:
                _close(got, want, STATE_REL, name)
        np.testing.assert_array_equal(tc.attn.pos.numpy(),
                                      np.asarray(jc.attn.pos))
    _close(tc.ssm.h, jc.ssm.h, STATE_REL, "ssm.h")
    _close(tc.ssm.conv, jc.ssm.conv, STATE_REL, "ssm.conv")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("plen", [1, 2, 28])
def test_prefill_then_8_decode_steps_match(models, plen):
    # Under 3 tokens (ROADMAP C-11) the reference's whole-prompt prefill
    # raises; the port's prefill agrees with its prefill_chunk from a
    # zero cache instead.
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(plen).integers(
        0, 256, (2, plen)).astype(np.int32)
    if plen < jcfg.ssm_conv_width - 1:
        with pytest.raises(TypeError, match="slice_sizes"):
            jtr.prefill(jp, jcfg, jnp.asarray(toks), max_len=64)
        jl, jc = jtr.prefill_chunk(jp, jcfg, jtr.init_cache(jcfg, 2, 64),
                                   jnp.asarray(toks))
    else:
        jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks), max_len=64)
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks), max_len=64)
        _close(tl, jl)
        _state_close(tc, jc)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        for _ in range(8):
            jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok))
            tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
            _close(tl, jl)
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
    _state_close(tc, jc)


def test_hybrid_softmax_rings_beside_the_carry():
    # hymba under an exact kind: unpaged rings beside the SSD state.
    jcfg, tcfg, jp, tp = _pair(HYMBA, attn_kind="softmax")
    toks = np.random.default_rng(8).integers(0, 256, (2, 21)).astype(np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks[:, :20]), max_len=32)
    jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, 20:]))
    with torch.inference_mode():
        _, tc = api.prefill(tp, tcfg, torch.from_numpy(toks[:, :20]),
                            max_len=32)
        assert tc.attn.k.shape[2] == 32 and tc.attn.s is None
        tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, 20:]))
    _close(tl, jl)
    _state_close(tc, jc)


@pytest.mark.parametrize("chunk", [16, 7])
def test_prefill_chunk_rows_match(models, chunk):
    # A 50-token prompt chunk by chunk into a fresh cache (a ragged last
    # chunk; the scan tile clamped to the chunk): every chunk's
    # last-token logits and the final state.
    jcfg, tcfg, jp, tp = models
    prompt = np.random.default_rng(3).integers(0, 256, 50).astype(np.int32)
    jc = jtr.init_cache(jcfg, 1, 64)
    with torch.inference_mode():
        tc = api.init_cache(tcfg, 1, 64, device="cpu")
        for o in range(0, 50, chunk):
            piece = prompt[None, o:o + chunk]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(piece))
            jl, jc = jtr.prefill_chunk(jp, jcfg, jc, jnp.asarray(piece))
            _close(tl, jl)
    _state_close(tc, jc)
    np.testing.assert_array_equal(tc.pos.numpy(), [50])


def _two_slot_pools(jcfg, tcfg, jp, tp, lens=(9, 14)):
    rng = np.random.default_rng(4)
    jpool = japi.init_cache(jcfg, 3, 32)
    tpool = api.init_cache(tcfg, 3, 32, device="cpu")
    with torch.inference_mode():
        for slot, n in enumerate(lens):
            toks = rng.integers(3, 256, (1, n)).astype(np.int32)
            _, one = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                  max_len=32)
            jpool = japi.write_slot(jcfg, jpool, one, jnp.int32(slot))
            _, tone = api.prefill(tp, tcfg, torch.from_numpy(toks),
                                  max_len=32)
            tpool = api.write_slot(tcfg, tpool, tone, slot)
    return jpool, tpool


def test_masked_decode_keeps_drained_slots(models):
    # Slots 0 and 1 prefilled, slot 2 empty; a masked step with slot 1
    # drained: live rows' logits and state as the JAX step's, the drained
    # slot's every state leaf bit-identical, every leaf written in place.
    jcfg, tcfg, jp, tp = models
    jpool, tpool = _two_slot_pools(jcfg, tcfg, jp, tp)
    before = [t.clone() for t in tree_leaves(tpool)]
    ptrs = [t.data_ptr() for t in tree_leaves(tpool)]
    toks = np.array([[5], [6], [7]], np.int32)
    act = np.array([True, False, True])
    jl, jnew = japi.decode_step(jp, jcfg, jpool, jnp.asarray(toks),
                                jnp.asarray(act))
    with torch.inference_mode():
        tl, tnew = api.decode_step(tp, tcfg, tpool, torch.from_numpy(toks),
                                   torch.from_numpy(act))
    assert tnew is tpool
    assert [t.data_ptr() for t in tree_leaves(tpool)] == ptrs
    _close(tl.numpy()[act], np.asarray(jl)[act])
    _state_close(tpool, jnew)
    for (path, t), b in zip(tree_items(tpool), before):
        if path != "pos" and not path.endswith("/pos"):
            assert torch.equal(t[:, 1], b[:, 1]), path


def test_slot_ops_match_jax(models):
    jcfg, tcfg, jp, tp = models
    jpool, tpool = _two_slot_pools(jcfg, tcfg, jp, tp)
    _state_close(tpool, jpool)
    np.testing.assert_array_equal(
        api.slot_state_finite(tcfg, tpool).numpy(),
        np.asarray(japi.slot_state_finite(jcfg, jpool)))
    jpool = japi.corrupt_slot(jcfg, jpool, 1)
    api.corrupt_slot(tcfg, tpool, 1)
    assert torch.isnan(tpool.ssm.h[:, 1]).all()
    assert torch.isnan(tpool.ssm.conv[:, 1]).all()
    np.testing.assert_array_equal(
        api.slot_state_finite(tcfg, tpool).numpy(), [True, False, True])
    np.testing.assert_array_equal(
        np.asarray(japi.slot_state_finite(jcfg, jpool)), [True, False, True])
    jpool = japi.reset_slot(jcfg, jpool, 1)
    out = api.reset_slot(tcfg, tpool, 1)
    assert out is tpool
    _state_close(tpool, jpool)
    assert bool(api.slot_state_finite(tcfg, tpool).all())
    assert not tpool.ssm.h[:, 1].any() and int(tpool.pos[1]) == 0


# -- the engines ---------------------------------------------------------------

WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot")


def _min_gap(tcfg, tp, prompt, stream, chunk, max_len=64):
    """The least top-2 logit gap along ``stream``, the port alone,
    teacher-forced: the prompt absorbed in the engine's chunks, then
    decode steps."""
    gaps = []
    with torch.inference_mode():
        cache = api.init_cache(tcfg, 1, max_len, device="cpu")
        for o in range(0, len(prompt), chunk):
            logits, cache = api.prefill_chunk(
                tcfg, tp, cache, torch.from_numpy(prompt[None, o:o + chunk]))
        for tok in stream:
            top2 = torch.topk(logits[0, -1], 2).values
            gaps.append(float(top2[0] - top2[1]))
            logits, cache = api.decode_step(
                tp, tcfg, cache, torch.tensor([[int(tok)]],
                                              dtype=torch.int32))
    return min(gaps)


def _same(outs, base):
    assert set(outs) == set(base)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid], f"rid {rid}")


@pytest.mark.parametrize("name", ARCHS)
def test_lockstep_engine_matches_jax(name):
    # Left-padded prompts (pad 0 visible, as in the JAX engine), greedy.
    jcfg, tcfg, jp, tp = _pair(name, scale=8.0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 256, n).astype(np.int32) for n in (17, 9)]
    jeng = jengine.ServingEngine(jcfg, jp, _auto_mesh(), max_len=64)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=64)
    jouts = jeng.generate([jengine.Request(p, max_new_tokens=10)
                           for p in prompts])
    touts = teng.generate([tengine.Request(p, max_new_tokens=10)
                           for p in prompts])
    for a, b in zip(touts, jouts):
        np.testing.assert_array_equal(a, b)
    assert len({int(t) for o in touts for t in o}) > 3


CONT = dict(num_slots=2, max_len=64, prefill_chunk=8, macro_ticks=4,
            debug_audit=True)
# 70 tokens > max_len: the SSD state is constant-size, so mamba2 admits
# it; hymba under SLAY too.
CONT_PROMPTS = (20, 7, 70, 12)


def _requests(mod, lens, max_new=10):
    rng = np.random.default_rng(6)
    return [mod.Request(rng.integers(3, 256, n).astype(np.int32),
                        max_new_tokens=max_new, arrival_time=2.0 * i)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("name", ARCHS)
def test_continuous_trace_matches_jax(name):
    jcfg, tcfg, jp, tp = _pair(name, scale=8.0)
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, _auto_mesh(), serving=JServingConfig(**CONT))
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**CONT), device="cpu")
    jouts, js = jeng.run(_requests(jengine, CONT_PROMPTS))
    touts, ts = teng.run(_requests(tengine, CONT_PROMPTS))
    for rid, req in enumerate(_requests(tengine, CONT_PROMPTS)):
        gap = _min_gap(tcfg, tp, req.prompt, jouts[rid],
                       CONT["prefill_chunk"])
        assert gap > TIE_GAP, f"near-tie in rid {rid} ({gap:.2e})"
    _same(touts, jouts)
    for rid in jouts:
        for k in STAT_KEYS:
            assert (getattr(teng.metrics.per_request[rid], k)
                    == getattr(jeng.metrics.per_request[rid], k)), (rid, k)
    assert set(ts) == set(js)
    for k in set(js) - WALL_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert ts["requests_completed"] == len(CONT_PROMPTS)
    assert len({int(t) for o in touts.values() for t in o}) > 5


@pytest.mark.parametrize("name", ARCHS)
def test_engine_refuses_speculative_and_ignores_pages(name):
    jcfg, tcfg, jp, tp = _pair(name)
    with pytest.raises(ValueError, match=f"family='{tcfg.family}'"):
        tengine.ContinuousServingEngine(
            tcfg, tp, device="cpu",
            serving=ServingConfig(**CONT, speculative=True))
    eng = tengine.ContinuousServingEngine(
        tcfg, tp, device="cpu", serving=ServingConfig(**CONT, page_size=8))
    assert eng.page_pool is None and eng.pool.pages is None


# -- mamba2's prefix cache and checkpoints across both packages --------------

CRASH = (10, 16)
RESTORE = dict(num_slots=2, max_len=16, prefill_chunk=4, macro_ticks=4,
               checkpoint_every_ticks=6, prefix_cache_bytes=1 << 22,
               debug_audit=True)


def _restore_trace(mod):
    """Three prompts sharing a 4-token system prompt (one chunk, so the
    prefix cache hits) and a repeat of the first (a whole-prompt hit)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(3, 256, 4)
    ps = [np.concatenate([shared, rng.integers(3, 256, 5)]).astype(np.int32)
          for _ in range(3)]
    return [mod.Request(p, max_new_tokens=12, arrival_time=float(i))
            for i, p in enumerate(ps + ps[:1])]


@pytest.fixture(scope="module")
def mamba_dirs(tmp_path_factory):
    jcfg, tcfg, jp, tp = _pair(MAMBA, scale=8.0)
    mesh = _auto_mesh()
    sv = JServingConfig(**RESTORE)
    whole = jengine.ContinuousServingEngine(jcfg, jp, mesh, serving=sv)
    streams, stats = whole.run(_restore_trace(jengine))
    d = str(tmp_path_factory.mktemp("jax_crashed"))
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=sv,
        journal=jjournal.Journal(os.path.join(d, jjournal.JOURNAL_NAME)),
        fault_injector=jfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(jfaults.EngineCrash):
        jeng.run(_restore_trace(jengine))
    return jcfg, tcfg, jp, tp, mesh, streams, stats, whole, d


def test_mamba2_prefix_cache_matches_jax(mamba_dirs):
    # The cached run's streams, hits and the cache's stats (bytes
    # included: every snapshot is the SSD carry and tail) as the JAX
    # engine's, and equal to a cold run.
    jcfg, tcfg, jp, tp, mesh, streams, js, whole, _ = mamba_dirs
    for rid, req in enumerate(_restore_trace(tengine)):
        gap = _min_gap(tcfg, tp, req.prompt, streams[rid],
                       RESTORE["prefill_chunk"], RESTORE["max_len"])
        assert gap > TIE_GAP, f"near-tie in rid {rid} ({gap:.2e})"
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu")
    outs, ts = teng.run(_restore_trace(tengine))
    _same(outs, streams)
    assert ts["prefix_hits"] == js["prefix_hits"] >= 3
    assert teng.prefix_cache.stats() == whole.prefix_cache.stats()
    cold = tengine.ContinuousServingEngine(
        tcfg, tp, device="cpu",
        serving=ServingConfig(**dict(RESTORE, prefix_cache_bytes=0)))
    _same(cold.run(_restore_trace(tengine))[0], streams)


def test_mamba2_port_restores_a_jax_written_directory(mamba_dirs):
    jcfg, tcfg, jp, tp, mesh, streams, _, _, d = mamba_dirs
    eng = tengine.ContinuousServingEngine.restore(
        d, tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu")
    assert eng.recovery["checkpoint_used"] and len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, streams)
    assert s["tokens_replayed"] > 0


def test_mamba2_jax_restores_a_port_written_directory(mamba_dirs, tmp_path):
    jcfg, tcfg, jp, tp, mesh, streams, _, _, _ = mamba_dirs
    d = str(tmp_path)
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu",
        journal=tjournal.Journal(os.path.join(d, tjournal.JOURNAL_NAME)),
        fault_injector=tfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(tfaults.EngineCrash):
        teng.run(_restore_trace(tengine))
    eng = jengine.ContinuousServingEngine.restore(
        d, jcfg, jp, mesh, serving=JServingConfig(**RESTORE))
    rec = eng.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    assert len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, streams)
    assert s["tokens_replayed"] > 0
