"""The engines' frontend paths and whole-prompt prefill in the port
against the JAX engines, on the CPU, at smoke configs in fp32: the
bucketed masked prefill (``prefill_chunk=0``) on slayformer under
yat_spherical; internvl2-76b's vision patch prefix absorbed chunk by
chunk (SLAY, where an over-budget prompt is admitted) or refused at
``submit`` (softmax, a bounded ring); whisper-small's whole-prompt
prefill through the continuous engine under SLAY and softmax, its
crash and restore, and a JAX-written whisper directory restored in the
port; the lockstep engines of both configs.

Weights come from the JAX init (the embedding divided by 8, so that
greedy streams vary) and cross through numpy; the JAX engines run on a
1x1 mesh with Auto axes (ROADMAP C-4). Streams and counters
(``prefill_ticks``, ``bucket_hits``, ``bucket_misses`` and the rest of
the summary but wall times) must be identical where no near-tie decides
a token (C-2; the tests check the top-2 gaps along the JAX streams).
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
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import journal as jjournal
from repro_torch import configs, convert
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import journal as tjournal

torch.set_num_threads(1)    # small ops; the suite runs one process per core

VISION, WHISPER = "internvl2-76b", "whisper-small"
TIE_GAP = 1e-5
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot")


def _auto_mesh():
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    return jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)


def _pair(name, **overrides):
    jcfg = jax_smoke_config(name, dtype="float32", **overrides)
    tcfg = configs.get_smoke_config(name, dtype="float32", **overrides)
    tree = jax.device_get(japi.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / 8.0
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


def _requests(mod, lens, max_new=6, seed=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(3, 256, n).astype(np.int32),
                        max_new_tokens=max_new, arrival_time=float(i))
            for i, n in enumerate(lens)]


def _stand_ins(cfg):
    if cfg.frontend == "vision":
        return {"patch_embeds": torch.zeros(1, cfg.num_patches, cfg.d_model)}
    if cfg.frontend == "audio":
        return {"frame_embeds": torch.zeros(1, cfg.enc_seq, cfg.d_model)}
    return {}


def _min_gap(tcfg, tp, prompt, stream):
    """The least top-2 logit gap along ``stream``, the port alone,
    teacher-forced behind the zero frontend stand-ins."""
    gaps = []
    with torch.inference_mode():
        logits, cache = api.prefill(tp, tcfg, torch.from_numpy(prompt[None]),
                                    max_len=64, **_stand_ins(tcfg))
        for tok in stream:
            top2 = torch.topk(logits[0, -1], 2).values
            gaps.append(float(top2[0] - top2[1]))
            logits, cache = api.decode_step(
                tp, tcfg, cache, torch.tensor([[int(tok)]],
                                              dtype=torch.int32))
    return min(gaps)


def _no_ties(tcfg, tp, reqs, streams):
    for rid, req in enumerate(reqs):
        gap = _min_gap(tcfg, tp, req.prompt, streams[rid])
        assert gap > TIE_GAP, f"near-tie in rid {rid} ({gap:.2e})"


def _same(outs, base):
    assert set(outs) == set(base)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid], f"rid {rid}")


def _both(name, lens, serving, max_new=6, **overrides):
    """One trace through the JAX and the port's continuous engines:
    (tcfg, tp, (JAX outs, summary, engine), (port outs, summary,
    engine))."""
    jcfg, tcfg, jp, tp = _pair(name, **overrides)
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, _auto_mesh(), serving=JServingConfig(**serving))
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**serving), device="cpu")
    jres = (*jeng.run(_requests(jengine, lens, max_new)), jeng)
    tres = (*teng.run(_requests(tengine, lens, max_new)), teng)
    return tcfg, tp, jres, tres


def _engines_agree(jres, tres):
    (jouts, js, jeng), (touts, ts, teng) = jres, tres
    _same(touts, jouts)
    for rid in jouts:
        for k in STAT_KEYS:
            assert (getattr(teng.metrics.per_request[rid], k)
                    == getattr(jeng.metrics.per_request[rid], k)), (rid, k)
    assert set(ts) == set(js)
    for k in set(js) - WALL_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])


# -- the bucketed whole-prompt prefill on a decoder ----------------------------

BUCKET = dict(num_slots=2, max_len=64, macro_ticks=4, debug_audit=True)
BUCKET_PROMPTS = (5, 9, 3, 12, 20)


def test_bucketed_prefill_matches_jax_and_the_chunked_run():
    # prefill_chunk=0 routes every prompt through the pow-2 bucketed
    # masked prefill (buckets 16 and 32: 2 misses, 3 hits), one tick a
    # prompt; the streams equal the chunked run's and the JAX engine's.
    tcfg, tp, jres, tres = _both("slayformer-124m", BUCKET_PROMPTS,
                                 dict(BUCKET, prefill_chunk=0),
                                 attn_kind="yat_spherical")
    _no_ties(tcfg, tp, _requests(tengine, BUCKET_PROMPTS), jres[0])
    _engines_agree(jres, tres)
    ts = tres[1]
    assert (ts["bucket_misses"], ts["bucket_hits"]) == (2, 3)
    assert ts["prefill_ticks"] == len(BUCKET_PROMPTS)
    chunked = tengine.ContinuousServingEngine(
        tcfg, tp, device="cpu", serving=ServingConfig(**BUCKET,
                                                      prefill_chunk=4))
    outs, s = chunked.run(_requests(tengine, BUCKET_PROMPTS))
    _same(outs, tres[0])
    assert s["bucket_misses"] == 0 and s["prefill_ticks"] > 10


def test_unbucketed_whole_prompt_prefill_matches_jax():
    # prefill_buckets=False: each prompt prefilled at its own length.
    tcfg, tp, jres, tres = _both(
        "slayformer-124m", BUCKET_PROMPTS[:3],
        dict(BUCKET, prefill_chunk=0, prefill_buckets=False))
    _engines_agree(jres, tres)
    assert tres[1]["bucket_misses"] == 0 == tres[1]["bucket_hits"]


def test_speculative_bucketed_prefill_matches_jax():
    # A speculative engine with prefill_chunk=0 prefills the verifier and
    # its SLAY draft whole, each bucketed and masked: the setup of
    # tests/test_torch_spec_engine.py (the JAX tree after its
    # ensure_draft_params, so both drafts are one), greedy. Streams and
    # counters as the JAX engine's, and equal to plain exact decoding's.
    kind = dict(attn_kind="yat_spherical", slay_anchors=16, slay_prf=32,
                dtype="float32")
    jcfg = jax_smoke_config("slayformer-124m", **kind)
    tcfg = configs.get_smoke_config("slayformer-124m", **kind)
    tree = jax.device_get(japi.ensure_draft_params(
        japi.draft_config(jcfg), japi.init_params(jcfg,
                                                  jax.random.PRNGKey(0))))
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    sv = dict(num_slots=2, max_len=128, prefill_chunk=0, macro_ticks=4,
              debug_audit=True, speculative=True, spec_gamma=2)
    lens = (12, 5, 30, 9)
    jeng = jengine.ContinuousServingEngine(jcfg, jp, _auto_mesh(),
                                           serving=JServingConfig(**sv))
    teng = tengine.ContinuousServingEngine(tcfg, tp, device="cpu",
                                           serving=ServingConfig(**sv))
    jres = (*jeng.run(_requests(jengine, lens, 12)), jeng)
    tres = (*teng.run(_requests(tengine, lens, 12)), teng)
    _no_ties(tcfg, tp, _requests(tengine, lens, 12), jres[0])
    _engines_agree(jres, tres)
    assert tres[1]["bucket_misses"] == 2 and tres[1]["bucket_hits"] == 2
    plain = tengine.ContinuousServingEngine(
        tcfg, tp, device="cpu", serving=ServingConfig(**dict(
            sv, speculative=False)))
    _same(plain.run(_requests(tengine, lens, 12))[0], tres[0])


# -- internvl2's vision prefix -----------------------------------------------

VIS = dict(num_slots=1, max_len=32, prefill_chunk=4, debug_audit=True)


def test_over_budget_vision_prompt_is_absorbed_chunk_by_chunk():
    # Under SLAY (unbounded capacity) a prompt 1 row over max_len with its
    # prefix is admitted: the 8-row prefix in 2 chunks of 4 zero rows,
    # then the prompt's 6 chunks, then decode, as the JAX engine does; the
    # stream is the lockstep reference's with room to spare.
    n = 32 - 4 - 8 + 1
    reqs = [dict(prompt=np.ones(n, np.int32), max_new_tokens=4)]
    jcfg, tcfg, jp, tp = _pair(VISION)
    jeng = jengine.ContinuousServingEngine(jcfg, jp, _auto_mesh(),
                                           serving=JServingConfig(**VIS))
    teng = tengine.ContinuousServingEngine(tcfg, tp, device="cpu",
                                           serving=ServingConfig(**VIS))
    jres = (*jeng.run([jengine.Request(**r) for r in reqs]), jeng)
    tres = (*teng.run([tengine.Request(**r) for r in reqs]), teng)
    _no_ties(tcfg, tp, [tengine.Request(**r) for r in reqs], jres[0])
    _engines_agree(jres, tres)
    assert tres[1]["prefill_ticks"] == 2 + 6
    want = jengine.ServingEngine(jcfg, jp, _auto_mesh(), max_len=64).generate(
        [jengine.Request(**r) for r in reqs])[0]
    np.testing.assert_array_equal(tres[0][0], want)
    lock = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=64)
    np.testing.assert_array_equal(
        lock.generate([tengine.Request(**r) for r in reqs])[0], want)
    # A whole-prompt prefill cannot exceed the ring: with prefill_chunk=0
    # the same request is refused, naming the prefix rows.
    eng0 = tengine.ContinuousServingEngine(
        tcfg, tp, device="cpu", serving=ServingConfig(**dict(
            VIS, prefill_chunk=0)))
    with pytest.raises(ValueError, match="8 vision-prefix patches"):
        eng0.submit(tengine.Request(**reqs[0]))


def test_vision_prompt_over_a_softmax_ring_is_refused_at_submit():
    jcfg, tcfg, jp, tp = _pair(VISION, attn_kind="softmax")
    teng = tengine.ContinuousServingEngine(tcfg, tp, device="cpu",
                                           serving=ServingConfig(**VIS))
    over = np.ones(32 - 4 - 8 + 1, np.int32)
    with pytest.raises(ValueError, match="vision-prefix"):
        teng.submit(tengine.Request(over, max_new_tokens=4))
    jeng = jengine.ContinuousServingEngine(jcfg, jp, _auto_mesh(),
                                           serving=JServingConfig(**VIS))
    with pytest.raises(ValueError, match="vision-prefix"):
        jeng.submit(jengine.Request(over, max_new_tokens=4))
    # At the budget it admits and serves, as the JAX engine does; and
    # bucketed (prefill_chunk=0), where the bucket's cap leaves the
    # prefix its rows.
    fit = dict(prompt=np.arange(3, 3 + 32 - 4 - 8, dtype=np.int32),
               max_new_tokens=4)
    for sv in (VIS, dict(VIS, prefill_chunk=0)):
        jeng = jengine.ContinuousServingEngine(
            jcfg, jp, _auto_mesh(), serving=JServingConfig(**sv))
        teng = tengine.ContinuousServingEngine(
            tcfg, tp, device="cpu", serving=ServingConfig(**sv))
        jres = (*jeng.run([jengine.Request(**fit)]), jeng)
        tres = (*teng.run([tengine.Request(**fit)]), teng)
        _engines_agree(jres, tres)
        assert tres[1]["requests_completed"] == 1


def test_vision_pool_serves_a_trace_with_the_prefix_cache():
    # Four requests, the last two repeating the first two, on a 2-slot
    # pool with a prefix cache: every snapshot holds the prefix, a hit
    # seeds behind it; streams, hits and the cache's stats as the JAX
    # engine's.
    sv = dict(num_slots=2, max_len=64, prefill_chunk=4, macro_ticks=4,
              prefix_cache_bytes=1 << 22, debug_audit=True)
    jcfg, tcfg, jp, tp = _pair(VISION)
    rng = np.random.default_rng(6)
    ps = [rng.integers(3, 256, n).astype(np.int32) for n in (6, 9)]

    def reqs(mod):
        return [mod.Request(ps[i % 2], max_new_tokens=5,
                            arrival_time=float(i)) for i in range(4)]

    jeng = jengine.ContinuousServingEngine(jcfg, jp, _auto_mesh(),
                                           serving=JServingConfig(**sv))
    teng = tengine.ContinuousServingEngine(tcfg, tp, device="cpu",
                                           serving=ServingConfig(**sv))
    jres = (*jeng.run(reqs(jengine)), jeng)
    tres = (*teng.run(reqs(tengine)), teng)
    _no_ties(tcfg, tp, reqs(tengine), jres[0])
    _engines_agree(jres, tres)
    assert tres[1]["prefix_hits"] == jres[1]["prefix_hits"] >= 2
    assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()


def test_vision_and_whisper_refuse_speculative_serving():
    for name in (VISION, WHISPER):
        jcfg, tcfg, jp, tp = _pair(name, attn_kind="yat_spherical")
        with pytest.raises(ValueError, match="speculative"):
            tengine.ContinuousServingEngine(
                tcfg, tp, device="cpu", serving=ServingConfig(
                    **VIS, speculative=True))


# -- whisper's whole-prompt prefill ------------------------------------------

WSV = dict(num_slots=2, max_len=32, prefill_chunk=4, macro_ticks=4,
           prefix_cache_bytes=1 << 22, debug_audit=True)
W_PROMPTS = (5, 9, 3, 7)


@pytest.mark.parametrize("kind", ["slay", "softmax"])
def test_whisper_continuous_trace_matches_jax(kind):
    # Not chunkable: one whole-prompt prefill tick a request behind zero
    # frames, no prefix cache (a budget is given and dropped), no bucket.
    tcfg, tp, jres, tres = _both(WHISPER, W_PROMPTS, WSV, attn_kind=kind)
    _no_ties(tcfg, tp, _requests(tengine, W_PROMPTS), jres[0])
    _engines_agree(jres, tres)
    ts, teng = tres[1], tres[2]
    assert teng.prefix_cache is None and ts["prefix_hits"] == 0
    assert ts["bucket_misses"] == 0 == ts["bucket_hits"]
    assert ts["prefill_ticks"] == len(W_PROMPTS)
    assert ts["requests_completed"] == len(W_PROMPTS)
    assert len({int(t) for o in tres[0].values() for t in o}) > 4


@pytest.mark.parametrize("name", [VISION, WHISPER])
def test_lockstep_engine_matches_jax(name):
    # Left-padded prompts behind the zero stand-ins, greedy.
    jcfg, tcfg, jp, tp = _pair(name)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 256, n).astype(np.int32) for n in (9, 5)]
    jouts = jengine.ServingEngine(jcfg, jp, _auto_mesh(), max_len=48
                                  ).generate([jengine.Request(
                                      p, max_new_tokens=8) for p in prompts])
    touts = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=48
                                  ).generate([tengine.Request(
                                      p, max_new_tokens=8) for p in prompts])
    for a, b in zip(touts, jouts):
        np.testing.assert_array_equal(a, b)
    assert len({int(t) for o in touts for t in o}) >= 3


CRASH = (10, 14)
RESTORE = dict(num_slots=2, max_len=32, prefill_chunk=4, macro_ticks=4,
               checkpoint_every_ticks=6, debug_audit=True)
R_PROMPTS = (6, 9, 4, 8)


@pytest.fixture(scope="module")
def whisper_dirs(tmp_path_factory):
    """whisper under SLAY: the uncrashed JAX run's streams, and the
    directory of a JAX run crashed after its first checkpoint."""
    jcfg, tcfg, jp, tp = _pair(WHISPER)
    mesh = _auto_mesh()
    sv = JServingConfig(**RESTORE)
    whole = jengine.ContinuousServingEngine(jcfg, jp, mesh, serving=sv)
    streams, _ = whole.run(_requests(jengine, R_PROMPTS, 10))
    d = str(tmp_path_factory.mktemp("jax_whisper_crashed"))
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=sv,
        journal=jjournal.Journal(os.path.join(d, jjournal.JOURNAL_NAME)),
        fault_injector=jfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(jfaults.EngineCrash):
        jeng.run(_requests(jengine, R_PROMPTS, 10))
    return tcfg, tp, streams, d


def test_whisper_crash_and_restore_streams_the_uncrashed_run(whisper_dirs,
                                                             tmp_path):
    tcfg, tp, streams, _ = whisper_dirs
    d = str(tmp_path)
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu",
        journal=tjournal.Journal(os.path.join(d, tjournal.JOURNAL_NAME)),
        fault_injector=tfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(tfaults.EngineCrash):
        teng.run(_requests(tengine, R_PROMPTS, 10))
    eng = tengine.ContinuousServingEngine.restore(
        d, tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu")
    rec = eng.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    outs, s = eng.run()
    _same(outs, streams)
    assert s["tokens_replayed"] > 0


def test_whisper_port_restores_a_jax_written_directory(whisper_dirs):
    tcfg, tp, streams, d = whisper_dirs
    eng = tengine.ContinuousServingEngine.restore(
        d, tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu")
    assert eng.recovery["checkpoint_used"]
    assert eng.recovery["resident_resumed"] >= 1
    outs, s = eng.run()
    _same(outs, streams)
    assert s["tokens_replayed"] > 0
