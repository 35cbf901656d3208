"""Paged slot memory in the port (``repro_torch.serving.pages``) against
the JAX package's (``repro.serving.pages``), on the CPU.

The host allocator ``PagePool``: the cases of ``tests/test_pages.py``.
The device ops (gather, scatter, whole-page install, zero, NaN and the
per-slot finiteness probe) against the JAX functions on the same numpy
leaves and tables, bit for bit. The engine: the port's continuous engine
on the softmax smoke config in fp32 (embedding divided by 8 so streams
vary) against the JAX engine on the same trace, unpaged, paged and paged
with half the pages (admission waits for pages): equal streams,
per-request stats and deterministic counters (page gauges included), the
paged streams equal to the unpaged ones, no page left allocated; and a
NaN quarantined on a paged slot, retried to the same streams. Identity
of a stream is owed only where no near-tie decides a token (ROADMAP C-2),
which each engine test checks first.
"""
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
from repro.serving import pages as jpages
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import pages

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
TIE_GAP = 1e-5
PROMPT_LENS = (20, 7, 33, 12, 26)
BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, macro_ticks=4,
            debug_audit=True)
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot",
             "retries")


# ---------------------------------------------------------------------------
# PagePool (host allocator): the cases of tests/test_pages.py
# ---------------------------------------------------------------------------


def _alloc_free_roundtrip(rng):
    pool = pages.PagePool(num_slots=4, num_pages=16, page_size=8,
                          pages_per_slot=4)
    assert pool.pages_for(1) == 1 and pool.pages_for(8) == 1
    assert pool.pages_for(9) == 2 and pool.pages_for(64) == 4  # capped
    got = pool.alloc(2, need_rows=17)            # ceil(17/8) = 3 pages
    assert len(got) == 3 and pool.pages_in_use() == 3
    assert pool.slot_pages(2) == got and pool.pages_peak == 3
    pool.check()
    assert pool.free_slot(2) == 3
    assert pool.pages_in_use() == 0 and pool.slot_pages(2) == []
    assert pool.pages_peak == 3                  # high-water survives free
    pool.check()


def _alloc_errors(rng):
    pool = pages.PagePool(num_slots=2, num_pages=4, page_size=8,
                          pages_per_slot=4)
    pool.alloc(0, need_rows=24)                  # 3 of 4 pages
    with pytest.raises(RuntimeError, match="already holds pages"):
        pool.alloc(0, need_rows=8)
    assert not pool.can_alloc(1, need_rows=16)   # 2 needed, 1 free
    with pytest.raises(RuntimeError, match="free pages"):
        pool.alloc(1, need_rows=16)
    assert pool.can_alloc(1, need_rows=8)
    pool.alloc(1, need_rows=8)
    pool.check()


def _geometry_validation(rng):
    with pytest.raises(ValueError, match="page_size"):
        pages.PagePool(2, 4, 0, 2)
    with pytest.raises(ValueError, match="num_pages"):
        pages.PagePool(4, 6, 8, 2, shards=4)
    with pytest.raises(ValueError, match="num_slots"):
        pages.PagePool(6, 8, 8, 2, shards=4)


def _shard_block_confinement(rng):
    pool = pages.PagePool(num_slots=4, num_pages=8, page_size=4,
                          pages_per_slot=2, shards=2)
    for slot in range(4):
        got = pool.alloc(slot, need_rows=8)
        d = pool.shard_of(slot)
        assert all(d * 4 <= p < (d + 1) * 4 for p in got), (slot, got)
    pool.check()
    pool.free_slot(2)
    assert pool.free_in_shard(1) == 2 and pool.free_in_shard(0) == 0
    assert not pool.can_alloc(1, need_rows=4)    # slot 1 lives in shard 0
    assert pool.can_alloc(2, need_rows=4)        # shard 1 has room
    pool.check()


def _churn(shards):
    def case(rng):
        pool = pages.PagePool(num_slots=8, num_pages=32, page_size=4,
                              pages_per_slot=4, shards=shards)
        held: set[int] = set()
        peak = 0
        for _ in range(300):
            slot = int(rng.integers(8))
            if slot in held:
                pool.free_slot(slot)
                held.discard(slot)
            else:
                need = int(rng.integers(1, 17))
                if pool.can_alloc(slot, need):
                    assert len(pool.alloc(slot, need)) == pool.pages_for(need)
                    held.add(slot)
            peak = max(peak, pool.pages_in_use())
            assert pool.pages_in_use() == sum(
                len(pool.slot_pages(s)) for s in held)
            pool.check()
        for slot in sorted(held):
            pool.free_slot(slot)
        assert pool.pages_in_use() == 0 and pool.pages_peak == peak
        pool.check()
    return case


def _snapshot_roundtrip(rng):
    pool = pages.PagePool(num_slots=4, num_pages=8, page_size=4,
                          pages_per_slot=2)
    pool.alloc(1, 7)
    pool.alloc(3, 3)
    again = pages.PagePool(4, 8, 4, 2)
    again.load_snapshot(pool.snapshot())
    assert again.snapshot().keys() == pool.snapshot().keys()
    np.testing.assert_array_equal(again.table, pool.table)
    assert again.free == pool.free and again.pages_peak == 3
    with pytest.raises(ValueError, match="page_size"):
        pages.PagePool(4, 8, 8, 2).load_snapshot(pool.snapshot())
    # The same snapshot as the JAX allocator's after the same operations.
    jpool = jpages.PagePool(num_slots=4, num_pages=8, page_size=4,
                            pages_per_slot=2)
    jpool.alloc(1, 7)
    jpool.alloc(3, 3)
    for key, want in jpool.snapshot().items():
        np.testing.assert_array_equal(np.asarray(pool.snapshot()[key],
                                                 dtype=object),
                                      np.asarray(want, dtype=object), key)


POOL_CASES = {
    "alloc_free_roundtrip": _alloc_free_roundtrip,
    "alloc_errors": _alloc_errors,
    "geometry_validation": _geometry_validation,
    "shard_block_confinement": _shard_block_confinement,
    "churn_one_shard": _churn(1),
    "churn_two_shards": _churn(2),
    "snapshot_roundtrip": _snapshot_roundtrip,
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_page_pool(case, rng):
    POOL_CASES[case](rng)


# ---------------------------------------------------------------------------
# Device ops against the JAX functions
# ---------------------------------------------------------------------------


def _churned(rng, shards, mod=pages):
    pool = mod.PagePool(num_slots=4, num_pages=8, page_size=4,
                        pages_per_slot=2, shards=shards)
    for slot, need in zip((0, 1, 3), rng.integers(1, 9, 3)):
        pool.alloc(slot, need_rows=int(need))    # slot 2 left unmapped
    pool.free_slot(1)                            # a freed slot too
    return pool


def _states(rng, shards):
    seed = int(rng.integers(1 << 30))
    tpool = _churned(np.random.default_rng(seed), shards)
    jpool = _churned(np.random.default_rng(seed), shards, jpages)
    np.testing.assert_array_equal(tpool.table, jpool.table)
    return tpool.device_vectors(), jpool.device_vectors()


@pytest.mark.parametrize("shards", [1, 2])
def test_gather_and_scatter_match_jax(rng, shards):
    ts, js = _states(rng, shards)
    leaf = rng.standard_normal((8, 4, 3)).astype(np.float32)
    dense = rng.standard_normal((4, 8, 3)).astype(np.float32)
    got = pages.gather_ring(torch.from_numpy(leaf), ts)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpages.gather_ring(jnp.asarray(leaf), js)))
    t_leaf = torch.from_numpy(leaf.copy())
    out = pages.scatter_ring_(t_leaf, torch.from_numpy(dense), ts)
    assert out.data_ptr() == t_leaf.data_ptr()   # in place
    want = jpages.scatter_ring(jnp.asarray(leaf), jnp.asarray(dense), js)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_slot_page_ops_match_jax(rng):
    ts, js = _states(rng, 1)
    leaf = rng.standard_normal((2, 8, 4, 3)).astype(np.float32)
    src = rng.standard_normal((2, 1, 8, 3)).astype(np.float32)
    got = pages.write_slot_pages(torch.from_numpy(leaf.copy()),
                                 torch.from_numpy(src), 0, ts)
    want = jpages.write_slot_pages(jnp.asarray(leaf), jnp.asarray(src),
                                   jnp.int32(0), js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = pages.corrupt_slot_pages(torch.from_numpy(leaf.copy()), 3, ts)
    jbad = jpages.corrupt_slot_pages(jnp.asarray(leaf), jnp.int32(3), js)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    ok = pages.pages_finite([bad], ts, num_slots=4)
    assert ok.tolist() == np.asarray(
        jpages.pages_finite([jbad], js, num_slots=4)).tolist()
    assert ok.tolist() == [True, True, True, False]
    clean = pages.write_zero_pages(bad, 3, ts)
    np.testing.assert_array_equal(
        clean.numpy(), np.asarray(jpages.write_zero_pages(jbad, jnp.int32(3),
                                                          js)))
    assert bool(torch.isfinite(clean).all())


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind="softmax")
    tcfg = get_smoke_config(NAME, dtype="float32", attn_kind="softmax")
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


def _requests(mod, prompts, max_new=10):
    return [mod.Request(p, max_new_tokens=max_new, arrival_time=2.0 * i)
            for i, p in enumerate(prompts)]


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


def _min_gap(models, prompts, outs):
    """Smallest greedy top-2 logit gap along the streams, the port alone,
    teacher-forced from a whole-prompt prefill."""
    _, tcfg, _, tp, _ = models
    gaps = []
    with torch.inference_mode():
        for rid, stream in outs.items():
            logits, cache = api.prefill(tp, tcfg,
                                        torch.from_numpy(prompts[rid][None]))
            for tok in stream:
                top2 = torch.topk(logits[0, -1], 2).values
                gaps.append(float(top2[0] - top2[1]))
                t = torch.tensor([[int(tok)]], dtype=torch.int32)
                logits, cache = api.decode_step(tp, tcfg, cache, t)
    return min(gaps)


def _compare(jres, tres):
    (jouts, js), (touts, ts) = jres, tres
    jeng, teng = js.pop("_eng"), ts.pop("_eng")
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


def _run(eng, reqs):
    outs, summary = eng.run(reqs)
    summary["_eng"] = eng
    return outs, summary


REGIMES = {"unpaged": {}, "paged": dict(page_size=8),
           "overcommitted": dict(page_size=8, num_pages=8)}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_engine_matches_jax(models, regime):
    prompts = _prompts()
    jeng, teng = _engines(models, **REGIMES[regime])
    jres = _run(jeng, _requests(jengine, prompts))
    tres = _run(teng, _requests(tengine, prompts))
    assert _min_gap(models, prompts, jres[0]) > TIE_GAP, "near-tie"
    _compare(jres, tres)
    outs, s = tres
    assert s["requests_completed"] == len(prompts)
    assert s["final_pages_in_use"] == 0 and s["final_occupancy"] == 0
    if regime == "unpaged":
        assert s["num_pages"] == 0 and teng.page_pool is None
        return
    teng.page_pool.check()
    assert s["num_pages"] == REGIMES[regime].get("num_pages", 2 * 64 // 8)
    assert 1 <= s["pages_peak"] <= s["num_pages"]
    # Paged streams are the unpaged streams.
    _, plain = _engines(models)
    base = plain.run(_requests(tengine, prompts))[0]
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid])


def test_short_requests_reserve_fewer_pages(models):
    _, teng = _engines(models, page_size=8)
    _, s = teng.run([tengine.Request(np.int32([5, 6, 7]), max_new_tokens=4)])
    assert s["pages_peak"] == 1                  # 3 + 4 rows: 1 of 16 pages
    assert s["final_pages_in_use"] == 0


def test_paged_quarantine_matches_jax(models):
    # NaNs injected into live paged slots: detected, the slot's pages
    # zeroed and freed, the request retried to its fault-free stream.
    prompts = _prompts()
    inj = dict(seed=2, nan_every=5)
    jeng, teng = _engines(models, injector_kw=inj, page_size=8,
                          fault_retries=3)
    jres = _run(jeng, _requests(jengine, prompts))
    tres = _run(teng, _requests(tengine, prompts))
    _compare(jres, tres)
    outs, s = tres
    assert s["faults_detected"] >= 1 and s["final_pages_in_use"] == 0
    teng.page_pool.check()
    assert not teng.pool.attn.k.isnan().any()    # freed pages were zeroed
    _, clean = _engines(models, page_size=8)
    base = clean.run(_requests(tengine, prompts))[0]
    for rid, st in teng.metrics.per_request.items():
        if st.finish_reason in ("eos", "length"):
            np.testing.assert_array_equal(outs[rid], base[rid])


def test_request_too_large_for_the_ring(models):
    _, teng = _engines(models, page_size=8)
    with pytest.raises(tengine.RequestTooLargeError, match="capacity 64"):
        teng.submit(tengine.Request(np.ones(60, np.int32),
                                    max_new_tokens=5))
    teng.submit(tengine.Request(np.ones(60, np.int32), max_new_tokens=4))
