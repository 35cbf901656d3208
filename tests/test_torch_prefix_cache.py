"""The port's prefix cache (``repro_torch.serving.prefix_cache``) against
the JAX package's, on the CPU.

Unit level: collision safety, chunk-multiple candidates, the full-hit
logits rule, LRU under the byte budget with refcount pins, snapshots that
share no storage, stats; and the same inserts and lookups on both
packages' caches, with real decode-state snapshots of the smoke model,
giving equal stats and byte counts. Engine level, at the smoke config in
fp32 (embedding divided by 8 so streams vary), in the JAX package's three
cache regimes (SLAY's constant state; softmax's KV ring, unpaged and
paged): cached streams equal cold ones, greedy and at T = 0.8, with
partial hits and full hits that run no prefill chunk; and the port's
engine against the JAX engine with the same budget on one trace
(streams, per-request stats and the deterministic summary counters),
where a near-tie of ``logits / T + g`` would be reported as such
(ROADMAP C-2).
"""
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
from repro.serving import prefix_cache as jprefix
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import sampling
from repro_torch.serving.prefix_cache import (PrefixCache, token_digest,
                                              tree_bytes)

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
TIE_GAP = 1e-5
BASE = dict(num_slots=2, max_len=64, prefill_chunk=8, macro_ticks=4,
            debug_audit=True)
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot",
             "retries", "prefix_cached", "prefix_tokens")


# ---------------------------------------------------------------------------
# Unit level
# ---------------------------------------------------------------------------


def _cache(n=100):
    return {"state": torch.zeros(n)}             # 4n bytes


def test_digest_collision_cannot_false_hit():
    pc = PrefixCache(1 << 20, digest_fn=lambda toks: b"collide")
    a, b = np.int32([1, 2, 3, 4]), np.int32([1, 2, 9, 9])
    pc.insert(a, _cache(), logits=torch.zeros(1, 1, 8))
    assert pc.lookup(b, chunk=4) is None and pc.misses == 1
    got = pc.lookup(a, chunk=4)
    assert got is not None and got.length == 4 and pc.hits == 1


def test_token_digest_is_length_and_content_addressed():
    assert token_digest(np.int32([1, 2])) != token_digest(np.int32([2, 1]))
    assert token_digest(np.int32([1, 2])) == token_digest(
        np.asarray([1, 2], np.int64))
    assert token_digest(np.int32([5, 6, 7])) == jprefix.token_digest(
        np.int32([5, 6, 7]))


def test_lookup_serves_only_chunk_multiples():
    pc = PrefixCache(1 << 20)
    toks = np.int32(range(10))
    pc.insert(toks[:5], _cache())                 # not a multiple of 4
    pc.insert(toks[:4], _cache())
    assert pc.lookup(toks, chunk=4).length == 4   # 8 absent, 5 skipped
    pc.insert(toks[:8], _cache())
    assert pc.lookup(toks, chunk=4).length == 8   # longest multiple wins


def test_full_hit_requires_stored_logits():
    pc = PrefixCache(1 << 20)
    toks = np.int32(range(8))
    pc.insert(toks, _cache())                     # full length, no logits
    pc.insert(toks[:4], _cache())
    assert pc.lookup(toks, chunk=4).length == 4   # full entry skipped
    e = pc.insert(toks, _cache(), logits=torch.ones(1, 1, 8))
    assert e.logits is not None and e.nbytes == 400 + 32   # upgraded
    got = pc.lookup(toks, chunk=4)
    assert got.length == 8 and got is e and len(pc) == 2


def test_lru_eviction_under_byte_budget():
    pc = PrefixCache(900)
    lg = torch.zeros(1, 1, 4)                     # 16 bytes
    t = np.int32(range(12))
    e1 = pc.insert(t[:4], _cache(100), logits=lg)     # 416 bytes
    pc.insert(t[:8], _cache(100), logits=lg)
    assert pc.lookup(t[:4], chunk=4) is e1        # refresh e1's stamp
    pc.insert(t[:12], _cache(100), logits=lg)     # evicts the LRU entry
    assert pc.evictions == 1 and len(pc) == 2
    got = pc.lookup(t[:8], chunk=4)
    assert got is e1 and got.length == 4          # the victim was t[:8]
    assert pc.nbytes <= 900


def test_referenced_entries_are_never_evicted():
    pc = PrefixCache(1000)
    t = np.int32(range(8))
    e1 = pc.insert(t[:4], _cache(100))
    e2 = pc.insert(t[:8], _cache(100), logits=torch.zeros(1, 1, 4))
    pc.acquire(e1)
    pc.acquire(e2)
    assert pc.insert(t[:6], _cache(100)) is None  # both pinned: no room
    assert len(pc) == 2 and pc.evictions == 0 and pc.live_refs() == 2
    pc.release(e1)
    assert pc.insert(t[:6], _cache(100)) is not None
    assert pc.lookup(t[:8], chunk=4) is e2        # the pinned entry stays


def test_insert_copy_shares_no_storage():
    # The decode kernel writes the pool in place: a snapshot must not
    # alias the buffers it was taken from, nor hand its own to a caller
    # that writes them.
    pc = PrefixCache(1 << 20)
    src = {"state": torch.ones(4)}
    lg = torch.ones(1, 1, 4)
    e = pc.insert(np.int32([1, 2, 3, 4]), src, logits=lg)
    src["state"].zero_()
    lg.zero_()
    np.testing.assert_array_equal(e.cache["state"].numpy(), np.ones(4))
    np.testing.assert_array_equal(e.logits.numpy(), np.ones((1, 1, 4)))
    assert e.cache["state"].data_ptr() != src["state"].data_ptr()


def test_stats_shape():
    pc = PrefixCache(1 << 20)
    pc.insert(np.int32([1, 2]), _cache(), logits=torch.zeros(1, 1, 4))
    pc.lookup(np.int32([1, 2]), chunk=2)
    pc.lookup(np.int32([7, 7]), chunk=2)
    s = pc.stats()
    assert s["hits"] == 1 and s["misses"] == 1 and s["hit_rate"] == 0.5
    assert s["entries"] == 1 and s["tokens_reused"] == 2
    assert s["bytes"] == pc.nbytes == 400 + 16
    assert pc.entries()[0].length == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_inserts_and_lookups_as_jax(dtype):
    # Real snapshots of the smoke model (its decode state and last-token
    # logits from one prefill chunk) on both sides: the same byte counts,
    # so the LRU evicts the same entries, and equal stats throughout.
    jcfg = jax_smoke_config(NAME, dtype=dtype)
    tcfg = get_smoke_config(NAME, dtype=dtype)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(tree, device="cpu")
    toks = np.arange(3, 3 + 8, dtype=np.int32)[None]
    jl, jc = japi.prefill_chunk(jcfg, jax.tree.map(jnp.asarray, tree),
                                japi.init_cache(jcfg, 1, 64),
                                jnp.asarray(toks))
    with torch.inference_mode():
        tl, tc = api.prefill_chunk(tcfg, tp, api.init_cache(tcfg, 1, 64,
                                                            device="cpu"),
                                   torch.from_numpy(toks))
    assert tl.dtype == getattr(torch, str(jl.dtype))
    entry = (sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jc))
             + jl.size * jl.dtype.itemsize)
    rng = np.random.default_rng(3)
    shared = rng.integers(3, 256, 16)
    prompts = [np.concatenate([shared, rng.integers(3, 256, n)])
               for n in (4, 9, 1, 12, 5)]
    caches = [(jprefix.PrefixCache(3 * entry), jc, jl),
              (PrefixCache(3 * entry), tc, tl)]
    trail = [[], []]
    for p in prompts + prompts[:2]:
        for side, (pc, cache, logits) in enumerate(caches):
            e = pc.lookup(p, chunk=8)
            if e is not None:
                pc.acquire(e)
            pc.insert(p[:16], cache)
            pc.insert(p, cache, logits=logits)
            if e is not None and len(p) % 2:
                pc.release(e)
            trail[side].append((pc.stats(), [(x.length, x.nbytes, x.refs)
                                             for x in pc.entries()]))
    assert trail[0] == trail[1]
    assert caches[1][0].evictions > 0 and caches[1][0].hits > 0


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


# regime -> (attention kind, ServingConfig keywords), as
# tests/test_prefix_cache.py parametrises the JAX cache.
REGIMES = {"constant_state": ("slay", {}),
           "kv_ring": ("softmax", {}),
           "kv_ring_paged": ("softmax", {"page_size": 8})}


@pytest.fixture(scope="module", params=sorted(REGIMES))
def models(request):
    kind, paging = REGIMES[request.param]
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tcfg = get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    mesh = make_host_mesh()
    # Auto axes: the JAX engine under jax 0.9.0 (ROADMAP C-4).
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    mesh = jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)
    return jcfg, tcfg, jp, tp, mesh, paging


def _prompts():
    """Four prompts on a shared 16-token system prompt (two chunks of 8),
    then repeats of the first and third, which arrive after those end."""
    rng = np.random.default_rng(17)
    shared = rng.integers(3, 256, 16)
    ps = [np.concatenate([shared, rng.integers(3, 256, n)]).astype(np.int32)
          for n in (5, 9, 3, 12)]
    return ps + [ps[0], ps[2]]


def _requests(mod, prompts):
    arrivals = [0.0, 2.0, 4.0, 6.0, 70.0, 72.0]
    return [mod.Request(p, max_new_tokens=8 + i % 3, arrival_time=a)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


def _budget(tcfg):
    """Room for 7 snapshots with logits: the 8 the trace stores evict
    once (the oldest chunk-boundary entry), and the repeats' full-prompt
    entries survive."""
    one = api.init_cache(tcfg, 1, 64, device="cpu")
    return 7 * (tree_bytes(one) + tcfg.vocab_size * 4)


def _port_run(models, prompts, **serving):
    _, tcfg, _, tp, _, paging = models
    eng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**{**BASE, **paging, **serving}),
        device="cpu")
    outs, s = eng.run(_requests(tengine, prompts))
    return outs, s, eng


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cached_streams_equal_cold_streams(models, temperature):
    prompts = _prompts()
    cold, sc, _ = _port_run(models, prompts, temperature=temperature)
    warm, sw, eng = _port_run(models, prompts, temperature=temperature,
                              prefix_cache_bytes=_budget(models[1]))
    assert set(warm) == set(cold)
    for rid in cold:
        np.testing.assert_array_equal(warm[rid], cold[rid], f"rid {rid}")
    per = eng.metrics.per_request
    # Requests 1-3 hit the system prompt (a partial hit), 4 and 5 their
    # whole prompt (a full hit), which runs no prefill chunk.
    assert [(per[r].prefix_cached, per[r].prefix_tokens) for r in per] == [
        (False, 0), (True, 16), (True, 16), (True, 16),
        (True, len(prompts[4])), (True, len(prompts[5]))]
    assert sc["prefix_hits"] == 0 and sw["prefix_hits"] == 5
    assert sw["prompt_tokens"] == sum(map(len, prompts[:4])) - 3 * 16
    assert sw["prefill_ticks"] < sc["prefill_ticks"]
    stats = eng.prefix_cache.stats()
    assert stats["evictions"] == 1 and stats["hits"] == 5
    assert eng.prefix_cache.live_refs() == 0
    assert sw["ttft_cached_ticks_p50"] < sc["ttft_cold_ticks_p50"]
    assert len({int(t) for o in warm.values() for t in o}) > 5


def test_shared_cache_warms_a_second_engine(models):
    # A cache passed in is shared: after one engine populated it, a second
    # engine admits every request of the same trace by a full hit.
    prompts = _prompts()
    cold, _, _ = _port_run(models, prompts)
    pc = PrefixCache(1 << 24)
    _, tcfg, _, tp, _, paging = models
    for n in range(2):
        eng = tengine.ContinuousServingEngine(
            tcfg, tp, serving=ServingConfig(**BASE, **paging), device="cpu",
            prefix_cache=pc)
        outs, s = eng.run(_requests(tengine, prompts))
        for rid in cold:
            np.testing.assert_array_equal(outs[rid], cold[rid])
    assert s["prefix_hits"] == len(prompts) and s["prompt_tokens"] == 0
    assert all(st.prefix_tokens == st.prompt_len
               for st in eng.metrics.per_request.values())


def _gaps(models, prompt, stream, rid, temperature, seed=0):
    """Top-2 gaps of logits / T + g along ``stream``, the port alone,
    teacher-forced from a whole-prompt prefill."""
    _, tcfg, _, tp, _, _ = models
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


def test_prefix_cached_engine_matches_jax(models):
    jcfg, tcfg, jp, _, mesh, paging = models
    prompts = _prompts()
    temperature = 0.8
    kw = {**BASE, **paging, "temperature": temperature,
          "prefix_cache_bytes": _budget(tcfg)}
    jeng = jengine.ContinuousServingEngine(jcfg, jp, mesh,
                                           serving=JServingConfig(**kw))
    jouts, js = jeng.run(_requests(jengine, prompts))
    touts, ts, teng = _port_run(models, prompts, **kw)
    for rid, want in jouts.items():
        gap = min(_gaps(models, prompts[rid], want, rid, temperature))
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
    assert ts["prefix_hits"] == 5
    assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()
    if paging:
        assert ts["final_pages_in_use"] == 0 and ts["pages_peak"] > 0
