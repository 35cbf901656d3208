"""The serving engines' static-buffer programs (``repro_torch.serving.
graphs``) on the CPU, where they run eagerly: the programs the card
captures as CUDA graphs and replays.

A graph binds device addresses, so the slot pool must stay one set of
tensors for the engine's life (through dispatches, admissions,
evictions, a quarantine, a prefix hit and a restore), the prefill's
static cache must never be shared with a prefix-cache snapshot or the
pool, and everything that varies per call (the control vectors, the
lockstep sampling key) must come from a static device buffer. The card
side (graphed against eager, launch counts, the graph count) is in
``tests/test_torch_card.py``. No JAX here: the engines' streams are held
to the JAX engines in ``tests/test_torch_continuous.py``,
``test_torch_sampling.py`` and ``test_torch_restore.py``. Each engine
test runs on SLAY's (S, z) pool and on softmax's KV ring, unpaged and
paged (whose page tables are pool tensors too).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults
from repro_torch.serving import graphs
from repro_torch.serving import journal as journal_lib
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"


# regime -> (attention kind, ServingConfig keywords)
REGIMES = {"slay": ("slay", {}), "softmax": ("softmax", {}),
           "softmax_paged": ("softmax", {"page_size": 8})}


@pytest.fixture(scope="module", params=sorted(REGIMES))
def model(request):
    kind, paging = REGIMES[request.param]
    cfg = get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    params = api.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0     # logits flat enough to vary
    return cfg, params, paging


def _serving(paging, **kw):
    return ServingConfig(**{"num_slots": 2, "max_len": 64,
                            "prefill_chunk": 4, "macro_ticks": 4,
                            "temperature": 0.8, **paging, **kw})


def _trace(n=4, max_new=8):
    """``n`` prompts on a shared 4-token system prompt (one chunk), then a
    repeat of the first, arriving late enough to find its whole-prompt
    prefix-cache entry."""
    rng = np.random.default_rng(5)
    shared = rng.integers(3, 256, 4)
    prompts = [np.concatenate([shared, rng.integers(3, 256, k)])
               .astype(np.int32) for k in (3, 6, 2, 9)[:n]]
    reqs = [tengine.Request(p, max_new_tokens=max_new,
                            arrival_time=2.0 * i)
            for i, p in enumerate(prompts)]
    return reqs + [tengine.Request(prompts[0], max_new_tokens=max_new,
                                   arrival_time=40.0)]


@dataclasses.dataclass
class _OneFault(faults.FaultInjector):
    """NaN-corrupts the lowest live slot once, at the first engine step at
    or after tick ``at``."""

    at: int = 0

    def corrupt_slots(self, tick, live_slots):
        if self.log or tick < self.at or not live_slots:
            return []
        self.log.append({"kind": "nan", "tick": tick})
        return [min(live_slots)]


def _ptrs(cache) -> list[int]:
    """Data pointers of every pool leaf (SLAY: attn.pos, attn.s, attn.z,
    pos; a ring: attn.k, attn.v, attn.pos, pos [, the page tables])."""
    return [t.data_ptr() for t in tree_leaves(cache)]


def _fill_pool(eng, n=2):
    """Admit ``n`` requests and step until they are all decoding."""
    rng = np.random.default_rng(9)
    for _ in range(n):
        eng.submit(tengine.Request(rng.integers(3, 256, 6).astype(np.int32),
                                   max_new_tokens=30))
    while len(eng.sched.active) < n:
        eng.step()
    eng.step()                                  # one dispatch: mid-stream


def test_program_runs_eagerly_on_the_cpu():
    calls = []
    prog = graphs.Program(lambda: calls.append(1) or len(calls),
                          torch.device("cpu"))
    assert [prog(), prog(), prog()] == [1, 2, 3]
    assert not prog.graphed and not prog.captured and prog.out is None


def test_pool_tensors_are_never_replaced(model, tmp_path, monkeypatch):
    # Every pool leaf keeps its storage through dispatches, admissions,
    # evictions, a quarantine, a prefix hit and a restore: a captured
    # graph binds these addresses.
    cfg, params, paging = model
    sv = _serving(paging, prefix_cache_bytes=1 << 22,
                  checkpoint_every_ticks=6, debug_audit=True)
    seen: list = []
    step = tengine.ContinuousServingEngine.step

    def checked_step(self):
        out = step(self)
        seen.append(_ptrs(self.pool))
        return out

    monkeypatch.setattr(tengine.ContinuousServingEngine, "step",
                        checked_step)
    jr = journal_lib.Journal(os.path.join(tmp_path, journal_lib.JOURNAL_NAME))
    eng = tengine.ContinuousServingEngine(
        cfg, params, serving=sv, device="cpu", journal=jr,
        fault_injector=_OneFault(seed=3, at=12, crash_window=(30, 30)))
    first = _ptrs(eng.pool)
    with pytest.raises(faults.EngineCrash):
        eng.run(_trace())
    m = eng.metrics
    assert (m.decode_dispatches > 2 and m.faults_detected >= 1
            and m.prefix_hits >= 1 and m.requests_terminated >= 1
            and m.checkpoints_written >= 1)
    assert seen and all(p == first for p in seen)

    restored = []
    apply = tengine.ContinuousServingEngine._apply_restore

    def checked_apply(self, *a, **kw):
        before = _ptrs(self.pool)
        apply(self, *a, **kw)
        restored.append((before, _ptrs(self.pool)))

    monkeypatch.setattr(tengine.ContinuousServingEngine, "_apply_restore",
                        checked_apply)
    seen.clear()
    eng2 = tengine.ContinuousServingEngine.restore(str(tmp_path), cfg, params,
                                                   serving=sv, device="cpu")
    assert eng2.recovery["checkpoint_used"]
    (before, after), = restored
    assert before == after
    outs, s = eng2.run()
    assert s["prefix_hits"] >= 1 and s["final_occupancy"] == 0
    assert seen and all(p == before for p in seen)


def test_all_inactive_dispatch_leaves_the_pool_bytes_identical(model):
    # Drained slots are an exact passthrough, positions included now
    # that they advance in place by ``active``.
    cfg, params, paging = model
    eng = tengine.ContinuousServingEngine(cfg, params,
                                          serving=_serving(paging),
                                          device="cpu")
    with torch.inference_mode():
        _fill_pool(eng)
        before = [t.clone() for t in tree_leaves(eng.pool)]
        assert before[0].any() and before[3].any()
        eng._active[:] = False
        eng._decode_macro()
    for got, want in zip(tree_leaves(eng.pool), before):
        assert torch.equal(got, want)


class _FreshControl:
    """The decode dispatch as the port ran it before its static buffers:
    ``_macro_decode`` on control tensors built anew from the host
    mirrors."""

    def __init__(self, eng):
        self.eng = eng
        self.captured = False

    def __call__(self):
        e, sv = self.eng, self.eng.serving
        c = [torch.from_numpy(x.astype(np.int32)) for x in (
            e._last_tok, e._active, e._rids, e._gen, e._eos, e._maxn)]
        return tengine._macro_decode(
            e.params, e.pool, c[0], c[1].bool(), *c[2:], cfg=e.cfg,
            num_ticks=sv.macro_ticks, temperature=sv.temperature,
            seed=sv.seed, fault_guard=sv.fault_guard)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_static_program_streams_equal_fresh_control(model, temperature):
    cfg, params, paging = model
    runs = []
    for fresh in (False, True):
        eng = tengine.ContinuousServingEngine(
            cfg, params, serving=_serving(paging, temperature=temperature),
            device="cpu")
        if fresh:
            eng._decode = _FreshControl(eng)
        runs.append(eng.run(_trace()))
    (got, s), (want, s_want) = runs
    assert s["decode_dispatches"] > 4
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], f"rid {rid}")
    if temperature > 0:
        greedy = tengine.ContinuousServingEngine(
            cfg, params, serving=_serving(paging, temperature=0.0),
            device="cpu").run(_trace())[0]
        assert any(not np.array_equal(got[r], greedy[r]) for r in got)


def _storages(tensors) -> set[int]:
    return {t.untyped_storage().data_ptr() for t in tensors}


def test_prefill_buffer_never_aliases_a_snapshot_or_the_pool(model):
    cfg, params, paging = model
    eng = tengine.ContinuousServingEngine(
        cfg, params, serving=_serving(paging, prefix_cache_bytes=1 << 22),
        device="cpu")
    static = _storages(tree_leaves(eng._pf_cache) + [eng._pf_tokens])
    pool = _storages(tree_leaves(eng.pool))
    inserted = []
    insert = eng.prefix_cache.insert

    def checked_insert(tokens, cache, **kw):
        e = insert(tokens, cache, **kw)
        if e is not None:
            inserted.append(e)
            held = _storages(tree_leaves(e.cache)
                             + ([e.logits] if e.logits is not None else []))
            assert not held & (static | pool)
        return e

    eng.prefix_cache.insert = checked_insert
    outs, s = eng.run(_trace())
    assert inserted and s["prefix_hits"] >= 2
    assert any(e.logits is not None for e in inserted)
    assert static == _storages(tree_leaves(eng._pf_cache) + [eng._pf_tokens])
    for e in eng.prefix_cache.entries():
        assert not _storages(tree_leaves(e.cache)) & (static | pool)


def _lockstep_reference(params, cfg, prompts, n, temperature, seed):
    """The lockstep engine's streams as it drew them before its static
    key buffer: the numpy key, fresh caches, eager decode steps."""
    lp = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, lp - len(p):] = p
    key = prng.PRNGKey(seed)
    with torch.inference_mode():
        logits, cache = api.prefill(params, cfg, torch.from_numpy(toks))
        tok = tengine.ServingEngine._sample(logits, temperature, key)
        out = [tok]
        for _ in range(n - 1):
            key, sub = prng.split(key)
            logits, cache = api.decode_step(params, cfg, cache, tok)
            tok = tengine.ServingEngine._sample(logits, temperature, sub)
            out.append(tok)
    return torch.cat(out, 1).numpy()


def test_lockstep_device_key_reproduces_the_sampled_streams(model):
    # The lockstep step reads its key from a (2,) int64 device buffer (a
    # graph would freeze a host key); the draws are the numpy key's, the
    # streams ``tests/test_torch_sampling.py`` holds to the JAX engine.
    cfg, params, paging = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (9, 14)]
    eng = tengine.ServingEngine(cfg, params, device="cpu", max_len=64)
    for batch in ([prompts[0]], prompts):
        got = eng.generate([tengine.Request(p, max_new_tokens=12)
                            for p in batch], temperature=0.8, seed=3)
        want = _lockstep_reference(params, cfg, batch, 12, 0.8, 3)
        np.testing.assert_array_equal(np.stack(got), want)
        st = eng._steps[(len(batch), 0.8)]
        assert st.key.dtype == torch.int64 and st.key.shape == (2,)
    greedy = eng.generate([tengine.Request(prompts[0], max_new_tokens=12)])
    assert not np.array_equal(greedy[0], got[0])
    assert len(set(got[0].tolist())) > 3        # the draws vary


def test_graph_cache_entries_are_zero_on_the_cpu(model):
    cfg, params, paging = model
    eng = tengine.ContinuousServingEngine(cfg, params,
                                          serving=_serving(paging),
                                          device="cpu")
    assert eng.graph_cache_entries() == {"macro_decode": 0, "chunk": 0}
    outs, s = eng.run(_trace())
    assert s["decode_dispatches"] > 0 and s["prefill_ticks"] > 0
    assert eng.graph_cache_entries() == {"macro_decode": 0, "chunk": 0}
    lock = tengine.ServingEngine(cfg, params, device="cpu", max_len=64)
    lock.generate([dataclasses.replace(r) for r in _trace()[:2]])
    assert lock.graph_cache_entries() == {"decode": 0}
