"""Crash-safe serving in the port (``repro_torch.serving.journal``,
``.checkpoint`` and ``ContinuousServingEngine.restore``) on the CPU, the
counterparts of ``tests/test_serving_restore.py`` in its three regimes
(SLAY's constant state; softmax's KV ring, unpaged and paged), and two
cross-program checks against the JAX package.

The journal's framing and torn-tail replay, atomic checkpoints with
corrupt-file fallback, and the kill-and-restore contract: a crash
mid-decode and mid-chunked-prefill, a truncated journal tail, restore
onto another slot count, exactly-once redelivery, a refused sampling
config, a corrupt newest checkpoint. The trace shares a system prompt,
so the prefix cache is live and its index goes through the checkpoint.
Across programs: under one fake clock the port's journal is byte for
byte the JAX engine's, and the port restores a directory that a crashed
JAX engine wrote, to the JAX engine's uncrashed streams (a near-tie of
``logits / T + g`` would be reported as such, ROADMAP C-2); the other
way round, the JAX engine restores a directory that the crashed port
wrote, to the same streams in fp32, and in bf16 to the prefix cache
(leaf dtypes and bytes) that it restores from its own directory, the
port writing a bf16 leaf byte for byte as the JAX writer does.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServingConfig as JServingConfig
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtr
from repro.serving import checkpoint as jckpt
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
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
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
TIE_GAP = 1e-5
CRASH = (10, 16)                # lands on tick 12, checkpoint at 7


# regime -> (attention kind, ServingConfig keywords), the regimes of
# tests/test_serving_restore.py.
REGIMES = {"constant_state": ("slay", {}),
           "kv_ring": ("softmax", {}),
           "paged": ("softmax", {"page_size": 8})}


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


def _kw(**kw):
    return {"num_slots": 2, "max_len": 64, "prefill_chunk": 4,
            "macro_ticks": 4, "temperature": 0.7,
            "checkpoint_every_ticks": 6, "prefix_cache_bytes": 1 << 22,
            "debug_audit": True, **kw}


def _sv(**kw):
    return ServingConfig(**_kw(**kw))


def _prompts(n=3, plen=5):
    """``n`` prompts: a shared 4-token system prompt (one chunk) and a
    unique suffix, so later requests hit the prefix cache."""
    rng = np.random.default_rng(7)
    shared = rng.integers(3, 256, 4)
    return [np.concatenate([shared, rng.integers(3, 256, plen)])
            .astype(np.int32) for _ in range(n)]


def _trace(mod=tengine, n=3, max_new=12, plen=5):
    return [mod.Request(p, max_new_tokens=max_new, arrival_time=float(i))
            for i, p in enumerate(_prompts(n, plen))]


def _baseline(models, sv, **tr):
    """Fault-free streams of the trace (no journal)."""
    _, tcfg, _, tp, _, paging = models
    eng = tengine.ContinuousServingEngine(
        tcfg, tp, device="cpu",
        serving=dataclasses.replace(sv, checkpoint_every_ticks=0, **paging))
    return eng.run(_trace(**tr))[0]


def _crash_run(models, d, sv, *, crash_window=CRASH, **tr):
    """Run the trace on a journaled engine until the injected crash kills
    it; the dead engine."""
    _, tcfg, _, tp, _, paging = models
    jr = journal_lib.Journal(os.path.join(d, journal_lib.JOURNAL_NAME))
    inj = faults.FaultInjector(seed=3, crash_window=crash_window)
    eng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=dataclasses.replace(sv, **paging), device="cpu",
        fault_injector=inj, journal=jr)
    with pytest.raises(faults.EngineCrash):
        eng.run(_trace(**tr))
    return eng


def _restore(models, d, sv, **kw):
    _, tcfg, _, tp, _, paging = models
    return tengine.ContinuousServingEngine.restore(
        d, tcfg, tp, serving=dataclasses.replace(sv, **paging),
        device="cpu", **kw)


def _same(outs, base):
    assert set(outs) == set(base)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid], f"rid {rid}")


# -- journal unit behaviour --------------------------------------------------


def test_journal_roundtrip_and_replay(tmp_path):
    p = str(tmp_path / "j.wal")
    with journal_lib.Journal(p) as j:
        j.append({"t": "meta", "v": 1, "seed": 0})
        j.append({"t": "admit", "rid": 0, "prompt": [1, 2, 3]})
        j.append({"t": "tok", "rid": 0, "tok": 42, "idx": 0})
        j.append({"t": "fin", "rid": 0, "reason": "length", "tick": 3})
        j.flush()
        assert j.flushes == 1 and not j.dirty
    st = journal_lib.replay(p)
    assert st.meta["seed"] == 0
    assert st.admits[0]["prompt"] == [1, 2, 3]
    assert st.tokens[0] == [42] and st.fins[0] == "length"
    assert not st.dropped_tail and st.valid_bytes == os.path.getsize(p)
    # One format: the JAX package reads it the same.
    assert dataclasses.asdict(jjournal.replay(p)) == dataclasses.asdict(st)


def test_journal_torn_tail_dropped_and_truncated(tmp_path):
    p = str(tmp_path / "j.wal")
    with journal_lib.Journal(p) as j:
        j.append({"t": "admit", "rid": 0, "prompt": [1]})
        j.append({"t": "tok", "rid": 0, "tok": 5, "idx": 0})
        j.flush()
    whole = os.path.getsize(p)
    with open(p, "ab") as f:                   # a torn write: half a record
        f.write(b'deadbeef {"t": "tok", "rid": 0,')
    st = journal_lib.replay(p)
    assert st.dropped_tail and st.valid_bytes == whole
    assert st.tokens[0] == [5]
    with journal_lib.Journal(p, truncate_to=st.valid_bytes) as j2:
        j2.append({"t": "tok", "rid": 0, "tok": 6, "idx": 1})
        j2.flush()
    assert journal_lib.replay(p).tokens[0] == [5, 6]


def test_journal_crc_corruption_drops_suffix(tmp_path):
    p = str(tmp_path / "j.wal")
    with journal_lib.Journal(p) as j:
        for i in range(4):
            j.append({"t": "tok", "rid": 0, "tok": i, "idx": i})
        j.flush()
    with open(p, "rb") as f:
        lines = f.readlines()
    lines[2] = lines[2].replace(b'"tok"', b'"toX"')
    with open(p, "wb") as f:
        f.writelines(lines)
    st = journal_lib.replay(p)
    assert st.dropped_tail and st.tokens[0] == [0, 1]


def test_journal_retry_record_resets_stream(tmp_path):
    p = str(tmp_path / "j.wal")
    with journal_lib.Journal(p) as j:
        j.append({"t": "tok", "rid": 1, "tok": 9, "idx": 0})
        j.append({"t": "retry", "rid": 1})
        j.append({"t": "tok", "rid": 1, "tok": 4, "idx": 0})
        j.flush()
    st = journal_lib.replay(p)
    assert st.tokens[1] == [4] and st.retries[1] == 1


# -- checkpoint unit behaviour -----------------------------------------------


def _flip_last_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)[0]
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b ^ 0xFF]))


def test_checkpoint_save_load_roundtrip(tmp_path):
    p = str(tmp_path / "ckpt-000000000007.ckpt")
    state = {"version": 1, "tick": 7, "pool": [np.ones(3, np.int32)],
             "arr": np.arange(12, dtype=np.float32).reshape(3, 4)}
    ckpt_lib.save(p, state)
    assert os.listdir(str(tmp_path)) == ["ckpt-000000000007.ckpt"]
    got = ckpt_lib.load(p)
    assert got["tick"] == 7
    np.testing.assert_array_equal(got["arr"], state["arr"])
    np.testing.assert_array_equal(jckpt.load(p)["arr"], state["arr"])


def test_checkpoint_reads_jax_bfloat16_and_refuses_other_objects(tmp_path):
    # A JAX-written bfloat16 leaf comes back as the float32 it encodes,
    # without ml_dtypes; a payload that names anything but numpy arrays
    # and builtins (here a torch tensor) is refused and skipped.
    d = str(tmp_path)
    want = np.float32([1.5, -2.25, 3e38, 1e-40])
    jckpt.save(jckpt.checkpoint_path(d, 2),
               {"tick": 2, "logits": want.astype(ml_dtypes.bfloat16)})
    got = ckpt_lib.load(jckpt.checkpoint_path(d, 2))["logits"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, want.astype(ml_dtypes.bfloat16).astype(np.float32))
    bad = jckpt.checkpoint_path(d, 5)
    jckpt.save(bad, {"tick": 5, "t": torch.ones(2)})
    with pytest.raises(pickle.UnpicklingError, match="torch"):
        ckpt_lib.load(bad)
    assert ckpt_lib.latest_valid(d)["tick"] == 2


def test_bf16_leaf_pickles_as_the_jax_writer():
    # The port writes a bfloat16 leaf as the JAX writer's ml_dtypes array,
    # opcode for opcode, without importing ml_dtypes; and reads it back.
    rng = np.random.default_rng(11)
    cases = [np.array([[1.5, -2.0]], ml_dtypes.bfloat16).view(np.uint16),
             rng.integers(0, 1 << 16, (1, 1, 300)).astype(np.uint16)]
    for words in cases:
        t = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
        leaf = ckpt_lib.to_numpy(t)
        want = pickle.dumps(words.view(ml_dtypes.bfloat16), protocol=4)
        assert ckpt_lib.dumps(leaf) == want
        state = {"pool": [np.arange(3, dtype=np.float32)], "logits": leaf}
        assert ckpt_lib.dumps(state) == pickle.dumps(
            {"pool": state["pool"], "logits": words.view(ml_dtypes.bfloat16)},
            protocol=4)


def test_checkpoint_corruption_detected_and_skipped(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(ckpt_lib.checkpoint_path(d, 3), {"tick": 3})
    newest = ckpt_lib.checkpoint_path(d, 9)
    ckpt_lib.save(newest, {"tick": 9})
    _flip_last_byte(newest)
    with pytest.raises(ckpt_lib.CheckpointError):
        ckpt_lib.load(newest)
    assert ckpt_lib.latest_valid(d)["tick"] == 3
    assert [t for t, _ in ckpt_lib.list_checkpoints(d)] == [9, 3]


def test_checkpoint_latest_valid_empty_dir(tmp_path):
    assert ckpt_lib.latest_valid(str(tmp_path)) is None


# -- kill and restore --------------------------------------------------------


def test_crash_restore_byte_identical(models, tmp_path):
    sv = _sv()
    base = _baseline(models, sv)
    d = str(tmp_path)
    _crash_run(models, d, sv)
    got = {}
    eng2 = _restore(models, d, sv, on_token=lambda rid, tok:
                    got.setdefault(rid, []).append(tok))
    assert eng2.recovery["wall_s"] >= 0.0
    outs, s = eng2.run()
    _same(outs, base)
    assert s["tokens_replayed"] > 0
    assert s["final_occupancy"] == 0 and s["final_queue_depth"] == 0
    # Exactly once: the callbacks got the suffix past the journal's
    # horizon, never a replayed token.
    for rid, toks in got.items():
        np.testing.assert_array_equal(
            toks, np.asarray(outs[rid])[len(outs[rid]) - len(toks):])


def test_crash_uses_checkpoint_and_resumes_residents(models, tmp_path):
    sv = _sv()
    d = str(tmp_path)
    eng = _crash_run(models, d, sv)
    assert eng.metrics.checkpoints_written >= 1
    eng2 = _restore(models, d, sv)
    rec = eng2.recovery
    assert rec["checkpoint_used"] and rec["checkpoint_tick"] >= 1
    assert rec["resident_resumed"] >= 1
    assert len(eng2.prefix_cache) > 0          # the index came back
    # The checkpoint was copied into the pool's own tensors (a paged
    # pool's page tables among them), which the decode and the slot
    # functions then keep updating in place.
    ptrs = [t.data_ptr() for t in tree_leaves(eng2.pool)]
    outs, s = eng2.run()
    assert ptrs == [t.data_ptr() for t in tree_leaves(eng2.pool)]
    _same(outs, _baseline(models, sv))
    assert s["journal_bytes"] > 0


def test_crash_mid_chunked_prefill_restores_byte_identical(models, tmp_path):
    sv = _sv(checkpoint_every_ticks=2)
    tr = dict(n=2, max_new=6, plen=20)          # 24 / 4 = 6 prefill chunks
    base = _baseline(models, sv, **tr)
    d = str(tmp_path)
    eng = _crash_run(models, d, sv, crash_window=(3, 3), **tr)
    assert eng.tick <= 6 and eng._prefill is not None    # inside prefill
    outs, s = _restore(models, d, sv).run()
    _same(outs, base)
    assert s["final_occupancy"] == 0


def test_restore_with_truncated_journal_tail(models, tmp_path):
    sv = _sv()
    base = _baseline(models, sv)
    d = str(tmp_path)
    _crash_run(models, d, sv)
    jpath = os.path.join(d, journal_lib.JOURNAL_NAME)
    with open(jpath, "r+b") as f:
        f.truncate(os.path.getsize(jpath) - 5)
    assert journal_lib.replay(jpath).dropped_tail
    eng2 = _restore(models, d, sv)
    assert eng2.recovery["journal_dropped_tail"]
    outs, s = eng2.run()
    _same(outs, base)
    assert s["final_occupancy"] == 0


def test_restore_onto_different_slot_count(models, tmp_path):
    sv = _sv()
    base = _baseline(models, sv)
    d = str(tmp_path)
    eng = _crash_run(models, d, sv)
    assert eng.metrics.checkpoints_written >= 1
    eng2 = _restore(models, d, _sv(num_slots=3))
    assert not eng2.recovery["checkpoint_used"]
    outs, s = eng2.run()
    _same(outs, base)
    assert s["tokens_replayed"] > 0 and s["final_occupancy"] == 0


def test_restore_redelivers_exactly_once(models, tmp_path):
    sv = _sv()
    base = _baseline(models, sv)
    d = str(tmp_path)
    _crash_run(models, d, sv)
    got, fins = {}, []
    eng2 = _restore(
        models, d, sv, redeliver=True,
        on_token=lambda rid, tok: got.setdefault(rid, []).append(tok),
        on_finish=lambda rid, why: fins.append((rid, why)))
    outs, _ = eng2.run()
    for rid in base:
        np.testing.assert_array_equal(got.get(rid, []), outs[rid])
    assert sorted(rid for rid, _ in fins) == sorted(base)


def test_restore_detects_a_stream_that_regenerates_differently(models,
                                                               tmp_path):
    # A journaled token that the restored engine does not regenerate (here
    # forged, with a valid CRC) is a byte-identity violation, not a
    # silently delivered second stream.
    sv = _sv()
    d = str(tmp_path)
    _crash_run(models, d, sv)
    jpath = os.path.join(d, journal_lib.JOURNAL_NAME)
    with open(jpath, "rb") as f:
        lines = f.readlines()
    # The last token: one that the crash left past the checkpoint, which
    # the restored engine regenerates.
    i = max(n for n, line in enumerate(lines) if b'"t":"tok"' in line)
    rec = journal_lib._parse_line(lines[i])
    lines[i] = journal_lib._frame({**rec, "tok": (rec["tok"] + 1) % 256})
    with open(jpath, "wb") as f:
        f.writelines(lines)
    eng2 = _restore(models, d, sv)
    with pytest.raises(RuntimeError, match="byte-identity violated"):
        eng2.run()


def test_restore_refuses_mismatched_sampling_config(models, tmp_path):
    d = str(tmp_path)
    _crash_run(models, d, _sv())
    with pytest.raises(ValueError, match="seed"):
        _restore(models, d, _sv(seed=123))
    with pytest.raises(ValueError, match="temperature"):
        _restore(models, d, _sv(temperature=0.9))


def test_restore_skips_corrupt_newest_checkpoint(models, tmp_path):
    sv = _sv(checkpoint_every_ticks=2)
    base = _baseline(models, sv)
    d = str(tmp_path)
    eng = _crash_run(models, d, sv)
    assert eng.metrics.checkpoints_written >= 2
    ticks = [t for t, _ in ckpt_lib.list_checkpoints(d)]
    _flip_last_byte(ckpt_lib.checkpoint_path(d, ticks[0]))
    eng2 = _restore(models, d, sv)
    assert eng2.recovery["checkpoint_used"]
    assert eng2.recovery["checkpoint_tick"] == ticks[1]
    _same(eng2.run()[0], base)


# -- across programs ---------------------------------------------------------


class _Clock:
    """A fake wall clock: each read advances it by a quarter second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.fixture(scope="module")
def jax_dirs(models, tmp_path_factory):
    """The JAX engine on the trace, under a fake clock: uncrashed with a
    journal, and crashed; (its streams, the two directories)."""
    jcfg, _, jp, _, mesh, paging = models
    sv = JServingConfig(**_kw(**paging))
    out = {}
    for name in ("whole", "crashed"):
        d = str(tmp_path_factory.mktemp(name))
        jr = jjournal.Journal(os.path.join(d, jjournal.JOURNAL_NAME))
        inj = (jfaults.FaultInjector(seed=3, crash_window=CRASH)
               if name == "crashed" else None)
        eng = jengine.ContinuousServingEngine(
            jcfg, jp, mesh, serving=sv, journal=jr, fault_injector=inj,
            clock=_Clock())
        if inj is None:
            out["streams"] = eng.run(_trace(jengine))[0]
        else:
            with pytest.raises(jfaults.EngineCrash):
                eng.run(_trace(jengine))
            assert eng.metrics.checkpoints_written >= 1
        out[name] = d
    return out


def test_journal_bytes_equal_jax_under_one_clock(models, jax_dirs,
                                                 tmp_path):
    _, tcfg, _, tp, _, paging = models
    d = str(tmp_path)
    jr = journal_lib.Journal(os.path.join(d, journal_lib.JOURNAL_NAME))
    eng = tengine.ContinuousServingEngine(tcfg, tp, serving=_sv(**paging),
                                          device="cpu", journal=jr,
                                          clock=_Clock())
    outs, s = eng.run(_trace())
    _same(outs, jax_dirs["streams"])
    name = journal_lib.JOURNAL_NAME
    with open(os.path.join(d, name), "rb") as f:
        mine = f.read()
    with open(os.path.join(jax_dirs["whole"], name), "rb") as f:
        theirs = f.read()
    assert mine == theirs and s["journal_bytes"] == len(mine)
    # The checkpoints are one format: the same ticks, keys, leaf shapes
    # and dtypes, host state and prefix index.
    assert ([t for t, _ in ckpt_lib.list_checkpoints(d)]
            == [t for t, _ in jckpt.list_checkpoints(jax_dirs["whole"])])
    a, b = ckpt_lib.latest_valid(d), jckpt.latest_valid(jax_dirs["whole"])
    assert set(a) == set(b)
    assert [(x.shape, x.dtype) for x in a["pool"]] == [
        (x.shape, x.dtype) for x in b["pool"]]
    for k in ("tick", "next_rid", "slots", "draft_pool", "speculative",
              "spec_gamma", "page_size"):
        assert a[k] == b[k], k
    assert (a["page_pool"] is None) == (b["page_pool"] is None)
    if b["page_pool"] is not None:
        for k, want in b["page_pool"].items():
            np.testing.assert_array_equal(
                np.asarray(a["page_pool"][k], dtype=object),
                np.asarray(want, dtype=object), k)
    for k in a["mirrors"]:
        np.testing.assert_array_equal(a["mirrors"][k], b["mirrors"][k])
    assert [(e["length"], e["tokens"].tolist()) for e in a["prefix"]] == [
        (e["length"], e["tokens"].tolist()) for e in b["prefix"]]


def _gaps(models, prompt, stream, rid, temperature, seed=0):
    """Top-2 gaps of logits / T + g along ``stream``, the port alone,
    teacher-forced from a whole-prompt prefill."""
    _, tcfg, _, tp, _, _ = models
    gaps = []
    with torch.inference_mode():
        logits, cache = api.prefill(tp, tcfg, torch.from_numpy(prompt[None]))
        for idx, tok in enumerate(stream):
            row = (sampling.scale_logits(logits[0, -1].float(), temperature)
                   + sampling._gumbel_row(seed, rid, idx, logits.shape[-1],
                                          device="cpu"))
            top2 = torch.topk(row, 2).values
            gaps.append(float(top2[0] - top2[1]))
            t = torch.tensor([[int(tok)]], dtype=torch.int32)
            logits, cache = api.decode_step(tp, tcfg, cache, t)
    return gaps


def test_port_restores_a_jax_written_directory(models, jax_dirs):
    want = jax_dirs["streams"]
    for rid, (p, stream) in enumerate(zip(_prompts(), want.values())):
        gap = min(_gaps(models, p, stream, rid, 0.7))
        assert gap > TIE_GAP, f"near-tie in rid {rid} (gap {gap:.2e})"
    eng = _restore(models, jax_dirs["crashed"], _sv())
    rec = eng.recovery
    assert rec["checkpoint_used"] and len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, want)
    assert s["tokens_replayed"] > 0


def test_jax_engine_restores_a_port_written_directory(models, jax_dirs,
                                                      tmp_path):
    jcfg, _, jp, _, mesh, paging = models
    d = str(tmp_path)
    _crash_run(models, d, _sv())
    eng = jengine.ContinuousServingEngine.restore(
        d, jcfg, jp, mesh, serving=JServingConfig(**_kw(**paging)))
    rec = eng.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    assert len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, jax_dirs["streams"])
    assert s["tokens_replayed"] > 0


@pytest.fixture(scope="module")
def models_bf16(models):
    kind = models[0].attn_kind
    jcfg = jax_smoke_config(NAME, attn_kind=kind)
    tcfg = get_smoke_config(NAME, attn_kind=kind)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    return jcfg, tcfg, jp, tp, models[4], models[5]


def test_jax_engine_restores_port_bf16_prefix_cache_as_its_own(models_bf16,
                                                                tmp_path):
    # A bf16 model's prefix entries carry bf16 last-token logits (and an
    # exact kind's bf16 rings). Both engines crash on one trace at the same
    # tick with the same checkpoint; the JAX engine restores either
    # directory to the same prefix cache: leaf dtypes, logits in bfloat16,
    # and the LRU's byte count.
    jcfg, _, jp, _, mesh, paging = models_bf16
    kw = _kw(temperature=0.0, **paging)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _crash_run(models_bf16, port_dir, ServingConfig(**kw))
    jr = jjournal.Journal(os.path.join(jax_dir, jjournal.JOURNAL_NAME))
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=JServingConfig(**kw), journal=jr,
        fault_injector=jfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(jfaults.EngineCrash):
        jeng.run(_trace(jengine))
    caches = []
    for d in (port_dir, jax_dir):
        eng = jengine.ContinuousServingEngine.restore(
            d, jcfg, jp, mesh, serving=JServingConfig(**kw))
        assert eng.recovery["checkpoint_used"]
        pc = eng.prefix_cache
        caches.append((pc.nbytes, [
            (e.tokens.tolist(), [str(x.dtype) for x in jax.tree.leaves(
                e.cache)], None if e.logits is None else str(e.logits.dtype))
            for e in pc.entries()]))
    (port_bytes, port_entries), (jax_bytes, jax_entries) = caches
    assert port_entries == jax_entries
    assert any(lg == "bfloat16" for *_, lg in jax_entries)
    assert port_bytes == jax_bytes
