"""Crash-safe speculative serving in the port and its static-buffer
programs, on the CPU.

Durability: a journaled speculative engine crashed mid-trace and
restored (checkpoint and draft pool) gives the uncrashed streams, greedy
and at T = 0.8 (where the draft pool decides the draws); the port
restores a directory the JAX speculative engine wrote, and the JAX
engine restores one the port wrote, to the same streams; the
checkpoints are one format (keys, verifier and draft leaves); a journal
of another speculative config is refused with the JAX message. The
setup is ``tests/test_torch_spec_engine.py``'s (the JAX tree after its
``ensure_draft_params``, embedding / 8, the JAX engine on a 1x1 mesh
with Auto axes).

Programs (``tests/test_torch_graphs.py``'s contract for the K-round
dispatch that the card captures as one CUDA graph): the verifier pool,
the draft pool, the draft's scratch twin and the draft's prefill cache
keep their storage through dispatches, admissions, evictions, a
quarantine and a restore; an all-inactive dispatch leaves both pools
byte-identical; the static control buffer gives the streams of control
tensors built afresh; no graph on the CPU.
"""
import dataclasses
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
from repro.serving import checkpoint as jckpt
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import journal as jjournal
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.serving import checkpoint as ckpt_lib
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import journal as journal_lib
from repro_torch.serving import speculative
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
KIND = dict(attn_kind="yat_spherical", slay_anchors=16, slay_prf=32,
            dtype="float32")
BASE = dict(num_slots=2, max_len=128, prefill_chunk=16, macro_ticks=4,
            speculative=True, spec_gamma=2, checkpoint_every_ticks=6)
HOT = dict(temperature=0.8, seed=3)
CRASH = (9, 9)
TRACE = ((12, 20), (5, 16), (30, 24), (9, 12))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, **KIND)
    tcfg = get_smoke_config(NAME, **KIND)
    tree = jax.device_get(japi.ensure_draft_params(
        japi.draft_config(jcfg), japi.init_params(jcfg,
                                                  jax.random.PRNGKey(0))))
    tree["embed"] = tree["embed"] / 8.0
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    mesh = jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"), mesh)


def _trace(mod=tengine):
    rng = np.random.default_rng(7)
    return [mod.Request(rng.integers(1, 256, size=n).astype(np.int32),
                        max_new_tokens=m, eos_id=1) for n, m in TRACE]


def _sv(**kw):
    return ServingConfig(**{**BASE, **kw})


def _engine(models, **kw):
    _, tcfg, _, tp, _ = models
    return tengine.ContinuousServingEngine(tcfg, tp, device="cpu", **kw)


@pytest.fixture(scope="module")
def uncrashed(models):
    """The port's streams without a crash, greedy and sampled."""
    return {t: _engine(models, serving=_sv(**kw)).run(_trace())[0]
            for t, kw in ((0.0, {}), (0.8, HOT))}


def _crash(models, d, **kw):
    """A journaled port engine crashed at tick CRASH[0]."""
    jr = journal_lib.Journal(os.path.join(d, journal_lib.JOURNAL_NAME))
    eng = _engine(models, serving=_sv(**kw), journal=jr,
                  fault_injector=tfaults.FaultInjector(crash_window=CRASH))
    with pytest.raises(tfaults.EngineCrash):
        eng.run(_trace())
    assert eng.metrics.checkpoints_written >= 1
    return eng


def _same(outs, want):
    assert set(outs) == set(want)
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid], f"rid {rid}")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_crash_restore_byte_identity(models, uncrashed, tmp_path,
                                     temperature):
    _, tcfg, _, tp, _ = models
    kw = HOT if temperature else {}
    d = str(tmp_path)
    _crash(models, d, **kw)
    delivered: list = []
    eng = tengine.ContinuousServingEngine.restore(
        d, tcfg, tp, serving=_sv(**kw), device="cpu",
        on_token=lambda rid, tok: delivered.append(rid))
    rec = eng.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    outs, s = eng.run()
    _same(outs, uncrashed[temperature])
    assert s["tokens_replayed"] > 0 and s["draft_tokens_proposed"] > 0
    # Each token reaches its consumer once: the restored run delivers
    # only what the journal did not hold.
    assert len(delivered) == s["tokens_generated"] - s["tokens_replayed"]


def test_restore_refuses_another_speculative_config(models, tmp_path):
    _, tcfg, _, tp, _ = models
    d = str(tmp_path)
    _crash(models, d)
    for bad in (dict(speculative=False), dict(spec_gamma=3)):
        with pytest.raises(ValueError, match="speculative"):
            tengine.ContinuousServingEngine.restore(d, tcfg, tp,
                                                    serving=_sv(**bad),
                                                    device="cpu")


@pytest.fixture(scope="module")
def jax_dir(models, tmp_path_factory):
    """A directory of the JAX speculative engine crashed at T = 0.8."""
    jcfg, _, jp, _, mesh = models
    d = str(tmp_path_factory.mktemp("jax_spec"))
    jr = jjournal.Journal(os.path.join(d, jjournal.JOURNAL_NAME))
    eng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=JServingConfig(**BASE, **HOT), journal=jr,
        fault_injector=jfaults.FaultInjector(crash_window=CRASH))
    with pytest.raises(jfaults.EngineCrash):
        eng.run(_trace(jengine))
    return d


def test_port_restores_a_jax_written_directory(models, uncrashed, jax_dir,
                                               tmp_path):
    _, tcfg, _, tp, _ = models
    # One format: the port's checkpoint at the same tick has the JAX
    # one's keys, flags and leaves, the draft pool's among them.
    d = str(tmp_path)
    _crash(models, d, **HOT)
    a, b = ckpt_lib.latest_valid(d), jckpt.latest_valid(jax_dir)
    assert set(a) == set(b) and a["tick"] == b["tick"]
    for k in ("speculative", "spec_gamma", "slots", "next_rid"):
        assert a[k] == b[k], k
    assert a["speculative"] and a["spec_gamma"] == 2
    for key in ("pool", "draft_pool"):
        assert [(x.shape, x.dtype) for x in a[key]] == [
            (x.shape, x.dtype) for x in b[key]], key
    eng = tengine.ContinuousServingEngine.restore(
        jax_dir, tcfg, tp, serving=_sv(**HOT), device="cpu")
    assert eng.recovery["checkpoint_used"]
    assert eng.recovery["resident_resumed"] >= 1
    outs, s = eng.run()
    _same(outs, uncrashed[0.8])
    assert s["tokens_replayed"] > 0


def test_jax_engine_restores_a_port_written_directory(models, uncrashed,
                                                      tmp_path):
    jcfg, _, jp, _, mesh = models
    d = str(tmp_path)
    _crash(models, d, **HOT)
    eng = jengine.ContinuousServingEngine.restore(
        d, jcfg, jp, mesh, serving=JServingConfig(**BASE, **HOT))
    assert eng.recovery["checkpoint_used"]
    assert eng.recovery["resident_resumed"] >= 1
    outs, s = eng.run()
    _same(outs, uncrashed[0.8])
    assert s["tokens_replayed"] > 0


# ---------------------------------------------------------------------------
# The static-buffer programs
# ---------------------------------------------------------------------------


def _static(eng) -> list[int]:
    """Data pointers of every tensor the speculative dispatch and the
    prefill chunk bind."""
    return [t.data_ptr() for t in tree_leaves({
        "pool": eng.pool, "draft": eng.draft_pool,
        "scratch": eng._draft_scratch, "pf": eng._pf_cache,
        "pf_draft": eng._pf_draft})] + [eng._ctl.data_ptr()]


@dataclasses.dataclass
class _OneFault(tfaults.FaultInjector):
    """NaN-corrupts the lowest live slot once, at the first engine step at
    or after tick ``at``."""

    at: int = 0

    def corrupt_slots(self, tick, live_slots):
        if self.log or tick < self.at or not live_slots:
            return []
        self.log.append({"kind": "nan", "tick": tick})
        return [min(live_slots)]


def test_static_buffers_are_never_replaced(models, uncrashed, tmp_path,
                                           monkeypatch):
    _, tcfg, _, tp, _ = models
    seen: list = []
    step = tengine.ContinuousServingEngine.step

    def checked_step(self):
        out = step(self)
        seen.append(_static(self))
        return out

    monkeypatch.setattr(tengine.ContinuousServingEngine, "step",
                        checked_step)
    d = str(tmp_path)
    jr = journal_lib.Journal(os.path.join(d, journal_lib.JOURNAL_NAME))
    eng = _engine(models, serving=_sv(**HOT), journal=jr,
                  fault_injector=_OneFault(seed=3, at=6,
                                           crash_window=(24, 24)))
    first = _static(eng)
    with pytest.raises(tfaults.EngineCrash):
        eng.run(_trace())
    m = eng.metrics
    assert (m.decode_dispatches > 2 and m.faults_detected == 1
            and m.requests_terminated >= 1 and m.checkpoints_written >= 1)
    assert seen and all(p == first for p in seen)
    seen.clear()
    eng2 = tengine.ContinuousServingEngine.restore(d, tcfg, tp,
                                                   serving=_sv(**HOT),
                                                   device="cpu")
    assert eng2.recovery["checkpoint_used"]
    before = _static(eng2)
    outs, _ = eng2.run()
    _same(outs, uncrashed[0.8])
    assert seen and all(p == before for p in seen)


def test_all_inactive_dispatch_leaves_both_pools_bytes_identical(models):
    eng = _engine(models, serving=_sv(checkpoint_every_ticks=0))
    reqs = _trace()
    with torch.inference_mode():
        for r in reqs[:2]:
            eng.submit(r)
        while len(eng.sched.active) < 2:
            eng.step()
        eng.step()                                # one dispatch: mid-stream
        eng._debug_audit()        # both pools at the same context a slot
        pools = {"pool": eng.pool, "draft": eng.draft_pool}
        before = [t.clone() for t in tree_leaves(pools)]
        assert all(t.any() for t in before)
        eng._active[:] = False
        eng._decode_spec()
    for got, want in zip(tree_leaves(pools), before):
        assert torch.equal(got, want)
    with torch.inference_mode():
        eng.draft_pool.pos[0] += 1
    with pytest.raises(AssertionError, match="out of step"):
        eng._debug_audit()


class _FreshControl:
    """The speculative dispatch on control tensors built anew from the
    host mirrors (no static control buffer)."""

    captured = False

    def __init__(self, eng):
        self.eng = eng

    def __call__(self):
        e, sv = self.eng, self.eng.serving
        c = [torch.from_numpy(x.astype(np.int32)) for x in (
            e._last_tok, e._active, e._rids, e._gen, e._eos, e._maxn)]
        return speculative.spec_macro(
            e.params, e.draft_pool, e._draft_scratch, e.pool, c[0],
            c[1].bool(), *c[2:], draft_cfg=e.draft_cfg, cfg=e.cfg,
            num_rounds=sv.macro_ticks, gamma=sv.spec_gamma,
            temperature=sv.temperature, seed=sv.seed,
            fault_guard=sv.fault_guard)


def test_static_program_streams_equal_fresh_control(models, uncrashed):
    eng = _engine(models, serving=_sv(checkpoint_every_ticks=0, **HOT))
    eng._spec_decode = _FreshControl(eng)
    outs, s = eng.run(_trace())
    _same(outs, uncrashed[0.8])
    assert s["decode_dispatches"] > 4


def test_graph_cache_entries_are_zero_on_the_cpu(models):
    eng = _engine(models, serving=_sv(checkpoint_every_ticks=0))
    want = {"macro_decode": 0, "chunk": 0, "spec_macro": 0}
    assert eng.graph_cache_entries() == want
    eng.run(_trace())
    assert eng.graph_cache_entries() == want
