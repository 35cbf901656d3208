"""The port's sharding rules against the JAX package's, in process.

``repro_torch.distributed.sharding`` keeps its own copy of
``repro.distributed.sharding``'s rules; every function that reads only
the mesh's ``{axis: size}`` is handed the same duck mesh
(``SimpleNamespace(shape=...)``) on both sides and must agree exactly:
``partition_spec`` with its fallback log over every parameter leaf of all
11 configs at smoke and full width (full width from ``abstract_params``
on the ``meta`` device), ``param_axes``, ``pool_slot_axes``,
``serving_param_rules``, ``batch_sharding``'s spec (the reference's on
an abstract mesh of the same sizes) and the
shard-balanced ``Scheduler``. ``placements`` is held to the block the
reference's PartitionSpec assigns each mesh coordinate (JAX's rule: a
tuple entry's first axis is major), through DTensor's own split on a
fake process group of the mesh's size.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from jax.sharding import AbstractMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import configs as jconfigs
from repro.configs.base import ServingConfig as JServingConfig
from repro.distributed import sharding as jshd
from repro.models import api as japi
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.configs.base import ServingConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.serving import engine as tengine

torch.set_num_threads(1)    # small ops; the suite runs one process per core

MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 4, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})


def _flat(tree, prefix=""):
    """{a/b/c: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


@pytest.mark.parametrize("name", configs.ALL_ARCHS)
def test_param_axes_and_partition_specs_match_the_reference(name):
    for full in (False, True):
        get = configs.get_config if full else configs.get_smoke_config
        jget = jconfigs.get_config if full else jconfigs.get_smoke_config
        tcfg, jcfg = get(name), jget(name)
        axes = _flat(api.param_axes(tcfg))
        assert axes == _jflat(japi.param_axes(jcfg)), name
        shapes = {k: tuple(v.shape)
                  for k, v in _flat(api.abstract_params(tcfg)).items()}
        jshapes = {k: tuple(v.shape)
                   for k, v in _jflat(japi.abstract_params(jcfg)).items()}
        assert shapes == jshapes
        assert all(v.device.type == "meta"
                   for v in _flat(api.abstract_params(tcfg)).values())
        for m in MESHES:
            mesh = SimpleNamespace(shape=m)
            for key, ax in axes.items():
                got_log, want_log = [], []
                got = shd.partition_spec(mesh, shd.DEFAULT_RULES,
                                         shapes[key], ax, got_log)
                want = jshd.partition_spec(mesh, jshd.DEFAULT_RULES,
                                           shapes[key], ax, want_log)
                assert got == tuple(want), (name, full, m, key)
                assert got_log == want_log, (name, full, m, key)


def test_granite_kv_heads_fall_back_while_heads_shard():
    # granite's single kv head cannot split over model; its q heads can.
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    cfg = configs.get_smoke_config("granite-20b")
    log: list = []
    pl = shd.logical_to_sharding(mesh, shd.DEFAULT_RULES,
                                 api.abstract_params(cfg),
                                 api.param_axes(cfg), log)
    assert ("kv_heads", 1, "model") in log
    assert pl["layers"]["attn"]["wq"] == (shd.Shard(1), shd.Shard(2))
    assert pl["layers"]["attn"]["wk"] == (shd.Shard(1), shd.Replicate())


def test_pool_slot_axes_param_rules_and_batch_spec_match_the_reference():
    for m, n, req in itertools.product(
            MESHES, (1, 4, 6, 8, 32), (0, 1, 2, 4, 16)):
        mesh = SimpleNamespace(shape=m)
        results = []
        for mod in (shd, jshd):
            log: list = []
            try:
                results.append((mod.pool_slot_axes(mesh, mod.DEFAULT_RULES,
                                                   n, req, log), log))
            except ValueError as e:
                results.append(("raises", str(e)))
        assert results[0] == results[1], (m, n, req)
    for rules_kw in ({}, {"embed": ("data", "model")}, {"slots": None},
                     {"slots": ("pod", "data"), "mlp": ("data", "model")}):
        got = shd.serving_param_rules(shd.ShardingRules(**rules_kw))
        want = jshd.serving_param_rules(jshd.ShardingRules(**rules_kw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_batch_spec_matches_the_reference_with_its_fallback():
    # The reference's batch_sharding builds a NamedSharding, which takes
    # an abstract mesh of the same {axis: size}.
    for m in MESHES:
        amesh = AbstractMesh(tuple(m.values()), tuple(m))
        for bs in (None, 1, 2, 3, 16, 64):
            want = tuple(jshd.batch_sharding(amesh, batch_size=bs).spec)
            assert shd.batch_spec(SimpleNamespace(shape=m),
                                  batch_size=bs) == want, (m, bs)


def _reference_block(mesh: dict, spec: tuple, coord: dict, shape):
    """The slice of the reference's PartitionSpec at mesh coordinate
    ``coord``: a dim split over axes (a, b) takes block
    idx_a * size_b + idx_b of size_a * size_b equal blocks."""
    sl = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        k, parts = 0, 1
        for a in axes:
            k, parts = k * mesh[a] + coord[a], parts * mesh[a]
        sl.append(slice(k * n // parts, (k + 1) * n // parts))
    return tuple(sl)


@pytest.mark.parametrize("mesh,shape,spec", [
    ({"data": 2, "model": 2}, (4, 6, 8), ("data", None, "model")),
    ({"data": 2, "model": 2}, (8, 6), (("data", "model"),)),
    ({"pod": 2, "data": 2, "model": 2}, (8, 4, 6), (("pod", "data"),
                                                     "model")),
    ({"pod": 2, "data": 3, "model": 2}, (12, 5), (("pod", "data"),)),
    ({"data": 4, "model": 2}, (3, 8, 4), (None, ("data", "model"))),
])
def test_placements_give_the_reference_block_at_every_coordinate(
        mesh, shape, spec):
    names = list(mesh)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32
                        ).reshape(shape)
    world = int(np.prod(list(mesh.values())))
    for rank in range(world):
        coord = dict(zip(names, np.unravel_index(rank, list(mesh.values()))))
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        try:
            dm = torch.distributed.device_mesh.init_device_mesh(
                "cpu", tuple(mesh.values()), mesh_dim_names=tuple(names))
            pl = shd.placements(dm, spec, len(shape))
            local = distribute_tensor(full, dm, pl,
                                      src_data_rank=None).to_local()
        finally:
            dist.destroy_process_group()
        want = full.numpy()[_reference_block(mesh, spec, coord, shape)]
        np.testing.assert_array_equal(local.numpy(), want)


def test_placements_refuse_a_tuple_out_of_mesh_order():
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    assert shd.placements(mesh, (("data", "model"),), 1) == (
        shd.Shard(0), shd.Shard(0))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.placements(mesh, (("model", "data"),), 1)


def _script(sched, jsched, script):
    """Run one scripted sequence of submits, admissions and evictions on
    the port's and the reference's Scheduler; every admission's (rid,
    slot) on each side."""
    got, want = [], []
    for op, arg in script:
        for s, out, mod in ((sched, got, tengine), (jsched, want, jengine)):
            if op == "submit":
                s.submit(arg, mod.Request(np.zeros(2, np.int32),
                                          arrival_time=0.0))
                s.poll_arrivals(0.0)
            elif op == "admit":
                a = s.next_admission()
                out.append(None if a is None else (a[0], a[2]))
                if a is not None:
                    s.active[a[2]] = object()
            else:                                  # evict
                slots = sorted(s.active)
                if slots:
                    s.evict(slots[arg % len(slots)])
    return got, want


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_scheduler_makes_the_reference_slot_choices(shards):
    rng = np.random.default_rng(shards)
    script, rid = [], 0
    for _ in range(100):
        op = rng.choice(["submit", "admit", "admit", "evict"])
        if op == "submit":
            script.append(("submit", rid))
            rid += 1
        else:
            script.append((op, int(rng.integers(0, 8))))
    sched = tengine.Scheduler(ServingConfig(num_slots=8, max_len=32), shards)
    jsched = jengine.Scheduler(JServingConfig(num_slots=8, max_len=32),
                               slot_shards=shards)
    got, want = _script(sched, jsched, script)
    assert got == want and len([g for g in got if g]) >= 16
    assert [sched.shard_of(s) for s in range(8)] == [
        jsched.shard_of(s) for s in range(8)]


def test_serving_config_slot_shards_validation_is_the_reference():
    for kw in ({"slot_shards": -1}, {"num_slots": 6, "slot_shards": 4}):
        for cls in (ServingConfig, JServingConfig):
            with pytest.raises(ValueError):
                cls(**kw)
    # No refusal is left: slot_shards > 1 is a valid config.
    assert ServingConfig(num_slots=8, slot_shards=4).slot_shards == 4
    assert not hasattr(ServingConfig, "check_supported")


def test_cache_shardings_are_derived_from_shapes():
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    cfg = configs.get_smoke_config("slayformer-124m")
    pool = api.abstract_cache(cfg, 4, 64)
    log: list = []
    pl = shd.serving_cache_sharding(mesh, shd.DEFAULT_RULES, pool,
                                    fallback_log=log)
    # (S, z) (nl, S, Hkv, m, dv): slots over data and, by the reference's
    # head-like heuristic (dim 3 first), m over model; pos (S,) over data.
    assert pl.attn.s == (shd.Shard(1), shd.Shard(3))
    assert pl.pos == (shd.Shard(0), shd.Replicate())
    assert log == []
    rep = shd.serving_cache_sharding(mesh, shd.DEFAULT_RULES,
                                     api.abstract_cache(cfg, 3, 64),
                                     fallback_log=log)
    assert rep.pos == (shd.Replicate(), shd.Replicate())
    assert log == [("slots", 3, "data")]
    assert shd.serving_vector_sharding(mesh, num_slots=4, leading=1) == (
        shd.Shard(1), shd.Replicate())
    cs = shd.cache_sharding(mesh, shd.DEFAULT_RULES, pool)
    assert cs.attn.s == (shd.Shard(1), shd.Shard(3))


def test_mesh_factories_need_a_group_and_enough_ranks():
    from repro_torch.launch import mesh as lmesh
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        lmesh.make_host_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=1,
                            world_size=4)
    try:
        m = lmesh.make_mesh((2, 2), ("data", "model"))
        assert m.device_type == "cpu" and shd.mesh_shape(m) == {
            "data": 2, "model": 2}
        assert shd.mesh_shape(lmesh.make_serving_mesh(4)) == {
            "data": 4, "model": 1}
        with pytest.raises(ValueError, match="needs 8 ranks, the process "
                           "group has 4"):
            lmesh.make_serving_mesh(4, 2)
        for multi in (False, True):
            with pytest.raises(ValueError, match="ranks, the process group "
                               "has 4"):
                lmesh.make_production_mesh(multi_pod=multi)
        # A DeviceMesh reads as its {axis: size} in every rule function.
        assert shd.pool_slot_axes(m, shd.DEFAULT_RULES, 8, 2) == (
            ("data",), 2)
    finally:
        dist.destroy_process_group()
