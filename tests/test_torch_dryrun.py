"""The port's dry run (``repro_torch.launch.dryrun``) and perf experiments
(``launch.perf``) against the JAX package's: the skip rule, the
microbatch count and the experiments' transforms equal the reference's;
every assigned config x shape cell, cut to 2 layers at full width, traces
on the meta device over a fake 16x16 world (one subprocess, which also
runs one 2x16x16 cell and ``main`` on a cell made to fail) with the
argument bytes the sharding rules give, the reference's roofline keys and
the routes ``attention_route`` gives."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, perf
from repro_torch.models import api
from repro_torch.train.loop import TrainConfig
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
KINDS = ("slay", "softmax", "favor", "elu1")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _reference():
    """The reference's dryrun, perf, configs and roofline modules. Their
    import sets XLA_FLAGS to 512 forced host devices, which would reach
    every later JAX test of this process: it is put back at once (JAX
    reads it when its backend starts, which no import does)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro import configs as ref_configs
        from repro.launch import dryrun as ref_dryrun
        from repro.launch import perf as ref_perf
        from repro.launch import roofline as ref_roofline
        from repro.train.loop import TrainConfig as RefTrainConfig
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return types.SimpleNamespace(configs=ref_configs, dryrun=ref_dryrun,
                                 perf=ref_perf, roofline=ref_roofline,
                                 TrainConfig=RefTrainConfig)


REF = _reference()


def _duck(shape: dict):
    return types.SimpleNamespace(shape=shape)


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_skip_rule_and_microbatches_equal_the_reference(arch):
    """Every cell on both production meshes, under four kinds."""
    for kind in KINDS:
        cfg = configs.get_config(arch, attn_kind=kind)
        ref_cfg = REF.configs.get_config(arch, attn_kind=kind)
        for cell in configs.SHAPE_CELLS:
            ref_cell = REF.configs.get_cell(cell.name)
            assert (dryrun._cell_is_skipped(cfg, cell)
                    == REF.dryrun._cell_is_skipped(ref_cfg, ref_cell))
            for ms in MESHES.values():
                assert (dryrun.default_microbatches(cfg, cell, _duck(ms))
                        == REF.dryrun.default_microbatches(
                            ref_cfg, ref_cell, _duck(ms)))


def test_experiment_names_equal_the_reference():
    assert list(perf.EXPERIMENTS) == list(REF.perf.EXPERIMENTS)


@pytest.mark.parametrize("name", list(perf.EXPERIMENTS))
def test_experiment_transforms_equal_the_reference(name):
    """The rules' fields, the TrainConfig's fields and the overrides after
    each transform, from the defaults; the reference's
    ``remat_policy="save_collectives"`` is the port's
    ``remat="save_collectives"``."""
    rules, tc, ov = perf.EXPERIMENTS[name](
        shd.DEFAULT_RULES, TrainConfig(microbatches=4, remat=True), {})
    r_rules, r_tc, r_ov = REF.perf.EXPERIMENTS[name](
        REF.dryrun.shd.DEFAULT_RULES,
        REF.TrainConfig(microbatches=4, remat=True), {})
    assert dataclasses.asdict(rules) == dataclasses.asdict(r_rules)
    remat = ("save_collectives" if r_tc.remat_policy == "save_collectives"
             else r_tc.remat)
    assert (tc.microbatches, tc.compress_grads, tc.remat) == (
        r_tc.microbatches, r_tc.compress_grads, remat)
    assert ov == r_ov


# -- the grid, in one subprocess ------------------------------------------

_GRID = r"""
import json, sys
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
torch.set_num_threads(1)


def depth(arch):
    d = {"num_layers": 2}
    if configs.get_config(arch).enc_layers:
        d["enc_layers"] = 2
    return d


records = [dryrun.run_cell(a, c.name, verbose=False, **depth(a))
           for a in configs.ASSIGNED_ARCHS for c in configs.SHAPE_CELLS]
pod = dryrun.run_cell("granite-20b", "train_4k", multi_pod=True,
                      verbose=False, num_layers=2)
json.dump({"grid": records, "pod": pod},
          open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "grid.json"
    subprocess.run([sys.executable, "-c", _GRID, str(path)], check=True,
                   timeout=900, env={**os.environ, "PYTHONPATH": str(SRC)},
                   stdout=subprocess.DEVNULL)
    return json.loads(path.read_text())


def _local(shape, spec, ms) -> int:
    """Elements of one rank's block of ``shape`` under a PartitionSpec."""
    n = 1
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= dim // math.prod(ms[a] for a in axes)
    return n


def _local_placed(x, pls, ms) -> int:
    """Bytes of one rank's block of ``x`` under DTensor placements."""
    shape = list(x.shape)
    for size, p in zip(ms.values(), pls):
        if p.is_shard():
            shape[p.dim] //= size
    return math.prod(shape) * x.element_size()


def _want_argument(cfg, cell, ms) -> int:
    """The argument bytes of a cell, from ``partition_spec`` per leaf."""
    mesh, rules = _duck(ms), shd.DEFAULT_RULES
    p = api.abstract_params(cfg)
    elems = sum(tree_leaves(tree_map(
        lambda x, ax: _local(x.shape, shd.partition_spec(
            mesh, rules, tuple(x.shape), tuple(ax)), ms),
        p, api.param_axes(cfg))))
    params = sum(tree_leaves(tree_map(
        lambda x, ax: _local(x.shape, shd.partition_spec(
            mesh, rules, tuple(x.shape), tuple(ax)), ms) * x.element_size(),
        p, api.param_axes(cfg))))
    specs = configs.input_specs(cfg, cell)
    batch = sum(_local(x.shape, shd.batch_spec(mesh, rules,
                                               batch_size=x.shape[0]), ms)
                * x.element_size() for x in specs.values())
    if cell.mode == "train":
        # fp32 moments m and v, the int32 step and the fp32 residual.
        return params + 2 * 4 * elems + 4 + 4 + batch
    if cell.mode == "prefill":
        return params + batch
    c = api.abstract_cache(cfg, cell.global_batch, cell.seq_len)
    cache = sum(tree_leaves(tree_map(
        lambda x, pl: _local_placed(x, pl, ms), c,
        shd.cache_sharding(mesh, rules, c))))
    return params + cache + batch


def _want_routes(cfg, mode) -> dict:
    if cfg.family == "ssm":
        return {}
    d = cfg.resolved_head_dim
    dv = d if cfg.fuse_attention_features else None
    out = {"global": "torch_psi" if mode == "decode" else ops.attention_route(
        cfg.slay_config(), d, dv, mode == "train", "cpu")}
    if cfg.local_global_period:
        out["local"] = "softmax"
    return out


REF_KEYS = set(REF.roofline.Roofline(1.0, 1.0, 1.0, 1, 1.0).report())


@pytest.mark.parametrize("arch", configs.ASSIGNED_ARCHS)
def test_every_cell_traces_at_two_layers_on_16x16(grid, arch):
    """Each cell ends ok, or skipped where the reference skips; its
    argument bytes are the sharding rules' local blocks; its roofline has
    the reference's keys; its routes are ``attention_route``'s."""
    recs = [r for r in grid["grid"] if r["arch"] == arch]
    assert [r["shape"] for r in recs] == [c.name for c in
                                          configs.SHAPE_CELLS]
    for rec, cell in zip(recs, configs.SHAPE_CELLS):
        ref_cfg = REF.configs.get_config(arch)
        skip = REF.dryrun._cell_is_skipped(ref_cfg,
                                           REF.configs.get_cell(cell.name))
        if skip:
            assert rec["status"] == "skipped" and rec["reason"] == skip
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        cfg = configs.get_config(arch, **(
            {"num_layers": 2, "enc_layers": 2}
            if configs.get_config(arch).enc_layers else {"num_layers": 2}))
        bpd = rec["bytes_per_device"]
        assert bpd["argument"] == _want_argument(cfg, cell,
                                                 MESHES["16x16"]), cell
        assert bpd["peak"] == bpd["argument"] + bpd["temp"] > 0
        assert set(rec["roofline"]) == REF_KEYS
        assert rec["roofline"]["chips"] == 256 and rec["world"] == 256
        assert rec["routes"] == _want_routes(cfg, cell.mode)
        assert rec["roofline"]["device_flops"] > 0
        assert (rec["scaled"] is None) == (cell.mode != "train")


def test_multi_pod_cell(grid):
    rec = grid["pod"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["mesh"], rec["world"], rec["roofline"]["chips"]) == (
        "2x16x16", 512, 512)
    cfg = configs.get_config("granite-20b", num_layers=2)
    cell = configs.get_cell("train_4k")
    assert rec["scaled"]["microbatches"] == REF.dryrun.default_microbatches(
        REF.configs.get_config("granite-20b", num_layers=2),
        REF.configs.get_cell("train_4k"), _duck(MESHES["2x16x16"]))
    assert rec["bytes_per_device"]["argument"] == _want_argument(
        cfg, cell, MESHES["2x16x16"])
    assert rec["collectives"]


@pytest.mark.parametrize("status,rc", [("FAILED", 1), ("ok", 0),
                                       ("skipped", 0)])
def test_main_exits_nonzero_on_a_failed_cell(monkeypatch, tmp_path, status,
                                             rc):
    """``main`` exits 1 when a cell's record says FAILED, else 0, and
    writes every record to ``--out``."""
    def cell(arch, shape, **kw):
        return {"arch": arch, "shape": shape, "mesh": "16x16",
                "status": status, "error": "made to fail",
                "reason": "made to skip"}

    monkeypatch.setattr(dryrun, "run_cell", cell)
    out = tmp_path / "grid.json"
    assert dryrun.main(["--arch", "qwen3-32b", "--both-meshes",
                        "--out", str(out)]) == rc
    recs = json.loads(out.read_text())
    assert len(recs) == 2 * len(configs.SHAPE_CELLS)
    assert {r["status"] for r in recs} == {status}
