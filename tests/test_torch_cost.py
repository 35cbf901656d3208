"""The port's per-device cost counter (``repro_torch.launch.cost``) against
the JAX package's HLO cost model (``repro.launch.hlo_cost``); the SLAY
kernels' meta branches against ``launch.roofline``'s counts; the ring
factors and the per-device counts on a ``fake`` world of 16 ranks (in one
subprocess: the fake world is process-global)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import hlo_cost
from repro.models import api as ref_api
from repro_torch import configs
from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import _build, decode_step, feature_map, slay_fused
from repro_torch.kernels import slay_scan
from repro_torch.launch import cost, roofline
from repro_torch.models import api
from repro_torch.train.loop import value_and_grad

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _chain(a, b, c, d):
    return ((a @ b) @ c) @ d


def _bmm(x, y):
    return x @ y


def _loop(x, w):
    for _ in range(10):
        x = x @ w
    return x


def _jax_loop(x, w):
    return jax.lax.fori_loop(0, 10, lambda i, x: x @ w, x)


# name -> (torch function, jnp function, the numpy operands' shapes)
PROGRAMS = {
    "chain3": (_chain, _chain, [(64, 128), (128, 96), (96, 256), (256, 32)]),
    "bmm": (_bmm, _bmm, [(6, 48, 80), (6, 80, 40)]),
    "loop10": (_loop, _jax_loop, [(64, 128), (128, 128)]),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_matmul_programs_match_hlo_cost(name):
    """FLOPs and the dots' bytes (the whole of these programs' HBM bytes)
    equal the reference's HLO count exactly, the loop's trip count
    included."""
    fn, jfn, shapes = PROGRAMS[name]
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    hlo = hlo_cost.analyze(
        jax.jit(jfn).lower(*map(jnp.asarray, arrays)).compile().as_text())
    mine = cost.analyze(fn, *(_meta(a.shape) for a in arrays))
    assert mine.flops == hlo.flops
    assert mine.hbm_bytes == hlo.hbm_bytes
    assert mine.coll_wire_bytes == 0


def test_softmax_smoke_forward_flops_within_one_percent():
    """slayformer's smoke forward under softmax (no kernel on either
    side): the port's FLOPs within 1% of the reference's HLO count. Every
    dot of both sides is a projection, an attention product or the
    unembedding, so the counts agree to the FLOP; any difference is
    named in the message."""
    B, L = 2, 32
    ref_cfg = ref_configs.get_smoke_config("slayformer-124m",
                                           dtype="float32",
                                           attn_kind="softmax")
    p_abs = ref_api.abstract_params(ref_cfg)
    toks = jax.ShapeDtypeStruct((B, L), jnp.int32)
    hlo = hlo_cost.analyze(jax.jit(
        lambda p, t: ref_api.forward(p, ref_cfg, {"tokens": t})).lower(
            p_abs, toks).compile().as_text())
    cfg = configs.get_smoke_config("slayformer-124m", dtype="float32",
                                   attn_kind="softmax")
    mine = cost.analyze(api.forward, api.abstract_params(cfg), cfg,
                        _meta((B, L), torch.int32))
    assert abs(mine.flops - hlo.flops) <= 0.01 * hlo.flops, (
        mine.dot_flops_by_meta, hlo.dot_flops_by_meta)


# -- the kernels' meta branches -------------------------------------------

SMOKE = configs.get_smoke_config("slayformer-124m")
FCFG: SlayFeatureConfig = SMOKE.slay_config()
BH, BK, L, D = 8, 8, 64, SMOKE.resolved_head_dim
P, DP, R = FCFG.num_anchors, FCFG.num_prf, FCFG.num_quad_nodes
M = FCFG.feature_dim
BF = torch.bfloat16


def _k1():
    q, k, v = _meta((BH, L, D), BF), _meta((BK, L, D), BF), \
        _meta((BK, L, D), BF)
    y, den = slay_fused._launch(q, k, v, _meta((P, D)), _meta((DP, D)),
                                FCFG, 1e-6)
    assert (y.dtype, den.dtype, den.shape) == (BF, torch.float32, (BH, L))
    return roofline.k1_bound(BH, BK, L, D, D, P, DP, R, 2)


def _bwd(fn):
    def run():
        args = (_meta((BH, L, D), BF), _meta((BK, L, D), BF),
                _meta((BK, L, D), BF), _meta((P, D)), _meta((DP, D)),
                _meta((BH, L, D), BF), _meta((BH, L)), _meta((BH, L, D), BF))
        getattr(slay_fused, fn)(*args, FCFG)
        name = {"launch_bwd_q": "slay_fused_bwd_q",
                "launch_bwd_kv": "slay_fused_bwd_kv"}[fn]
        return roofline.bwd_bounds(BH, BK, L, D, D, P, DP, R, 2)[name]
    return run


def _k2(masked):
    def run():
        s, z = _meta((BK, M, D)), _meta((BK, M))
        active = _meta((BK,), torch.int32) if masked else None
        y, s2, z2 = decode_step.decode_linear_attention(
            _meta((BH, M), BF), _meta((BK, M), BF), _meta((BK, D), BF), s, z,
            active)
        assert s2 is s and z2 is z and y.shape == (BH, D)
        return roofline.k2_bound(BH, BK, BK, M, D, 2, 2)
    return run


def _scan(fn, name):
    def run():
        qf, kf, v = _meta((BH, L, M), BF), _meta((BK, L, M), BF), \
            _meta((BK, L, D), BF)
        if fn == "launch_fwd":
            slay_scan.launch_fwd(qf, kf, v)
        else:
            getattr(slay_scan, fn)(qf, kf, v, _meta((BH, L, D), BF),
                                   _meta((BH, L)), _meta((BH, L, D), BF))
        return roofline.scan_bounds(BH, BK, L, M, D, 2)[name]
    return run


def _fmap(bwd):
    def run():
        n = BH * L
        u = _meta((n, D), BF)
        if bwd:
            du, da, dw = feature_map.launch_bwd(u, _meta((P, D)),
                                                _meta((DP, D)),
                                                _meta((n, M), BF), FCFG)
            assert du.shape == (n, D) and da.dtype == torch.float32
        else:
            psi = feature_map.launch_fwd(u, _meta((P, D)), _meta((DP, D)),
                                         FCFG)
            assert psi.shape == (n, M) and psi.dtype == BF
        name = "feature_map_bwd" if bwd else "feature_map_fwd"
        return roofline.feature_map_bounds(n, D, P, DP, R, 2)[name]
    return run


BRANCHES = {
    "slay_fused_fwd": _k1,
    "slay_fused_bwd_q": _bwd("launch_bwd_q"),
    "slay_fused_bwd_kv": _bwd("launch_bwd_kv"),
    "slay_decode_step": _k2(False),
    "slay_decode_step_masked": _k2(True),
    "slay_scan_fwd": _scan("launch_fwd", "slay_scan_fwd"),
    "slay_scan_bwd_q": _scan("launch_bwd_q", "slay_scan_bwd_q"),
    "slay_scan_bwd_kv": _scan("launch_bwd_kv", "slay_scan_bwd_kv"),
    "feature_map_fwd": _fmap(False),
    "feature_map_bwd": _fmap(True),
}


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_meta_branch_records_its_roofline_count(name):
    """Each launch wrapper on meta tensors records one launch under the
    CUDA launch's key, with exactly its count function's operations and
    bytes, and allocates its outputs on meta."""
    _build.reset_launches()
    counter = cost.CostCounter()
    with counter:
        bound = BRANCHES[name]()
    assert counter.totals.kernels == {
        name: {"launches": 1, "flops": bound[2], "bytes": bound[3]}}
    assert _build.LAUNCHES[name] == 1
    assert counter.totals.flops == bound[2]


@pytest.fixture
def no_plain_versions(monkeypatch):
    """Every plain version of a kernel raises if called."""
    def refuse(*_a, **_k):
        raise AssertionError("a plain kernel version ran on meta")
    for mod, fn in ((slay_fused, "fused_causal_attention_plain"),
                    (slay_fused, "fused_causal_attention_bwd_plain"),
                    (slay_scan, "causal_linear_attention_plain"),
                    (slay_scan, "causal_linear_attention_bwd_plain"),
                    (feature_map, "feature_map_plain"),
                    (feature_map, "feature_map_bwd_plain"),
                    (decode_step, "decode_linear_attention_plain")):
        monkeypatch.setattr(mod, fn, refuse)


@pytest.mark.parametrize("remat", [True, False])
def test_meta_train_step_launches(no_plain_versions, remat):
    """A meta train step of the smoke model: one K3 and one K4 per layer,
    K1 once per layer, twice under remat (its backward reruns the
    forward); no plain version runs."""
    layers = SMOKE.num_layers
    batch = {"tokens": _meta((2, 32), torch.int32),
             "labels": _meta((2, 32), torch.int32)}
    _build.reset_launches()
    counter = cost.CostCounter()
    with counter:
        value_and_grad(api.abstract_params(SMOKE), SMOKE, batch, remat=remat)
    want = {"slay_fused_fwd": layers * (2 if remat else 1),
            "slay_fused_bwd_q": layers, "slay_fused_bwd_kv": layers}
    assert {k: v["launches"] for k, v in counter.totals.kernels.items()} \
        == want
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    assert counter.peak_bytes > 0


def test_meta_decode_step_one_k2_per_layer(no_plain_versions):
    cache = api.abstract_cache(SMOKE, 4, 64)
    counter = cost.CostCounter()
    with counter, torch.no_grad():
        api.decode_step(api.abstract_params(SMOKE), SMOKE, cache,
                        _meta((4, 1), torch.int32))
    assert {k: v["launches"] for k, v in counter.totals.kernels.items()} \
        == {"slay_decode_step": SMOKE.num_layers}


# -- a fake world of 16 ranks ---------------------------------------------

_WORLD = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import cost
from repro_torch.launch.dryrun import fake_world

torch.set_num_threads(1)
out = {}
with fake_world(16):
    g = dist.group.WORLD
    t = torch.empty(1024, device="meta")
    calls = {
        "all-gather": lambda: funcol.all_gather_tensor(t, 0, g),
        "reduce-scatter": lambda: funcol.reduce_scatter_tensor(t, "sum", 0, g),
        "all-reduce": lambda: funcol.all_reduce(t, "sum", g),
        "all-to-all": lambda: funcol.all_to_all_single(t, None, None, g),
    }
    for kind, fn in calls.items():
        tot = cost.analyze(fn)
        out[kind] = {"by_kind": tot.coll_by_kind,
                     "wire": tot.coll_wire_bytes, "hbm": tot.hbm_bytes}
mesh_out = {}
with fake_world(256):
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    M, K, N = 512, 1024, 768
    a = DTensor.from_local(torch.empty(M // 16, K, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    b = DTensor.from_local(torch.empty(K, N // 16, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    tot = cost.analyze(torch.mm, a, b)
    mesh_out = {"flops": tot.flops, "global": 2 * M * N * K,
                "hbm": tot.hbm_bytes, "wire": tot.coll_wire_bytes}
json.dump({"rings": out, "mesh": mesh_out}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    path = tmp_path_factory.mktemp("cost") / "world.json"
    subprocess.run([sys.executable, "-c", _WORLD, str(path)], check=True,
                   timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    return json.loads(path.read_text())


@pytest.mark.parametrize("kind,factor", [
    ("all-gather", 15 / 16 * 16 * 4096), ("reduce-scatter", 15 / 16 * 4096),
    ("all-reduce", 2 * 15 / 16 * 4096), ("all-to-all", 15 / 16 * 4096)])
def test_ring_factors_by_hand(world, kind, factor):
    """1024 fp32 values (4096 bytes) over a group of 16: the reference's
    ring factors, filed under the reference's kind."""
    rec = world["rings"][kind]
    assert rec["by_kind"] == {kind: factor}
    assert rec["wire"] == factor
    assert rec["hbm"] > 0


def test_per_device_flops_are_one_256th(world):
    """A Shard(0) x Shard(1) matmul on a (16, 16) mesh counts the local
    block's FLOPs, 1/256 of the global, and moves nothing."""
    m = world["mesh"]
    assert m["flops"] * 256 == m["global"]
    assert m["wire"] == 0
    assert m["hbm"] == 4 * (512 // 16 * 1024 + 1024 * 768 // 16
                            + 512 // 16 * 768 // 16)
