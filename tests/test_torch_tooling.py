"""The port's tooling against the JAX package: the shape cells,
``input_specs``, the parameter counts and ``model_flops_for`` for all 11
configs, the H100 ``Roofline``, and the kernels' bounds pinned.

``input_specs``' dtypes map the reference's onto the port's: int32 tokens
and labels stay ``torch.int32`` (the port's batches,
``data.pipeline``); bf16 and fp32 activations (patch and frame
embeddings) are ``torch.bfloat16`` and ``torch.float32``. Every port
tensor lies on the ``meta`` device.

The bounds are the values ``chip_smoke.py``'s own copies of these
functions gave at slayformer-124m's shapes before they moved to
``repro_torch.launch.roofline`` (bf16; K1: BH = 48, L = 512, and the
training shape BH = 96, L = 1024; K2: 48 kv rows, qf fp32, and the pool's
96 with 24 active; K3, K4, B5-B6b: BH = 96, L = 1024, m = 384; B7, B8:
N = 98,304), equal to the last bit.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jroof
from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as troof

torch.set_num_threads(1)    # small ops; the suite runs one process per core

ARCHS = tuple(jconfigs.ALL_ARCHS)
CELLS = tuple(c.name for c in jconfigs.SHAPE_CELLS)
DTYPES = {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32,
          "bfloat16": torch.bfloat16}


def test_exports_and_cells_match_the_reference():
    assert sorted(tconfigs.__all__) == sorted(jconfigs.__all__)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert [tuple(vars(c).values()) for c in tconfigs.SHAPE_CELLS] == \
        [tuple(vars(c).values()) for c in jconfigs.SHAPE_CELLS]
    for name in CELLS:
        assert vars(tconfigs.get_cell(name)) == vars(jconfigs.get_cell(name))
    with pytest.raises(KeyError):
        tconfigs.get_cell("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert t.param_count_dense == j.param_count_dense
    assert t.active_param_count == j.active_param_count
    ts, js = tconfigs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    assert ts.param_count_dense == js.param_count_dense
    assert ts.active_param_count == js.active_param_count


def _dtype(x):
    key = "bfloat16" if str(x.dtype) == "bfloat16" else np.dtype(x.dtype)
    return DTYPES[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_model_flops_match_the_reference(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for name in CELLS:
        tc, jc = tconfigs.get_cell(name), jconfigs.get_cell(name)
        got, want = tconfigs.input_specs(t, tc), jconfigs.input_specs(j, jc)
        assert list(got) == list(want)
        for key, spec in want.items():
            assert tuple(got[key].shape) == tuple(spec.shape), key
            assert got[key].dtype == _dtype(spec), key
            assert got[key].device.type == "meta"
        assert troof.model_flops_for(t, tc) == jroof.model_flops_for(j, jc)


def test_roofline_terms_by_hand():
    r = troof.Roofline(flops=2.0e15, hbm_bytes=6.7e12, coll_bytes=9.0e11,
                       chips=4, model_flops=4.0e15,
                       coll_by_kind={"all-reduce": 9.0e11})
    assert r.t_compute == 2.0e15 / 989e12
    assert r.t_memory == 6.7e12 / 3.35e12 == 2.0
    assert r.t_collective == 9.0e11 / 450e9 == 2.0
    assert r.dominant == "compute"
    assert r.useful_flop_ratio == 4.0e15 / (2.0e15 * 4)
    assert r.t_useful == 4.0e15 / (4 * 989e12)
    assert r.roofline_fraction == r.t_useful / r.t_compute
    rep = r.report()
    want = jroof.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0, chips=1,
                          model_flops=1.0).report()
    assert list(rep) == list(want)
    assert rep["coll_by_kind"] == {"all-reduce": 9.0e11}
    assert rep["roofline_fraction"] == r.roofline_fraction
    idle = troof.Roofline(0.0, 0.0, 0.0, 1, 0.0)
    assert idle.useful_flop_ratio == 0.0 and idle.roofline_fraction == 0.0
    assert troof.HBM_PER_CARD == 80e9
    assert (troof.FP32_FLOP_PER_S, troof.TF32_FLOP_PER_S) == (67e12, 495e12)


SL = (64, 64, 8, 16, 3)      # d, dv, P, D, R of slayformer-124m
BOUNDS = {
    "_psi_ops": (troof._psi_ops(64, 8, 16, 3), (4240, 8872)),
    "_bound": (troof._bound(1e9, 1e8),
               (0.029850746268656716, "bytes", 1e9, 1e8)),
    "_tc_bound": (troof._tc_bound(troof._bound(3e9, 1e6), 2e9),
                  (0.02704658525554048, "operations", 3e9, 1e6)),
    "k1_bound": (troof.k1_bound(48, 48, 512, *SL, 2),
                 (0.0396150447761194, "operations", 2654208000, 12687360)),
    "k1_tc_bound": (troof.k1_tc_bound(48, 48, 512, *SL, 2),
                    (0.018198484650203527, "operations", 2654208000,
                     12687360)),
    "k1_tc_bound train": (troof.k1_tc_bound(96, 96, 1024, *SL, 2),
                          (0.07279393860081411, "operations", 10616832000,
                           50731008)),
    "k2_bound": (troof.k2_bound(48, 48, 48, 384, 64, 4, 2),
                 (0.0029087713432835818, "bytes", 4776960, 9744384)),
    "k2_bound pool": (troof.k2_bound(96, 96, 24, 384, 64, 4, 2),
                      (0.0014571367164179104, "bytes", 2388480, 4881408)),
    "bwd_bounds": (troof.bwd_bounds(96, 96, 1024, *SL, 2), {
        "slay_fused_bwd_q": (0.17166519402985075, "operations", 11501568000,
                             76486656),
        "slay_fused_bwd_kv": (0.24378218220895523, "operations",
                              16333406208, 89069568)}),
    "bwd_tc_bounds": (troof.bwd_tc_bounds(96, 96, 1024, *SL, 2), {
        "slay_fused_bwd_q": (0.08599895352618725, "operations", 11501568000,
                             76486656),
        "slay_fused_bwd_kv": (0.11528282145345999, "operations",
                              16333406208, 89069568)}),
    "scan_bounds": (troof.scan_bounds(96, 96, 1024, 384, 64, 2), {
        "slay_scan_fwd": (0.1460181205970149, "operations", 9783214080,
                          176553984),
        "slay_scan_bwd_q": (0.14620592525373136, "operations", 9795796992,
                            189136896),
        "slay_scan_bwd_kv": (0.2183229134328358, "operations", 14627635200,
                             277217280)}),
    "scan_tc_bounds": (troof.scan_tc_bounds(96, 96, 1024, 384, 64, 2), {
        "slay_scan_fwd": (0.06035188009335143, "operations", 9783214080,
                          176553984),
        "slay_scan_bwd_q": (0.060539684750067844, "operations", 9795796992,
                            189136896),
        "slay_scan_bwd_kv": (0.08982355267734057, "operations", 14627635200,
                             277217280)}),
    "feature_map_bounds": (troof.feature_map_bounds(98304, 64, 8, 16, 3, 2), {
        "feature_map_fwd": (0.026294485970149252, "bytes", 416808960,
                            88086528),
        "feature_map_bwd": (0.030052413134328358, "bytes", 1288962048,
                            100675584)}),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_kernel_bounds_pinned(name):
    got, want = BOUNDS[name]
    assert got == want
