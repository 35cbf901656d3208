"""Every CUDA kernel of the port against its plain PyTorch version, on the
card.

Needs an NVIDIA card and ``nvcc``; without one every test here skips.
Run on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

Nothing of JAX or the JAX package is imported (the card has no JAX): the
oracle is the port's own plain versions, which the other
``tests/test_torch_*.py`` files hold against the JAX package on the CPU.
The features config is the smoke config's (head dim 16, P = 8, D = 16,
R = 3). Tolerances per case: fp32 differs from the plain versions in
summation order only, bf16 by one rounding of each output. The exact
kinds (softmax, yat, yat_spherical) have no kernel: their serving on the
card is held to the CPU and graphed to eager, their training step to the
CPU's loss.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ServingConfig
from repro_torch.core import features as tfeat
from repro_torch.kernels import _build
from repro_torch.kernels import decode_step as tdecode
from repro_torch.kernels import feature_map as tfm
from repro_torch.kernels import slay_fused as tfused
from repro_torch.kernels import slay_scan as tscan
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import journal as tjournal
from repro_torch.serving.prefix_cache import tree_copy
from repro_torch.serving import sampling as tsampling
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_leaves

D_HEAD = 16
needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="CUDA kernel: needs an NVIDIA card (run python3 chip_smoke.py)")


def _cfg():
    """The smoke config's features (head dim D_HEAD)."""
    return get_smoke_config("slayformer-124m").slay_config()


def _decode_inputs(seed, bh, bk, m=24, dv=8):
    rng = np.random.default_rng(seed)
    qf = rng.uniform(0.0, 1.0, (bh, m)).astype(np.float32)
    kf = rng.uniform(0.0, 1.0, (bk, m)).astype(np.float32)
    v = rng.normal(size=(bk, dv)).astype(np.float32)
    s = rng.normal(size=(bk, m, dv)).astype(np.float32)
    z = rng.uniform(0.0, 4.0, (bk, m)).astype(np.float32)
    return qf, kf, v, s, z


# -- K1, K3, K4: the fused forward and its backward --------------------------


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_matches_plain_on_card(dtype):
    # K1 runs one block per (q head, quadrature node) and sums the node
    # shares in its epilogue. Cases: GQA at L = 96; ragged L = 90 (a
    # partial last tile of zero rows); head dim 128; P = 16, D = 24, R = 1
    # (past the shape limits of the one-node thread mappings of psi_rows,
    # so their default mapping runs); R = 2; head dim 12 with P·D = 12
    # (rows that are not a multiple of 16 bytes in bf16, Ψ padded to 16
    # columns). fp32: summation order only (1e-4); bf16: one rounding of
    # y (2e-2).
    tcfg = _cfg()
    cases = [(tcfg, 96, 32), (tcfg, 90, 90),
             (tfeat.SlayFeatureConfig(head_dim=128), 96, 32),
             (tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_anchors=16,
                                      num_prf=24, num_quad_nodes=1), 96, 32),
             (tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_quad_nodes=2), 90,
              90),
             (tfeat.SlayFeatureConfig(head_dim=12, num_anchors=3, num_prf=4),
              90, 90)]
    for cfg, L, chunk in cases:
        d = cfg.head_dim
        p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(8, L, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(4, L, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(4, L, 32, generator=gen, device="cuda").to(dtype)
        y, den = tfused.fused_causal_attention(q, k, v, p["anchors"],
                                               p["omegas"], cfg,
                                               chunk_size=chunk)
        yp, denp = tfused.fused_causal_attention_plain(
            q, k, v, p["anchors"], p["omegas"], cfg, chunk_size=chunk)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), yp.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(den, denp, rtol=1e-4, atol=0.0)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bwd_kernels_match_plain_on_card(dtype):
    # K3 and K4 against their plain twins, partials included; ragged L;
    # the default R = 3 quadrature nodes, R = 2 (the kernels' grid is one
    # block per q head and node), head dim 128 (the widest the kernels
    # take) and P = 16, D = 24 (past the shape limits of the one-node
    # thread mappings of psi_rows and psi_bwd_rows, so their default
    # mapping runs). fp32: summation order (1e-4 of each output's scale);
    # bf16: one rounding of dq/dk/dv partials to bf16 (1e-2 of scale).
    tcfg = _cfg()
    for cfg in (tcfg, tfeat.SlayFeatureConfig(head_dim=D_HEAD,
                                              num_quad_nodes=2),
                tfeat.SlayFeatureConfig(head_dim=128),
                tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_anchors=16,
                                        num_prf=24, num_quad_nodes=1)):
        d = cfg.head_dim
        p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(8, 90, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(4, 90, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(4, 90, 32, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(8, 90, 32, generator=gen, device="cuda").to(dtype)
        a, w = p["anchors"], p["omegas"]
        y, den = tfused.fused_causal_attention(q, k, v, a, w, cfg,
                                               chunk_size=90)
        args = (q, k, v, a, w, y, den, dy, cfg)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        for kern, plain in ((tfused.launch_bwd_q, tfused.fused_bwd_q_plain),
                            (tfused.launch_bwd_kv, tfused.fused_bwd_kv_plain)):
            got, want = kern(*args), plain(*args, chunk_size=90)
            for g, wnt in zip(got, want):
                scale = float(wnt.float().abs().max())
                torch.testing.assert_close(g.float(), wnt.float(), rtol=0.0,
                                           atol=tol * scale)


@needs_card
def test_fused_attention_refuses_backward_limits_before_forward():
    # What K3/K4 refuse (head dim not a multiple of 8, rows not on 16
    # bytes) is refused before K1 runs when the inputs need gradients, and
    # still runs forward-only without them.
    cfg = tfeat.SlayFeatureConfig(head_dim=12)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0))
    a, w = p["anchors"], p["omegas"]
    x = torch.randn(2, 16, 12, device="cuda")
    v = torch.randn(2, 16, 16, device="cuda")
    _build.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        tfused.fused_causal_attention(x.requires_grad_(True), x, v, a, w, cfg,
                                      chunk_size=16)
    assert _build.LAUNCHES["slay_fused_fwd"] == 0
    tfused.fused_causal_attention(x.detach(), x.detach(), v, a, w, cfg,
                                  chunk_size=16)
    assert _build.LAUNCHES["slay_fused_fwd"] == 1
    cfg, d = tfeat.SlayFeatureConfig(head_dim=16), 16
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0))
    buf = torch.randn(2 * 16 * d + 1, device="cuda")
    q = buf[1:].view(2, 16, d).requires_grad_(True)   # 4 bytes off
    k = torch.randn(2, 16, d, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfused.fused_causal_attention(q, k, v, p["anchors"], p["omegas"], cfg,
                                      chunk_size=16)
    assert _build.LAUNCHES["slay_fused_fwd"] == 1


# -- K2: the decode step ----------------------------------------------------


@needs_card
@pytest.mark.parametrize("masked", [False, True])
def test_decode_kernel_matches_plain_on_card(masked):
    args = [torch.from_numpy(x).cuda() for x in _decode_inputs(1, 8, 4, m=384,
                                                               dv=64)]
    active = (torch.tensor([1, 0, 1, 1], dtype=torch.int32, device="cuda")
              if masked else None)
    plain = [a.clone() for a in args]
    yp, sp, zp = tdecode.decode_linear_attention_plain(*plain, active)
    y, s, z = tdecode.decode_linear_attention(*args, active)
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, sp, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(z, zp, rtol=1e-6, atol=1e-6)


@needs_card
@pytest.mark.parametrize("bh,bk,m,dv,masked", [
    (1024, 1024, 384, 64, False),   # 1024 clusters of 8, more than fit
    (64, 8, 390, 32, False),        # G = 8, slices of 49 and a last of 47
    (64, 8, 390, 16, True),         # G = 8, masked, whole clusters idle
    (96, 48, 384, 128, True),       # GQA G = 2, dv 128, masked
    (6, 3, 7, 64, False),           # m below one slice: one block a row
])
def test_decode_kernel_clusters_on_card(bh, bk, m, dv, masked):
    # K2 runs one thread-block cluster per kv row, its C <= 8 blocks
    # splitting the m feature rows. S' and z' keep the one-block
    # arithmetic (one rounded product, one add), so they equal the plain
    # version's; y sums the slices' partials in rank order: fp32
    # summation order only (1e-5). Inactive rows' S and z bit-identical,
    # their y zero.
    args = [torch.from_numpy(x).cuda() for x in _decode_inputs(2, bh, bk,
                                                               m=m, dv=dv)]
    active = None
    if masked:
        active = (torch.arange(bk, device="cuda") % 3 != 1).to(torch.int32)
    s0, z0 = args[3].clone(), args[4].clone()
    plain = [a.clone() for a in args]
    yp, sp, zp = tdecode.decode_linear_attention_plain(*plain, active)
    y, s, z = tdecode.decode_linear_attention(*args, active)
    assert s.data_ptr() == args[3].data_ptr() and z.data_ptr() == args[4].data_ptr()
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    assert torch.equal(s, sp) and torch.equal(z, zp)
    if masked:
        off = active == 0
        assert torch.equal(s[off], s0[off]) and torch.equal(z[off], z0[off])
        assert bool((y.reshape(bk, bh // bk, dv)[off] == 0).all())


@needs_card
@pytest.mark.parametrize("m,dtype,masked", [
    (64, torch.float32, False),     # favor's features (fp32 in bf16 models)
    (64, torch.bfloat16, True),     # elu1's, the pool's masked step
    (128, torch.bfloat16, False),   # cosformer's, its sin half zero
    (128, torch.bfloat16, True),
])
def test_decode_kernel_at_the_baselines_widths_on_card(m, dtype, masked):
    # The linear baselines decode through K2 at m = 64 (favor, elu1) and
    # m = 128 (cosformer, whose cache features are [relu(u), 0], ROADMAP
    # C-8), dv = 64, 96 kv rows; v fp32, so y differs from the plain
    # version in summation order only (1e-5), S' and z' not at all.
    qf, kf, v, s, z = (torch.from_numpy(x).cuda()
                       for x in _decode_inputs(3, 96, 96, m=m, dv=64))
    qf, kf = qf.to(dtype), kf.to(dtype)
    if m == 128:
        qf[:, 64:] = 0
        kf[:, 64:] = 0
    args = [qf, kf, v, s, z]
    active = None
    if masked:
        active = (torch.arange(96, device="cuda") % 4 != 1).to(torch.int32)
    s0, z0 = s.clone(), z.clone()
    plain = [a.clone() for a in args]
    yp, sp, zp = tdecode.decode_linear_attention_plain(*plain, active)
    _build.reset_launches()
    y, s2, z2 = tdecode.decode_linear_attention(*args, active)
    assert _build.LAUNCHES["slay_decode_step_masked" if masked
                           else "slay_decode_step"] == 1
    assert s2 is s and z2 is z
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    assert torch.equal(s, sp) and torch.equal(z, zp)
    if m == 128:
        assert torch.equal(s[:, 64:], s0[:, 64:])
    if masked:
        off = active == 0
        assert torch.equal(s[off], s0[off]) and torch.equal(z[off], z0[off])
        assert not y[off].any()


@needs_card
@pytest.mark.parametrize("kind", ["favor", "cosformer", "elu1"])
def test_baseline_engines_on_card_match_cpu(kind):
    # The smoke model of each linear baseline in fp32 (embedding scaled
    # down so the streams vary): the continuous engine (graphed, T = 0.8)
    # and the lockstep engine (greedy) on the card and on the CPU give the
    # same streams; on the card every decode step is one K2 launch per
    # layer (masked in the pool) and no SLAY kernel other than K2 runs.
    cfg = get_smoke_config("slayformer-124m", dtype="float32",
                           attn_kind=kind)
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (20, 7, 33, 12, 26)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4, temperature=0.8)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        lock = tengine.ServingEngine(cfg, params, device=device, max_len=64)
        _build.reset_launches()
        outs, s = eng.run([tengine.Request(p, max_new_tokens=10,
                                           arrival_time=2.0 * i)
                           for i, p in enumerate(prompts)])
        cont = dict(_build.LAUNCHES)
        _build.reset_launches()
        gen = lock.generate([tengine.Request(p, max_new_tokens=10)
                             for p in prompts[:3]])
        runs.append((outs, s, gen, cont, dict(_build.LAUNCHES)))
    (cpu, s_cpu, gen_cpu, _, _), (card, s_card, gen, cont, lock) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    for a, b in zip(gen, gen_cpu):
        np.testing.assert_array_equal(a, b)
    assert s_card["ticks"] == s_cpu["ticks"]
    nl = cfg.num_layers
    assert cont["slay_decode_step_masked"] == (
        nl * serving.macro_ticks * s_card["decode_dispatches"])
    assert lock["slay_decode_step"] == nl * 9
    others = {k: n for k, n in {**cont, **lock}.items()
              if n and k not in ("slay_decode_step",
                                 "slay_decode_step_masked")}
    assert not others, others
    assert cont["slay_decode_step"] == lock["slay_decode_step_masked"] == 0


# -- the dense decoders: head dim 128, any GQA group -------------------------


@needs_card
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 8, 48, 64])
def test_decode_kernel_any_group_at_head_dim_128_on_card(g, masked):
    # K2 at the decoders' head dim (dv = 128, m = 384) for every group:
    # phi4-mini's 3, qwen3's 8, granite's MQA 48, gemma2's 2, phi3.5-moe's
    # 4, grok-1's 6, and 1, 64 beside them. Past 8 q heads a block sums
    # the heads in tiles of 8, walking its slice again; S' and z' are
    # written once. v fp32: y differs from the plain version in summation
    # order only (1e-5), S' and z' not at all; drained rows
    # bit-identical, y zero.
    bk = 4 if g >= 48 else 16
    args = [torch.from_numpy(x).cuda()
            for x in _decode_inputs(4 + g, bk * g, bk, m=384, dv=128)]
    active = None
    if masked:
        active = (torch.arange(bk, device="cuda") % 3 != 1).to(torch.int32)
    s0, z0 = args[3].clone(), args[4].clone()
    plain = [a.clone() for a in args]
    yp, sp, zp = tdecode.decode_linear_attention_plain(*plain, active)
    _build.reset_launches()
    y, s, z = tdecode.decode_linear_attention(*args, active)
    assert _build.LAUNCHES["slay_decode_step_masked" if masked
                           else "slay_decode_step"] == 1
    assert s is args[3] and z is args[4]
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    assert torch.equal(s, sp) and torch.equal(z, zp)
    if masked:
        off = active == 0
        assert torch.equal(s[off], s0[off]) and torch.equal(z[off], z0[off])
        assert bool((y.reshape(bk, g, 128)[off] == 0).all())


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_at_head_dim_128_and_group_48_on_card(dtype):
    # K1, K3 and K4 at d = dv = 128 (one block per SM) with granite's MQA
    # group of 48 q heads on one kv head, two sequences, L = 256: each
    # against its plain version, and the backward summed over the group
    # as autograd returns it. fp32: summation order (1e-4, of each
    # output's scale in the backward); bf16: one rounding (2e-2 forward,
    # 1e-2 of scale backward).
    cfg = tfeat.SlayFeatureConfig(head_dim=128)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0))
    a, w = p["anchors"].cuda(), p["omegas"].cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(96, 256, 128, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, 256, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, 256, 128, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(96, 256, 128, generator=gen, device="cuda").to(dtype)
    y, den = tfused.fused_causal_attention(q, k, v, a, w, cfg)
    yp, denp = tfused.fused_causal_attention_plain(q, k, v, a, w, cfg)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(den, denp, rtol=1e-4, atol=0.0)
    args = (q, k, v, a, w, y, den, dy, cfg)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for kern, plain in ((tfused.launch_bwd_q, tfused.fused_bwd_q_plain),
                        (tfused.launch_bwd_kv, tfused.fused_bwd_kv_plain),
                        (tfused.fused_causal_attention_bwd,
                         tfused.fused_causal_attention_bwd_plain)):
        got, want = kern(*args), plain(*args)
        for g, wnt in zip(got, want):
            assert g.shape == wnt.shape
            scale = float(wnt.float().abs().max())
            torch.testing.assert_close(g.float(), wnt.float(), rtol=0.0,
                                       atol=tol * scale)


@needs_card
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-20b",
                                  "qwen3-32b"])
def test_dense_decoder_engines_on_card_match_cpu(arch):
    # Each dense decoder's smoke model (2 layers, head dim 16; G = 2, 4,
    # 2; qwen3 with qk-norm scales drawn away from zero) in fp32, embedding
    # scaled down so the streams vary: the continuous engine (graphed,
    # greedy) and the lockstep engine on the card and on the CPU give the
    # same streams; on the card every decode step is one K2 launch a
    # layer (masked in the pool), the lockstep prefill one K1 launch a
    # layer.
    cfg = get_smoke_config(arch, dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    if cfg.qk_norm:
        gen = torch.Generator().manual_seed(1)
        for name in ("q_norm", "k_norm"):
            leaf = params["layers"]["attn"][name]
            leaf.copy_(0.5 * torch.randn(leaf.shape, generator=gen))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (20, 7, 33, 12, 26)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        lock = tengine.ServingEngine(cfg, params, device=device, max_len=64)
        _build.reset_launches()
        outs, s = eng.run([tengine.Request(p, max_new_tokens=10,
                                           arrival_time=2.0 * i)
                           for i, p in enumerate(prompts)])
        cont = dict(_build.LAUNCHES)
        _build.reset_launches()
        gen_out = lock.generate([tengine.Request(p, max_new_tokens=10)
                                 for p in prompts[:3]])
        runs.append((outs, s, gen_out, cont, dict(_build.LAUNCHES)))
    (cpu, s_cpu, gen_cpu, _, _), (card, s_card, gen_card, cont, lock) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    for a, b in zip(gen_card, gen_cpu):
        np.testing.assert_array_equal(a, b)
    assert s_card["ticks"] == s_cpu["ticks"]
    nl = cfg.num_layers
    assert cont["slay_decode_step_masked"] == (
        nl * serving.macro_ticks * s_card["decode_dispatches"])
    assert lock["slay_decode_step"] == nl * 9
    assert lock["slay_fused_fwd"] == nl


@needs_card
@pytest.mark.parametrize("arch", ["gemma2-27b", "phi3.5-moe-42b-a6.6b",
                                  "grok-1-314b"])
def test_mixed_and_moe_engines_on_card_match_cpu(arch):
    # gemma2's smoke model (4 layers, 0 and 2 local with a 32-token
    # window, 1 and 3 global SLAY) and the MoE ones (2 layers of 4
    # experts, top 2) in fp32, embedding scaled down so the streams vary:
    # the continuous engine (graphed, greedy; a 45-token prompt wraps
    # gemma2's rings) and the lockstep engine on the card and on the CPU
    # give the same streams; only the SLAY layers launch the kernels (K2
    # once a SLAY layer and step, masked in the pool; K1 once a SLAY
    # layer in the lockstep prefill).
    cfg = get_smoke_config(arch, dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (20, 7, 45, 12, 26)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        lock = tengine.ServingEngine(cfg, params, device=device, max_len=64)
        _build.reset_launches()
        outs, s = eng.run([tengine.Request(p, max_new_tokens=10,
                                           arrival_time=2.0 * i)
                           for i, p in enumerate(prompts)])
        cont = dict(_build.LAUNCHES)
        _build.reset_launches()
        gen_out = lock.generate([tengine.Request(p, max_new_tokens=10)
                                 for p in prompts[:3]])
        runs.append((outs, s, gen_out, cont, dict(_build.LAUNCHES)))
    (cpu, s_cpu, gen_cpu, _, _), (card, s_card, gen_card, cont, lock) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    for a, b in zip(gen_card, gen_cpu):
        np.testing.assert_array_equal(a, b)
    assert s_card["ticks"] == s_cpu["ticks"]
    nl = int((tapi.layer_kinds(cfg) == 0).sum())
    assert nl == (2 if arch == "gemma2-27b" else cfg.num_layers)
    assert cont["slay_decode_step_masked"] == (
        nl * serving.macro_ticks * s_card["decode_dispatches"])
    assert lock["slay_decode_step"] == nl * 9
    assert lock["slay_fused_fwd"] == nl


# -- the SSM families: mamba2 (no attention) and hymba (G = 5) --------------


@needs_card
@pytest.mark.parametrize("masked", [False, True])
def test_decode_kernel_group_5_at_head_dim_64_on_card(masked):
    # K2 at hymba-1.5b's group (25 q heads on 5 kv heads) and head dim
    # (dv = 64, m = 384), 8 slots' kv rows: y to 1e-5 (summation order),
    # S' and z' equal to the plain version's, in place; drained rows
    # bit-identical, y zero.
    g, bk = 5, 40
    args = [torch.from_numpy(x).cuda()
            for x in _decode_inputs(21, bk * g, bk, m=384, dv=64)]
    active = None
    if masked:
        active = (torch.arange(bk, device="cuda") % 3 != 1).to(torch.int32)
    s0, z0 = args[3].clone(), args[4].clone()
    yp, sp, zp = tdecode.decode_linear_attention_plain(
        *[a.clone() for a in args], active)
    _build.reset_launches()
    y, s, z = tdecode.decode_linear_attention(*args, active)
    assert _build.LAUNCHES["slay_decode_step_masked" if masked
                           else "slay_decode_step"] == 1
    assert s is args[3] and z is args[4]
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    assert torch.equal(s, sp) and torch.equal(z, zp)
    if masked:
        off = active == 0
        assert torch.equal(s[off], s0[off]) and torch.equal(z[off], z0[off])
        assert bool((y.reshape(bk, g, 64)[off] == 0).all())


@needs_card
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssd_decode_step_graphed_writes_the_pool_on_card(arch):
    # The masked decode step of a 3-slot pool (slots 0 and 2 prefilled
    # and live, slot 1 prefilled and drained) captured in a CUDA graph
    # and replayed, beside the same step run eagerly on a copy of the
    # pool: the replay writes the pool's own SSD carry and conv tail
    # (every leaf keeps its storage), its logits and every leaf equal the
    # eager step's bit for bit, and the drained slot's leaves keep their
    # bytes.
    cfg = get_smoke_config(arch, dtype="float32")
    params = tapi.init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(2)
    with torch.inference_mode():
        pool = tapi.init_cache(cfg, 3, 64, device="cuda")
        for slot, n in enumerate((9, 14, 5)):
            toks = torch.from_numpy(rng.integers(3, 256, (1, n))
                                    .astype(np.int32)).cuda()
            _, one = tapi.prefill(params, cfg, toks, max_len=64)
            tapi.write_slot(cfg, pool, one, slot)
        tok = torch.tensor([[5], [6], [7]], dtype=torch.int32, device="cuda")
        act = torch.tensor([True, False, True], device="cuda")
        eager = tree_copy(pool)
        want, _ = tapi.decode_step(params, cfg, eager, tok, act)
        before = [t.clone() for t in tree_leaves(pool)]
        ptrs = [t.data_ptr() for t in tree_leaves(pool)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up, then restore
            tapi.decode_step(params, cfg, pool, tok, act)
        torch.cuda.current_stream().wait_stream(side)
        for t, b in zip(tree_leaves(pool), before):
            t.copy_(b)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = tapi.decode_step(params, cfg, pool, tok, act)
        for t, b in zip(tree_leaves(pool), before):   # capture ran nothing
            t.copy_(b)
        graph.replay()
        torch.cuda.synchronize()
    assert [t.data_ptr() for t in tree_leaves(pool)] == ptrs
    assert torch.equal(logits[act], want[act])
    assert int(pool.pos[1]) == 14 and int(pool.pos[0]) == 10
    for t, e, b in zip(tree_leaves(pool), tree_leaves(eager), before):
        assert torch.equal(t, e)
        if t.dim() > 1:                      # (nl, B, ...): slot 1 kept
            assert torch.equal(t[:, 1], b[:, 1])
    h0 = before[[id(t) for t in tree_leaves(pool)].index(id(pool.ssm.h))]
    assert not torch.equal(pool.ssm.h[:, 0], h0[:, 0])


@needs_card
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_engines_on_card_match_cpu(arch):
    # The smoke models in fp32, embedding scaled down so the streams
    # vary: the continuous engine (graphed, greedy; a 70-token prompt
    # past max_len, which the constant-size carry admits) and the
    # lockstep engine on the card and on the CPU give the same streams;
    # mamba2 launches no kernel, hymba K2 once a layer and step (masked
    # in the pool) and K1 once a layer in the lockstep prefill.
    cfg = get_smoke_config(arch, dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (20, 7, 70, 12, 26)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        lock = tengine.ServingEngine(cfg, params, device=device, max_len=64)
        _build.reset_launches()
        outs, s = eng.run([tengine.Request(p, max_new_tokens=10,
                                           arrival_time=2.0 * i)
                           for i, p in enumerate(prompts)])
        cont = dict(_build.LAUNCHES)
        _build.reset_launches()
        gen_out = lock.generate([tengine.Request(p, max_new_tokens=10)
                                 for p in prompts[:2]])
        runs.append((outs, s, gen_out, cont, dict(_build.LAUNCHES),
                     eng.graph_cache_entries()))
    (cpu, s_cpu, gen_cpu, _, _, _), (card, s_card, gen_card, cont, lock,
                                     graphs) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    for a, b in zip(gen_card, gen_cpu):
        np.testing.assert_array_equal(a, b)
    assert s_card["ticks"] == s_cpu["ticks"]
    assert graphs == {"macro_decode": 1, "chunk": 1}
    nl = cfg.num_layers if cfg.family == "hybrid" else 0
    assert cont["slay_decode_step_masked"] == (
        nl * serving.macro_ticks * s_card["decode_dispatches"])
    assert lock["slay_decode_step"] == nl * 9
    assert lock["slay_fused_fwd"] == nl
    assert sum(cont.values()) == cont["slay_decode_step_masked"]


# -- B7, B8, B5, B6a, B6b: the two-dispatch path -----------------------------


@needs_card
@pytest.mark.parametrize("n", [1000, 40001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_map_kernels_match_plain_on_card(dtype, n):
    # Ragged N; at N = 40001 each warp of B8's persistent grid walks
    # several tokens. Ψ and du: fp32 summation order (1e-5), bf16 one step
    # (2^-7 relative); dA, dΩ stay fp32 sums over N tokens (1e-4 of
    # scale).
    tcfg = _cfg()
    p = tfeat.init_feature_params(tcfg, torch.Generator().manual_seed(0),
                                  device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn(n, D_HEAD, generator=gen, device="cuda").to(dtype)
    dpsi = torch.randn(n, tcfg.feature_dim, generator=gen,
                       device="cuda").to(dtype)
    a, w = p["anchors"], p["omegas"]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(tfm.launch_fwd(u, a, w, tcfg).float(),
                               tfm.feature_map_plain(u, a, w, tcfg).float(),
                               rtol=tol, atol=1e-6)
    got = tfm.feature_map_bwd(u, a, w, dpsi, tcfg)
    want = tfm.feature_map_bwd_plain(u, a, w, dpsi, tcfg)
    for g, wnt in zip(got, want, strict=True):
        scale = float(wnt.float().abs().max())
        torch.testing.assert_close(g.float(), wnt.float(), rtol=0.0,
                                   atol=max(tol, 1e-4) * scale)


# B7's cases, (name, features config, N, u's offset in elements): N = 1,
# under one tile (32 tokens), ragged, and more tiles than its persistent
# grid has blocks, so that each block walks several; head dim 128; P + D =
# 40 (two rounds of projections a lane); one and eight quadrature nodes;
# head dim 15 with P = 3, D = 4 (rows of u not on 16 bytes: plain loads;
# in bf16 Ψ's 4-column anchor blocks are 8 bytes: plain stores); and a
# contiguous u at an offset of one element (not on 16 bytes).
FWD_CASES = [
    ("N=1", None, 1, 0),
    ("N=20", None, 20, 0),
    ("N=1000", None, 1000, 0),
    ("N=200001", None, 200001, 0),
    ("d=128", tfeat.SlayFeatureConfig(head_dim=128), 3001, 0),
    ("P+D=40", tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_anchors=16,
                                       num_prf=24, num_quad_nodes=1), 3001, 0),
    ("R=8", tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_quad_nodes=8), 777,
     0),
    ("d=15", tfeat.SlayFeatureConfig(head_dim=15, num_anchors=3, num_prf=4),
     777, 0),
    ("offset u", None, 777, 1),
]


@needs_card
@pytest.mark.parametrize("name,cfg,n,offset", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_map_fwd_shapes_on_card(dtype, name, cfg, n, offset):
    # Ψ of B7 against its plain version at the shapes its design splits
    # on; tolerances as the test above.
    cfg = cfg or _cfg()
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                  device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randn(offset + n * cfg.head_dim, generator=gen,
                      device="cuda").to(dtype)
    u = buf[offset:].view(n, cfg.head_dim)
    assert u.is_contiguous() and (u.data_ptr() % 16 != 0) == (offset > 0)
    a, w = p["anchors"], p["omegas"]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(tfm.launch_fwd(u, a, w, cfg).float(),
                               tfm.feature_map_plain(u, a, w, cfg).float(),
                               rtol=tol, atol=1e-6)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_map_bwd_shapes_on_card(dtype):
    # B8 at the shapes its instantiations split on: head dim 64 (two
    # columns a lane, the dA/dΩ sums in registers) with more tokens than
    # its persistent grid has warps, head dim 128 (four columns a lane,
    # the sums in shared memory), P + D = 40 (two rounds of projections,
    # items looping over the lanes), and head dim 15 with P = 3, D = 4,
    # whose rows do not start on 16 bytes (plain copies in place of
    # cp.async). Tolerances as the test above.
    cases = [(tfeat.SlayFeatureConfig(head_dim=64), 50001),
             (tfeat.SlayFeatureConfig(head_dim=128), 3001),
             (tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_anchors=16,
                                      num_prf=24, num_quad_nodes=1), 3001),
             (tfeat.SlayFeatureConfig(head_dim=15, num_anchors=3, num_prf=4),
              777)]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for cfg, n in cases:
        p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                      device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        u = torch.randn(n, cfg.head_dim, generator=gen,
                        device="cuda").to(dtype)
        dpsi = torch.randn(n, cfg.feature_dim, generator=gen,
                           device="cuda").to(dtype)
        a, w = p["anchors"], p["omegas"]
        got = tfm.feature_map_bwd(u, a, w, dpsi, cfg)
        want = tfm.feature_map_bwd_plain(u, a, w, dpsi, cfg)
        for g, wnt in zip(got, want, strict=True):
            scale = float(wnt.float().abs().max())
            torch.testing.assert_close(g.float(), wnt.float(), rtol=0.0,
                                       atol=max(tol, 1e-4) * scale)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_match_plain_on_card(dtype):
    # GQA, ragged L = 90. B5, B6a and B6b run one block per (q head, slice
    # of 128 feature columns): m = 96 is one slice padded with zero columns;
    # m = 390 is three full slices and a partial one, and its rows do not
    # start on 16 bytes (narrower copies); in bf16 the rows of m = 45 do
    # not start on 4 bytes (plain loads). y: fp32 summation order
    # (1e-4), bf16 one rounding (2e-2); den fp32 (1e-4 relative); dq, dk,
    # dv partials 1e-4 (fp32) or 1e-2 (bf16) of scale.
    for m in (96, 390, 45):
        gen = torch.Generator(device="cuda").manual_seed(0)
        qf = torch.rand(8, 90, m, generator=gen, device="cuda").to(dtype)
        kf = torch.rand(4, 90, m, generator=gen, device="cuda").to(dtype)
        v = torch.randn(4, 90, 32, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(8, 90, 32, generator=gen, device="cuda").to(dtype)
        y, den = tscan.launch_fwd(qf, kf, v)
        yp, denp = tscan.causal_linear_attention_plain(qf, kf, v,
                                                       chunk_size=90)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), yp.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(den, denp, rtol=1e-4, atol=0.0)
        args = (qf, kf, v, y, den, dy)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        got = (tscan.launch_bwd_q(*args), *tscan.launch_bwd_kv(*args))
        want = (tscan.scan_bwd_q_plain(*args, chunk_size=90),
                *tscan.scan_bwd_kv_plain(*args, chunk_size=90))
        for g, wnt in zip(got, want, strict=True):
            scale = float(wnt.float().abs().max())
            torch.testing.assert_close(g.float(), wnt.float(), rtol=0.0,
                                       atol=tol * scale)


# -- sampling and the continuous engine ----------------------------------------


@needs_card
def test_threefry_on_card_matches_numpy():
    # Keys and words bit for bit; Gumbel noise within 4 ulp of
    # max(|g|, 1) (each side's own logarithms; see test_torch_sampling).
    eps = float(np.finfo(np.float32).eps)
    rids = torch.arange(4, dtype=torch.int32, device="cuda")
    for seed in (0, 1, 2 ** 31 + 5):
        for idx in (0, 1, 13):
            keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), rids), idx)
            bits = prng.random_bits(keys, (1000,))
            g = tsampling._gumbel_row(seed, rids, idx, 50257)
            for r in range(4):
                want = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), r), idx)
                np.testing.assert_array_equal(
                    keys[r].cpu().numpy().astype(np.uint32), want)
                np.testing.assert_array_equal(
                    bits[r].cpu().numpy().astype(np.uint32),
                    prng.random_bits(want, (1000,)))
                gw = tsampling._gumbel_row(seed, r, idx, 50257)
                err = (np.abs(g[r].cpu().numpy() - gw)
                       / (eps * np.maximum(np.abs(gw), 1.0)))
                assert err.max() <= 4, (seed, r, idx, err.max())


@needs_card
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_continuous_engine_on_card_matches_cpu(temperature):
    # The smoke model in fp32 (embedding scaled down so the streams vary)
    # through ContinuousServingEngine on the card and on the CPU: the same
    # streams and schedule; on the card one masked decode launch per layer
    # and tick of every dispatch, and no fused-forward launch (the chunked
    # prefill is torch code).
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (20, 7, 33, 12, 26)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4, temperature=temperature)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        _build.reset_launches()
        outs, s = eng.run([tengine.Request(p, max_new_tokens=10,
                                           arrival_time=2.0 * i)
                           for i, p in enumerate(prompts)])
        runs.append((outs, s, dict(_build.LAUNCHES)))
    (cpu, s_cpu, _), (card, s_card, launches) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    assert s_card["ticks"] == s_cpu["ticks"]
    assert launches["slay_decode_step_masked"] == (
        cfg.num_layers * serving.macro_ticks * s_card["decode_dispatches"])
    assert launches["slay_fused_fwd"] == launches["slay_decode_step"] == 0


@needs_card
def test_prefix_cache_and_restore_on_card_match_cpu(tmp_path):
    # The smoke model in fp32 with a prefix cache and a journal on the
    # card: a run that crashes (its first step from tick 24) after a
    # checkpoint with a request resident, then restore on the card from
    # the directory; every stream equal to the same engine's on the CPU
    # with no crash, and the prefix cache hit on both.
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    shared = rng.integers(3, 256, 16)
    prompts = [np.concatenate([shared, rng.integers(3, 256, n)])
               .astype(np.int32) for n in (5, 9, 3, 12)]
    prompts.append(prompts[0])
    arrivals = (0.0, 2.0, 4.0, 6.0, 70.0)
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4, temperature=0.8,
                            prefix_cache_bytes=1 << 24,
                            checkpoint_every_ticks=6, debug_audit=True)

    def trace():
        return [tengine.Request(p, max_new_tokens=10, arrival_time=a)
                for p, a in zip(prompts, arrivals)]

    cpu_eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device="cpu")
    want, s_cpu = cpu_eng.run(trace())
    jr = tjournal.Journal(str(tmp_path / tjournal.JOURNAL_NAME))
    eng = tengine.ContinuousServingEngine(
        cfg, params, serving=serving, device="cuda", journal=jr,
        fault_injector=tfaults.FaultInjector(seed=3, crash_window=(24, 28)))
    with pytest.raises(tfaults.EngineCrash):
        eng.run(trace())
    assert eng.metrics.checkpoints_written >= 1
    _build.reset_launches()
    eng2 = tengine.ContinuousServingEngine.restore(
        str(tmp_path), cfg, params, serving=serving, device="cuda")
    rec = eng2.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    assert eng2.pool.attn.s.is_cuda and len(eng2.prefix_cache) > 0
    # The graphs are captured after restore, over the restored pool.
    assert eng2.graph_cache_entries() == {"macro_decode": 0, "chunk": 0}
    ptrs = [t.data_ptr() for t in tree_leaves(eng2.pool)]
    got, s = eng2.run()
    assert eng2.graph_cache_entries()["macro_decode"] == 1
    assert ptrs == [t.data_ptr() for t in tree_leaves(eng2.pool)]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], f"rid {rid}")
    assert s_cpu["prefix_hits"] == 4 and s["tokens_replayed"] > 0
    assert s["final_occupancy"] == 0
    assert _build.LAUNCHES["slay_decode_step_masked"] == (
        cfg.num_layers * serving.macro_ticks * s["decode_dispatches"])



def _side_by_side(engines, reqs):
    """Step ``engines`` (the same config, one graphed, one not) in turn on
    copies of ``reqs`` until all are idle; after every round their pools
    (a speculative engine's draft pool too) must be byte-identical and
    the first engine's pool must keep its tensors. Each engine's outputs,
    summary and launch counts."""
    launches = [collections.Counter() for _ in engines]
    for eng in engines:
        for r in reqs:
            eng.submit(dataclasses.replace(r))
    ptrs = [t.data_ptr() for t in tree_leaves(engines[0].pool)]

    def busy(e):
        return bool(e.sched.active or e.sched.ready or e.sched.waiting
                    or e._prefill)

    while any(busy(e) for e in engines):
        for eng, n in zip(engines, launches):
            before = dict(_build.LAUNCHES)
            eng.step()
            n.update({k: v - before[k] for k, v in _build.LAUNCHES.items()})
        for a, b in zip(*(tree_leaves({"p": e.pool, "d": e.draft_pool})
                          for e in engines[:2])):
            assert torch.equal(a, b)
        assert ptrs == [t.data_ptr() for t in tree_leaves(engines[0].pool)]
    return [(eng.run(), dict(n)) for eng, n in zip(engines, launches)]


@needs_card
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graphed_engine_matches_eager_on_card(temperature):
    # The smoke model in fp32 on the card: the engine that replays one
    # CUDA graph per decode dispatch and per full prefill chunk against
    # the same engine run eagerly, stepped side by side. The pools are
    # byte-identical after every step (so the first dispatch, eager and
    # then captured, and every replay did what the eager engine did), the
    # streams and launch counts are equal, and one graph of each program
    # serves every dispatch and chunk.
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    reqs = [tengine.Request(rng.integers(3, 256, n).astype(np.int32),
                            max_new_tokens=10, arrival_time=2.0 * i)
            for i, n in enumerate((20, 7, 33, 12, 26))]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4, temperature=temperature)
    engines = [tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                               device="cuda", _graphs=g)
               for g in (True, False)]
    ((graphed, sg), ng), ((eager, se), ne) = _side_by_side(engines, reqs)
    assert set(graphed) == set(eager) == set(range(len(reqs)))
    for rid in eager:
        np.testing.assert_array_equal(graphed[rid], eager[rid], f"rid {rid}")
    assert sg["ticks"] == se["ticks"] and sg["decode_dispatches"] > 4
    assert ng == ne and ng["slay_decode_step_masked"] == (
        cfg.num_layers * serving.macro_ticks * sg["decode_dispatches"])
    assert engines[0].graph_cache_entries() == {"macro_decode": 1,
                                                "chunk": 1}
    assert engines[1].graph_cache_entries() == {"macro_decode": 0,
                                                "chunk": 0}
    assert engines[0]._decode.launches == {
        "slay_decode_step_masked": cfg.num_layers * serving.macro_ticks}


@needs_card
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lockstep_graph_matches_eager_on_card(temperature):
    # The lockstep decode step (model and sampler, its key in a device
    # buffer) replayed as one graph per batch size and temperature against
    # the same engine run eagerly: equal tokens and decode launches, and
    # a second batch of the same size replays the same graph.
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(3)
    batches = [[rng.integers(1, 256, n).astype(np.int32) for n in ns]
               for ns in ((9, 14, 5), (11, 3, 8))]
    runs = []
    for g in (True, False):
        eng = tengine.ServingEngine(cfg, params, device="cuda", max_len=64,
                                    _graphs=g)
        outs = []
        _build.reset_launches()
        for batch in batches:
            outs.append(eng.generate([tengine.Request(p, max_new_tokens=12)
                                      for p in batch],
                                     temperature=temperature, seed=3))
        runs.append((outs, dict(_build.LAUNCHES), eng.graph_cache_entries()))
    (graphed, ng, cg), (eager, ne, ce) = runs
    for a, b in zip(graphed, eager):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert ng == ne and ng["slay_decode_step"] == 2 * cfg.num_layers * 11
    assert cg == {"decode": 1} and ce == {"decode": 0}


@needs_card
@pytest.mark.parametrize("kind,page_size", [
    ("softmax", 0), ("softmax", 8), ("yat_spherical", 8)],
    ids=["softmax-ring", "softmax-paged", "yat_spherical-paged"])
def test_exact_kind_engines_graphed_match_eager_on_card(kind, page_size):
    # The smoke model of an exact kind in fp32, its KV ring unpaged or in
    # 8-row pages: the graphed engine and the eager one stepped side by
    # side on the card (pools, page tables included, byte-identical after
    # every step), both equal to the CPU engine's streams; no SLAY kernel;
    # no page left allocated. Then the lockstep engine, graphed and eager.
    cfg = get_smoke_config("slayformer-124m", dtype="float32",
                           attn_kind=kind)
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    reqs = [tengine.Request(rng.integers(3, 256, n).astype(np.int32),
                            max_new_tokens=10, arrival_time=2.0 * i)
            for i, n in enumerate((20, 7, 33, 12, 26))]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4, page_size=page_size,
                            num_pages=12 if page_size else 0,
                            debug_audit=True)
    want, s_cpu = tengine.ContinuousServingEngine(
        cfg, params, serving=serving, device="cpu").run(
            [dataclasses.replace(r) for r in reqs])
    engines = [tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                               device="cuda", _graphs=g)
               for g in (True, False)]
    _build.reset_launches()
    ((graphed, sg), ng), ((eager, se), ne) = _side_by_side(engines, reqs)
    for rid in want:
        np.testing.assert_array_equal(graphed[rid], want[rid], f"rid {rid}")
        np.testing.assert_array_equal(eager[rid], want[rid], f"rid {rid}")
    assert sg["ticks"] == se["ticks"] == s_cpu["ticks"]
    assert not any(_build.LAUNCHES.values())
    assert not any(ng.values()) and not any(ne.values())
    assert engines[0].graph_cache_entries() == {"macro_decode": 1,
                                                "chunk": 1}
    assert sg["final_pages_in_use"] == 0
    if page_size:
        assert 0 < sg["pages_peak"] <= 12
    prompts = [r.prompt for r in reqs[:3]]
    lock = [tengine.ServingEngine(cfg, params, device="cuda", max_len=64,
                                  _graphs=g).generate(
        [tengine.Request(p, max_new_tokens=8) for p in prompts])
        for g in (True, False)]
    for a, b in zip(*lock):
        np.testing.assert_array_equal(a, b)


@needs_card
@pytest.mark.parametrize("temperature,page_size", [(0.0, 0), (0.8, 8)],
                         ids=["greedy", "sampled-paged"])
def test_speculative_engine_graphed_matches_eager_on_card(temperature,
                                                         page_size):
    # Draft-verify decoding of the yat_spherical smoke model in fp32 (its
    # SLAY twin the draft, gamma = 2): the engine that replays one CUDA
    # graph per K-round dispatch against the same engine run eagerly,
    # stepped side by side (both pools byte-identical after every step);
    # equal streams, and greedy the CPU engine's streams (every token the
    # verifier's argmax); the masked decode kernel K x (2 gamma + 1) x
    # layers times a dispatch (gamma draft steps, gamma + 1 resync steps),
    # per replay of the graph too; no page left allocated.
    cfg = get_smoke_config("slayformer-124m", dtype="float32",
                           attn_kind="yat_spherical")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    reqs = [tengine.Request(rng.integers(3, 256, n).astype(np.int32),
                            max_new_tokens=12, arrival_time=2.0 * i)
            for i, n in enumerate((20, 7, 33, 12, 26))]
    G, K = 2, 4
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=K, temperature=temperature,
                            speculative=True, spec_gamma=G,
                            page_size=page_size, debug_audit=True)
    engines = [tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                               device="cuda", _graphs=g)
               for g in (True, False)]
    ((graphed, sg), ng), ((eager, se), ne) = _side_by_side(engines, reqs)
    assert set(graphed) == set(eager) == set(range(len(reqs)))
    for rid in eager:
        np.testing.assert_array_equal(graphed[rid], eager[rid], f"rid {rid}")
    for k in ("ticks", "decode_dispatches", "draft_tokens_proposed",
              "draft_tokens_accepted", "tokens_generated"):
        assert sg[k] == se[k], k
    per = cfg.num_layers * K * (2 * G + 1)
    assert sg["decode_dispatches"] > 2 and sg["draft_tokens_proposed"] > 0
    assert ng == ne and ng["slay_decode_step_masked"] == (
        per * sg["decode_dispatches"])
    assert not ng.get("slay_decode_step") and not ng.get("slay_fused_fwd")
    assert engines[0].graph_cache_entries() == {
        "macro_decode": 0, "chunk": 1, "spec_macro": 1}
    assert engines[0]._spec_decode.launches == {
        "slay_decode_step_masked": per}
    assert sg["final_pages_in_use"] == 0
    if temperature == 0.0:
        want, _ = tengine.ContinuousServingEngine(
            cfg, params, serving=serving, device="cpu").run(
                [dataclasses.replace(r) for r in reqs])
        for rid in want:
            np.testing.assert_array_equal(graphed[rid], want[rid],
                                          f"rid {rid}")


@needs_card
def test_softmax_train_step_on_card_is_finite_and_matches_cpu():
    # One AdamW step of the softmax smoke model in fp32 through plain
    # autograd on the card: a finite loss and gradient norm, equal to the
    # CPU's to 1e-5 and 1e-4 relative (the order of sums).
    cfg = get_smoke_config("slayformer-124m", dtype="float32",
                           attn_kind="softmax")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = tloop.make_train_step(cfg, ocfg, tloop.TrainConfig(remat=True))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tapi.init_params(cfg, 0, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        m = step(p, tadamw.adamw_init(p, ocfg), torch.zeros(()), b)[3]
        out[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert all(np.isfinite(out["cuda"]))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)


# -- the frontends: internvl2's vision prefix, whisper, bucketed prefill ----


@needs_card
@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-small"])
def test_frontend_engines_on_card_match_cpu(arch):
    # The smoke models in fp32, embedding scaled down so the streams
    # vary, behind the engines' zero stand-ins: the continuous engine
    # (graphed, greedy) and the lockstep engine on the card and on the
    # CPU give the same streams. internvl2 absorbs its 8-row prefix in
    # chunks and launches K2 once a layer and step (masked in the pool)
    # and K1 once a layer in the lockstep prefill; whisper prefills each
    # prompt whole (K1 once a decoder layer, B7 twice an encoder and a
    # decoder layer) and captures no chunk graph.
    cfg = get_smoke_config(arch, dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (20, 7, 30, 12)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=8,
                            macro_ticks=4)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        lock = tengine.ServingEngine(cfg, params, device=device, max_len=64)
        _build.reset_launches()
        outs, s = eng.run([tengine.Request(p, max_new_tokens=10,
                                           arrival_time=2.0 * i)
                           for i, p in enumerate(prompts)])
        cont = {k: n for k, n in _build.LAUNCHES.items() if n}
        _build.reset_launches()
        gen_out = lock.generate([tengine.Request(p, max_new_tokens=10)
                                 for p in prompts[:2]])
        runs.append((outs, s, gen_out, cont,
                     {k: n for k, n in _build.LAUNCHES.items() if n},
                     eng.graph_cache_entries()))
    (cpu, s_cpu, gen_cpu, _, _, _), (card, s_card, gen_card, cont, lock,
                                     graphs) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    for a, b in zip(gen_card, gen_cpu):
        np.testing.assert_array_equal(a, b)
    assert s_card["ticks"] == s_cpu["ticks"]
    nl, K = cfg.num_layers, serving.macro_ticks
    want_cont = {"slay_decode_step_masked": nl * K * s_card["decode_dispatches"]}
    want_lock = {"slay_fused_fwd": nl, "slay_decode_step": nl * 9}
    if cfg.family == "encdec":
        b7 = 2 * (cfg.enc_layers + nl)
        want_cont.update(slay_fused_fwd=nl * len(prompts),
                         feature_map_fwd=b7 * len(prompts))
        want_lock["feature_map_fwd"] = b7
    assert graphs == {"macro_decode": 1,
                      "chunk": int(cfg.family != "encdec")}
    assert cont == want_cont and lock == want_lock


@needs_card
def test_bucketed_prefill_on_card_matches_cpu():
    # prefill_chunk=0 on the smoke slayformer in fp32: each prompt padded
    # to its pow-2 bucket and prefilled through K1 (once a layer), masked
    # by its length; the same streams and bucket counters as on the CPU.
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    params = tapi.init_params(cfg, 0, device="cpu")
    params["embed"] = params["embed"] / 8.0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 256, n).astype(np.int32)
               for n in (5, 20, 9, 33)]
    serving = ServingConfig(num_slots=2, max_len=64, prefill_chunk=0,
                            macro_ticks=4)
    runs = []
    for device in ("cpu", "cuda"):
        eng = tengine.ContinuousServingEngine(cfg, params, serving=serving,
                                              device=device)
        _build.reset_launches()
        runs.append((*eng.run([tengine.Request(p, max_new_tokens=8,
                                               arrival_time=float(i))
                               for i, p in enumerate(prompts)]),
                     {k: n for k, n in _build.LAUNCHES.items() if n}))
    (cpu, s_cpu, _), (card, s_card, launches) = runs
    for rid in cpu:
        np.testing.assert_array_equal(card[rid], cpu[rid], f"rid {rid}")
    for k in ("ticks", "bucket_hits", "bucket_misses", "prefill_ticks"):
        assert s_card[k] == s_cpu[k], k
    assert (s_card["bucket_misses"], s_card["bucket_hits"]) == (3, 1)
    nl = cfg.num_layers
    assert launches == {
        "slay_fused_fwd": nl * len(prompts),
        "slay_decode_step_masked": nl * 4 * s_card["decode_dispatches"]}


@needs_card
def test_whisper_train_step_on_card_matches_cpu():
    # whisper's smoke model in fp32, one batch over random frames: the
    # loss and every gradient on the card (K1, K3, K4 once a decoder
    # layer; B7 and B8 twice an encoder and a decoder layer) equal to the
    # CPU's to 1e-5 relative and 1e-4 of each leaf's largest magnitude.
    cfg = get_smoke_config("whisper-small", dtype="float32")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 33)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frame_embeds": frames}
    out = {}
    for dev in ("cpu", "cuda"):
        p = tapi.init_params(cfg, 0, device=dev)
        _build.reset_launches()
        loss, _, grads = tloop.value_and_grad(
            p, cfg, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(loss), {k: g.cpu() for k, g in _flat(grads)},
                    {k: n for k, n in _build.LAUNCHES.items() if n})
    nl, b7 = cfg.num_layers, 2 * (cfg.enc_layers + cfg.num_layers)
    assert out["cuda"][2] == {"slay_fused_fwd": nl, "slay_fused_bwd_q": nl,
                              "slay_fused_bwd_kv": nl,
                              "feature_map_fwd": b7, "feature_map_bwd": b7}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= 1e-4 * scale, k


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v


# -- the core's routes: every feature config; K1's node-width limit ----------


def _route_case(cfg, L=96, h=4, hkv=2, dv=32, seed=0):
    """Projections and fp32 q, k, v, dy (model layout, batch 1) on the
    card for ``cfg``."""
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(seed),
                                  device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = cfg.head_dim
    q = torch.randn(1, L, h, d, generator=gen, device="cuda")
    k = torch.randn(1, L, hkv, d, generator=gen, device="cuda")
    v = torch.randn(1, L, hkv, dv, generator=gen, device="cuda")
    dy = torch.randn(1, L, h, dv, generator=gen, device="cuda")
    return p, q, k, v, dy


def _plain_num_den(qf, kf, v):
    """The causal sums of the model-layout features, quadratic and fp32:
    num (1, L, H, dv) and den (1, L, H), the plain oracle of a scan."""
    g = qf.shape[-2] // kf.shape[-2]
    kr, vr = kf.repeat_interleave(g, -2), v.repeat_interleave(g, -2)
    scores = torch.tril(torch.einsum("blhm,bshm->bhls", qf, kr))
    return (torch.einsum("bhls,bshd->blhd", scores, vr),
            scores.sum(-1).transpose(1, 2))


def _grads(fn, p, q, k, v, dy):
    leaves = [t.clone().requires_grad_(True)
              for t in (q, k, v, p["anchors"], p["omegas"])]
    params = dict(p, anchors=leaves[3], omegas=leaves[4])
    y = fn(params, *leaves[:3])
    (y.float() * dy).sum().backward()
    return y.detach(), [t.grad for t in leaves]


ROUTE_KINDS = [("exact", "tensor", 0), ("rm", "tensor", 0),
               ("tensorsketch", "subsample", 96), ("nystrom", "tensor", 0),
               ("laplace", "tensor", 0), ("anchor", "hadamard", 0),
               ("anchor", "subsample", 96)]


@needs_card
@pytest.mark.parametrize("kind,fusion,sketch", ROUTE_KINDS,
                         ids=[f"{k}-{f}" for k, f, _ in ROUTE_KINDS])
def test_every_feature_config_runs_the_scan_on_card(kind, fusion, sketch):
    # A config no kernel computes takes Ψ from core.features (PyTorch ops)
    # and its contraction through B5, its gradient through B6a/B6b; no
    # K1, B7. Signed kinds can drive den toward 0, so num = y·(den + δ)
    # and den are held to the plain causal sums at 1e-4 of the largest
    # |num| and |den|; the gradients (against autograd of the plain
    # route: core features then linear_attention.causal_chunked) at 1e-3
    # of each one's largest.
    from repro_torch.core import linear_attention as tla
    from repro_torch.kernels import ops as tops
    cfg = tfeat.SlayFeatureConfig(head_dim=D_HEAD, poly_kind=kind,
                                  fusion=fusion, sketch_dim=sketch)
    p, q, k, v, dy = _route_case(cfg)
    qf = tfeat.slay_features(q, p, cfg)
    kf = tfeat.slay_features(k, p, cfg)
    num, den = _plain_num_den(qf, kf, v)
    qh = qf[0].permute(1, 0, 2).contiguous()
    kh = kf[0].permute(1, 0, 2).contiguous()
    vh = v[0].permute(1, 0, 2).contiguous()
    yk, denk = tscan.launch_fwd(qh, kh, vh)
    numk = yk * (denk[..., None] + 1e-6)
    torch.testing.assert_close(
        numk, num[0].permute(1, 0, 2), rtol=0.0,
        atol=1e-4 * float(num.abs().max()))
    torch.testing.assert_close(denk, den[0].T, rtol=0.0,
                               atol=1e-4 * float(den.abs().max()))

    def kernel(params, q, k, v):
        return tops.slay_fused_attention(q, k, v, params, cfg, chunk_size=16)

    def plain(params, q, k, v):
        return tla.causal_chunked(tfeat.slay_features(q, params, cfg),
                                  tfeat.slay_features(k, params, cfg), v,
                                  chunk_size=16)

    _build.reset_launches()
    y, got = _grads(kernel, p, q, k, v, dy)
    counts = {n: c for n, c in _build.LAUNCHES.items() if c}
    assert counts == {"slay_scan_fwd": 1, "slay_scan_bwd_q": 1,
                      "slay_scan_bwd_kv": 1}, counts
    torch.testing.assert_close(y, yk.permute(1, 0, 2)[None], rtol=0.0,
                               atol=0.0)
    _, want = _grads(plain, p, q, k, v, dy)
    for g, w in zip(got, want, strict=True):
        if w is None:     # a projection the kind does not read
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=0.0,
                                   atol=1e-3 * float(w.abs().max()))


@needs_card
@pytest.mark.parametrize("d", [32, 64])
def test_anchor_past_the_fused_kernels_width_runs_two_dispatch_on_card(d):
    # Table 2's "large" budget, P = D = 32 (m = 3072): K1 and K4 would
    # need 316 KB and more of shared memory a block, so the route, decided
    # before any launch, is B7 then B5, and B6a/B6b then B8 backward.
    # Against autograd of the plain route (fp32): y 1e-4, gradients 1e-4
    # of each one's largest.
    from repro_torch.core import linear_attention as tla
    from repro_torch.kernels import ops as tops
    cfg = tfeat.SlayFeatureConfig(head_dim=d, num_anchors=32, num_prf=32)
    for grad in (False, True):
        assert not tfused.fused_fits(d, 32, 32, 32, 3, grad, "cuda")
        assert tfused.fused_fits(D_HEAD, 32, 8, 16, 3, grad, "cuda")
    p, q, k, v, dy = _route_case(cfg, L=80)

    def kernel(params, q, k, v):
        return tops.slay_fused_attention(q, k, v, params, cfg, chunk_size=16)

    def plain(params, q, k, v):
        return tla.causal_chunked(tfeat.slay_features(q, params, cfg),
                                  tfeat.slay_features(k, params, cfg), v,
                                  chunk_size=16)

    _build.reset_launches()
    y, got = _grads(kernel, p, q, k, v, dy)
    counts = {n: c for n, c in _build.LAUNCHES.items() if c}
    assert counts == {"feature_map_fwd": 2, "feature_map_bwd": 2,
                      "slay_scan_fwd": 1, "slay_scan_bwd_q": 1,
                      "slay_scan_bwd_kv": 1}, counts
    yp, want = _grads(plain, p, q, k, v, dy)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0.0,
                                   atol=1e-4 * float(w.abs().max()))


@needs_card
def test_fused_smem_copies_match_the_kernels_entries_on_card():
    # slay_fused.fused_fits decides the route on the CPU from Python
    # copies of K1's and K4's layouts; they must equal the C entries.
    fwd = _build.load("slay_fused").slay_fused_smem_bytes
    bwd = _build.load("slay_fused_bwd").slay_fused_bwd_smem_bytes
    for d, dv, P, D in [(64, 64, 8, 16), (16, 8, 8, 16), (128, 128, 8, 16),
                        (32, 32, 32, 32), (64, 64, 16, 24), (15, 16, 3, 16),
                        (64, 128, 16, 32)]:
        assert tfused.fused_smem_bytes(d, dv, P, D) == fwd(d, dv, P, D)
        assert tfused.fused_bwd_smem_bytes(d, dv, P, D) == bwd(d, dv, P, D)
        for grad in (False, True):
            assert tfused.fused_fits(d, dv, P, D, 3, grad, "cuda") == \
                tfused.fused_fits(d, dv, P, D, 3, grad, "cpu")


def _c_smem_bytes(probe) -> int:
    """The bytes a probe of ``analysis.smem`` needs by the kernels' own C
    entries: the ``*_smem_bytes`` entries (fp32; B7 and B8 at either
    dtype) and the occupancy entries, which report the dynamic shared
    memory they set at the probe's dtype."""
    a = dict(probe.args)
    code = 1 if probe.dtype == "bf16" else 0
    k = probe.kernel

    def occ(lib, fn, *args, **kw):
        return _build.residency(lib, fn, *args, grid=(1, 1),
                                **kw)["smem_bytes"]

    if k == "K1":
        return occ("slay_fused", "slay_fused_fwd_occupancy", a["d"], a["dv"],
                   a["P"], a["D"], code)
    if k in ("K3", "K4"):
        return occ("slay_fused_bwd", "slay_fused_bwd_occupancy",
                   int(k == "K4"), a["d"], a["dv"], a["P"], a["D"], code)
    if k == "K2":
        return occ("decode_step", "slay_decode_step_occupancy", a["g"],
                   a["m"], a["dv"], 0, 1, clustered=True)
    if k in ("B5", "B6a", "B6b"):
        return occ("slay_scan", "slay_scan_occupancy",
                   ("B5", "B6a", "B6b").index(k), a["m"], a["dv"], code)
    return _build.load("feature_map").slay_feature_map_smem_bytes(
        a["d"], a["P"], a["D"], a["R"], int(k == "B8"), code)


@needs_card
def test_smem_copies_and_routes_match_the_c_entries_over_the_audit_on_card():
    # Every probe of the shared-memory audit (every kernel at every shape
    # the 11 configs, C-15's and C-14's send it, bf16 and fp32): the
    # Python layout copies equal the kernels' C entries, fp32 also by the
    # *_smem_bytes entries; fused_fits, fmap_fits and the route agree
    # between "cpu" and "cuda" at every shape, with and without a
    # gradient.
    from repro_torch.analysis import smem
    from repro_torch.kernels import ops as tops
    probes = smem.probe_all()
    for name, p in probes.items():
        assert p.nbytes == _c_smem_bytes(p), name
    lib_fwd = _build.load("slay_fused").slay_fused_smem_bytes
    lib_bwd = _build.load("slay_fused_bwd").slay_fused_bwd_smem_bytes
    lib_scan = _build.load("slay_scan").slay_scan_smem_bytes
    for p in probes.values():
        a = dict(p.args)
        if p.dtype != "fp32":
            continue
        if p.kernel == "K1":
            assert p.nbytes == lib_fwd(a["d"], a["dv"], a["P"], a["D"])
        if p.kernel == "K4":
            assert p.nbytes == lib_bwd(a["d"], a["dv"], a["P"], a["D"])
        if p.kernel in ("B5", "B6a", "B6b"):
            kind = ("B5", "B6a", "B6b").index(p.kernel)
            assert p.nbytes == lib_scan(a["m"], a["dv"], kind)
    for source, f, dv, _g in smem.shapes():
        d, P, D, R = f.head_dim, f.num_anchors, f.num_prf, f.num_quad_nodes
        for grad in (False, True):
            assert tfused.fused_fits(d, dv, P, D, R, grad, "cuda") == \
                tfused.fused_fits(d, dv, P, D, R, grad, "cpu"), source
            assert tfm.fmap_fits(d, P, D, R, grad, "cuda") == \
                tfm.fmap_fits(d, P, D, R, grad, "cpu"), source
            for w in (dv, None):
                assert tops.attention_route(f, d, w, grad, "cuda") == \
                    tops.attention_route(f, d, w, grad, "cpu"), source


# ROADMAP C-15's configs: (feature config, route without a gradient, with
# one), as tests/test_torch_routes.py tables them on the CPU.
C15_CARD = {
    "r12": (dict(head_dim=64, num_quad_nodes=12), "torch_psi", "torch_psi"),
    "pd24": (dict(head_dim=64, num_anchors=4, num_prf=6), "fused",
             "two_dispatch"),
    "d128_pd32": (dict(head_dim=128, num_anchors=32, num_prf=32),
                  "two_dispatch", "torch_psi"),
}
# The kernels one call of ops.slay_fused_attention launches on a route:
# (forward, backward), by LAUNCHES key and by device kernel name.
ROUTE_LAUNCHES = {
    "fused": ({"slay_fused_fwd": 1},
              {"slay_fused_bwd_q": 1, "slay_fused_bwd_kv": 1}),
    "two_dispatch": ({"feature_map_fwd": 2, "slay_scan_fwd": 1},
                     {"slay_scan_bwd_q": 1, "slay_scan_bwd_kv": 1,
                      "feature_map_bwd": 2}),
    "torch_psi": ({"slay_scan_fwd": 1},
                  {"slay_scan_bwd_q": 1, "slay_scan_bwd_kv": 1}),
}
KERNEL_NAMES = {"slay_fused_fwd": "fused_fwd_kernel",
                "slay_fused_bwd_q": "fused_bwd_q_kernel",
                "slay_fused_bwd_kv": "fused_bwd_kv_kernel",
                "feature_map_fwd": "feature_map_fwd_kernel",
                "feature_map_bwd": "feature_map_bwd_kernel",
                "slay_scan_fwd": "scan_fwd_kernel",
                "slay_scan_bwd_q": "scan_bwd_q_kernel",
                "slay_scan_bwd_kv": "scan_bwd_kv_kernel"}


def _profiled_slay_kernels(fn) -> dict:
    """{device kernel name: launches} of the SLAY kernels ``fn()`` runs,
    by the profiler (CUPTI); a window that recorded no device kernel at
    all is taken again, at most twice."""
    import re
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    out = collections.Counter()
    for e in events:
        m = re.search(r"slay::(\w+_kernel)\b", e.key)
        if m and m.group(1) in KERNEL_NAMES.values():
            out[m.group(1)] += e.count
    return dict(out)


@needs_card
@pytest.mark.parametrize("name", sorted(C15_CARD))
def test_c15_configs_run_their_routes_forward_and_backward_on_card(name):
    # R = 12, P·D = 24 and head dim 128 at P = D = 32 through
    # ops.slay_fused_attention at slayformer's 12 heads, L = 1024, bf16,
    # against the CPU plain path on the same inputs: no ValueError; y
    # within 2e-2 (one bf16 rounding, the two-dispatch route's tolerance),
    # the gradients of q, k, v, the anchors and the omegas within 1e-2 of
    # each one's largest. The launch counters and the profiler's device
    # kernels show the route the CPU tables.
    from repro_torch.kernels import ops as tops
    kw, fwd_route, grad_route = C15_CARD[name]
    cfg = tfeat.SlayFeatureConfig(**kw)
    d = cfg.head_dim
    for grad, want in ((False, fwd_route), (True, grad_route)):
        assert tops.attention_route(cfg, d, d, grad, "cuda") == want
    p, q, k, v, dy = _route_case(cfg, L=1024, h=12, hkv=12, dv=d)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    cpu = {n: t.cpu() for n, t in p.items()}

    def run(params, q, k, v):
        return tops.slay_fused_attention(q, k, v, params, cfg)

    with torch.no_grad():
        _build.reset_launches()
        y = run(p, q, k, v)
        torch.cuda.synchronize()
        counts = {n: c for n, c in _build.LAUNCHES.items() if c}
        assert counts == ROUTE_LAUNCHES[fwd_route][0], counts
        seen = _profiled_slay_kernels(lambda: run(p, q, k, v))
        assert seen == {KERNEL_NAMES[n]: c for n, c in counts.items()}, seen
        yc = run(cpu, q.cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(y.cpu().float(), yc.float(), rtol=2e-2,
                               atol=2e-2)
    _build.reset_launches()
    y, got = _grads(run, p, q, k, v, dy)
    torch.cuda.synchronize()
    counts = {n: c for n, c in _build.LAUNCHES.items() if c}
    want = collections.Counter(ROUTE_LAUNCHES[grad_route][0])
    want.update(ROUTE_LAUNCHES[grad_route][1])
    assert counts == dict(want), counts
    seen = _profiled_slay_kernels(lambda: _grads(run, p, q, k, v, dy))
    assert seen == {KERNEL_NAMES[n]: c for n, c in counts.items()}, seen
    yc, wants = _grads(run, cpu, q.cpu(), k.cpu(), v.cpu(), dy.cpu())
    torch.testing.assert_close(y.cpu().float(), yc.float(), rtol=2e-2,
                               atol=2e-2)
    for g, w in zip(got, wants, strict=True):
        torch.testing.assert_close(g.cpu().float(), w.float(), rtol=0.0,
                                   atol=1e-2 * float(w.float().abs().max()))


@needs_card
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_map_bwd_reads_dpsi_unstaged_at_p_d_32_on_card(dtype, d):
    # At P = D = 32 (m = 3072) B8's ring of dΨ rows would need 300-584 KB
    # a block, so its items read dΨ from device memory: the same sums as
    # the plain version. Tolerances as test_feature_map_kernels_match_*.
    cfg = tfeat.SlayFeatureConfig(head_dim=d, num_anchors=32, num_prf=32)
    lib = _build.load("feature_map")
    assert lib.slay_feature_map_smem_bytes(d, 32, 32, 3, 1, 0) <= \
        _build.SMEM_LIMIT
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                  device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn(3001, d, generator=gen, device="cuda").to(dtype)
    dpsi = torch.randn(3001, cfg.feature_dim, generator=gen,
                       device="cuda").to(dtype)
    a, w = p["anchors"], p["omegas"]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(tfm.launch_fwd(u, a, w, cfg).float(),
                               tfm.feature_map_plain(u, a, w, cfg).float(),
                               rtol=tol, atol=1e-6)
    got = tfm.feature_map_bwd(u, a, w, dpsi, cfg)
    want = tfm.feature_map_bwd_plain(u, a, w, dpsi, cfg)
    for g, wnt in zip(got, want, strict=True):
        scale = float(wnt.float().abs().max())
        torch.testing.assert_close(g.float(), wnt.float(), rtol=0.0,
                                   atol=max(tol, 1e-4) * scale)


@needs_card
def test_decode_kernel_at_its_feature_limit_on_card():
    # K2 at G = 1, dv = 64 takes m up to 230,120 (every block holds its
    # slice of Ψq); one more raises ValueError before any launch.
    m = tdecode.max_feature_dim(1, 64)
    assert m == 230120
    args = [torch.from_numpy(x).cuda() for x in _decode_inputs(2, 2, 2, m=m,
                                                               dv=64)]
    plain = [a.clone() for a in args]
    yp, sp, zp = tdecode.decode_linear_attention_plain(*plain)
    _build.reset_launches()
    y, s, z = tdecode.decode_linear_attention(*args)
    assert _build.LAUNCHES["slay_decode_step"] == 1
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, sp, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(z, zp, rtol=1e-6, atol=1e-6)
    big = [torch.from_numpy(x).cuda() for x in _decode_inputs(2, 2, 2,
                                                              m=m + 1, dv=64)]
    with pytest.raises(ValueError, match="230120"):
        tdecode.decode_linear_attention(*big)
    assert _build.LAUNCHES["slay_decode_step"] == 1


@needs_card
@pytest.mark.parametrize("kind", ["anchor", "laplace"])
def test_slay_prefill_then_decode_on_card_matches_cpu(kind):
    # slay_prefill_state (B7 for anchor) then 4 slay_decode_steps (B7 and
    # K2) on the card against the same calls on the CPU, fp32; the
    # caller's state is left as it was.
    from repro_torch.core import slay as tslay
    cfg = tfeat.SlayFeatureConfig(head_dim=D_HEAD, poly_kind=kind)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    gen = torch.Generator().manual_seed(1)
    k, v = (torch.randn(2, 33, 2, D_HEAD, generator=gen) for _ in range(2))
    steps = [(torch.randn(2, 4, D_HEAD, generator=gen),
              torch.randn(2, 2, D_HEAD, generator=gen),
              torch.randn(2, 2, D_HEAD, generator=gen)) for _ in range(4)]
    pc = {n: t.cuda() for n, t in p.items()}
    want = tslay.slay_prefill_state(p, k, v, cfg)
    got = tslay.slay_prefill_state(pc, k.cuda(), v.cuda(), cfg)
    _build.reset_launches()
    for q1, k1, v1 in steps:
        s0 = got.s.clone()
        yw, want = tslay.slay_decode_step(p, q1, k1, v1, want, cfg)
        yg, nxt = tslay.slay_decode_step(pc, q1.cuda(), k1.cuda(), v1.cuda(),
                                         got, cfg)
        assert torch.equal(got.s, s0)
        got = nxt
        torch.testing.assert_close(yg.cpu(), yw, rtol=1e-4, atol=1e-5)
    assert _build.LAUNCHES["slay_decode_step"] == 4
    torch.testing.assert_close(got.s.cpu(), want.s, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.z.cpu(), want.z, rtol=1e-5, atol=1e-5)


# -- the sharded paths on NCCL (one rank; two ranks with two cards) ---------


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank NCCL group on a free loopback port and its 1x1 mesh."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@needs_card
def test_sharded_train_step_on_one_rank_nccl_runs_the_kernels(one_rank_mesh):
    # Two sharded steps (DTensor parameters, K1/K3/K4 through local_map)
    # against the unsharded step from the same weights: losses to 1e-4
    # relative (bf16 model), one launch of each kernel a layer a step.
    from torch.distributed.tensor import DTensor

    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as shd
    cfg = get_smoke_config("slayformer-124m")
    ocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    tcfg = tloop.TrainConfig(remat=False)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                               global_batch=4)
    params = tapi.init_params(cfg, 0, device="cuda")
    sp = shd.shard_params(one_rank_mesh, shd.DEFAULT_RULES,
                          {k: v for k, v in params.items()},
                          tapi.param_axes(cfg))
    assert all(isinstance(x, DTensor) for x in tree_leaves(sp))
    step = tloop.sharded_train_step(cfg, ocfg, tcfg, one_rank_mesh)
    ref = tloop.make_train_step(cfg, ocfg, tcfg)
    st = (sp, tadamw.adamw_init(sp, ocfg), torch.zeros(()))
    rt = (params, tadamw.adamw_init(params, ocfg), torch.zeros(()))
    nl = cfg.num_layers
    for i in range(2):
        batch = pipeline.make_batch(dcfg, i)
        before = dict(_build.LAUNCHES)
        *st, m = step(*st, batch)
        got = {k: _build.LAUNCHES[k] - before[k] for k in (
            "slay_fused_fwd", "slay_fused_bwd_q", "slay_fused_bwd_kv")}
        assert got == dict.fromkeys(got, nl), got
        *rt, mr = ref(*rt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(mr["loss"]),
                                   rtol=1e-4)


@needs_card
def test_sharded_engine_on_one_rank_nccl_replays_like_unsharded(
        one_rank_mesh):
    # The engine with the 1x1 mesh captures its dispatch over local
    # tensors only: its streams and its pool after the run are the
    # unsharded engine's, bit for bit, with the same B4b launches.
    from torch.distributed.tensor import DTensor
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    params = tapi.init_params(cfg, 0, device="cuda")
    params["embed"] = params["embed"] / 8
    rng = np.random.default_rng(0)
    reqs = [tengine.Request(rng.integers(3, cfg.vocab_size, int(n)).astype(
        np.int32), max_new_tokens=12, arrival_time=2.0 * i)
        for i, n in enumerate(rng.integers(4, 20, 6))]
    runs = []
    for mesh in (one_rank_mesh, None):
        eng = tengine.ContinuousServingEngine(
            cfg, params, serving=ServingConfig(num_slots=4, max_len=64,
                                               prefill_chunk=8),
            device="cuda", mesh=mesh)
        before = _build.LAUNCHES["slay_decode_step_masked"]
        outs, s = eng.run([dataclasses.replace(r) for r in reqs])
        runs.append((outs, s, eng,
                     _build.LAUNCHES["slay_decode_step_masked"] - before))
    (a, sa, ea, la), (b, sb, eb, lb) = runs
    assert {r: o.tolist() for r, o in a.items()} == {
        r: o.tolist() for r, o in b.items()}
    assert la == lb == cfg.num_layers * 8 * sa["decode_dispatches"] > 0
    assert ea.graph_cache_entries() == {"macro_decode": 1, "chunk": 1}
    assert sa["slot_shards"] == 1
    assert not any(isinstance(x, DTensor) for x in tree_leaves(ea.pool))
    for x, y in zip(tree_leaves(ea.pool), tree_leaves(eb.pool)):
        assert torch.equal(x, y)


@pytest.mark.skipif("torch.cuda.device_count() < 2",
                    reason="two NCCL ranks need two cards (NCCL puts one "
                    "rank on a device); the one-card machine skips it")
def test_two_rank_nccl_slot_sharded_parity(tmp_path):
    import torch_dist_ranks as ranks
    out = ranks.spawn("serving_nccl", 2, tmp_path, timeout=300)
    for case in out.values():
        assert case["same"] and case["shards"] == 2, out
        assert case["graphs"] == {"macro_decode": 1, "chunk": 1}, out


@needs_card
@pytest.mark.parametrize("fuse", [True, False])
def test_meta_steps_launch_what_the_card_steps_launch(fuse):
    """The dry run's meta branches record, kernel by kernel, the launches
    the same steps make on the card: a remat train step (K1 twice per
    layer, K3, K4; or B7, B8, B5, B6a, B6b on the two-dispatch path), a
    prefill and a decode step of the smoke config."""
    cfg = dataclasses.replace(get_smoke_config("slayformer-124m"),
                              fuse_attention_features=fuse)

    def launches(device):
        params = tapi.init_params(cfg, 0, device=device)
        toks = torch.zeros(2, 32, dtype=torch.int32, device=device)
        steps = (
            lambda: tloop.value_and_grad(params, cfg, {"tokens": toks,
                                                       "labels": toks},
                                         remat=True),
            lambda: tapi.prefill(params, cfg, toks),
            lambda: tapi.decode_step(params, cfg,
                                     tapi.init_cache(cfg, 2, 64,
                                                     device=device),
                                     toks[:, :1]))
        out = []
        for i, step in enumerate(steps):
            _build.reset_launches()
            with torch.set_grad_enabled(i == 0):
                step()
            out.append({k: n for k, n in _build.LAUNCHES.items() if n})
        return out

    card = launches("cuda")
    assert launches("meta") == card
    assert all(card)
