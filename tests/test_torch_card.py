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
summation order only, bf16 by one rounding of each output.
"""
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
from repro_torch.serving import engine as tengine
from repro_torch.serving import sampling as tsampling

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
