"""The split kernels' arithmetic, as K1, K3, K4, B5, B6a and B6b compute it.

K1, K3 and K4 run one block per (q head, quadrature node r): block (h, r)
carries only node r's P·D rows of the scan state. K1 forms node r's
shares of num and den, which its epilogue sums over the nodes and
divides; K3 and K4 form node r's share of dΨ (and, in K4, of dV through
the node's part of the scores), run the Ψ VJP on that share and add the R
shares of du, dv, dA and dΩ. B5, B6a and B6b run one block per (q head,
slice of 128 feature columns, the last padded with zero columns): block
(h, c) of B5 forms slice c's shares of num and den, which K1's epilogue
sums over the slices and divides; B6a writes slice c's columns of dΨq;
B6b slice c's columns of dΨk and its share of dV. Their tile products run
on the tensor cores in 3xTF32. This file replays that arithmetic on the
CPU, tile by tile (16 tokens) and node by node or slice by slice, with
seeded numpy inputs at the smoke size:

(a) with exact fp32 products the shares add up to the plain versions
    (``fused_causal_attention_plain``, ``fused_bwd_q_plain``,
    ``fused_bwd_kv_plain``, ``causal_linear_attention_plain``,
    ``scan_bwd_q_plain``, ``scan_bwd_kv_plain``) to 1e-6 of each
    output's largest magnitude, and match the JAX package's Pallas
    kernels in interpret mode: K1's and B5's y and den to the tolerances of
    ``test_torch_kernels.py::test_fused_forward_head_major_y_and_den_match_pallas``
    and ``test_torch_scan.py::test_scan_forward_matches_pallas``,
    the gradients to 1e-4 of scale, the tolerance of
    ``test_torch_kernels.py::test_fused_grads_match_pallas_vjp`` and
    ``test_torch_scan.py::test_scan_grads_match_pallas_vjp``;
(b) with every tile product rounded as the kernels form it in 3xTF32
    (operands split into TF32 big + small parts, cvt.rna rounding: the fp32
    mantissa rounded to 10 bits, ties away from zero), the result stays
    within 1e-5 of scale of the fp32 plain version, 10x inside the card's
    fp32 checks (``BWD_REL`` 1e-4 in ``chip_smoke.py``, K1's y to 1e-4),
    while single-pass TF32 does not: it misses K1's check.

B8, the feature map's VJP, runs on the fp32 pipes one warp per token:
its dpa sums split into S parts (``bwd_split``) and added after the
node loop, and each warp keeps its dA/dΩ sums over the tokens it walks
(global warp w takes tokens w, w + W, ...), which its block adds in
warp order and the wrapper sums over blocks. ``split_fmap_bwd`` replays
that order; it matches the interpret-mode Pallas VJP and the plain twin
to 1e-5 of scale (du) and 1e-5 relative in norm (dA, dΩ), 10x inside the
card's ``BWD_REL`` and ``DAW_REL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.kernels import feature_map as jfm
from repro.kernels import slay_fused as jfused
from repro.kernels import slay_scan as jscan
from repro_torch.core import features as tfeat
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import feature_map as tfm
from repro_torch.kernels import slay_fused as tfused
from repro_torch.kernels import slay_scan as tscan

D_HEAD, TILE, DELTA = 16, 16, 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the fp32 mantissa to 10 bits, ties away
    from zero (the low 13 bits of the pattern cleared after adding half
    of their range to the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as mma.sync in 3xTF32: small·big + big·small + big·big, each
    in fp32, the small terms first."""
    ab, bb = tf32(a), tf32(b)
    asm, bsm = tf32(a - ab), tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with single-pass TF32 operands (what the kernels rule out)."""
    return tf32(a) @ tf32(b)


def scores(q, k, mm):
    """tril(q kᵀ) as the MMA phases form it: the two halves of the
    columns through ``mm``, then added."""
    half = q.shape[-1] // 2
    return (torch.tril(mm(q[..., :half], k[..., :half].transpose(-1, -2)))
            + torch.tril(mm(q[..., half:], k[..., half:].transpose(-1, -2))))


def split_fwd(q, k, v, anchors, omegas, cfg, mm=torch.matmul):
    """K1 node by node and tile by tile, with every tile product through
    ``mm``: -> (y, den) in fp32, the node shares summed in node order and
    divided as the epilogue does."""
    st = tcommon.feature_statics(cfg)
    qf, _, kf, _, vf = tfused._per_q_head(q, k, v, anchors, omegas, st)
    bh, L, _ = qf.shape
    dv, pd = vf.shape[-1], cfg.num_anchors * cfg.num_prf
    num, den = 0.0, 0.0
    for r in range(cfg.num_quad_nodes):
        cols = slice(r * pd, (r + 1) * pd)
        s = torch.zeros(bh, pd, dv)
        z = torch.zeros(bh, pd)
        num_r, den_r = torch.zeros(bh, L, dv), torch.zeros(bh, L)
        for t0 in range(0, L, TILE):
            sl = slice(t0, t0 + TILE)
            qt, kt, vt = qf[:, sl, cols], kf[:, sl, cols], vf[:, sl]
            sc = scores(qt, kt, mm)
            num_r[:, sl] = mm(qt, s) + mm(sc, vt)
            den_r[:, sl] = torch.sum(qt * z[:, None, :], -1) + sc.sum(-1)
            s = s + mm(kt.transpose(-1, -2), vt)
            z = z + kt.sum(-2)
        num, den = num + num_r, den + den_r
    return num / (den[..., None] + DELTA), den


def feature_slices(m, width=128):
    """(f0, mc) of each feature slice the scan kernels' blocks take:
    ``width`` columns from f0, the last mc <= width."""
    return [(f0, min(width, m - f0)) for f0 in range(0, m, width)]


def padded(x, f0, mc):
    """Columns f0..f0+mc-1 of x, padded to a multiple of 16 with zero
    columns, as the kernels widen a slice in shared memory."""
    return torch.nn.functional.pad(x[..., f0:f0 + mc], (0, -mc % 16))


def split_scan_fwd(qf, kf, v, mm=torch.matmul, width=128):
    """B5 slice by slice and tile by tile, with every tile product through
    ``mm``: -> (y, den) in fp32, the slice shares summed in slice order and
    divided as the epilogue does."""
    bh, L, m = qf.shape
    q = qf.float()
    k, vf = tscan._per_q_head(kf, v, bh)
    num, den = 0.0, 0.0
    for f0, mc in feature_slices(m, width):
        pq, pk = padded(q, f0, mc), padded(k, f0, mc)
        s = torch.zeros(bh, pq.shape[-1], vf.shape[-1])
        z = torch.zeros(bh, pq.shape[-1])
        num_c, den_c = torch.zeros(bh, L, vf.shape[-1]), torch.zeros(bh, L)
        for t0 in range(0, L, TILE):
            sl = slice(t0, t0 + TILE)
            qt, kt, vt = pq[:, sl], pk[:, sl], vf[:, sl]
            sc = scores(qt, kt, mm)
            num_c[:, sl] = mm(qt, s) + mm(sc, vt)
            den_c[:, sl] = torch.sum(qt * z[:, None, :], -1) + sc.sum(-1)
            s = s + mm(kt.transpose(-1, -2), vt)
            z = z + kt.sum(-2)
        num, den = num + num_c, den + den_c
    return num / (den[..., None] + DELTA), den


def split_scan_q(qf, kf, v, y, den, dy, mm=torch.matmul, width=128):
    """B6a slice by slice and tile by tile, with every tile product through
    ``mm``: -> dq (BH, L, m) in fp32, each slice's columns written by its
    block."""
    bh, L, m = qf.shape
    k, vf = tscan._per_q_head(kf, v, bh)
    gg, hh = tcommon.cotangents(y, den, dy, DELTA)
    dq = torch.zeros(bh, L, m)
    for f0, mc in feature_slices(m, width):
        pk = padded(k, f0, mc)
        s = torch.zeros(bh, pk.shape[-1], vf.shape[-1])
        z = torch.zeros(bh, pk.shape[-1])
        for t0 in range(0, L, TILE):
            sl = slice(t0, t0 + TILE)
            g, h, vt, kt = gg[:, sl], hh[:, sl], vf[:, sl], pk[:, sl]
            dp = torch.tril(mm(g, vt.transpose(-1, -2)) + h)
            dq[:, sl, f0:f0 + mc] = (mm(g, s.transpose(-1, -2)) + mm(dp, kt)
                                     + h * z[:, None, :])[..., :mc]
            s = s + mm(kt.transpose(-1, -2), vt)
            z = z + kt.sum(-2)
    return dq


def split_scan_kv(qf, kf, v, y, den, dy, mm=torch.matmul, width=128):
    """B6b slice by slice and tile by tile, with every tile product through
    ``mm``: -> per-q-head (dk, dv) in fp32, dk's columns written by their
    slice, dv's slice shares summed."""
    bh, L, m = qf.shape
    q = qf.float()
    k, vf = tscan._per_q_head(kf, v, bh)
    gg, hh = tcommon.cotangents(y, den, dy, DELTA)
    dk, dv = torch.zeros(bh, L, m), torch.zeros(bh, L, vf.shape[-1])
    for f0, mc in feature_slices(m, width):
        pq, pk = padded(q, f0, mc), padded(k, f0, mc)
        ds = torch.zeros(bh, pq.shape[-1], vf.shape[-1])
        dz = torch.zeros(bh, pq.shape[-1])
        for t0 in reversed(range(0, L, TILE)):
            sl = slice(t0, t0 + TILE)
            g, h, vt, qt, kt = gg[:, sl], hh[:, sl], vf[:, sl], pq[:, sl], pk[:, sl]
            dp = torch.tril(mm(g, vt.transpose(-1, -2)) + h)
            sc = scores(qt, kt, mm)
            dv[:, sl] += mm(sc.transpose(-1, -2), g) + mm(kt, ds)
            dk[:, sl, f0:f0 + mc] = (mm(dp.transpose(-1, -2), qt)
                                     + mm(vt, ds.transpose(-1, -2))
                                     + dz[:, None, :])[..., :mc]
            ds = ds + mm(qt.transpose(-1, -2), g)
            dz = dz + torch.sum(qt * h, dim=-2)
    return dk, dv


def split_bwd(q, k, v, anchors, omegas, y, den, dy, cfg, mm=torch.matmul):
    """K3 and K4 node by node and tile by tile, with every tile product
    through ``mm``: -> ((dq, dA, dΩ), (dk, dv, dA, dΩ)), the per-q-head
    outputs of ``launch_bwd_q`` and ``launch_bwd_kv`` in fp32."""
    st = tcommon.feature_statics(cfg)
    qf, qres, kf, kres, vf = tfused._per_q_head(q, k, v, anchors, omegas, st)
    gg, hh = tcommon.cotangents(y, den, dy, DELTA)
    bh, L, m = qf.shape
    dv, pd = vf.shape[-1], cfg.num_anchors * cfg.num_prf
    tiles = [slice(t0, t0 + TILE) for t0 in range(0, L, TILE)]
    out_q = [0.0, 0.0, 0.0]
    out_kv = [0.0, 0.0, 0.0, 0.0]
    for r in range(cfg.num_quad_nodes):
        cols = slice(r * pd, (r + 1) * pd)
        pq, pk = qf[..., cols], kf[..., cols]
        # K3, node r: forward over the tiles, (S_r, z_r) of the earlier ones.
        s = torch.zeros(bh, pd, dv)
        z = torch.zeros(bh, pd)
        dpsi = torch.zeros(bh, L, m)
        for sl in tiles:
            g, h, vt, kt = gg[:, sl], hh[:, sl], vf[:, sl], pk[:, sl]
            dp = torch.tril(mm(g, vt.transpose(-1, -2)) + h)
            dpsi[:, sl, cols] = (mm(g, s.transpose(-1, -2)) + mm(dp, kt)
                                 + h * z[:, None, :])
            s = s + mm(kt.transpose(-1, -2), vt)
            z = z + kt.sum(-2)
        for i, x in enumerate(tcommon.features_bwd(dpsi, qres, anchors,
                                                   omegas, st)):
            out_q[i] = out_q[i] + x
        # K4, node r: reverse, (dS_r, dz_r) of the later tiles.
        ds = torch.zeros(bh, pd, dv)
        dz = torch.zeros(bh, pd)
        dpsi = torch.zeros(bh, L, m)
        dvs = torch.zeros(bh, L, dv)
        for sl in reversed(tiles):
            g, h, vt = gg[:, sl], hh[:, sl], vf[:, sl]
            qt, kt = pq[:, sl], pk[:, sl]
            dp = torch.tril(mm(g, vt.transpose(-1, -2)) + h)
            sc = torch.tril(mm(qt, kt.transpose(-1, -2)))
            dvs[:, sl] = mm(sc.transpose(-1, -2), g) + mm(kt, ds)
            dpsi[:, sl, cols] = (mm(dp.transpose(-1, -2), qt)
                                 + mm(vt, ds.transpose(-1, -2))
                                 + dz[:, None, :])
            ds = ds + mm(qt.transpose(-1, -2), g)
            dz = dz + torch.sum(qt * h, dim=-2)
        du, da, dw = tcommon.features_bwd(dpsi, kres, anchors, omegas, st)
        for i, x in enumerate((du, dvs, da, dw)):
            out_kv[i] = out_kv[i] + x
    return tuple(out_q), tuple(out_kv)


def _inputs(seed, bh, bk, L, nodes, dv=16):
    cfg = tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_quad_nodes=nodes)
    jcfg = jfeat.SlayFeatureConfig(head_dim=D_HEAD, num_quad_nodes=nodes)
    jp = jfeat.init_feature_params(jax.random.PRNGKey(seed), jcfg)
    a, w = (np.array(jp[n]) for n in ("anchors", "omegas"))
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.normal(size=s).astype(np.float32)
                   for s in ((bh, L, D_HEAD), (bk, L, D_HEAD), (bk, L, dv),
                             (bh, L, dv)))
    return cfg, jcfg, (q, k, v, a, w, dy)


def _plain_forward(cfg, arrays):
    q, k, v, a, w, _ = (torch.from_numpy(x) for x in arrays)
    return tfused.fused_causal_attention_plain(q, k, v, a, w, cfg,
                                               chunk_size=TILE)


def _forward(cfg, arrays):
    q, k, v, a, w, dy = (torch.from_numpy(x) for x in arrays)
    y, den = tfused.fused_causal_attention_plain(q, k, v, a, w, cfg,
                                                 chunk_size=TILE)
    return (q, k, v, a, w, y, den, dy, cfg)


def _within(got, want, frac):
    """max |got − want| <= frac · max |want|; returns that ratio."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= frac * scale, f"{err:.3e} > {frac:g} x {scale:.3e}"
    return err / scale


CASES = [(4, 4, 37, 3), (4, 2, 48, 2)]   # bh, bk, L (ragged first), nodes


@pytest.mark.parametrize("bh,bk,L,nodes", CASES)
def test_node_shares_add_up_to_the_plain_backward(bh, bk, L, nodes):
    cfg, _, arrays = _inputs(L, bh, bk, L, nodes)
    args = _forward(cfg, arrays)
    got_q, got_kv = split_bwd(*args)
    want_q = tfused.fused_bwd_q_plain(*args, chunk_size=TILE)
    want_kv = tfused.fused_bwd_kv_plain(*args, chunk_size=TILE)
    for got, want in zip(got_q + got_kv, want_q + want_kv, strict=True):
        assert got.shape == want.shape
        _within(got, want, 1e-6)


@pytest.mark.parametrize("bh,bk,nodes", [(4, 4, 3), (4, 2, 2)])
def test_node_shares_match_the_pallas_vjp(bh, bk, nodes):
    # The summed shares (GQA and dA/dΩ reduced as the wrapper does)
    # against jax.vjp of the interpret-mode Pallas kernels.
    L = 64
    cfg, jcfg, arrays = _inputs(7 + nodes, bh, bk, L, nodes)
    args = _forward(cfg, arrays)
    got_q, got_kv = split_bwd(*args)
    got = tfused._reduce(args[1], args[2], args[3], args[4], *got_q, *got_kv)
    q, k, v, a, w, dy = arrays

    def jfn(*xs):
        return jfused.fused_causal_attention(*xs, jcfg, chunk_size=TILE,
                                             interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v, a, w)))
    for g, wnt in zip(got, vjp(jnp.asarray(dy)), strict=True):
        wnt = torch.from_numpy(np.array(wnt))
        assert g.shape == wnt.shape
        _within(g, wnt, 1e-4)


@pytest.mark.parametrize("bh,bk,L,nodes", CASES)
def test_3xtf32_tile_products_keep_fp32_accuracy(bh, bk, L, nodes):
    cfg, _, arrays = _inputs(100 + L, bh, bk, L, nodes)
    args = _forward(cfg, arrays)
    want_q = tfused.fused_bwd_q_plain(*args, chunk_size=TILE)
    want_kv = tfused.fused_bwd_kv_plain(*args, chunk_size=TILE)
    got_q, got_kv = split_bwd(*args, mm=mm_3xtf32)
    for got, want in zip(got_q + got_kv, want_q + want_kv, strict=True):
        _within(got, want, 1e-5)
    # The check can fail: single-pass TF32 keeps about 3 decimal digits.
    one_q, one_kv = split_bwd(*args, mm=mm_tf32)
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(one_q + one_kv, want_q + want_kv))
    assert worst > 1e-5


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # exactly representable
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[:5].tolist() == [1.0, one, one, 1.0, -one]
    # 10 mantissa bits: the low 13 bits of the pattern are zero and the
    # result is within half a TF32 step (2^-11 relative).
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


# -- K1: the forward by quadrature node ------------------------------------


def _close_fwd(got, want, frac):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        _within(g, w.float(), frac)


@pytest.mark.parametrize("bh,bk,L,nodes", CASES)
def test_forward_node_shares_add_up_to_the_plain_forward(bh, bk, L, nodes):
    cfg, _, arrays = _inputs(200 + L, bh, bk, L, nodes)
    q, k, v, a, w, _ = (torch.from_numpy(x) for x in arrays)
    _close_fwd(split_fwd(q, k, v, a, w, cfg), _plain_forward(cfg, arrays),
               1e-6)


@pytest.mark.parametrize("bh,bk,nodes", [(4, 4, 3), (4, 2, 2)])
def test_forward_node_shares_match_pallas(bh, bk, nodes):
    # y and den of the summed shares against _fwd_impl of the
    # interpret-mode Pallas kernel, at that test's tolerances.
    L = 48
    cfg, jcfg, arrays = _inputs(300 + nodes, bh, bk, L, nodes)
    q, k, v, a, w, _ = arrays
    st = jfused.statics_for(jcfg, chunk_size=TILE, delta=DELTA,
                            interpret=True)
    wy, wden = jfused._fwd_impl(st, *(jnp.asarray(x) for x in (q, k, v, a, w)))
    gy, gden = split_fwd(*(torch.from_numpy(x) for x in (q, k, v, a, w)), cfg)
    np.testing.assert_allclose(gy.numpy(), np.array(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gden.numpy(), np.array(wden), rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("bh,bk,L,nodes", CASES)
def test_forward_3xtf32_keeps_fp32_accuracy(bh, bk, L, nodes):
    cfg, _, arrays = _inputs(400 + L, bh, bk, L, nodes)
    xs = [torch.from_numpy(x) for x in arrays[:5]]
    want = _plain_forward(cfg, arrays)
    _close_fwd(split_fwd(*xs, cfg, mm=mm_3xtf32), want, 1e-5)
    # Single-pass TF32 misses K1's card check of y (1e-4 + 1e-4·|y|).
    y1, _ = split_fwd(*xs, cfg, mm=mm_tf32)
    assert bool(((y1 - want[0]).abs() > 1e-4 + 1e-4 * want[0].abs()).any())


# -- B5, B6a, B6b: the scan on precomputed features, by feature slice ---------


def _scan_case(seed, bh, bk, L, m, dv=16):
    """Features nonnegative, as Ψ is; v and the cotangent normal; y and
    den from the plain forward."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0.0, 1.0, (bh, L, m)).astype(np.float32),
              rng.uniform(0.0, 1.0, (bk, L, m)).astype(np.float32),
              rng.normal(size=(bk, L, dv)).astype(np.float32),
              rng.normal(size=(bh, L, dv)).astype(np.float32))
    qf, kf, v, dy = (torch.from_numpy(x) for x in arrays)
    y, den = tscan.causal_linear_attention_plain(qf, kf, v, chunk_size=TILE)
    return arrays, (qf, kf, v, y, den, dy)


@pytest.mark.parametrize("mm,frac", [(torch.matmul, 1e-6), (mm_3xtf32, 1e-5)],
                         ids=["fp32", "3xtf32"])
@pytest.mark.parametrize("m", [96, 390])
def test_scan_slices_add_up_to_the_plain_reverse_scan(m, mm, frac):
    # m = 96: one slice padded to 96 columns; m = 390: three full slices
    # and one of 6 columns padded to 16.
    _, args = _scan_case(m, 4, 2, 37, m)
    got = split_scan_kv(*args, mm=mm)
    want = tscan.scan_bwd_kv_plain(*args, chunk_size=TILE)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        _within(g, w, frac)


@pytest.mark.parametrize("m", [96, 390])
def test_scan_slices_match_the_pallas_vjp(m):
    # The slices' dk and dv (summed per GQA group as the wrapper does, dq
    # from the plain re-scan) against jax.vjp of the interpret-mode
    # Pallas scan.
    arrays, args = _scan_case(500 + m, 4, 2, 32, m)
    dq = tscan.scan_bwd_q_plain(*args, chunk_size=TILE)
    got = tscan._reduce(args[1], args[2], dq, *split_scan_kv(*args))

    def jfn(*xs):
        return jscan.causal_linear_attention(*xs, chunk_size=TILE,
                                             interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in arrays[:3]))
    for g, wnt in zip(got, vjp(jnp.asarray(arrays[3])), strict=True):
        wnt = torch.from_numpy(np.array(wnt))
        assert g.shape == wnt.shape
        _within(g, wnt, 1e-4)


@pytest.mark.parametrize("mm,frac", [(torch.matmul, 1e-6), (mm_3xtf32, 1e-5)],
                         ids=["fp32", "3xtf32"])
@pytest.mark.parametrize("m", [96, 390])
def test_scan_forward_slices_add_up_to_the_plain_forward(m, mm, frac):
    # B5's slice shares, summed and divided as the epilogue does, against
    # the plain forward: y and den, each to frac of its largest magnitude.
    _, args = _scan_case(600 + m, 4, 2, 37, m)
    got = split_scan_fwd(*args[:3], mm=mm)
    want = tscan.causal_linear_attention_plain(*args[:3], chunk_size=TILE)
    _close_fwd(got, want, frac)


@pytest.mark.parametrize("m", [96, 390])
def test_scan_forward_slices_match_pallas(m):
    # y and den of the summed slice shares against _fwd_impl of the
    # interpret-mode Pallas scan, at the tolerances of
    # test_torch_scan.py::test_scan_forward_matches_pallas.
    arrays, args = _scan_case(700 + m, 4, 2, 32, m)
    st = jscan.ScanStatics(chunk_size=TILE, delta=DELTA, interpret=True)
    wy, wden = jscan._fwd_impl(st, *(jnp.asarray(x) for x in arrays[:3]))
    gy, gden = split_scan_fwd(*args[:3])
    np.testing.assert_allclose(gy.numpy(), np.array(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gden.numpy(), np.array(wden), rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("mm,frac", [(torch.matmul, 1e-6), (mm_3xtf32, 1e-5)],
                         ids=["fp32", "3xtf32"])
@pytest.mark.parametrize("m", [96, 390])
def test_scan_q_slices_add_up_to_the_plain_re_scan(m, mm, frac):
    # B6a's slice columns of dq against the plain forward re-scan.
    _, args = _scan_case(800 + m, 4, 2, 37, m)
    got = split_scan_q(*args, mm=mm)
    want = tscan.scan_bwd_q_plain(*args, chunk_size=TILE)
    assert got.shape == want.shape
    _within(got, want, frac)


@pytest.mark.parametrize("m", [96, 390])
def test_scan_q_slices_match_the_pallas_vjp(m):
    # dq from B6a's slices, with dk and dv from B6b's (summed per GQA
    # group as the wrapper does), against jax.vjp of the interpret-mode
    # Pallas scan.
    arrays, args = _scan_case(900 + m, 4, 2, 32, m)
    got = tscan._reduce(args[1], args[2], split_scan_q(*args),
                        *split_scan_kv(*args))

    def jfn(*xs):
        return jscan.causal_linear_attention(*xs, chunk_size=TILE,
                                             interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in arrays[:3]))
    for g, wnt in zip(got, vjp(jnp.asarray(arrays[3])), strict=True):
        wnt = torch.from_numpy(np.array(wnt))
        assert g.shape == wnt.shape
        _within(g, wnt, 1e-4)


# -- B8: the feature map's VJP, one warp per token -----------------------


def bwd_split(P, D):
    """S of ``csrc/feature_map.cu::bwd_split``: the parts of each dpa sum,
    the largest S dividing D with P·S + D <= 32, at least 1."""
    return max([1] + [s for s in range(2, D + 1)
                      if D % s == 0 and P * s + D <= 32])


def split_fmap_bwd(u, a, w, dpsi, cfg, blocks, warps=8):
    """B8 token by token in fp32: -> (du, dA, dΩ). The dpa sums in S parts
    per node loop, added in part order; dA/dΩ summed per warp over its
    tokens in order, per block in warp order, then over the blocks."""
    st = tcommon.feature_statics(cfg)
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    n = u.shape[0]
    uf, a, w = u.float(), a.float(), w.float()
    inv = torch.rsqrt(torch.sum(uf * uf, -1, keepdim=True) + 1e-6)
    uh = uf * inv
    pa, pw = uh @ a.T, uh @ w.T
    phi_p = (pa * pa) * float(1.0 / np.sqrt(P))
    dps = dpsi.float().reshape(n, R, P, D)
    S = bwd_split(P, D)
    K = D // S
    parts = torch.zeros(n, P, S)
    dpw = torch.zeros(n, D)
    for r, (s_r, sw) in enumerate(zip(st.s_nodes, st.sqrt_w)):
        phi_e = torch.exp(float(np.sqrt(2.0 * s_r)) * pw - s_r) * float(
            1.0 / np.sqrt(D))
        x = dps[:, r] * sw                                   # (n, P, D)
        sr = (x * phi_e[:, None, :]).reshape(n, P, S, K).sum(-1)
        parts = parts + sr
        de = torch.sum(x * phi_p[:, :, None], dim=1)        # (n, D)
        dpw = dpw + (float(np.sqrt(2.0 * s_r)) * phi_e) * de
    acc = torch.zeros(n, P)
    for h in range(S):
        acc = acc + parts[..., h]
    dpa = (2.0 * pa) * acc * float(1.0 / np.sqrt(P))
    dproj = torch.cat([dpa, dpw], dim=-1)                   # (n, P + D)
    duh = dpa @ a + dpw @ w
    du = inv * (duh - uh * torch.sum(uh * duh, -1, keepdim=True))
    nw = blocks * warps
    acc_w = torch.zeros(nw, P + D, uf.shape[1])
    for t0 in range(0, n, nw):
        t = torch.arange(t0, min(n, t0 + nw))
        acc_w[t - t0] += dproj[t, :, None] * uh[t, None, :]
    per_block = acc_w.reshape(blocks, warps, P + D, -1)
    daw = per_block[:, 0]
    for k in range(1, warps):
        daw = daw + per_block[:, k]
    daw = torch.sum(daw, dim=0)
    return du.to(u.dtype), daw[:P], daw[P:]


@pytest.mark.parametrize("n,block,blocks,nodes", [
    (1000, 200, 3, 3),      # each warp walks about 42 tokens
    (1000, 200, 125, 3),    # one token a warp
    (999, 37, 5, 2),        # ragged: warps walk unequal counts
])
def test_fmap_bwd_warp_order_matches_the_pallas_vjp(n, block, blocks, nodes):
    # B8's order against jax.vjp of the interpret-mode Pallas feature map
    # and against the plain twin (both fp32): du to 1e-5 of its scale, dA
    # and dΩ to 1e-5 relative in norm.
    cfg = tfeat.SlayFeatureConfig(head_dim=D_HEAD, num_quad_nodes=nodes)
    jcfg = jfeat.SlayFeatureConfig(head_dim=D_HEAD, num_quad_nodes=nodes)
    jp = jfeat.init_feature_params(jax.random.PRNGKey(3), jcfg)
    a, w = (np.array(jp[k]) for k in ("anchors", "omegas"))
    rng = np.random.default_rng(n + blocks)
    u = rng.normal(size=(n, D_HEAD)).astype(np.float32)
    dpsi = rng.normal(size=(n, cfg.feature_dim)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (u, a, w, dpsi)]
    got = split_fmap_bwd(*t, cfg, blocks)

    def jfn(u, a, w):
        return jfm.slay_feature_map(u, a, w, jcfg, block_tokens=block,
                                    interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (u, a, w)))
    jax_out = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(dpsi))]
    plain = tfm.feature_map_bwd_plain(*t, cfg)
    for want in (jax_out, plain):
        _within(got[0], want[0], 1e-5)
        for g, wnt in zip(got[1:], want[1:], strict=True):
            assert g.shape == wnt.shape
            rel = float(torch.linalg.vector_norm(g - wnt)
                        / torch.linalg.vector_norm(wnt))
            assert rel <= 1e-5, rel


def test_fmap_bwd_split_fills_one_warp():
    # slayformer's P = 8, D = 16: each dpa sum in two parts, 16 dpa and 16
    # dpw items, one warp; P = 16, D = 24 leaves no room (S = 1, 40
    # items over two passes of the lanes).
    assert bwd_split(8, 16) == 2
    assert bwd_split(16, 24) == 1
    assert bwd_split(3, 4) == 4
