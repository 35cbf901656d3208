"""The port's core (quadrature, Ψ, linear attention) against the JAX package.

Inputs are drawn once with numpy and handed to both packages; the random
projections are the JAX draws, moved across, never re-drawn. Everything is
fp32 (the port computes Ψ in fp32; see ``repro_torch.core.features``).
Tolerances: 1e-5 relative and absolute — both sides run the same fp32
arithmetic and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.core import linear_attention as jla
from repro.core import quadrature as jquad
from repro_torch.core import features as tfeat
from repro_torch.core import linear_attention as tla
from repro_torch.core import quadrature as tquad
from repro_torch.kernels import common as tcommon

torch.set_num_threads(1)    # small ops; the suite runs one process per core

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(d=16, **kw):
    return (jfeat.SlayFeatureConfig(head_dim=d, **kw),
            tfeat.SlayFeatureConfig(head_dim=d, **kw))


def _proj(jcfg, seed=0):
    jp = jfeat.init_feature_params(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(jp[k])) for k in ("anchors", "omegas")}
    return jp, tp


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("nodes,eps", [(1, 1e-3), (3, 1e-3), (5, 0.1)])
def test_quadrature_identical(nodes, eps):
    # The port's copy must give the very same float64 nodes and weights.
    for got, want in zip(tquad.yat_quadrature(nodes, eps),
                         jquad.yat_quadrature(nodes, eps)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_normalize_matches():
    u = np.random.default_rng(1).normal(size=(3, 5, 16)).astype(np.float32)
    u[0, 0] = 0.0                                    # the eps-guarded zero row
    _close(tfeat.normalize(torch.from_numpy(u)), jfeat.normalize(jnp.asarray(u)))


@pytest.mark.parametrize("nodes", [1, 3])
def test_slay_features_matches(nodes):
    jcfg, tcfg = _cfgs(num_quad_nodes=nodes)
    jp, tp = _proj(jcfg)
    u = np.random.default_rng(2).normal(size=(2, 7, 3, 16)).astype(np.float32)
    got = tfeat.slay_features(torch.from_numpy(u), tp, tcfg)
    want = jfeat.slay_features(jnp.asarray(u), jp, jcfg)
    assert got.shape == (2, 7, 3, tcfg.feature_dim) and got.dtype == torch.float32
    _close(got, want)


def test_kernel_features_fwd_matches_jax_kernel_arithmetic():
    # kernels.common.features_fwd is the fp32 Ψ the CUDA kernels compute;
    # it must agree with the Pallas kernels' own features_fwd.
    from repro.kernels import common as jcommon
    from repro.kernels import slay_fused as jfused
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg, seed=3)
    u = np.random.default_rng(3).normal(size=(9, 16)).astype(np.float32)
    jst = jfused.statics_for(jcfg, chunk_size=16, delta=1e-6,
                             interpret=True).feat
    want, _ = jcommon.features_fwd(jnp.asarray(u), jp["anchors"], jp["omegas"],
                                   jst)
    got, _ = tcommon.features_fwd(torch.from_numpy(u), tp["anchors"],
                                  tp["omegas"], tcommon.feature_statics(tcfg))
    _close(got, want)


def _lin_inputs(seed, B, L, H, Hkv, m=12, dv=8):
    rng = np.random.default_rng(seed)
    # Nonnegative features, as Ψ is: the denominators stay well away from 0.
    qf = rng.uniform(0.0, 1.0, (B, L, H, m)).astype(np.float32)
    kf = rng.uniform(0.0, 1.0, (B, L, Hkv, m)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, dv)).astype(np.float32)
    s0 = rng.normal(size=(B, Hkv, m, dv)).astype(np.float32)
    z0 = rng.uniform(0.0, 4.0, (B, Hkv, m)).astype(np.float32)
    return qf, kf, v, s0, z0


@pytest.mark.parametrize("L,H,Hkv,chunk,seeded", [
    (32, 4, 4, 8, False),          # chunk multiple
    (37, 4, 4, 8, False),          # ragged L: zero padding
    (29, 4, 2, 8, False),          # GQA G=2, ragged
    (21, 4, 2, 16, True),          # GQA with init_state
])
def test_causal_chunked_matches(L, H, Hkv, chunk, seeded):
    qf, kf, v, s0, z0 = _lin_inputs(L, 2, L, H, Hkv)
    t = [torch.from_numpy(x) for x in (qf, kf, v)]
    j = [jnp.asarray(x) for x in (qf, kf, v)]
    ts = tla.LinearState(torch.from_numpy(s0), torch.from_numpy(z0))
    js = jla.LinearState(jnp.asarray(s0), jnp.asarray(z0))
    got, gst = tla.causal_chunked(*t, chunk_size=chunk, return_state=True,
                                  init_state=ts if seeded else None)
    want, wst = jla.causal_chunked(*j, chunk_size=chunk, return_state=True,
                                   init_state=js if seeded else None)
    assert got.shape == (2, L, H, 8)
    _close(got, want)
    _close(gst.s, wst.s)
    _close(gst.z, wst.z)
    # Chunking only orders the evaluation.
    other = tla.causal_chunked(*t, chunk_size=chunk * 2,
                               init_state=ts if seeded else None)
    _close(other, got)


def test_prefill_state_then_decode_step_matches():
    qf, kf, v, _, _ = _lin_inputs(5, 2, 13, 4, 2)
    gst = tla.prefill_state(torch.from_numpy(kf), torch.from_numpy(v))
    wst = jla.prefill_state(jnp.asarray(kf), jnp.asarray(v))
    _close(gst.s, wst.s)
    _close(gst.z, wst.z)
    rng = np.random.default_rng(6)
    for _ in range(3):
        q1 = rng.uniform(0.0, 1.0, (2, 4, 12)).astype(np.float32)
        k1 = rng.uniform(0.0, 1.0, (2, 2, 12)).astype(np.float32)
        v1 = rng.normal(size=(2, 2, 8)).astype(np.float32)
        gy, gst = tla.decode_step(*(torch.from_numpy(x) for x in (q1, k1, v1)),
                                  gst)
        wy, wst = jla.decode_step(*(jnp.asarray(x) for x in (q1, k1, v1)), wst)
        _close(gy, wy)
        _close(gst.s, wst.s)
        _close(gst.z, wst.z)
    # Prompt state plus one step equals the causal scan's last row.
    full = tla.causal_chunked(
        *(torch.from_numpy(np.concatenate([a, b[:, None]], 1))
          for a, b in ((qf, q1), (kf, k1), (v, v1))), chunk_size=4)
    st = tla.prefill_state(torch.from_numpy(kf), torch.from_numpy(v))
    y_last, _ = tla.decode_step(*(torch.from_numpy(x) for x in (q1, k1, v1)),
                                st)
    _close(y_last, full[:, -1])


@pytest.mark.parametrize("num_prf,antithetic", [(512, True), (511, True),
                                                (512, False)])
def test_init_feature_params_distribution(num_prf, antithetic):
    # Draws come from a torch.Generator, so only their law can be compared
    # with jax.random's: unit-norm anchors, omegas ~ N(0, I), in exact
    # antithetic pairs when enabled and D is even.
    cfg = tfeat.SlayFeatureConfig(head_dim=64, num_anchors=8, num_prf=num_prf,
                                  prf_antithetic=antithetic)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    a, w = p["anchors"], p["omegas"]
    assert a.shape == (8, 64) and w.shape == (num_prf, 64)
    assert a.dtype == w.dtype == torch.float32
    torch.testing.assert_close(torch.linalg.norm(a, dim=-1), torch.ones(8))
    if antithetic and num_prf % 2 == 0:
        assert torch.equal(w[: num_prf // 2], -w[num_prf // 2:])
    else:
        assert not torch.equal(w[: num_prf // 2], -w[num_prf // 2: 2 * (
            num_prf // 2)])
    half = w[: num_prf // 2]
    # 256·64 standard normals: mean within 5 sigma (5/128), var within 5%.
    assert abs(float(half.mean())) < 5 / 128
    assert abs(float(half.var()) - 1.0) < 0.05


def test_slay_attention_matches_jax_causal_noncausal_two_dispatch():
    from repro.core import slay as jslay
    from repro_torch.core import slay as tslay
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg, seed=4)
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 21, 4, 16)).astype(np.float32)
               for _ in range(3))
    got = tslay.slay_attention(tp, *(torch.from_numpy(x) for x in (q, k, v)),
                               tcfg, chunk_size=8)
    want = jslay.slay_attention(jp, *(jnp.asarray(x) for x in (q, k, v)),
                                jcfg, chunk_size=8)
    _close(got, want)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    # Non-causal (ported with linear_attention.noncausal) against JAX's.
    got = tslay.slay_attention(tp, *t, tcfg, causal=False)
    want = jslay.slay_attention(jp, *(jnp.asarray(x) for x in (q, k, v)),
                                jcfg, causal=False)
    _close(got, want)
    # The two-dispatch path (feature map, then scan) against the JAX one.
    got = tslay.slay_attention(tp, *t, tcfg, chunk_size=8, fuse_features=False)
    want = jslay.slay_attention(jp, *(jnp.asarray(x) for x in (q, k, v)),
                                jcfg, chunk_size=8, use_kernel=True,
                                fuse_features=False, interpret=True)
    _close(got, want)
