"""Every feature config of the core, slay_init, prefill and decode, the
quadrature helpers and the task suite against the JAX package.

Smoke shapes: head dim 16, P = 8, D = 16, R = 3; B = 2, L = 21, 4 q heads
over 2 kv heads, chunk 8; fp32; inputs from ``np.random.default_rng``.
The random projections are the JAX draws, moved across through
``convert.params_from_numpy`` (integer leaves kept), never re-drawn. The
JAX side is its jnp path (``use_kernel=False``); the port's runs its
routes on the CPU (the kernels' plain versions). Tolerances: Ψ within
1e-5 of its largest |value|; attention outputs and gradients within
1e-4 of each one's largest |value| (fp32 in a different summation
order) where Ψ is nonnegative (anchor, laplace), 2e-3 where it is signed
(exact, rm, tensorsketch, nystrom: the denominator Ψq·ΣΨk sums terms of
both signs, and its cancellation amplifies the summation-order
differences, measured up to 5.4e-4 here for tensorsketch); the
quadrature helpers, the TensorSketch tables and the tasks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.core import quadrature as jquad
from repro.core import slay as jslay
from repro.data import tasks as jtasks
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import features as tfeat
from repro_torch.core import linear_attention as tla
from repro_torch.core import quadrature as tquad
from repro_torch.core import slay as tslay
from repro_torch.data import tasks as ttasks
from repro_torch.kernels import decode_step as tdecode
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slay_fused as tfused

torch.set_num_threads(1)    # small ops; the suite runs one process per core

D_HEAD, B, L, H, HKV, CHUNK = 16, 2, 21, 4, 2, 8
CONFIGS = [(kind, fusion) for kind in tfeat.POLY_KINDS
           for fusion in tfeat.FUSIONS]
IDS = [f"{k}-{f}" for k, f in CONFIGS]


def _kw(kind, fusion, d=D_HEAD, **extra):
    kw = dict(head_dim=d, poly_kind=kind, fusion=fusion, **extra)
    if fusion == "subsample":
        # 96 of the P·D = 128 Kronecker columns (a ragged last scan slice
        # at m = 288); laplace's P·D is 16, so 12 of those.
        kw["sketch_dim"] = 12 if kind == "laplace" else 96
    return kw


def _pair(kind, fusion, seed=0, **extra):
    """(JAX config, port config, JAX params, port params)."""
    jcfg = jfeat.SlayFeatureConfig(**_kw(kind, fusion, **extra))
    tcfg = tfeat.SlayFeatureConfig(**_kw(kind, fusion, **extra))
    jp = jslay.slay_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _near(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=frac * max(np.abs(want).max(), 1e-30))


def _qkv(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D_HEAD)).astype(np.float32)
    k = rng.normal(size=(B, L, HKV, D_HEAD)).astype(np.float32)
    v = rng.normal(size=(B, L, HKV, D_HEAD)).astype(np.float32)
    dy = rng.normal(size=(B, L, H, D_HEAD)).astype(np.float32)
    return q, k, v, dy


@pytest.mark.parametrize("kind,fusion", CONFIGS, ids=IDS)
def test_feature_dims_and_features_match_jax(kind, fusion):
    jcfg, tcfg, jp, tp = _pair(kind, fusion)
    for attr in ("poly_dim", "node_dim", "feature_dim"):
        assert getattr(tcfg, attr) == getattr(jcfg, attr)
    assert tcfg.kernelizable == (kind == "anchor" and fusion == "tensor")
    u = np.random.default_rng(1).normal(size=(3, 7, D_HEAD)).astype(np.float32)
    un = jfeat.normalize(jnp.asarray(u))
    got = tfeat.poly_features(torch.from_numpy(np.array(un)), tp, tcfg)
    _near(got, jfeat.poly_features(un, jp, jcfg), 1e-5)
    got = tfeat.slay_features(torch.from_numpy(u), tp, tcfg)
    assert got.dtype == torch.float32
    assert got.shape == (3, 7, tcfg.feature_dim)
    _near(got, jfeat.slay_features(jnp.asarray(u), jp, jcfg), 1e-5)
    # ops.slay_features: the kernel's plain twin, or these PyTorch ops.
    _near(tops.slay_features(torch.from_numpy(u), tp, tcfg),
          jfeat.slay_features(jnp.asarray(u), jp, jcfg), 1e-5)


def _jax_grads(jp, q, k, v, dy, jcfg, causal):
    def loss(q, k, v, a, w):
        prm = dict(jp, anchors=a, omegas=w)
        y = jslay.slay_attention(prm, q, k, v, jcfg, causal=causal,
                                 chunk_size=CHUNK)
        return jnp.sum(y * dy), y
    args = [jnp.asarray(x) for x in (q, k, v)] + [jp["anchors"], jp["omegas"]]
    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(*args)
    return y, grads


def _port_grads(tp, q, k, v, dy, tcfg, causal):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    leaves += [tp["anchors"].clone().requires_grad_(True),
               tp["omegas"].clone().requires_grad_(True)]
    prm = dict(tp, anchors=leaves[3], omegas=leaves[4])
    y = tslay.slay_attention(prm, *leaves[:3], tcfg, causal=causal,
                             chunk_size=CHUNK)
    (y * torch.from_numpy(dy)).sum().backward()
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("kind,fusion", CONFIGS, ids=IDS)
def test_slay_attention_and_grads_match_jax(kind, fusion, causal):
    # Outputs and the gradients with respect to q, k, v, the anchors and
    # the omegas (GQA, ragged L = 21 against chunk 8).
    jcfg, tcfg, jp, tp = _pair(kind, fusion, seed=2)
    q, k, v, dy = _qkv(3)
    want_y, want = _jax_grads(jp, q, k, v, dy, jcfg, causal)
    got_y, got = _port_grads(tp, q, k, v, dy, tcfg, causal)
    tol = 1e-4 if kind in ("anchor", "laplace") else 2e-3
    _near(got_y, want_y, tol)
    for g, w in zip(got, want, strict=True):
        # A projection the kind does not read (exact, tensorsketch and
        # laplace read no anchors) has no gradient; JAX gives it zeros.
        _near(np.zeros(w.shape) if g is None else g, w, tol)


@pytest.mark.parametrize("kind,fusion", CONFIGS, ids=IDS)
def test_slay_init_tree_matches_jax(kind, fusion):
    # Key sets, shapes and dtypes of the port's draws against the JAX
    # draws (the index is int64 in the port, int32 in JAX).
    jcfg, tcfg, jp, _ = _pair(kind, fusion)
    tp = tcore.slay_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(tp) == set(jp)
    for name, t in tp.items():
        j = np.asarray(jp[name])
        assert tuple(t.shape) == j.shape, name
        if name == "subsample_idx":
            assert t.dtype == torch.int64 and j.dtype.kind == "i"
        else:
            assert t.dtype == torch.float32 and j.dtype == np.float32


def test_rm_signs_and_subsample_idx_distribution():
    # Draws come from a torch.Generator, so only their law is compared
    # with jax.random's: Rademacher signs, distinct in-range indices.
    cfg = tfeat.SlayFeatureConfig(head_dim=64, num_anchors=64, poly_kind="rm",
                                  fusion="subsample", sketch_dim=500)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    signs = p["rm_signs"]
    assert signs.shape == (2, 64, 64)
    assert set(torch.unique(signs).tolist()) == {-1.0, 1.0}
    # 8192 signs: mean within 5 sigma (5/90.5).
    assert abs(float(signs.mean())) < 5 / 90.5
    idx = p["subsample_idx"]
    assert idx.shape == (500,) and len(torch.unique(idx)) == 500
    assert int(idx.min()) >= 0 and int(idx.max()) < 64 * 16
    # 500 draws without replacement from 1024: mean within 5 sigma of
    # 511.5 (sigma ≈ 295.6/√500 · √(524/1023)).
    assert abs(float(idx.float().mean()) - 511.5) < 5 * 295.6 / 500 ** 0.5


@pytest.mark.parametrize("d,p", [(16, 8), (64, 8), (32, 32)])
def test_tensorsketch_tables_bit_for_bit(d, p):
    kh1, kh2, ks1, ks2 = jax.random.split(jax.random.PRNGKey(17), 4)
    want = (jax.random.randint(kh1, (d,), 0, p),
            jax.random.randint(kh2, (d,), 0, p),
            jax.random.rademacher(ks1, (d,), jnp.float32),
            jax.random.rademacher(ks2, (d,), jnp.float32))
    got = tfeat._sketch_hashes(d, p)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    # The count-sketch matrices place each sign in its bucket.
    m1 = tfeat._sketch_matrices(d, p, torch.device("cpu"))[0].numpy()
    np.testing.assert_array_equal(m1[np.arange(d), np.asarray(want[0])],
                                  np.asarray(want[2]))
    assert np.count_nonzero(m1) == d


@pytest.mark.parametrize("kind,fusion", [("anchor", "tensor"),
                                         ("rm", "tensor"),
                                         ("laplace", "tensor"),
                                         ("tensorsketch", "hadamard"),
                                         ("exact", "subsample")])
def test_prefill_state_then_decode_steps_match_jax(kind, fusion):
    # slay_prefill_state over the prompt, then 4 slay_decode_steps; the
    # port's step runs K2's plain twin in place on a copy, so the
    # caller's state is left as it was.
    jcfg, tcfg, jp, tp = _pair(kind, fusion, seed=4)
    q, k, v, _ = _qkv(5)
    want = jslay.slay_prefill_state(jp, jnp.asarray(k), jnp.asarray(v), jcfg)
    got = tcore.slay_prefill_state(tp, torch.from_numpy(k),
                                   torch.from_numpy(v), tcfg)
    _near(got.s, want.s, 1e-5)
    _near(got.z, want.z, 1e-5)
    rng = np.random.default_rng(6)
    for _ in range(4):
        q1 = rng.normal(size=(B, H, D_HEAD)).astype(np.float32)
        k1 = rng.normal(size=(B, HKV, D_HEAD)).astype(np.float32)
        v1 = rng.normal(size=(B, HKV, D_HEAD)).astype(np.float32)
        wy, want = jslay.slay_decode_step(
            jp, *(jnp.asarray(x) for x in (q1, k1, v1)), want, jcfg)
        before = tla.LinearState(got.s.clone(), got.z.clone())
        gy, nxt = tcore.slay_decode_step(
            tp, *(torch.from_numpy(x) for x in (q1, k1, v1)), got, tcfg)
        assert torch.equal(got.s, before.s) and torch.equal(got.z, before.z)
        got = nxt
        _near(gy, wy, 1e-4)
        _near(got.s, want.s, 1e-5)
        _near(got.z, want.z, 1e-5)


def test_decode_step_refuses_m_past_the_kernels_limit():
    # K2 holds each block's slice of Ψq for the whole group: at G = 48 and
    # dv = 16 it takes m <= 8680; both devices refuse m past it before
    # any work.
    assert tdecode.max_feature_dim(1, 64) == 230120
    m = tdecode.max_feature_dim(48, 16)
    assert m == 8680
    assert tdecode.decode_smem_bytes(48, m + 1, 16) > 232448
    args = (torch.zeros(48, m + 1), torch.zeros(1, m + 1), torch.zeros(1, 16),
            torch.zeros(1, m + 1, 16), torch.zeros(1, m + 1))
    with pytest.raises(ValueError, match="m <= 8680"):
        tdecode.decode_linear_attention(*args)


@pytest.mark.parametrize("nodes,eps", [(1, 1e-3), (3, 1e-3), (8, 0.1)])
def test_quadrature_helpers_identical(nodes, eps):
    x = np.linspace(-1.0, 1.0, 257)
    np.testing.assert_array_equal(tquad.quadrature_kernel(x, nodes, eps),
                                  jquad.quadrature_kernel(x, nodes, eps))
    np.testing.assert_array_equal(tquad.exact_spherical_yat(x, eps),
                                  jquad.exact_spherical_yat(x, eps))
    assert tquad.quadrature_kernel(x, nodes, eps).dtype == np.float64


@pytest.mark.parametrize("task", jtasks.ALL_TASKS)
def test_tasks_generate_and_accuracy_identical(task):
    assert ttasks.ALL_TASKS == jtasks.ALL_TASKS
    got = ttasks.generate(task, np.random.default_rng(7), 4, 48, 32)
    want = jtasks.generate(task, np.random.default_rng(7), 4, 48, 32)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    logits = np.random.default_rng(8).normal(size=(4, 48, 32))
    assert ttasks.accuracy(logits, got["labels"], got["mask"]) == \
        jtasks.accuracy(logits, want["labels"], want["mask"])


def test_fused_route_predicate():
    # The fused kernels' shared memory (csrc layouts, copied here) holds a
    # node's whole (P·D, dv) carry: slayformer's P·D = 128 fits, Table 2's
    # P = D = 32 does not; the numbers are the docstrings'.
    assert tfused.fused_smem_bytes(64, 64, 8, 16, es=2) == 83584
    assert tfused.fused_smem_bytes(64, 64, 8, 16) == 89728
    assert tfused.fused_smem_bytes(32, 32, 32, 32) == 316160
    assert tfused.fused_bwd_smem_bytes(64, 64, 8, 16, es=2) == 104832
    assert tfused.fused_bwd_smem_bytes(64, 64, 8, 16) == 115072
    for grad in (False, True):
        assert tfused.fused_fits(64, 64, 8, 16, 3, grad, "cpu")
        assert not tfused.fused_fits(32, 32, 32, 32, 3, grad, "cpu")
        assert not tfused.fused_fits(64, 64, 32, 32, 3, grad, "cpu")


def test_anchor_past_the_fused_width_takes_two_dispatch_and_matches_jax(
        monkeypatch):
    # At P = D = 32 (m = 3072) ops.slay_fused_attention runs the feature
    # map then the scan, never the fused entry, forward and backward;
    # against the JAX reference as above.
    jcfg, tcfg, jp, tp = _pair("anchor", "tensor", seed=9, d=32,
                               num_anchors=32, num_prf=32)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused kernel ran")

    monkeypatch.setattr(tfused, "fused_causal_attention", refuse)
    rng = np.random.default_rng(10)
    q = rng.normal(size=(1, 19, 2, 32)).astype(np.float32)
    k = rng.normal(size=(1, 19, 1, 32)).astype(np.float32)
    v = rng.normal(size=(1, 19, 1, 32)).astype(np.float32)
    dy = rng.normal(size=(1, 19, 2, 32)).astype(np.float32)
    want_y, want = _jax_grads(jp, q, k, v, dy, jcfg, True)
    got_y, got = _port_grads(tp, q, k, v, dy, tcfg, True)
    _near(got_y, want_y, 1e-4)
    for g, w in zip(got, want, strict=True):
        _near(g, w, 1e-4)
