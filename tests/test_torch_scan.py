"""The port's two-dispatch path (feature map, then scan) against the JAX
package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as the JAX tests do. Both
compute Ψ in fp32 and accumulate in fp32, so in fp32 they differ only in
summation order: Ψ and y are held to 1e-5, den (a sum of up to L
nonnegative terms) to 1e-5 relative, and gradients to 1e-4 of each
gradient's largest magnitude (dA and dΩ sum over every token). Ψ in bf16
is held to one bf16 step (at most 2^-7 relative) of the JAX kernel's bf16
output: the two fp32 values may round to neighbouring bf16 numbers.
One train step on the two-dispatch path is held to the JAX step as
``tests/test_torch_train.py`` holds the fused one. The kernel-vs-plain
cases, which need the card, are in ``tests/test_torch_card.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import features as jfeat
from repro.core import slay as jslay
from repro.kernels import feature_map as jfm
from repro.kernels import ops as jops
from repro.kernels import slay_scan as jscan
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import features as tfeat
from repro_torch.core import slay as tslay
from repro_torch.kernels import _build
from repro_torch.kernels import feature_map as tfm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slay_scan as tscan
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items

torch.set_num_threads(1)    # small ops; the suite runs one process per core

D_HEAD, CHUNK = 16, 16


def _cfgs(**kw):
    return (jfeat.SlayFeatureConfig(head_dim=D_HEAD, **kw),
            tfeat.SlayFeatureConfig(head_dim=D_HEAD, **kw))


def _proj(jcfg, seed=0):
    jp = jfeat.init_feature_params(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(jp[k])) for k in ("anchors", "omegas")}
    return jp, tp


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _grad_tol(got, want):
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=0.0, atol=1e-4 * scale)


def _scan_inputs(seed, bh, bk, L, m, dv):
    """Features are nonnegative, as Ψ is; v and the cotangent normal."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (bh, L, m)).astype(np.float32),
            rng.uniform(0.0, 1.0, (bk, L, m)).astype(np.float32),
            rng.normal(size=(bk, L, dv)).astype(np.float32),
            rng.normal(size=(bh, L, dv)).astype(np.float32))


SCAN_CASES = [
    (4, 2, 64, 48, 32, 16),     # GQA G = 2
    (2, 2, 32, 16, 16, 8),      # MHA
    (6, 1, 48, 24, 8, 16),      # MQA G = 6
    (1, 1, 16, 8, 4, 16),       # one head, chunk == L
]


# -- B5: the scan forward ------------------------------------------------


@pytest.mark.parametrize("bh,bk,L,m,dv,chunk", SCAN_CASES)
def test_scan_forward_matches_pallas(bh, bk, L, m, dv, chunk):
    qf, kf, v, _ = _scan_inputs(bh + L + m, bh, bk, L, m, dv)
    st = jscan.ScanStatics(chunk_size=chunk, delta=1e-6, interpret=True)
    wy, wden = jscan._fwd_impl(st, *(jnp.asarray(x) for x in (qf, kf, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (qf, kf, v))
    y = tscan.causal_linear_attention(tq, tk, tv, chunk_size=chunk)
    gy, gden = tscan.causal_linear_attention_plain(tq, tk, tv,
                                                   chunk_size=chunk)
    assert y.shape == (bh, L, dv) and gden.dtype == torch.float32
    _close(y, wy)
    _close(gy, wy)
    _close(gden, wden, atol=0.0)


def test_scan_plain_twin_matches_core_oracle_at_any_chunk():
    # Chunking only orders the evaluation (the CUDA kernel tiles by 16):
    # the twin at chunks 8 and 48 against the core.linear_attention oracle.
    qf, kf, v, _ = (torch.from_numpy(x) for x in _scan_inputs(3, 6, 3, 48, 24, 8))
    want = tref.causal_linear_attention_ref(qf, kf, v, chunk_size=16)
    for chunk in (8, 48):
        _close(tscan.causal_linear_attention(qf, kf, v, chunk_size=chunk), want)


def test_scan_bf16_keeps_dtypes():
    # bf16 in, y bf16 out, den fp32: the JAX kernel's dtypes. One bf16
    # rounding of y (|y| < 4 here) on each side: 3e-2, as the JAX test.
    qf, kf, v, _ = _scan_inputs(5, 2, 2, 32, 16, 8)
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (qf, kf, v)]
    tx = [torch.from_numpy(x).bfloat16() for x in (qf, kf, v)]
    want = jscan.causal_linear_attention(*jx, chunk_size=8, interpret=True)
    y, den = tscan.causal_linear_attention_plain(*tx, chunk_size=8)
    assert y.dtype == torch.bfloat16 and den.dtype == torch.float32
    _close(y.float(), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


# -- B6: the scan backward -----------------------------------------------


@pytest.mark.parametrize("bh,bk,L,m,dv,chunk", SCAN_CASES)
def test_scan_grads_match_pallas_vjp(bh, bk, L, m, dv, chunk):
    # Autograd through ScanAttention (the plain backward on the CPU)
    # against jax.vjp through the _scan custom VJP in interpret mode.
    qf, kf, v, dy = _scan_inputs(7 * bh + L, bh, bk, L, m, dv)

    def jfn(*xs):
        return jscan.causal_linear_attention(*xs, chunk_size=chunk,
                                             interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (qf, kf, v)))
    want = vjp(jnp.asarray(dy))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (qf, kf, v)]
    y = tscan.causal_linear_attention(*xs, chunk_size=chunk)
    got = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    for g, wnt in zip(got, want, strict=True):
        assert g.shape == wnt.shape
        _grad_tol(g, wnt)


@pytest.mark.parametrize("bh,bk", [(3, 3), (4, 2)])
def test_scan_plain_bwd_matches_autograd_of_plain_forward(bh, bk):
    # The hand-written backward (and its per-q-head partials, summed)
    # against torch autograd through the plain forward, an oracle that
    # shares none of its code.
    qf, kf, v, dy = (torch.from_numpy(x)
                     for x in _scan_inputs(bh, bh, bk, 48, 24, 8))
    xs = [t.clone().requires_grad_(True) for t in (qf, kf, v)]
    y, den = tscan.causal_linear_attention_plain(*xs, chunk_size=CHUNK)
    want = torch.autograd.grad(y, xs, dy)
    got = tscan.causal_linear_attention_bwd_plain(
        qf, kf, v, y.detach(), den.detach(), dy, chunk_size=CHUNK)
    for g, wnt in zip(got, want, strict=True):
        _grad_tol(g, wnt)
    dk_p, dv_p = tscan.scan_bwd_kv_plain(qf, kf, v, y.detach(), den.detach(),
                                         dy, chunk_size=CHUNK)
    assert dk_p.shape == (bh, 48, 24) and dv_p.shape == (bh, 48, 8)


# -- B7 and B8: the feature map and its VJP --------------------------------


@pytest.mark.parametrize("n,block,nodes", [(64, 32, 3), (96, 32, 1)])
def test_feature_map_matches_pallas(n, block, nodes):
    jcfg, tcfg = _cfgs(num_quad_nodes=nodes)
    jp, tp = _proj(jcfg)
    u = np.random.default_rng(n).normal(size=(n, D_HEAD)).astype(np.float32)
    u[5] = 0.0                                      # Ψ(0) = 0, eps-guarded
    want = jfm.slay_feature_map(jnp.asarray(u), jp["anchors"], jp["omegas"],
                                jcfg, block_tokens=block, interpret=True)
    got = tfm.slay_feature_map(torch.from_numpy(u), tp["anchors"],
                               tp["omegas"], tcfg, block_tokens=block)
    assert got.shape == (n, tcfg.feature_dim) and got.dtype == torch.float32
    _close(got, want)
    assert not torch.count_nonzero(got[5])


def test_feature_map_bf16_writes_psi_in_u_dtype():
    # Ψ in u's dtype (feature_map.py:99): both sides compute fp32 and round
    # once to bf16, so they agree to one bf16 step (at most 2^-7 relative).
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    u = np.random.default_rng(9).normal(size=(64, D_HEAD)).astype(np.float32)
    want = jfm.slay_feature_map(jnp.asarray(u).astype(jnp.bfloat16),
                                jp["anchors"], jp["omegas"], jcfg,
                                block_tokens=32, interpret=True)
    got = tfm.slay_feature_map(torch.from_numpy(u).bfloat16(), tp["anchors"],
                               tp["omegas"], tcfg, block_tokens=32)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=2 ** -7, atol=0.0)


def test_feature_map_grads_match_pallas_vjp():
    # du, dA and dΩ through FeatureMap (B8's plain twin) against jax.vjp
    # through the _fmap custom VJP in interpret mode.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    rng = np.random.default_rng(12)
    u = rng.normal(size=(64, D_HEAD)).astype(np.float32)
    dpsi = rng.normal(size=(64, tcfg.feature_dim)).astype(np.float32)
    a, w = np.array(jp["anchors"]), np.array(jp["omegas"])

    def jfn(u, a, w):
        return jfm.slay_feature_map(u, a, w, jcfg, block_tokens=32,
                                    interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (u, a, w)))
    want = vjp(jnp.asarray(dpsi))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (u, a, w)]
    psi = tfm.slay_feature_map(*xs, tcfg, block_tokens=32)
    got = torch.autograd.grad(psi, xs, torch.from_numpy(dpsi))
    for g, wnt in zip(got, want, strict=True):
        assert g.shape == wnt.shape
        _grad_tol(g, wnt)


def test_feature_map_backward_with_constant_projections():
    # In the model the projections are detached constants: du alone flows
    # back, and it equals the plain VJP's.
    jcfg, tcfg = _cfgs()
    _, tp = _proj(jcfg)
    u = torch.randn(40, D_HEAD, generator=torch.Generator().manual_seed(1))
    u.requires_grad_(True)
    psi = tfm.feature_map(u, tp["anchors"], tp["omegas"], tcfg)
    (du,) = torch.autograd.grad(psi.sum(), [u])
    want, _, _ = tfm.feature_map_bwd_plain(u.detach(), tp["anchors"],
                                           tp["omegas"], torch.ones_like(psi),
                                           tcfg)
    _close(du, want)


def test_feature_map_bwd_without_projection_grads_returns_du_alone():
    # proj_grads=False (FeatureMap.backward with detached projections)
    # skips dA and dΩ; du is the full VJP's.
    jcfg, tcfg = _cfgs()
    _, tp = _proj(jcfg)
    gen = torch.Generator().manual_seed(2)
    u = torch.randn(40, D_HEAD, generator=gen)
    dpsi = torch.randn(40, tcfg.feature_dim, generator=gen)
    args = (u, tp["anchors"], tp["omegas"], dpsi, tcfg)
    du, da, dw = tfm.feature_map_bwd(*args, proj_grads=False)
    assert da is None and dw is None
    torch.testing.assert_close(du, tfm.feature_map_bwd(*args)[0], rtol=0.0,
                               atol=0.0)


# -- the model-layout wrappers -------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37, 3, D_HEAD), (5, D_HEAD), (0, D_HEAD)])
def test_ops_slay_features_matches_pallas_at_ragged_sizes(shape):
    # No padding on the port's side; the JAX entry pads to 256 and slices.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    u = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    want = jops.slay_features(jnp.asarray(u), jp, jcfg, interpret=True)
    got = tops.slay_features(torch.from_numpy(u), tp, tcfg)
    assert got.shape == (*shape[:-1], tcfg.feature_dim)
    _close(got, want)
    _close(got, tref.slay_features_ref(torch.from_numpy(u), tp, tcfg))


@pytest.mark.parametrize("B,L,H,Hkv", [(2, 37, 4, 4), (1, 29, 4, 2)])
def test_ops_slay_causal_attention_ragged_matches_pallas(B, L, H, Hkv):
    # Ragged L (zero padding at the feature level) and GQA head grouping,
    # forward and gradients carried back through pad, reshape and permute.
    rng = np.random.default_rng(L + H)
    qf = rng.uniform(0.0, 1.0, (B, L, H, 24)).astype(np.float32)
    kf = rng.uniform(0.0, 1.0, (B, L, Hkv, 24)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, 8)).astype(np.float32)
    dy = rng.normal(size=(B, L, H, 8)).astype(np.float32)

    def jfn(*xs):
        return jops.slay_causal_attention(*xs, chunk_size=CHUNK,
                                          interpret=True)

    wy, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (qf, kf, v)))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (qf, kf, v)]
    y = tops.slay_causal_attention(*xs, chunk_size=CHUNK)
    assert y.shape == (B, L, H, 8)
    _close(y.detach(), wy)
    got = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    for g, wnt in zip(got, vjp(jnp.asarray(dy)), strict=True):
        assert g.shape == wnt.shape
        _grad_tol(g, wnt)


def test_slay_attention_two_dispatch_matches_jax():
    # slay_attention(fuse_features=False) against the JAX function with
    # use_kernel=True, fuse_features=False in interpret mode: y and the
    # q/k/v gradients; ragged L = 21 and GQA.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg, seed=4)
    rng = np.random.default_rng(21)
    q = rng.normal(size=(2, 21, 4, D_HEAD)).astype(np.float32)
    k = rng.normal(size=(2, 21, 2, D_HEAD)).astype(np.float32)
    v = rng.normal(size=(2, 21, 2, 8)).astype(np.float32)
    dy = rng.normal(size=(2, 21, 4, 8)).astype(np.float32)

    def jfn(q, k, v):
        return jslay.slay_attention(jp, q, k, v, jcfg, chunk_size=8,
                                    use_kernel=True, fuse_features=False,
                                    interpret=True)

    wy, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    y = tslay.slay_attention(tp, *xs, tcfg, chunk_size=8, fuse_features=False)
    _close(y.detach(), wy)
    got = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    for g, wnt in zip(got, vjp(jnp.asarray(dy)), strict=True):
        _grad_tol(g, wnt)


# -- one train step on the two-dispatch path -----------------------------


def test_two_dispatch_train_step_matches_jax():
    # make_train_step with fuse_attention_features=False on both sides from
    # identical params and batch (the JAX step runs the jnp path off-TPU,
    # the same math): loss to 1e-5 relative, grad_norm to 1e-4, params
    # after the step to 2·lr (AdamW's step range, see test_torch_train).
    name = "slayformer-124m"
    jcfg = jax_smoke_config(name, dtype="float32")
    tcfg = get_smoke_config(name, dtype="float32")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (4, 25)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jloop.make_train_step(
        jcfg, jadamw.AdamWConfig(**kw),
        jloop.TrainConfig(remat=False, fuse_attention_features=False))
    jparams, _, _, jm = jstep(
        jp, jadamw.adamw_init(jp, jadamw.AdamWConfig(**kw)), jnp.zeros(()),
        {k: jnp.asarray(x) for k, x in b.items()})
    tp = convert.params_from_numpy(jax.device_get(jp), device="cpu")
    tocfg = tadamw.AdamWConfig(**kw)
    tcfg_train = tloop.TrainConfig(remat=False, fuse_attention_features=False)
    _build.reset_launches()
    tstep = tloop.make_train_step(tcfg, tocfg, tcfg_train)
    tparams, _, _, tm = tstep(tp, tadamw.adamw_init(tp, tocfg), torch.zeros(()),
                              {k: torch.from_numpy(x) for k, x in b.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert all(n == 0 for n in _build.LAUNCHES.values())      # CPU: plain
    lr = float(jm["lr"])
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {k: t.float().numpy() for k, t in tree_items(tparams)}
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert np.abs(got[key] - w).max() <= 2 * lr, key


def test_resolve_attention_path_overrides_only_when_set():
    cfg = get_smoke_config("slayformer-124m")
    assert tloop.resolve_attention_path(cfg, tloop.TrainConfig()) is cfg
    off = tloop.resolve_attention_path(
        cfg, tloop.TrainConfig(fuse_attention_features=False))
    assert off == dataclasses.replace(cfg, fuse_attention_features=False)
    assert not off.attention_spec().fuse_features


# -- wrapper checks ------------------------------------------------------


def _scan_args():
    return [torch.zeros(4, 32, 24), torch.zeros(2, 32, 24), torch.zeros(2, 32, 8)]


@pytest.mark.parametrize("bad,exc", [
    (lambda a: a.__setitem__(0, a[0].half()), TypeError),          # dtype
    (lambda a: a.__setitem__(1, a[1].bfloat16()), TypeError),      # mixed
    (lambda a: a.__setitem__(0, a[0][:3]), ValueError),            # BH % BK
    (lambda a: a.__setitem__(1, a[1][:, :16]), ValueError),        # kf length
    (lambda a: a.__setitem__(1, a[1][..., :8]), ValueError),       # kf width
    (lambda a: a.__setitem__(
        0, torch.zeros(4, 24, 32).transpose(1, 2)), ValueError),   # strides
])
def test_scan_wrapper_rejects(bad, exc):
    args = _scan_args()
    bad(args)
    with pytest.raises(exc):
        tscan.causal_linear_attention(*args, chunk_size=CHUNK)


def test_scan_wrapper_rejects_ragged_and_checks_residuals():
    args = _scan_args()
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tscan.causal_linear_attention(*args, chunk_size=24)
    y, den = tscan.causal_linear_attention_plain(*args, chunk_size=CHUNK)
    dy = torch.zeros_like(y)
    with pytest.raises(TypeError, match="den float32"):
        tscan.causal_linear_attention_bwd(*args, y, den.double(), dy,
                                          chunk_size=CHUNK)
    with pytest.raises(ValueError, match="do not match"):
        tscan.causal_linear_attention_bwd(*args, y[:, :16], den, dy,
                                          chunk_size=CHUNK)


def test_feature_map_wrapper_rejects():
    jcfg, tcfg = _cfgs()
    _, tp = _proj(jcfg)
    a, w = tp["anchors"], tp["omegas"]
    u = torch.zeros(64, D_HEAD)
    with pytest.raises(ValueError, match="not divisible by block"):
        tfm.slay_feature_map(u[:40], a, w, tcfg, block_tokens=32)
    with pytest.raises(ValueError, match="anchor\\+tensor only"):
        tfm.slay_feature_map(u, a, w, dataclasses.replace(tcfg, fusion="hadamard"))
    with pytest.raises(TypeError):
        tfm.feature_map(u.half(), a, w, tcfg)
    with pytest.raises(TypeError):
        tfm.feature_map(u, a.double(), w, tcfg)
    with pytest.raises(ValueError, match="head dim"):
        tfm.feature_map(u[:, :8], a, w, tcfg)
    with pytest.raises(ValueError, match="contiguous"):
        tfm.feature_map(torch.zeros(D_HEAD, 64).t(), a, w, tcfg)
    with pytest.raises(ValueError, match="does not match"):
        tfm.feature_map_bwd(u, a, w, torch.zeros(64, 8), tcfg)
