"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as the JAX tests do. Both
compute Ψ in fp32 and accumulate in fp32, so they differ only in summation
order: y is held to 1e-5, den (a sum of up to L nonnegative terms of order
one) to 1e-5 relative. The decode state update is one add per element on
both sides and must match to 1e-6. Gradients of the fused attention (the
custom VJP on the JAX side, the autograd Function on the port's) are held
to 1e-4 of each gradient's largest magnitude: dA and dΩ sum over every
token of every head. The kernel-vs-plain cases, which need the card, are
in ``tests/test_torch_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.kernels import common as jcommon
from repro.kernels import decode_step as jdecode
from repro.kernels import ops as jops
from repro.kernels import slay_fused as jfused
from repro_torch.core import features as tfeat
from repro_torch.kernels import _build
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import decode_step as tdecode
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slay_fused as tfused

D_HEAD, CHUNK = 16, 16


def _cfgs():
    return (jfeat.SlayFeatureConfig(head_dim=D_HEAD),
            tfeat.SlayFeatureConfig(head_dim=D_HEAD))


def _proj(jcfg):
    jp = jfeat.init_feature_params(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(jp[k])) for k in ("anchors", "omegas")}
    return jp, tp


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,L,H,Hkv", [(2, 37, 4, 4), (1, 29, 4, 2)])
def test_fused_forward_model_layout_matches_pallas(B, L, H, Hkv):
    # ops.slay_fused_attention: ragged L (zero padding), GQA head grouping.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    rng = np.random.default_rng(L)
    q = rng.normal(size=(B, L, H, D_HEAD)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, D_HEAD)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, 8)).astype(np.float32)
    want = jops.slay_fused_attention(*(jnp.asarray(x) for x in (q, k, v)), jp,
                                     jcfg, chunk_size=CHUNK, interpret=True)
    got = tops.slay_fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    tp, tcfg, chunk_size=CHUNK)
    assert got.shape == (B, L, H, 8)
    _close(got, want)


def test_fused_forward_head_major_y_and_den_match_pallas():
    # The kernel entry itself, GQA BH = 2·BK: y and the den residual.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(4, 48, D_HEAD)).astype(np.float32)
    k = rng.normal(size=(2, 48, D_HEAD)).astype(np.float32)
    v = rng.normal(size=(2, 48, 8)).astype(np.float32)
    st = jfused.statics_for(jcfg, chunk_size=CHUNK, delta=1e-6, interpret=True)
    wy, wden = jfused._fwd_impl(st, *(jnp.asarray(x) for x in (q, k, v)),
                                jp["anchors"], jp["omegas"])
    gy, gden = tfused.fused_causal_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), tp["anchors"],
        tp["omegas"], tcfg, chunk_size=CHUNK)
    assert gden.dtype == torch.float32 and gden.shape == (4, 48)
    _close(gy, wy)
    _close(gden, wden, rtol=1e-5, atol=0.0)
    # Chunking only orders the evaluation (the CUDA kernel tiles by 16).
    oy, oden = tfused.fused_causal_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), tp["anchors"],
        tp["omegas"], tcfg, chunk_size=48)
    _close(oy, gy)
    _close(oden, gden, rtol=1e-5, atol=0.0)


def test_fused_plain_twin_matches_core_oracle():
    # The kernel's plain twin (kernels.common Ψ, per-chunk scan) against
    # the oracle built from core.features and core.linear_attention.
    jcfg, tcfg = _cfgs()
    _, tp = _proj(jcfg)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(6, 32, D_HEAD, generator=gen)
    k = torch.randn(3, 32, D_HEAD, generator=gen)
    v = torch.randn(3, 32, 8, generator=gen)
    got, _ = tfused.fused_causal_attention(q, k, v, tp["anchors"],
                                           tp["omegas"], tcfg, chunk_size=8)
    want = tref.fused_causal_attention_ref(q, k, v, tp, tcfg, chunk_size=16)
    _close(got, want)


def _decode_inputs(seed, bh, bk, m=24, dv=8):
    rng = np.random.default_rng(seed)
    qf = rng.uniform(0.0, 1.0, (bh, m)).astype(np.float32)
    kf = rng.uniform(0.0, 1.0, (bk, m)).astype(np.float32)
    v = rng.normal(size=(bk, dv)).astype(np.float32)
    s = rng.normal(size=(bk, m, dv)).astype(np.float32)
    z = rng.uniform(0.0, 4.0, (bk, m)).astype(np.float32)
    return qf, kf, v, s, z


@pytest.mark.parametrize("bh,bk,masked", [(6, 6, False), (8, 4, False),
                                          (6, 6, True), (8, 4, True)])
def test_decode_matches_pallas(bh, bk, masked):
    qf, kf, v, s, z = _decode_inputs(bh + bk, bh, bk)
    active = (np.arange(bk) % 3 != 1).astype(np.int32) if masked else None
    jy, js, jz = jdecode.decode_linear_attention(
        *(jnp.asarray(x) for x in (qf, kf, v, s, z)),
        None if active is None else jnp.asarray(active), interpret=True)
    ts, tz = torch.from_numpy(s.copy()), torch.from_numpy(z.copy())
    ty, ts2, tz2 = tdecode.decode_linear_attention(
        *(torch.from_numpy(x) for x in (qf, kf, v)), ts, tz,
        None if active is None else torch.from_numpy(active))
    assert ts2 is ts and tz2 is tz                  # updated in place
    _close(ty, jy)
    _close(ts, js, rtol=1e-6, atol=1e-6)
    _close(tz, jz, rtol=1e-6, atol=1e-6)
    if masked:
        off = torch.from_numpy(active == 0)
        g = bh // bk
        # Drained rows: state bit-identical, y exactly zero.
        assert torch.equal(ts[off], torch.from_numpy(s)[off])
        assert torch.equal(tz[off], torch.from_numpy(z)[off])
        assert bool((ty.reshape(bk, g, -1)[off] == 0).all())


def test_decode_model_layout_matches_pallas():
    # ops.decode_linear_step: (B, H, m) layout, B·Hkv kv rows, slot mask.
    rng = np.random.default_rng(7)
    B, H, Hkv, m, dv = 3, 4, 2, 24, 8
    qf = rng.uniform(0.0, 1.0, (B, H, m)).astype(np.float32)
    kf = rng.uniform(0.0, 1.0, (B, Hkv, m)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, dv)).astype(np.float32)
    s = rng.normal(size=(B, Hkv, m, dv)).astype(np.float32)
    z = rng.uniform(0.0, 4.0, (B, Hkv, m)).astype(np.float32)
    active = np.array([1, 0, 1], np.int32)
    jy, js, jz = jops.decode_linear_step(
        *(jnp.asarray(x) for x in (qf, kf, v, s, z)), jnp.asarray(active),
        interpret=True)
    ts, tz = torch.from_numpy(s.copy()), torch.from_numpy(z.copy())
    ty, ts2, tz2 = tops.decode_linear_step(
        *(torch.from_numpy(x) for x in (qf, kf, v)), ts, tz,
        torch.from_numpy(active))
    assert ts2 is ts and tz2 is tz
    _close(ty, jy)
    _close(ts, js, rtol=1e-6, atol=1e-6)
    _close(tz, jz, rtol=1e-6, atol=1e-6)


def _fused_args():
    _, tcfg = _cfgs()
    p = tfeat.init_feature_params(tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    q = torch.zeros(4, 32, D_HEAD)
    k = torch.zeros(2, 32, D_HEAD)
    v = torch.zeros(2, 32, 8)
    return [q, k, v, p["anchors"], p["omegas"]], tcfg


@pytest.mark.parametrize("bad,exc", [
    (lambda a: a.__setitem__(0, a[0].half()), TypeError),          # dtype
    (lambda a: a.__setitem__(1, a[1].bfloat16()), TypeError),      # mixed
    (lambda a: a.__setitem__(3, a[3].double()), TypeError),        # anchors
    (lambda a: a.__setitem__(0, a[0][:3]), ValueError),            # BH % BK
    (lambda a: a.__setitem__(1, a[1][:, :16]), ValueError),        # k length
    (lambda a: a.__setitem__(0, a[0][..., :8]), ValueError),       # head dim
    (lambda a: a.__setitem__(
        0, torch.zeros(4, D_HEAD, 32).transpose(1, 2)), ValueError),  # strides
])
def test_fused_wrapper_rejects(bad, exc):
    args, cfg = _fused_args()
    bad(args)
    with pytest.raises(exc):
        tfused.fused_causal_attention(*args, cfg, chunk_size=CHUNK)


def test_fused_wrapper_rejects_ragged_and_grad():
    # Ragged L is the ops wrapper's job; gradients now flow to every input.
    args, cfg = _fused_args()
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tfused.fused_causal_attention(*args, cfg, chunk_size=24)
    for a in args:
        a.requires_grad_(True)
    y, den = tfused.fused_causal_attention(*args, cfg, chunk_size=CHUNK)
    assert y.requires_grad and not den.requires_grad
    y.sum().backward()
    assert all(a.grad is not None and a.grad.shape == a.shape for a in args)


@pytest.mark.parametrize("which,bad,exc", [
    (0, lambda t: t.half(), TypeError),                  # qf dtype
    (3, lambda t: t.bfloat16(), TypeError),              # state must be fp32
    (3, lambda t: t[:, :12], ValueError),                # state shape
    (4, lambda t: t.t().contiguous().t(), ValueError),   # strided z
    (5, lambda t: t.long(), TypeError),                  # active dtype
    (5, lambda t: t[:2], ValueError),                    # active shape
])
def test_decode_wrapper_rejects(which, bad, exc):
    args = [torch.from_numpy(x) for x in _decode_inputs(0, 6, 3)]
    args.append(torch.ones(3, dtype=torch.int32))
    args[which] = bad(args[which])
    with pytest.raises(exc):
        tdecode.decode_linear_attention(*args)


def test_decode_wrapper_rejects_grad():
    args = [torch.from_numpy(x) for x in _decode_inputs(0, 6, 3)]
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue B under B4"):
        tdecode.decode_linear_attention(*args)


def test_cpu_tensors_launch_nothing():
    # The plain versions run for CPU tensors, and only they: no launch is
    # counted and no kernel library is built or loaded.
    _build.reset_launches()
    args, cfg = _fused_args()
    args[0].requires_grad_(True)
    y, _ = tfused.fused_causal_attention(*args, cfg, chunk_size=CHUNK)
    y.sum().backward()                       # the plain backward
    dargs = [torch.from_numpy(x) for x in _decode_inputs(0, 6, 3)]
    tdecode.decode_linear_attention(*dargs)
    tdecode.decode_linear_attention(*dargs, torch.tensor([1, 0, 1],
                                                         dtype=torch.int32))
    # The two-dispatch path, feature map then scan, and their backward.
    params = {"anchors": args[3], "omegas": args[4]}
    x = torch.ones(1, 32, 2, D_HEAD, requires_grad=True)
    xf = tops.slay_features(x, params, cfg)
    tops.slay_causal_attention(xf, xf, x[..., :8],
                               chunk_size=CHUNK).sum().backward()
    assert _build.LAUNCHES == {
        "slay_fused_fwd": 0, "slay_fused_bwd_q": 0, "slay_fused_bwd_kv": 0,
        "slay_decode_step": 0, "slay_decode_step_masked": 0,
        "feature_map_fwd": 0, "feature_map_bwd": 0,
        "slay_scan_fwd": 0, "slay_scan_bwd_q": 0, "slay_scan_bwd_kv": 0}
    assert not _build._LIBS


# -- the backward (B2 + B3) ---------------------------------------------


def _grad_tol(got, want):
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=0.0, atol=1e-4 * scale)


def _bwd_inputs(seed, bh, bk, L, dv=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((bh, L, D_HEAD), (bk, L, D_HEAD), (bk, L, dv), (bh, L, dv))]


def test_features_bwd_matches_jax():
    # The Ψ VJP, called directly on both sides: du, dA, dΩ within 1e-5.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    rng = np.random.default_rng(11)
    u = rng.normal(size=(13, D_HEAD)).astype(np.float32)
    u[3] = 0.0                                      # the eps-guarded zero row
    dpsi = rng.normal(size=(13, tcfg.feature_dim)).astype(np.float32)
    jst = jfused.statics_for(jcfg, chunk_size=CHUNK, delta=1e-6,
                             interpret=True).feat
    tst = tcommon.feature_statics(tcfg)
    _, jres = jcommon.features_fwd(jnp.asarray(u), jp["anchors"], jp["omegas"],
                                   jst)
    want = jcommon.features_bwd(jnp.asarray(dpsi), jres, jp["anchors"],
                                jp["omegas"], jst)
    _, tres = tcommon.features_fwd(torch.from_numpy(u), tp["anchors"],
                                   tp["omegas"], tst)
    got = tcommon.features_bwd(torch.from_numpy(dpsi), tres, tp["anchors"],
                               tp["omegas"], tst)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("bh,bk,chunk", [(4, 4, 16), (4, 2, 16), (4, 2, 32)])
def test_fused_grads_match_pallas_vjp(bh, bk, chunk):
    # Autograd through the port (the plain backward on the CPU) against
    # jax.vjp of the interpret-mode Pallas kernels: dq, dk, dv, dA, dΩ.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    q, k, v, dy = _bwd_inputs(bh + 10 * bk + chunk, bh, bk, 64)
    a, w = np.array(jp["anchors"]), np.array(jp["omegas"])

    def jfn(*xs):
        return jfused.fused_causal_attention(*xs, jcfg, chunk_size=chunk,
                                             interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v, a, w)))
    want = vjp(jnp.asarray(dy))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, a, w)]
    y, _ = tfused.fused_causal_attention(*xs, tcfg, chunk_size=chunk)
    got = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        _grad_tol(g, wnt)


def test_fused_grads_model_layout_ragged_matches_pallas_vjp():
    # ops.slay_fused_attention: ragged L = 37 (zero padding) and GQA, the
    # gradients carried back through pad, reshape and permute.
    jcfg, tcfg = _cfgs()
    jp, tp = _proj(jcfg)
    rng = np.random.default_rng(37)
    B, L, H, Hkv = 1, 37, 4, 2
    q = rng.normal(size=(B, L, H, D_HEAD)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, D_HEAD)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, 8)).astype(np.float32)
    dy = rng.normal(size=(B, L, H, 8)).astype(np.float32)

    def jfn(q, k, v):
        return jops.slay_fused_attention(q, k, v, jp, jcfg, chunk_size=CHUNK,
                                         interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dy))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    y = tops.slay_fused_attention(*xs, tp, tcfg, chunk_size=CHUNK)
    got = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        _grad_tol(g, wnt)


@pytest.mark.parametrize("bh,bk", [(3, 3), (4, 2)])
def test_plain_bwd_matches_autograd_of_plain_forward(bh, bk):
    # The hand-written backward against torch autograd through the plain
    # forward, an oracle that shares none of its code.
    _, tcfg = _cfgs()
    p = tfeat.init_feature_params(tcfg, torch.Generator().manual_seed(2),
                                  device="cpu")
    q, k, v, dy = (torch.from_numpy(x) for x in _bwd_inputs(bh, bh, bk, 48))
    xs = [t.clone().requires_grad_(True)
          for t in (q, k, v, p["anchors"], p["omegas"])]
    y, den = tfused.fused_causal_attention_plain(*xs, tcfg, chunk_size=CHUNK)
    want = torch.autograd.grad(y, xs, dy)
    got = tfused.fused_causal_attention_bwd_plain(
        q, k, v, p["anchors"], p["omegas"], y.detach(), den.detach(), dy,
        tcfg, chunk_size=CHUNK)
    for g, wnt in zip(got, want):
        _grad_tol(g, wnt)


def test_backward_limits_are_checked_from_shapes_and_addresses():
    # What K3/K4 take beyond K1's limits, checked from the tensors alone
    # (on the card this runs before K1 when the inputs need gradients).
    q = torch.zeros(2, 16, 16)
    tfused._check_bwd_inputs(tfeat.SlayFeatureConfig(head_dim=16), q=q)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfused._check_bwd_inputs(tfeat.SlayFeatureConfig(head_dim=12),
                                 q=torch.zeros(2, 16, 12))
    with pytest.raises(ValueError, match="P·D a multiple of 16"):
        tfused._check_bwd_inputs(
            tfeat.SlayFeatureConfig(head_dim=16, num_anchors=3, num_prf=4),
            q=q)
    off = torch.zeros(2 * 16 * 16 + 1)[1:].view(2, 16, 16)   # 4 bytes off
    with pytest.raises(ValueError, match="k must start on a 16-byte"):
        tfused._check_bwd_inputs(tfeat.SlayFeatureConfig(head_dim=16), q=q,
                                 k=off)
