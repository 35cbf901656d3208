"""The linear baselines in the port (``repro_torch.core.baselines``,
favor, cosformer, elu1) against the JAX package's, on the CPU.

Function level: each feature map and ``linear_baseline_attention``
(causal and not), ``linear_attention.noncausal``, cosformer's positions
in bf16 past 256 (they round in the input's dtype, as the reference
builds them) and favor's projection. Model level, the smoke-size
slayformer per kind in fp32 with the JAX weights crossing through numpy:
prefill, chunked prefill and decode (cache features, cosformer without
its position weights, ROADMAP C-8), forward logits, loss, gradients
(favor's projection gets zeros), one AdamW step against
``repro.train.loop.make_train_step``, and ``Trainer.run``.

Tolerances, as ``tests/test_torch_exact.py`` and ``test_torch_model.py``
state them: fp32 1e-5 relative and absolute (the same arithmetic in
another order of sums); bf16 3e-2 on outputs of scale 1 (a few bf16
roundings, 2^-8 each); logits 1e-4 absolute; the (S, z) state of a
decoded model 1e-5 relative and 1e-4 absolute (sums of ~40 products of
scale 10); gradients to 1e-4 of each leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import baselines as jbl
from repro.core import linear_attention as jla
from repro.models import api as japi
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import baselines as tbl
from repro_torch.core import linear_attention as tla
from repro_torch.models import api
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
KINDS = ["favor", "cosformer", "elu1"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
LOGIT_ATOL = 1e-4
STATE_TOL = dict(rtol=1e-5, atol=1e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32),
                               **(tol or TOL["float32"]))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(arrs, dtype):
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _favor_params(head_dim=16):
    jp = jbl.favor_init(jax.random.PRNGKey(3), head_dim)
    tp = {"proj": torch.from_numpy(np.array(jp["proj"]))}
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_feature_maps_match_jax(kind, dtype):
    (ju,), (tu,) = _both([_rand(np.random.default_rng(0), 2, 21, 3, 16)],
                         dtype)
    if kind == "favor":
        jp, tp = _favor_params()
        want, got = jbl.favor_features(ju, jp), tbl.favor_features(tu, tp)
    elif kind == "elu1":
        want, got = jbl.elu1_features(ju), tbl.elu1_features(tu)
    else:
        want = jbl.cosformer_features(ju, max_len=30)
        got = tbl.cosformer_features(tu, max_len=30)
    # favor's features are fp32 whatever u is (the reference divides by a
    # numpy float64, a float32 operand); the others keep u's dtype.
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert got.shape == want.shape
    _close(got, want, **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_linear_baseline_attention_matches_jax(kind, causal):
    # GQA (4 query heads on 2 kv heads), L = 21 over chunks of 8 (padded).
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 21, 4, 16), _rand(rng, 2, 21, 2, 16), _rand(
        rng, 2, 21, 2, 16)
    jp, tp = _favor_params() if kind == "favor" else (None, None)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "float32")
    want = jbl.linear_baseline_attention(kind, jp, jq, jk, jv, causal=causal,
                                         chunk_size=8)
    got = tbl.linear_baseline_attention(kind, tp, tq, tk, tv, causal=causal,
                                        chunk_size=8)
    _close(got, want)


def test_cosformer_bf16_positions_past_256():
    # L = 300 in bf16: positions 257.. round in bf16 (257 -> 256, 259 ->
    # 260) before the π/2M scale, on both sides; the attention follows.
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 1, 300, 2, 16) for _ in range(3))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "bfloat16")
    tpos = torch.arange(300, dtype=torch.bfloat16)
    assert tpos[257] == 256 and tpos[259] == 260
    np.testing.assert_array_equal(
        tpos.float().numpy(),
        np.asarray(jnp.arange(300, dtype=jnp.bfloat16), np.float32))
    want = jbl.cosformer_features(jk)
    got = tbl.cosformer_features(tk)
    assert got.dtype == torch.bfloat16
    _close(got, want, **TOL["bfloat16"])
    # Rows 256 and 257 share one bf16 position: the same weights.
    w = tbl.cosformer_features(torch.ones(1, 300, 1, 1, dtype=torch.bfloat16))
    assert torch.equal(w[0, 256], w[0, 257])
    want = jbl.linear_baseline_attention("cosformer", None, jq, jk, jv)
    got = tbl.linear_baseline_attention("cosformer", None, tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _close(got, want, **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_matches_jax(dtype):
    # Cross-attention shapes: 7 queries on 4 heads against 19 keys on 2.
    rng = np.random.default_rng(4)
    qf = np.abs(_rand(rng, 2, 7, 4, 24))
    kf = np.abs(_rand(rng, 2, 19, 2, 24))
    v = _rand(rng, 2, 19, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both([qf, kf, v], dtype)
    want = jla.noncausal(jq, jk, jv)
    got = tla.noncausal(tq, tk, tv)
    assert got.shape == (2, 7, 4, 16) and got.dtype == tv.dtype
    _close(got, want, **TOL[dtype])


def test_favor_init_construction():
    # Blocks of head_dim rows Q·diag(norms): orthogonal rows, norms of
    # Gaussian rows (chi with head_dim degrees, mean about sqrt(d)).
    proj = tbl.favor_init(torch.Generator().manual_seed(0), 16)["proj"]
    jproj = np.asarray(jbl.favor_init(jax.random.PRNGKey(0), 16)["proj"])
    assert proj.shape == jproj.shape == (64, 16)
    assert proj.dtype == torch.float32
    for b in range(4):
        blk = proj[16 * b:16 * (b + 1)]
        gram = blk @ blk.T
        off = gram - torch.diag(torch.diagonal(gram))
        assert float(off.abs().max()) < 1e-4 * float(gram.diagonal().max())
    norms = torch.linalg.norm(proj, dim=-1)
    assert abs(float(norms.mean()) - float(np.linalg.norm(jproj, axis=-1)
                                           .mean())) < 1.0
    assert abs(float(norms.mean()) - 4.0) < 1.0
    again = tbl.favor_init(torch.Generator().manual_seed(0), 16)["proj"]
    assert torch.equal(proj, again)


# -- the smoke model ----------------------------------------------------


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    kind = request.param
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tcfg = get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    assert ("slay" in tree) == (kind == "favor")
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    return jcfg, tcfg, jp, tp


def test_init_params_and_cache_shapes(models):
    jcfg, tcfg, jp, _ = models
    tp = api.init_params(tcfg, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in tree_items(tp)} == {
        k: tuple(v.shape) for k, v in tree_items(jax.device_get(jp))}
    jc = japi.abstract_cache(jcfg, 3, 64)
    tc = api.abstract_cache(tcfg, 3, 64)
    assert tc.attn.s.device.type == "meta"
    for name in ("s", "z", "pos"):
        want = getattr(jc.attn, name)
        got = getattr(tc.attn, name)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert tc.attn.k is None and jc.attn.k is None


def test_params_from_numpy_keeps_favor_proj_fp32(models):
    # A bf16 tree (the JAX bf16 init's leaves) becomes bf16 weights with
    # favor's projection fp32, as the SLAY anchors; so does a cast to bf16
    # on the way in; and the projection goes back to numpy unchanged.
    _, _, jp, _ = models
    tree = jax.device_get(jp)
    tree16 = {k: v if k == "slay" else jax.tree.map(
        lambda x: np.asarray(x, jnp.bfloat16), v) for k, v in tree.items()}
    for tp in (convert.params_from_numpy(tree16, device="cpu"),
               convert.params_from_numpy(tree, device="cpu",
                                         dtype=torch.bfloat16)):
        assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
        assert ("slay" in tp) == ("slay" in tree)
        if "slay" in tp:
            assert tp["slay"]["proj"].dtype == torch.float32
            back = convert.params_to_numpy(tp)
            np.testing.assert_array_equal(back["slay"]["proj"],
                                          tree["slay"]["proj"])


def test_prefill_chunks_and_decode_match(models):
    # Whole-prompt prefill of a right-padded batch, 8 decode steps with a
    # drained row; then one prompt fed in chunks of 8. cosformer's prefill
    # logits come from the position-weighted attention, its state and
    # every chunk and decode step from the unweighted cache features, on
    # both sides (C-8).
    jcfg, tcfg, jp, tp = models
    jprefill = jax.jit(jtr.prefill, static_argnums=1)
    jdecode = jax.jit(jtr.decode_step, static_argnums=1)
    jchunk = jax.jit(jtr.prefill_chunk, static_argnums=1)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 19)).astype(np.int32)
    true_len = np.array([19, 8], np.int32)
    jl, jc = jprefill(jp, jcfg, jnp.asarray(toks),
                      true_len=jnp.asarray(true_len))
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks),
                             true_len=torch.from_numpy(true_len))
    _close(tl, jl, rtol=0.0, atol=LOGIT_ATOL)
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    for t in range(8):
        act = np.array([True, t % 4 != 1])
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(act))
        with torch.inference_mode():
            tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                     torch.from_numpy(act))
        _close(tl[0], np.asarray(jl)[0], rtol=0.0, atol=LOGIT_ATOL)
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    _close(tc.attn.z, jc.attn.z, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    prompt = rng.integers(0, 256, 27).astype(np.int32)
    jc = jtr.init_cache(jcfg, 1, 32)
    with torch.inference_mode():
        tc = api.init_cache(tcfg, 1, 32, device="cpu")
        for o in range(0, 27, 8):
            chunk = prompt[None, o:o + 8]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(chunk))
            jl, jc = jchunk(jp, jcfg, jc, jnp.asarray(chunk))
            _close(tl, jl, rtol=0.0, atol=LOGIT_ATOL)
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), [27])
    if tcfg.attn_kind == "cosformer":
        m = tc.attn.s.shape[-2]           # the sin half stays zero
        assert not tc.attn.s[..., m // 2:, :].any()
        assert not tc.attn.z[..., m // 2:].any()


def test_forward_loss_and_gradients_match(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss, _, grads = tloop.value_and_grad(tp, tcfg, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = dict(tree_items(jax.device_get(jgrads)))
    tg = dict(tree_items(grads))
    assert set(tg) == set(jg)
    for key, g in tg.items():
        scale = float(np.abs(jg[key]).max()) or 1.0
        _close(g, jg[key], rtol=0.0, atol=1e-4 * scale, err_msg=key)
    if "slay/proj" in tg:                 # a constant of the model
        assert not tg["slay/proj"].any() and not np.any(jg["slay/proj"])
    logits, _ = api.forward(tp, tcfg, torch.from_numpy(toks))
    jlogits, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(logits.detach(), jlogits, rtol=0.0, atol=LOGIT_ATOL)


def test_train_step_matches_jax_and_trainer_loss_falls(models, tmp_path):
    # One AdamW step (plain autograd) against the JAX step: loss to 1e-5,
    # grad norm to 1e-4 relative, favor's projection carried unchanged
    # but for weight decay as on the JAX side; then Trainer.run: finite,
    # falling.
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**kw),
                                  jloop.TrainConfig(remat=False))
    jparams, _, _, jm = jstep(
        jp, jadamw.adamw_init(jp, jadamw.AdamWConfig(**kw)), jnp.zeros(()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = tadamw.AdamWConfig(**kw)
    tstep = tloop.make_train_step(tcfg, ocfg, tloop.TrainConfig(remat=True))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params, _, _, tm = tstep(tp, tadamw.adamw_init(tp, ocfg),
                             torch.zeros(()), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    if "slay" in params:
        _close(params["slay"]["proj"], jparams["slay"]["proj"], rtol=1e-6,
               atol=1e-7)
    trainer = tloop.Trainer(tcfg, ocfg, tloop.TrainConfig(
        ckpt_dir=str(tmp_path)), device="cpu")
    hist = trainer.run(((s, tb) for s in range(3)), 3)
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
