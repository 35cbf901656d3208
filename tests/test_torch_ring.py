"""The exact kinds' KV ring in the port against the JAX package: the
attention ring functions (``prefill_cache``, ``prefill_chunk``,
``decode_step``) and the smoke-size model's prefill, chunked prefill,
decode, forward, loss and gradients, for softmax, yat and yat_spherical.

Inputs are drawn with numpy from a seed; weights come from the JAX init
through numpy. All fp32. Tolerances: attention outputs and ring rows 1e-5
relative and absolute (the same arithmetic in another order of sums);
the model's ring rows (of scale ~10 after a layer) 1e-5 relative and
1e-4 absolute; logits 1e-4 absolute (two layers of fp32 matmuls, logits
of scale ~30; a whole forward's to 5e-5 of their scale); each gradient
leaf to 1e-4 of its largest entry, as ``tests/test_torch_train.py``
holds SLAY's. Drained rows and ``pos`` are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.slay import AttentionSpec as JSpec
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.slay import AttentionSpec as TSpec
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items

torch.set_num_threads(1)    # small ops; the suite runs one process per core

KINDS = ["softmax", "yat", "yat_spherical"]
TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=1e-5, atol=1e-4)
LOGIT_ATOL = 1e-4
B, H, HKV, DH, SIZE = 2, 4, 2, 8, 16


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _caches(kind):
    t = tattn.init_cache(TSpec(kind=kind), (B,), HKV, DH, DH, SIZE,
                         torch.float32, device=torch.device("cpu"))
    j = jattn.init_cache(JSpec(kind=kind), (B,), HKV, DH, DH, SIZE,
                         jnp.float32)
    return t, j


def _check_cache(tc, jc):
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_cache_keeps_the_trailing_rows(kind):
    # L = 21 > size 16: the ring keeps the last 16 tokens; row 1 is
    # right-padded to 9 valid tokens.
    rng = np.random.default_rng(0)
    k, v = _rand(rng, B, 21, HKV, DH), _rand(rng, B, 21, HKV, DH)
    valid = np.arange(21)[None, :] < np.array([21, 9])[:, None]
    tc, jc = _caches(kind)
    tc = tattn.prefill_cache(TSpec(kind=kind), None, torch.from_numpy(k),
                             torch.from_numpy(v), tc, torch.from_numpy(valid))
    jc = jattn.prefill_cache(JSpec(kind=kind), None, jnp.asarray(k),
                             jnp.asarray(v), jc, jnp.asarray(valid))
    _check_cache(tc, jc)


@pytest.mark.parametrize("chunk", [5, 20])
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_chunks_wrap_the_ring(kind, chunk):
    # Slots start at positions 3 and 11 and absorb 4 chunks each: 23 or 83
    # tokens past a 16-row ring, so the ring prefix wraps; a 20-token chunk
    # is longer than the ring and writes only its trailing 16 rows.
    rng = np.random.default_rng(1)
    tc, jc = _caches(kind)
    k0, v0 = _rand(rng, B, 11, HKV, DH), _rand(rng, B, 11, HKV, DH)
    valid = np.arange(11)[None, :] < np.array([3, 11])[:, None]
    tc = tattn.prefill_cache(TSpec(kind=kind), None, torch.from_numpy(k0),
                             torch.from_numpy(v0), tc, torch.from_numpy(valid))
    jc = jattn.prefill_cache(JSpec(kind=kind), None, jnp.asarray(k0),
                             jnp.asarray(v0), jc, jnp.asarray(valid))
    for _ in range(4):
        q = _rand(rng, B, chunk, H, DH)
        k, v = _rand(rng, B, chunk, HKV, DH), _rand(rng, B, chunk, HKV, DH)
        ty, tc = tattn.prefill_chunk(TSpec(kind=kind), None,
                                     *map(torch.from_numpy, (q, k, v)), tc)
        jy, jc = jattn.prefill_chunk(JSpec(kind=kind), None,
                                     *map(jnp.asarray, (q, k, v)), jc)
        _close(ty, jy)
        _check_cache(tc, jc)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_steps_with_drained_rows(kind):
    # 24 steps from positions 3 and 11 through the 16-row ring; slot 1 is
    # drained every third step: its ring, pos and output stay frozen.
    rng = np.random.default_rng(2)
    tc, jc = _caches(kind)
    k0, v0 = _rand(rng, B, 11, HKV, DH), _rand(rng, B, 11, HKV, DH)
    valid = np.arange(11)[None, :] < np.array([3, 11])[:, None]
    tc = tattn.prefill_cache(TSpec(kind=kind), None, torch.from_numpy(k0),
                             torch.from_numpy(v0), tc, torch.from_numpy(valid))
    jc = jattn.prefill_cache(JSpec(kind=kind), None, jnp.asarray(k0),
                             jnp.asarray(v0), jc, jnp.asarray(valid))
    for t in range(24):
        act = np.array([True, t % 3 != 0])
        q, k, v = (_rand(rng, B, H, DH), _rand(rng, B, HKV, DH),
                   _rand(rng, B, HKV, DH))
        before = (tc.k[1].clone(), tc.v[1].clone(), int(tc.pos[1]))
        ty, tc = tattn.decode_step(TSpec(kind=kind), None,
                                   *map(torch.from_numpy, (q, k, v)), tc,
                                   active=torch.from_numpy(act))
        jy, jc = jattn.decode_step(JSpec(kind=kind), None,
                                   *map(jnp.asarray, (q, k, v)), jc,
                                   active=jnp.asarray(act))
        _close(ty, jy)
        _check_cache(tc, jc)
        if not act[1]:
            assert torch.equal(tc.k[1], before[0])
            assert torch.equal(tc.v[1], before[1])
            assert int(tc.pos[1]) == before[2]
            assert not ty[1].any()
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist()
    assert int(tc.pos[0]) == 27


# -- the smoke model ----------------------------------------------------


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    kind = request.param
    jcfg = jax_smoke_config("slayformer-124m", dtype="float32",
                            attn_kind=kind)
    tcfg = get_smoke_config("slayformer-124m", dtype="float32",
                            attn_kind=kind)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    assert "slay" not in tree
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    return jcfg, tcfg, jp, tp


def test_prefill_and_decode_match(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 19)).astype(np.int32)
    true_len = np.array([19, 8], np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks), max_len=24,
                         true_len=jnp.asarray(true_len))
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks), max_len=24,
                             true_len=torch.from_numpy(true_len))
    _close(tl, jl, rtol=0.0, atol=LOGIT_ATOL)
    for t in range(12):                          # row 0 wraps at 24
        act = np.array([True, t % 4 != 1])
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                 jnp.asarray(act))
        with torch.inference_mode():
            tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                     torch.from_numpy(act))
        _close(tl[0], np.asarray(jl)[0], rtol=0.0, atol=LOGIT_ATOL)
    _close(tc.attn.k, jc.attn.k, **RING_TOL)
    _close(tc.attn.v, jc.attn.v, **RING_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.attn.pos.numpy(), np.asarray(jc.attn.pos))


def test_chunked_prefill_matches_whole_prompt_and_jax(models):
    jcfg, tcfg, jp, tp = models
    prompt = np.random.default_rng(4).integers(0, 256, 27).astype(np.int32)
    jc = jtr.init_cache(jcfg, 1, 32)
    with torch.inference_mode():
        tc = api.init_cache(tcfg, 1, 32, device="cpu")
        for o in range(0, 27, 8):
            chunk = prompt[None, o:o + 8]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(chunk))
            jl, jc = jtr.prefill_chunk(jp, jcfg, jc, jnp.asarray(chunk))
            _close(tl, jl, rtol=0.0, atol=LOGIT_ATOL)
        wl, wc = api.prefill(tp, tcfg, torch.from_numpy(prompt[None]),
                             max_len=32)
    _close(tc.attn.k, jc.attn.k, **RING_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), [27])
    # Chunked against whole-prompt: the same rows up to fp32 roundoff.
    _close(tl, wl, rtol=0.0, atol=LOGIT_ATOL)
    _close(tc.attn.k, wc.attn.k, **RING_TOL)
    _close(tc.attn.v, wc.attn.v, **RING_TOL)


def test_forward_loss_and_gradients_match(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    tp = {k: v for k, v in tp.items()}
    leaves = [t for _, t in tree_items(tp)]
    for t in leaves:
        t.requires_grad_(True)
    tloss, _ = api.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    jg = dict(tree_items(jax.device_get(jgrads)))
    for (key, _), g in zip(tree_items(tp), grads):
        scale = float(np.abs(jg[key]).max()) or 1.0
        _close(g, jg[key], rtol=0.0, atol=1e-4 * scale, err_msg=key)
    logits, _ = api.forward(tp, tcfg, torch.from_numpy(toks))
    jlogits, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    # All 17 rows of a softmax model: its peaked attention rows amplify the
    # fp32 roundoff of the logits (1.4e-5 of the scale measured, yat 2e-6).
    scale = float(np.abs(np.asarray(jlogits)).max())
    _close(logits.detach(), jlogits, rtol=0.0, atol=5e-5 * scale)


def test_train_step_matches_jax_and_trainer_loss_falls(models, tmp_path):
    # One AdamW step through plain autograd against the JAX step (loss to
    # 1e-5, grad norm to 1e-4 relative), then Trainer.run: finite, falling.
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**kw),
                                  jloop.TrainConfig(remat=False))
    jm = jstep(jp, jadamw.adamw_init(jp, jadamw.AdamWConfig(**kw)),
               jnp.zeros(()), {k: jnp.asarray(v) for k, v in batch.items()})[3]
    ocfg = tadamw.AdamWConfig(**kw)
    tstep = tloop.make_train_step(tcfg, ocfg, tloop.TrainConfig(remat=True))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm = tstep(tp, tadamw.adamw_init(tp, ocfg), torch.zeros(()), tb)[3]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    trainer = tloop.Trainer(tcfg, ocfg, tloop.TrainConfig(
        ckpt_dir=str(tmp_path)), device="cpu")
    hist = trainer.run(((s, tb) for s in range(3)), 3)
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
