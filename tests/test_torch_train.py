"""The port's training slice against the JAX package, on the CPU.

Weights come from the JAX init and cross through numpy
(``repro_torch.convert``); batches are drawn with numpy. Both sides run the
smoke-size slayformer in fp32; the port's attention runs its plain forward
and backward (the Pallas kernels' arithmetic), the JAX model its jnp
reference path. Tolerances, each stated where it is used: the loss to
1e-5 relative and gradients to 1e-4 of each leaf's largest magnitude
(fp32 in another summation order through two layers); AdamW on identical
gradients to 1e-6 on fp32 parameters and to one bf16 step on bf16 ones;
compression, data and checkpoints exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    restore_latest, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as tpipe
from repro_torch.models import api
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items, tree_leaves

NAME = "slayformer-124m"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, dtype="float32")
    tcfg = get_smoke_config(NAME, dtype="float32")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp


def _tparams(jp):
    return convert.params_from_numpy(jax.device_get(jp), device="cpu")


def _batch(seed, B=2, L=24, V=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, L + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flat_numpy(tree):
    """{path: fp32 numpy} of a JAX pytree or a port tree."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, (dict, torch.Tensor)) for v in tree.values()):
        return {k: v.detach().float().numpy() for k, v in tree_items(tree)}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _close_leaves(got, want, rel=1e-4):
    got, want = _flat_numpy(got), _flat_numpy(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[key], w, rtol=0.0, atol=rel * scale,
                                   err_msg=key)


def test_loss_and_grads_match_jax(models):
    jcfg, tcfg, jp = models
    b = _batch(0)
    (jloss, jm), jg = jax.value_and_grad(japi.loss_fn, has_aux=True)(
        jp, jcfg, _jax_batch(b))
    tp = _tparams(jp)
    loss, metrics, grads = tloop.value_and_grad(tp, tcfg, _torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               rtol=1e-5)
    assert float(metrics["moe_aux"]) == 0.0
    # The SLAY projections are constants on both sides: zero gradients.
    assert not torch.count_nonzero(grads["slay"]["anchors"])
    _close_leaves(grads, jg)
    # Recomputing each layer in the backward gives the same gradients.
    loss_r, _, grads_r = tloop.value_and_grad(tp, tcfg, _torch_batch(b),
                                              remat=True)
    assert float(loss_r) == float(loss)
    for (key, g), (_, gr) in zip(tree_items(grads), tree_items(grads_r)):
        torch.testing.assert_close(gr, g, rtol=0.0, atol=1e-6, msg=key)


def test_loss_fn_api_and_remat_options(models):
    _, tcfg, jp = models
    tp = _tparams(jp)
    b = _torch_batch(_batch(1))
    loss, mx = api.loss_fn(tp, tcfg, b)
    assert loss.shape == () and set(mx) == {"nll", "moe_aux"}
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        api.loss_fn(tp, tcfg, b, remat="save_collectives")
    ocfg = tadamw.AdamWConfig()
    # The two-dispatch path's step sees the same loss as the fused forward.
    two = tloop.make_train_step(
        tcfg, ocfg, tloop.TrainConfig(fuse_attention_features=False))
    *_, m2 = two(tp, tadamw.adamw_init(tp, ocfg), torch.zeros(()), b)
    np.testing.assert_allclose(float(m2["loss"]), float(loss), rtol=1e-5)
    step = tloop.make_train_step(tcfg, ocfg,
                                 tloop.TrainConfig(remat="save_collectives"))
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        step(tp, tadamw.adamw_init(tp, ocfg), torch.zeros(()), b)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(models, microbatches):
    # One make_train_step step from identical params and batch: params,
    # moments, grad_norm and lr (make_train_step run directly, as
    # tests/test_train_infra.py runs it).
    jcfg, tcfg, jp = models
    b = _batch(2, B=4)
    ocfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jloop.make_train_step(
        jcfg, ocfg, jloop.TrainConfig(microbatches=microbatches, remat=False))
    jparams, jopt, _, jmetrics = jstep(jp, jadamw.adamw_init(jp, ocfg),
                                       jnp.zeros(()), _jax_batch(b))
    tocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tstep = tloop.make_train_step(
        tcfg, tocfg, tloop.TrainConfig(microbatches=microbatches, remat=False))
    tp = _tparams(jp)
    params, opt, _, metrics = tstep(tp, tadamw.adamw_init(tp, tocfg),
                                    torch.zeros(()), _torch_batch(b))
    assert int(opt.step) == int(jopt.step) == 1
    np.testing.assert_allclose(float(metrics["lr"]), float(jmetrics["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)
    # fp32 params after one step: p − lr·(q + wd·p), q = g/(|g| + ε/scale)
    # at step 1. Where |q| is near 1 (|g| far above ε/scale) the step is
    # firm and held to 1e-6 of an lr of 5e-4; where |g| is near ε, q moves
    # with the gradients' relative error and only stays within the step's
    # range, 2·lr. The moments: 1e-4 (m) and 2e-4 (v, squares) of scale.
    lr, p0 = float(jmetrics["lr"]), _flat_numpy(jp)
    g, w = _flat_numpy(params), _flat_numpy(jparams)
    for key in w:
        firm = np.abs((p0[key] - w[key]) / lr - ocfg.weight_decay * p0[key]) > 0.99
        assert key.startswith("slay/") or firm.mean() > 0.5, key
        np.testing.assert_allclose(g[key][firm], w[key][firm], rtol=0.0,
                                   atol=1e-6, err_msg=key)
        assert np.abs(g[key] - w[key]).max() <= 2 * lr, key
    _close_leaves(opt.m, jopt.m)
    _close_leaves(opt.v, jopt.v, rel=2e-4)


def test_train_steps_follow_jax_at_lr_3e3(models):
    # Eight steps at lr 3e-3 (warmup 1), each on a new batch: the port's
    # loss per step against the JAX step's, run side by side from identical
    # params. Rounding differences compound through the updates and stay
    # below 1e-6 relative here; the losses are held to 1e-5, as one step's.
    jcfg, tcfg, jp = models
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=8)
    jocfg, tocfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jstep = jloop.make_train_step(jcfg, jocfg, jloop.TrainConfig(remat=False))
    tstep = tloop.make_train_step(tcfg, tocfg, tloop.TrainConfig(remat=False))
    tp = _tparams(jp)
    jstate = (jp, jadamw.adamw_init(jp, jocfg), jnp.zeros(()))
    tstate = (tp, tadamw.adamw_init(tp, tocfg), torch.zeros(()))
    jl, tl = [], []
    for s in range(8):
        b = _batch(10 + s, B=4)
        *jstate, jm = jstep(*jstate, _jax_batch(b))
        *tstate, tm = tstep(*tstate, _torch_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_microbatched_step_matches_single(models):
    _, tcfg, jp = models
    b = _torch_batch(_batch(3, B=4))
    ocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    tp = _tparams(jp)
    outs = []
    for n in (1, 2):
        step = tloop.make_train_step(
            tcfg, ocfg, tloop.TrainConfig(microbatches=n, remat=False))
        outs.append(step(tp, tadamw.adamw_init(tp, ocfg), torch.zeros(()), b))
    # Same global batch: the mean over two halves equals the whole batch's
    # mean up to fp32 rounding.
    np.testing.assert_allclose(float(outs[1][3]["loss"]),
                               float(outs[0][3]["loss"]), rtol=1e-6)
    for (key, p1), (_, p2) in zip(tree_items(outs[0][0]),
                                  tree_items(outs[1][0])):
        torch.testing.assert_close(p2, p1, rtol=0.0, atol=1e-6, msg=key)


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_schedule_and_adamw_update_match_jax(dtype, moments):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}

    def draw(scale):
        def one(s):
            return (rng.normal(size=s) * scale).astype(np.float32)
        return {"a": one(shapes["a"]),
                "b": {k: one(s) for k, s in shapes["b"].items()}}

    p_np, g_np = draw(1.0), draw(0.7)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p_np)
    jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g_np)
    tp = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), p_np)
    tg = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), g_np)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=9, clip_norm=0.5,
              moment_dtype=moments)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    for s in range(12):
        np.testing.assert_allclose(
            float(tadamw.schedule(torch.tensor(s, dtype=torch.int32), tcfg)),
            float(jadamw.schedule(jnp.int32(s), jcfg)), rtol=1e-6, atol=0.0)
    jstate, tstate = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    # fp32: a few fp32 roundings; bf16: one bf16 step of the result.
    atol = 1e-6 if dtype == "float32" and moments == "float32" else 0.0
    rtol = 1e-6 if atol else 2 ** -7
    for _ in range(4):                     # through warmup and decay
        jp, jstate, jm = jadamw.adamw_update(jg, jstate, jp, jcfg)
        tp, tstate, tm = tadamw.adamw_update(tg, tstate, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for got, want in ((tp, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
            assert tree_leaves(got)[0].dtype == (
                tdt if got is tp else getattr(torch, moments))
            g, w = _flat_numpy(got), _flat_numpy(want)
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                           atol=atol + 1e-9, err_msg=key)


def test_compress_decompress_bit_identical_to_jax():
    rng = np.random.default_rng(5)
    grads = {"w": rng.normal(size=(64,)).astype(np.float32) * 0.01,
             "b": {"c": rng.normal(size=(3, 5)).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = jax.tree.map(torch.from_numpy, grads)
    je, te = jcompress.init(jg), tcompress.init(tg)
    for _ in range(5):
        jq, je = jcompress.compress_decompress(jg, je)
        tq, te = tcompress.compress_decompress(tg, te)
        for got, want in ((tq, jq), (te, je)):
            g, w = _flat_numpy(got), _flat_numpy(want)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_tokens_from_uniform_equals_jax_make_batch():
    cfg_kw = dict(vocab_size=97, seq_len=33, global_batch=3, seed=7)
    jcfg, tcfg = jpipe.DataConfig(**cfg_kw), tpipe.DataConfig(**cfg_kw)
    for step in (0, 5):
        want = jpipe.make_batch(jcfg, step)
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), step)
        u = np.asarray(jax.random.uniform(key, (3, 34)))
        got = tpipe.tokens_from_uniform(u, tpipe._zipf_cdf(tcfg), tcfg)
        for name in ("tokens", "labels"):
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_make_batch_is_step_indexed():
    cfg = tpipe.DataConfig(vocab_size=31, seq_len=8, global_batch=2, seed=3)
    b1, b2 = tpipe.make_batch(cfg, 7), tpipe.make_batch(cfg, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], tpipe.make_batch(cfg, 8)["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    it = tpipe.batch_iterator(cfg, start_step=7)
    step, b3 = next(it)
    assert step == 7 and torch.equal(b3["labels"], b1["labels"])


def test_checkpoint_round_trip_keep_and_errors(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4, generator=torch.Generator()
                                   .manual_seed(0)).bfloat16()},
            "opt": tadamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                                     {"m": torch.ones(2)}, {"m": torch.ones(2)})}
    path = save_checkpoint(str(tmp_path), 42, tree)
    assert os.path.basename(path) == "step_00000042.ckpt"
    assert os.listdir(tmp_path) == ["step_00000042.ckpt"]   # no tmp left
    restored, step = restore_checkpoint(path, tree)
    assert step == 42 and isinstance(restored["opt"], tadamw.AdamWState)
    for (ka, x), (kb, y) in zip(tree_items(restored), tree_items(tree)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y)
    for s in (43, 44, 45):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000044.ckpt",
                                            "step_00000045.ckpt"]
    assert latest_step(str(tmp_path)) == 45
    assert restore_latest(str(tmp_path / "none"), tree) == (None, None)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_latest(str(tmp_path), {**tree, "a": torch.zeros(3, 2)})


def test_trainer_runs_saves_and_resumes_exactly(tmp_path):
    cfg = get_smoke_config(NAME, dtype="float32")
    ocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    dcfg = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4)

    def trainer(d):
        tcfg = tloop.TrainConfig(remat=False, ckpt_dir=str(d), ckpt_every=100)
        return tloop.Trainer(cfg, ocfg, tcfg, seed=0, device="cpu")

    whole = trainer(tmp_path / "whole").run(tpipe.batch_iterator(dcfg), 7,
                                            log_every=100)
    tr = trainer(tmp_path / "cut")
    hist = tr.run(tpipe.batch_iterator(dcfg), 5, log_every=100)
    assert len(hist) == 5 and tr.step == 5
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert latest_step(str(tmp_path / "cut")) == 5
    tr2 = trainer(tmp_path / "cut")
    assert tr2.step == 5 and int(tr2.opt_state.step) == 5
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
        assert torch.equal(a, b)
    rest = tr2.run(tpipe.batch_iterator(dcfg, start_step=tr2.step), 7,
                   log_every=100)
    assert [h["loss"] for h in hist + rest] == [h["loss"] for h in whole]


def test_watchdog_tightens_ckpt_cadence(tmp_path, monkeypatch, caplog):
    cfg = get_smoke_config(NAME, dtype="float32")
    tcfg = tloop.TrainConfig(remat=False, ckpt_dir=str(tmp_path),
                             ckpt_every=64, watchdog_factor=1.5)
    tr = tloop.Trainer(cfg, tadamw.AdamWConfig(), tcfg, device="cpu")
    calls = [0]

    def fake_monotonic():
        # Two reads per step; the end of step 7 (read 16) jumps by 10 s.
        calls[0] += 1
        return 0.1 * calls[0] + (10.0 if calls[0] >= 16 else 0.0)

    monkeypatch.setattr(tloop.time, "monotonic", fake_monotonic)
    dcfg = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                            global_batch=2)
    saved = []
    monkeypatch.setattr(tr, "save", lambda: saved.append(tr.step))
    with caplog.at_level("WARNING", logger="repro_torch.train"):
        tr.run(tpipe.batch_iterator(dcfg), 40, log_every=100)
    # Step 7 took 10 s against a median of 0.1 s: the cadence halves from
    # 64 to 32, so a checkpoint lands at step 32 besides the final one.
    assert "tightening checkpoint cadence" in caplog.text
    assert saved == [32, 40]
