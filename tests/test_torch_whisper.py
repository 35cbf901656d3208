"""whisper-small's encoder-decoder in the port against the JAX package, on
the CPU, at its smoke config in fp32 (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, 32 frames), under SLAY, softmax, the linear
baseline elu1 and yat_spherical: the encoding, the teacher-forced
logits, the loss and its gradients, prefill then 8 decode steps with
every cache leaf, the slot functions on a 3-slot pool, the cache's leaf
order and one AdamW step.

Weights come from the JAX init and cross through numpy
(``repro_torch.convert``); frames and tokens are drawn from a numpy
seed. Tolerances: logits and the encoding to 1e-5 of their largest
magnitude, except under softmax, 1e-4: its peaked attention rows
amplify fp32 rounding through the four attention blocks a token meets
(one softmax attention alone agrees to 1e-6 on both sides, and both lie
within 5e-6 of a float64 one), so the encoding agrees to 1.3e-5 of its
scale and the logits to 4e-5. Every decode-state leaf to 1e-5 of its
largest magnitude (1e-4 under softmax), the loss to 1e-5 relative,
gradients to 1e-4 of each leaf's largest magnitude (2e-3 under softmax:
there the JAX package's fp32 gradients and the port's each lie 1.2e-3 of
a leaf's scale from the JAX package's run in float64, and 7e-4 from each
other). One AdamW step's parameters as ``tests/test_torch_train.py``
holds them: where the step is firm (|g| far above ε) to 1e-5 of each
leaf's largest magnitude and no tighter than 1e-6 (that file's bound:
the norm scales start at zero and span only about lr after the step),
elsewhere within the step's range, 2·lr.

ROADMAP C-12, a caveat of the reference reproduced here: under an exact
yat kind, ``decode_step`` reads the cross-attention with a softmax while
``forward`` and ``prefill`` use the yat kernel, so teacher-forced and
decoded logits differ; under softmax they agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro.models import whisper as jw
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch import configs, convert
from repro_torch.models import api
from repro_torch.models import whisper as tw
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "whisper-small"
KINDS = ("slay", "softmax", "elu1", "yat_spherical")
REL = {"softmax": 1e-4}
GRAD_REL = {"softmax": 2e-3}
STEP_REL = 1e-5


def _rel(kind):
    return REL.get(kind, 1e-5)


def _close(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0.0,
                               atol=rel * (np.abs(want).max() or 1.0),
                               err_msg=err_msg)


def _pair(kind):
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tcfg = configs.get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tree = jax.device_get(jw.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    return (request.param, *_pair(request.param))


def _inputs(cfg, seed, B=2, L=9):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return frames, toks


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def test_params_have_the_reference_tree(models):
    kind, jcfg, tcfg, jp, tp = models
    want = {k: np.asarray(v).shape
            for k, v in _flat(jax.device_get(jp))}
    mine = {k: tuple(v.shape)
            for k, v in _flat(api.init_params(tcfg, 0, device="cpu"))}
    assert mine == want
    back = dict(_flat(convert.params_to_numpy(tp)))
    for k, w in _flat(jax.device_get(jp)):
        np.testing.assert_array_equal(back[k], np.asarray(w), k)


def test_encode_and_forward_match(models):
    kind, jcfg, tcfg, jp, tp = models
    frames, toks = _inputs(jcfg, 0)
    je = jw.encode(jp, jcfg, jnp.asarray(frames))
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "frame_embeds": jnp.asarray(frames)})
    with torch.inference_mode():
        te = tw.encode(tp, tcfg, torch.from_numpy(frames))
        tl, aux = api.forward(tp, tcfg, torch.from_numpy(toks),
                              frame_embeds=torch.from_numpy(frames))
    _close(te, je, _rel(kind), "encoding")
    assert tl.shape == (2, 9, 256) and float(aux) == 0.0
    _close(tl, jl, _rel(kind), "logits")


def test_loss_and_grads_match(models):
    kind, jcfg, tcfg, jp, tp = models
    frames, toks = _inputs(jcfg, 1, L=17)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "frame_embeds": frames}
    (jloss, _), jg = jax.value_and_grad(japi.loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    loss, metrics, grads = tloop.value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["moe_aux"]) == 0.0
    want = {k: v for k, v in _flat(jax.device_get(jg))
            if not k.startswith("slay")}
    got = {k.replace(".", "/"): v for k, v in tree_items(grads)
           if not k.startswith("slay")}
    assert got.keys() == want.keys()
    assert np.abs(want["enc_pos"]).max() > 0     # the encoder learns
    for k, w in want.items():
        _close(got[k], w, GRAD_REL.get(kind, 1e-4), k)


def _state_close(tc, jc, kind):
    jls, tls = jax.tree.leaves(jc), tree_leaves(tc)
    assert [tuple(np.shape(a)) for a in jls] == [tuple(b.shape) for b in tls]
    for a, b in zip(jls, tls):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a, _rel(kind))


def test_prefill_then_8_decode_steps_match(models):
    kind, jcfg, tcfg, jp, tp = models
    frames, toks = _inputs(jcfg, 2)
    jl, jc = jw.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(frames),
                        max_len=32)
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks),
                             frame_embeds=torch.from_numpy(frames),
                             max_len=32)
        _close(tl, jl, _rel(kind), "prefill logits")
        _state_close(tc, jc, kind)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        for _ in range(8):
            jl, jc = jw.decode_step(jp, jcfg, jc, jnp.asarray(tok))
            tl, tc2 = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
            assert tc2 is tc
            _close(tl, jl, _rel(kind), "decode logits")
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
    _state_close(tc, jc, kind)
    np.testing.assert_array_equal(tc.pos.numpy(), [17, 17])


def test_cache_leaves_in_the_reference_order(models):
    # Checkpoints and prefix snapshots are lists of leaves: the order is
    # jax.tree.leaves' of the reference's WhisperCache.
    kind, jcfg, tcfg, jp, tp = models
    jc = jw.init_cache(jcfg, 3, 32)
    tc = api.init_cache(tcfg, 3, 32, page_size=8, device="cpu")
    paths = [p for p, _ in tree_items(tc)]
    jpaths = [jax.tree_util.keystr(p, simple=True, separator="/")
              for p, _ in jax.tree_util.tree_leaves_with_path(jc)]
    assert paths == jpaths
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    linear = kind in ("slay", "elu1")
    assert paths[:3] == (["self_attn/pos", "self_attn/s", "self_attn/z"]
                         if linear else
                         ["self_attn/k", "self_attn/v", "self_attn/pos"])


def _pools(jcfg, tcfg, jp, tp):
    """3-slot pools, slots 0 and 1 prefilled with prompts of 9 and 14."""
    rng = np.random.default_rng(4)
    jpool = japi.init_cache(jcfg, 3, 32)
    with torch.inference_mode():
        tpool = api.init_cache(tcfg, 3, 32, device="cpu")
        for slot, n in enumerate((9, 14)):
            frames = rng.normal(size=(1, jcfg.enc_seq, jcfg.d_model)).astype(
                np.float32)
            toks = rng.integers(3, 256, (1, n)).astype(np.int32)
            _, one = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                             "frame_embeds":
                                             jnp.asarray(frames)},
                                  max_len=32)
            jpool = japi.write_slot(jcfg, jpool, one, jnp.int32(slot))
            _, tone = api.prefill(tp, tcfg, torch.from_numpy(toks),
                                  frame_embeds=torch.from_numpy(frames),
                                  max_len=32)
            assert api.write_slot(tcfg, tpool, tone, slot) is tpool
    return jpool, tpool


@torch.inference_mode()
def test_slot_ops_and_masked_decode_match(models):
    kind, jcfg, tcfg, jp, tp = models
    jpool, tpool = _pools(jcfg, tcfg, jp, tp)
    _state_close(tpool, jpool, kind)
    # A masked step with slot 1 drained: live rows as the JAX step's, the
    # drained slot's every leaf bit-identical, the pool written in place.
    before = [t.clone() for t in tree_leaves(tpool)]
    ptrs = [t.data_ptr() for t in tree_leaves(tpool)]
    toks = np.array([[5], [6], [7]], np.int32)
    act = np.array([True, False, True])
    jl, jpool = japi.decode_step(jp, jcfg, jpool, jnp.asarray(toks),
                                 jnp.asarray(act))
    tl, _ = api.decode_step(tp, tcfg, tpool, torch.from_numpy(toks),
                            torch.from_numpy(act))
    assert [t.data_ptr() for t in tree_leaves(tpool)] == ptrs
    _close(tl.numpy()[act], np.asarray(jl)[act], _rel(kind))
    _state_close(tpool, jpool, kind)
    for (path, t), b in zip(tree_items(tpool), before):
        assert torch.equal(t[:, 1] if t.dim() > 1 else t[1],
                           b[:, 1] if b.dim() > 1 else b[1]), path
    np.testing.assert_array_equal(
        api.slot_state_finite(tcfg, tpool).numpy(),
        np.asarray(japi.slot_state_finite(jcfg, jpool)))
    jpool = japi.corrupt_slot(jcfg, jpool, 1)
    api.corrupt_slot(tcfg, tpool, 1)
    assert torch.isnan(tpool.cross_s[:, 1]).all()
    for got in (api.slot_state_finite(tcfg, tpool).numpy(),
                np.asarray(japi.slot_state_finite(jcfg, jpool))):
        np.testing.assert_array_equal(got, [True, False, True])
    jpool = japi.reset_slot(jcfg, jpool, 1)
    assert api.reset_slot(tcfg, tpool, 1) is tpool
    _state_close(tpool, jpool, kind)
    assert bool(api.slot_state_finite(tcfg, tpool).all())
    assert not tpool.cross_z[:, 1].any() and int(tpool.pos[1]) == 0


def test_serving_surface_flags_match(models):
    kind, jcfg, tcfg, jp, tp = models
    for fn in ("supports_chunked_prefill", "supports_masked_prefill",
               "supports_paging", "supports_speculative"):
        assert getattr(api, fn)(tcfg) == getattr(japi, fn)(jcfg) is False, fn
    assert (api.context_capacity(tcfg, 32)
            == japi.context_capacity(jcfg, 32))
    with pytest.raises(NotImplementedError, match="family='encdec'"):
        api.prefill_chunk(tcfg, tp, None, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="true_len"):
        api.prefill(tp, tcfg, torch.zeros(1, 4, dtype=torch.int32),
                    frame_embeds=torch.zeros(1, 32, 64),
                    true_len=torch.tensor([3]))


@pytest.mark.parametrize("kind", ["slay", "softmax"])
def test_one_adamw_step_matches_jax(kind):
    jcfg, tcfg, jp, tp = _pair(kind)
    frames, toks = _inputs(jcfg, 6, L=17)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frame_embeds": frames}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**kw),
                                  jloop.TrainConfig(remat=False))
    jnew, _, _, jm = jstep(jp, jadamw.adamw_init(jp, jadamw.AdamWConfig(**kw)),
                           jnp.zeros(()),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = tadamw.AdamWConfig(**kw)
    tstep = tloop.make_train_step(tcfg, ocfg, tloop.TrainConfig(remat=True))
    tnew, _, _, tm = tstep(tp, tadamw.adamw_init(tp, ocfg), torch.zeros(()),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    lr, p0 = float(jm["lr"]), dict(_flat(jax.device_get(jp)))
    want = dict(_flat(jax.device_get(jnew)))
    for k, t in tree_items(tnew):
        k = k.replace(".", "/")
        got, w = t.numpy(), np.asarray(want[k])
        firm = np.abs((p0[k] - w) / lr - 0.01 * p0[k]) > 0.99
        assert k.startswith("slay/") or firm.any(), k
        np.testing.assert_allclose(
            got[firm], w[firm], rtol=0.0,
            atol=max(STEP_REL * np.abs(w).max(), 1e-6), err_msg=k)
        assert np.abs(got - w).max() <= 2 * lr, k


# -- ROADMAP C-12: the reference decodes its cross-attention with a softmax --


def _teacher_forced_gap(cfg, forward, prefill, decode, frames, toks, n=5):
    """Largest |decode - forward| logit over the tokens after the first
    ``n``, teacher-forced, relative to the largest |logit|."""
    full = np.asarray(forward(toks, frames), np.float32)
    logits, cache = prefill(toks[:, :n], frames)
    gaps = []
    for t in range(n, toks.shape[1]):
        logits, cache = decode(cache, toks[:, t:t + 1])
        gaps.append(np.abs(np.asarray(logits, np.float32)[:, 0]
                           - full[:, t]).max())
    return max(gaps) / np.abs(full).max()


@pytest.mark.parametrize("kind", ["yat", "yat_spherical", "softmax"])
def test_c12_exact_yat_decode_reads_cross_attention_by_softmax(kind):
    jcfg, tcfg, jp, tp = _pair(kind)
    frames, toks = _inputs(jcfg, 8, B=1, L=10)
    jgap = _teacher_forced_gap(
        jcfg,
        lambda t, f: jw.forward(jp, jcfg, jnp.asarray(t), jnp.asarray(f))[0],
        lambda t, f: jw.prefill(jp, jcfg, jnp.asarray(t), jnp.asarray(f),
                                max_len=16),
        lambda c, t: jw.decode_step(jp, jcfg, c, jnp.asarray(t)),
        frames, toks)
    with torch.inference_mode():
        tgap = _teacher_forced_gap(
            tcfg,
            lambda t, f: tw.forward(tp, tcfg, torch.from_numpy(t),
                                    torch.from_numpy(f))[0],
            lambda t, f: tw.prefill(tp, tcfg, torch.from_numpy(t),
                                    torch.from_numpy(f), max_len=16),
            lambda c, t: tw.decode_step(tp, tcfg, c, torch.from_numpy(t)),
            frames, toks)
    if kind == "softmax":
        # Decode agrees with the teacher-forced forward on both sides.
        assert jgap < 1e-4 and tgap < 1e-4, (jgap, tgap)
    else:
        # The same gap on both sides: decode is not the forward there.
        assert jgap > 1e-2 and tgap > 1e-2, (jgap, tgap)
        np.testing.assert_allclose(tgap, jgap, rtol=1e-3)


def test_c13_favor_whisper_has_no_projection_on_either_side():
    # ROADMAP C-13: the reference's whisper draws random projections for
    # SLAY only, so under favor its tree has no ``slay`` entry and the
    # forward pass fails on the missing projection; the port keeps the
    # reference's tree and fails the same way.
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind="favor")
    tcfg = configs.get_smoke_config(NAME, dtype="float32", attn_kind="favor")
    jp = jw.init_params(jcfg, jax.random.PRNGKey(0))
    tp = api.init_params(tcfg, 0, device="cpu")
    assert "slay" not in jp and "slay" not in tp
    frames, toks = _inputs(jcfg, 9)
    with pytest.raises(TypeError, match="NoneType"):
        jw.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(frames))
    with pytest.raises(TypeError, match="NoneType"):
        api.forward(tp, tcfg, torch.from_numpy(toks),
                    frame_embeds=torch.from_numpy(frames))


@pytest.mark.parametrize("lq,lk", [(7, 32), (1, 45)])
def test_slay_cross_attention_matches_jax(lq, lk):
    # A5's cross-attention: queries against keys and values of another
    # length, two q heads on each kv head, in fp32 to 1e-5.
    from repro.core import features as jfeat
    from repro.core import slay as jslay
    from repro_torch.core import features as tfeat
    from repro_torch.core import slay as tslay
    jcfg = jfeat.SlayFeatureConfig(head_dim=16)
    tcfg = tfeat.SlayFeatureConfig(head_dim=16)
    jp = jfeat.init_feature_params(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(jp[k])) for k in ("anchors", "omegas")}
    rng = np.random.default_rng(lq)
    q = rng.normal(size=(2, lq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, lk, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jslay.slay_cross_attention(jp, *(jnp.asarray(x) for x in (q, k, v)),
                                      jcfg)
    got = tslay.slay_cross_attention(tp, *(torch.from_numpy(x)
                                           for x in (q, k, v)), tcfg)
    assert got.shape == (2, lq, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
