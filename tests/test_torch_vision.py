"""internvl2-76b's vision patch prefix in the port against the JAX
package, on the CPU, at its smoke config in fp32 (2 layers, d_model 64,
4 q heads on 2 kv heads of 16, 8 patches), under SLAY and softmax: the
forward pass and loss with ``patch_embeds`` ahead of the tokens (the
loss scores the text tail), their gradients, prefill behind the prefix
then decode steps, a masked prefill whose true length counts the
prefix, the prefix fed as pre-embedded chunks (``prefill_chunk(embeds=)``)
then token chunks, one AdamW step, and the serving flags.

Weights come from the JAX init and cross through numpy; patch
embeddings, tokens and labels are drawn from a numpy seed. Tolerances:
logits to 1e-5 of their largest magnitude (5e-5 under softmax, whose
peaked rows amplify fp32 rounding, as ``tests/test_torch_ring.py``
holds slayformer's), decode state to 1e-5 of its largest magnitude (a
softmax ring to 5e-5, as ``tests/test_torch_archs.py``), the loss to
1e-5 relative, gradients to 1e-4 of each leaf's largest magnitude, one
AdamW step's parameters as ``tests/test_torch_whisper.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch import configs, convert
from repro_torch.models import api
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "internvl2-76b"
KINDS = ("slay", "softmax")
REL = {"softmax": 5e-5}
GRAD_REL = 1e-4


def _rel(kind):
    return REL.get(kind, 1e-5)


def _close(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0.0,
                               atol=rel * (np.abs(want).max() or 1.0),
                               err_msg=err_msg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _pair(kind):
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tcfg = configs.get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    return (request.param, *_pair(request.param))


def _inputs(cfg, seed, B=2, L=9):
    rng = np.random.default_rng(seed)
    pe = rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return pe, toks


def test_forward_with_prefix_matches(models):
    kind, jcfg, tcfg, jp, tp = models
    pe, toks = _inputs(jcfg, 0)
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "patch_embeds": jnp.asarray(pe)})
    with torch.inference_mode():
        tl, _ = api.forward(tp, tcfg, torch.from_numpy(toks),
                            patch_embeds=torch.from_numpy(pe))
        t0, _ = api.forward(tp, tcfg, torch.from_numpy(toks),
                            patch_embeds=torch.zeros_like(
                                torch.from_numpy(pe)))
    assert tl.shape == (2, 8 + 9, 256)
    _close(tl, jl, _rel(kind))
    # The prefix takes part in attention: it moves the text tail.
    assert float((tl[:, 8:] - t0[:, 8:]).abs().max()) > 1e-3


def test_loss_scores_the_text_tail_and_grads_match(models):
    kind, jcfg, tcfg, jp, tp = models
    pe, toks = _inputs(jcfg, 1, L=17)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patch_embeds": pe}
    (jloss, _), jg = jax.value_and_grad(japi.loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = tloop.value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {k: v for k, v in _flat(jax.device_get(jg))
            if not k.startswith("slay")}
    got = {k.replace(".", "/"): v for k, v in tree_items(grads)
           if not k.startswith("slay")}
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], w, GRAD_REL, k)


def _state_close(tc, jc, kind):
    jls, tls = jax.tree.leaves(jc), tree_leaves(tc)
    assert [tuple(np.shape(a)) for a in jls] == [tuple(b.shape) for b in tls]
    for a, b in zip(jls, tls):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a, _rel(kind))


def test_prefill_behind_prefix_then_decode_match(models):
    kind, jcfg, tcfg, jp, tp = models
    pe, toks = _inputs(jcfg, 2)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks),
                         patch_embeds=jnp.asarray(pe), max_len=40)
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks),
                             patch_embeds=torch.from_numpy(pe), max_len=40)
        _close(tl, jl, _rel(kind))
        _state_close(tc, jc, kind)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        for _ in range(6):
            jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok))
            tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
            _close(tl, jl, _rel(kind))
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
    _state_close(tc, jc, kind)
    np.testing.assert_array_equal(tc.pos.numpy(), [8 + 9 + 6] * 2)


def test_masked_prefill_counts_the_prefix(models):
    # Right-padded prompts of 5 and 9 tokens behind the prefix, true
    # lengths 8 + 5 and 8 + 9: the logits at each true end and the cache,
    # as the JAX package's; the short row equals its own unpadded prefill.
    kind, jcfg, tcfg, jp, tp = models
    pe, toks = _inputs(jcfg, 3, L=16)
    toks[0, 5:] = 0
    toks[1, 9:] = 0
    tl_ = np.array([13, 17], np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks),
                         patch_embeds=jnp.asarray(pe), max_len=32,
                         true_len=jnp.asarray(tl_))
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks),
                             patch_embeds=torch.from_numpy(pe), max_len=32,
                             true_len=torch.from_numpy(tl_))
        one, _ = api.prefill(tp, tcfg, torch.from_numpy(toks[:1, :5]),
                             patch_embeds=torch.from_numpy(pe[:1]),
                             max_len=32)
    _close(tl, jl, _rel(kind))
    _state_close(tc, jc, kind)
    _close(tl[:1], one.numpy(), _rel(kind))


def test_prefix_chunks_then_token_chunks_end_in_the_whole_prefill(models):
    # The 8-row prefix in chunks of 3 as pre-embedded rows, then a
    # 13-token prompt in chunks of 5: every chunk's logits and the final
    # state against the JAX package's, and the state and last logits of
    # one whole prefill.
    kind, jcfg, tcfg, jp, tp = models
    pe, toks = _inputs(jcfg, 4, B=1, L=13)
    jc = jtr.init_cache(jcfg, 1, 32)
    with torch.inference_mode():
        tc = api.init_cache(tcfg, 1, 32, device="cpu")
        for o in range(0, 8, 3):
            emb = pe[:, o:o + 3]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, None,
                                       embeds=torch.from_numpy(emb))
            jl, jc = japi.prefill_chunk(jcfg, jp, jc, None,
                                        embeds=jnp.asarray(emb))
            _close(tl, jl, _rel(kind))
        for o in range(0, 13, 5):
            piece = toks[:, o:o + 5]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(piece))
            jl, jc = japi.prefill_chunk(jcfg, jp, jc, jnp.asarray(piece))
            _close(tl, jl, _rel(kind))
        _state_close(tc, jc, kind)
        wl, wc = api.prefill(tp, tcfg, torch.from_numpy(toks),
                             patch_embeds=torch.from_numpy(pe), max_len=32)
    np.testing.assert_array_equal(tc.pos.numpy(), [21])
    _close(tl, wl.numpy(), _rel(kind))
    for a, b in zip(tree_leaves(tc), tree_leaves(wc)):
        _close(a, b.numpy(), _rel(kind))


def test_serving_flags_match(models):
    kind, jcfg, tcfg, jp, tp = models
    for fn in ("supports_chunked_prefill", "supports_masked_prefill",
               "supports_paging", "supports_speculative"):
        assert getattr(api, fn)(tcfg) == getattr(japi, fn)(jcfg), fn
    assert not api.supports_paging(tcfg) and not api.supports_speculative(
        tcfg)
    assert api.supports_chunked_prefill(tcfg)
    assert (api.context_capacity(tcfg, 32)
            == japi.context_capacity(jcfg, 32))


def test_one_adamw_step_with_prefix_matches_jax():
    jcfg, tcfg, jp, tp = _pair("slay")
    pe, toks = _inputs(jcfg, 6, L=17)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patch_embeds": pe}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**kw),
                                  jloop.TrainConfig(remat=False))
    jnew, _, _, jm = jstep(jp, jadamw.adamw_init(jp, jadamw.AdamWConfig(**kw)),
                           jnp.zeros(()),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = tadamw.AdamWConfig(**kw)
    tstep = tloop.make_train_step(tcfg, ocfg, tloop.TrainConfig(
        microbatches=2, remat=True))
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
            atol=max(1e-5 * np.abs(w).max(), 1e-6), err_msg=k)
        assert np.abs(got - w).max() <= 2 * lr, k
