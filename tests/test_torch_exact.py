"""The port's exact attention (``repro_torch.core.kernels``) against the
JAX package's (``repro.core.kernels``), and the model-level dispatch of
the exact kinds (GQA) against ``repro.models.attention.full_attention``.

Inputs are drawn with numpy from a seed and handed to both sides.
Tolerances: fp32 1e-5 relative and absolute (the same arithmetic in
another summation order); bf16 3e-2 absolute and relative on outputs of
scale 1 (four bf16 roundings of the logits or scores, the weights and
the output; bf16 has 8 bits of mantissa, so 2^-8 = 3.9e-3 a rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro.core.slay import AttentionSpec as JSpec
from repro.models import attention as jattn
from repro_torch.core import kernels as tk
from repro_torch.core.slay import AttentionSpec as TSpec
from repro_torch.models import attention as tattn

torch.set_num_threads(1)    # small ops; the suite runs one process per core

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _qkv(lq=12, lk=None, h=3, dh=8, hkv=None, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    lk = lk or lq
    hkv = hkv or h
    q = rng.normal(size=(2, lq, h, dh)).astype(np.float32) * scale
    k = rng.normal(size=(2, lk, hkv, dh)).astype(np.float32) * scale
    v = rng.normal(size=(2, lk, hkv, dh)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# name -> (function, its keyword arguments, keyword arguments of _qkv)
CASES = {
    "softmax_causal": ("softmax_attention", dict(causal=True), {}),
    "softmax_full": ("softmax_attention", dict(causal=False), {}),
    "softmax_softcap": ("softmax_attention",
                        dict(causal=True, logit_softcap=2.0),
                        dict(scale=3.0)),
    "softmax_window_masked": ("softmax_attention",
                              dict(causal=True, window=5), {}),
    "softmax_window_banded": ("softmax_attention",
                              dict(causal=True, window=4), {}),
    "softmax_kv_cache_rows": ("softmax_attention", dict(causal=True),
                              dict(lq=5, lk=12)),
    "yat_causal": ("yat_attention", dict(causal=True), {}),
    "yat_full": ("yat_attention", dict(causal=False), {}),
    "yat_spherical_causal": ("yat_attention",
                             dict(causal=True, spherical=True), {}),
    "yat_spherical_full": ("yat_attention",
                           dict(causal=False, spherical=True), {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_attention_matches_jax(case, dtype):
    fn, kw, shape = CASES[case]
    (jq, jk_, jv), (tq, tk_, tv) = _both(_qkv(**shape), dtype)
    want = getattr(jk, fn)(jq, jk_, jv, **kw)
    got = getattr(tk, fn)(tq, tk_, tv, **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, dtype)


@pytest.mark.parametrize("fn", ["yat_scores", "spherical_yat_scores"])
def test_yat_scores_match_jax(fn):
    q, k, _ = _qkv(seed=3)
    k[:, 0] = q[:, 0]                  # q = k: the eps-guarded distance
    got = getattr(tk, fn)(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    want = np.asarray(getattr(jk, fn)(jnp.asarray(q), jnp.asarray(k)))
    # Scores (B, H, Lq, Lk); the q = k entries are [..., 0, 0]. There the
    # distance cancels sums of size |q|² to ~1e-6 against eps = 1e-3, so
    # the order of the sums moves the score by up to ~1e-3 relative.
    np.testing.assert_allclose(got[..., 0, 0], want[..., 0, 0], rtol=5e-3)
    got[..., 0, 0] = want[..., 0, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_normalization_matches_jax(causal):
    rng = np.random.default_rng(4)
    scores = rng.uniform(size=(2, 3, 9, 9)).astype(np.float32)
    v = rng.normal(size=(2, 9, 3, 8)).astype(np.float32)
    got = tk.kernel_normalized_attention(torch.from_numpy(scores),
                                         torch.from_numpy(v), causal)
    want = jk.kernel_normalized_attention(jnp.asarray(scores),
                                          jnp.asarray(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["softmax", "yat", "yat_spherical"])
def test_full_attention_gqa_matches_jax(kind):
    # H = 4 query heads over Hkv = 2 kv heads: kv broadcast over the group.
    (jq, jk_, jv), (tq, tk_, tv) = _both(_qkv(h=4, hkv=2, seed=5),
                                         "float32")
    want = jattn.full_attention(JSpec(kind=kind), None, jq, jk_, jv)
    got = tattn.full_attention(TSpec(kind=kind), None, tq, tk_, tv)
    _close(got, want, "float32")


def test_exact_attention_has_autograd_gradients():
    # Training runs the exact kinds through plain autograd.
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(seed=6))
    for kind in ("softmax", "yat", "yat_spherical"):
        y = tattn.full_attention(TSpec(kind=kind), None, q, k, v)
        gq, gk, gv = torch.autograd.grad(y.square().sum(), (q, k, v))
        assert all(bool(torch.isfinite(g).all()) for g in (gq, gk, gv))
        assert float(gk.abs().sum()) > 0.0
