"""The port's chunked prefill and slot functions against the JAX package's
(``repro.models.transformer``) on the smoke config, in fp32.

The chunk chain runs the same fp32 (S, z) recurrence as a whole-prompt
prefill in another order of sums: logits are held to the model tests'
atol 1e-4, the state to rtol/atol 1e-5. The slot writes are copies, so
the slots they do not write are held bit for bit, and the writes must
land in the pool's own storage (the decode kernel updates it in place).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import api

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
LOGIT_ATOL = 1e-4
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKS = (5, 16, 7)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, dtype="float32")
    tcfg = get_smoke_config(NAME, dtype="float32")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _state(cache):
    a = cache.attn
    return [np.asarray(x) for x in (a.s, a.z, a.pos, cache.pos)]


def _assert_state_close(got, want):
    for g, w in zip(_state(got)[:2], _state(want)[:2]):
        np.testing.assert_allclose(g, w, **STATE_TOL)
    for g, w in zip(_state(got)[2:], _state(want)[2:]):
        np.testing.assert_array_equal(g, w)


def test_chunked_prefill_matches_whole_prompt_and_jax(models):
    jcfg, tcfg, jp, tp = models
    prompt = np.random.default_rng(0).integers(
        1, 256, sum(CHUNKS)).astype(np.int32)[None]
    whole_logits, whole = api.prefill(tp, tcfg, torch.from_numpy(prompt))
    tc = api.init_cache(tcfg, 1, device="cpu")
    jc = jtr.init_cache(jcfg, 1, 64)
    off = 0
    for n in CHUNKS:
        chunk = prompt[:, off:off + n]
        tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(chunk))
        jl, jc = jtr.prefill_chunk(jp, jcfg, jc, jnp.asarray(chunk))
        off += n
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0.0,
                                   atol=LOGIT_ATOL)
        _assert_state_close(tc, jc)
        assert int(tc.pos[0]) == off
    np.testing.assert_allclose(tl.numpy(), whole_logits.numpy(), rtol=0.0,
                               atol=LOGIT_ATOL)
    _assert_state_close(tc, whole)


def _pool(models, slots=3):
    """A pool with every slot primed by a different prompt, and a fresh
    batch-1 request cache, on both sides."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 256, (slots, 11)).astype(np.int32)
    _, tpool = api.prefill(tp, tcfg, torch.from_numpy(toks))
    _, jpool = jtr.prefill(jp, jcfg, jnp.asarray(toks))
    src = rng.integers(1, 256, (1, 6)).astype(np.int32)
    _, tsrc = api.prefill(tp, tcfg, torch.from_numpy(src))
    _, jsrc = jtr.prefill(jp, jcfg, jnp.asarray(src))
    return tpool, jpool, tsrc, jsrc


def _storage(cache):
    a = cache.attn
    return [t.data_ptr() for t in (a.s, a.z, a.pos, cache.pos)]


@pytest.mark.parametrize("slot", [0, 2])
def test_write_and_reset_slot_in_place(models, slot):
    jcfg, tcfg, _, _ = models
    tpool, jpool, tsrc, jsrc = _pool(models)
    before = [t.clone() for t in (tpool.attn.s, tpool.attn.z)]
    ptrs = _storage(tpool)
    out = api.write_slot(tcfg, tpool, tsrc, slot)
    jpool = jtr.write_slot(jcfg, jpool, jsrc, slot)
    assert out is tpool and _storage(out) == ptrs
    assert tpool.attn.s.is_contiguous() and tpool.attn.z.is_contiguous()
    _assert_state_close(tpool, jpool)
    others = [i for i in range(3) if i != slot]
    for t, b in zip((tpool.attn.s, tpool.attn.z), before):
        assert torch.equal(t[:, others], b[:, others])
        assert torch.equal(t[:, slot], (tsrc.attn.s if t is tpool.attn.s
                                        else tsrc.attn.z)[:, 0])
    out = api.reset_slot(tcfg, tpool, slot)
    jpool = jtr.reset_slot(jcfg, jpool, slot)
    assert out is tpool and _storage(out) == ptrs
    _assert_state_close(tpool, jpool)
    assert not tpool.attn.s[:, slot].any() and int(tpool.pos[slot]) == 0
    for t, b in zip((tpool.attn.s, tpool.attn.z), before):
        assert torch.equal(t[:, others], b[:, others])


def test_slot_state_finite_and_corrupt_slot(models):
    jcfg, tcfg, _, _ = models
    tpool, jpool, _, _ = _pool(models)
    assert api.slot_state_finite(tcfg, tpool).tolist() == [True] * 3
    z_before = tpool.attn.z.clone()
    pos_before = tpool.attn.pos.clone()
    ptrs = _storage(tpool)
    out = api.corrupt_slot(tcfg, tpool, 1)
    jpool = jtr.corrupt_slot(jcfg, jpool, 1)
    assert out is tpool and _storage(out) == ptrs
    got = api.slot_state_finite(tcfg, tpool)
    want = np.asarray(jtr.slot_state_finite(jcfg, jpool))
    assert got.tolist() == want.tolist() == [True, False, True]
    assert torch.equal(tpool.attn.z[:, [0, 2]], z_before[:, [0, 2]])
    assert torch.equal(tpool.attn.pos, pos_before)
    # One non-finite element anywhere in a slot's state flags that slot.
    api.reset_slot(tcfg, tpool, 1)
    tpool.attn.z[1, 2, 0, 3] = float("inf")
    assert api.slot_state_finite(tcfg, tpool).tolist() == [True, True, False]


def test_masked_pool_decode_leaves_drained_slots_bit_identical(models):
    jcfg, tcfg, jp, tp = models
    tpool, jpool, _, _ = _pool(models)
    active = np.array([1, 0, 1], np.int32)
    s0, z0 = tpool.attn.s.clone(), tpool.attn.z.clone()
    ptrs = _storage(tpool)[:2]
    tok = np.array([[4], [9], [17]], np.int32)
    for _ in range(3):
        tl, tpool = api.decode_step(tp, tcfg, tpool, torch.from_numpy(tok),
                                    torch.from_numpy(active))
        jl, jpool = jtr.decode_step(jp, jcfg, jpool, jnp.asarray(tok),
                                    jnp.asarray(active))
    assert _storage(tpool)[:2] == ptrs
    assert torch.equal(tpool.attn.s[:, 1], s0[:, 1])
    assert torch.equal(tpool.attn.z[:, 1], z0[:, 1])
    assert not torch.equal(tpool.attn.s[:, 0], s0[:, 0])
    np.testing.assert_allclose(tl.numpy()[active == 1],
                               np.asarray(jl)[active == 1], rtol=0.0,
                               atol=LOGIT_ATOL)
    _assert_state_close(tpool, jpool)


def test_slot_predicates_match_jax(models):
    jcfg, tcfg, _, _ = models
    assert (api.supports_chunked_prefill(tcfg)
            == japi.supports_chunked_prefill(jcfg) is True)
    assert api.supports_paging(tcfg) == japi.supports_paging(jcfg) is False
    assert (api.context_capacity(tcfg, 64)
            == japi.context_capacity(jcfg, 64) is None)
