"""The speculative-decoding math of the port (``repro_torch.serving.
speculative``, the ``spec_*`` substreams of ``serving.sampling`` and the
verifier surface of the model) against the JAX package's, on the CPU.

Bits: ``spec_key`` and ``spec_uniform`` equal ``jax.random``'s; the
Gumbel rows of a substream within 2 ulp of max(|g|, 1) (ROADMAP C-3: the
logarithms are each backend's own). The acceptance math: ``draft_sample``
and ``accept_and_correct`` on the same logits, greedy and sampled, with
each decision's margin checked first (a near-tie fails as such, C-2),
and the port's own chi-square test that the emitted distribution is the
verifier's, with the JAX test's critical values. The verifier:
``verify_chunk`` on softmax, yat and yat_spherical pools (fp32, slots at
different positions, one drained) against the JAX function, unpaged and
paged: logits, rings, positions and page tables; row j against
sequential decode steps; ``rollback_slots``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro.serving import pages as jpages
from repro.serving import sampling as jsampling
from repro.serving import speculative as jspec
from repro_torch import convert, prng
from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from repro_torch.serving import sampling
from repro_torch.serving import speculative
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAME = "slayformer-124m"
SEEDS = [0, 3, 2 ** 31 + 5]
RIDS = [0, 1, 70001]
IDXS = [0, 2, 13]
G_ULP = 2
EPS32 = float(np.finfo(np.float32).eps)
TIE_GAP = 1e-5
# fp32 at the smoke config, tests/test_torch_ring.py's tolerances: logits
# to 1e-4 absolute, ring rows to 1e-5 relative and 1e-4 absolute.
LOGIT_ATOL = 1e-4
RING_TOL = dict(rtol=1e-5, atol=1e-4)
# chi-square critical values at p = 0.001 for df = vocab - 1, as the JAX
# package's tests/test_speculative.py; the seeds are fixed, so each case
# is one known draw.
CHI2_CRIT = {7: 24.32, 15: 37.70}
TAGS = (sampling.SPEC_TAG_DRAFT, sampling.SPEC_TAG_ACCEPT,
        sampling.SPEC_TAG_RESAMPLE)


# ---------------------------------------------------------------------------
# Substreams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_spec_keys_uniform_and_gumbel_match_jax(seed):
    assert (sampling.SPEC_TAG_DRAFT, sampling.SPEC_TAG_ACCEPT,
            sampling.SPEC_TAG_RESAMPLE) == (jsampling.SPEC_TAG_DRAFT,
                                            jsampling.SPEC_TAG_ACCEPT,
                                            jsampling.SPEC_TAG_RESAMPLE)
    assert sampling.STREAM_KEY_VERSION == jsampling.STREAM_KEY_VERSION
    rids = torch.tensor([r for r in RIDS for _ in IDXS], dtype=torch.int32)
    idxs = torch.tensor(IDXS * len(RIDS), dtype=torch.int32)
    for tag in TAGS:
        want = np.stack([np.asarray(jax.random.key_data(jsampling.spec_key(
            seed, jnp.int32(r), jnp.int32(i), tag)))
            for r, i in zip(rids.tolist(), idxs.tolist())])
        np.testing.assert_array_equal(
            sampling.spec_key(seed, rids, idxs, tag).numpy(), want)
        for r, i, w in zip(rids.tolist(), idxs.tolist(), want):
            np.testing.assert_array_equal(sampling.spec_key(seed, r, i, tag),
                                          w)
        g = sampling.spec_gumbel_row(seed, rids, idxs, tag, 97)
        gw = np.stack([np.asarray(jsampling.spec_gumbel_row(
            seed, jnp.int32(r), jnp.int32(i), tag, 97))
            for r, i in zip(rids.tolist(), idxs.tolist())])
        err = np.abs(g.numpy() - gw) / (EPS32 * np.maximum(np.abs(gw), 1.0))
        assert err.max() <= G_ULP, f"tag {tag}: {err.max():.2f} ulp"
    u = sampling.spec_uniform(seed, rids, idxs)
    uw = np.array([np.asarray(jsampling.spec_uniform(
        seed, jnp.int32(r), jnp.int32(i)))
        for r, i in zip(rids.tolist(), idxs.tolist())])
    assert u.dtype == torch.float32 and u.shape == (len(uw),)
    np.testing.assert_array_equal(u.numpy(), uw)
    assert sampling.spec_uniform(seed, 1, 2) == np.asarray(
        jsampling.spec_uniform(seed, jnp.int32(1), jnp.int32(2)))
    assert ((u >= 0) & (u < 1)).all()


def test_substreams_are_independent():
    # The DRAFT, ACCEPT and RESAMPLE streams of one (seed, rid, idx) and
    # the untagged base stream never share a key.
    keys = [tuple(sampling.spec_key(0, 1, 2, t).tolist()) for t in TAGS]
    base = prng.fold_in(prng.fold_in(prng.PRNGKey(0), 1), 2)
    assert len({*keys, tuple(base.tolist())}) == 4
    rows = [sampling.spec_gumbel_row(0, 1, 2, t, 64) for t in TAGS]
    rows.append(sampling._gumbel_row(0, 1, 2, 64))
    for a in range(len(rows)):
        for b in range(a):
            assert not np.array_equal(np.asarray(rows[a]),
                                      np.asarray(rows[b]))


# ---------------------------------------------------------------------------
# Acceptance math
# ---------------------------------------------------------------------------


def _top2_gap(x: np.ndarray) -> np.ndarray:
    part = np.sort(np.where(np.isfinite(x), x, -np.inf), axis=-1)
    return part[..., -1] - part[..., -2]


def _slots(n=9):
    rids = np.array([0, 1, 2, 7, 7, 40, 3, 70001, 5][:n], np.int32)
    idxs = np.array([0, 0, 4, 1, 2, 9, 3, 0, 31][:n], np.int32)
    return rids, idxs


def _jrows(fn, rids, idxs, *a):
    return np.stack([np.asarray(fn(*a[:1], jnp.int32(r), jnp.int32(i),
                                   *a[1:]))
                     for r, i in zip(rids, idxs)])


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_draft_sample_matches_jax(temperature):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(9, 301)).astype(np.float32)
    rids, idxs = _slots()
    want = np.asarray(jspec.draft_sample(
        jnp.asarray(logits), jnp.asarray(rids), jnp.asarray(idxs),
        temperature=temperature, seed=11))
    got = speculative.draft_sample(
        torch.from_numpy(logits), torch.from_numpy(rids),
        torch.from_numpy(idxs), temperature=temperature, seed=11)
    row = logits
    if temperature > 0:
        row = logits / np.float32(temperature) + _jrows(
            jsampling.spec_gumbel_row, rids, idxs, 11,
            jsampling.SPEC_TAG_DRAFT, 301)
    gap = _top2_gap(row).min()
    assert gap > TIE_GAP, f"near-tie (gap {gap:.2e})"
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [0.0, 0.6, 1.4])
def test_accept_and_correct_matches_jax(temperature):
    rng = np.random.default_rng(6)
    V = 41
    p = rng.normal(size=(9, V)).astype(np.float32)
    q = (p + rng.normal(size=(9, V)) * 0.7).astype(np.float32)
    rids, idxs = _slots()
    drafts = np.array(jspec.draft_sample(
        jnp.asarray(q), jnp.asarray(rids), jnp.asarray(idxs),
        temperature=temperature, seed=4))
    drafts[0] = np.argmax(p[0])      # one sure accept when greedy
    acc, corr = jspec.accept_and_correct(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(drafts),
        jnp.asarray(rids), jnp.asarray(idxs), temperature=temperature,
        seed=4)
    tacc, tcorr = speculative.accept_and_correct(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(drafts),
        torch.from_numpy(rids), torch.from_numpy(idxs),
        temperature=temperature, seed=4)
    if temperature > 0:
        # The coin's margin, then the resample's top-2 gap.
        pp = np.asarray(jax.nn.softmax(p / np.float32(temperature)))
        qq = np.asarray(jax.nn.softmax(q / np.float32(temperature)))
        d = drafts[:, None]
        pd = np.take_along_axis(pp, d, -1)[:, 0]
        qd = np.take_along_axis(qq, d, -1)[:, 0]
        u = _jrows(jsampling.spec_uniform, rids, idxs, 4)
        coin = np.abs(u * qd - pd) / pd
        assert coin.min() > TIE_GAP, f"near-tie coin ({coin.min():.2e})"
        r = np.maximum(pp - qq, 0)
        logr = np.where(r > 0, np.log(np.maximum(r, 1e-38)), -np.inf)
        g = _jrows(jsampling.spec_gumbel_row, rids, idxs, 4,
                   jsampling.SPEC_TAG_RESAMPLE, V)
        gap = _top2_gap(logr + g).min()
        assert gap > TIE_GAP, f"near-tie resample (gap {gap:.2e})"
        assert 0 < int(np.asarray(acc).sum()) < 9
    else:
        assert bool(acc[0]) and not bool(np.asarray(acc).all())
        np.testing.assert_array_equal(tcorr.numpy(), np.argmax(p, -1))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(tcorr.numpy(), np.asarray(corr))
    assert tacc.dtype == torch.bool and tcorr.dtype == torch.int32


def _emitted(p_logits, q_logits, *, temperature, seed, n, idx):
    """n independent speculative draws of one token position, vectorised
    over the rid axis (each (seed, rid, idx) an independent stream)."""
    vocab = p_logits.shape[-1]
    rids = torch.arange(n, dtype=torch.int32)
    idxs = torch.full((n,), idx, dtype=torch.int32)
    p = p_logits.expand(n, vocab)
    q = q_logits.expand(n, vocab)
    drafts = speculative.draft_sample(q, rids, idxs, temperature=temperature,
                                      seed=seed)
    acc, corr = speculative.accept_and_correct(
        p, q, drafts, rids, idxs, temperature=temperature, seed=seed)
    return torch.where(acc, drafts, corr).numpy(), acc.numpy()


def _chi2(counts, probs, n):
    exp = probs * n
    return float(np.sum((counts - exp) ** 2 / np.maximum(exp, 1e-12)))


@pytest.mark.parametrize("case", range(4))
def test_accepted_distribution_matches_verifier(case):
    """The emitted histogram follows softmax(p / T) however far the draft
    q is from the verifier p (chi-square, p = 0.001): the cases of the
    JAX package's test."""
    rng = np.random.default_rng(100 + case)
    vocab = int(rng.choice([8, 16]))
    temperature = float(rng.uniform(0.4, 1.6))
    scale = float(rng.uniform(0.5, 3.0))
    p_logits = torch.from_numpy(rng.normal(size=vocab).astype(np.float32))
    q_logits = torch.from_numpy(
        (rng.normal(size=vocab) * scale).astype(np.float32))
    n = 8000
    toks, _ = _emitted(p_logits, q_logits, temperature=temperature,
                       seed=case, n=n, idx=3 + case)
    counts = np.bincount(toks, minlength=vocab)
    probs = torch.softmax(p_logits / temperature, -1).numpy()
    assert _chi2(counts, probs, n) < CHI2_CRIT[vocab - 1]


def test_identical_distributions_always_accept():
    # u * q(d) < p(d) with u in [0, 1): p == q accepts every draft.
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    toks, acc = _emitted(logits, logits, temperature=0.9, seed=7, n=2000,
                         idx=5)
    assert acc.all()
    counts = np.bincount(toks, minlength=16)
    probs = torch.softmax(logits / 0.9, -1).numpy()
    assert _chi2(counts, probs, 2000) < CHI2_CRIT[15]


# ---------------------------------------------------------------------------
# The verifier: verify_chunk, rollback_slots
# ---------------------------------------------------------------------------

S, L, PAGE = 3, 32, 8
PROMPTS = (5, 11, 7)
LC = 3
ACTIVE = (True, False, True)


@pytest.fixture(scope="module", params=["softmax", "yat", "yat_spherical"])
def kind_models(request):
    kind = request.param
    jcfg = jax_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tcfg = get_smoke_config(NAME, dtype="float32", attn_kind=kind)
    tree = jax.device_get(japi.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


def _pools(kind_models, paged):
    """The same pool on both sides: the prompts prefilled alone and
    written into slots 0-2 (different positions; paged, each slot's pages
    allocated for its prompt and 2 x LC rows)."""
    jcfg, tcfg, jp, tp = kind_models
    rng = np.random.default_rng(2)
    kw, st = {}, None
    if paged:
        pp = jpages.PagePool(S, S * L // PAGE, PAGE, L // PAGE)
        for slot, n in enumerate(PROMPTS):
            pp.alloc(slot, n + 2 * LC)
        st = pp.device_vectors()
        kw = dict(page_size=PAGE, num_pages=pp.num_pages)
    jpool = japi.init_cache(jcfg, S, L, **kw)
    for slot, n in enumerate(PROMPTS):
        toks = jnp.asarray(rng.integers(3, 256, (1, n)), jnp.int32)
        _, one = japi.prefill(jp, jcfg, {"tokens": toks}, max_len=L)
        jpool = japi.write_slot(jcfg, jpool, one, jnp.int32(slot), st)
    tpool = api.init_cache(tcfg, S, L, device="cpu", **kw)
    for dst, src in zip(tree_leaves(tpool), jax.tree.leaves(jpool)):
        dst.copy_(torch.from_numpy(np.array(src)))
    return jpool, tpool


def _leaves_equal(got, want, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, **RING_TOL,
                                       err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, f"{what} leaf {i}")


@pytest.mark.parametrize("paged", [False, True])
def test_verify_chunk_matches_jax(kind_models, paged):
    jcfg, tcfg, jp, tp = kind_models
    jpool, tpool = _pools(kind_models, paged)
    before = [t.clone() for t in tree_leaves(tpool)]
    toks = np.random.default_rng(4).integers(3, 256, (S, LC)).astype(
        np.int32)
    act = np.array(ACTIVE)
    jl, jnew = japi.verify_chunk(jcfg, jp, jpool, jnp.asarray(toks),
                                 jnp.asarray(act))
    with torch.inference_mode():
        tl, tnew = api.verify_chunk(tcfg, tp, tpool, torch.from_numpy(toks),
                                    torch.from_numpy(act))
    assert tnew is tpool and tl.shape == (S, LC, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                               rtol=0.0, atol=LOGIT_ATOL)
    _leaves_equal(tpool, jnew, "advanced pool")
    pos = np.array(PROMPTS) + LC * act
    np.testing.assert_array_equal(tpool.pos.numpy(), pos)
    assert (tpool.attn.pos.numpy() == pos).all()
    # The drained slot keeps its bytes: its ring rows, or its pages.
    if paged:
        mine = (tpool.pages.owner_slot == 1)
        for b, a in zip(before[:2], tree_leaves(tpool)[:2]):
            assert torch.equal(a[:, mine], b[:, mine])
    else:
        for b, a in zip(before[:2], tree_leaves(tpool)[:2]):
            assert torch.equal(a[:, 1], b[:, 1])
    # Rolling back and forth moves positions only.
    rb = np.array(PROMPTS) + np.array([1, 0, 2])
    jrb = japi.rollback_slots(jcfg, jnew, jnp.asarray(rb, jnp.int32))
    ring = [t.clone() for t in tree_leaves(tpool)[:2]]
    out = api.rollback_slots(tcfg, tpool, torch.from_numpy(rb.astype(
        np.int32)))
    assert out is tpool
    _leaves_equal(tpool, jrb, "rolled-back pool")
    assert all(torch.equal(a, b) for a, b in zip(ring,
                                                 tree_leaves(tpool)[:2]))
    assert api.slot_positions(tcfg, tpool) is tpool.pos


@pytest.mark.parametrize("paged", [False, True])
def test_verify_rows_are_sequential_decode_logits(kind_models, paged):
    # Row j of one chunk is the logits of decode step j on the same
    # tokens; the chunk leaves the pool as the steps do.
    _, tcfg, _, tp = kind_models
    _, chunk_pool = _pools(kind_models, paged)
    _, step_pool = _pools(kind_models, paged)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        3, 256, (S, LC)).astype(np.int32))
    act = torch.tensor(ACTIVE)
    with torch.inference_mode():
        rows, _ = api.verify_chunk(tcfg, tp, chunk_pool, toks, act)
        for j in range(LC):
            lg, _ = api.decode_step(tp, tcfg, step_pool, toks[:, j:j + 1],
                                    act)
            torch.testing.assert_close(rows[act, j], lg[act, 0], rtol=0.0,
                                       atol=LOGIT_ATOL)
    for a, b in zip(tree_leaves(chunk_pool), tree_leaves(step_pool)):
        torch.testing.assert_close(a, b, **RING_TOL)


def test_draft_surface(kind_models):
    jcfg, tcfg, _, tp = kind_models
    dcfg = api.draft_config(tcfg)
    assert dcfg.attn_kind == "slay" and api.supports_speculative(tcfg)
    assert api.draft_config(jcfg).attn_kind == japi.draft_config(
        jcfg).attn_kind == "slay"
    assert not api.supports_speculative(dcfg)
    assert japi.supports_speculative(jcfg) and not japi.supports_speculative(
        japi.draft_config(jcfg))
    with pytest.raises(ValueError, match="exact kind"):
        api.verify_chunk(dcfg, tp, api.init_cache(dcfg, 1, 8, device="cpu"),
                         torch.zeros(1, 2, dtype=torch.int32))
    # A tree with the JAX draft's projections keeps them; one without gets
    # the port's own, fixed per checkpoint and fp32.
    jd = jax.device_get(japi.ensure_draft_params(
        japi.draft_config(jcfg), japi.init_params(jcfg,
                                                  jax.random.PRNGKey(0))))
    conv = convert.params_from_numpy(jd, device="cpu")
    assert api.ensure_draft_params(dcfg, conv) is conv
    mine = api.ensure_draft_params(dcfg, tp)
    again = api.ensure_draft_params(dcfg, tp)
    assert "slay" not in tp and set(mine) == set(tp) | {"slay"}
    for k in ("anchors", "omegas"):
        assert mine["slay"][k].dtype == torch.float32
        assert mine["slay"][k].shape == conv["slay"][k].shape
        assert torch.equal(mine["slay"][k], again["slay"][k])
