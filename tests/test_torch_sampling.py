"""The port's threefry and samplers against ``jax.random`` and the JAX
package's ``repro.serving.sampling``, and the lockstep engine's sampled
streams against the JAX ``ServingEngine``.

Bits (keys, words, uniform floats) must be equal. Gumbel noise takes two
logarithms, each backend's own: XLA's float32 log is up to 1 ulp off,
torch's and the port's numpy one (float64 rounded) almost never. Near
g = 0 the outer log cancels, so one ulp of the inner log is many ulps of
g; the noise is held to 4 ulp of max(|g|, 1), twice the largest
difference measured here (1.86). Sampled tokens must be identical
wherever the top-2 gap of ``logits / T + g`` exceeds 1e-5, far above
that noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro.serving import sampling as jsampling
from repro_torch import convert, prng
from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import sampling as tsampling

torch.set_num_threads(1)    # small ops; the suite runs one process per core

SEEDS = [0, 1, 2 ** 31 + 5]
RIDS = [0, 1, 7, 70001]
IDXS = [0, 1, 13]
G_ULP = 4
TIE_GAP = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _jkey(seed, rid, idx):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
    return jax.random.fold_in(k, idx)


def _tkey(seed, rid, idx):
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed), rid), idx)


def _assert_noise_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want) / (EPS32 * np.maximum(np.abs(want), 1.0))
    assert err.max() <= G_ULP, f"{what}: {err.max():.2f} ulp"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_match_jax(seed):
    assert (prng.PRNGKey(seed) == np.asarray(jax.random.PRNGKey(seed))).all()
    for rid in RIDS:
        for idx in IDXS:
            jk, tk = _jkey(seed, rid, idx), _tkey(seed, rid, idx)
            np.testing.assert_array_equal(tk, np.asarray(jk))
            np.testing.assert_array_equal(prng.split(tk),
                                          np.asarray(jax.random.split(jk)))
            np.testing.assert_array_equal(
                prng.split(tk, 3), np.asarray(jax.random.split(jk, 3)))
            want = np.asarray(jax.random.bits(jk, (3, 37)))
            np.testing.assert_array_equal(prng.random_bits(tk, (3, 37)),
                                          want)
            got = prng.random_bits(tk, (3, 37), device="cpu")
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # Batched keys (as jax.vmap over keys): torch lanes, one row per key.
    rids = torch.tensor(RIDS, dtype=torch.int32)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), rids), 13)
    for i, rid in enumerate(RIDS):
        np.testing.assert_array_equal(keys[i].numpy().astype(np.uint32),
                                      np.asarray(_jkey(seed, rid, 13)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_gumbel_match_jax(seed):
    for rid in RIDS:
        for idx in IDXS:
            jk, tk = _jkey(seed, rid, idx), _tkey(seed, rid, idx)
            want = np.asarray(jax.random.uniform(jk, (2000,)))
            np.testing.assert_array_equal(prng.uniform(tk, (2000,)), want)
            np.testing.assert_array_equal(
                prng.uniform(tk, (2000,), device="cpu").numpy(), want)
            want16 = jax.random.uniform(jk, (2000,), jnp.bfloat16)
            got16 = prng.uniform(tk, (2000,), torch.bfloat16, device="cpu")
            np.testing.assert_array_equal(got16.float().numpy(),
                                          np.asarray(want16, np.float32))
            want = np.asarray(jax.random.gumbel(jk, (2000,)))
            _assert_noise_close(prng.gumbel(tk, (2000,)), want, "numpy")
            _assert_noise_close(prng.gumbel(tk, (2000,), device="cpu"),
                                want, "torch")


def _gap(x):
    top2 = np.sort(np.asarray(x, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_samplers_match_jax(temperature):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(9, 301)).astype(np.float32)
    rids = np.array([0, 1, 2, 7, 7, 40, 3, 70001, 5], np.int32)
    idxs = np.array([0, 0, 4, 1, 2, 9, 3, 0, 31], np.int32)
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(rids), jnp.asarray(idxs),
        temperature=temperature, seed=11))
    got = tsampling.sample_tokens(torch.from_numpy(logits),
                                  torch.from_numpy(rids),
                                  torch.from_numpy(idxs),
                                  temperature=temperature, seed=11)
    assert got.dtype == torch.int32
    if temperature > 0:
        g = np.stack([np.asarray(jsampling._gumbel_row(
            11, jnp.int32(r), jnp.int32(i), 301)) for r, i in zip(rids, idxs)])
        gaps = _gap(logits / np.float32(temperature) + g)
    else:
        gaps = _gap(logits)
    assert gaps.min() > TIE_GAP, f"near-tie (gap {gaps.min():.2e})"
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(9):
        host = tsampling.host_sample_token(logits[i], int(rids[i]),
                                           int(idxs[i]),
                                           temperature=temperature, seed=11)
        assert host == int(want[i]) == jsampling.host_sample_token(
            logits[i], int(rids[i]), int(idxs[i]), temperature=temperature,
            seed=11)


def test_stop_predicates_match_jax():
    tok = np.array([3, 5, 5, 9], np.int32)
    gen = np.array([1, 4, 2, 8], np.int32)
    want = jsampling.stop_hit(jnp.asarray(tok), jnp.asarray(gen), 5, 4)
    got = tsampling.stop_hit(torch.from_numpy(tok), torch.from_numpy(gen),
                             5, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsampling.FINISH_REASONS == jsampling.FINISH_REASONS
    for t, e in ((5, 5), (5, -1), (0, 0)):
        assert (tsampling.finish_reason_of(t, e)
                == jsampling.finish_reason_of(t, e))


def _host_mesh():
    # A 1x1 (data, model) mesh with Auto axes (ROADMAP C-4), as
    # tests/test_torch_model.py builds it.
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    return jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)


def test_lockstep_sampled_generate_matches_jax():
    # The repair: generate(temperature > 0) draws what the JAX engine
    # draws (categorical on PRNGKey(seed), then on split subkeys). The
    # embedding is scaled down so the logits are flat enough (std about
    # 1) that the draws decide the tokens.
    jcfg = jax_smoke_config("slayformer-124m", dtype="float32")
    tcfg = get_smoke_config("slayformer-124m", dtype="float32")
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (9, 14)]
    jeng = jengine.ServingEngine(jcfg, jp, _host_mesh(), max_len=64)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=64)
    for batch in ([prompts[0]], prompts):
        want = jeng.generate([jengine.Request(p, max_new_tokens=12)
                              for p in batch], temperature=0.8, seed=3)
        got = teng.generate([tengine.Request(p, max_new_tokens=12)
                             for p in batch], temperature=0.8, seed=3)
        _check_tie_free(tp, tcfg, batch, want, 0.8, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(set(want[0].tolist())) > 3      # the draws vary


def _check_tie_free(tp, tcfg, prompts, streams, temperature, seed):
    """Teacher-force the port along the JAX streams and fail on a near-tie
    of logits / T + g, where identity is not owed (ROADMAP C-2). The draw
    keys are the engine's: PRNGKey(seed), then the split subkeys."""
    lp = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, lp - len(p):] = p
    n = len(streams[0])
    key = draw = prng.PRNGKey(seed)
    with torch.inference_mode():
        logits, cache = api.prefill(tp, tcfg, torch.from_numpy(toks))
        for t in range(n):
            row = tsampling.scale_logits(logits[:, -1], temperature)
            g = prng.gumbel(draw, tuple(row.shape), device="cpu")
            gap = float(_gap((row + g).numpy()).min())
            assert gap > TIE_GAP, f"near-tie at token {t} (gap {gap:.2e})"
            if t + 1 < n:
                key, draw = prng.split(key)
                tok = torch.tensor([[s[t]] for s in streams],
                                   dtype=torch.int32)
                logits, cache = api.decode_step(tp, tcfg, cache, tok)
