"""The port's smoke-size slayformer against the JAX package, end to end.

Weights come from the JAX init and cross through numpy
(``repro_torch.convert``); token streams are drawn with numpy. Both sides
run in fp32 (``dtype="float32"``), the port's Ψ in fp32 like the Pallas
kernels. Logits are held to atol 1e-4 (about 3e-6 of their scale here):
two layers of fp32 matmuls in another summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from repro_torch.serving import engine as tengine

NAME = "slayformer-124m"
LOGIT_ATOL = 1e-4
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(NAME, dtype="float32")
    tcfg = get_smoke_config(NAME, dtype="float32")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or dict(rtol=0.0, atol=LOGIT_ATOL)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    jcfg = jax_smoke_config(NAME, dtype=dtype)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = convert.params_from_numpy(tree, device="cpu")
    assert tp["layers"]["attn"]["wq"].dtype == getattr(torch, dtype)
    assert tp["slay"]["anchors"].dtype == torch.float32
    back = dict(_leaves(convert.params_to_numpy(tp)))
    want = dict(_leaves(tree))
    assert back.keys() == want.keys()
    assert {"embed", "final_norm", "layers.attn.wo", "layers.mlp.down",
            "layers.pre_mlp", "slay.omegas"} <= back.keys()
    for name, arr in want.items():
        # bf16 -> fp32 is exact, so the round trip is bit for bit.
        np.testing.assert_array_equal(back[name],
                                      np.asarray(arr, np.float32), name)


def test_forward_logits_match(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 37)).astype(np.int32)
    want, _ = jtr.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = api.forward(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 37, 256) and float(aux) == 0.0
    _close(got, want)


def test_prefill_then_16_decode_steps_match(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(1).integers(0, 256, (2, 21)).astype(np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    _close(tc.attn.z, jc.attn.z, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for _ in range(16):
        jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok))
        tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    _close(tc.attn.z, jc.attn.z, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_masked_prefill_and_masked_decode_match(models):
    # Right-padded prompts with true_len, then a decode step with a
    # drained slot: its state must pass through bit-identically.
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(2).integers(0, 256, (3, 19)).astype(np.int32)
    true_len = np.array([19, 7, 12], np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks),
                         true_len=jnp.asarray(true_len))
    tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks),
                         true_len=torch.from_numpy(true_len))
    _close(tl, jl)
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), true_len)
    active = np.array([1, 0, 1], np.int32)
    s_before = tc.attn.s.clone()
    tok = np.array([[3], [5], [7]], np.int32)
    jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                             jnp.asarray(active))
    tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                             torch.from_numpy(active))
    _close(tl[active == 1], np.asarray(jl)[active == 1])
    assert torch.equal(tc.attn.s[:, 1], s_before[:, 1])
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), true_len + active)


def _min_top2_gap(tp, tcfg, prompts, streams):
    """Smallest top-2 logit gap along the greedy trace, teacher-forced."""
    lp = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, lp - len(p):] = p
    logits, cache = api.prefill(tp, tcfg, torch.from_numpy(toks))
    gaps = []
    for t in range(len(streams[0])):
        top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        if t + 1 < len(streams[0]):
            tok = torch.tensor([[s[t]] for s in streams], dtype=torch.int32)
            logits, cache = api.decode_step(tp, tcfg, cache, tok)
    return min(gaps)


def _host_mesh():
    # make_host_mesh()'s 1x1 (data, model) mesh with Auto axes: jax 0.9
    # makes mesh axes Explicit by default, and the JAX engine's activation
    # constraints then raise (ROADMAP C-4). The layout is the same.
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    return jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)


@pytest.mark.parametrize("batched", [False, True])
def test_greedy_generate_token_identical(models, batched):
    # One request per call (the JAX engine's exact mode) and one
    # left-padded batch of three.
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (9, 23, 14)]
    reqs = lambda mod: [mod.Request(p, max_new_tokens=12) for p in prompts]
    jeng = jengine.ServingEngine(jcfg, jp, _host_mesh(), max_len=64)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=64)
    if batched:
        want, got = jeng.generate(reqs(jengine)), teng.generate(reqs(tengine))
        gap = _min_top2_gap(tp, tcfg, prompts, want)
    else:
        want = [jeng.generate([r])[0] for r in reqs(jengine)]
        got = [teng.generate([r])[0] for r in reqs(tengine)]
        gap = min(_min_top2_gap(tp, tcfg, [p], [w])
                  for p, w in zip(prompts, want))
    # ROADMAP C-2: identity is only owed on a trace without near-ties. A
    # gap of 1e-3 is ten times the fp32 logit tolerance; an exact tie
    # (gap 0) is reported as a tie, not as a mismatch.
    assert gap > 0.0, "exact argmax tie on this trace: pick another seed"
    assert gap > 1e-3, f"near-tie on this trace (top-2 gap {gap:.2e})"
    assert [len(s) for s in got] == [12, 12, 12]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_generate_stops_at_eos_and_samples(models):
    _, tcfg, _, tp = models
    eng = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=64)
    prompt = np.arange(1, 9, dtype=np.int32)
    greedy = eng.generate([tengine.Request(prompt, max_new_tokens=6)])[0]
    # EOS = the third greedy token: the stream ends with it, inclusive.
    cut = eng.generate([tengine.Request(prompt, max_new_tokens=6,
                                        eos_id=int(greedy[2]))])[0]
    first = int(np.flatnonzero(greedy == greedy[2])[0])
    np.testing.assert_array_equal(cut, greedy[:first + 1])
    a = eng.generate([tengine.Request(prompt, 6)], temperature=1.0, seed=5)
    b = eng.generate([tengine.Request(prompt, 6)], temperature=1.0, seed=5)
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.generate([tengine.Request(prompt, max_new_tokens=60)])


def test_bf16_smoke_model_runs(models):
    # The serving dtype: finite logits of the right shape, the same greedy
    # first token as fp32 on this prompt.
    _, tcfg, _, tp = models
    cfg16 = dataclasses.replace(tcfg, dtype="bfloat16")
    tp16 = convert.params_from_numpy(convert.params_to_numpy(tp),
                                     device="cpu", dtype=torch.bfloat16)
    toks = torch.arange(1, 30, dtype=torch.int32)[None]
    l16, _ = api.prefill(tp16, cfg16, toks)
    l32, _ = api.prefill(tp, tcfg, toks)
    assert l16.dtype == torch.bfloat16 and l16.shape == (1, 1, 256)
    assert bool(torch.isfinite(l16.float()).all())
    assert int(l16.float().argmax()) == int(l32.argmax())
