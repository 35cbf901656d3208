"""gemma2-27b (local/global layers) and the top-2 MoE decoders
phi3.5-moe-42b-a6.6b and grok-1-314b in the port against the JAX package,
on the CPU, at their smoke configs in fp32.

gemma2's smoke config has 4 layers (0 and 2 local: a 32-token window,
softcap 50; 1 and 3 global SLAY), d_model 64, 4 q heads on 2 kv heads;
the MoE smoke configs have 2 layers of 4 experts, top 2. Weights come
from the JAX init and cross through numpy (``repro_torch.convert``).
Tolerances: logits to 5e-5 of their largest magnitude (the tied
256-wide unembedding of unscaled embeddings gives logits up to about 25;
fp32 in another summation order through gemma2's softcapped softmax
layers leaves single steps up to 3e-5 of that apart, the SLAY-only
paths under 1e-5), every decode state leaf ((S, z), ring rows) to 5e-5 of its largest
magnitude (the state of gemma2's last layer carries three layers'
rounding), the loss and ``moe_aux`` to 1e-5
relative, gradients to 1e-4 of each leaf's largest magnitude, ``moe``'s
output to 1e-5, as ``tests/test_torch_archs.py`` holds the dense
decoders. ``lax.top_k`` breaks ties toward the lower index and
``torch.topk`` promises nothing: the router probabilities here come from
random fp32 weights and are tie-free. gemma2's lockstep engine, the
continuous engines of gemma2 and phi3.5-moe and phi3.5-moe's
speculative engine (a softmax verifier) each run one trace beside the
JAX engine's (1x1 mesh with Auto axes, ROADMAP C-4), and gemma2's
crash-restore (prefix cache and checkpoints) crosses both ways: streams
and counters identical where no near-tie decides a token (C-2; the
continuous and restore tests check the gaps).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import ServingConfig as JServingConfig
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import journal as jjournal
from repro_torch import configs, convert
from repro_torch.configs.base import ArchConfig, ServingConfig
from repro_torch.examples import serve, train_slayformer
from repro_torch.models import api, layers
from repro_torch.models import transformer as ttr
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import journal as tjournal
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items

torch.set_num_threads(1)    # small ops; the suite runs one process per core

GEMMA = "gemma2-27b"
MOES = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
ARCHS = (GEMMA,) + MOES
LOGIT_REL = 5e-5
STATE_REL = 5e-5
GRAD_REL = 1e-4
TIE_GAP = 1e-5


def _close(got, want, **tol):
    want = np.asarray(want)
    if not tol:
        tol = dict(rtol=0.0, atol=LOGIT_REL * np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, **tol)



def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree, np.float32)


def _auto_mesh():
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    return jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)


def _pair(name, scale=1.0, **overrides):
    """(jcfg, tcfg, JAX params, port params) at the smoke config in fp32,
    the embedding divided by ``scale``."""
    jcfg = jax_smoke_config(name, dtype="float32", **overrides)
    tcfg = configs.get_smoke_config(name, dtype="float32", **overrides)
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / scale
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


# -- configs and parameters --------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_jax(name):
    # Every field equal to the JAX package's, full width and smoke; the
    # JAX fields the port lacks sit at their defaults there.
    port = {f.name for f in dataclasses.fields(ArchConfig)}
    assert {"local_window", "local_global_period", "moe_experts",
            "moe_top_k"} <= port
    for tcfg, jcfg in ((configs.get_config(name), jax_config(name)),
                       (configs.get_smoke_config(name),
                        jax_smoke_config(name))):
        for f in port:
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        for f in dataclasses.fields(JArchConfig):
            if f.name not in port:
                assert getattr(jcfg, f.name) == f.default, f.name
        for local in (False, True):
            a = tcfg.attention_spec(local=local)
            b = jcfg.attention_spec(local=local)
            assert (a.kind, a.window, a.logit_softcap) == (
                b.kind, b.window, b.logit_softcap)
    assert name in configs.ALL_ARCHS
    np.testing.assert_array_equal(
        ttr._layer_kinds(configs.get_config(name)),
        jtr._layer_kinds(jax_config(name)))


@pytest.mark.parametrize("kind", ["slay", "softmax"])
@pytest.mark.parametrize("name", ARCHS)
def test_capabilities_match_jax(name, kind):
    tcfg = configs.get_smoke_config(name, attn_kind=kind)
    jcfg = jax_smoke_config(name, attn_kind=kind)
    for fn in ("supports_paging", "supports_speculative",
               "supports_masked_prefill"):
        assert getattr(ttr, fn)(tcfg) == getattr(jtr, fn)(jcfg), fn
    for max_len in (16, 64):
        assert (ttr.context_capacity(tcfg, max_len)
                == jtr.context_capacity(jcfg, max_len))
    # The union layout: every leaf's shape and dtype as the JAX cache's.
    got = api.abstract_cache(tcfg, 3, 48)
    want = jtr.init_cache(jcfg, 3, 48)
    for t, w in zip(got.attn, want.attn):
        assert (t is None) == (w is None)
        if t is not None:
            assert tuple(t.shape) == w.shape
            assert str(t.dtype).split(".")[-1] == str(w.dtype)


def test_params_convert_and_round_trip(models):
    jcfg, tcfg, jp, tp = models
    want = dict(_flat(jax.device_get(jp)))
    mine = dict(_flat(api.init_params(tcfg, 0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in want.items()}
    assert ("layers/moe/router" in want) == bool(jcfg.moe_experts)
    assert ("layers/mlp/up" in want) == (not jcfg.moe_experts)
    back = dict(_flat(convert.params_to_numpy(tp)))
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, k)


@pytest.mark.parametrize("name", ARCHS)
def test_drivers_take_the_arch(name, tmp_path, capsys):
    hist = train_slayformer.main(["--device", "cpu", "--arch", name,
                                  "--steps", "2", "--seq", "32", "--batch",
                                  "2", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and all(np.isfinite([h["loss"] for h in hist]))
    assert all((h["moe_aux"] > 0) == (name in MOES) for h in hist)
    outs = serve.main(["--device", "cpu", "--arch", name, "--max-new", "4"])
    assert len(outs) == 4 and all(len(o) == 4 for o in outs)
    assert name in capsys.readouterr().out
    assert serve.build_config(serve.parse_args(
        ["--arch", name, "--no-smoke"])) == configs.get_config(name)


# -- the MoE layer -----------------------------------------------------------


def _moe_params(seed=0, d=64, e=4, ff=96):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(0, 0.3, (d, e)).astype(np.float32),
            "gate": rng.normal(0, 0.1, (e, d, ff)).astype(np.float32),
            "up": rng.normal(0, 0.1, (e, d, ff)).astype(np.float32),
            "down": rng.normal(0, 0.1, (e, ff, d)).astype(np.float32)}


def _both_moe(p, x, **kw):
    jy, jaux = jlayers.moe({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), p["router"].shape[1], 2, **kw)
    ty, taux = layers.moe({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), p["router"].shape[1], 2, **kw)
    _close(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    return ty


def test_moe_capacity_drops_match_jax():
    # Every token routes to experts 0 and 1 (router columns 0 and 1 align
    # with a shared direction of x): 16 tokens x top 2 on 4 experts gives
    # capacity int(1.25 * 16 * 2 / 4) = 10 per expert, so tokens 10-15
    # lose both choices (a zero row) and 0-9 keep both.
    p = _moe_params()
    rng = np.random.default_rng(1)
    u = rng.normal(size=64).astype(np.float32)
    u /= np.linalg.norm(u)
    p["router"][:, 0] = 3.0 * u
    p["router"][:, 1] = 2.0 * u
    x = (4.0 * u + 0.05 * rng.normal(size=(2, 16, 64))).astype(np.float32)
    y = _both_moe(p, x)
    assert bool((y[:, 10:] == 0).all())
    assert bool((y[:, :10].abs().amax(-1) > 0).all())


def test_moe_queue_order_and_seq_chunks_match_jax():
    # Random routing (some experts over capacity at 24 tokens, so a
    # token's second choice queues behind earlier tokens' first), and a
    # 24-token sequence split into chunks of 8 with the aux averaged.
    p = _moe_params(2)
    x = np.random.default_rng(3).normal(size=(3, 24, 64)).astype(np.float32)
    for kw in ({}, {"seq_chunk": 8}, {"capacity_factor": 0.5}):
        _both_moe(p, x, **kw)
    # Grouped leading dims and a one-token decode row (C = 1).
    _both_moe(p, x[:, :1])
    _both_moe(p, x.reshape(3, 2, 12, 64))


# -- the model paths ---------------------------------------------------------


@pytest.mark.parametrize("L", [37, 64])
def test_forward_logits_match(models, L):
    # gemma2 at L = 64 takes the banded route (64 % 32 == 0, 64 > 32), at
    # 37 the masked one.
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(L).integers(0, 256, (2, L)).astype(np.int32)
    want, jaux = jtr.forward(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        got, aux = api.forward(tp, tcfg, torch.from_numpy(toks))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == bool(jcfg.moe_experts)


def test_loss_aux_and_grads_match(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(1).integers(0, 256, (2, 41)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jmx), jg = jax.value_and_grad(japi.loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    loss, mx, grads = tloop.value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(mx["moe_aux"]), float(jmx["moe_aux"]),
                               rtol=1e-5)
    want = {k: v for k, v in _flat(jax.device_get(jg))
            if not k.startswith("slay")}
    got = {k.replace(".", "/"): v.float().numpy()
           for k, v in tree_items(grads) if not k.startswith("slay")}
    assert got.keys() == want.keys()
    if jcfg.moe_experts:       # the router learns through gates and aux
        assert np.abs(want["layers/moe/router"]).max() > 0
    for k, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=GRAD_REL * scale, err_msg=k)


def _state_close(tc, jc):
    a, b = tc.attn, jc.attn
    for name in ("s", "z", "k", "v"):
        got, want = getattr(a, name), getattr(b, name)
        assert (got is None) == (want is None), name
        if want is not None:
            want = np.asarray(want)
            _close(got, want, rtol=0.0,
                   atol=STATE_REL * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(a.pos.numpy(), np.asarray(b.pos))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("plen", [28, 40])
def test_prefill_then_8_decode_steps_match(models, plen):
    # gemma2's rings hold 32 rows: a 28-token prompt wraps during the 8
    # decode steps, a 40-token one in the prefill.
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(plen).integers(
        0, 256, (2, plen)).astype(np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks), max_len=64)
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks), max_len=64)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        for _ in range(8):
            jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok))
            tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
            _close(tl, jl)
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
    _state_close(tc, jc)
    if jcfg.local_window:
        assert tc.attn.k.shape[2] == 32 and plen + 8 > 32


@pytest.mark.parametrize("max_len,chunk", [(64, 16), (16, 24)])
def test_prefill_chunk_rows_match(models, max_len, chunk):
    # An 80-token prompt chunk by chunk into a fresh cache: every chunk's
    # last-token logits and the final state. gemma2's rings: 32 rows
    # (wrapped), or 16 rows with chunks of 24 (each chunk longer than the
    # ring commits only its tail; a0 of an unwritten row is negative on
    # the first chunk).
    jcfg, tcfg, jp, tp = models
    prompt = np.random.default_rng(3).integers(0, 256, 80).astype(np.int32)
    jc = jtr.init_cache(jcfg, 1, max_len)
    with torch.inference_mode():
        tc = api.init_cache(tcfg, 1, max_len, device="cpu")
        for o in range(0, 80, chunk):
            piece = prompt[None, o:o + chunk]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(piece))
            jl, jc = jtr.prefill_chunk(jp, jcfg, jc, jnp.asarray(piece))
            _close(tl, jl)
    _state_close(tc, jc)
    np.testing.assert_array_equal(tc.pos.numpy(), [80])


@pytest.mark.parametrize("name", MOES)
def test_moe_verify_chunk_rows_match(name):
    # An MoE config verifies under an exact kind: two slots prefilled, 3
    # candidate rows each (capacity of a 3-token chunk), the second slot
    # drained; live rows' logits and the advanced rings.
    jcfg, tcfg, jp, tp = _pair(name, attn_kind="softmax")
    assert api.supports_speculative(tcfg) and jtr.supports_speculative(jcfg)
    rng = np.random.default_rng(4)
    jpool = japi.init_cache(jcfg, 2, 32)
    with torch.inference_mode():
        tpool = api.init_cache(tcfg, 2, 32, device="cpu")
        for slot, n in enumerate((9, 14)):
            toks = rng.integers(3, 256, (1, n)).astype(np.int32)
            _, one = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                  max_len=32)
            jpool = japi.write_slot(jcfg, jpool, one, jnp.int32(slot))
            _, tone = api.prefill(tp, tcfg, torch.from_numpy(toks),
                                  max_len=32)
            tpool = api.write_slot(tcfg, tpool, tone, slot)
        toks = rng.integers(3, 256, (2, 3)).astype(np.int32)
        act = np.array([True, False])
        jl, jnew = japi.verify_chunk(jcfg, jp, jpool, jnp.asarray(toks),
                                     jnp.asarray(act))
        tl, tnew = api.verify_chunk(tcfg, tp, tpool, torch.from_numpy(toks),
                                    torch.from_numpy(act))
    assert tnew is tpool and tl.shape == (2, 3, 256)
    _close(tl.numpy()[act], np.asarray(jl)[act])
    _state_close(tpool, jnew)


def test_c9_exact_global_layers_decode_over_the_window_ring():
    # ROADMAP C-9, a caveat of the reference reproduced: under an exact
    # kind every layer's ring has min(max_len, local_window) rows, so
    # gemma2's global softmax layers decode over the last 32 tokens while
    # the forward attends to all 41. The port decodes as the JAX package
    # does, and both differ from their own forward.
    jcfg, tcfg, jp, tp = _pair(GEMMA, scale=8.0, attn_kind="softmax")
    toks = np.random.default_rng(9).integers(0, 256, (1, 41)).astype(np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks[:, :40]), max_len=64)
    jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, 40:]))
    jfull, _ = jtr.forward(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        _, tc = api.prefill(tp, tcfg, torch.from_numpy(toks[:, :40]),
                            max_len=64)
        assert tc.attn.k.shape[2] == 32 and tc.attn.s is None
        tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, 40:]))
        tfull, _ = api.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)
    _close(tfull, jfull)
    gap = np.abs(np.asarray(jl[0, -1]) - np.asarray(jfull[0, -1])).max()
    assert gap > 100 * LOGIT_REL * np.abs(np.asarray(jl)).max()
    np.testing.assert_allclose(
        np.abs(tl[0, -1].numpy() - tfull[0, -1].numpy()).max(), gap,
        rtol=1e-2)


def test_gemma2_lockstep_engine_matches_jax():
    # Left-padded prompts (pad 0 visible, as in the JAX engine), one of
    # them past the 32-row window, greedy; prompt + max_new <= max_len.
    jcfg, tcfg, jp, tp = _pair(GEMMA, scale=8.0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 256, n).astype(np.int32) for n in (37, 12)]
    jeng = jengine.ServingEngine(jcfg, jp, _auto_mesh(), max_len=64)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", max_len=64)
    jouts = jeng.generate([jengine.Request(p, max_new_tokens=10)
                           for p in prompts])
    touts = teng.generate([tengine.Request(p, max_new_tokens=10)
                           for p in prompts])
    for a, b in zip(touts, jouts):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds max_len"):
        teng.generate([tengine.Request(prompts[0], max_new_tokens=40)])


# -- the continuous engine ---------------------------------------------------

CONT = dict(num_slots=2, max_len=64, prefill_chunk=8, macro_ticks=4,
            debug_audit=True)
# gemma2's 70-token prompt is longer than max_len: windowed rings wrap,
# so it is admitted and absorbed chunk by chunk.
CONT_PROMPTS = {GEMMA: (20, 7, 70, 12), MOES[0]: (20, 7, 33, 12)}
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot")


def _requests(mod, lens, max_new=10):
    rng = np.random.default_rng(6)
    return [mod.Request(rng.integers(3, 256, n).astype(np.int32),
                        max_new_tokens=max_new, arrival_time=2.0 * i)
            for i, n in enumerate(lens)]


def _min_gap(tcfg, tp, prompt, stream, chunk):
    """The least top-2 logit gap along ``stream``, the port alone,
    teacher-forced: the prompt absorbed in the engine's chunks (an MoE
    layer's capacity is per call), then decode steps."""
    gaps = []
    with torch.inference_mode():
        cache = api.init_cache(tcfg, 1, CONT["max_len"], device="cpu")
        for o in range(0, len(prompt), chunk):
            logits, cache = api.prefill_chunk(
                tcfg, tp, cache, torch.from_numpy(prompt[None, o:o + chunk]))
        for tok in stream:
            top2 = torch.topk(logits[0, -1], 2).values
            gaps.append(float(top2[0] - top2[1]))
            logits, cache = api.decode_step(
                tp, tcfg, cache, torch.tensor([[int(tok)]],
                                              dtype=torch.int32))
    return min(gaps)


@pytest.fixture(scope="module", params=sorted(CONT_PROMPTS))
def cont_runs(request):
    name = request.param
    jcfg, tcfg, jp, tp = _pair(name, scale=8.0)
    lens = CONT_PROMPTS[name]
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, _auto_mesh(), serving=JServingConfig(**CONT))
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**CONT), device="cpu")
    jres = (*jeng.run(_requests(jengine, lens)), jeng)
    tres = (*teng.run(_requests(tengine, lens)), teng)
    return tcfg, tp, lens, jres, tres


def test_continuous_trace_matches_jax(cont_runs):
    tcfg, tp, lens, (jouts, js, jeng), (touts, ts, teng) = cont_runs
    for rid, req in enumerate(_requests(tengine, lens)):
        gap = _min_gap(tcfg, tp, req.prompt, jouts[rid],
                       CONT["prefill_chunk"])
        assert gap > TIE_GAP, f"near-tie in rid {rid} ({gap:.2e})"
    assert set(touts) == set(jouts)
    for rid in jouts:
        np.testing.assert_array_equal(touts[rid], jouts[rid], f"rid {rid}")
        for k in STAT_KEYS:
            assert (getattr(teng.metrics.per_request[rid], k)
                    == getattr(jeng.metrics.per_request[rid], k)), (rid, k)
    assert set(ts) == set(js)
    for k in set(js) - WALL_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert len({int(t) for o in touts.values() for t in o}) > 5
    assert ts["requests_completed"] == len(lens)


# -- gemma2's prefix cache and checkpoints across both packages --------------

CRASH = (10, 16)
RESTORE = dict(num_slots=2, max_len=16, prefill_chunk=4, macro_ticks=4,
               checkpoint_every_ticks=6, prefix_cache_bytes=1 << 22,
               debug_audit=True)


def _restore_trace(mod):
    """Three prompts sharing a 4-token system prompt (one chunk, so the
    prefix cache hits); 9 + 12 tokens wrap gemma2's 16-row rings."""
    rng = np.random.default_rng(7)
    shared = rng.integers(3, 256, 4)
    return [mod.Request(np.concatenate([shared, rng.integers(3, 256, 5)])
                        .astype(np.int32), max_new_tokens=12,
                        arrival_time=float(i)) for i in range(3)]


@pytest.fixture(scope="module")
def gemma_dirs(tmp_path_factory):
    jcfg, tcfg, jp, tp = _pair(GEMMA, scale=8.0)
    mesh = _auto_mesh()
    sv = JServingConfig(**RESTORE)
    whole = jengine.ContinuousServingEngine(jcfg, jp, mesh, serving=sv)
    streams = whole.run(_restore_trace(jengine))[0]
    d = str(tmp_path_factory.mktemp("jax_crashed"))
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, mesh, serving=sv,
        journal=jjournal.Journal(os.path.join(d, jjournal.JOURNAL_NAME)),
        fault_injector=jfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(jfaults.EngineCrash):
        jeng.run(_restore_trace(jengine))
    return jcfg, tcfg, jp, tp, mesh, streams, d


def _same(outs, base):
    assert set(outs) == set(base)
    for rid in base:
        np.testing.assert_array_equal(outs[rid], base[rid], f"rid {rid}")


def test_gemma2_port_restores_a_jax_written_directory(gemma_dirs):
    jcfg, tcfg, jp, tp, mesh, streams, d = gemma_dirs
    for rid, req in enumerate(_restore_trace(tengine)):
        gap = _min_gap(tcfg, tp, req.prompt, streams[rid],
                       RESTORE["prefill_chunk"])
        assert gap > TIE_GAP, f"near-tie in rid {rid} ({gap:.2e})"
    eng = tengine.ContinuousServingEngine.restore(
        d, tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu")
    assert eng.recovery["checkpoint_used"] and len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, streams)
    assert s["tokens_replayed"] > 0


def test_gemma2_jax_restores_a_port_written_directory(gemma_dirs, tmp_path):
    jcfg, tcfg, jp, tp, mesh, streams, _ = gemma_dirs
    d = str(tmp_path)
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**RESTORE), device="cpu",
        journal=tjournal.Journal(os.path.join(d, tjournal.JOURNAL_NAME)),
        fault_injector=tfaults.FaultInjector(seed=3, crash_window=CRASH))
    with pytest.raises(tfaults.EngineCrash):
        teng.run(_restore_trace(tengine))
    eng = jengine.ContinuousServingEngine.restore(
        d, jcfg, jp, mesh, serving=JServingConfig(**RESTORE))
    rec = eng.recovery
    assert rec["checkpoint_used"] and rec["resident_resumed"] >= 1
    assert len(eng.prefix_cache) > 0
    outs, s = eng.run()
    _same(outs, streams)
    assert s["tokens_replayed"] > 0


# -- an MoE verifier's speculative engine ------------------------------------

SPEC = dict(num_slots=2, max_len=128, prefill_chunk=16, macro_ticks=4,
            debug_audit=True, speculative=True, spec_gamma=2)


def test_moe_speculative_engine_matches_jax():
    # phi3.5-moe under softmax verifies the drafts of its SLAY twin (the
    # JAX tree after its ensure_draft_params, so both drafts are one);
    # each verify chunk of gamma + 1 = 3 tokens routes with its own
    # capacity (1 per expert here), as the reference's does, so the
    # streams are the JAX engine's, not plain decoding's. Greedy: streams,
    # per-request stats and every deterministic counter.
    name = MOES[0]
    jcfg = jax_smoke_config(name, dtype="float32", attn_kind="softmax")
    tcfg = configs.get_smoke_config(name, dtype="float32",
                                    attn_kind="softmax")
    tree = jax.device_get(japi.ensure_draft_params(
        japi.draft_config(jcfg), jtr.init_params(jcfg,
                                                 jax.random.PRNGKey(0))))
    tree["embed"] = tree["embed"] / 8.0
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    lens = (12, 5, 30, 9)
    jeng = jengine.ContinuousServingEngine(
        jcfg, jp, _auto_mesh(), serving=JServingConfig(**SPEC))
    jouts, js = jeng.run(_requests(jengine, lens, max_new=16))
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**SPEC), device="cpu")
    touts, ts = teng.run(_requests(tengine, lens, max_new=16))
    _same(touts, jouts)
    for rid in jouts:
        for k in STAT_KEYS:
            assert (getattr(teng.metrics.per_request[rid], k)
                    == getattr(jeng.metrics.per_request[rid], k)), (rid, k)
    for k in set(js) - WALL_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert ts["draft_tokens_proposed"] > 0
