"""The dense decoders phi4-mini-3.8b, granite-20b and qwen3-32b in the port
against the JAX package, on the CPU, at their smoke configs in fp32 (2
layers, d_model 64, head_dim 16; 4 q heads on 2 kv heads, granite's MQA
on 1, so G = 2, 4, 2).

Weights come from the JAX init and cross through numpy
(``repro_torch.convert``); qwen3's qk-norm scales (zeros at init, which
would hide a swapped or dropped norm) are drawn anew with numpy for both
sides. Tolerances: logits to 1e-4 absolute
(about 3e-6 of their scale; fp32 in another summation order through two
layers), the decode state (S, z) to 1e-5, a softmax verifier's ring rows
to 5e-5 of the ring's largest magnitude, the loss to 1e-5 relative and
gradients to 1e-4 of each leaf's largest magnitude, as
``tests/test_torch_model.py`` and ``test_torch_train.py`` hold
slayformer. granite's continuous engine runs one trace beside the JAX
engine (1x1 mesh with Auto axes, ROADMAP C-4): streams and counters
identical where no near-tie decides (C-2). K2's plain version at
granite's full-width group (G = 48, dv = 128) is held to the Pallas
decode kernel in interpret mode to 1e-5.
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
from repro.kernels import decode_step as jdecode
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro_torch import configs, convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig, ServingConfig
from repro_torch.examples import serve, train_slayformer
from repro_torch.kernels import decode_step as tdecode
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.train import loop as tloop
from repro_torch.tree import tree_items

torch.set_num_threads(1)    # small ops; the suite runs one process per core

ARCHS = ("phi4-mini-3.8b", "granite-20b", "qwen3-32b")
# The configs whose fields and drivers are checked here: the dense
# decoders and the two frontends (tests/test_torch_vision.py and
# tests/test_torch_whisper.py hold their models).
CONFIG_ARCHS = ARCHS + ("internvl2-76b", "whisper-small")
LOGIT_ATOL = 1e-4
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
# Ring rows of a softmax verifier: the second layer's keys and values
# carry the first layer's softmax attention, whose logits (random weights,
# no qk-norm) amplify fp32 rounding to about 1e-5 of the ring's largest
# magnitude (the first layer's rows agree to 2e-7 of it).
RING_REL = 5e-5
TIE_GAP = 1e-5


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or dict(rtol=0.0, atol=LOGIT_ATOL)))


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = jax_smoke_config(request.param, dtype="float32")
    tcfg = configs.get_smoke_config(request.param, dtype="float32")
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    if jcfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            leaf = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = rng.normal(
                0.0, 0.5, leaf.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", CONFIG_ARCHS)
def test_configs_equal_jax(name):
    # Every field the port has equals the JAX package's, full width and
    # smoke; every JAX field the port lacks is at its default there, so
    # no field of the config is dropped.
    port = {f.name for f in dataclasses.fields(ArchConfig)}
    for tcfg, jcfg in ((configs.get_config(name), jax_config(name)),
                       (configs.get_smoke_config(name),
                        jax_smoke_config(name))):
        for f in port:
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        for f in dataclasses.fields(JArchConfig):
            if f.name not in port:
                assert getattr(jcfg, f.name) == f.default, f.name
    assert name in configs.ALL_ARCHS
    cfg = configs.get_config(name)
    # whisper-small's heads are 64 wide, the decoders' 128.
    want_dh = 64 if cfg.family == "encdec" else 128
    assert cfg.resolved_head_dim == want_dh and cfg.attn_kind == "slay"
    assert cfg.num_heads % cfg.num_kv_heads == 0


@pytest.mark.parametrize("name", CONFIG_ARCHS)
def test_drivers_take_the_arch(name, tmp_path, capsys):
    # Both command-line drivers run the config at its smoke size on the
    # CPU; --no-smoke / --preset full name its full-width config. The
    # training driver's synthetic batches carry tokens and labels only,
    # as the JAX driver's: internvl2 trains without its patch prefix, and
    # whisper, which needs frame embeddings, is refused.
    argv = ["--device", "cpu", "--arch", name, "--steps", "2", "--seq",
            "32", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    if name == "whisper-small":
        with pytest.raises(SystemExit):
            train_slayformer.main(argv)
        assert "frame embeddings" in capsys.readouterr().err
    else:
        hist = train_slayformer.main(argv)
        assert len(hist) == 2 and all(np.isfinite([h["loss"]
                                                   for h in hist]))
    outs = serve.main(["--device", "cpu", "--arch", name, "--max-new", "4"])
    assert len(outs) == 4 and all(len(o) == 4 for o in outs)
    assert name in capsys.readouterr().out
    assert serve.build_config(serve.parse_args(
        ["--arch", name, "--no-smoke"])) == configs.get_config(name)
    if name != "whisper-small":
        assert train_slayformer.build_config(train_slayformer.parse_args(
            ["--arch", name, "--preset", "full"])) == configs.get_config(name)


def test_unported_fields_are_refused():
    # Every config of the JAX package is registered (internvl2's vision
    # prefix and whisper's encoder-decoder since A12b closed), and
    # remat="save_collectives" with sharding: without a mesh it is
    # remat=True. A family or frontend the JAX package does not have is
    # refused.
    from repro.configs import ALL_ARCHS as JAX_ARCHS
    assert set(configs.ALL_ARCHS) == set(JAX_ARCHS)
    base = configs.get_smoke_config("phi4-mini-3.8b", dtype="float32")
    params = api.init_params(base, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    assert float(api.loss_fn(params, base, batch,
                             remat="save_collectives")[0]) == float(
        api.loss_fn(params, base, batch, remat=True)[0])
    for kw in (dict(family="retnet"), dict(frontend="video")):
        with pytest.raises(NotImplementedError, match="the port has"):
            api.init_params(dataclasses.replace(base, **kw), device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("whisper-large")


def test_params_convert_and_checkpoint_round_trip(models, tmp_path):
    # The port's init has the JAX tree's leaves and shapes (qwen3's
    # q_norm, k_norm and untied unembed among them); the JAX tree goes
    # to the port and back bit for bit, and through a training
    # checkpoint.
    jcfg, tcfg, jp, tp = models
    want = dict(_flat(_numpy_tree(jax.device_get(jp))))
    mine = dict(_flat(api.init_params(tcfg, 0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in want.items()}
    assert ("layers/attn/q_norm" in want) == jcfg.qk_norm
    assert ("unembed" in want) == (not jcfg.tie_embeddings)
    back = dict(_flat(convert.params_to_numpy(tp)))
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, k)
    save_checkpoint(str(tmp_path), 3, tp)
    zeros = api.init_params(tcfg, 1, device="cpu")
    got, step = restore_checkpoint(
        os.path.join(str(tmp_path), "step_00000003.ckpt"), zeros)
    assert step == 3
    for (k, g), (_, t) in zip(tree_items(got), tree_items(tp)):
        assert torch.equal(g, t), k


def test_forward_logits_match(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 37)).astype(np.int32)
    want, _ = jtr.forward(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        got, _ = api.forward(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 37, 256)
    _close(got, want)


def test_loss_and_grads_match(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (2, 33)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jg = jax.value_and_grad(japi.loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = tloop.value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(_flat(_numpy_tree(jg)))
    got = {k.replace(".", "/"): v.float().numpy()
           for k, v in tree_items(grads)}
    got = {k: v for k, v in got.items() if not k.startswith("slay")}
    want = {k: v for k, v in want.items() if not k.startswith("slay")}
    assert got.keys() == want.keys()
    if jcfg.qk_norm:        # the norms carry gradient
        assert np.abs(want["layers/attn/q_norm"]).max() > 0
    for k, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=GRAD_REL * scale, err_msg=k)


def test_prefill_then_8_decode_steps_match(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(np.int32)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tc = api.prefill(tp, tcfg, torch.from_numpy(toks))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        for _ in range(8):
            jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(tok))
            tl, tc = api.decode_step(tp, tcfg, tc, torch.from_numpy(tok))
            _close(tl, jl)
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
                np.int32)[:, None]
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    _close(tc.attn.z, jc.attn.z, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_prefill_chunk_rows_match(models):
    # A prompt absorbed in chunks of 8 into a fresh cache: every chunk's
    # last-token logits and the final (S, z), against the JAX package.
    jcfg, tcfg, jp, tp = models
    prompt = np.random.default_rng(3).integers(0, 256, 27).astype(np.int32)
    jc = jtr.init_cache(jcfg, 1, 32)
    with torch.inference_mode():
        tc = api.init_cache(tcfg, 1, 32, device="cpu")
        for o in range(0, 27, 8):
            chunk = prompt[None, o:o + 8]
            tl, tc = api.prefill_chunk(tcfg, tp, tc, torch.from_numpy(chunk))
            jl, jc = jtr.prefill_chunk(jp, jcfg, jc, jnp.asarray(chunk))
            _close(tl, jl)
    _close(tc.attn.s, jc.attn.s, **STATE_TOL)
    _close(tc.attn.z, jc.attn.z, **STATE_TOL)
    np.testing.assert_array_equal(tc.pos.numpy(), [27])


def test_verify_chunk_rows_match(models):
    # verify_chunk needs an exact kind's ring: the same weights as a
    # softmax verifier. Two slots prefilled, then 3 candidate rows each,
    # the second slot drained: every live row's logits and the advanced
    # rings against the JAX package.
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, attn_kind="softmax")
    tcfg = dataclasses.replace(tcfg, attn_kind="softmax")
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
    for got, want in ((tpool.attn.k, jnew.attn.k), (tpool.attn.v,
                                                     jnew.attn.v)):
        want = np.asarray(want)
        _close(got, want, rtol=0.0, atol=RING_REL * np.abs(want).max())
    np.testing.assert_array_equal(tpool.pos.numpy(), [12, 14])


# -- granite's continuous engine ---------------------------------------------

CONT = dict(num_slots=2, max_len=64, prefill_chunk=8, macro_ticks=4,
            debug_audit=True)
CONT_PROMPTS = (20, 7, 33, 12)
WALL_KEYS = {"wall_s", "decode_tokens_per_s", "total_tokens_per_s",
             "ttft_s_p50", "ttft_s_p95"}
STAT_KEYS = ("finish_reason", "admitted", "first_token", "finished", "slot")


def _requests(mod):
    rng = np.random.default_rng(6)
    return [mod.Request(rng.integers(3, 256, n).astype(np.int32),
                        max_new_tokens=10, arrival_time=2.0 * i)
            for i, n in enumerate(CONT_PROMPTS)]


@pytest.fixture(scope="module")
def granite_runs():
    """granite's smoke model (embedding / 8, so that greedy streams vary)
    on one trace through both continuous engines, greedy."""
    jcfg = jax_smoke_config("granite-20b", dtype="float32")
    tcfg = configs.get_smoke_config("granite-20b", dtype="float32")
    tree = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"] / 8.0
    mesh = make_host_mesh()
    auto = (jax.sharding.AxisType.Auto,) * len(mesh.axis_names)
    mesh = jax.make_mesh(mesh.devices.shape, mesh.axis_names,
                         axis_types=auto)
    jeng = jengine.ContinuousServingEngine(
        jcfg, jax.tree.map(jnp.asarray, tree), mesh,
        serving=JServingConfig(**CONT))
    tp = convert.params_from_numpy(tree, device="cpu")
    teng = tengine.ContinuousServingEngine(
        tcfg, tp, serving=ServingConfig(**CONT), device="cpu")
    jres = (*jeng.run(_requests(jengine)), jeng)
    tres = (*teng.run(_requests(tengine)), teng)
    return tcfg, tp, jres, tres


def test_granite_continuous_trace_matches_jax(granite_runs):
    tcfg, tp, (jouts, js, jeng), (touts, ts, teng) = granite_runs
    # No near-tie along the JAX streams (the port teacher-forced).
    for rid, req in enumerate(_requests(tengine)):
        with torch.inference_mode():
            logits, cache = api.prefill(tp, tcfg,
                                        torch.from_numpy(req.prompt[None]))
            for tok in jouts[rid]:
                top2 = torch.topk(logits[0, -1], 2).values
                gap = float(top2[0] - top2[1])
                assert gap > TIE_GAP, f"near-tie in rid {rid} ({gap:.2e})"
                logits, cache = api.decode_step(
                    tp, tcfg, cache, torch.tensor([[int(tok)]],
                                                  dtype=torch.int32))
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
    assert ts["requests_completed"] == len(CONT_PROMPTS)
    assert ts["final_occupancy"] == 0


# -- K2's plain version at granite's full-width group ------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_decode_plain_at_g48_dv128_matches_pallas(masked):
    # granite-20b: 48 q heads on one kv head, head dim 128 (dv = 128), m =
    # 384 features; 3 kv rows (slots), the middle one drained if masked.
    bk, g, m, dv = 3, 48, 384, 128
    rng = np.random.default_rng(7)
    qf = rng.uniform(0.0, 1.0, (bk * g, m)).astype(np.float32)
    kf = rng.uniform(0.0, 1.0, (bk, m)).astype(np.float32)
    v = rng.normal(size=(bk, dv)).astype(np.float32)
    s = rng.normal(size=(bk, m, dv)).astype(np.float32)
    z = rng.uniform(0.0, 4.0, (bk, m)).astype(np.float32)
    active = np.array([1, 0, 1], np.int32) if masked else None
    jy, js, jz = jdecode.decode_linear_attention(
        *(jnp.asarray(x) for x in (qf, kf, v, s, z)),
        None if active is None else jnp.asarray(active), interpret=True)
    ts, tz = torch.from_numpy(s.copy()), torch.from_numpy(z.copy())
    ty, ts2, tz2 = tdecode.decode_linear_attention(
        *(torch.from_numpy(x) for x in (qf, kf, v)), ts, tz,
        None if active is None else torch.from_numpy(active))
    assert ts2 is ts and tz2 is tz and ty.shape == (bk * g, dv)
    _close(ty, jy, rtol=1e-5, atol=1e-5)
    _close(ts, js, rtol=1e-6, atol=1e-6)
    _close(tz, jz, rtol=1e-6, atol=1e-6)
    if masked:
        assert torch.equal(ts[1], torch.from_numpy(s)[1])
        assert torch.equal(tz[1], torch.from_numpy(z)[1])
        assert bool((ty.reshape(bk, g, dv)[1] == 0).all())
