"""Rank programs of the port's multi-process CPU tests (gloo ranks).

The tests (``tests/test_torch_distributed.py``,
``tests/test_torch_serving_sharded.py``, ``tests/test_torch_fallback.py``)
call :func:`spawn`, which starts one fresh interpreter per rank running
this file::

    python tests/torch_dist_ranks.py CHECK RANK WORLD DIR

The ranks meet through a ``FileStore`` under ``DIR`` (no port), run
check ``CHECK`` and rank 0 writes its results to ``DIR/CHECK.json``.
Nothing here imports JAX or the JAX package: the tests compute the JAX
reference in their own process and hand it over as ``.npz`` files in
``DIR``. Every rank checks at its end that no JAX module was loaded.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spawn(check: str, world: int, d: Path, *, timeout: float = 300.0,
          env_extra: dict | None = None) -> dict:
    """Run ``check`` on ``world`` gloo ranks; return rank 0's results.
    Every rank is killed when ``timeout`` seconds pass, and the test
    fails with each rank's output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra or {})
    d.mkdir(parents=True, exist_ok=True)
    logs = [open(d / f"{check}.rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, check, str(r),
                               str(world), str(d)], env=env, cwd=ROOT,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        out.append(f"--- rank {r} (exit {p.returncode}) ---\n"
                   f"{f.read()[-4000:]}")
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{check} on {world} ranks failed or timed out "
                             f"after {timeout} s\n" + "\n".join(out))
    return json.loads((d / f"{check}.json").read_text())


# ---------------------------------------------------------------------------
# Rank-side helpers
# ---------------------------------------------------------------------------


def load_tree(path: Path) -> dict:
    """A nested dict of numpy arrays from an ``.npz`` of ``a/b/c`` keys."""
    import numpy as np
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, leaf = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


def _full(x):
    from repro_torch.distributed.sharding import full_tensor
    return full_tensor(x).detach()


def _max_rel(a: dict, b: dict) -> dict:
    """{leaf: largest |a - b| over the largest |b| of the whole tree}."""
    from repro_torch.tree import tree_items
    pairs = [(ka, _full(x).float(), _full(y).float())
             for (ka, x), (kb, y) in zip(tree_items(a), tree_items(b))
             if ka == kb or (_ for _ in ()).throw(AssertionError((ka, kb)))]
    scale = max(float(y.abs().max()) for _, _, y in pairs)
    return {k: float((x - y).abs().max()) / scale for k, x, y in pairs}


class CountCollectives:
    """Counts the functional collectives dispatched while it is active
    (``torch.ops._c10d_functional.*``), by op name."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts: dict[str, int] = {}
        groups: set = set()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                if (func.namespace == "_c10d_functional"
                        and name not in ("wait_tensor",
                                         "_wrap_tensor_autograd")):
                    counts[name] = counts.get(name, 0) + 1
                    groups.add(args[-1])          # the group's name
                return func(*args, **(kwargs or {}))

        self.counts, self.groups = counts, groups
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def check_train(rank: int, world: int, d: Path) -> dict:
    """(a) the sharded train step on (data 2, model 2), plain and with
    compressed gradients; (b) save_collectives against remat=True;
    (d) the elastic checkpoint."""
    import torch

    from repro_torch import convert
    from repro_torch.checkpoint import restore_latest, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim import compress as gcomp
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import loop
    from repro_torch.tree import tree_items, tree_map

    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_smoke_config("slayformer-124m", dtype="float32")
    jp = convert.params_from_numpy(load_tree(d / "params.npz"), device="cpu")
    bz = load_tree(d / "batches.npz")
    batches = [{k: torch.from_numpy(bz[k][s]) for k in ("tokens", "labels")}
               for s in range(bz["tokens"].shape[0])]
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out: dict = {}
    for compress in (False, True):
        tcfg = loop.TrainConfig(microbatches=2, remat=True,
                                compress_grads=compress)
        params = shd.shard_params(mesh, shd.DEFAULT_RULES,
                                  tree_map(torch.clone, jp),
                                  api.param_axes(cfg))
        opt = adamw_init(params, ocfg)
        ef = gcomp.init(params) if compress else torch.zeros(())
        step = loop.sharded_train_step(cfg, ocfg, tcfg, mesh)
        ref = tree_map(torch.clone, jp)
        ropt = adamw_init(ref, ocfg)
        ref_ef = gcomp.init(ref) if compress else torch.zeros(())
        rstep = loop.make_train_step(cfg, ocfg, tcfg)
        losses = []
        for b in batches:
            params, opt, ef, m = step(params, opt, ef, b)
            ref, ropt, ref_ef, _ = rstep(ref, ropt, ref_ef, b)
            losses.append(float(m["loss"]))
        tag = "compress" if compress else "plain"
        out[f"{tag}_losses"] = losses
        out[f"{tag}_param_rel"] = _max_rel(params, ref)
        out[f"{tag}_placements_kept"] = all(
            tuple(p.placements) == tuple(mm.placements)
            for (_, p), (_, mm) in zip(tree_items(params),
                                       tree_items(opt.m)))
    # (b) save_collectives against remat=True: loss, gradients and the
    # all-reduces of the backward.
    params = shd.shard_params(mesh, shd.DEFAULT_RULES,
                              tree_map(torch.clone, jp), api.param_axes(cfg))
    b = batches[0]
    pl = shd.batch_sharding(mesh)
    from torch.distributed.tensor import distribute_tensor
    db = {k: distribute_tensor(x, mesh, pl, src_data_rank=None)
          for k, x in b.items()}
    grads, counts, loss = {}, {}, {}
    for remat in (False, True, "save_collectives"):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        items = tree_items(leaves)
        with shd.activation_sharding(mesh):
            lo, _ = api.loss_fn(leaves, cfg, db, remat=remat)
            with CountCollectives() as c:
                gs = torch.autograd.grad(lo, [t for _, t in items],
                                         allow_unused=True)
        key = str(remat)
        loss[key] = float(_full(lo))
        counts[key] = c.counts
        grads[key] = {k: torch.zeros(()) if g is None else _full(g)
                      for (k, _), g in zip(items, gs)}
    out["remat_losses"] = loss
    out["backward_collectives"] = counts
    out["save_vs_remat_grad_rel"] = max(
        float((grads["save_collectives"][k] - g).abs().max())
        / max(float(g.abs().max()), 1e-30)
        for k, g in grads["True"].items() if g.dim())
    # (d) the elastic checkpoint: save on (2, 2), restore onto (1, 4) and
    # onto no mesh; every leaf bit for bit.
    ck = str(d / "ckpt")
    state = {"params": params, "opt": adamw_init(params, ocfg)}
    save_checkpoint(ck, 7, state)
    mesh_b = make_mesh((1, 4), ("data", "model"))
    axes = api.param_axes(cfg)
    sh = {"params": shd.logical_to_sharding(
        mesh_b, shd.DEFAULT_RULES, api.abstract_params(cfg), axes)}
    like = {"params": api.init_params(cfg, 1, device="cpu")}
    got_b, step_b = restore_latest(ck, like, shardings=sh, mesh=mesh_b)
    got_0, step_0 = restore_latest(ck, like)
    whole = {k: _full(v) for k, v in tree_items(params)}
    out["elastic_steps"] = [step_b, step_0]
    out["elastic_mesh_b_exact"] = all(
        torch.equal(_full(v), whole[k])
        for k, v in tree_items(got_b["params"]))
    out["elastic_no_mesh_exact"] = all(
        torch.equal(v, whole[k]) for k, v in tree_items(got_0["params"]))
    want = dict(tree_items(sh["params"]))
    out["elastic_placements"] = all(
        tuple(v.placements) == want[k]
        for k, v in tree_items(got_b["params"]))
    return out


FAMILIES = ("phi3.5-moe-42b-a6.6b", "gemma2-27b", "hymba-1.5b",
            "mamba2-780m", "whisper-small", "internvl2-76b", "granite-20b")


def check_forward(rank: int, world: int, d: Path) -> dict:
    """(c) each family's sharded forward on (data 2, model 2) against the
    unsharded port: logits' largest error over their largest magnitude,
    and the rule fallbacks that fired (granite's kv_heads)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api

    mesh = make_mesh((2, 2), ("data", "model"))
    out: dict = {}
    for name in FAMILIES:
        cfg = get_smoke_config(name, dtype="float32")
        params = api.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        B, L = 2, 32
        kw = {"tokens": torch.randint(0, cfg.vocab_size, (B, L),
                                      generator=gen)}
        if cfg.family == "encdec":
            kw["frame_embeds"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                             generator=gen)
        if cfg.frontend == "vision":
            kw["patch_embeds"] = torch.randn(B, cfg.num_patches,
                                             cfg.d_model, generator=gen)
        want, _ = api.forward(params, cfg, **kw)
        log: list = []
        axes = api.param_axes(cfg)
        shd.logical_to_sharding(mesh, shd.DEFAULT_RULES, params, axes, log)
        sp = shd.shard_params(mesh, shd.DEFAULT_RULES, params, axes)
        pl = shd.batch_sharding(mesh)
        skw = {k: distribute_tensor(x, mesh, pl, src_data_rank=None)
               for k, x in kw.items()}
        with shd.activation_sharding(mesh):
            got, _ = api.forward(sp, cfg, **skw)
        got = _full(got)
        out[name] = {
            "rel": float((got - want).abs().max())
            / float(want.abs().max()),
            "fallbacks": sorted({f"{a}:{n}:{m}" for a, n, m in log})}
    return out


def fallback_configs() -> dict:
    """Smoke configs, fp32, whose heads do not all divide a model axis of
    2: granite's one kv head (kv heads replicated while q heads shard),
    three q and kv heads (both replicated), three SSD heads in hymba's
    layers (``ssm._gated_out``'s whole-y projection); and, as a control
    with no fallback, slayformer under softmax. The softmax cases train
    only: granite's ring, whose one kv head does not divide the model
    axis, is split over its rows by ``cache_sharding``, which
    ``_ring_write`` refuses; the control is there for its gradients."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    return {
        "granite_kv1": get_smoke_config("granite-20b", dtype="float32"),
        "granite_kv1_softmax": get_smoke_config(
            "granite-20b", dtype="float32", attn_kind="softmax"),
        "heads3": dataclasses.replace(
            get_smoke_config("slayformer-124m", dtype="float32"),
            num_heads=3, num_kv_heads=3, head_dim=16),
        "hymba_ssd3": dataclasses.replace(
            get_smoke_config("hymba-1.5b", dtype="float32"),
            ssm_expand=3, ssm_head_dim=64),
        "control_softmax": get_smoke_config(
            "slayformer-124m", dtype="float32", attn_kind="softmax"),
    }


def _leaf_rel(a: dict, b: dict) -> dict:
    """{leaf: largest |a - b| over that leaf's largest |b|}."""
    from repro_torch.tree import tree_items
    want = dict(tree_items(b))
    out = {}
    for k, x in tree_items(a):
        x, y = _full(x).float(), _full(want[k]).float()
        out[k] = float((x - y).abs().max()) / max(float(y.abs().max()),
                                                  1e-30)
    return out


def check_fallback(rank: int, world: int, d: Path) -> dict:
    """Sharded gradients and decode where heads fall back to replicated,
    on (data 2, model 2), against the unsharded port: the loss and every
    gradient of ``api.loss_fn`` (with remat), two steps of
    ``sharded_train_step`` (microbatches 2, remat), and a prefill then
    three decode steps with the cache in ``cache_sharding``'s placements
    (granite: the (S, z) state replicated while q heads shard)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import loop
    from repro_torch.tree import tree_items, tree_map

    mesh = make_mesh((2, 2), ("data", "model"))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tcfg = loop.TrainConfig(microbatches=2, remat=True)
    pl = shd.batch_sharding(mesh)
    out: dict = {}
    for name, cfg in fallback_configs().items():
        params = api.init_params(cfg, 0, device="cpu")
        axes = api.param_axes(cfg)
        log: list = []
        shd.logical_to_sharding(mesh, shd.DEFAULT_RULES, params, axes, log)
        gen = torch.Generator().manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (2, 4, 17), generator=gen)
        batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
        rec: dict = {"fallbacks": sorted({f"{a}:{n}:{m}"
                                          for a, n, m in log})}
        # The loss and every gradient, remat=True.
        b = batches[0]
        ref = tree_map(lambda p: p.detach().requires_grad_(True), params)
        lo, _ = api.loss_fn(ref, cfg, b, remat=True)
        items = tree_items(ref)
        want = torch.autograd.grad(lo, [t for _, t in items],
                                   allow_unused=True)
        sp = shd.shard_params(mesh, shd.DEFAULT_RULES,
                              tree_map(torch.clone, params), axes)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), sp)
        db = {k: distribute_tensor(x, mesh, pl, src_data_rank=None)
              for k, x in b.items()}
        with shd.activation_sharding(mesh):
            slo, _ = api.loss_fn(leaves, cfg, db, remat=True)
            got = torch.autograd.grad(
                slo, [t for _, t in tree_items(leaves)], allow_unused=True)
        rec["loss"] = [float(_full(slo)), float(lo.detach())]
        zero = torch.zeros(())
        rec["grad_rel"] = _leaf_rel(
            {k: zero if g is None else g
             for (k, _), g in zip(items, got)},
            {k: zero if g is None else g
             for (k, _), g in zip(items, want)})
        # Two steps of the sharded train step.
        step = loop.sharded_train_step(cfg, ocfg, tcfg, mesh)
        rstep = loop.make_train_step(cfg, ocfg, tcfg)
        sp = shd.shard_params(mesh, shd.DEFAULT_RULES,
                              tree_map(torch.clone, params), axes)
        ref = tree_map(torch.clone, params)
        so, ro = adamw_init(sp, ocfg), adamw_init(ref, ocfg)
        ef, ref_ef = torch.zeros(()), torch.zeros(())
        losses = []
        for bb in batches[:2]:
            sp, so, ef, m = step(sp, so, ef, bb)
            ref, ro, ref_ef, rm = rstep(ref, ro, ref_ef, bb)
            losses.append([float(m["loss"]), float(rm["loss"])])
        rec["step_losses"] = losses
        rec["step_param_rel"] = max(_max_rel(sp, ref).values())
        out[name] = rec
        if cfg.attn_kind == "softmax":
            continue
        # A prefill, then three decode steps.
        prompt = toks[0, :, :12]
        with torch.no_grad():
            rl, rc = api.prefill(params, cfg, prompt, max_len=32)
            sp = shd.shard_params(mesh, shd.DEFAULT_RULES, params, axes)
            with shd.activation_sharding(mesh):
                sl, sc = api.prefill(sp, cfg, distribute_tensor(
                    prompt, mesh, pl, src_data_rank=None), max_len=32)
            steps = [float((_full(sl) - rl).abs().max())
                     / float(rl.abs().max())]
            tok = rl[:, -1].argmax(-1, keepdim=True)
            for _ in range(3):
                rl, rc = api.decode_step(params, cfg, rc, tok)
                with shd.activation_sharding(mesh):
                    sl, sc = api.decode_step(sp, cfg, sc, distribute_tensor(
                        tok, mesh, pl, src_data_rank=None))
                steps.append(float((_full(sl) - rl).abs().max())
                             / float(rl.abs().max()))
                tok = rl.reshape(rl.shape[0], -1).argmax(-1, keepdim=True)
        rec["decode_rel"] = steps
        rec["cache_rel"] = max(_leaf_rel(sc, rc).values())
        rec["state_placements"] = {
            k: str(tuple(x.placements)) for k, x in tree_items(sc)
            if x.dim() >= 4}
    return out


def serving_trace(cfg, n: int = 8, *, burst: bool = False, seed: int = 0,
                  budget: tuple = (5, 10)):
    """A seeded request trace: prompts of 4-12 tokens, budgets drawn from
    [lo, hi), arrivals every 2 ticks (all at tick 0 with ``burst``)."""
    import numpy as np

    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(3, cfg.vocab_size,
                                 size=int(rng.integers(4, 13))
                                 ).astype(np.int32),
                    max_new_tokens=int(rng.integers(*budget)),
                    arrival_time=0.0 if burst else float(2 * i))
            for i in range(n)]


def _serve(cfg, params, sv, mesh, reqs):
    """(streams, summary, engine) of one continuous-engine run."""
    from repro_torch.serving.engine import ContinuousServingEngine
    eng = ContinuousServingEngine(cfg, params, serving=sv, device="cpu",
                                  mesh=mesh)
    outs, summary = eng.run(reqs)
    return {r: o.tolist() for r, o in outs.items()}, summary, eng


def _smoke(attn_kind="slay", device="cpu"):
    """The smoke slayformer, fp32, embedding divided by 8 so that greedy
    streams vary."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    cfg = get_smoke_config("slayformer-124m", dtype="float32",
                           attn_kind=attn_kind)
    params = api.init_params(cfg, 0, device=device)
    params["embed"] = params["embed"] / 8
    return cfg, params


def check_serving(rank: int, world: int, d: Path) -> dict:
    """DESIGN.md §8 on 4 gloo ranks: a slot-sharded continuous engine
    against the unsharded one on the same trace."""
    import dataclasses

    from repro_torch.configs.base import ServingConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import ContinuousServingEngine

    mesh = make_mesh((4, 1), ("data", "model"))
    out: dict = {}
    base = ServingConfig(num_slots=4, max_len=64, prefill_chunk=8)
    cases = [("slay", 0.0, 8), ("slay", 0.0, 1), ("slay", 0.8, 8),
             ("slay", 0.8, 1), ("softmax", 0.0, 8)]
    for kind, temp, K in cases:
        cfg, params = _smoke(kind)
        sv = dataclasses.replace(base, temperature=temp, macro_ticks=K)
        reqs = serving_trace(cfg)
        a, sa, eng = _serve(cfg, params, sv, mesh, reqs)
        b, sb, _ = _serve(cfg, params, sv, None, serving_trace(cfg))
        out[f"{kind}_T{temp}_K{K}"] = {
            "same": a == b, "ticks": [sa["ticks"], sb["ticks"]],
            "dispatches": [sa["decode_dispatches"],
                           sb["decode_dispatches"]],
            "shards": [sa["slot_shards"], sb["slot_shards"]],
            "gathers": eng.metrics.slot_gathers}
    # The other families' pools and speculative decoding, sharded.
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    for case, name, kw, skw in (
            ("mamba2", "mamba2-780m", {}, {}),
            ("whisper", "whisper-small", {}, {}),
            ("softmax_spec", "slayformer-124m", {"attn_kind": "softmax"},
             {"speculative": True, "spec_gamma": 2})):
        cfg = get_smoke_config(name, dtype="float32", **kw)
        params = api.init_params(cfg, 0, device="cpu")
        params["embed"] = params["embed"] / 8
        sv = dataclasses.replace(base, **skw)
        a, sa, eng = _serve(cfg, params, sv, mesh, serving_trace(cfg))
        b, sb, _ = _serve(cfg, params, sv, None, serving_trace(cfg))
        out[case] = {"same": a == b, "ticks": [sa["ticks"], sb["ticks"]],
                     "dispatches": [sa["decode_dispatches"],
                                    sb["decode_dispatches"]],
                     "shards": [sa["slot_shards"], sb["slot_shards"]],
                     "gathers": eng.metrics.slot_gathers}
    # Eviction and reuse: 2 slots a shard, a burst of arrivals.
    cfg, params = _smoke()
    sv = dataclasses.replace(base, num_slots=8)
    burst = dict(burst=True, budget=(60, 80))
    a, sa, eng = _serve(cfg, params, sv, mesh, serving_trace(cfg, 12, **burst))
    b, _, _ = _serve(cfg, params, sv, None, serving_trace(cfg, 12, **burst))
    order = sorted(eng.metrics.per_request.values(),
                   key=lambda st: (st.admitted, st.rid))
    out["evict"] = {"same": a == b,
                    "first_shards": [eng.sched.shard_of(st.slot)
                                     for st in order[:4]],
                    "slots": [st.slot for st in order]}
    # Divisibility fallback: 6 slots over data = 4 replicate.
    sv = dataclasses.replace(base, num_slots=6)
    a, sa, eng = _serve(cfg, params, sv, mesh, serving_trace(cfg))
    b, _, _ = _serve(cfg, params, sv, None, serving_trace(cfg))
    out["fallback"] = {"same": a == b, "shards": sa["slot_shards"],
                       "log": [list(x) for x in eng.slot_shard_fallbacks],
                       "gathers": eng.metrics.slot_gathers}
    # Collectives in a dispatch: none on the slot axes inside it, one
    # all_gather after it.
    cfg, params = _smoke()
    inside: dict = {}
    eng = ContinuousServingEngine(cfg, params, serving=base, device="cpu",
                                  mesh=mesh)
    program = eng._decode

    def counted():
        with CountCollectives() as c, _count_c10d() as calls:
            buf = program()
        for k, v in {**c.counts, **calls}.items():
            inside[k] = inside.get(k, 0) + v
        return buf

    eng._decode = counted
    with _count_c10d() as calls:
        eng.run(serving_trace(cfg))
    out["collectives"] = {"inside": inside, "all": calls,
                          "dispatches": eng.metrics.decode_dispatches}
    # A paged softmax pool over 2 shards (pod 2 x data 2: the pool is
    # replicated over pod).
    mesh2 = make_mesh((2, 2), ("pod", "data"))
    cfg, params = _smoke("softmax")
    sv = dataclasses.replace(base, num_slots=4, page_size=8, num_pages=16)
    a, sa, eng = _serve(cfg, params, sv, mesh2, serving_trace(cfg))
    b, _, _ = _serve(cfg, params, sv, None, serving_trace(cfg))
    eng.page_pool.check()
    out["paged"] = {"same": a == b, "shards": sa["slot_shards"],
                    "pages_peak": sa["pages_peak"],
                    "leaked": sa["final_pages_in_use"],
                    "own_block": _pages_in_own_block(eng)}
    # The prefix cache and a crash restored from its checkpoint, on the
    # sharded pool: each rank journals into its own directory and
    # checkpoints the whole pool.
    cfg, params = _smoke()
    out["durable"] = _durable(rank, d, cfg, params, mesh,
                              dataclasses.replace(base, num_slots=8))
    # Tensor parallelism: (data 2, model 2), parameters and (S, z) heads
    # over model, slots over data; the dispatch's collectives counted.
    mesh3 = make_mesh((2, 2), ("data", "model"))
    cfg, params = _smoke()
    eng = ContinuousServingEngine(cfg, params, serving=base, device="cpu",
                                  mesh=mesh3)
    program, inside, groups = eng._decode, {}, set()

    def counted_tp():
        with CountCollectives() as c:
            buf = program()
        for k, v in c.counts.items():
            inside[k] = inside.get(k, 0) + v
        groups.update(c.groups)
        return buf

    eng._decode = counted_tp
    outs, sa = eng.run(serving_trace(cfg))
    b, sb, _ = _serve(cfg, params, base, None, serving_trace(cfg))
    out["tp"] = {"same": {r: o.tolist() for r, o in outs.items()} == b,
                 "shards": sa["slot_shards"],
                 "dispatches": [sa["decode_dispatches"],
                                sb["decode_dispatches"]],
                 "inside": inside, "ticks": sa["decode_dispatches"]
                 * base.macro_ticks, "layers": cfg.num_layers,
                 "model_group_only": groups == {
                     mesh3.get_group("model").group_name}}
    # The lockstep engine on the same mesh: the unsharded streams.
    from repro_torch.serving.engine import ServingEngine
    reqs = serving_trace(cfg, 4)
    got = ServingEngine(cfg, params, device="cpu", max_len=64,
                        mesh=mesh3).generate(reqs, temperature=0.8)
    want = ServingEngine(cfg, params, device="cpu",
                         max_len=64).generate(reqs, temperature=0.8)
    out["tp"]["lockstep_same"] = [g.tolist() for g in got] == [
        w.tolist() for w in want]
    return out


def _shared_prefix_trace(cfg, n: int = 10):
    """Requests behind one 16-token system prompt (two chunks of 8), the
    last three repeating earlier prompts whole."""
    import numpy as np

    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(7)
    system = rng.integers(3, cfg.vocab_size, 16)
    prompts = [np.concatenate([system, rng.integers(
        3, cfg.vocab_size, int(rng.integers(2, 9)))]).astype(np.int32)
        for _ in range(n - 3)]
    prompts += prompts[:3]
    return [Request(p, max_new_tokens=10, arrival_time=float(2 * i))
            for i, p in enumerate(prompts)]


def _durable(rank, d: Path, cfg, params, mesh, sv) -> dict:
    """Prefix-cached streams and a crash-restore through a checkpoint of
    the sharded pool, against the unsharded engine's streams."""
    import dataclasses

    from repro_torch.serving import faults, journal
    from repro_torch.serving.engine import ContinuousServingEngine
    sv = dataclasses.replace(sv, prefix_cache_bytes=1 << 24)
    cold, _, _ = _serve(cfg, params, sv, None, _shared_prefix_trace(cfg))
    hot, s, _ = _serve(cfg, params, sv, mesh, _shared_prefix_trace(cfg))
    jdir = d / f"journal.rank{rank}"
    jdir.mkdir(exist_ok=True)
    jsv = dataclasses.replace(sv, checkpoint_every_ticks=6)
    eng = ContinuousServingEngine(
        cfg, params, serving=jsv, device="cpu", mesh=mesh,
        fault_injector=faults.FaultInjector(seed=3, crash_window=(20, 20)),
        journal=journal.Journal(str(jdir / journal.JOURNAL_NAME)))
    try:
        eng.run(_shared_prefix_trace(cfg))
        crashed = False
    except faults.EngineCrash:
        crashed = True
    back = ContinuousServingEngine.restore(str(jdir), cfg, params,
                                           serving=jsv, device="cpu",
                                           mesh=mesh)
    outs, _ = back.run()
    return {"prefix_same": hot == cold, "prefix_hits": s["prefix_hits"],
            "crashed": crashed,
            "checkpoint_used": back.recovery["checkpoint_used"],
            "restored_same": {r: o.tolist() for r, o in outs.items()}
            == cold}


def _pages_in_own_block(eng) -> bool:
    """Whether every page each slot was given over the run lay in its
    shard's block (checked live by the allocator's audit; here on the
    final tables too)."""
    pp = eng.page_pool
    per = pp.num_pages // pp.shards
    return all(pp.shard_of(s) == p // per
               for s in range(pp.num_slots) for p in pp.slot_pages(s))


class _count_c10d:
    """Counts the calls of the ``torch.distributed`` collectives made while
    it is active, by name."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "broadcast", "all_to_all_single",
             "reduce", "gather", "scatter", "barrier")

    def __enter__(self):
        import torch.distributed as dist
        self.calls: dict[str, int] = {}
        self._saved = {n: getattr(dist, n) for n in self.NAMES}

        def wrap(name, fn):
            def counted(*a, **k):
                self.calls[name] = self.calls.get(name, 0) + 1
                return fn(*a, **k)
            return counted

        for n, fn in self._saved.items():
            setattr(dist, n, wrap(n, fn))
        return self.calls

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self._saved.items():
            setattr(dist, n, fn)
        return False


def check_serving_nccl(rank: int, world: int, d: Path) -> dict:
    """Two NCCL ranks, one card each: the slot-sharded engine (data = 2,
    graphed) against the unsharded one on the same card."""
    import dataclasses

    from repro_torch.configs.base import ServingConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import ContinuousServingEngine

    mesh = make_mesh((world, 1), ("data", "model"))
    cfg, params = _smoke(device="cuda")
    sv = ServingConfig(num_slots=4, max_len=64, prefill_chunk=8)
    out = {}
    for temp in (0.0, 0.8):
        s = dataclasses.replace(sv, temperature=temp)
        runs = []
        for m in (mesh, None):
            eng = ContinuousServingEngine(cfg, params, serving=s,
                                          device="cuda", mesh=m)
            outs, summary = eng.run(serving_trace(cfg))
            runs.append(({r: o.tolist() for r, o in outs.items()}, summary,
                         eng.graph_cache_entries()))
        out[f"T{temp}"] = {"same": runs[0][0] == runs[1][0],
                           "shards": runs[0][1]["slot_shards"],
                           "graphs": runs[0][2]}
    return out


CHECKS = {"train": check_train, "forward": check_forward,
          "fallback": check_fallback,
          "serving": check_serving, "serving_nccl": check_serving_nccl}


def main() -> None:
    check, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                             int(sys.argv[3]), Path(sys.argv[4]))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(str(d / f"{check}.store"), world)
    backend = "nccl" if check.endswith("_nccl") else "gloo"
    if backend == "nccl":                  # one card a rank
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        out = CHECKS[check](rank, world, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    if rank == 0:
        (d / f"{check}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()
