"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell's
step on the ``meta`` device over a fake 256- or 512-rank world, and count
what one device would do, the counterpart of ``repro/launch/dryrun.py``.
Nothing is allocated: parameters, optimizer state, decode caches and
batches are ``meta`` DTensors in the sharding rules' placements, and the
SLAY kernels take their meta branches (``kernels._build.record_meta``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--multi-pod] [--attn-kind softmax] \\
        [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out grid.json

The reference lowers each cell on 512 forced host devices and reads one
device's compiled program. Here :func:`run_cell` starts a process group
on the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``)
of 256 or 512 ranks in this process, of which this process is rank 0, and
traces rank 0's program under ``launch.cost.CostCounter``: its local ops,
the collectives of its redistributions and its kernels. A fake group
moves no data, so the dry run needs one process and no card.

Where the port differs from the reference's dry run:

* the reference on forced CPU devices counts its jnp reference path of
  each kernel (``repro/kernels/ops.py:7``); the port counts the kernel the
  card would launch, with ``launch.roofline``'s count of its work;
* a train cell traces one microbatch's forward and backward with the
  optimizer update (``train.loop.sharded_train_step`` at one microbatch),
  then the update alone (``train.loop.apply_grads``), and counts
  ``microbatches x (step - update) + update``, as the reference's cost
  model multiplies a loop body by its trip count; with more than one
  microbatch the step's fp32 gradient accumulator
  (``bytes_per_device["accumulator"]``) is added to ``temp``;
* ``temp`` is the most bytes that the traced step had allocated at once
  (a recomputation under remat included), and ``argument`` the local bytes
  of the parameters, moments, the whole batch and the cache, where the
  reference reads XLA's buffer assignment;
* DTensor on a CPU mesh redistributes a shard to another shard by an
  all-gather and a slice (it warns so), where NCCL would run an
  all-to-all.

Exit code != 0 on any failed cell (a sharding mismatch, a refused kernel
shape, an op DTensor cannot place).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.optim import compress as gcomp
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.loop import (TrainConfig, apply_grads,
                                    sharded_train_step)
from repro_torch.tree import tree_leaves, tree_map


def _cell_is_skipped(cfg: ArchConfig, cell: ShapeCell) -> str | None:
    """The reference's skip rule: no cell is skipped with a linear kind
    (long_500k is what SLAY enables); a full-attention kind skips
    long_500k, except on the ssm and hybrid families."""
    if cell.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        spec_linear = cfg.attn_kind in ("slay", "favor", "cosformer", "elu1")
        if not spec_linear:
            return ("long_500k needs sub-quadratic attention; "
                    f"attn_kind={cfg.attn_kind} is full-attention "
                    "(run with the SLAY backend instead)")
    return None


def default_microbatches(cfg: ArchConfig, cell: ShapeCell, mesh) -> int:
    """The reference's gradient-accumulation factor: one microbatch is
    about 4k tokens per data-parallel shard, and it divides the per-shard
    batch. ``mesh`` is a DeviceMesh or any object whose ``shape`` is an
    {axis: size} mapping (``distributed.sharding.mesh_shape``)."""
    ms = shd.mesh_shape(mesh)
    data_par = ms.get("pod", 1) * ms.get("data", 1)
    per_shard_seqs = max(cell.global_batch // data_par, 1)
    tokens_per_shard = per_shard_seqs * cell.seq_len
    want = max(1, tokens_per_shard // 4096)
    mb = min(want, per_shard_seqs)
    while per_shard_seqs % mb:
        mb -= 1
    return max(mb, 1)


@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks on the ``fake`` backend in this
    process (this process is rank 0), destroyed on exit. Raises if a
    group exists already, or if the backend cannot be imported."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "a torch.distributed process group exists already; the dry run "
            "starts its own fake world (run it in a fresh process)")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs PyTorch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"PyTorch does not have: {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(x: torch.Tensor, mesh, placements) -> DTensor:
    """A ``meta`` DTensor of x's global shape and dtype in ``placements``:
    this rank's block, nothing allocated."""
    local, _ = compute_local_shape_and_global_offset(x.shape, mesh,
                                                     placements)
    return DTensor.from_local(
        torch.empty(local, dtype=x.dtype, device="meta"), mesh, placements,
        run_check=False, shape=x.shape, stride=x.stride())


def _local_bytes(tree) -> int:
    return sum(t.to_local().nbytes if isinstance(t, DTensor) else t.nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _output_bytes(counter: cost.CostCounter, out: tuple) -> int:
    """Bytes of the outputs (a tuple of trees) allocated by the traced
    call (not the donated arguments it wrote in place)."""
    seen, total = set(), 0
    for t in (x for part in out for x in tree_leaves(part)):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if isinstance(t, DTensor) else t
        st = t.untyped_storage()
        if id(st) not in seen and counter.allocated(t):
            seen.add(id(st))
            total += st.nbytes()
    return total


def _batch(specs: dict, mesh, rules, rows: int | None = None) -> dict:
    """The cell's inputs as meta DTensors, batch over (pod, data), cut to
    the first ``rows`` sequences (a microbatch) when given."""
    out = {}
    for k, x in specs.items():
        if rows is not None:
            x = x[:rows]
        pl = shd.batch_sharding(mesh, rules, extra_rank=x.dim() - 1,
                                batch_size=x.shape[0])
        out[k] = _meta(x, mesh, pl)
    return out


def routes(cfg: ArchConfig, mode: str) -> dict:
    """The attention route of each layer kind of ``cfg`` in ``mode``
    (``kernels.ops.attention_route`` on ``meta``, which decides as on the
    card): ``fused``, ``two_dispatch`` or ``torch_psi`` for SLAY; a
    decode step is ``torch_psi`` (the cache's Ψ in PyTorch ops,
    ``models.attention._features``, then K2); any other kind is its name
    (PyTorch ops)."""
    if cfg.family == "ssm":
        return {}
    kinds = {"global": 0, "local": 1}
    present = set(int(k) for k in api.layer_kinds(cfg))
    d = cfg.resolved_head_dim
    out = {}
    for name, flag in kinds.items():
        if flag not in present:
            continue
        spec = cfg.attention_spec(local=bool(flag))
        if spec.kind != "slay":
            out[name] = spec.kind
            continue
        grad = mode == "train"
        if mode == "decode":
            out[name] = ops.TORCH_PSI
        else:
            out[name] = ops.attention_route(
                spec.slay, d, d if spec.fuse_features else None, grad, "meta")
    return out


def trace_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
               rules: shd.ShardingRules = shd.DEFAULT_RULES, *,
               train_cfg: TrainConfig | None = None,
               opt_cfg: AdamWConfig | None = None) -> dict:
    """Trace the cell's step on ``meta`` over ``mesh`` (the counterpart of
    the reference's ``lower_cell``): -> {"totals" (``CostTotals``, train
    scaled to its microbatches), "bytes" (``bytes_per_device``),
    "fallbacks", "scaled"}."""
    axes = api.param_axes(cfg)
    p_abs = api.abstract_params(cfg)
    fallbacks: list = []
    p_sh = shd.logical_to_sharding(mesh, rules, p_abs, axes, fallbacks)
    params = tree_map(lambda x, pl: _meta(x, mesh, pl), p_abs, p_sh)
    specs = configs.input_specs(cfg, cell)
    counter = cost.CostCounter()
    scaled = None
    extra = {}
    if cell.mode == "train":
        train_cfg = train_cfg or TrainConfig(
            microbatches=default_microbatches(cfg, cell, mesh), remat=True,
            compress_grads=False)
        opt_cfg = opt_cfg or AdamWConfig(
            moment_dtype="bfloat16"
            if cfg.param_count_dense > 1e11 else "float32")
        opt_state = adamw_init(params, opt_cfg)
        ef = (gcomp.init(params) if train_cfg.compress_grads
              else torch.zeros((), device="meta"))
        mb = train_cfg.microbatches
        if cell.global_batch % mb:
            raise ValueError(f"{mb} microbatches do not divide the batch "
                             f"of {cell.global_batch}")
        argument = (_local_bytes(params) + _local_bytes(opt_state)
                    + _local_bytes(ef)
                    + _local_bytes(_batch(specs, mesh, rules)))
        batch = _batch(specs, mesh, rules, cell.global_batch // mb)
        step = sharded_train_step(
            cfg, opt_cfg, dataclasses.replace(train_cfg, microbatches=1),
            mesh, rules)
        with counter:
            out = step(params, opt_state, ef, batch)
        update = cost.CostCounter()
        grads = tree_map(torch.zeros_like, params)
        with update, shd.activation_sharding(mesh, rules):
            apply_grads(grads, params, opt_state, ef, opt_cfg, train_cfg,
                        donate=True)
        totals = cost.CostTotals().add(counter.totals, mb)
        totals.add(update.totals, 1 - mb)
        scaled = {"microbatches": mb,
                  "scaled": ["forward", "backward"], "once": ["update"]}
        if mb > 1:
            extra["accumulator"] = 4 * sum(
                t.to_local().numel() for t in tree_leaves(params))
    elif cell.mode == "prefill":
        batch = _batch(specs, mesh, rules)
        argument = _local_bytes(params) + _local_bytes(batch)
        fronts = {k: v for k, v in batch.items() if k != "tokens"}
        with torch.no_grad(), counter, shd.activation_sharding(mesh, rules):
            out = api.prefill(params, cfg, batch["tokens"], **fronts)
        totals = counter.totals
    else:
        c_abs = api.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        c_sh = shd.cache_sharding(mesh, rules, c_abs)
        cache = tree_map(lambda x, pl: _meta(x, mesh, pl), c_abs, c_sh)
        tokens = _batch(specs, mesh, rules)["tokens"]
        argument = (_local_bytes(params) + _local_bytes(cache)
                    + _local_bytes(tokens))
        with torch.no_grad(), counter, shd.activation_sharding(mesh, rules):
            out = api.decode_step(params, cfg, cache, tokens)
        totals = counter.totals
    temp = counter.peak_bytes + extra.get("accumulator", 0)
    return {"totals": totals, "fallbacks": fallbacks, "scaled": scaled,
            "bytes": {"argument": argument,
                      "output": _output_bytes(counter, out),
                      "temp": temp, "peak": argument + temp, **extra}}


def _mesh(mesh_shape, multi_pod: bool):
    if mesh_shape is not None:
        # The same world, another logical split (the reference's mesh
        # experiments), e.g. (32, 8).
        return make_mesh(tuple(mesh_shape),
                         ("pod", "data", "model")[-len(mesh_shape):])
    return make_production_mesh(multi_pod=multi_pod)


def run_cell(arch: str, shape: str | ShapeCell, *, multi_pod: bool = False,
             attn_kind: str | None = None,
             rules: shd.ShardingRules = shd.DEFAULT_RULES,
             train_cfg: TrainConfig | None = None,
             opt_cfg: AdamWConfig | None = None,
             mesh_shape: tuple[int, ...] | None = None,
             world_size: int | None = None, verbose: bool = True,
             **cfg_overrides) -> dict:
    """One cell's record, the reference's keys with ``trace_s`` for its
    ``compile_s``, plus ``kernels`` ({name: launches, flops, bytes}),
    ``routes``, ``fits`` (peak within ``roofline.HBM_PER_CARD``),
    ``eager_bytes``, ``scaled`` and ``world``. The world has 512 ranks
    with ``multi_pod``, else 256, or ``world_size``; ``mesh_shape`` splits
    it another way. ``shape`` is a cell's name or a ``ShapeCell``."""
    cell = shape if isinstance(shape, ShapeCell) else configs.get_cell(shape)
    overrides = dict(cfg_overrides)
    if attn_kind:
        overrides["attn_kind"] = attn_kind
    cfg = configs.get_config(arch, **overrides)
    world = world_size or (512 if multi_pod else 256)
    record: dict = {"arch": arch, "shape": cell.name,
                    "mesh": ("x".join(map(str, mesh_shape)) if mesh_shape
                             else ("2x16x16" if multi_pod else "16x16")),
                    "attn_kind": cfg.attn_kind, "mode": cell.mode,
                    "world": world}
    skip = _cell_is_skipped(cfg, cell)
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        return record
    t0 = time.monotonic()
    try:
        with fake_world(world):
            mesh = _mesh(mesh_shape, multi_pod)
            chips = math.prod(mesh.shape)
            traced = trace_cell(cfg, cell, mesh, rules, train_cfg=train_cfg,
                                opt_cfg=opt_cfg)
            record["routes"] = routes(cfg, cell.mode)
    except Exception as e:  # noqa: BLE001 — report per-cell failures
        record["status"] = "FAILED"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=8)
        return record
    t_trace = time.monotonic() - t0
    totals, bpd = traced["totals"], traced["bytes"]
    roof = rl.from_counts(totals, chips, rl.model_flops_for(cfg, cell))
    top_dots = sorted(totals.dot_flops_by_meta.items(),
                      key=lambda kv: -kv[1])[:10]
    record.update({
        "status": "ok",
        "trace_s": round(t_trace, 1),
        "bytes_per_device": bpd,
        "collectives": roof.coll_by_kind,
        "sharding_fallbacks": [f"{log}:{dim}!%{ax}" for log, dim, ax
                               in traced["fallbacks"]][:20],
        "roofline": roof.report(),
        "top_dot_flops": [{"op": k, "flops": v} for k, v in top_dots],
        "kernels": totals.kernels,
        "eager_bytes": totals.eager_bytes,
        "scaled": traced["scaled"],
        "fits": bpd["peak"] <= rl.HBM_PER_CARD,
    })
    if verbose:
        print(f"[{record['mesh']}] {arch} x {cell.name}: OK "
              f"trace={t_trace:.0f}s "
              f"args={bpd['argument'] / 2**30:.2f}GiB "
              f"temp={bpd['temp'] / 2**30:.2f}GiB "
              f"fits={record['fits']} dom={roof.dominant} "
              f"t=({roof.t_compute:.2e},{roof.t_memory:.2e},"
              f"{roof.t_collective:.2e})s "
              f"roofline_frac={roof.roofline_fraction:.2f}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    choices=list(configs.ALL_ARCHS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=[c.name for c in configs.SHAPE_CELLS] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="full assigned grid (10 archs x 4 shapes)")
    ap.add_argument("--attn-kind", default=None)
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else \
        [c.name for c in configs.SHAPE_CELLS]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    records = []
    failed = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, multi_pod=mp, attn_kind=args.attn_kind)
        records.append(rec)
        if rec["status"] == "FAILED":
            failed += 1
            print(f"[{rec['mesh']}] {a} x {s}: FAILED — {rec['error']}",
                  file=sys.stderr)
        elif rec["status"] == "skipped":
            print(f"[{rec['mesh']}] {a} x {s}: skipped — {rec['reason']}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    print(f"\n{len(records) - failed}/{len(records)} cells passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
