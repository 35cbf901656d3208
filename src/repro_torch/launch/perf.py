"""Perf experiments over the dry run: re-trace a cell under a named
experiment configuration and report its roofline terms, the counterpart
of ``repro/launch/perf.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell qwen3-32b:train_4k --exp mb4,seqpar,gradcomp

Each experiment is a (rules, train_cfg, cfg_overrides) transform, the
reference's 21 under its names, on the port's ``ShardingRules`` and
``TrainConfig`` (the same field names; the reference's
``remat_policy="save_collectives"`` is the port's
``remat="save_collectives"``). ``launch.dryrun.run_cell`` traces the cell
and prints the three terms, the dominant one and the roofline fraction.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import types

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.train.loop import TrainConfig


def _mb(n):
    def t(rules, tc, ov):
        return rules, dataclasses.replace(tc, microbatches=n), ov
    return t


def _seqpar(rules, tc, ov):
    """Sequence parallelism: the residual stream's sequence dim over
    model between layers (Megatron-SP)."""
    return dataclasses.replace(rules, act_seq="model"), tc, ov


def _grad_compress(rules, tc, ov):
    return rules, dataclasses.replace(tc, compress_grads=True), ov


def _no_remat(rules, tc, ov):
    return rules, dataclasses.replace(tc, remat=False), ov


def _save_coll(rules, tc, ov):
    return rules, dataclasses.replace(tc, remat="save_collectives"), ov


def _serving_rules(rules, tc, ov):
    """Decode-optimized: weights over model only (no per-step FSDP
    all-gather over data); batch over (pod, data)."""
    return dataclasses.replace(rules, embed=None, act_embed=None), tc, ov


def _fsdp_pod(rules, tc, ov):
    """Multi-pod ZeRO: parameters and optimizer state over the pod axis
    as well (512-way)."""
    return dataclasses.replace(rules, embed=("pod", "data")), tc, ov


def _fsdp_model_too(rules, tc, ov):
    """FSDP over both axes: embed -> (data, model), parameters 256-way
    sharded."""
    return dataclasses.replace(rules, embed=("data", "model"), heads=None,
                               mlp=None, vocab=None,
                               act_heads=None, act_mlp=None), tc, ov


def _chunk(n):
    def t(rules, tc, ov):
        return rules, tc, {**ov, "chunk_size": n}
    return t


def _anchors(p, d):
    def t(rules, tc, ov):
        return rules, tc, {**ov, "slay_anchors": p, "slay_prf": d}
    return t


def _mesh(*shape):
    def t(rules, tc, ov):
        return rules, tc, {**ov, "__mesh_shape__": shape}
    return t


EXPERIMENTS = {
    "baseline": lambda rules, tc, ov: (rules, tc, ov),
    "mb1": _mb(1), "mb2": _mb(2), "mb4": _mb(4), "mb8": _mb(8),
    "seqpar": _seqpar,
    "gradcomp": _grad_compress,
    "no_remat": _no_remat,
    "save_coll": _save_coll,
    "serving_rules": _serving_rules,
    "fsdp2d": _fsdp_model_too,
    "fsdp_pod": _fsdp_pod,
    "chunk128": _chunk(128), "chunk512": _chunk(512),
    "slay_p4d8": _anchors(4, 8), "slay_p16d32": _anchors(16, 32),
    # Logical re-splits of the same 256-rank pod (heads divisibility).
    "mesh32x8": _mesh(32, 8), "mesh64x4": _mesh(64, 4),
    "mesh8x32": _mesh(8, 32), "mesh128x2": _mesh(128, 2),
    "mesh256x1": _mesh(256, 1),
}


def production_shape(multi_pod: bool = False):
    """The production mesh's sizes without a world: a duck mesh for
    ``dryrun.default_microbatches``."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return types.SimpleNamespace(shape=shape)


def run_experiment(arch: str, shape: str, names: list[str], *,
                   multi_pod: bool = False) -> dict:
    """The cell's dry-run record under the experiments ``names``, applied
    in order to the defaults."""
    rules = shd.DEFAULT_RULES
    tc = TrainConfig(
        microbatches=dryrun.default_microbatches(
            configs.get_config(arch), configs.get_cell(shape),
            production_shape(multi_pod)),
        remat=True, compress_grads=False)
    ov: dict = {}
    for n in names:
        rules, tc, ov = EXPERIMENTS[n](rules, tc, ov)
    mesh_shape = ov.pop("__mesh_shape__", None)
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, rules=rules,
                          train_cfg=tc, mesh_shape=mesh_shape, verbose=True,
                          **ov)
    rec["experiments"] = names
    rec["microbatches"] = tc.microbatches
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--exp", default="baseline",
                    help="comma-separated experiment names, applied in "
                         f"order; known: {sorted(EXPERIMENTS)}")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    rec = run_experiment(arch, shape, args.exp.split(","),
                         multi_pod=args.multi_pod)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        existing.append(rec)
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    if rec["status"] != "ok":
        print(rec.get("error"))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
