"""AdamW with warmup+cosine schedule and global-norm clipping.

Functional over the parameter dict, as ``repro.optim.adamw``: every
function returns new tensors and leaves its inputs as they are, except
``adamw_update(donate=True)``, which writes the step into the parameter
and moment tensors it is given, as the JAX package's jitted train step
donates them (``repro/train/loop.py:142``). Moments
are fp32 by default or bf16 (``moment_dtype``); the update runs in fp32 in
the same order of operations as the JAX package, and the new parameters
are cast back to each parameter's dtype.

DTensor parameters (a sharded step, ``train.loop.sharded_train_step``)
get moments with their placements; the global norm is the whole tree's,
and each leaf's update runs on every rank's own shard (the arithmetic is
elementwise, so the shards' updates are the whole update).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4                 # paper App. H
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01       # paper App. H
    warmup_steps: int = 500
    total_steps: int = 10_000
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # float32 | bfloat16


class AdamWState(NamedTuple):
    step: torch.Tensor               # int32 scalar, on the parameters' device
    m: dict
    v: dict


# Elements of a leaf that ``adamw_update(donate=True)`` updates at once.
DONATE_SLICE = 1 << 26


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def adamw_init(params: dict, cfg: AdamWConfig) -> AdamWState:
    dt = _mdtype(cfg)
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=dt)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at ``step`` (int tensor): linear warmup, then cosine
    down to a tenth of ``lr``. fp32, as the JAX package computes it."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """The tree's L2 norm, fp32 (a plain tensor, gathered if sharded)."""
    n = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                       for x in tree_leaves(tree)))
    return n.full_tensor() if isinstance(n, DTensor) else n


def adamw_update(grads: dict, state: AdamWState, params: dict,
                 cfg: AdamWConfig, *, donate: bool = False
                 ) -> tuple[dict, AdamWState, dict]:
    """One step; returns (new_params, new_state, metrics). ``donate=True``
    copies the new parameters and moments into ``params`` and ``state``'s
    tensors and returns those, a slice of at most ``DONATE_SLICE``
    elements (whole rows of the leading axis) at a time, so the step holds
    one copy of them and one slice's fp32 temporaries, not two copies and
    a whole leaf's (the arithmetic is elementwise and the same)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, cfg)
    dt = _mdtype(cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        mh, vh = m32 / c1, v32 / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m32.to(dt), v32.to(dt))

    def upd_in_place(p, g, m, v):
        rows = max(1, DONATE_SLICE // max(p[0].numel(), 1))
        for i in range(0, p.shape[0], rows):
            ps, gs, ms, vs = (t[i:i + rows] for t in (p, g, m, v))
            for dst, src in zip((ps, ms, vs), upd(ps, gs, ms, vs)):
                dst.copy_(src)
        return p, m, v

    fn = upd_in_place if donate else upd

    def leaf(p, g, m, v):
        if not isinstance(p, DTensor):
            return fn(p, g, m, v)
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out = fn(p.to_local(), g.to_local(), m.to_local(), v.to_local())
        if donate:
            return p, m, v
        return tuple(DTensor.from_local(o, p.device_mesh, p.placements,
                                        run_check=False, shape=p.shape,
                                        stride=p.stride()) for o in out)

    out = tree_map(leaf, params, grads, state.m, state.v)
    new_params = tree_map(lambda t: t[0], out)
    new_m = tree_map(lambda t: t[1], out)
    new_v = tree_map(lambda t: t[2], out)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step, new_m, new_v), metrics
