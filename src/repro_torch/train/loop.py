"""Training step + fault-tolerant loop, as ``repro.train.loop``.

The step: microbatched gradient accumulation in fp32, optional per-layer
recomputation (``remat``), optional error-feedback int8 gradient
compression, global-norm clipping, AdamW. SLAY attention runs its fused
kernels and their backward (K1, K3, K4) on the card, or with
``fuse_attention_features=False`` the two-dispatch path (feature map,
then scan, and their backward), and the plain versions on the CPU: the
tensors' device chooses, so there is no ``use_pallas`` knob. The exact
kinds (``softmax``, ``yat``, ``yat_spherical``) and the SSM families'
SSD blocks have no kernel: plain autograd of their PyTorch ops on either
device (``remat`` recomputes an SSD block's chunk scan too). A batch's
frontend stand-ins (``patch_embeds`` of a vision config, ``frame_embeds``
of encdec) go to ``api.loss_fn`` with its tokens and labels, as in the
reference's step.

The loop: resume from the latest checkpoint on start, an atomic
checkpoint every ``ckpt_every`` steps and at the end, and a step-time
watchdog that halves the checkpoint cadence when a step takes longer than
``watchdog_factor`` times the median.

Sharded (``Trainer(mesh=...)``, :func:`sharded_train_step`, the
reference's ``jit_train_step``): one process per rank over the caller's
process group; parameters, moments and error-feedback residuals are
DTensors in the rules' placements (``distributed.sharding``), each
microbatch is placed by ``batch_sharding``, and the step runs under
``activation_sharding``, so the model's activation constraints and the
kernels' ``local_map`` apply. Without a mesh the step is the
single-device one.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time

import torch

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import restore_latest, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.optim import compress as gcomp
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)
from repro_torch.tree import tree_items, tree_map, tree_map_with_path

log = logging.getLogger("repro_torch.train")


def resolve_attention_path(cfg: ArchConfig,
                           train_cfg: "TrainConfig") -> ArchConfig:
    """Apply the TrainConfig attention override to the arch config."""
    if train_cfg.fuse_attention_features is None:
        return cfg
    return dataclasses.replace(
        cfg, fuse_attention_features=train_cfg.fuse_attention_features)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # grad-accumulation steps
    # True recomputes each layer whole in the backward; "save_collectives"
    # keeps each layer's tensor-parallel all-reduce outputs (the same as
    # True without a mesh).
    remat: bool | str = True
    # None = respect cfg.fuse_attention_features; True/False force the
    # fused kernels or the two-dispatch feature-map -> scan path.
    fuse_attention_features: bool | None = None
    compress_grads: bool = False     # error-feedback int8
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 200
    watchdog_factor: float = 2.0     # step slower than factor x median -> flag
    keep_ckpts: int = 3


def value_and_grad(params: dict, cfg: ArchConfig, batch: dict, *,
                   remat=False) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``api.loss_fn`` at ``params``. Gradients
    have each parameter's dtype; the SLAY projections, constants of the
    model, get zeros, as ``stop_gradient`` gives them in JAX."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = api.loss_fn(leaves, cfg, batch, remat=remat)
    items = tree_items(leaves)
    grads = torch.autograd.grad(loss, [t for _, t in items], allow_unused=True)
    by_path = {k: torch.zeros_like(t) if g is None else _like(t, g)
               for (k, t), g in zip(items, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map_with_path(lambda k, _t: by_path[k], leaves))


def _like(p, g):
    """A sharded parameter's gradient in the parameter's placements."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def apply_grads(grads, params, opt_state: AdamWState, ef_state,
                opt_cfg: AdamWConfig, train_cfg: TrainConfig, *,
                donate: bool = False):
    """The step after its gradients: the error-feedback compression when
    ``train_cfg`` asks for it, then AdamW. -> (params, opt_state,
    ef_state, the optimizer's metrics). ``launch.dryrun`` counts it apart
    from the microbatches' forward and backward."""
    if train_cfg.compress_grads:
        grads, ef_state = gcomp.compress_decompress(grads, ef_state)
    params, opt_state, opt_metrics = adamw_update(
        grads, opt_state, params, opt_cfg, donate=donate)
    return params, opt_state, ef_state, opt_metrics


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    train_cfg: TrainConfig, *, donate: bool = False,
                    place=None):
    """Returns train_step(params, opt_state, ef_state, batch)
    -> (params, opt_state, ef_state, metrics), with new tensors for the
    parameters and optimizer state, or with ``donate=True`` the given
    ones updated in place (``adamw_update(donate=True)``), as the JAX
    package's jitted step donates them: the step then holds one copy of
    the weights and moments, which a few billion parameters need on one
    card. ``place`` maps each (micro)batch before the loss reads it (the
    sharded step distributes it)."""
    cfg = resolve_attention_path(cfg, train_cfg)
    remat = train_cfg.remat
    place = place or (lambda b: b)

    def compute_grads(params, batch):
        if train_cfg.microbatches <= 1:
            return value_and_grad(params, cfg, place(batch), remat=remat)
        n = train_cfg.microbatches
        micro = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
                 for k, x in batch.items()}
        dev = params["embed"].device
        loss = torch.zeros((), device=dev)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        for i in range(n):
            mb = place({k: x[i] for k, x in micro.items()})
            loss_i, _, grads_i = value_and_grad(params, cfg, mb, remat=remat)
            grads = tree_map(lambda a, g: a + g.float() / n, grads, grads_i)
            loss = loss + loss_i / n
        return loss, {"nll": loss, "moe_aux": torch.zeros((), device=dev)}, grads

    def train_step(params, opt_state: AdamWState, ef_state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        params, opt_state, ef_state, opt_metrics = apply_grads(
            grads, params, opt_state, ef_state, opt_cfg, train_cfg,
            donate=donate)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, ef_state, metrics

    return train_step


def sharded_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                       train_cfg: TrainConfig, mesh,
                       rules: shd.ShardingRules = shd.DEFAULT_RULES, *,
                       donate: bool = True):
    """The step over ``mesh`` (the reference's ``jit_train_step``): takes
    parameters, moments and residuals as DTensors in the rules'
    placements (:func:`repro_torch.distributed.sharding.shard_params`)
    and the same whole batch on every rank, which each microbatch
    distributes by ``batch_sharding`` (no communication: each rank keeps
    its block). The step runs under ``activation_sharding(mesh, rules)``
    and donates the parameters and moments, as the reference's jit
    donates them. Its metrics come back whole (plain scalars)."""
    def place(batch):
        def one(x):
            if isinstance(x, DTensor):
                return x
            pl = shd.batch_sharding(mesh, rules, extra_rank=x.dim() - 1,
                                    batch_size=x.shape[0])
            return distribute_tensor(x.to(mesh.device_type), mesh, pl,
                                     src_data_rank=None)
        return {k: one(x) for k, x in batch.items()}

    base = make_train_step(cfg, opt_cfg, train_cfg, donate=donate,
                           place=place)

    def step(params, opt_state, ef_state, batch):
        with shd.activation_sharding(mesh, rules):
            params, opt_state, ef_state, metrics = base(
                params, opt_state, ef_state, batch)
        return params, opt_state, ef_state, {
            k: shd.full_tensor(v) for k, v in metrics.items()}

    return step


class Trainer:
    """Fault-tolerant loop around the step. The step donates the
    parameters and moments (``make_train_step(donate=True)``), as the JAX
    package's Trainer jits it with ``donate_argnums``. With ``mesh`` (a
    ``DeviceMesh`` of :mod:`repro_torch.launch.mesh`, one process per
    rank) the parameters are sharded by ``rules`` from rank 0's draw and
    the step is :func:`sharded_train_step`; checkpoints stay whole
    tensors, so a run resumes on another mesh."""

    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 train_cfg: TrainConfig, *, seed: int = 0, device="cuda",
                 mesh=None, rules: shd.ShardingRules = shd.DEFAULT_RULES):
        self.cfg, self.opt_cfg, self.train_cfg = cfg, opt_cfg, train_cfg
        self.mesh, self.rules = mesh, rules
        self.params = api.init_params(cfg, seed, device=device)
        if mesh is None:
            self.step_fn = make_train_step(cfg, opt_cfg, train_cfg,
                                           donate=True)
        else:
            self.step_fn = sharded_train_step(cfg, opt_cfg, train_cfg, mesh,
                                              rules)
            self.params = shd.shard_params(mesh, rules, self.params,
                                           api.param_axes(cfg))
        self.opt_state = adamw_init(self.params, opt_cfg)
        self.ef_state = (gcomp.init(self.params) if train_cfg.compress_grads
                         else torch.zeros(()))
        self.step = 0
        self._times: list[float] = []
        self._resume()

    def _resume(self):
        state = {"params": self.params, "opt": self.opt_state}
        restored, step = restore_latest(self.train_cfg.ckpt_dir, state)
        if restored is not None:
            self.params = restored["params"]
            self.opt_state = restored["opt"]
            self.step = step
            log.info("resumed from step %d", step)

    def save(self):
        save_checkpoint(self.train_cfg.ckpt_dir, self.step,
                        {"params": self.params, "opt": self.opt_state},
                        keep=self.train_cfg.keep_ckpts)

    def run(self, batches, num_steps: int, *, log_every: int = 10):
        """batches: iterator of (step, batch). Returns metric history."""
        history = []
        ckpt_every = self.train_cfg.ckpt_every
        for step, batch in batches:
            if step >= num_steps:
                break
            t0 = time.monotonic()
            (self.params, self.opt_state, self.ef_state,
             metrics) = self.step_fn(self.params, self.opt_state,
                                     self.ef_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # syncs
            dt = time.monotonic() - t0
            self._times.append(dt)
            self.step = step + 1
            # Straggler / anomaly watchdog: tighten checkpoint cadence.
            med = sorted(self._times)[len(self._times) // 2]
            if (len(self._times) > 5
                    and dt > self.train_cfg.watchdog_factor * med):
                log.warning("step %d took %.2fs (median %.2fs) — "
                            "tightening checkpoint cadence", step, dt, med)
                ckpt_every = max(ckpt_every // 2, 10)
            if self.step % ckpt_every == 0:
                self.save()
            history.append({"step": self.step, **metrics, "step_time_s": dt})
            if step % log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, metrics["loss"],
                         dt)
        self.save()
        return history
