"""Atomic checkpoints of the port's training state.

The contract of ``repro.checkpoint.store``:

* **Atomic**: write ``<dir>/tmp.<step>``, fsync, then ``os.replace`` it to
  ``step_<n:08d>.ckpt``; a crash mid-write never corrupts the latest
  checkpoint, and only complete files are ever listed.
* **Keep N**: after each save only the newest ``keep`` files remain.
* **Resume-exact**: the data pipeline is step-indexed, so (params,
  optimizer state, step) is the whole job state.
* **Mesh-agnostic**: a leaf is stored whole, with no sharding. A sharded
  tree (DTensor leaves) is gathered on save, every rank taking part, and
  rank 0 writes it; restore places each leaf in the placements the new
  job asks for (``shardings=``, or a DTensor ``tree_like`` leaf's own),
  so a run resumes on another mesh (elastic rescale) or on none.

The file format is the port's own. The JAX package writes msgpack +
zstd, neither of which the port may depend on; here each file is
``torch.save`` of ``{"step": n, "arrays": {key: CPU tensor}}`` with keys
``layers/attn/wq`` and every dtype kept (bf16 included). The port reads
only that format, and the JAX store cannot read it.
"""
from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import tree_items, tree_map_with_path


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` atomically. With DTensor leaves every rank must call
    it: the leaves are gathered whole and rank 0 writes them, the others
    return once the file is in place."""
    items = tree_items(tree)
    sharded = any(isinstance(leaf, DTensor) for _, leaf in items)
    arrays = {key: (leaf.full_tensor() if isinstance(leaf, DTensor)
                    else leaf).detach().to("cpu", copy=True)
              for key, leaf in items}
    final = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    if not sharded or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"tmp.{step}")
        with open(tmp, "wb") as f:
            torch.save({"step": step, "arrays": arrays}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)           # atomic on POSIX
        _gc(ckpt_dir, keep)
    if sharded:
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt"))
    for f in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.ckpt$", f))]
    return max(steps) if steps else None


def restore_checkpoint(path: str, tree_like, *, shardings=None, mesh=None):
    """Restore into the structure of ``tree_like``: every leaf comes back
    with its stored dtype, on the device of the matching leaf. Raises on a
    shape mismatch. ``shardings`` (a tree of DTensor placements over
    ``mesh``, e.g. ``distributed.sharding.logical_to_sharding``'s) places
    each leaf on the new mesh; without it a DTensor leaf of ``tree_like``
    gives its own mesh and placements. Every rank reads the file and keeps
    its own block, so placing needs no communication."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    arrays = payload["arrays"]
    where = dict(tree_items(shardings)) if shardings is not None else {}

    def take(key, leaf):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        if key in where:
            return distribute_tensor(arr.to(mesh.device_type), mesh,
                                     where[key], src_data_rank=None)
        if isinstance(leaf, DTensor):
            return distribute_tensor(arr.to(leaf.device), leaf.device_mesh,
                                     leaf.placements, src_data_rank=None)
        return arr.to(leaf.device)

    return tree_map_with_path(take, tree_like), payload["step"]


def restore_latest(ckpt_dir: str, tree_like, *, shardings=None, mesh=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    return restore_checkpoint(path, tree_like, shardings=shardings,
                              mesh=mesh)
