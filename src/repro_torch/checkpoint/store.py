"""Atomic checkpoints of the port's training state.

The contract of ``repro.checkpoint.store``:

* **Atomic**: write ``<dir>/tmp.<step>``, fsync, then ``os.replace`` it to
  ``step_<n:08d>.ckpt``; a crash mid-write never corrupts the latest
  checkpoint, and only complete files are ever listed.
* **Keep N**: after each save only the newest ``keep`` files remain.
* **Resume-exact**: the data pipeline is step-indexed, so (params,
  optimizer state, step) is the whole job state.

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

from repro_torch.tree import tree_items, tree_map_with_path


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: leaf.detach().to("cpu", copy=True)
              for key, leaf in tree_items(tree)}
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    with open(tmp, "wb") as f:
        torch.save({"step": step, "arrays": arrays}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)           # atomic on POSIX
    _gc(ckpt_dir, keep)
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


def restore_checkpoint(path: str, tree_like):
    """Restore into the structure of ``tree_like``: every leaf comes back
    with its stored dtype, on the device of the matching leaf. Raises on a
    shape mismatch."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    arrays = payload["arrays"]

    def take(key, leaf):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        return arr.to(leaf.device)

    return tree_map_with_path(take, tree_like), payload["step"]


def restore_latest(ckpt_dir: str, tree_like):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    return restore_checkpoint(path, tree_like)
