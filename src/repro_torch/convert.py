"""Move parameters between the JAX package and the port, through numpy.

``params_from_numpy`` takes the JAX parameter pytree with every leaf
turned into a numpy array (``jax.device_get``) and returns the port's
parameter dict: the same nesting and names (``embed``, ``final_norm``,
stacked ``layers.{pre_attn, pre_mlp, attn.{wq,wk,wv,wo}, mlp.{up,down}}``,
``slay.{anchors,omegas}``) as torch tensors. ``params_to_numpy`` goes the
other way. bf16 goes through fp32 both ways: numpy has no bf16 of its own,
and the cast is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf_from_numpy(x, dtype, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind == "f" or str(arr.dtype) == "bfloat16":
        src_bf16 = str(arr.dtype) == "bfloat16"
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        t = t.to(dtype if dtype is not None
                 else torch.bfloat16 if src_bf16 else torch.float32)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(dev)


def params_from_numpy(tree: dict, *, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """numpy parameter tree -> torch parameter dict on ``device``.

    Float leaves keep their dtype (bf16 stays bf16) unless ``dtype`` is
    given; the SLAY projections under ``slay`` always stay fp32.
    """
    dev = resolve_device(device)

    def conv(node, dt):
        if isinstance(node, dict):
            return {k: conv(v, None if k == "slay" else dt)
                    for k, v in node.items()}
        return _leaf_from_numpy(node, dt, dev)

    return conv(tree, dtype)


def params_to_numpy(params: dict) -> dict:
    """torch parameter dict -> numpy tree; bf16 leaves become fp32."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
