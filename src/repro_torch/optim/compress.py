"""Error-feedback int8 gradient compression, as ``repro.optim.compress``.

Each gradient plus its carried residual is quantized to int8 with one
per-tensor scale, dequantized, and the quantization error is carried to
the next step (Karimireddy et al., 2019), so the bias vanishes over steps:

    cstate = compress.init(grads)
    grads_q, cstate = compress.compress_decompress(grads, cstate)

``torch.round`` and ``jnp.round`` both round half to even, so the result
is bit-identical to the JAX package's on the same fp32 inputs. On
DTensor gradients (a sharded step) the residuals carry the gradients'
placements and the scale is the whole tensor's maximum.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def init(grads: dict) -> dict:
    """Error-feedback residual buffers (fp32, zero)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: dict, ef_state: dict) -> tuple[dict, dict]:
    """Quantize (grad + residual) to int8, dequantize, update residual."""
    def one(g, e):
        x = g.float() + e
        q, scale = _quantize(x)
        deq = q.float() * scale
        return deq.to(g.dtype), x - deq

    out = tree_map(one, grads, ef_state)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
