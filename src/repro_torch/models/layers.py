"""Shared neural-net layers: RMSNorm, RoPE, MLP, embeddings.

Plain functions ``f(params, x, ...) -> y`` on tensors, mirroring
``repro.models.layers``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with fp32 statistics; the scale is applied as (1 + scale)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Half-split RoPE. x (..., L, H, Dh), positions (..., L) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., L, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp(params: dict, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    """Gated: silu(x@gate) * (x@up) @ down. Non-gated (slayformer):
    silu(x@up) @ down — SiLU, not GELU, as the JAX package computes it."""
    up = x @ params["up"]
    if gated:
        up = F.silu(x @ params["gate"]) * up
    else:
        up = F.silu(up)
    return up @ params["down"]


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    logits = x @ table.T
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
