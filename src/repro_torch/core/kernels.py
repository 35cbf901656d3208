"""Exact (quadratic) attention: softmax, Yat and spherical Yat
(``repro.core.kernels``).

The O(L²) mechanisms the paper measures SLAY against (Table 5's
"Quadratic Attention" block). The JAX package computes them in jnp,
outside any Pallas kernel, so these are plain PyTorch ops with the
reference's arithmetic dtype by dtype: scores and logits in the
activation dtype, masked logits at ``finfo(dtype).min`` (not -inf), the
softmax in fp32 and cast back; the Yat kinds weight masked positions 0
and normalize by their sum plus δ. Constants enter as tensors of the
activation dtype, as jnp's weakly typed scalars do.

Shapes follow the multi-head convention (..., L, H, Dh) for q/k/v.
"""
from __future__ import annotations

import torch

from repro_torch.core.features import normalize


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype: a scalar operand
    rounded to the activation dtype first, as jnp rounds a weak scalar.
    Made by a fill on ``like``'s device, not a copy from the host, so a
    CUDA graph can capture it."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit softcap ``cap * tanh(logits / cap)``; identity at 0."""
    if not cap:
        return logits
    c = const(cap, logits)
    return c * torch.tanh(logits / c)


def masked_softmax(logits: torch.Tensor, mask) -> torch.Tensor:
    """Softmax over the last axis in fp32 of ``logits`` with ``mask``
    False set to ``finfo(dtype).min``, cast back to the logits' dtype."""
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return torch.softmax(logits.float(), dim=-1).to(logits.dtype)


def yat_scores(q: torch.Tensor, k: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """Exact E-product scores (paper Eq. 1): (qᵀk)² / (||q−k||² + eps),
    (..., H, Lq, Lk)."""
    dot = torch.einsum("...qhd,...khd->...hqk", q, k)
    q2 = torch.sum(q * q, dim=-1)                    # (..., L, H)
    k2 = torch.sum(k * k, dim=-1)
    dist2 = (q2.transpose(-1, -2)[..., :, None]
             + k2.transpose(-1, -2)[..., None, :] - 2.0 * dot)
    return dot * dot / (torch.clamp(dist2, min=0.0) + const(eps, dot))


def spherical_yat_scores(q: torch.Tensor, k: torch.Tensor,
                         eps: float = 1e-3) -> torch.Tensor:
    """Spherical E-product scores (paper Eq. 5): x²/(C−2x), x = q̂ᵀk̂."""
    x = torch.einsum("...qhd,...khd->...hqk", normalize(q), normalize(k))
    return x * x / (const(2.0 + eps, x) - 2.0 * x)


def kernel_normalized_attention(scores: torch.Tensor, v: torch.Tensor,
                                causal: bool,
                                delta: float = 1e-6) -> torch.Tensor:
    """Kernel normalization Y_i = Σ_j K_ij v_j / (Σ_j K_ij + δ): scores
    are nonnegative kernel weights (paper Eq. 11 on the exact kernel
    matrix), not a softmax."""
    if causal:
        L = scores.shape[-1]
        mask = torch.ones(L, L, dtype=torch.bool,
                          device=scores.device).tril()
        scores = torch.where(mask, scores, 0.0)
    num = torch.einsum("...hqk,...khd->...qhd", scores, v)
    den = torch.sum(scores, dim=-1).transpose(-1, -2)[..., None]
    return num / (den + const(delta, den))


def windowed_softmax_attention(q, k, v, window: int,
                               logit_softcap: float = 0.0) -> torch.Tensor:
    """Banded causal sliding-window attention in O(L·2w) memory: query
    block i attends to key blocks i-1 and i only. Requires
    ``L % window == 0``."""
    *lead, L, H, dh = q.shape
    w = window
    nb = L // w
    qb = q.reshape(*lead, nb, w, H, dh)
    kb = k.reshape(*lead, nb, w, H, k.shape[-1])
    vb = v.reshape(*lead, nb, w, H, v.shape[-1])

    def prev(x):                                     # block 0 sees zeros
        return torch.cat([torch.zeros_like(x[..., :1, :, :, :]),
                          x[..., :-1, :, :, :]], dim=-4)

    k2 = torch.cat([prev(kb), kb], dim=-3)           # (..., nb, 2w, H, dh)
    v2 = torch.cat([prev(vb), vb], dim=-3)
    logits = torch.einsum("...qhd,...khd->...hqk", qb, k2) / torch.sqrt(
        const(dh, q))
    logits = softcap(logits, logit_softcap)
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None] + w  # absolute within band
    kpos = torch.arange(2 * w, device=dev)[None, :]
    mask = (qpos >= kpos) & (qpos - kpos < w)
    first = torch.arange(nb, device=dev) == 0        # block 0: no prev half
    mask_b = torch.where(first[:, None, None], (mask & (kpos >= w))[None],
                         mask[None])
    probs = masked_softmax(logits, mask_b.reshape(nb, 1, w, 2 * w))
    out = torch.einsum("...hqk,...khd->...qhd", probs, v2)
    return out.reshape(*lead, L, H, v.shape[-1])


def softmax_attention(q, k, v, causal: bool = True,
                      logit_softcap: float = 0.0,
                      window: int = 0) -> torch.Tensor:
    """Scaled dot-product attention with an optional logit softcap and
    sliding window. Causal self-attention with ``L % window == 0`` routes
    to the banded implementation. When ``Lk > L`` the queries are the
    last L positions (a query at row i sits at position i + Lk - L)."""
    Lq, Lk = q.shape[-3], k.shape[-3]
    if window and causal and Lq == Lk and Lq % window == 0 and Lq > window:
        return windowed_softmax_attention(q, k, v, window, logit_softcap)
    return masked_softmax_attention(q, k, v, causal, logit_softcap, window)


def masked_softmax_attention(q, k, v, causal: bool = True,
                             logit_softcap: float = 0.0,
                             window: int = 0) -> torch.Tensor:
    """:func:`softmax_attention`'s masked route: the whole (Lq, Lk) logits
    with the causal and window masks, at any length."""
    Lq, Lk = q.shape[-3], k.shape[-3]
    dh = q.shape[-1]
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) / torch.sqrt(
        const(dh, q))
    logits = softcap(logits, logit_softcap)
    dev = q.device
    qpos = torch.arange(Lq, device=dev)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=dev)[None, :]
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (qpos - kpos < window)
    probs = masked_softmax(logits, mask)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def yat_attention(q, k, v, causal: bool = True, eps: float = 1e-3,
                  spherical: bool = False) -> torch.Tensor:
    """Quadratic Yat attention (exact or spherical), kernel-normalized."""
    fn = spherical_yat_scores if spherical else yat_scores
    return kernel_normalized_attention(fn(q, k, eps), v, causal)
