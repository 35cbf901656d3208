"""Linear-time attention contractions (paper Eq. 11 and Algorithm 1).

Given features Ψ(Q) (..., L, H, m), Ψ(K) (..., L, Hkv, m) and values
V (..., L, Hkv, dv) — GQA with H = Hkv·G, each kv head shared by a group
of G query heads *without* materialising the repeat —

    Y = Ψ(Q) (Ψ(K)ᵀ V) / (Ψ(Q) (Ψ(K)ᵀ 1) + δ)

* causal: chunked form — intra-chunk causal quadratic on features plus
  the inter-chunk running (S, z) state, O(m·dv) carry;
* decode: O(m·dv) per token with persistent (S, z) state.

All accumulation is fp32 whatever the input dtype. This module is the
plain oracle the port's kernels are held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class LinearState(NamedTuple):
    """Running linear-attention state: S = ΣΨ(k)ᵀv, z = ΣΨ(k)."""

    s: torch.Tensor  # (..., Hkv, m, dv) fp32
    z: torch.Tensor  # (..., Hkv, m)     fp32


def _group(qf: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(..., L, H, m) -> (..., L, Hkv, G, m)."""
    *lead, L, H, m = qf.shape
    if H % num_kv:
        raise ValueError(f"q heads {H} not divisible by kv heads {num_kv}")
    return qf.reshape(*lead, L, num_kv, H // num_kv, m)


def causal_chunked(qf, kf, v, chunk_size: int = 256, delta: float = 1e-6,
                   init_state: LinearState | None = None,
                   return_state: bool = False):
    """Causal linear attention via chunked prefix state.

    qf (..., L, H, m), kf (..., L, Hkv, m), v (..., L, Hkv, dv). L is
    zero-padded to a chunk multiple (zero features add nothing to the
    state; padded query rows are sliced away). ``init_state`` seeds the
    (S, z) carry (chunked prefill continuation); ``return_state`` also
    returns the post-sequence :class:`LinearState`. The chunk size is only
    an order of evaluation: any chunk gives the same result up to rounding.
    """
    *lead, L, H, m = qf.shape
    num_kv, dv = kf.shape[-2], v.shape[-1]
    pad = (-L) % chunk_size
    if pad:
        qf, kf, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qf, kf, v))
    T = chunk_size
    qg = _group(qf, num_kv).float()          # (..., Lp, Hkv, G, m)
    kc, vc = kf.float(), v.float()
    dev = qf.device
    if init_state is not None:
        s = init_state.s.float().expand(*lead, num_kv, m, dv)
        z = init_state.z.float().expand(*lead, num_kv, m)
    else:
        s = torch.zeros(*lead, num_kv, m, dv, device=dev)
        z = torch.zeros(*lead, num_kv, m, device=dev)
    tril = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
    outs = []
    for c in range((L + pad) // T):
        q_c = qg[..., c * T:(c + 1) * T, :, :, :]
        k_c = kc[..., c * T:(c + 1) * T, :, :]
        v_c = vc[..., c * T:(c + 1) * T, :, :]
        # Inter-chunk contribution from the prefix state.
        num = torch.einsum("...tkgm,...kmd->...tkgd", q_c, s)
        den = torch.einsum("...tkgm,...km->...tkg", q_c, z)
        # Intra-chunk causal quadratic on features.
        scores = torch.einsum("...tkgm,...ukm->...kgtu", q_c, k_c)
        scores = torch.where(tril, scores, 0.0)
        num = num + torch.einsum("...kgtu,...ukd->...tkgd", scores, v_c)
        den = den + scores.sum(-1).movedim(-1, -3)
        s = s + torch.einsum("...tkm,...tkd->...kmd", k_c, v_c)
        z = z + k_c.sum(-3)
        outs.append((num / (den[..., None] + delta)).to(v.dtype))
    y = torch.cat(outs, dim=-4).reshape(*lead, L + pad, H, dv)[..., :L, :, :]
    if return_state:
        return y, LinearState(s, z)
    return y


def init_state(lead_shape, num_kv: int, m: int, dv: int, *,
               device: torch.device) -> LinearState:
    return LinearState(
        s=torch.zeros(*lead_shape, num_kv, m, dv, device=device),
        z=torch.zeros(*lead_shape, num_kv, m, device=device),
    )


def prefill_state(kf, v) -> LinearState:
    """Absorb a whole prompt into the decode state (causal prefix total)."""
    s = torch.einsum("...lkm,...lkd->...kmd", kf.float(), v.float())
    return LinearState(s, kf.float().sum(-3))


def decode_step(qf, kf, v, state: LinearState, delta: float = 1e-6):
    """One token: qf (..., H, m), kf (..., Hkv, m), v (..., Hkv, dv).
    Returns (y (..., H, dv) in v's dtype, new LinearState). O(m·dv)."""
    num_kv = kf.shape[-2]
    s = state.s + torch.einsum("...km,...kd->...kmd", kf.float(), v.float())
    z = state.z + kf.float()
    *lead, H, m = qf.shape
    qg = qf.float().reshape(*lead, num_kv, H // num_kv, m)
    num = torch.einsum("...kgm,...kmd->...kgd", qg, s)
    den = torch.einsum("...kgm,...km->...kg", qg, z)
    y = (num / (den[..., None] + delta)).reshape(*lead, H, v.shape[-1])
    return y.to(v.dtype), LinearState(s, z)
