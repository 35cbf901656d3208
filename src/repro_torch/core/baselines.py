"""Linear-attention baselines the paper compares against (Table 5), as
``repro.core.baselines``:

* FAVOR+ (Performer, ReLU random features),
* ELU+1 linear attention (Katharopoulos et al.),
* cosformer (Qin et al., 2022) position-reweighted ReLU features.

Each produces features for ``core.linear_attention``, so the causal,
non-causal and decode machinery serves all of them. The JAX package runs
them in jnp outside any Pallas kernel, so these are plain PyTorch ops
with its dtypes: favor's features are fp32 whatever the input's dtype
(the JAX code divides by a numpy float64 scalar, a float32 operand with
64-bit floats off), elu1's and cosformer's the input's, and cosformer's
positions are built in the input's dtype (in bf16, 257 rounds to 256).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import linear_attention as la
from repro_torch.core.kernels import const


def favor_init(gen: torch.Generator, head_dim: int, num_features: int = 64,
               *, device: torch.device | str = "cpu") -> dict:
    """Orthogonal-ish Gaussian projection (num_features, head_dim) for the
    FAVOR+ ReLU features, fp32: stacked blocks Q·diag(norms), Q from the QR
    of a Gaussian matrix and norms the row norms of another, as the JAX
    package builds it. Drawn from ``gen`` on the CPU, so its bits differ
    from ``jax.random``'s: a tree converted from the JAX package carries
    the JAX projection."""
    blocks = []
    n = num_features
    while n > 0:
        g = torch.randn(head_dim, head_dim, generator=gen)
        qmat, _ = torch.linalg.qr(g)
        norms = torch.linalg.norm(
            torch.randn(head_dim, head_dim, generator=gen), dim=-1)
        blocks.append(qmat * norms[:, None])
        n -= head_dim
    proj = torch.cat(blocks, dim=0)[:num_features]
    return {"proj": proj.to(device)}


def favor_features(u: torch.Tensor, params: dict) -> torch.Tensor:
    """ReLU random features relu(u projᵀ) / sqrt(m) (paper Table 9: M = 64
    ReLU); the product in u's dtype, the result fp32."""
    proj = params["proj"]
    m = proj.shape[0]
    x = torch.einsum("...d,Dd->...D", u, proj.to(u.dtype))
    return torch.relu(x).float() / float(np.float32(np.sqrt(m)))


def elu1_features(u: torch.Tensor) -> torch.Tensor:
    """φ(x) = elu(x) + 1 (strictly positive), in u's dtype; elu with
    ``expm1`` as ``jax.nn.elu`` computes it."""
    pos = u > 0
    elu = torch.where(pos, u, torch.expm1(torch.where(pos, 0.0, u)))
    return elu + 1.0


def cosformer_features(u: torch.Tensor, seq_axis: int = -3,
                       max_len: int | None = None) -> torch.Tensor:
    """cosformer: [relu(u)·cos, relu(u)·sin] of i·π/(2M) along the
    sequence axis, M = ``max_len`` or the length; doubles the feature
    dim. The cos/sin pair rebuilds the cos(π(i−j)/2M) locality weight
    after the linear-attention product."""
    L = u.shape[seq_axis]
    M = max_len or L
    pos = (torch.arange(L, dtype=u.dtype, device=u.device)
           * const(np.pi / (2 * M), u))
    shape = [1] * u.dim()
    shape[seq_axis] = L
    pos = pos.reshape(shape)
    phi = torch.relu(u)
    return torch.cat([phi * torch.cos(pos), phi * torch.sin(pos)], dim=-1)


def decode_features(kind: str, params: dict | None,
                    u: torch.Tensor) -> torch.Tensor:
    """A baseline's features on the cache paths (``prefill_cache``,
    ``prefill_chunk``, ``decode_step``), as ``_features`` in the JAX
    package's ``models.attention``. cosformer there takes the large-M
    limit (cos ~ 1): [relu(u), 0], never reweighted by position, so half
    of its (S, z) state stays zero (ROADMAP C-8)."""
    if kind == "favor":
        return favor_features(u, params)
    if kind == "elu1":
        return elu1_features(u)
    if kind == "cosformer":
        return torch.cat([torch.relu(u), torch.zeros_like(u)], dim=-1)
    raise ValueError(f"unknown linear baseline {kind!r}")


def linear_baseline_attention(kind: str, params: dict | None, q, k, v, *,
                              causal: bool = True, chunk_size: int = 256,
                              delta: float = 1e-6) -> torch.Tensor:
    """favor | cosformer | elu1 over the shared linear machinery, q
    (..., L, H, Dh), k/v (..., L, Hkv, *). cosformer reweights both sides
    with M = max(Lq, Lk)."""
    if kind == "favor":
        qf, kf = favor_features(q, params), favor_features(k, params)
    elif kind == "elu1":
        qf, kf = elu1_features(q), elu1_features(k)
    elif kind == "cosformer":
        m = max(q.shape[-3], k.shape[-3])
        qf = cosformer_features(q, max_len=m)
        kf = cosformer_features(k, max_len=m)
    else:
        raise ValueError(f"unknown linear baseline {kind!r}")
    if causal:
        return la.causal_chunked(qf, kf, v, chunk_size=chunk_size,
                                 delta=delta)
    return la.noncausal(qf, kf, v, delta=delta)
