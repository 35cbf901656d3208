"""Plain oracles for the kernels, routed through ``repro_torch.core``.

Head-major layouts, as the kernels use them:
    q:  (BH, L, d) raw queries (or qf (BH, L, m) features), one row
        per q head
    k:  (BK, L, d) raw keys (or kf (BK, L, m)), one row per kv head
    v:  (BK, L, dv)
with BH = batch·H, BK = batch·Hkv and G = BH // BK: q row i reads kv row
i // G.
"""
from __future__ import annotations

import torch

from repro_torch.core import linear_attention as la
from repro_torch.core.features import SlayFeatureConfig, slay_features


def causal_linear_attention_ref(qf, kf, v, *, chunk_size: int = 256,
                                delta: float = 1e-6) -> torch.Tensor:
    """Oracle for the scan on features: qf (BH, L, m), kf (BK, L, m),
    v (BK, L, dv) -> y (BH, L, dv)."""
    bh, L, m = qf.shape
    bk, _, dv = v.shape
    g = bh // bk
    q = qf.reshape(bk, g, L, m).transpose(1, 2)             # (bk, L, g, m)
    y = la.causal_chunked(q, kf[:, :, None, :], v[:, :, None, :],
                          chunk_size=chunk_size, delta=delta)
    return y.transpose(1, 2).reshape(bh, L, dv)


def slay_features_ref(u, params: dict, cfg: SlayFeatureConfig) -> torch.Tensor:
    """Oracle for the feature map: Ψ(u) over the trailing dim, fp32."""
    return slay_features(u, params, cfg)


def fused_causal_attention_ref(q, k, v, params: dict, cfg: SlayFeatureConfig,
                               *, chunk_size: int = 256,
                               delta: float = 1e-6) -> torch.Tensor:
    """Oracle for the fused forward on raw q/k: -> y (BH, L, dv)."""
    bh, L, _ = q.shape
    bk, _, dv = v.shape
    g = bh // bk
    qf = slay_features(q, params, cfg).reshape(bk, g, L, -1).transpose(1, 2)
    kf = slay_features(k, params, cfg)[:, :, None, :]        # (bk, L, 1, m)
    y = la.causal_chunked(qf, kf, v[:, :, None, :], chunk_size=chunk_size,
                          delta=delta)                       # (bk, L, g, dv)
    return y.transpose(1, 2).reshape(bh, L, dv)


def decode_linear_attention_ref(qf, kf, v, s, z, active=None, *,
                                delta: float = 1e-6):
    """Oracle for the decode step: qf (BH, m), kf (BK, m), v (BK, dv),
    s (BK, m, dv), z (BK, m) -> (y, s', z') as new tensors. ``active``
    (BK,) masks pool rows: y rows zero, state passed through."""
    bh, m = qf.shape
    bk, dv = v.shape
    g = bh // bk
    state = la.LinearState(s[:, None], z[:, None])
    y, new = la.decode_step(qf.reshape(bk, g, m), kf[:, None], v[:, None],
                            state, delta=delta)
    y, s2, z2 = y.reshape(bh, dv), new.s[:, 0], new.z[:, 0]
    if active is not None:
        am = active.bool()
        y = torch.where(am.repeat_interleave(g)[:, None], y, 0.0).to(y.dtype)
        s2 = torch.where(am[:, None, None], s2, s)
        z2 = torch.where(am[:, None], z2, z)
    return y, s2, z2
