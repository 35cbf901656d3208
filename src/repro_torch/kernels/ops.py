"""Model-layout wrappers around the kernels.

Model code calls these. They translate between the model's
(..., L, H, feat) layout and the kernels' head-major (BH, L, feat) layout
and zero-pad ragged lengths to chunk multiples (zero features add nothing
to the running state, as in ``core.linear_attention``). Kernel or plain
version is chosen by the tensors' device inside the kernel wrappers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import decode_step as _dk
from repro_torch.kernels import feature_map as _fm
from repro_torch.kernels import slay_fused as _fused
from repro_torch.kernels import slay_scan as _scan


def _headmajor_call(kernel_fn, q, k, v, *, chunk_size: int):
    """Run a head-major (BH, L, feat) kernel from the model layout.

    q (..., L, H, dq), k (..., L, Hkv, dk), v (..., L, Hkv, dv)
    -> (..., L, H, dv). Zero-pads ragged L to a chunk multiple and maps q
    heads group-major so q row i reads kv row i // g.
    """
    *lead, L, H, dq = q.shape
    hkv, dk, dv = k.shape[-2], k.shape[-1], v.shape[-1]
    g = H // hkv
    b = 1
    for x in lead:
        b *= x
    pad = (-L) % chunk_size
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    Lp = L + pad
    qh = (q.reshape(b, Lp, hkv, g, dq).permute(0, 2, 3, 1, 4)
          .reshape(b * hkv * g, Lp, dq))
    kh = k.reshape(b, Lp, hkv, dk).transpose(1, 2).reshape(b * hkv, Lp, dk)
    vh = v.reshape(b, Lp, hkv, dv).transpose(1, 2).reshape(b * hkv, Lp, dv)
    yh = kernel_fn(qh.contiguous(), kh.contiguous(), vh.contiguous())
    y = (yh.reshape(b, hkv, g, Lp, dv).permute(0, 3, 1, 2, 4)
         .reshape(*lead, Lp, H, dv))
    return y[..., :L, :, :] if pad else y


def slay_causal_attention(qf: torch.Tensor, kf: torch.Tensor,
                          v: torch.Tensor, *, chunk_size: int = 256,
                          delta: float = 1e-6) -> torch.Tensor:
    """Causal linear attention on precomputed features (the scan of the
    two-dispatch path).

    qf (..., L, H, m), kf (..., L, Hkv, m), v (..., L, Hkv, dv)
    -> (..., L, H, dv). Ragged L is zero-padded (zero features add
    nothing to the running state).
    """
    return _headmajor_call(
        lambda qh, kh, vh: _scan.causal_linear_attention(
            qh, kh, vh, chunk_size=chunk_size, delta=delta),
        qf, kf, v, chunk_size=chunk_size)


def slay_features(u: torch.Tensor, params: dict,
                  cfg: SlayFeatureConfig) -> torch.Tensor:
    """Ψ(u) over the trailing dim through the feature-map kernel (its plain
    twin on the CPU): u (..., d) -> (..., m) in u's dtype.

    The CUDA kernel takes any token count, so nothing is padded; the
    result equals the JAX entry's pad-and-slice.
    """
    *lead, d = u.shape
    psi = _fm.feature_map(u.reshape(-1, d).contiguous(), params["anchors"],
                          params["omegas"], cfg)
    return psi.reshape(*lead, cfg.feature_dim)


def slay_fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         params: dict, cfg: SlayFeatureConfig, *,
                         chunk_size: int = 256,
                         delta: float = 1e-6) -> torch.Tensor:
    """End-to-end SLAY causal attention on **raw** q/k.

    q (..., L, H, d), k (..., L, Hkv, d), v (..., L, Hkv, dv)
    -> (..., L, H, dv). Ψ is computed inside the fused kernel on the card
    (its fp32 plain twin on the CPU); ragged L is zero-padded.
    """
    def run(qh, kh, vh):
        y, _den = _fused.fused_causal_attention(
            qh, kh, vh, params["anchors"], params["omegas"], cfg,
            chunk_size=chunk_size, delta=delta)
        return y

    return _headmajor_call(run, q, k, v, chunk_size=chunk_size)


def decode_linear_step(qf: torch.Tensor, kf: torch.Tensor, v: torch.Tensor,
                       s: torch.Tensor, z: torch.Tensor,
                       active: torch.Tensor | None = None, *,
                       delta: float = 1e-6):
    """One-token decode step from the *model* layout.

    qf (B, H, m), kf (B, Hkv, m), v (B, Hkv, dv), s (B, Hkv, m, dv) fp32,
    z (B, Hkv, m) fp32 -> (y (B, H, dv), s', z'). The whole batch is one
    kernel launch over B·Hkv kv rows; s and z must be contiguous and are
    updated in place. ``active`` (B,) masks continuous-batching pool rows.
    """
    B, H, m = qf.shape
    hkv, dv = kf.shape[-2], v.shape[-1]
    g = H // hkv
    ah = None
    if active is not None:
        ah = (active.to(torch.int32)[:, None].expand(B, hkv)
              .reshape(B * hkv).contiguous())
    y, _s, _z = _dk.decode_linear_attention(
        qf.reshape(B * hkv * g, m).contiguous(),
        kf.reshape(B * hkv, m).contiguous(),
        v.reshape(B * hkv, dv).contiguous(),
        s.view(B * hkv, m, dv), z.view(B * hkv, m), ah, delta=delta)
    return y.reshape(B, H, dv), s, z
