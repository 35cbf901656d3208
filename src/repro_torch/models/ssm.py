"""The Mamba-2 SSD (state-space duality) block, chunk-parallel, in plain
PyTorch ops (``repro.models.ssm``; the reference runs it in jnp, outside
any Pallas kernel, and so does the port).

The SSD recurrence per head (state h in R^{hd x ds}):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T ,   y_t = h_t C_t + D x_t

runs chunk-parallel: within a chunk a masked, decay-weighted attention
on (C, B), across chunks a (nh, hd, ds) fp32 carry. Beside the scan the
block keeps the (W-1, conv_dim) tail of its depthwise causal conv, so a
prompt fed chunk by chunk continues exactly.

Shapes: x (B, L, nh, hd), b/c (B, L, ng, ds) shared by the nh / ng heads
of their group, dt (B, L, nh) after the softplus, a_log (nh,).

dtypes, as the reference's: the chunk conv runs in the activation dtype
(products summed in order of the taps), the decode step's conv in fp32
over the fp32 tail, cast after the SiLU; ``softplus(dt + dt_bias)``,
``a = -exp(a_log)`` and the scan are fp32; the gated RMS norm multiplies
``y * silu(z)`` in the activation dtype, then normalises in fp32 (eps
1e-6, scale ``1 + norm``); the carried tail is fp32.

One change from the reference: the scan masks the intra-chunk log-decay
differences above the diagonal before the exponent
(``exp(where(tri, diff, -inf))``), where the reference takes
``where(tri, exp(diff), 0)``. The values are the same bit for bit; the
reference's gradient is NaN once a chunk spans enough steps for
``exp(diff)`` above the diagonal to overflow (ROADMAP C-10), the port's
stays finite.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import local_einsum
from repro_torch.models.layers import rmsnorm


class SsmState(NamedTuple):
    h: torch.Tensor       # (..., nh, hd, ds) fp32
    conv: torch.Tensor    # (..., W-1, conv_dim) fp32, the conv's inputs


def dims(d_model: int, d_state: int, expand: int = 2, head_dim: int = 64,
         ngroups: int = 1) -> tuple[int, int, int]:
    """(d_inner, nheads, conv_dim) of an SSD block."""
    d_inner = expand * d_model
    return d_inner, d_inner // head_dim, d_inner + 2 * ngroups * d_state


def ssd_shapes(d_model: int, d_state: int, expand: int = 2,
               head_dim: int = 64, ngroups: int = 1,
               conv_width: int = 4) -> dict:
    """name -> (shape, init, scale) of one block's parameters, as
    ``repro.models.ssm.ssd_specs`` (scale None = 1/sqrt(fan-in))."""
    d_inner, nheads, conv_dim = dims(d_model, d_state, expand, head_dim,
                                     ngroups)
    return {
        "in_proj": ((d_model, 2 * d_inner + 2 * ngroups * d_state + nheads),
                    "normal", None),
        "conv_w": ((conv_width, conv_dim), "normal", 0.5),
        "conv_b": ((conv_dim,), "zeros", None),
        "a_log": ((nheads,), "ones", None),
        "dt_bias": ((nheads,), "zeros", None),
        "d_skip": ((nheads,), "ones", None),
        "norm": ((d_inner,), "zeros", None),
        "out_proj": ((d_inner, d_model), "normal", None),
    }


def _split_proj(params, x, d_model, d_state, expand, head_dim, ngroups):
    d_inner, nheads, _ = dims(d_model, d_state, expand, head_dim, ngroups)
    gs = ngroups * d_state
    # Sharded, through ``local_einsum``: where in_proj's columns fell back
    # to whole over model while its rows split over data, DTensor's own
    # matmul splits x's features to meet the rows and returns a partial
    # sum over data, which would reach the conv tail in the cache.
    w = params["in_proj"]
    proj = (local_einsum("...d,dn->...n", x, w) if isinstance(x, DTensor)
            else x @ w)
    z, xs, b, c, dt = torch.split(proj, [d_inner, d_inner, gs, gs, nheads],
                                  dim=-1)
    return z, xs, b, c, dt, d_inner, nheads


def _causal_conv(params, u, w: int, tail=None):
    """Depthwise causal conv of width ``w`` in ``u``'s dtype. u (..., L,
    C) -> (SiLU(conv + bias), the new tail: the last W-1 rows of [tail,
    u]). ``tail`` None is a fresh sequence (zero left context)."""
    L = u.shape[-2]
    if tail is None:
        tail = u.new_zeros(*u.shape[:-2], w - 1, u.shape[-1])
    hist = torch.cat([tail.to(u.dtype), u], dim=-2)
    cw = params["conv_w"]
    out = hist[..., 0:L, :] * cw[0]
    for i in range(1, w):
        out = out + hist[..., i:i + L, :] * cw[i]
    return F.silu(out + params["conv_b"]), hist[..., L:, :]


def _heads(t, g: int, axis: int):
    """Repeat each group ``g`` times along ``axis`` (``jnp.repeat``):
    head h reads group h // g."""
    shape = list(t.shape)
    t = t.unsqueeze(axis + 1)
    ex = list(t.shape)
    ex[axis + 1] = g
    shape[axis] *= g
    return t.expand(ex).reshape(shape)


def ssd_init_state(lead_shape, d_model: int, d_state: int, expand: int = 2,
                   head_dim: int = 64, ngroups: int = 1, conv_width: int = 4,
                   *, device) -> SsmState:
    d_inner, nheads, conv_dim = dims(d_model, d_state, expand, head_dim,
                                     ngroups)
    return SsmState(
        torch.zeros(*lead_shape, nheads, head_dim, d_state, device=device),
        torch.zeros(*lead_shape, conv_width - 1, conv_dim, device=device))


def ssd_forward(params: dict, x, *, d_state: int, expand: int = 2,
                head_dim: int = 64, ngroups: int = 1, conv_width: int = 4,
                chunk_size: int = 256):
    """The whole-sequence block: x (B, L, d_model) -> (B, L, d_model),
    :func:`ssd_prefill_chunk` from the zero state, as the reference."""
    state = ssd_init_state((x.shape[0],), x.shape[-1], d_state, expand,
                           head_dim, ngroups, conv_width, device=x.device)
    y, _ = ssd_prefill_chunk(
        params, x, state, d_state=d_state, expand=expand, head_dim=head_dim,
        ngroups=ngroups, conv_width=conv_width, chunk_size=chunk_size)
    return y


def ssd_prefill_chunk(params: dict, x, state: SsmState, *, d_state: int,
                      expand: int = 2, head_dim: int = 64, ngroups: int = 1,
                      conv_width: int = 4, chunk_size: int = 256
                      ) -> tuple[torch.Tensor, SsmState]:
    """Absorb a chunk x (B, Lc, d_model) into ``state``: (y (B, Lc,
    d_model), the new state, new tensors). The scan carry seeds the
    chunk's recurrence and the conv tail gives its first W-1 positions
    their left context, so any chunk schedule gives
    :func:`ssd_forward`'s rows (ragged chunks included)."""
    d_model = x.shape[-1]
    z, xs, b, c, dt, d_inner, nheads = _split_proj(
        params, x, d_model, d_state, expand, head_dim, ngroups)
    u = torch.cat([xs, b, c], dim=-1)                  # (B, Lc, conv_dim)
    B, L = x.shape[0], x.shape[-2]
    xbc, tail = _causal_conv(params, u, conv_width, tail=state.conv)
    gs = ngroups * d_state
    xs, b, c = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    xh = xs.reshape(B, L, nheads, head_dim)
    bh = b.reshape(B, L, ngroups, d_state)
    ch = c.reshape(B, L, ngroups, d_state)
    dt = F.softplus(dt.float() + params["dt_bias"].float())   # (B, L, nh)
    a = -torch.exp(params["a_log"].float())                    # (nh,)
    y, h = _ssd_chunked(xh, bh, ch, dt, a, chunk_size, init_h=state.h)
    y = y + params["d_skip"].float()[:, None] * xh.float()
    y = y.reshape(B, L, d_inner).to(x.dtype) * F.silu(z)
    return _gated_out(params, y, nheads), SsmState(h, tail.float())


def _gated_out(params: dict, y, nheads: int):
    """The gated norm (fp32 inside) and the out-projection of the heads'
    rows y (..., d_inner). Sharded (DTensors) over a mesh axis that the
    ``nheads`` heads do not divide (hymba's 50 over 16 ranks), the norm's
    scale is taken whole and the projection runs through
    ``local_einsum``, so y and its gradient stay whole over that axis:
    the reshape of y to (nh, hd) heads cannot take such a split."""
    norm = params["norm"]
    if not isinstance(y, DTensor) or all(
            nheads % n == 0 for n in y.device_mesh.shape):
        return rmsnorm(norm, y) @ params["out_proj"]
    if isinstance(norm, DTensor):
        norm = norm.redistribute(
            placements=[Replicate()] * norm.device_mesh.ndim)
    return local_einsum("...i,id->...d", rmsnorm(norm, y),
                        params["out_proj"], force=True)


def _ssd_chunked(xh, bh, ch, dt, a, chunk: int, *, init_h=None):
    """The chunk-parallel scan: ((B, L, nh, hd) fp32, the final (B, nh,
    hd, ds) carry). ``init_h`` seeds the carry. A ragged L is padded to
    a chunk multiple with dt = 0: a padded step's decay is exp(0) = 1
    and its contributions vanish, so the carry and every real row are
    untouched."""
    B, L, nh, hd = xh.shape
    ng, ds = bh.shape[-2], bh.shape[-1]
    pad = -L % chunk
    if pad:
        xh, bh, ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, bh, ch))
        dt = F.pad(dt, (0, 0, 0, pad))
    C, T = (L + pad) // chunk, chunk
    g = nh // ng
    xc = xh.reshape(B, C, T, nh, hd).float()
    bc = bh.reshape(B, C, T, ng, ds).float()
    cc = ch.reshape(B, C, T, ng, ds).float()
    dtc = dt.reshape(B, C, T, nh)
    cum = torch.cumsum(dtc * a, dim=2)      # inclusive log-decay, <= 0
    tri = torch.ones(T, T, dtype=torch.bool,
                     device=xh.device).tril()[None, :, :, None]
    h = (torch.zeros(B, nh, hd, ds, device=xh.device) if init_h is None
         else init_h.float())
    ys = []
    for i in range(C):
        x_c, b_c, c_c = xc[:, i], bc[:, i], cc[:, i]
        dt_c, cum_c = dtc[:, i], cum[:, i]
        # decay[t, u] = exp(cum_t - cum_u) for u <= t, else 0, masked
        # before the exponent (C-10).
        diff = cum_c[:, :, None, :] - cum_c[:, None, :, :]    # (B,T,T,nh)
        decay = torch.exp(torch.where(tri, diff, -torch.inf))
        cb = _heads(torch.einsum("btgs,bugs->btug", c_c, b_c), g, 3)
        scores = decay * cb * dt_c[:, None, :, :]
        y = torch.einsum("btuh,buhd->bthd", scores, x_c)
        # The carried prefix read out at each position, decayed.
        cg = _heads(c_c, g, 2)                                 # (B,T,nh,ds)
        y = y + torch.einsum("bths,bhds->bthd",
                             cg * torch.exp(cum_c)[..., None], h)
        # h' = exp(cum_T) h + sum_u exp(cum_T - cum_u) dt_u x_u B_u^T
        w = torch.exp(cum_c[:, -1:, :] - cum_c) * dt_c          # (B,T,nh)
        bg = _heads(b_c, g, 2)
        dh = torch.einsum("bthd,bths->bhds", x_c * w[..., None], bg)
        h = torch.exp(cum_c[:, -1, :])[..., None, None] * h + dh
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, C * T, nh, hd)
    return y[:, :L], h


def ssd_decode_step(params: dict, x, state: SsmState, *, d_state: int,
                    expand: int = 2, head_dim: int = 64, ngroups: int = 1,
                    conv_width: int = 4) -> tuple[torch.Tensor, SsmState]:
    """One token: x (B, d_model) -> (B, d_model) and the new state (new
    tensors; the caller writes them into its own)."""
    d_model = x.shape[-1]
    z, xs, b, c, dt, d_inner, nheads = _split_proj(
        params, x, d_model, d_state, expand, head_dim, ngroups)
    u = torch.cat([xs, b, c], dim=-1)                       # (B, conv_dim)
    hist = torch.cat([state.conv, u[..., None, :].float()], dim=-2)
    conv = torch.einsum("bwc,wc->bc", hist, params["conv_w"].float())
    xbc = F.silu(conv + params["conv_b"]).to(x.dtype)
    gs = ngroups * d_state
    xs, b, c = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    B = x.shape[0]
    g = nheads // ngroups
    xh = xs.reshape(B, nheads, head_dim).float()
    bh = _heads(b.reshape(B, ngroups, d_state), g, 1).float()
    chd = _heads(c.reshape(B, ngroups, d_state), g, 1).float()
    dt = F.softplus(dt.float() + params["dt_bias"].float())    # (B, nh)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)
    h = (decay[..., None, None] * state.h
         + torch.einsum("bh,bhd,bhs->bhds", dt, xh, bh))
    y = torch.einsum("bhds,bhs->bhd", h, chd)
    y = y + params["d_skip"].float()[:, None] * xh
    y = y.reshape(B, d_inner).to(x.dtype) * F.silu(z)
    return _gated_out(params, y, nheads), SsmState(h, hist[..., 1:, :])
