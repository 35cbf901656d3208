"""Shared neural-net layers: RMSNorm, RoPE, MLP, MoE, embeddings.

Plain functions ``f(params, x, ...) -> y`` on tensors, mirroring
``repro.models.layers``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import constrain


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
    silu(x@up) @ down — SiLU, not GELU, as the JAX package computes it.
    The hidden activations are constrained to ``act_mlp`` (TP)."""
    hidden = (("act_batch", "act_seq", "act_mlp") if x.dim() == 3
              else ("act_batch", "act_mlp"))
    up = constrain(x @ params["up"], hidden)
    if gated:
        up = F.silu(constrain(x @ params["gate"], hidden)) * up
    else:
        up = F.silu(up)
    return up @ params["down"]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row, as ``jax.nn.one_hot``. A comparison, not
    ``F.one_hot``, whose range check would sync the host (a captured
    CUDA graph cannot)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe(params: dict, x: torch.Tensor, num_experts: int, top_k: int = 2,
        capacity_factor: float = 1.25,
        seq_chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity-bounded one-hot dispatch (GShard/Switch),
    ``repro.models.layers.moe`` op for op. x (..., S, d) -> (y, aux).

    Each call's capacity is ``max(int(1.25 * S * k / E), 1)`` slots per
    expert and row group; a token's k choices queue token by token (its
    first choice before its second) and choices past an expert's
    capacity are dropped. Gate values are renormalised over the top k
    (+ 1e-9). ``aux`` is the Switch load-balance loss E · mean_G Σ_e
    density · frac, frac from the argmax. A sequence longer than
    ``seq_chunk`` and a multiple of it runs chunk by chunk (capacity per
    chunk), with the aux averaged over the chunks. Fixed shapes only: no
    host sync, so a CUDA graph can capture it. ``torch.topk`` does not
    promise the lower index on a tie, as ``lax.top_k`` does; router
    probabilities tie only on degenerate inputs.
    """
    *lead, s, d = x.shape
    if s > seq_chunk and s % seq_chunk == 0:
        n = s // seq_chunk
        xc = torch.movedim(x.reshape(*lead, n, seq_chunk, d), len(lead), 0)
        outs = [moe(params, xi, num_experts, top_k, capacity_factor,
                    seq_chunk) for xi in xc]
        y = torch.movedim(torch.stack([o[0] for o in outs]), 0, len(lead))
        return (y.reshape(*lead, s, d),
                torch.mean(torch.stack([o[1] for o in outs])))
    xf = x.reshape(-1, s, d)                                  # (G, S, d)
    g = xf.shape[0]
    e, k = num_experts, top_k
    cap = max(int(capacity_factor * s * k / e), 1)
    logits = torch.einsum("gsd,de->gse", xf, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # Load-balance auxiliary loss (Switch eq. 4).
    density = torch.mean(probs, dim=1)                        # (G, E)
    frac = torch.mean(_one_hot(torch.argmax(probs, -1), e), dim=1)
    aux = torch.mean(torch.sum(density * frac, dim=-1)) * e
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)        # (G, S, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    # Position within each expert's queue, capacity-masked.
    onehot = _one_hot(gate_idx, e)                            # (G,S,k,E)
    flat = onehot.reshape(g, s * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, s, k, e)
    keep = (pos < cap).float() * onehot
    posc = _one_hot(torch.sum(pos * onehot, -1).to(torch.int32), cap)
    dispatch = torch.einsum("gske,gskc->gsec", keep, posc)    # (G,S,E,C)
    combine = torch.einsum("gsec,gsk,gske->gsec", dispatch, gate_vals,
                           onehot)
    exp = ("act_batch", "experts", None, None)       # EP over experts
    xe = constrain(torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xf),
                   exp)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, params["gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, params["up"])
    ye = constrain(torch.einsum("gecf,efd->gecd", h, params["down"]), exp)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    return y.reshape(*lead, s, d), aux


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(table, DTensor):
        return _sharded_embed(table, tokens)
    return table[tokens.long()]


def _sharded_embed(table, tokens):
    """A sharded table's rows of each rank's own tokens: the table
    gathered whole (as FSDP gathers a weight before its use), the lookup
    on local tensors through ``local_map``, its gradient a partial sum
    over the ranks whose tokens differ. DTensor's own index and embedding
    rules are not used: their sharding propagation fails on some meshes
    and versions of PyTorch."""
    mesh = table.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    tpl = tuple(tokens.placements)
    if any(isinstance(p, Shard) and p.dim != 0 for p in tpl):
        raise ValueError(f"tokens sharded off their batch dim: {tpl}")
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    if (not torch.is_grad_enabled() and any(vocab)
            and all(v or isinstance(p, Replicate)
                    for v, p in zip(vocab, table.placements))
            and not any(v and isinstance(p, Shard)
                        for v, p in zip(vocab, tpl))):
        return _masked_embed(table, tokens, vocab)
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in tpl)
    return local_map(
        lambda t, ids: t[ids.long()], out_placements=list(tpl),
        in_placements=(rep, tpl), in_grad_placements=(grad, tpl),
        device_mesh=mesh)(table.redistribute(mesh, rep), tokens)


def _masked_embed(table, tokens, vocab: list):
    """Serving's lookup in a vocab-sharded table (no gradient): each rank
    takes the rows of its own vocab block, zeros elsewhere, and the
    result is their partial sum (one all-reduce of the rows when it is
    read), not the whole table gathered."""
    mesh = table.device_mesh
    lo = 0
    size = table.shape[0]
    for j, v in enumerate(vocab):
        if v:
            size //= mesh.size(j)
            lo += mesh.get_local_rank(j) * size

    def rows(t, ids):
        ids = ids.long() - lo
        mine = (ids >= 0) & (ids < t.shape[0])
        out = t[ids.clamp(0, t.shape[0] - 1)]
        return torch.where(mine[..., None], out, torch.zeros((), dtype=t.dtype,
                                                             device=t.device))

    out = tuple(Partial() if v else p
                for v, p in zip(vocab, tokens.placements))
    return local_map(rows, out_placements=list(out),
                     in_placements=(tuple(table.placements),
                                    tuple(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def unembed(table: torch.Tensor, x: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    logits = x @ table.T
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
