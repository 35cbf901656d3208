"""Attention dispatch for the ported decoder (``repro.models.attention``).

Convention: q (..., L, H, Dh), k/v (..., L, Hkv, Dh) -> (..., L, H, Dh),
and one decode interface over :class:`AttnCache`. Kinds:

    slay          — the paper's linear-time mechanism: its CUDA kernels
                    on the card; decode state the constant-size (S, z)
    favor | cosformer | elu1
                  — the linear baselines (paper Table 5,
                    ``core.baselines``): plain PyTorch for the sequence,
                    the (S, z) decode step through the decode kernel
    softmax       — exact quadratic (optionally logit-softcapped and,
                    on gemma2's local layers, sliding-window)
    yat           — exact quadratic Yat-kernel attention (paper Eq. 1)
    yat_spherical — exact quadratic spherical Yat (paper Eq. 5)

The exact kinds decode from a ring-buffer KV cache of ``max_len`` rows
(``min(max_len, window)`` for a windowed layer, which wraps in place)
and run as plain PyTorch ops, as the JAX package runs them in jnp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import baselines as bl
from repro_torch.core import kernels as exact
from repro_torch.core import linear_attention as la
from repro_torch.core import slay as slay_mod
from repro_torch.core.features import normalize, slay_features
from repro_torch.core.slay import AttentionSpec, feature_dim
from repro_torch.kernels import ops


class AttnCache(NamedTuple):
    """Uniform decode cache; the fields of the other kind are None.

    k, v:  the exact kinds' ring buffers (..., size, Hkv, Dh), a token at
           absolute position p in row p % size.
    s, z:  a linear kind's running state (S = Σ ψ(k)ᵀv, z = Σ ψ(k)),
           fp32, m = :func:`core.slay.feature_dim` features wide.
    ``pos`` counts tokens seen so far, per slot (lead-shaped), so slots of
    one pool hold sequences of different lengths.
    """

    k: torch.Tensor | None           # (..., size, Hkv, Dh)
    v: torch.Tensor | None           # (..., size, Hkv, dv)
    pos: torch.Tensor                # int32, lead-shaped
    s: torch.Tensor | None           # (..., Hkv, m, dv) fp32
    z: torch.Tensor | None           # (..., Hkv, m)     fp32


def _check_kind(spec: AttentionSpec) -> None:
    if spec.kind not in slay_mod.ATTN_KINDS:
        raise NotImplementedError(
            f"unknown attention kind {spec.kind!r}; the port has "
            f"{', '.join(slay_mod.ATTN_KINDS)}")


def init_cache(spec: AttentionSpec, lead_shape, num_kv: int, head_dim: int,
               dv: int, max_len: int, dtype: torch.dtype, *,
               device: torch.device) -> AttnCache:
    """A zero cache: (S, z) for a linear kind, rings of ``max_len`` rows
    otherwise (``min(max_len, window)`` for a windowed layer)."""
    _check_kind(spec)
    pos = torch.zeros(lead_shape, dtype=torch.int32, device=device)
    if spec.is_linear:
        st = la.init_state(lead_shape, num_kv, feature_dim(spec, head_dim),
                           dv, device=device)
        return AttnCache(None, None, pos, st.s, st.z)
    size = min(max_len, spec.window) if spec.window else max_len
    return AttnCache(
        torch.zeros(*lead_shape, size, num_kv, head_dim, dtype=dtype,
                    device=device),
        torch.zeros(*lead_shape, size, num_kv, dv, dtype=dtype,
                    device=device), pos, None, None)


def full_attention(spec: AttentionSpec, params: dict | None, q, k, v, *,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill). SLAY: the fused
    kernel, or with ``spec.fuse_features`` False the feature-map kernel
    then the scan kernel. A linear baseline: its features (cosformer's
    reweighted by position) and the chunked scan in PyTorch ops. The exact
    kinds broadcast kv over the GQA group and run in PyTorch ops; a
    windowed softmax takes the banded route when the window divides a
    longer sequence, else the masked one. Sharded (DTensors), an exact
    kind runs on each rank's block of batch and heads, as the kernels
    do (``kernels.ops``): its einsums over DTensors would flatten a
    split batch and heads into strided splits that DTensor walks one
    element at a time."""
    _check_kind(spec)
    if spec.kind == "slay":
        return slay_mod.slay_attention(
            params, q, k, v, spec.slay, causal=causal,
            chunk_size=spec.chunk_size, fuse_features=spec.fuse_features)
    if spec.is_linear:
        return bl.linear_baseline_attention(spec.kind, params, q, k, v,
                                            causal=causal,
                                            chunk_size=spec.chunk_size)
    if isinstance(q, DTensor):
        return ops._sharded_heads(
            lambda a, b, c: full_attention(spec, params, a, b, c,
                                           causal=causal), q, k, v)
    if k.shape[-2] != q.shape[-2]:
        g = q.shape[-2] // k.shape[-2]
        k = torch.repeat_interleave(k, g, dim=-2)
        v = torch.repeat_interleave(v, g, dim=-2)
    if spec.kind == "softmax":
        return exact.softmax_attention(q, k, v, causal=causal,
                                       logit_softcap=spec.logit_softcap,
                                       window=spec.window)
    return exact.yat_attention(q, k, v, causal=causal,
                               spherical=spec.kind == "yat_spherical")


def cross_attention(spec: AttentionSpec, params: dict | None, q, k, v
                    ) -> torch.Tensor:
    """Non-causal cross-attention (encoder-decoder): q (..., Lq, H, Dh)
    over k/v (..., Lk, Hkv, *) of the encoder's length. SLAY's is
    :func:`core.slay.slay_cross_attention`'s: Ψ by the feature-map
    kernel, the contraction in PyTorch."""
    return full_attention(spec, params, q, k, v, causal=False)


def prefill_cache(spec: AttentionSpec, params: dict | None, k, v,
                  cache: AttnCache, valid=None) -> AttnCache:
    """Absorb a whole prompt's keys/values into a fresh decode cache.

    k/v: (..., L, Hkv, *). A linear kind reduces them to (S, z) (new
    tensors); the ring kinds write the trailing ``size`` tokens into
    ``cache``'s rings in place at their ring rows and return them.
    ``valid`` (..., L) bool masks a right-padded prompt: a linear kind
    zeroes pad key features, the rings get zero rows, which ``pos`` (the
    true length) keeps outside every later validity horizon.
    """
    _check_kind(spec)
    L, lead = k.shape[-3], k.shape[:-3]
    if valid is None:
        pos = torch.full(lead, L, dtype=torch.int32, device=k.device)
    else:
        pos = valid.to(torch.int32).sum(-1).expand(lead)
    if spec.is_linear:
        kf = _features(spec, params, k)
        if valid is not None:
            kf = torch.where(valid[..., None, None], kf, 0.0)
        st = prefill_state(kf, v)
        return AttnCache(None, None, pos, st.s, st.z)
    if valid is not None:
        k = torch.where(valid[..., None, None], k, 0)
        v = torch.where(valid[..., None, None], v, 0)
    size = cache.k.shape[-3]
    take = min(L, size)
    idx = (torch.arange(take, device=k.device) + (L - take)) % size
    _ring_write(cache.k, idx, k[..., L - take:, :, :], per_row=False)
    _ring_write(cache.v, idx, v[..., L - take:, :, :], per_row=False)
    return AttnCache(cache.k, cache.v, pos, None, None)


def prefill_state(kf, v) -> la.LinearState:
    """``core.linear_attention.prefill_state`` of kf (..., L, Hkv, m) and
    v (..., L, Hkv, dv): the (S, z) sums over the prompt. Sharded (a
    DTensor kf), on each rank's block through ``local_map``: the sums are
    per sequence and head, so a block's are whole, or a partial sum where
    its sequence is split. DTensor's einsum would flatten a split batch
    and heads, which some versions refuse."""
    if not isinstance(kf, DTensor):
        return la.prefill_state(kf, v)
    lead = kf.dim() - 3                 # dims before (L, Hkv, m)

    def out(p):
        if not isinstance(p, Shard):
            return p
        if p.dim == lead:               # the sequence: a partial sum
            return Partial()
        return Shard(p.dim - 1 if p.dim > lead else p.dim)

    pl = tuple(kf.placements)
    o = [out(p) for p in pl]
    s, z = local_map(lambda a, b: tuple(la.prefill_state(a, b)),
                     out_placements=(o, o), in_placements=(pl, pl),
                     device_mesh=kf.device_mesh,
                     redistribute_inputs=True)(kf, v)
    return la.LinearState(s, z)


def _ring_write(buf, idx, rows, *, per_row: bool, active=None):
    """Write ring rows in place: ``buf[..., idx, :, :] = rows`` (a
    prompt's rows at ring rows ``idx`` of every sequence), or with
    ``per_row`` ``buf[b, idx[b]] = rows[b]`` (a decode token at each
    sequence's own ring row; where ``active`` is false the row keeps what
    it held). On a DTensor ring the write runs on each rank's block
    through ``local_map``, rows and indices taken to the ring's split
    (batch and heads), since DTensor has no in-place indexed write for a
    batch-split ring; a ring split over its rows is refused."""
    def write(lb, li, lr, *la):
        lr = lr.to(lb.dtype)
        if not per_row:
            lb[..., li, :, :] = lr
            return
        b = torch.arange(lb.shape[0], device=lb.device)
        if la:
            lr = torch.where(la[0].bool()[:, None, None], lr, lb[b, li])
        lb[b, li] = lr

    extra = () if active is None else (active,)
    if not isinstance(buf, DTensor):
        write(buf, idx, rows, *extra)
        return
    pl = tuple(buf.placements)
    if any(isinstance(p, Shard) and p.dim == buf.dim() - 3 for p in pl):
        raise ValueError("a ring split over its rows cannot be written "
                         "in place on each rank's block")
    # A decode row (B, Hkv, dh) lacks the ring's row dim.
    rpl = tuple(Shard(p.dim - 1) if per_row and isinstance(p, Shard)
                and p.dim > 0 else p for p in pl)
    ipl = tuple(Shard(0) if per_row and isinstance(p, Shard) and p.dim == 0
                else Replicate() for p in pl)
    local_map(write, out_placements=None,
              in_placements=(pl, ipl, rpl, *(ipl for _ in extra)),
              device_mesh=buf.device_mesh, redistribute_inputs=True)(
                  buf, idx, rows, *extra)


def _yat_scores(kind: str, qg, kb):
    """Exact yat kernel weights (paper Eq. 1 / Eq. 5, eps 1e-3) of grouped
    queries qg (..., Hkv, G, Dh) against keys kb (..., S, Hkv, Dh) ->
    (..., Hkv, G, S): the one source of the weights of the decode step and
    the chunked-prefill continuation. Callers mask to 0 and normalize."""
    if kind == "yat_spherical":
        x = torch.einsum("...kgd,...skd->...kgs", normalize(qg),
                         normalize(kb))
        return x * x / (exact.const(2.0 + 1e-3, x) - 2.0 * x)
    x = torch.einsum("...kgd,...skd->...kgs", qg, kb)
    q2 = torch.sum(qg * qg, -1)[..., None]               # (..., Hkv, G, 1)
    k2 = torch.movedim(torch.sum(kb * kb, -1), -2, -1)[
        ..., :, None, :]                                 # (..., Hkv, 1, S)
    return x * x / (torch.clamp(q2 + k2 - 2 * x, min=0.0)
                    + exact.const(1e-3, x))


def _ring_attend(spec: AttentionSpec, qg, kb, vb, mask):
    """Exact attention of grouped queries qg (..., Hkv, G, Dh) over keys
    and values kb/vb (..., S, Hkv, *) where ``mask`` (broadcast to
    (..., Hkv, G, S)) holds: softmax with masked logits at the dtype's
    minimum, or the yat weights masked to 0 over their sum + 1e-6."""
    if spec.kind in ("yat", "yat_spherical"):
        scores = torch.where(mask, _yat_scores(spec.kind, qg, kb), 0.0)
        num = torch.einsum("...kgs,...skd->...kgd", scores, vb)
        den = torch.sum(scores, dim=-1)[..., None]
        return num / (den + exact.const(1e-6, den))
    logits = torch.einsum("...kgd,...skd->...kgs", qg, kb) / torch.sqrt(
        exact.const(qg.shape[-1], qg))
    logits = exact.softcap(logits, spec.logit_softcap)
    probs = exact.masked_softmax(logits, mask)
    return torch.einsum("...kgs,...skd->...kgd", probs, vb)


def prefill_chunk(spec: AttentionSpec, params: dict | None, q, k, v,
                  cache: AttnCache, *,
                  active=None) -> tuple[torch.Tensor, AttnCache]:
    """Absorb one prompt chunk into an existing decode cache.

    q (B, Lc, H, Dh), k/v (B, Lc, Hkv, *); ``cache.pos`` (B,) counts the
    tokens absorbed so far. A linear kind: the chunked causal scan in
    torch on its cache features (:func:`_features`) seeded with the
    cache's fp32 state (new tensors; the cache's are not written), as the
    JAX package runs it in jnp outside any kernel. The ring kinds attend
    to the ring prefix (the row j holds the newest position congruent to
    j mod size, visible once written and, for a windowed layer, while
    less than ``window`` behind the query) and causally within the chunk
    (within the window), then write the chunk's keys and values into the
    rings in place, only the trailing ``size`` of a chunk longer than the
    ring. Either way a prompt fed chunk by chunk ends in the state of a
    whole-prompt prefill (up to the order of fp32 sums for SLAY).

    ``active`` (B,) masks slots as :func:`decode_step` does (the
    speculative verifier's chunk): a drained slot's state keeps its bytes
    (its ring rows are rewritten with their own) and its ``pos`` does not
    advance; its output rows are meaningless.
    """
    _check_kind(spec)
    B, Lc = q.shape[0], q.shape[1]
    start = cache.pos
    act = None if active is None else active.bool()
    step = Lc if act is None else Lc * act.to(torch.int32)
    if spec.is_linear:
        qf = _features(spec, params, q)
        kf = _features(spec, params, k)
        y, st = la.causal_chunked(
            qf, kf, v, chunk_size=max(min(spec.chunk_size, Lc), 1),
            init_state=la.LinearState(cache.s, cache.z), return_state=True)
        s, z = st.s, st.z
        if act is not None:
            s = torch.where(act[:, None, None, None], s, cache.s)
            z = torch.where(act[:, None, None], z, cache.z)
        return y, AttnCache(None, None, start + step, s, z)
    dev = q.device
    size = cache.k.shape[-3]
    dh, hkv = q.shape[-1], k.shape[-2]
    g = q.shape[-2] // hkv
    qg = q.reshape(B, Lc, hkv, g, dh)
    st = start.long()
    j = torch.arange(size, device=dev)[None, :]
    # Absolute position held by ring row j before this chunk's writes: the
    # newest written position congruent to j (mod size), negative if none.
    a0 = j + torch.div(st[:, None] - 1 - j, size,
                       rounding_mode="floor") * size
    pre_ok = (a0 >= 0)[:, None, :]
    rel = (torch.arange(Lc, device=dev)[:, None]
           - torch.arange(Lc, device=dev)[None, :])
    in_ok = rel >= 0
    if spec.window:
        p = st[:, None] + torch.arange(Lc, device=dev)[None, :]
        pre_ok = pre_ok & (p[:, :, None] - a0[:, None, :] < spec.window)
        in_ok = in_ok & (rel < spec.window)
    pre_ok = pre_ok.expand(B, Lc, size)
    in_ok = in_ok[None].expand(B, Lc, Lc)
    mask = torch.cat([pre_ok, in_ok], dim=-1)[:, :, None, None, :]
    k_all = torch.cat([cache.k.to(q.dtype), k.to(q.dtype)], dim=1)
    v_all = torch.cat([cache.v.to(q.dtype), v.to(q.dtype)], dim=1)
    y = _ring_attend(spec, qg, k_all[:, None], v_all[:, None], mask)
    y = y.reshape(B, Lc, hkv * g, v.shape[-1])
    take = min(Lc, size)
    b = torch.arange(B, device=dev)[:, None]
    idx = (st[:, None] + (Lc - take)
           + torch.arange(take, device=dev)[None, :]) % size
    kw = k[:, Lc - take:].to(cache.k.dtype)
    vw = v[:, Lc - take:].to(cache.v.dtype)
    if act is not None:
        a = act[:, None, None, None]
        kw = torch.where(a, kw, cache.k[b, idx])
        vw = torch.where(a, vw, cache.v[b, idx])
    cache.k[b, idx] = kw
    cache.v[b, idx] = vw
    return y, AttnCache(cache.k, cache.v, start + step, None, None)


def decode_step(spec: AttentionSpec, params: dict | None, q, k, v,
                cache: AttnCache, *,
                active=None) -> tuple[torch.Tensor, AttnCache]:
    """One token for a batch of slots. q (B, H, Dh), k/v (B, Hkv, *)
    -> (B, H, dv). The cache is updated in place and returned, so a
    captured CUDA graph of the step keeps updating the same tensors: SLAY's
    s and z by the decode kernel (its plain twin on the CPU); a ring kind's
    row ``pos % size`` of each slot; ``pos`` advanced.

    ``active`` (B,) masks continuous-batching pool rows: drained rows keep
    their state bit-identical (a ring row is rewritten with its own bytes)
    and ``pos`` frozen, and output y = 0.
    """
    _check_kind(spec)
    if q.dim() != 3:
        raise ValueError(f"decode q must be (B, H, Dh), got {tuple(q.shape)}")
    step = 1 if active is None else active.to(torch.int32)
    if spec.is_linear:
        qf = _features(spec, params, q)
        kf = _features(spec, params, k)
        y, _, _ = ops.decode_linear_step(qf, kf, v, cache.s, cache.z, active)
        cache.pos.add_(step)
        return y, cache
    B = q.shape[0]
    dev = q.device
    size = cache.k.shape[-3]
    ring = (cache.pos % size).long()
    _ring_write(cache.k, ring, k, per_row=True, active=active)
    _ring_write(cache.v, ring, v, per_row=True, active=active)
    n_seen = cache.pos + step
    valid = (torch.arange(size, device=dev)[None, :]
             < torch.clamp(n_seen, max=size)[:, None])   # (B, S)
    h, dh = q.shape[-2], q.shape[-1]
    hkv, dv = cache.k.shape[-2], cache.v.shape[-1]
    qg = q.reshape(B, hkv, h // hkv, dh)
    y = _ring_attend(spec, qg, cache.k.to(q.dtype), cache.v.to(q.dtype),
                     valid[:, None, None, :])
    y = y.reshape(B, h, dv)
    if active is not None:
        y = torch.where(active.bool()[:, None, None], y, 0).to(y.dtype)
    cache.pos.add_(step)
    return y, cache


def _features(spec: AttentionSpec, params: dict | None, u):
    """A linear kind's features on the cache paths: SLAY's Ψ in fp32
    (``core.features``), or a baseline's (cosformer without its position
    weights, as in the JAX package; ROADMAP C-8). Sharded (a DTensor u),
    on each rank's rows through ``local_map``: the features act on the
    last dim alone, which is never split."""
    if isinstance(u, DTensor):
        names = sorted(params or {})
        pl = tuple(u.placements)

        def local(ul, *cs):
            return _features(spec, dict(zip(names, cs)) if names else params,
                             ul)

        return local_map(
            local, out_placements=list(pl),
            in_placements=(pl, *(ops._const(params[n]) for n in names)),
            device_mesh=u.device_mesh)(u, *(params[n] for n in names))
    if spec.kind == "slay":
        return slay_features(u, params, spec.slay)
    return bl.decode_features(spec.kind, params, u)
