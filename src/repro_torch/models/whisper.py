"""whisper-small's encoder-decoder backbone (``repro.models.whisper``);
the audio frontend is a stub, as in the reference: ``frame_embeds`` (B,
enc_seq, d) are precomputed frame embeddings.

The encoder adds ``enc_pos`` to the frames and runs non-causal
self-attention (no RoPE) and the MLP in each of ``enc_layers`` layers,
then ``enc_norm``. Each decoder layer runs causal self-attention (RoPE),
then cross-attention from the decoder's rows to the encoding
(``pre_cross``, ``cross``), then the MLP. Under SLAY all three
linearise: the encoder's and the cross-attention's Ψ go through the
feature-map kernel (B7, its VJP B8 in training) and the decoder's
self-attention through the fused kernel (K1; K3 and K4 in training).

Parameters, laid out like the reference's pytree::

    embed (V, d) (tied), enc_pos (enc_seq, d), enc_norm, final_norm (d,),
    enc_layers: pre_attn, pre_mlp (ne, d), attn: wq, wk, wv, wo, mlp: up,
                down [, gate]                 (stacked, ne leading)
    dec_layers: the same, nl leading, and pre_cross (nl, d), cross: wq,
                wk, wv, wo
    slay: anchors, omegas                      (SLAY configs only)

Serving: ``prefill`` encodes the frames, absorbs the whole prompt and
builds each layer's cross state once; ``decode_step`` advances the
self-attention state in place (SLAY through the decode kernel K2) and
reads the fixed cross state. Under a linear kind that state is each
layer's (S, z) of the encoding's cache-path features (fp32), under an
exact kind the encoder's keys and values (fp32), and decode then reads
them with a softmax whatever the exact kind, as the reference does
(ROADMAP C-12: under yat, decode and the teacher-forced ``forward``
differ). There is no chunked or masked prefill: the encoding has no
chunk-by-chunk continuation, so the serving engine prefills a whole
prompt at its own length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import kernels as exact
from repro_torch.core.features import init_feature_params
from repro_torch.core.slay import feature_dim
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import local_einsum
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr
from repro_torch.models.layers import embed, mlp, rmsnorm, rope, unembed
from repro_torch.serving import pages as pg


def _param_shapes(cfg: ArchConfig) -> dict:
    """name -> (shape, init, scale), as ``transformer._param_shapes``."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    H, Hkv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {
        "embed": ((cfg.vocab_size, d), "normal", 1.0),
        "enc_pos": ((cfg.enc_seq, d), "normal", 0.02),
    }
    for stack, n in (("enc_layers", cfg.enc_layers),
                     ("dec_layers", cfg.num_layers)):
        for k, v in tr._attn_mlp_shapes(cfg, d, n, dh, H, Hkv, ff).items():
            shapes[stack + k[len("layers"):]] = v
    nl = cfg.num_layers
    shapes["dec_layers.pre_cross"] = ((nl, d), "zeros", None)
    shapes["dec_layers.cross.wq"] = ((nl, d, H, dh), "normal", None)
    shapes["dec_layers.cross.wk"] = ((nl, d, Hkv, dh), "normal", None)
    shapes["dec_layers.cross.wv"] = ((nl, d, Hkv, dh), "normal", None)
    shapes["dec_layers.cross.wo"] = ((nl, H, dh, d), "normal", None)
    shapes["enc_norm"] = ((d,), "zeros", None)
    shapes["final_norm"] = ((d,), "zeros", None)
    return shapes


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random weights from ``seed`` (a CPU ``torch.Generator``) in the
    activation dtype; SLAY's projections, fp32, drawn last. Only SLAY
    draws projections, as in the reference."""
    cfg.check_supported()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = tr.realize(_param_shapes(cfg), gen, dev, cfg.activation_dtype)
    if cfg.attn_kind == "slay":
        params["slay"] = init_feature_params(cfg.slay_config(), gen,
                                             device=dev)
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """The logical-axes tree of :func:`init_params`' parameters, the
    reference's ``param_axes``."""
    cfg.check_supported()
    return tr.axes_tree(cfg, _param_shapes(cfg))


def _layer(stack: dict, i: int) -> dict:
    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i]
                for k, v in node.items()}
    return take(stack)


def _proj(w, x):
    return tr.act(local_einsum("...d,dhk->...hk", x, w), tr._AHEAD)


def _qkv(cfg: ArchConfig, p: dict, x, positions=None):
    """q, k, v of ``x`` through ``p``'s wq, wk, wv; RoPE on q and k at
    ``positions`` (the decoder's self-attention only)."""
    q, k, v = _proj(p["wq"], x), _proj(p["wk"], x), _proj(p["wv"], x)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: dict, y):
    return tr.act(local_einsum("...hk,hkd->...d", y, p["wo"]), tr._ARES)


def _mlp(cfg: ArchConfig, lp: dict, x):
    return tr.act(mlp(lp["mlp"], rmsnorm(lp["pre_mlp"], x), cfg.gated_mlp),
                  tr._ARES)


def encode(params: dict, cfg: ArchConfig, frame_embeds: torch.Tensor):
    """frame_embeds (B, T, d) -> the encoding (B, T, d): ``enc_pos``
    added, non-causal self-attention without RoPE in every encoder
    layer, ``enc_norm``. The frames are taken in the activation dtype."""
    cfg.check_supported()
    dt = cfg.activation_dtype
    x = (frame_embeds.to(params["embed"].device, dt)
         + params["enc_pos"].to(dt))
    spec = cfg.attention_spec()
    slay = tr._slay_params(params, detach=True)
    for i in range(cfg.enc_layers):
        lp = _layer(params["enc_layers"], i)
        x = tr.act(x, tr._ARES)
        q, k, v = _qkv(cfg, lp["attn"], rmsnorm(lp["pre_attn"], x))
        y = attn.full_attention(spec, slay, q, k, v, causal=False)
        x = x + _out(lp["attn"], y)
        x = x + _mlp(cfg, lp, x)
    return rmsnorm(params["enc_norm"], x)


def _dec_layer(cfg: ArchConfig, spec, slay, positions, enc, lp: dict, x,
               cache=None):
    """One decoder layer over a sequence: (x, the layer's self-attention
    cache of the prompt, its cross state (s, z) or (k, v)); the two last
    are None without ``cache`` (training)."""
    x = tr.act(x, tr._ARES)
    q, k, v = _qkv(cfg, lp["attn"], rmsnorm(lp["pre_attn"], x), positions)
    y = attn.full_attention(spec, slay, q, k, v, causal=True)
    x = x + _out(lp["attn"], y)
    qc = _proj(lp["cross"]["wq"], rmsnorm(lp["pre_cross"], x))
    kc, vc = _proj(lp["cross"]["wk"], enc), _proj(lp["cross"]["wv"], enc)
    yc = attn.cross_attention(spec, slay, qc, kc, vc)
    x = x + _out(lp["cross"], yc)
    x = x + _mlp(cfg, lp, x)
    if cache is None:
        return x, None, None
    nc = attn.prefill_cache(spec, slay, k, v, cache)
    if spec.is_linear:
        st = attn.prefill_state(attn._features(spec, slay, kc), vc)
        return x, nc, (st.s, st.z)
    return x, nc, (kc.float(), vc.float())


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            frame_embeds: torch.Tensor, *, remat: bool | str = False):
    """Teacher-forced decoder over the encoded frames: tokens (B, L) ->
    (logits (B, L, V), 0 as the aux loss). ``remat`` recomputes each
    decoder layer in the backward pass, as the reference's
    ``jax.checkpoint`` of the decoder body."""
    enc = encode(params, cfg, frame_embeds)
    dev = params["embed"].device
    x = embed(params["embed"], tokens.to(dev)).to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=dev)[None, :]
    spec = cfg.attention_spec()
    slay = tr._slay_params(params, detach=True)
    for i in range(cfg.num_layers):
        x = tr.remat_call(remat, lambda lp, x, enc: _dec_layer(
            cfg, spec, slay, positions, enc, lp, x)[0],
            _layer(params["dec_layers"], i), x, enc)
    x = rmsnorm(params["final_norm"], x)
    return (unembed(params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=dev))


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            remat: bool | str = False) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over ``batch``'s tokens, labels and
    frame_embeds (fp32 logits, mean over tokens)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch["frame_embeds"], remat=remat)
    labels = batch["labels"].to(logits.device).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = torch.mean(logz - tr.gold_logits(logits, labels))
    return nll, {"nll": nll, "moe_aux": aux}


class WhisperCache(NamedTuple):
    """The decode state, stacked (num_layers leading), in the reference's
    field order, so its leaves are ``jax.tree.leaves``' (SLAY:
    ``self_attn.pos, self_attn.s, self_attn.z, cross_s, cross_z, pos``;
    an exact kind: ``self_attn.k, self_attn.v, self_attn.pos, cross_s,
    cross_z, pos``) and checkpoints and prefix snapshots keep the JAX
    format. ``cross_s``/``cross_z`` are (nl, B, Hkv, m, dv)/(nl, B, Hkv,
    m) fp32 under a linear kind, the encoder's keys and values (nl, B,
    enc_seq, Hkv, dh) fp32 under an exact kind; read-only after
    ``prefill``."""

    self_attn: attn.AttnCache
    cross_s: torch.Tensor
    cross_z: torch.Tensor
    pos: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               page_size: int = 0, num_pages: int = 0,
               device: str | torch.device = "cuda") -> WhisperCache:
    """A zero cache for ``batch`` slots: self-attention (S, z) and the
    cross summaries under a linear kind, rings of ``max_len`` rows and
    the encoder's keys and values under an exact kind. Never paged
    (``page_size`` is ignored, as in the reference)."""
    cfg.check_supported()
    dev = resolve_device(device)
    spec = cfg.attention_spec()
    nl, dh, hkv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    if not spec.is_linear and max_len < 1:
        raise ValueError(f"{cfg.name}'s KV rings need max_len >= 1, got "
                         f"{max_len}")
    a = attn.init_cache(spec, (nl, batch), hkv, dh, dh, max_len,
                        cfg.activation_dtype, device=dev)
    if spec.is_linear:
        m = feature_dim(spec, dh)
        cs = torch.zeros(nl, batch, hkv, m, dh, device=dev)
        cz = torch.zeros(nl, batch, hkv, m, device=dev)
    else:
        cs = torch.zeros(nl, batch, cfg.enc_seq, hkv, dh, device=dev)
        cz = torch.zeros(nl, batch, cfg.enc_seq, hkv, dh, device=dev)
    return WhisperCache(a, cs, cz,
                        torch.zeros(batch, dtype=torch.int32, device=dev))


def _float_leaves(cache: WhisperCache) -> list:
    a = cache.self_attn
    return [t for t in (a.k, a.v, a.s, a.z, cache.cross_s, cache.cross_z)
            if t is not None]


# The slot surface, in place on the pool's own tensors, as the
# transformer's (see there): the decode step binds them.


def reset_slot(cfg: ArchConfig, cache: WhisperCache, slot: int,
               pages=None) -> WhisperCache:
    """Zero one slot (eviction), in place: its self-attention state,
    cross state and positions."""
    for t in _float_leaves(cache):
        t[:, slot].zero_()
    cache.self_attn.pos[:, slot] = 0
    cache.pos[slot] = 0
    return cache


def write_slot(cfg: ArchConfig, cache: WhisperCache, src: WhisperCache,
               slot: int, pages=None) -> WhisperCache:
    """Install a batch-1 request cache (a fresh ``prefill``'s) into slot
    ``slot``, in place."""
    for dst, s in zip(_float_leaves(cache), _float_leaves(src)):
        dst[:, slot].copy_(s[:, 0])
    cache.self_attn.pos[:, slot].copy_(src.self_attn.pos[:, 0])
    cache.pos[slot] = src.pos[0]
    return cache


def slot_state_finite(cfg: ArchConfig, cache: WhisperCache) -> torch.Tensor:
    """(B,) bool: every float element of the slot's self-attention state
    and cross state is finite, over all layers."""
    ok = None
    for leaf in _float_leaves(cache):
        f = pg.rows_finite(leaf).all(0)
        ok = f if ok is None else ok & f
    return ok


def corrupt_slot(cfg: ArchConfig, cache: WhisperCache,
                 slot: int) -> WhisperCache:
    """NaN one slot's float state, in place (fault injection)."""
    for t in _float_leaves(cache):
        t[:, slot].fill_(float("nan"))
    return cache


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    """No incremental prefill: the encoding and the cross state come
    from the whole frames."""
    return False


def context_capacity(cfg: ArchConfig, max_len: int) -> int | None:
    """None (unbounded) under a linear kind, ``max_len`` (the
    self-attention ring) under an exact kind."""
    return None if cfg.attention_spec().is_linear else max_len


def supports_masked_prefill(cfg: ArchConfig) -> bool:
    """No ``true_len`` masking for encdec, as in the reference."""
    return False


def supports_paging(cfg: ArchConfig) -> bool:
    return False


def supports_speculative(cfg: ArchConfig) -> bool:
    return False


def prefill_chunk(params: dict, cfg: ArchConfig, cache, tokens, *,
                  embeds=None):
    raise NotImplementedError(
        f"chunked prefill unsupported for {cfg.name}: gate "
        f"family='encdec' — prefill encodes the audio frames whole "
        f"(cross-attention state has no chunk-by-chunk continuation); "
        f"serve encdec via whole-prompt prefill")


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            frame_embeds: torch.Tensor, *, max_len: int | None = None,
            true_len=None) -> tuple[torch.Tensor, WhisperCache]:
    """Encode the frames and absorb the prompt: last-token logits (B, 1,
    V) and a fresh cache whose cross state is built from the encoding's
    keys (their cache-path features under a linear kind) and values.
    ``max_len`` sizes an exact kind's rings (default: prompt + 64)."""
    if true_len is not None:
        raise NotImplementedError("true_len-masked prefill unsupported "
                                  "for encdec")
    enc = encode(params, cfg, frame_embeds)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    B, L = tokens.shape
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    spec = cfg.attention_spec()
    slay = tr._slay_params(params)
    cache0 = init_cache(cfg, B, max_len if max_len else L + 64, device=dev)
    caches, cs, cz = [], [], []
    for i in range(cfg.num_layers):
        x, nc, (s, z) = _dec_layer(
            cfg, spec, slay, positions, enc, _layer(params["dec_layers"], i),
            x, tr._layer_cache(cache0.self_attn, i))
        caches.append(nc)
        cs.append(s)
        cz.append(z)
    logits = unembed(params["embed"], rmsnorm(params["final_norm"], x[:, -1]))
    ring = None if spec.is_linear else cache0.self_attn
    return logits[:, None, :], WhisperCache(
        tr._stack_caches(ring, caches), torch.stack(cs), torch.stack(cz),
        torch.full((B,), L, dtype=torch.int32, device=dev))


def decode_step(params: dict, cfg: ArchConfig, cache: WhisperCache,
                tokens: torch.Tensor, active: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, WhisperCache]:
    """One decoder token over the cached cross state: tokens (B, 1) ->
    logits (B, 1, V); the self-attention state and ``pos`` advance in
    place (``active`` (B,) freezes drained slots), the cross state is
    read only. Its query's features are the cache path's (fp32), as the
    reference's ``attn._features``."""
    cfg.check_supported()
    dev = params["embed"].device
    x = embed(params["embed"], tokens.to(dev)[:, 0]).to(cfg.activation_dtype)
    spec = cfg.attention_spec()
    slay = tr._slay_params(params)
    pos = cache.pos
    hkv = cfg.num_kv_heads
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        q, k, v = _qkv(cfg, lp["attn"], rmsnorm(lp["pre_attn"], x)[:, None],
                       pos[:, None])
        y, _ = attn.decode_step(spec, slay, q[:, 0], k[:, 0], v[:, 0],
                                tr._layer_cache(cache.self_attn, i),
                                active=active)
        x = x + _out(lp["attn"], y)
        qc = _proj(lp["cross"]["wq"], rmsnorm(lp["pre_cross"], x))
        B, H, dh = qc.shape
        if spec.is_linear:
            qf = attn._features(spec, slay, qc)
            qg = qf.reshape(B, hkv, H // hkv, qf.shape[-1])
            s, z = cache.cross_s[i], cache.cross_z[i]
            num = torch.einsum("bkgm,bkmd->bkgd", qg, s)
            den = torch.einsum("bkgm,bkm->bkg", qg, z)
            yc = (num / (den[..., None] + 1e-6)).reshape(
                B, H, s.shape[-1]).to(x.dtype)
        else:
            kc = cache.cross_s[i].to(x.dtype)
            vc = cache.cross_z[i].to(x.dtype)
            logits = torch.einsum("bhd,bshd->bhs", qc, kc) / torch.sqrt(
                exact.const(dh, x))
            probs = torch.softmax(logits.float(), -1).to(x.dtype)
            yc = torch.einsum("bhs,bshd->bhd", probs, vc)
        x = x + _out(lp["cross"], yc)
        x = x + _mlp(cfg, lp, x)
    pos.add_(1 if active is None else active.to(torch.int32))
    x = rmsnorm(params["final_norm"], x)
    return unembed(params["embed"], x)[:, None, :], cache
