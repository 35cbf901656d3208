"""The decoder LM (dense or top-k MoE, optionally behind a vision patch
prefix) and the SSM families: SLAY, a linear baseline (favor, cosformer,
elu1) or an exact kind, gemma2's local/global alternation (a
sliding-window softcapped softmax on every layer but each
``local_global_period``-th, which runs the config's kind), mamba2's
attention-free SSD layers (``family="ssm"``: ``x + ssd(rmsnorm(pre,
x))``, ``models/ssm.py``) and hymba's hybrid layers
(``family="hybrid"``: attention and an SSD block on the same normalised
input, averaged, then the MLP). internvl2's vision frontend is a stub,
as in the reference: ``patch_embeds`` (B, P, d), precomputed patch
embeddings, are concatenated ahead of the token embeddings, and the
prefix is one more run of rows to every path (``prefill_chunk(embeds=)``
feeds it chunk by chunk).

Parameters are a plain dict laid out like the JAX package's pytree, so
``repro_torch.convert`` moves weights across unchanged::

    embed (V, d), final_norm (d,), [unembed (V, d) if untied],
    layers: pre_attn (nl, d), pre_mlp (nl, d),
            attn: wq (nl, d, H, dh), wk/wv (nl, d, Hkv, dh), wo (nl, H, dh, d)
                  [, q_norm, k_norm (nl, dh) if qk_norm],
            mlp: up (nl, d, ff), down (nl, ff, d) [, gate (nl, d, ff)],
            or with E = moe_experts > 0, in place of mlp:
            moe: router (nl, d, E), gate/up (nl, E, d, ff), down (nl, E, ff, d),
            ssd: in_proj, conv_w, conv_b, a_log, dt_bias, d_skip, norm,
                 out_proj (``ssm.ssd_shapes``, nl leading; hybrid)
            or for an ssm config only pre (nl, d) and ssd,
    slay: anchors (P, dh), omegas (D, dh)   (fp32, shared by every layer;
                                             SLAY configs only)
          proj (64, dh)                     (fp32, favor's projection,
                                             under the same key)

Layers are stacked along a leading axis and run by a Python loop.
Training is ``loss_fn`` (next-token cross-entropy) under autograd, with
optional per-layer recomputation (``remat``): SLAY through its kernels'
backward, the linear baselines and the exact kinds (``softmax``, ``yat``,
``yat_spherical``) through plain autograd of PyTorch ops. Serving is
``prefill`` (prompt -> last-token logits + decode cache: (S, z) for the
linear kinds, KV rings for the exact kinds, optionally paged) then
``decode_step`` (one token, the cache updated in place); an exact kind
also verifies speculative drafts (``verify_chunk``, ``rollback_slots``).
A config with local layers keeps the reference's union cache: every
layer has rings of ``min(max_len, local_window)`` rows and, under a
linear kind, (S, z) too; each layer uses its kind's leaves and leaves
the others as they are. An SSM config's cache carries each layer's SSD
state (``DecodeCache.ssm``: the (nh, hd, ds) fp32 scan carry and the
(W-1, conv_dim) fp32 conv tail per slot), beside hybrid's attention
state; it is never paged, and it cannot be rewound, so neither family
verifies speculative drafts. The MoE aux loss is summed over layers into
``forward``'s second output; the serving paths drop it, as the
reference does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.baselines import favor_init
from repro_torch.core.features import init_feature_params
from repro_torch.core.slay import feature_dim
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain, local_einsum
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import embed, mlp, moe, rmsnorm, rope, unembed
from repro_torch.serving import pages as pg


def _param_shapes(cfg: ArchConfig) -> dict:
    """name -> (shape, init, scale); scale None = 1/sqrt(fan-in), where the
    fan-in is shape[-2] of the per-layer shape, as the JAX ParamSpec."""
    d, nl, dh = cfg.d_model, cfg.num_layers, cfg.resolved_head_dim
    H, Hkv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {
        "embed": ((cfg.vocab_size, d), "normal", 1.0),
        "final_norm": ((d,), "zeros", None),
    }
    if cfg.family != "ssm":
        shapes.update(_attn_mlp_shapes(cfg, d, nl, dh, H, Hkv, ff))
    else:
        shapes["layers.pre"] = ((nl, d), "zeros", None)
    if cfg.family in ("ssm", "hybrid"):
        for k, (shape, init, scale) in ssm.ssd_shapes(
                d, cfg.ssm_state, cfg.ssm_expand, cfg.ssm_head_dim,
                cfg.ssm_ngroups, cfg.ssm_conv_width).items():
            shapes[f"layers.ssd.{k}"] = ((nl, *shape), init, scale)
    if not cfg.tie_embeddings:
        shapes["unembed"] = ((cfg.vocab_size, d), "normal", 1.0)
    return shapes


def _attn_mlp_shapes(cfg: ArchConfig, d, nl, dh, H, Hkv, ff) -> dict:
    """The attention and MLP (or MoE) leaves of a decoder layer."""
    shapes = {
        "layers.pre_attn": ((nl, d), "zeros", None),
        "layers.pre_mlp": ((nl, d), "zeros", None),
        "layers.attn.wq": ((nl, d, H, dh), "normal", None),
        "layers.attn.wk": ((nl, d, Hkv, dh), "normal", None),
        "layers.attn.wv": ((nl, d, Hkv, dh), "normal", None),
        "layers.attn.wo": ((nl, H, dh, d), "normal", None),
    }
    if cfg.qk_norm:
        shapes["layers.attn.q_norm"] = ((nl, dh), "zeros", None)
        shapes["layers.attn.k_norm"] = ((nl, dh), "zeros", None)
    E = cfg.moe_experts
    if E:
        shapes["layers.moe.router"] = ((nl, d, E), "normal", None)
        shapes["layers.moe.gate"] = ((nl, E, d, ff), "normal", None)
        shapes["layers.moe.up"] = ((nl, E, d, ff), "normal", None)
        shapes["layers.moe.down"] = ((nl, E, ff, d), "normal", None)
    else:
        shapes["layers.mlp.up"] = ((nl, d, ff), "normal", None)
        shapes["layers.mlp.down"] = ((nl, ff, d), "normal", None)
        if cfg.gated_mlp:
            shapes["layers.mlp.gate"] = ((nl, d, ff), "normal", None)
    return shapes


# Each leaf's logical axes (``repro_torch.distributed.sharding``), as the
# reference's ParamSpecs name them; a stacked leaf adds "layers" ahead.
_LEAF_AXES = {
    "embed": ("vocab", "embed"), "unembed": ("vocab", "embed"),
    "final_norm": ("embed",), "enc_norm": ("embed",),
    "enc_pos": (None, "embed"), "pre": ("embed",), "pre_attn": ("embed",),
    "pre_mlp": ("embed",), "pre_cross": ("embed",),
    "attn.wq": ("embed", "heads", None), "attn.wk": ("embed", "kv_heads", None),
    "attn.wv": ("embed", "kv_heads", None), "attn.wo": ("heads", None, "embed"),
    "attn.q_norm": (None,), "attn.k_norm": (None,),
    "mlp.up": ("embed", "mlp"), "mlp.gate": ("embed", "mlp"),
    "mlp.down": ("mlp", "embed"), "moe.router": ("embed", None),
    "moe.gate": ("experts", "embed", "mlp"),
    "moe.up": ("experts", "embed", "mlp"),
    "moe.down": ("experts", "mlp", "embed"),
    "ssd.in_proj": ("embed", "mlp"), "ssd.conv_w": (None, "mlp"),
    "ssd.conv_b": ("mlp",), "ssd.a_log": (None,), "ssd.dt_bias": (None,),
    "ssd.d_skip": (None,), "ssd.norm": ("mlp",),
    "ssd.out_proj": ("mlp", "embed"),
}
_STACKS = ("layers", "enc_layers", "dec_layers")


def axes_tree(cfg: ArchConfig, shapes: dict) -> dict:
    """The logical-axes tree of the parameters ``shapes`` describes, with
    the random projections' (replicated) for a SLAY or favor config."""
    tree: dict = {}
    for name in shapes:
        head, _, rest = name.partition(".")
        if head in _STACKS:
            ax = ("layers", *_LEAF_AXES[rest.replace("cross.", "attn.")])
        else:
            ax = _LEAF_AXES[name]
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = ax
    if cfg.attn_kind == "slay":
        tree["slay"] = {"anchors": (None, None), "omegas": (None, None)}
    elif cfg.attn_kind == "favor":
        tree["slay"] = {"proj": (None, None)}
    return tree


def param_axes(cfg: ArchConfig) -> dict:
    """The logical-axes tree of :func:`init_params`' parameters, the
    reference's ``param_axes``."""
    cfg.check_supported()
    return axes_tree(cfg, _param_shapes(cfg))


def realize(shapes: dict, gen: torch.Generator, dev: torch.device,
            dtype: torch.dtype) -> dict:
    """The nested parameter dict of ``shapes`` (dotted name -> (shape,
    init, scale)), drawn in that order from ``gen`` on the CPU; on the
    ``meta`` device, shapes and dtypes only (nothing drawn)."""
    params: dict = {}
    for name, (shape, init, scale) in shapes.items():
        if dev.type == "meta":
            x = torch.empty(shape, device=dev, dtype=dtype)
        elif init == "zeros":
            x = torch.zeros(shape)
        elif init == "ones":
            x = torch.ones(shape)
        else:
            if scale is None:
                scale = 1.0 / np.sqrt(max(shape[-2] if len(shape) >= 2
                                          else shape[-1], 1))
            x = torch.randn(shape, generator=gen) * float(scale)
        node = params
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = x.to(device=dev, dtype=dtype)
    return params


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random weights from ``seed`` (a CPU ``torch.Generator``, so the same
    seed gives the same weights on any device), in the activation dtype;
    the random projections, drawn last and for SLAY and favor configs
    only, stay fp32 (so one seed gives every kind the same model
    weights). favor's sits under ``slay`` as in the JAX package, so
    checkpoints and prefix snapshots keep its format. mamba2 (no
    attention) draws none."""
    cfg.check_supported()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = realize(_param_shapes(cfg), gen, dev, cfg.activation_dtype)
    # Random projections, fp32, shared by every layer and head.
    if cfg.attn_kind == "slay":
        params["slay"] = init_feature_params(cfg.slay_config(), gen,
                                             device=dev)
    elif cfg.attn_kind == "favor":
        params["slay"] = favor_init(gen, cfg.resolved_head_dim, device=dev)
    return params


def _slay_params(params: dict, detach: bool = False):
    """The random projections (SLAY's anchors and omegas, favor's
    ``proj``), or None for a kind without them."""
    sp = params.get("slay")
    if sp is None or not detach:
        return sp
    return {k: v.detach() for k, v in sp.items()}


def _layer(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked ``layers`` subtree (views)."""
    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i]
                for k, v in node.items()}
    return take(params["layers"])


# Activation axes (``distributed.sharding.constrain``): per-head q/k/v and
# attention output, and the residual stream. A decode row (B, ...) has
# no sequence dim.
_AHEAD = ("act_batch", "act_seq", "act_heads", None)
_ARES = ("act_batch", "act_seq", "act_embed")


def act(x, axes: tuple):
    """``constrain`` by ``axes``, dropping the sequence entry for a row
    without a sequence dim; ``x`` itself on the unsharded path."""
    if x.dim() == len(axes) - 1:
        axes = axes[:1] + axes[2:]
    return constrain(x, axes)


# The collectives that remat="save_collectives" keeps: a layer's
# attention-out and MLP-down outputs after their tensor-parallel
# all-reduce (``act(..., _ARES)`` in :func:`_finish_layer`).
_COLLECTIVES = (torch.ops._c10d_functional.all_reduce.default,
                torch.ops._c10d_functional.wait_tensor.default)


def _save_collectives(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _COLLECTIVES
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(remat, fn, *args):
    """``fn(*args)``, recomputed in the backward pass under ``remat``:
    True recomputes everything (``torch.utils.checkpoint``);
    ``"save_collectives"`` keeps the outputs of the forward's
    all-reduces (the reference's ``attn_out`` and ``mlp_out``), so the
    recomputation runs no collective. Without a mesh there is no
    collective, and it is ``remat=True``."""
    if not remat:
        return fn(*args)
    if remat == "save_collectives":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_collectives))
    return checkpoint(fn, *args, use_reentrant=False)


def _qkv(cfg: ArchConfig, lp: dict, xa, positions):
    """q, k, v of one layer from its normalised input ``xa`` (``rmsnorm``
    by ``pre_attn``, which a hybrid layer's SSD block reads too): every
    path (forward, prefill, chunks, decode, verify) projects through
    here. qk-norm (qwen3) normalises q and k over the head dim before
    RoPE."""
    a = lp["attn"]
    q, k, v = (act(local_einsum("...d,dhk->...hk", xa, a[w]), _AHEAD)
               for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = rmsnorm(lp["attn"]["q_norm"], q)
        k = rmsnorm(lp["attn"]["k_norm"], k)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _layer_kinds(cfg: ArchConfig) -> np.ndarray:
    """Per-layer flag: 1 = local sliding-window softmax, 0 = the config's
    kind (every ``local_global_period``-th layer, counting from 1)."""
    if cfg.mixed_layers:
        idx = np.arange(cfg.num_layers)
        return (idx % cfg.local_global_period
                != cfg.local_global_period - 1).astype(np.int32)
    return np.zeros(cfg.num_layers, np.int32)


def _layer_specs(cfg: ArchConfig) -> list:
    """Each layer's AttentionSpec, local or global by :func:`_layer_kinds`;
    None for every layer of an ssm config (no attention)."""
    if cfg.family == "ssm":
        return [None] * cfg.num_layers
    return [cfg.attention_spec(local=bool(kind))
            for kind in _layer_kinds(cfg)]


def _ssd_kw(cfg: ArchConfig) -> dict:
    return dict(d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim, ngroups=cfg.ssm_ngroups,
                conv_width=cfg.ssm_conv_width)


def _finish_layer(cfg: ArchConfig, lp: dict, x, y, m=None):
    """Output projection, residual, MLP or MoE block: (x, the MoE aux
    loss, None for a dense MLP). A hybrid layer averages the attention
    output with its SSD block's ``m``, ``0.5 (a + m)``, before the
    residual. A decode row (B, d) routes as a sequence of one token per
    slot, as the reference does."""
    y = act(y, _AHEAD)
    a = act(local_einsum("...hk,hkd->...d", y, lp["attn"]["wo"]), _ARES)
    if m is not None:
        a = 0.5 * (a + m)
    x = x + a
    xm = rmsnorm(lp["pre_mlp"], x)
    if not cfg.moe_experts:
        return x + act(mlp(lp["mlp"], xm, cfg.gated_mlp), _ARES), None
    seq = xm if xm.dim() == 3 else xm[:, None, :]
    y2, aux = moe(lp["moe"], seq, cfg.moe_experts, cfg.moe_top_k)
    return x + act(y2.reshape(x.shape), _ARES), aux


def _logits(params: dict, cfg: ArchConfig, x):
    x = rmsnorm(params["final_norm"], x)
    table = params.get("unembed", params["embed"])
    return unembed(table, x, cfg.final_logit_softcap)


def _layer_fwd(cfg: ArchConfig, slay_params: dict, positions, spec,
               lp: dict, x):
    """One layer over the whole sequence: (x, its MoE aux, 0 if dense)."""
    zero = torch.zeros((), device=x.device)
    if spec is not None:
        x = act(x, _ARES)
    xn = rmsnorm(lp["pre" if spec is None else "pre_attn"], x)
    m = None
    if "ssd" in lp:
        m = ssm.ssd_forward(lp["ssd"], xn, chunk_size=cfg.chunk_size,
                            **_ssd_kw(cfg))
    if spec is None:                         # an ssm layer
        return x + m, zero
    q, k, v = _qkv(cfg, lp, xn, positions)
    y = attn.full_attention(spec, slay_params, q, k, v)
    x, aux = _finish_layer(cfg, lp, x, y, m)
    return x, zero if aux is None else aux


def _embed_rows(params: dict, cfg: ArchConfig, tokens, patch_embeds):
    """The input rows (B, P + L, d): the token embeddings behind the
    vision prefix ``patch_embeds`` (B, P, d) if given."""
    dev = params["embed"].device
    x = embed(params["embed"], tokens.to(dev)).to(cfg.activation_dtype)
    if patch_embeds is None:
        return x
    return torch.cat([patch_embeds.to(dev, x.dtype), x], dim=1)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            patch_embeds: torch.Tensor | None = None,
            remat: bool | str = False):
    """tokens (B, L) -> (logits (B, P + L, V), the MoE aux loss summed
    over layers, fp32; 0 for a dense MLP). ``patch_embeds`` (B, P, d), a
    vision prefix, comes ahead of the tokens (P = 0 without it).

    The random projections are constants of the model (``detach``, as
    ``stop_gradient`` in the JAX package); cosformer, elu1 and the exact
    kinds have none.
    ``remat=True`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations, so
    the attention forward (and an SSD block's scan) runs twice per
    layer; ``remat="save_collectives"`` keeps each layer's
    tensor-parallel all-reduce outputs (:func:`remat_call`).

    DTensor parameters and tokens (``distributed.sharding.shard_params``)
    under an ``activation_sharding`` context run the sharded forward:
    the activations are constrained at the reference's sites, the
    attention kernels run on each rank's block (``kernels.ops``).
    """
    cfg.check_supported()
    dev = params["embed"].device
    x = act(_embed_rows(params, cfg, tokens, patch_embeds), _ARES)
    L = x.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    slay_params = _slay_params(params, detach=True)
    layer = functools.partial(_layer_fwd, cfg, slay_params, positions)
    aux = torch.zeros((), device=dev)
    for i, spec in enumerate(_layer_specs(cfg)):
        x, a = remat_call(remat, layer, spec, _layer(params, i), x)
        aux = aux + a
    return act(_logits(params, cfg, x), ("act_batch", "act_seq",
                                         "act_vocab")), aux


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            remat: bool | str = False) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy: fp32 logits, logsumexp minus the gold
    logit, mean over tokens, + 0.01 x the MoE aux loss (0 for a dense
    MLP), reported as ``moe_aux``. With ``batch["patch_embeds"]`` (a
    vision prefix) only the text tail is scored."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          patch_embeds=batch.get("patch_embeds"),
                          remat=remat)
    labels = batch["labels"].to(logits.device).long()
    if logits.shape[1] != labels.shape[1]:   # vision prefix: text tail only
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = torch.mean(logz - gold_logits(logits, labels))
    total = nll + 0.01 * aux
    return total, {"nll": nll, "moe_aux": aux}


def gold_logits(logits, labels):
    """Each token's logit of its label. Under sharding the vocab dim is
    gathered first and the gather runs on each rank's own rows
    (``local_map``): DTensor's gather rules (a masked partial along a
    sharded dim, its scatter gradient) fail on some meshes and versions
    of PyTorch."""
    def pick(lg, lb):
        return torch.gather(lg, -1, lb[..., None])[..., 0]

    if not isinstance(logits, DTensor):
        return pick(logits, labels)
    logits = constrain(logits, ("act_batch", "act_seq", None))
    pl = tuple(logits.placements)
    if any(isinstance(p, Shard) and p.dim == 2 for p in pl):
        raise ValueError(f"logits sharded over the vocab: {pl}")
    return local_map(pick, out_placements=list(pl), in_placements=(pl, pl),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits, labels)


class DecodeCache(NamedTuple):
    """Stacked (num_layers leading) per-layer decode state; ``pos`` (B,)
    int32 counts the tokens each slot has seen.

    ``attn`` is the attention state (None for an ssm config), ``ssm`` the
    SSD state of an ssm or hybrid config (None otherwise): ``h`` (nl, B,
    nh, hd, ds) and ``conv`` (nl, B, W-1, conv_dim), both fp32. The
    fields come in the reference's order, so the leaves do too (mamba2
    ``ssm.h, ssm.conv, pos``; hymba under SLAY ``attn.pos, attn.s,
    attn.z, ssm.h, ssm.conv, pos``), and checkpoints and prefix snapshots
    keep the JAX format. Build it with keywords.

    ``pages`` is None except in a paged serving pool, where it holds a
    ``serving.pages.PageState`` and the ring leaves are page-indexed
    ``(nl, P, page, Hkv, dh)`` instead of ``(nl, S, kv_len, Hkv, dh)``.
    """

    attn: attn.AttnCache | None
    ssm: ssm.SsmState | None
    pos: torch.Tensor
    pages: pg.PageState | None = None


def _layer_cache(ac: attn.AttnCache, i: int) -> attn.AttnCache:
    """Layer i's views of a stacked AttnCache."""
    return attn.AttnCache(*(None if t is None else t[i] for t in ac))


def _layer_ssm(st: ssm.SsmState, i: int) -> ssm.SsmState:
    """Layer i's views of a stacked SsmState."""
    return ssm.SsmState(st.h[i], st.conv[i])


def _stack_ssm(states: list) -> ssm.SsmState | None:
    if not states:
        return None
    return ssm.SsmState(torch.stack([s.h for s in states]),
                        torch.stack([s.conv for s in states]))


def supports_paging(cfg: ArchConfig) -> bool:
    """Whether the pooled rings can be paged: a non-windowed exact
    quadratic ring, the one state whose per-slot size grows with the
    context. A linear kind's (S, z) and an SSM carry are O(1) per slot
    and bypass paging (a hybrid config's rings too, as in the
    reference); windowed rings are bounded by the window and wrap in
    place. A frontend config's rings are not paged either, as in the
    reference."""
    cfg.check_supported()
    if cfg.family in ("ssm", "hybrid") or cfg.local_window or cfg.frontend:
        return False
    return not cfg.attention_spec().is_linear


def context_capacity(cfg: ArchConfig, max_len: int) -> int | None:
    """Context rows (prompt + decode budget) one slot admits: None
    (unbounded) for an ssm config and a linear kind, whose constant-size
    state holds any context, and for windowed rings, which wrap exactly;
    ``max_len`` for an exact kind's ring (hybrid's included), which
    would overwrite live context past it."""
    cfg.check_supported()
    if cfg.family == "ssm":
        return None
    if cfg.attention_spec().is_linear or cfg.local_window:
        return None
    return max_len


def supports_masked_prefill(cfg: ArchConfig) -> bool:
    """Whether ``prefill`` takes ``true_len`` (right-padded prompts):
    not with windowed rings, where a pad row would evict in-window
    history, nor with an SSM carry, which decays through pad steps."""
    cfg.check_supported()
    return cfg.family not in ("ssm", "hybrid") and not cfg.local_window


def _needs_rings(cfg: ArchConfig) -> bool:
    if cfg.family == "ssm":
        return False
    return cfg.mixed_layers or not cfg.attention_spec().is_linear


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               page_size: int = 0, num_pages: int = 0,
               device: str | torch.device = "cuda") -> DecodeCache:
    """A zero cache for ``batch`` slots. A linear kind: constant-size
    (S, z), and ``max_len`` is unused. The exact kinds: rings of
    ``max_len`` rows; with
    ``page_size`` > 0, ``num_pages`` (0: ``batch * max_len / page_size``)
    physical pages shared by all slots, and an all-free PageState.
    With ``local_window`` set every layer's rings have ``min(max_len,
    local_window)`` rows (the reference's union layout, global layers
    included), beside a linear kind's (S, z) on every layer when the
    layers are mixed; they are never paged. An ssm config has only the
    SSD state, a hybrid one both (its rings never paged)."""
    cfg.check_supported()
    dev = resolve_device(device)
    pos = torch.zeros(batch, dtype=torch.int32, device=dev)
    st = None
    if cfg.family in ("ssm", "hybrid"):
        st = ssm.ssd_init_state((cfg.num_layers, batch), cfg.d_model,
                                device=dev, **_ssd_kw(cfg))
    a, pages = (None, None) if cfg.family == "ssm" else _init_attn(
        cfg, batch, max_len, page_size, num_pages, dev)
    return DecodeCache(attn=a, ssm=st, pos=pos, pages=pages)


def _init_attn(cfg: ArchConfig, batch: int, max_len: int, page_size: int,
               num_pages: int, dev: torch.device):
    """:func:`init_cache`'s attention state: (the AttnCache, a paged
    pool's all-free PageState or None)."""
    spec = cfg.attention_spec()
    nl, dh, hkv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    if _needs_rings(cfg) and max_len < 1:
        raise ValueError(f"{cfg.name}'s KV rings need max_len >= 1, got "
                         f"{max_len}")
    if page_size > 0 and supports_paging(cfg):
        if max_len % page_size:
            raise ValueError(
                f"page_size={page_size} must divide max_len={max_len}")
        lp = max_len // page_size
        P = num_pages if num_pages else batch * lp
        shape = (nl, P, page_size, hkv, dh)
        dt = cfg.activation_dtype
        a = attn.AttnCache(
            torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(nl, batch, dtype=torch.int32, device=dev), None, None)
        return a, pg.init_state(batch, P, lp, device=dev)
    if not cfg.mixed_layers:
        size = min(max_len, cfg.local_window) if cfg.local_window else max_len
        return attn.init_cache(spec, (nl, batch), hkv, dh, dh, size,
                               cfg.activation_dtype, device=dev), None
    # Mixed local/global layers: the union of both kinds' leaves.
    kv_len = min(max_len, cfg.local_window)
    ring = (nl, batch, kv_len, hkv, dh)
    s = z = None
    if spec.is_linear:
        m = feature_dim(spec, dh)
        s = torch.zeros(nl, batch, hkv, m, dh, device=dev)
        z = torch.zeros(nl, batch, hkv, m, device=dev)
    return attn.AttnCache(
        torch.zeros(ring, dtype=cfg.activation_dtype, device=dev),
        torch.zeros(ring, dtype=cfg.activation_dtype, device=dev),
        torch.zeros(nl, batch, dtype=torch.int32, device=dev), s, z), None


def _stack_caches(ac: attn.AttnCache | None, caches: list):
    """One stacked AttnCache from per-layer results over the stacked
    cache ``ac`` they continued (None: a linear kind's prefill, which
    starts from nothing). The rings are ``ac``'s, written in place; a
    linear layer's new (S, z) are stacked, and a local layer's unused
    (S, z) taken from ``ac`` as they were. None for an ssm config (no
    layer attends)."""
    if not caches:
        return None

    def state(name):
        own = None if ac is None else getattr(ac, name)
        rows = [getattr(c, name) for c in caches]
        if own is None and rows[0] is None:
            return None
        return torch.stack([own[i] if r is None else r
                            for i, r in enumerate(rows)])

    pos = torch.stack([c.pos for c in caches])
    if ac is None:
        return attn.AttnCache(None, None, pos, state("s"), state("z"))
    return attn.AttnCache(ac.k, ac.v, pos, state("s"), state("z"))


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            patch_embeds: torch.Tensor | None = None,
            max_len: int | None = None, true_len: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Process a prompt batch; return last-token logits (B, 1, V) and a
    primed cache. ``patch_embeds`` (B, P, d), a vision prefix, comes
    ahead of the tokens. ``max_len`` sizes an exact kind's rings
    (default: the prefix and prompt + 64 rows of decode headroom, as the
    JAX package); a linear kind's state does not depend on it.
    ``true_len`` (B,) marks the real lengths of right-padded prompts,
    prefix rows included: logits are read at ``true_len - 1`` and pad
    positions add nothing to the cache (not with windowed rings or an
    SSM carry, :func:`supports_masked_prefill`).

    An SSD block absorbs the prompt as one chunk from the zero state
    (``ssm.ssd_prefill_chunk``): one scan gives its rows and its final
    carry, which agrees with the reference's separate
    ``_ssd_prefill_state`` (the same sums in another order) and, for a
    prompt shorter than the conv's W-1 = 3 rows, with the reference's
    ``prefill_chunk`` from a zero cache, where its ``prefill`` raises
    (ROADMAP C-11)."""
    cfg.check_supported()
    if true_len is not None and not supports_masked_prefill(cfg):
        raise NotImplementedError(
            f"true_len-masked prefill unsupported for {cfg.name} "
            f"(family={cfg.family}, local_window={cfg.local_window})")
    dev = params["embed"].device
    x = _embed_rows(params, cfg, tokens, patch_embeds)
    B, L = x.shape[:2]
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    valid = None
    if true_len is not None:
        true_len = true_len.to(dev)
        valid = positions < true_len[:, None]
    slay = _slay_params(params)
    ring = None if not _needs_rings(cfg) else init_cache(
        cfg, B, max_len if max_len else L + 64, device=dev).attn
    if ring is not None and isinstance(x, DTensor):
        ring = shd.place_cache(ring)     # the rings of a sharded prefill
    st0 = None
    if cfg.family in ("ssm", "hybrid"):
        st0 = ssm.ssd_init_state((B,), cfg.d_model, device=dev,
                                 **_ssd_kw(cfg))
    caches, states = [], []
    for i, spec in enumerate(_layer_specs(cfg)):
        lp = _layer(params, i)
        if spec is not None:
            x = act(x, _ARES)
        xn = rmsnorm(lp["pre" if spec is None else "pre_attn"], x)
        m = None
        if st0 is not None:
            m, st = ssm.ssd_prefill_chunk(lp["ssd"], xn, st0,
                                          chunk_size=cfg.chunk_size,
                                          **_ssd_kw(cfg))
            states.append(st)
        if spec is None:                     # an ssm layer
            x = x + m
            continue
        q, k, v = _qkv(cfg, lp, xn, positions)
        y = attn.full_attention(spec, slay, q, k, v)
        caches.append(attn.prefill_cache(
            spec, slay, k, v, None if ring is None else _layer_cache(ring, i),
            valid))
        x, _ = _finish_layer(cfg, lp, x, y, m)
    if true_len is None:
        x_last = x[:, -1]
        pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    else:
        idx = torch.clamp(true_len - 1, min=0).long()
        x_last = x[torch.arange(B, device=dev), idx]
        pos = true_len.to(torch.int32, copy=True)   # decode advances it
    return _logits(params, cfg, x_last)[:, None, :], DecodeCache(
        attn=_stack_caches(ring, caches), ssm=_stack_ssm(states), pos=pos)


def _write_ssm(dst: ssm.SsmState, new: ssm.SsmState, act) -> None:
    """Copy a layer's new SSD state into the cache's own tensors; with
    ``act`` (B,) bool a drained slot keeps its bytes (the reference's
    ``_state_passthrough``). The new tail is a fresh tensor, so the
    one-row shift never copies a tensor onto itself."""
    for d, n in zip(dst, new):
        if act is not None:
            n = torch.where(act.reshape(-1, *(1,) * (n.dim() - 1)), n, d)
        d.copy_(n)


def decode_step(params: dict, cfg: ArchConfig, cache: DecodeCache,
                tokens: torch.Tensor, active: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step. tokens (B, 1) -> logits (B, 1, V).

    The cache is updated in place (the JAX package donates it) and
    returned: every layer's state (a linear kind's (S, z), a ring's new
    row, an SSD block's carry and conv tail), positions and ``pos``. So
    a slot pool is one set of tensors for its whole life, which a
    captured CUDA graph of the step can bind, and nothing in the step
    syncs the host. ``active`` (B,) freezes drained slots: their state
    stays bit-identical, their SSD output is zero (as the reference's)
    and their logits rows are meaningless.

    A paged pool gathers each layer's pages into the dense ring, runs the
    unchanged ring update on it and scatters the owned pages back.
    """
    cfg.check_supported()
    dev = params["embed"].device
    x = constrain(embed(params["embed"], tokens.to(dev)[:, 0]),
                  ("act_batch", "act_embed")).to(cfg.activation_dtype)
    pos = cache.pos
    slay = _slay_params(params)
    ac = cache.attn
    act = None if active is None else active.bool()
    for i, spec in enumerate(_layer_specs(cfg)):
        lp = _layer(params, i)
        xn = rmsnorm(lp["pre" if spec is None else "pre_attn"], x)
        m = None
        if cache.ssm is not None:
            lst = _layer_ssm(cache.ssm, i)
            m, st = ssm.ssd_decode_step(lp["ssd"], xn, lst, **_ssd_kw(cfg))
            _write_ssm(lst, st, act)
            if act is not None:
                m = torch.where(act[:, None], m, 0)
        if spec is None:                     # an ssm layer
            x = x + m
            continue
        q, k, v = _qkv(cfg, lp, xn[:, None], pos[:, None])
        lc = _layer_cache(ac, i)
        if cache.pages is not None:
            lc = lc._replace(k=pg.gather_ring(lc.k, cache.pages),
                             v=pg.gather_ring(lc.v, cache.pages))
        y, nc = attn.decode_step(spec, slay, q[:, 0], k[:, 0], v[:, 0], lc,
                                 active=active)
        if cache.pages is not None:
            pg.scatter_ring_(ac.k[i], nc.k, cache.pages)
            pg.scatter_ring_(ac.v[i], nc.v, cache.pages)
        x, _ = _finish_layer(cfg, lp, x, y, m)
    pos.add_(1 if active is None else active.to(torch.int32))
    return _logits(params, cfg, x)[:, None, :], cache


# -- the slot surface of a pooled cache (continuous batching) -------------
#
# A pool is an ordinary init_cache(cfg, num_slots); slots are batch rows.
# The decode step updates the pool in place, so every slot op below
# writes into the pool's own storage (copy_, zero_, fill_, where(out=))
# on slot ``slot`` of every layer and returns the same cache: a new
# tensor would leave the next decode writing into a stale buffer. Other
# slots' bytes are untouched (the reference's slot-stable contract). A
# paged pool's ops take the host allocator's PageState as ``pages`` and
# copy it into the pool's page tables.


def _chunk_layers(params: dict, cfg: ArchConfig, cache: DecodeCache,
                  tokens: torch.Tensor | None, active=None, embeds=None):
    """The layers over a chunk of tokens (B, Lc), or of pre-embedded rows
    ``embeds`` (B, Lc, d) in their place, that continues ``cache``:
    the final hidden rows (B, Lc, d), each layer's new AttnCache and
    each layer's new SsmState. A ring is written in place (a paged
    pool's through its gathered dense view, scattered back); a linear
    kind's (S, z) and an SSD state come back as new tensors. An SSD
    block scans in tiles of ``max(min(chunk_size, Lc), 1)`` (the
    continuation is exact for any tile), as the reference does.
    ``active`` masks slots as in :func:`decode_step` (the exact kinds'
    verify chunk only)."""
    dev = params["embed"].device
    if embeds is not None:
        x = embeds.to(dev, cfg.activation_dtype)
    else:
        x = embed(params["embed"], tokens.to(dev)).to(cfg.activation_dtype)
    Lc = x.shape[1]
    positions = (cache.pos[:, None]
                 + torch.arange(Lc, dtype=torch.int32, device=dev)[None, :])
    slay = _slay_params(params)
    ac = cache.attn
    tile = max(min(cfg.chunk_size, Lc), 1)
    caches, states = [], []
    for i, spec in enumerate(_layer_specs(cfg)):
        lp = _layer(params, i)
        xn = rmsnorm(lp["pre" if spec is None else "pre_attn"], x)
        m = None
        if cache.ssm is not None:
            m, st = ssm.ssd_prefill_chunk(lp["ssd"], xn,
                                          _layer_ssm(cache.ssm, i),
                                          chunk_size=tile, **_ssd_kw(cfg))
            states.append(st)
        if spec is None:                     # an ssm layer
            x = x + m
            continue
        q, k, v = _qkv(cfg, lp, xn, positions)
        lc = _layer_cache(ac, i)
        if cache.pages is not None:
            lc = lc._replace(k=pg.gather_ring(lc.k, cache.pages),
                             v=pg.gather_ring(lc.v, cache.pages))
        y, nc = attn.prefill_chunk(spec, slay, q, k, v, lc, active=active)
        if cache.pages is not None:
            pg.scatter_ring_(ac.k[i], nc.k, cache.pages)
            pg.scatter_ring_(ac.v[i], nc.v, cache.pages)
        caches.append(nc)
        x, _ = _finish_layer(cfg, lp, x, y, m)
    return x, caches, states


def prefill_chunk(params: dict, cfg: ArchConfig, cache: DecodeCache,
                  tokens: torch.Tensor | None, *,
                  embeds: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, DecodeCache]:
    """Absorb one prompt chunk into an existing decode cache.

    tokens (B, Lc); ``cache`` holds the state of the prefix absorbed so
    far (per-slot ``pos``). Returns last-token logits (B, 1, V) and the
    advanced cache, so a prompt fed chunk by chunk ends in the state of a
    whole-prompt :func:`prefill` (a linear kind and an SSD block: the
    fp32 recurrence in another order of sums) and the engine can
    interleave prefill chunks with decode ticks. A linear kind and an
    SSD block return new tensors; the rings of an exact kind are written
    in place (the positions are new tensors).

    ``embeds`` (B, Lc, d) feeds pre-embedded rows in place of token ids
    (``tokens`` is then ignored): how a vision patch prefix is absorbed
    chunk by chunk. The continuation follows the positions, so prefix
    chunks and token chunks interleave exactly.
    """
    cfg.check_supported()
    x, caches, states = _chunk_layers(params, cfg, cache, tokens,
                                      embeds=embeds)
    return (_logits(params, cfg, x[:, -1])[:, None, :],
            DecodeCache(attn=_stack_caches(cache.attn, caches),
                        ssm=_stack_ssm(states),
                        pos=cache.pos + x.shape[1], pages=cache.pages))


# -- the speculative verifier (draft-verify decoding) ----------------------


def supports_speculative(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` can verify draft-verify speculative decoding: an
    exact kind's non-windowed ring, where rejecting a suffix is a
    per-slot ``pos`` rewind. A linear kind folds a token into (S, z) for
    good, an SSD carry (ssm, hybrid) cannot un-absorb a step, and a
    windowed ring's in-window eviction cannot be rewound, so none of
    them can. A frontend config cannot either: the draft swap must
    leave the parameter tree as it is, as the reference requires. An MoE
    config verifies like a dense one; each verify chunk routes with that
    chunk's capacity."""
    cfg.check_supported()
    if cfg.family in ("ssm", "hybrid") or cfg.frontend:
        return False
    if cfg.local_window or cfg.local_global_period:
        return False
    return not cfg.attention_spec().is_linear


def verify_chunk(params: dict, cfg: ArchConfig, cache: DecodeCache,
                 tokens: torch.Tensor, active: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, DecodeCache]:
    """Score a block of candidate tokens: tokens (B, Lc) -> logits
    (B, Lc, V), row j the verifier's next-token logits after absorbing
    tokens[:, :j + 1] on top of the cached prefix.

    :func:`prefill_chunk`'s continuation, with every row's logits, masked
    per slot as :func:`decode_step` is (a drained slot's ring rows keep
    their bytes and its ``pos`` stays), and the cache updated in place
    (rings, a paged pool's pages, both positions) and returned. The
    caller rewinds to the accept horizon with :func:`rollback_slots`.
    """
    if not supports_speculative(cfg):
        raise ValueError(f"verify_chunk needs an exact kind's ring, not "
                         f"attn_kind={cfg.attn_kind!r}, family="
                         f"{cfg.family!r}")
    x, _, _ = _chunk_layers(params, cfg, cache, tokens, active)
    Lc = tokens.shape[1]
    step = Lc if active is None else Lc * active.to(torch.int32)
    cache.attn.pos.add_(step)
    cache.pos.add_(step)
    return _logits(params, cfg, x), cache


def rollback_slots(cfg: ArchConfig, cache: DecodeCache,
                   new_pos: torch.Tensor) -> DecodeCache:
    """Rewind each slot's horizon to ``new_pos`` (B,), in place. A ring's
    validity follows ``pos`` alone, so rejecting a speculative suffix
    moves no ring bytes (rows past the horizon are invisible and are
    overwritten by the next absorb), and a paged pool's tables stay (the
    slot's pages cover its context plus the verify overshoot). An SSD
    state is left as it is."""
    cache.pos.copy_(new_pos)
    if cache.attn is not None:
        cache.attn.pos.copy_(new_pos[None].expand_as(cache.attn.pos))
    return cache


def _float_leaves(cache: DecodeCache) -> list:
    """The float state leaves, (nl, B, ...): rings, (S, z), SSD state."""
    a = cache.attn
    out = [] if a is None else [t for t in (a.k, a.v, a.s, a.z)
                                if t is not None]
    return out + ([] if cache.ssm is None else list(cache.ssm))


def reset_slot(cfg: ArchConfig, cache: DecodeCache, slot: int,
               pages=None) -> DecodeCache:
    """Zero one slot of a pooled cache (eviction), in place: its state
    and positions. A linear kind: a single overwrite of the slot's (S,
    z); an SSD block's carry and tail likewise. A paged pool zeroes the
    pages the slot owns under the current tables (so a quarantined NaN
    never reaches the page's next owner), then installs ``pages``, the
    host allocator's tables after the slot's free."""
    a = cache.attn
    if cache.pages is not None:
        for t in (a.k, a.v):
            pg.write_zero_pages(t, slot, cache.pages)
        if pages is not None:
            pg.install(cache.pages, pages)
    else:
        for t in _float_leaves(cache):
            t[:, slot].zero_()
    if a is not None:
        a.pos[:, slot] = 0
    cache.pos[slot] = 0
    return cache


def write_slot(cfg: ArchConfig, cache: DecodeCache, src: DecodeCache,
               slot: int, pages=None) -> DecodeCache:
    """Install a single-sequence cache (batch 1, e.g. a freshly prefilled
    request) into slot ``slot`` of a pooled cache (admission), in place.
    A paged pool first installs ``pages`` (the tables after the slot's
    allocation), then overwrites every page the slot owns from the dense
    source ring."""
    a, b = cache.attn, src.attn
    if cache.pages is not None:
        if pages is not None:
            pg.install(cache.pages, pages)
        pg.write_slot_pages(a.k, b.k, slot, cache.pages)
        pg.write_slot_pages(a.v, b.v, slot, cache.pages)
    else:
        for dst, s in zip(_float_leaves(cache), _float_leaves(src)):
            dst[:, slot].copy_(s[:, 0])
    if a is not None:
        a.pos[:, slot].copy_(b.pos[:, 0])
    cache.pos[slot] = src.pos[0]
    return cache


def slot_state_finite(cfg: ArchConfig, cache: DecodeCache) -> torch.Tensor:
    """(B,) bool: every float decode-state element of each slot, over all
    layers, is finite (the NaN/Inf quarantine probe): rings, (S, z) and
    the SSD carry and tail. Per-slot reductions only; positions are
    integers and are skipped. A paged pool checks the pages each slot
    owns: a free page's stale bytes blame no slot."""
    if cache.pages is not None:
        return pg.pages_finite([cache.attn.k, cache.attn.v], cache.pages,
                               cache.pos.shape[0])
    ok = None
    for leaf in _float_leaves(cache):
        f = pg.rows_finite(leaf).all(0)
        ok = f if ok is None else ok & f
    return ok


def corrupt_slot(cfg: ArchConfig, cache: DecodeCache, slot: int) -> DecodeCache:
    """Overwrite one slot's float state with NaN, in place (the chaos
    harness's fault; never on a production path). Positions stay, so the
    fault is numeric, not bookkeeping."""
    if cache.pages is not None:
        for t in (cache.attn.k, cache.attn.v):
            pg.corrupt_slot_pages(t, slot, cache.pages)
        return cache
    for t in _float_leaves(cache):
        t[:, slot].fill_(float("nan"))
    return cache


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    """Chunked prefill continues every decoder-only config: the linear
    kinds' fp32 (S, z) recurrence, the exact kinds' ring prefix plus
    causal chunk, an SSD block's fp32 carry and conv tail; a vision patch
    prefix through ``prefill_chunk(embeds=)``. (encdec is
    ``whisper.supports_chunked_prefill``'s.)"""
    cfg.check_supported()
    return True
