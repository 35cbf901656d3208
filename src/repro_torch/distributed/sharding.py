"""Logical-axis sharding rules onto DTensor placements, as
``repro.distributed.sharding``.

Model code annotates parameters and activations with *logical* axis names
(:func:`repro_torch.models.api.param_axes`, :func:`constrain`); this module
maps them to mesh axes:

    batch    -> (pod, data)      activations' batch dim (DP across pods too)
    embed    -> data             FSDP: params/opt-state sharded over data
    heads    -> model            TP over attention heads
    kv_heads -> model            TP over kv heads (falls back when Hkv < mesh)
    mlp      -> model            TP over FFN hidden
    vocab    -> model            TP over embedding/unembedding rows
    experts  -> model            EP over MoE experts
    layers   -> None             the stacked-layer axis, never sharded
    seq      -> None             SP off
    slots    -> data             serving slot-pool dim (DESIGN.md §8)

The fallback rule: a tensor dim that the mesh axes do not divide drops
its innermost mesh axis (replicates) rather than failing, and the drop is
logged, as in the reference.

The reference's GSPMD becomes SPMD over processes: one process per rank
under ``torch.distributed`` (NCCL on the card, gloo on the CPU), the
caller's process group, and a ``DeviceMesh`` from
:mod:`repro_torch.launch.mesh`. :func:`partition_spec` returns the
reference's ``PartitionSpec`` entries as a tuple; :func:`placements`
turns one into DTensor placements. The rule functions read only the
mesh's ``{axis: size}`` (a ``DeviceMesh``, or any object whose ``shape``
is that mapping), so one duck mesh serves this module and the reference.
Nothing here runs a collective unless a DTensor is given to it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None).

    The ``act_*`` entries govern *activation* constraints (:func:`constrain`
    inside the model forward):

        act_batch   batch dim of every activation          -> DP
        act_embed   residual-stream d_model dim            -> None (replicated)
        act_heads   per-head dims of q/k/v/attn-out        -> TP
        act_mlp     FFN hidden dim                         -> TP
        act_seq     sequence dim (sequence parallelism)    -> None

    Megatron-style defaults: residual replicated over `model`, heads/FFN
    sharded over `model`, so one all-reduce follows the attention-out and
    FFN-down contractions.
    """

    batch: tuple[str, ...] | str | None = ("pod", "data")
    embed: tuple[str, ...] | str | None = "data"
    heads: tuple[str, ...] | str | None = "model"
    kv_heads: tuple[str, ...] | str | None = "model"
    mlp: tuple[str, ...] | str | None = "model"
    vocab: tuple[str, ...] | str | None = "model"
    experts: tuple[str, ...] | str | None = "model"
    seq: tuple[str, ...] | str | None = None
    layers: tuple[str, ...] | str | None = None
    # Serving slot pool: the slot dim of the pooled decode cache and of the
    # engine's per-slot control vectors shards over `data` (DESIGN.md §8).
    slots: tuple[str, ...] | str | None = "data"
    act_batch: tuple[str, ...] | str | None = ("pod", "data")
    act_embed: tuple[str, ...] | str | None = None
    act_heads: tuple[str, ...] | str | None = "model"
    act_mlp: tuple[str, ...] | str | None = "model"
    act_seq: tuple[str, ...] | str | None = None
    act_vocab: tuple[str, ...] | str | None = "model"

    def lookup(self, logical: str | None):
        if logical is None:
            return None
        return getattr(self, logical)


DEFAULT_RULES = ShardingRules()


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` in mesh order, of a ``DeviceMesh`` or a duck mesh
    whose ``shape`` is that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _size(shape: dict, axes) -> int:
    return math.prod(shape[a] for a in axes)


# ---------------------------------------------------------------------------
# Activation-sharding context
# ---------------------------------------------------------------------------

_ACTIVATION_CTX: list = []   # stack of (mesh, rules)


class activation_sharding:
    """Context manager installing (mesh, rules) for :func:`constrain` calls
    inside model code. Without it (the single-device path) every
    ``constrain`` returns its input."""

    def __init__(self, mesh, rules: ShardingRules = DEFAULT_RULES):
        self.pair = (mesh, rules)
        self._implicit = None

    def __enter__(self):
        _ACTIVATION_CTX.append(self.pair)
        # A plain tensor met by a DTensor op inside the model (positions,
        # masks, constants) is a replicated value on every rank.
        self._implicit = implicit_replication()
        self._implicit.__enter__()
        return self

    def __exit__(self, *exc):
        self._implicit.__exit__(*exc)
        _ACTIVATION_CTX.pop()
        return False


def constrain(x, logical_axes: tuple):
    """Redistribute a DTensor activation to its logical axes' placements
    (the reference's ``with_sharding_constraint``). ``x`` comes back
    untouched outside an :class:`activation_sharding` context or when it
    is a plain tensor; a redistribution from ``Partial`` is the
    tensor-parallel all-reduce."""
    if not _ACTIVATION_CTX or not isinstance(x, DTensor):
        return x
    mesh, rules = _ACTIVATION_CTX[-1]
    spec = partition_spec(mesh, rules, tuple(x.shape), tuple(logical_axes))
    want = placements(x.device_mesh, spec, x.dim())
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _einsum_placements(eq: str, x, w) -> tuple:
    """Per mesh dim of a ``local_einsum``: (w's placement to compute with,
    the output's, x's gradient's, w's gradient's)."""
    lhs, out = eq.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    xl = xs.replace("...", "")
    lead = x.dim() - len(xl)
    ol = out.replace("...", "")
    plans = []
    for px, pw in zip(x.placements, w.placements):
        xc = (None if not isinstance(px, Shard)
              else "lead" if px.dim < lead else xl[px.dim - lead])
        wc = ws[pw.dim] if isinstance(pw, Shard) else None
        if xc == "lead" or (xc is not None and xc in ol):
            # x's rows (the batch) split here: the weight whole.
            at = px.dim if xc == "lead" else lead + ol.index(xc)
            plans.append((Replicate(), Shard(at), px, Partial()))
        elif xc is not None:
            # A contracted letter split on both sides: a partial sum.
            ww = Shard(ws.index(xc))
            plans.append((ww, Partial(), px, ww))
        elif wc is not None and wc in ol:
            # The weight's output columns (heads) split here.
            plans.append((pw, Shard(lead + ol.index(wc)), Partial(), pw))
        else:
            # The weight's contracted rows gathered (FSDP), or both whole.
            plans.append((Replicate(),) * 4)
    return tuple(zip(*plans))


def local_einsum(eq: str, x, w, *, force: bool = False):
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight
    ``w``, ``eq`` of the form ``"...xs,ws->...out"``.

    On DTensors where both are whole over some mesh axis of more than one
    rank (a weight whose heads fell back to replicated), or with
    ``force``, it runs on each rank's block through ``local_map``, with
    placements decided here: there DTensor's strategy search is free to
    split the flattened (heads x head dim) output over that axis, which
    the heads do not divide, and then fails to unflatten it. Per mesh
    dim: where x's batch is split the weight is gathered whole; where the
    weight's output columns are split the output is; a contracted dim
    split on both sides gives a partial sum; a weight split only on its
    contracted rows (FSDP) is gathered. A partial-sum x is summed first.
    Every other call is ``torch.einsum`` (DTensor's own rules)."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(placements=[
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])
    free = any(n > 1 and isinstance(px, Replicate)
               and isinstance(pw, Replicate)
               for n, px, pw in zip(x.device_mesh.shape, x.placements,
                                    w.placements))
    if not (free or force):
        return torch.einsum(eq, x, w)
    w_in, out, x_grad, w_grad = _einsum_placements(eq, x, w)
    return local_map(
        lambda xl, wl: torch.einsum(eq, xl, wl), out_placements=list(out),
        in_placements=(tuple(x.placements), w_in),
        in_grad_placements=(x_grad, w_grad), device_mesh=x.device_mesh,
        redistribute_inputs=True)(x, w)


def _mesh_axes_present(shape: dict, axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in shape)


def _axis_entry(axes: tuple[str, ...]):
    """Collapse an axis tuple to a spec entry."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def partition_spec(mesh, rules: ShardingRules, shape: tuple[int, ...],
                   logical_axes: tuple[str | None, ...],
                   fallback_log: list | None = None) -> tuple:
    """The reference's PartitionSpec entries (None, an axis or a tuple of
    axes per dim, trailing Nones dropped), honouring divisibility."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"rank mismatch: {shape} vs {logical_axes}")
    ms = mesh_shape(mesh)
    spec = []
    used: set[str] = set()
    for dim, logical in zip(shape, logical_axes):
        axes = _mesh_axes_present(ms, rules.lookup(logical))
        # Drop mesh axes already used by an earlier dim of this tensor.
        axes = tuple(a for a in axes if a not in used)
        while axes and dim % _size(ms, axes):
            dropped = axes[-1]
            axes = axes[:-1]
            if fallback_log is not None:
                fallback_log.append((logical, dim, dropped))
        used.update(axes)
        spec.append(_axis_entry(axes))
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def placements(mesh, spec: tuple, ndim: int) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dim named at
    tensor dim i is ``Shard(i)``, every other ``Replicate()``.

    A tuple entry such as ``("pod", "data")`` shards one dim over two mesh
    dims, the first major. DTensor splits a dim in mesh-dim order, so the
    two agree only when the tuple lists its axes in the mesh's order; any
    other order raises rather than give another block."""
    names = list(mesh_shape(mesh))
    where: dict[str, int] = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry} lists mesh axes out of the mesh's "
                f"order {tuple(names)}; DTensor would assign another block")
        for a in axes:
            where[a] = i
    if any(i >= ndim for i in where.values()):
        raise ValueError(f"spec {spec} has more dims than {ndim}")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def logical_to_sharding(mesh, rules: ShardingRules, abstract, axes,
                        fallback_log: list | None = None):
    """The tree of DTensor placements of a (nested-dict) parameter tree
    and its logical-axes tree; the leaves need only a ``shape``."""
    def one(x, ax):
        spec = partition_spec(mesh, rules, tuple(x.shape), tuple(ax),
                              fallback_log)
        return placements(mesh, spec, len(x.shape))
    return tree_map(one, abstract, axes)


def shard_params(mesh, rules: ShardingRules, params, axes):
    """DTensors of a realized parameter tree in the rules' placements,
    each scattered from rank 0's values (``src_data_rank=0``)."""
    sh = logical_to_sharding(mesh, rules, params, axes)
    return tree_map(lambda x, pl: distribute_tensor(x, mesh, pl,
                                                     src_data_rank=0),
                     params, sh)


def batch_spec(mesh, rules: ShardingRules = DEFAULT_RULES, *,
               batch_size: int | None = None) -> tuple:
    """The spec of (B, ...) input batches: batch dim over (pod, data).

    When ``batch_size`` is given, axes that do not divide it are dropped
    (innermost first): a global batch of 1 replicates."""
    ms = mesh_shape(mesh)
    axes = _mesh_axes_present(ms, rules.batch)
    if batch_size is not None:
        while axes and batch_size % _size(ms, axes):
            axes = axes[:-1]
    return (_axis_entry(axes),)


def batch_sharding(mesh, rules: ShardingRules = DEFAULT_RULES, *,
                   extra_rank: int = 1,
                   batch_size: int | None = None) -> tuple:
    """Placements of (B, ...) input batches (:func:`batch_spec`'s)."""
    return placements(mesh, batch_spec(mesh, rules, batch_size=batch_size),
                      1 + extra_rank)


def serving_param_rules(rules: ShardingRules = DEFAULT_RULES
                        ) -> ShardingRules:
    """Serving-time parameter rules: replicate over the slot axes.

    Training shards params over ``data`` (FSDP, ``embed -> data``); at
    decode the ``data`` axis carries slot parallelism instead, and an
    FSDP-sharded param tree would force a weight all-gather inside every
    decode tick. Serving therefore replicates params over the slot axes
    (keeping TP axes intact): the enabler of the §8 zero-collective decode
    loop.
    """
    slot_axes = rules.slots if isinstance(rules.slots, tuple) else \
        (rules.slots,) if rules.slots else ()

    def strip(entry):
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a not in slot_axes)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    # Strip the slot axes from every rule except `slots` itself, which is
    # the slot-pool sharding the engine resolves separately.
    return dataclasses.replace(rules, **{
        f.name: strip(getattr(rules, f.name))
        for f in dataclasses.fields(rules) if f.name != "slots"})


def pool_slot_axes(mesh, rules: ShardingRules, num_slots: int,
                   requested: int = 0,
                   fallback_log: list | None = None
                   ) -> tuple[tuple[str, ...], int]:
    """Resolve the mesh axes the serving slot pool shards over.

    ``requested`` is ``ServingConfig.slot_shards``: 0 = auto (the whole
    slot mesh axis, normally ``data``), 1 = force a single shard
    (replicate), N > 1 = demand exactly N-way sharding (raises if the mesh
    slot axes don't multiply to N: a config/mesh mismatch, not a
    fallback). Slot ownership is static and contiguous: shard k owns
    slots [k*S/N, (k+1)*S/N) for the engine's lifetime.

    Divisibility fallback: when ``num_slots`` is not divisible by the
    slot-axis size the axis is dropped (pool replicates) and the drop is
    recorded in ``fallback_log`` as ``("slots", num_slots, axis)``.

    Returns ``(axes, shard_count)``; ``axes`` is ``()`` when replicated.
    """
    ms = mesh_shape(mesh)
    axes = _mesh_axes_present(ms, rules.slots)
    size = _size(ms, axes)
    if requested > 1 and requested != size:
        raise ValueError(
            f"slot_shards={requested} but mesh slot axes {axes} have size "
            f"{size}; build the mesh to match (e.g. make_serving_mesh)")
    if requested == 1 or not axes or size == 1:
        return (), 1
    while axes and num_slots % size:
        dropped = axes[-1]
        axes = axes[:-1]
        size = _size(ms, axes)
        if fallback_log is not None:
            fallback_log.append(("slots", num_slots, dropped))
    return axes, size


def serving_cache_sharding(mesh, rules: ShardingRules, abstract, *,
                           num_slots: int | None = None,
                           num_pages: int | None = None,
                           slot_shards: int = 0,
                           fallback_log: list | None = None):
    """Slot-stable, slot-sharded placements of a pool cache's leaves,
    derived from their shapes only (never from which slots are live).

    The slot dim (dim 1 of every stacked ``(nl, S, ...)`` leaf, dim 0 of
    the ``(S,)`` ``pos``) shards over the slot axes, so each data shard
    owns a contiguous static block of slots; head-like dims (dim 3 of a
    ring, else dim 2) shard over ``heads``' axes when they divide. With
    ``num_pages`` the page dim of ``(nl, P, page, Hkv, dh)`` ring leaves
    shards over the slot axes too, and a ``pages`` PageState shards every
    child's leading dim (:func:`page_state_sharding`).
    """
    pstate = getattr(abstract, "pages", None)
    base = abstract._replace(pages=None) if pstate is not None else abstract
    if num_slots is None:
        num_slots = next((int(x.shape[1]) for x in tree_leaves(base)
                          if len(x.shape) >= 2), 1)
    ms = mesh_shape(mesh)
    saxes, _ = pool_slot_axes(mesh, rules, num_slots, slot_shards,
                              fallback_log)
    sax = _axis_entry(saxes)
    maxes = tuple(a for a in _mesh_axes_present(ms, rules.heads)
                  if a not in saxes)
    msize = _size(ms, maxes)
    mx = _axis_entry(maxes)

    def one(x):
        shape = tuple(x.shape)
        if len(shape) == 0:
            return placements(mesh, (), 0)
        if len(shape) == 1:           # per-slot pos vector
            return placements(mesh, (sax,) if shape[0] == num_slots else (),
                              1)
        spec: list = [None] * len(shape)
        if shape[1] == num_slots or (num_pages is not None
                                     and shape[1] == num_pages):
            spec[1] = sax
        for cand in (3, 2):
            if len(shape) > cand and shape[cand] % max(msize, 1) == 0 \
                    and msize > 1 and shape[cand] >= msize:
                spec[cand] = mx
                break
        return placements(mesh, tuple(spec), len(shape))

    tree = tree_map(one, base)
    if pstate is not None:
        tree = tree._replace(pages=page_state_sharding(mesh, sax, pstate))
    return tree


def page_state_sharding(mesh, sax, pstate):
    """Placements of a PageState: every child shards its leading dim over
    the slot axes (table rows are slots; owner vectors are pages,
    block-aligned with their owning shard)."""
    pl = placements(mesh, (sax,), 1)
    return type(pstate)(*([pl] * len(pstate)))


def serving_vector_sharding(mesh, rules: ShardingRules = DEFAULT_RULES, *,
                            num_slots: int, slot_shards: int = 0,
                            leading: int = 0,
                            fallback_log: list | None = None) -> tuple:
    """Placements of the engine's per-slot control vectors: ``(S,)``
    vectors, or ``(K, S)`` token/emitted buffers with ``leading=1``. They
    carry the pool's slot sharding (the same divisibility decision, from
    the same inputs), so each shard reads and writes only its own slots'
    control state."""
    saxes, _ = pool_slot_axes(mesh, rules, num_slots, slot_shards,
                              fallback_log)
    return placements(mesh, (*([None] * leading), _axis_entry(saxes)),
                      leading + 1)


def cache_sharding(mesh, rules: ShardingRules, abstract):
    """Decode caches: the batch dim (dim 1) over (pod, data), head-like
    dims heuristically over model. Layouts (stacked layers first):
    kv ring (nl, B, S, Hkv, dh); linear state (nl, B, Hkv, m, dv) /
    (nl, B, Hkv, m); ssm state (nl, B, nh, hd, ds), conv (nl, B, W-1, C).
    """
    ms = mesh_shape(mesh)
    baxes = _mesh_axes_present(ms, rules.batch)
    bsize = _size(ms, baxes)
    maxes = _mesh_axes_present(ms, rules.heads)
    msize = _size(ms, maxes)

    def one(x):
        shape = tuple(x.shape)
        if len(shape) <= 1:           # scalars, per-layer pos
            return placements(mesh, (), len(shape))
        spec: list = [None] * len(shape)
        if shape[1] % max(bsize, 1) == 0 and bsize > 1:
            spec[1] = _axis_entry(baxes)
        for cand in (3, 2):
            if len(shape) > cand and shape[cand] % max(msize, 1) == 0 \
                    and msize > 1 and shape[cand] >= msize:
                spec[cand] = _axis_entry(maxes)
                break
        return placements(mesh, tuple(spec), len(shape))

    return tree_map(one, abstract)


def place_cache(cache):
    """A freshly made decode cache (zeros) as DTensors in
    :func:`cache_sharding`'s placements under the active
    :class:`activation_sharding` context: each rank keeps its own block
    and nothing is sent. Unchanged outside a context."""
    if not _ACTIVATION_CTX:
        return cache
    mesh, rules = _ACTIVATION_CTX[-1]
    return tree_map(
        lambda x, pl: distribute_tensor(x, mesh, pl, src_data_rank=None),
        cache, cache_sharding(mesh, rules, cache))


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor (gathered), or ``x`` itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x
