"""Per-device cost counter of a PyTorch step: FLOPs, HBM bytes and
collective wire bytes, the counterpart of ``repro/launch/hlo_cost.py``.

The reference parses the compiled per-device SPMD program (XLA's HLO).
Here :class:`CostCounter`, a ``TorchDispatchMode``, counts the ops that
one rank's program dispatches. It declines every DTensor op
(``NotImplemented``), so DTensor's own dispatch runs, and it then sees
the local ops each rank runs on its block and the ``_c10d_functional``
collectives of every redistribution: per device, as the reference's
per-device program. On the ``meta`` device (``launch.dryrun``) nothing
is computed or allocated; each SLAY kernel's meta branch names its
launch and shape (``kernels._build.record_meta``), and
:data:`KERNEL_COUNTS` reads its work from ``launch.roofline``'s count
functions. Ops on DTensor's FakeTensors (its shape propagation) are not
counted.

* ``flops``: ``torch.utils.flop_counter``'s registered formula on the
  local shapes (2·M·N·K per ``mm``, ``bmm``, ``addmm``, ``baddbmm``;
  convolutions likewise), plus each kernel's operations from
  ``launch.roofline``'s count functions. Elementwise FLOPs are excluded,
  as in the reference.
* ``hbm_bytes``: the reference's heavy ops only (``hlo_cost.py:10-21``):
  dot and convolution operands plus output; collectives in plus out;
  reductions in plus out; gathers (``index_select``, ``embedding``,
  ``gather``, ``index``) twice their output; scatters (``index_put``,
  ``index_copy``, ``scatter``, ``index_add``, the embedding's backward)
  twice their update; plus each kernel's bytes.
* ``eager_bytes``: every op's operands and output (views and bare
  allocations move nothing) plus the kernels' bytes. Eager PyTorch fuses
  nothing, so this is what it moves; it does not feed ``Roofline``.
* ``coll_wire_bytes``: the reference's ring factors, G the size of the
  group the op names:

      all-gather       (G-1)/G · out_bytes
      reduce-scatter   (G-1)/G · in_bytes
      all-reduce       2(G-1)/G · in_bytes
      all-to-all       (G-1)/G · in_bytes

* memory: the bytes of every storage allocated inside the counter, from
  its allocation to its release (a weak reference on the storage; views
  share their base's storage and count once), and the most that were
  live at once (``peak_bytes``). A recomputation under
  ``torch.utils.checkpoint`` runs inside the backward and is seen there.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.launch import roofline as rl

aten = torch.ops.aten

_DOTS = frozenset({aten.mm, aten.addmm, aten.bmm, aten.baddbmm,
                   aten.convolution, aten._convolution,
                   aten.convolution_backward})
_REDUCTIONS = frozenset({
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.argmax, aten.argmin, aten.prod, aten.var, aten.var_mean,
    aten.std, aten.std_mean, aten.linalg_vector_norm, aten.norm,
    aten.logsumexp, aten.cumsum, aten.cumprod, aten._softmax,
    aten._log_softmax, aten._softmax_backward_data,
    aten._log_softmax_backward_data, aten.sort, aten.topk, aten.any,
    aten.all})
_GATHERS = frozenset({aten.index_select, aten.embedding, aten.gather,
                      aten.index})
# Scatters: the argument position of the update they write.
_SCATTERS = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
             aten.index_copy: 3, aten.index_copy_: 3, aten.scatter: 3,
             aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
             aten.index_add: 3, aten.index_add_: 3,
             aten.embedding_dense_backward: 0}
# Ops that allocate and write nothing (no traffic).
_ALLOCS = frozenset({aten.empty, aten.empty_strided, aten.empty_like,
                     aten.new_empty, aten.new_empty_strided})
# _c10d_functional op -> the reference's kind.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(*items) -> list:
    """The tensors among ``items`` and in their lists and tuples (an op's
    arguments and outputs nest no deeper)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def group_size(group) -> int:
    """The size of the process group a collective names (its name, or
    the group itself)."""
    if isinstance(group, str):
        group = dist.distributed_c10d._resolve_process_group(group)
    return group.size()


def wire_bytes(kind: str, g: int, in_bytes: int, out_bytes: int) -> float:
    """Bytes one device moves for a collective of ``kind`` over a group of
    ``g`` (the ring factors of the module docstring)."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        return frac * out_bytes
    if kind == "all-reduce":
        return 2.0 * frac * in_bytes
    return frac * in_bytes


@dataclasses.dataclass
class CostTotals:
    """The reference's fields (``hlo_cost.py:221``), plus ``eager_bytes``
    and ``kernels`` ({name: {"launches", "flops", "bytes"}})."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    dot_flops_by_meta: dict = dataclasses.field(default_factory=dict)
    eager_bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "CostTotals", scale: float = 1.0):
        self.flops += other.flops * scale
        self.hbm_bytes += other.hbm_bytes * scale
        self.coll_wire_bytes += other.coll_wire_bytes * scale
        self.eager_bytes += other.eager_bytes * scale
        for mine, theirs in ((self.coll_by_kind, other.coll_by_kind),
                             (self.dot_flops_by_meta,
                              other.dot_flops_by_meta)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + v * scale
        for name, rec in other.kernels.items():
            mine = self.kernels.setdefault(
                name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            for k in mine:
                mine[k] += rec[k] * scale
            mine["launches"] = round(mine["launches"])
        return self


def _site() -> str:
    """Where a dot was called: the innermost model or core function on the
    Python stack (a recomputed forward under checkpoint included), else
    the autograd node running it (a backward), else ``"?"``."""
    f = sys._getframe(3)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith(("repro_torch.models", "repro_torch.core")):
            return f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
        f = f.f_back
    node = torch._C._current_autograd_node()
    return f"backward {node.name()}" if node is not None else "?"


class LocalOpMode(TorchDispatchMode):
    """A dispatch mode that sees the ops one rank runs: it declines
    DTensor ops (``NotImplemented``), so DTensor's dispatch runs and the
    mode sees its local ops and collectives, and it passes over the ops
    of DTensor's shape propagation (FakeTensors). Each other op goes to
    :meth:`on_op`. It tracks the storages the ops allocate: the bytes
    live (:attr:`live_bytes`, a weak reference on each storage gives its
    release), the most live at once (:attr:`peak_bytes`) and each
    allocation's size (:attr:`allocations`); a view shares its base's
    storage and counts once, an input's storage not at all."""

    def __init__(self):
        super().__init__()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.allocations: list[int] = []
        self._live: dict[int, tuple] = {}

    def on_op(self, func, args, kwargs, out, ins, outs) -> None:
        """Called with every local op, its inputs and outputs."""

    def allocated(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was allocated under this mode and is
        still live."""
        return id(t.untyped_storage()) in self._live

    def _freed(self, key: int) -> None:
        _, nbytes = self._live.pop(key, (None, 0))
        self.live_bytes -= nbytes

    def _track(self, outs: list, ins: list) -> None:
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            seen.add(key)
            nbytes = st.nbytes()
            self._live[key] = (weakref.ref(st, lambda _, k=key: self._freed(k)),
                               nbytes)
            self.allocations.append(nbytes)
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor dispatches its local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        ins, outs = _tensors(*args, *kwargs.values()), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        self.on_op(func, args, kwargs, out, ins, outs)
        self._track(outs, ins)
        return out


def _k2(bh, bk, m, dv, qes, ves):
    # A meta decode step has no mask values: every kv row counts active.
    return rl.k2_bound(bh, bk, bk, m, dv, qes, ves)


def _part(bounds, name):
    return lambda *shape: bounds(*shape)[name]


# {launch: its count function of the shape ``record_meta`` passes},
# each returning ``(ms, bound_by, n_ops, bytes)``.
KERNEL_COUNTS = {
    "slay_fused_fwd": rl.k1_bound,
    **{n: _part(rl.bwd_bounds, n)
       for n in ("slay_fused_bwd_q", "slay_fused_bwd_kv")},
    "slay_decode_step": _k2, "slay_decode_step_masked": _k2,
    **{n: _part(rl.feature_map_bounds, n)
       for n in ("feature_map_fwd", "feature_map_bwd")},
    **{n: _part(rl.scan_bounds, n)
       for n in ("slay_scan_fwd", "slay_scan_bwd_q", "slay_scan_bwd_kv")},
}


class CostCounter(LocalOpMode):
    """Counts one rank's ops into :attr:`totals`, the kernels' meta
    launches included, and tracks the storages they allocate
    (:class:`LocalOpMode`). Reusable: each ``with`` adds to the totals,
    and the peak is the most live since the counter was made."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()

    def __enter__(self):
        self._outer, _build.meta_hook = _build.meta_hook, self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        _build.meta_hook = self._outer
        return super().__exit__(*exc)

    def _kernel(self, name: str, shape: tuple) -> None:
        _, _, n_ops, nbytes = KERNEL_COUNTS[name](*shape)
        t = self.totals
        t.flops += n_ops
        t.hbm_bytes += nbytes
        t.eager_bytes += nbytes
        rec = t.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        rec["launches"] += 1
        rec["flops"] += n_ops
        rec["bytes"] += nbytes

    def on_op(self, func, args, kwargs, out, ins, outs) -> None:
        t = self.totals
        packet = func.overloadpacket
        in_b = sum(_nbytes(x) for x in ins)
        out_b = sum(_nbytes(x) for x in outs)
        if not func.is_view and packet not in _ALLOCS:
            t.eager_bytes += in_b + out_b
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(packet.__name__)
            if kind is None:                # wait_tensor and the like
                return
            wire = wire_bytes(kind, group_size(args[-1]), in_b, out_b)
            t.coll_wire_bytes += wire
            t.coll_by_kind[kind] = t.coll_by_kind.get(kind, 0.0) + wire
            t.hbm_bytes += in_b + out_b
            return
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            t.flops += f
            key = f"{packet.__name__} {_site()}"
            t.dot_flops_by_meta[key] = t.dot_flops_by_meta.get(key, 0.0) + f
        if packet in _DOTS or packet in _REDUCTIONS:
            t.hbm_bytes += in_b + out_b
        elif packet in _GATHERS:
            t.hbm_bytes += 2 * out_b
        elif packet in _SCATTERS:
            upd = args[_SCATTERS[packet]] if len(args) > _SCATTERS[packet] \
                else None
            if not isinstance(upd, torch.Tensor):
                upd = args[2] if len(args) > 2 else outs[0]   # the index
                t.hbm_bytes += 2 * upd.numel() * outs[0].element_size()
            else:
                t.hbm_bytes += 2 * _nbytes(upd)


def analyze(fn, *args, **kwargs) -> CostTotals:
    """The totals of one call ``fn(*args, **kwargs)`` under a
    :class:`CostCounter`."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.totals
