"""Op-level contracts of a traced PyTorch program, the counterpart of
``repro/analysis/hlo.py``.

The reference parses the compiled HLO of an engine entry point and
checks three contracts on its op table. Here :func:`record` runs the
program once under a dispatch mode that sees one rank's local ops
(``launch.cost.LocalOpMode``) and returns a :class:`Trace`: every op
dispatched (name, local shapes, dtypes, devices, tags), the sizes of the
storages it allocated, and the storages of chosen leaves before the call
and after it. The checks, under the reference's rule codes:

* :func:`check_no_collectives` (HLO001): no ``c10d`` op and no
  ``_c10d_functional`` collective, the zero-collective decode contract;
* :func:`check_no_host_ops` (HLO002): no ``_local_scalar_dense``
  (``.item()``), no op whose output depends on the data
  (``nonzero``, ``unique``, ``masked_select``, indexing by a boolean
  mask: PyTorch tags them) and no copy from a device to the host;
* :func:`check_donation` (DON001): each donated leaf is written in place,
  so its storage after the call is the one it had before, and no storage
  of its full size is allocated (a copy of it; checked for leaves of at
  least :data:`COPY_MIN_BYTES`, below which the many control vectors and
  temporaries of one size would be taken for copies).

    PYTHONPATH=src python -m repro_torch.analysis.trace

checks ``ContinuousServingEngine.contract_traces()`` of slayformer's smoke
config under ``slay`` and under ``softmax`` on a 4-rank ``fake`` world
with ``make_serving_mesh(4)`` (the counterpart of
``tools/lint_contracts.py --hlo``), and exits 1 on any finding.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.launch.cost import COLLECTIVE_KINDS, LocalOpMode

COPY_MIN_BYTES = 4096
_HOST_TAGS = (torch.Tag.data_dependent_output, torch.Tag.dynamic_output_shape)
# Ops tagged with a dynamic output shape only when indexed by a mask.
_MASK_INDEXED = ("aten::index", "aten::index_put", "aten::index_put_",
                 "aten::_index_put_impl_")


@dataclasses.dataclass(frozen=True)
class TracedOp:
    name: str                    # e.g. "aten.mm.default"
    namespace: str
    shapes: tuple
    dtypes: tuple
    devices: tuple               # of the inputs, then the outputs
    collective: bool
    host_op: bool                # data-dependent output or a device->host copy


@dataclasses.dataclass
class Trace:
    ops: list
    allocations: list            # bytes of each storage allocated
    before: dict                 # leaf name -> its storage before the call
    after: dict                  # leaf name -> its storage after the call


def _is_collective(func) -> bool:
    """A ``c10d`` op, or a ``_c10d_functional`` collective (not its wait or
    its autograd wrapper)."""
    return func.namespace == "c10d" or (
        func.namespace == "_c10d_functional"
        and func.overloadpacket.__name__ in COLLECTIVE_KINDS)


def _is_host_op(func, ins, outs) -> bool:
    if func._schema.name in _MASK_INDEXED:
        if any(t.dtype == torch.bool for t in ins[1:]):
            return True
    elif any(tag in func.tags for tag in _HOST_TAGS):
        return True
    to_host = any(t.device.type == "cpu" for t in outs)
    return to_host and any(t.device.type not in ("cpu", "meta")
                           for t in ins)


class _Recorder(LocalOpMode):
    def __init__(self):
        super().__init__()
        self.ops: list[TracedOp] = []

    def on_op(self, func, args, kwargs, out, ins, outs) -> None:
        self.ops.append(TracedOp(
            name=str(func), namespace=func.namespace,
            shapes=tuple(tuple(t.shape) for t in ins + outs),
            dtypes=tuple(str(t.dtype) for t in ins + outs),
            devices=tuple(str(t.device) for t in ins + outs),
            collective=_is_collective(func),
            host_op=_is_host_op(func, ins, outs)))


def _storages(leaves: Callable[[], dict] | None) -> dict:
    return {} if leaves is None else {
        k: v.untyped_storage() for k, v in leaves().items()}


def record(fn, *args, leaves: Callable[[], dict] | None = None,
           **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once and return its :class:`Trace`.
    ``leaves`` returns {name: tensor} of the leaves whose storages the
    trace keeps; it is called before the call and after it."""
    before = _storages(leaves)
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    return Trace(ops=rec.ops, allocations=rec.allocations, before=before,
                 after=_storages(leaves))


def check_no_collectives(trace: Trace, label: str) -> list[Finding]:
    """HLO001: no cross-device collective in the program."""
    return [Finding(rule="HLO001", path=label, line=i + 1, symbol=op.name,
                    message=f"collective {op.name} over {op.shapes}")
            for i, op in enumerate(trace.ops) if op.collective]


def check_no_host_ops(trace: Trace, label: str) -> list[Finding]:
    """HLO002: no read of a value to the host (``.item()``), no op whose
    output shape or value the host must wait for, no device-to-host
    copy."""
    return [Finding(rule="HLO002", path=label, line=i + 1, symbol=op.name,
                    message=f"host op {op.name} on {op.devices}")
            for i, op in enumerate(trace.ops) if op.host_op]


def check_donation(trace: Trace, donated_leaves, label: str
                   ) -> list[Finding]:
    """DON001: a donated leaf written out of place: its storage after the
    call is not the one it had before, or a storage of its full size was
    allocated (a copy of it). Either doubles its device memory."""
    out = []
    for name in donated_leaves:
        st0, st1 = trace.before[name], trace.after[name]
        if st1 is not st0:
            out.append(Finding(
                rule="DON001", path=label, line=0, symbol=name,
                message="written out of place: a new storage after the "
                        "call"))
        elif (st0.nbytes() >= COPY_MIN_BYTES
              and st0.nbytes() in trace.allocations):
            out.append(Finding(
                rule="DON001", path=label, line=0, symbol=name,
                message=f"a copy of its {st0.nbytes()} bytes was "
                        f"allocated"))
    return out


def check_engine(eng, label: str) -> list[Finding]:
    """The three checks on every trace of ``eng.contract_traces()``."""
    out = []
    for name, (trace, donated) in eng.contract_traces().items():
        tag = f"{name}[{label}]"
        out += check_no_collectives(trace, tag)
        out += check_no_host_ops(trace, tag)
        out += check_donation(trace, donated, tag)
        print(f"  trace: {tag}: {len(trace.ops)} ops, {len(donated)} "
              f"donated leaves")
    return out


def main(argv=None) -> int:
    from repro_torch import configs
    from repro_torch.configs.base import ServingConfig
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import api
    from repro_torch.serving.engine import ContinuousServingEngine

    findings = []
    with fake_world(4):
        mesh = make_serving_mesh(4)
        for kind in ("slay", "softmax"):
            cfg = configs.get_smoke_config("slayformer-124m", attn_kind=kind)
            params = api.init_params(cfg, 0, device="cpu")
            eng = ContinuousServingEngine(
                cfg, params, mesh=mesh, device="cpu",
                serving=ServingConfig(num_slots=4, max_len=64,
                                      prefill_chunk=4, macro_ticks=8))
            findings += check_engine(eng, kind)
    for f in findings:
        print(f.render())
    print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
