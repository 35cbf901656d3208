"""Shared-memory audit of the CUDA kernels, the counterpart of the JAX
package's VMEM audit (``repro/analysis/vmem.py``).

Every SLAY kernel takes its dynamic shared memory per block from a layout
that grows with the config's shapes, and a block may use at most
``_build.SMEM_LIMIT``. The routes (``kernels.ops.attention_route``) read
Python copies of those layouts to keep each config off a kernel it would
not fit. This audit reads the same copies: it probes every kernel entry
(K1, K3, K4, K2, B5, B6a, B6b, B7, B8) at the shapes each of the 11
configs sends it through the route, with and without a gradient, fused
and with ``fuse_attention_features=False`` (Ψ alone, then the scan), in
bf16 and fp32 (K2 in the shapes only: its state is fp32), and at four
more shapes: ROADMAP C-15's R = 12, P·D = 24 and head dim 128 at
P = D = 32, and C-14's P = D = 32 at head dim 32.

    SMEM001  a probe the route sends to a kernel needs more than
             ``_build.SMEM_LIMIT``: the route and the layouts disagree.
    SMEM002  a probe's bytes differ from the committed baseline
             (``smem_baseline.json``): a layout changed. Review it, then
             ``python -m repro_torch.analysis.smem --update-baseline``.
    SMEM003  the baseline and the probe set are out of sync: a probe
             missing from the baseline, or a stale baseline entry.

On the card ``tests/test_torch_card.py`` holds every probe's bytes to the
kernels' C entries. Registers and spills are the compiler's, read from
``-Xptxas -v`` on the card (``chip_smoke.py``'s ``ptxas_report``), not
here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch import configs
from repro_torch.analysis.findings import Finding
from repro_torch.core.features import SlayFeatureConfig
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_step import decode_smem_bytes
from repro_torch.kernels.feature_map import fmap_smem_bytes
from repro_torch.kernels.slay_fused import (fused_bwd_smem_bytes,
                                            fused_smem_bytes)
from repro_torch.kernels.slay_scan import scan_smem_bytes

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "smem_baseline.json")
LABEL = "analysis/smem"
DTYPES = {"bf16": 2, "fp32": 4}
# Shapes beyond the configs' own: SlayFeatureConfig fields (dv = head dim,
# one q head per kv head).
EXTRA = {
    "c15_r12": dict(head_dim=64, num_quad_nodes=12),
    "c15_pd24": dict(head_dim=64, num_anchors=4, num_prf=6),
    "c15_d128_pd32": dict(head_dim=128, num_anchors=32, num_prf=32),
    "c14_d32_pd32": dict(head_dim=32, num_anchors=32, num_prf=32),
}
# The kernels each route runs: (without a gradient, with one).
ROUTE_KERNELS = {
    ops.FUSED: (("K1",), ("K1", "K3", "K4")),
    ops.TWO_DISPATCH: (("B7", "B5"), ("B7", "B5", "B6a", "B6b", "B8")),
    ops.TORCH_PSI: (("B5",), ("B5", "B6a", "B6b")),
}
_SCAN_KIND = {"B5": 0, "B6a": 1, "B6b": 2}


@dataclasses.dataclass(frozen=True)
class Probe:
    """One kernel entry at one shape: the bytes of dynamic shared memory
    a block takes there, and the shapes whose routes send it there."""

    kernel: str
    args: tuple          # (name, value) pairs that fix the bytes
    dtype: str           # "bf16" or "fp32"; "" for K2
    nbytes: int
    sources: tuple       # configs (or EXTRA shapes)

    @property
    def name(self) -> str:
        shape = ",".join(f"{k}={v}" for k, v in self.args)
        return f"{self.kernel}[{shape}{',' + self.dtype if self.dtype else ''}]"


def _bytes(kernel: str, f: SlayFeatureConfig, dv: int, g: int,
           es: int) -> tuple[tuple, int]:
    """(the args that fix the bytes, the bytes) of ``kernel``."""
    d, P, D, R = f.head_dim, f.num_anchors, f.num_prf, f.num_quad_nodes
    m = f.feature_dim
    if kernel in ("K1", "K3", "K4"):
        args = (("d", d), ("dv", dv), ("P", P), ("D", D))
        if kernel == "K1":
            return args, fused_smem_bytes(d, dv, P, D, es)
        return args, fused_bwd_smem_bytes(d, dv, P, D, es, kv=kernel == "K4")
    if kernel == "K2":
        return (("g", g), ("m", m), ("dv", dv)), decode_smem_bytes(g, m, dv)
    if kernel in _SCAN_KIND:
        return ((("m", m), ("dv", dv)),
                scan_smem_bytes(m, dv, _SCAN_KIND[kernel], es))
    return ((("d", d), ("P", P), ("D", D), ("R", R)),
            fmap_smem_bytes(d, P, D, R, kernel == "B8", es))


def shapes() -> list[tuple[str, SlayFeatureConfig, int, int]]:
    """(source, feature config, dv, q heads per kv head) of every config
    with SLAY layers, then of :data:`EXTRA`."""
    out = []
    for name in configs.ALL_ARCHS:
        cfg = configs.get_config(name)
        if cfg.attn_kind == "slay":
            out.append((name, cfg.slay_config(), cfg.resolved_head_dim,
                        cfg.num_heads // cfg.num_kv_heads))
    for name, kw in EXTRA.items():
        f = SlayFeatureConfig(**kw)
        out.append((name, f, f.head_dim, 1))
    return out


def probe_all() -> dict[str, Probe]:
    """Every probe, keyed by name: each shape's routes without and with a
    gradient, through the fused entry and for Ψ alone, in both dtypes,
    and its decode step K2."""
    probes: dict[str, Probe] = {}

    def add(kernel, f, dv, g, dtype, source):
        args, nbytes = _bytes(kernel, f, dv, g, DTYPES.get(dtype, 4))
        p = Probe(kernel, args, dtype, nbytes, (source,))
        old = probes.get(p.name)
        if old is None:
            probes[p.name] = p
        elif source not in old.sources:
            probes[p.name] = dataclasses.replace(
                old, sources=old.sources + (source,))

    for source, f, dv, g in shapes():
        for dtype in DTYPES:
            for grad in (False, True):
                for entry_dv in (dv, None):
                    route = ops.attention_route(f, f.head_dim, entry_dv,
                                                grad, "cpu")
                    for kernel in ROUTE_KERNELS[route][grad]:
                        add(kernel, f, dv, g, dtype, source)
        add("K2", f, dv, g, "", source)
    return dict(sorted(probes.items()))


def load_baseline(path: str = DEFAULT_BASELINE) -> dict[str, int]:
    with open(path) as fh:
        raw = json.load(fh)
    return {k: int(v) for k, v in raw.get("probes", {}).items()}


def write_baseline(probes: dict[str, Probe],
                   path: str = DEFAULT_BASELINE) -> None:
    payload = {
        "comment": "dynamic shared memory per block (bytes) of each kernel "
                   "entry at the probe shapes of repro_torch/analysis/"
                   "smem.py; regenerate with python -m "
                   "repro_torch.analysis.smem --update-baseline",
        "limit_bytes": _build.SMEM_LIMIT,
        "probes": {k: probes[k].nbytes for k in sorted(probes)},
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")


def check(probes: dict[str, Probe] | None = None,
          baseline: dict[str, int] | None = None,
          limit: int = _build.SMEM_LIMIT) -> list[Finding]:
    """SMEM001-003 over the probes against the baseline."""
    if probes is None:
        probes = probe_all()
    if baseline is None:
        baseline = (load_baseline() if os.path.exists(DEFAULT_BASELINE)
                    else {})
    findings = []
    for name, p in probes.items():
        if p.nbytes > limit:
            findings.append(Finding(
                "SMEM001", LABEL, 0,
                f"{p.nbytes} B a block, more than the {limit} B a block may "
                f"use, on the route of {', '.join(p.sources)}", name))
        if name not in baseline:
            findings.append(Finding(
                "SMEM003", LABEL, 0,
                f"probe missing from smem_baseline.json (measured "
                f"{p.nbytes} B): update the baseline", name))
        elif baseline[name] != p.nbytes:
            findings.append(Finding(
                "SMEM002", LABEL, 0,
                f"{p.nbytes} B != baseline {baseline[name]} B: a layout "
                f"changed; review it and update the baseline", name))
    for name in sorted(set(baseline) - set(probes)):
        findings.append(Finding(
            "SMEM003", LABEL, 0,
            "stale smem_baseline.json entry: no longer probed; update the "
            "baseline", name))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.smem",
        description="Audit the CUDA kernels' shared memory per block at "
                    "every shape the routes send them (SMEM001-003).")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the probes")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: the committed one)")
    args = ap.parse_args(argv)
    probes = probe_all()
    if args.update_baseline:
        write_baseline(probes, args.baseline)
        print(f"wrote {len(probes)} probes to {args.baseline}")
        return 0
    baseline = (load_baseline(args.baseline)
                if os.path.exists(args.baseline) else {})
    findings = check(probes, baseline)
    for f in findings:
        print(f.render())
    print(f"{len(probes)} probes, {len(findings)} findings")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
