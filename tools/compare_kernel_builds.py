"""Compare the fused kernels K1, K3 and K4 built from two source trees, bit
for bit, on one CUDA card.

Builds ``slay_fused`` and ``slay_fused_bwd`` from this checkout's
``src/repro_torch/csrc`` and from another ``csrc`` directory (for example a
parent commit unpacked with ``git archive`` into the git-ignored
``build/``), runs both builds on the same random inputs at
slayformer-124m's training shape (BH = 96, L = 1024, d = dv = 64), fp32 and
bf16 (K3 and K4 of both read the first build's y and den), and prints one
JSON line per output: how many elements differ and
the largest absolute difference. Extra ``nvcc`` flags apply to both
builds, so that ``-fmad=false`` tells whether a difference comes from the
compiler's contraction of multiplies and adds into FMAs.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_kernel_builds.py \\
        --other build/parent/src/repro_torch/csrc [--nvcc-flag=-fmad=false]

Exits 1 if any output differs, 0 if all are bit-identical.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.features import init_feature_params  # noqa: E402
from repro_torch.kernels import _build, slay_fused  # noqa: E402

LIBS = ("slay_fused", "slay_fused_bwd")
OUTPUTS = {"K1": ("y", "den"), "K3": ("dq", "dA", "dOmega"),
           "K4": ("dk", "dv", "dA", "dOmega")}


def build(csrc: Path, flags: list[str]) -> dict[str, ctypes.CDLL]:
    """The two fused libraries compiled from ``csrc`` with the repo's
    flags plus ``flags``, loaded with the repo's C signatures."""
    key = hashlib.sha256(f"{csrc.resolve()} {flags}".encode()).hexdigest()[:12]
    out_dir = ROOT / "build" / "compare" / key
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBS:
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc),
               "-o", str(out_dir / f"lib{name}.so"), str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, (restype, argtypes) in _build.SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def run(libs, args, y=None, den=None) -> dict[str, tuple]:
    """K1, K3 and K4 through the port's wrappers with ``libs`` loaded; K3
    and K4 read the given (y, den), else K1's."""
    _build._LIBS.update(libs)
    q, k, v, a, w, dy, cfg = args
    outs = {"K1": slay_fused._launch(q, k, v, a, w, cfg, 1e-6)}
    if y is None:
        y, den = outs["K1"]
    bwd = (q, k, v, a, w, y, den, dy, cfg)
    outs["K3"] = slay_fused.launch_bwd_q(*bwd)
    outs["K4"] = slay_fused.launch_bwd_kv(*bwd)
    torch.cuda.synchronize()
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="csrc directory of the tree to compare against")
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="extra nvcc flag for both builds (repeatable)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    here = build(_build.CSRC, opts.nvcc_flag)
    other = build(opts.other, opts.nvcc_flag)
    cfg = configs.get_config("slayformer-124m").slay_config()
    sp = init_feature_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    bh, L, d, dv = 96, 1024, cfg.head_dim, 64
    differ = False
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, dy = (torch.randn(bh, L, n, generator=gen, device="cuda").to(dt)
                    for n in (d, d, dv))
        v = torch.randn(bh, L, dv, generator=gen, device="cuda").to(dt)
        args = (q, k, v, sp["anchors"], sp["omegas"], dy, cfg)
        got_here = run(here, args)
        got_other = run(other, args, *got_here["K1"])
        for kern, names in OUTPUTS.items():
            for name, x, y in zip(names, got_here[kern], got_other[kern],
                                  strict=True):
                ne = int((x != y).sum())
                diff = float((x.float() - y.float()).abs().max())
                differ |= ne > 0
                print(json.dumps({"dtype": str(dt).split(".")[-1],
                                  "kernel": kern, "output": name,
                                  "elements": x.numel(), "differ": ne,
                                  "max_abs_diff": diff,
                                  "nvcc_flags": opts.nvcc_flag}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
