"""Compare the kernels K1, K3, K4, B7 and B8 built from this tree and from
other source trees on one CUDA card, and optionally time K3 and K4 of all.

Builds ``slay_fused``, ``slay_fused_bwd`` and ``feature_map`` from this
checkout's ``src/repro_torch/csrc`` and from each other ``csrc``
directory (for example a parent commit unpacked with ``git archive`` into
the git-ignored ``build/``), every ``nvcc`` started at once, runs each
build on the same random inputs at slayformer-124m's training shape (BH =
96, L = 1024, d = dv = 64; B7 and B8 on the N = 96·1024 q rows), fp32 and
bf16 (K3 and K4 of every build read this build's y and den), and prints
one JSON line per output and other tree. K1, B7 and B8 must be bit for
bit the same (B8: du and its per-block dA/dΩ partials): the line gives
how many elements differ and the largest absolute difference. K3 and K4
may round differently (another tree may hold another design of them):
their lines give the same counts and whether the difference is within
the card checks of ``chip_smoke.py``, ``BWD_REL`` of each output's
largest magnitude for dq, dk, dv and ``DAW_REL`` relative in norm for dA,
dΩ. Extra ``nvcc`` flags apply to every build, so that ``-fmad=false``
tells whether a difference comes from the compiler's contraction of
multiplies and adds into FMAs.

``--time`` then times K3 and K4 of every build at the training shape in
bf16, in turns (this, the others, the others in reverse, this; repeated
``--rounds`` times; CUDA-event medians of 20 calls each) and prints each
kernel's medians per build and each other build's ratio to this one.
This tree's K3 and K4 run through the port's wrappers, so their time
includes the sum of the kernels' per-node shares; a build from before
those shares (one block per q row, per-q-head outputs in the input
dtype) is called through the same C signature with outputs in its own
layout.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_kernel_builds.py \\
        --other build/parent/src/repro_torch/csrc [--other <csrc> ...] \\
        [--time [--rounds N]] [--nvcc-flag=-fmad=false]

Exits 1 if K1, B7 or B8 differ in any element or K3/K4 fall outside the
checks, 0 otherwise.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import BWD_REL, DAW_REL, smi, time_ms  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.features import init_feature_params  # noqa: E402
from repro_torch.kernels import _build, feature_map, slay_fused  # noqa: E402

LIBS = ("slay_fused", "slay_fused_bwd", "feature_map")
OUTPUTS = {"K1": ("y", "den"), "K3": ("dq", "dA", "dOmega"),
           "K4": ("dk", "dv", "dA", "dOmega"), "B7": ("psi",),
           "B8": ("du", "dA partials", "dOmega partials")}
BIT_EXACT = ("K1", "B7", "B8")   # kernels this line of work leaves alone


def build(trees: list[Path], flags: list[str]) -> list[dict[str, ctypes.CDLL]]:
    """The three libraries compiled from each ``csrc`` in ``trees`` with
    the repo's flags plus ``flags`` (one ``nvcc`` per source and tree, all
    started together), loaded with the repo's C signatures (a helper that
    a tree lacks is left unbound)."""
    procs = []
    for csrc in trees:
        key = hashlib.sha256(f"{csrc.resolve()} {flags}".encode()).hexdigest()
        out_dir = ROOT / "build" / "compare" / key[:12]
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in LIBS:
            so = out_dir / f"lib{name}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc),
                   "-o", str(so), str(csrc / f"{name}.cu")]
            procs.append((csrc, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    builds = [{} for _ in trees]
    for i, (csrc, name, so, proc) in enumerate(procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in _build.SIGNATURES[name].items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        builds[i // len(LIBS)][name] = lib
    return builds


def _legacy(fn, lib, bwd):
    """K3 (``fn`` = "slay_fused_bwd_q") or K4 of a build from before the
    per-node shares (one block per q row), which writes the per-q-head
    outputs in the input dtype; called through the same C signature."""
    q, k, v, a, w, y, den, dy, cfg = bwd
    bh, L, d = q.shape
    bk, _, dv = v.shape
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    s_nodes, sqrt_w = slay_fused._kernel_args(lib, "slay_fused_bwd_smem_bytes",
                                              q, v, cfg)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = (torch.empty_like(q),)
    if fn == "slay_fused_bwd_kv":
        outs += (torch.empty(bh, L, dv, dtype=v.dtype, device=q.device),)
    outs += (torch.empty(bh, P, d, **f32), torch.empty(bh, D, d, **f32))
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(), w.data_ptr(),
        dy.data_ptr(), y.data_ptr(), den.data_ptr(),
        *(o.data_ptr() for o in outs), bh, bk, L, d, dv, P, D, R, s_nodes,
        sqrt_w, 1e-6, _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn)
    return outs


def bwd_fns(libs) -> dict:
    """{"K3": fn(bwd args), "K4": ...} for a build: the port's wrappers for
    a build with per-node shares, else the legacy call above."""
    _build._LIBS.update(libs)
    lib = libs["slay_fused_bwd"]
    if hasattr(lib, "slay_fused_bwd_occupancy"):
        return {"K3": lambda b: slay_fused.launch_bwd_q(*b),
                "K4": lambda b: slay_fused.launch_bwd_kv(*b)}
    return {"K3": lambda b: _legacy("slay_fused_bwd_q", lib, b),
            "K4": lambda b: _legacy("slay_fused_bwd_kv", lib, b)}


def run(libs, args, y=None, den=None) -> dict[str, tuple]:
    """K1, K3, K4, B7 and B8 of the build ``libs``; K3 and K4 read the
    given (y, den), else K1's."""
    fns = bwd_fns(libs)
    q, k, v, a, w, dy, cfg, dpsi = args
    outs = {"K1": slay_fused._launch(q, k, v, a, w, cfg, 1e-6)}
    if y is None:
        y, den = outs["K1"]
    bwd = (q, k, v, a, w, y, den, dy, cfg)
    outs["K3"] = fns["K3"](bwd)
    outs["K4"] = fns["K4"](bwd)
    u = q.reshape(-1, q.shape[-1])
    outs["B7"] = (feature_map.launch_fwd(u, a, w, cfg),)
    outs["B8"] = feature_map.launch_bwd(u, a, w, dpsi, cfg)
    torch.cuda.synchronize()
    return outs


def compare(kern, name, x, y, dtype) -> tuple[dict, bool]:
    """One output of two builds: the JSON record and whether it passes
    (K1, B7, B8: bit for bit; K3, K4: within the card checks)."""
    rec = {"dtype": str(dtype).split(".")[-1], "kernel": kern,
           "output": name, "elements": x.numel()}
    if x.shape != y.shape:
        rec["shapes"] = [list(x.shape), list(y.shape)]
        return rec, False
    ne = int((x != y).sum())
    xf, yf = x.float(), y.float()
    rec.update(differ=ne, max_abs_diff=float((xf - yf).abs().max()))
    if kern in BIT_EXACT:
        return rec, ne == 0
    if name in ("dA", "dOmega"):
        rel = float(torch.linalg.vector_norm(xf - yf)
                    / torch.linalg.vector_norm(yf))
        rec.update(check="DAW_REL, relative in norm", tol=DAW_REL, rel=rel)
        ok = rel <= DAW_REL
    else:
        rel = rec["max_abs_diff"] / float(yf.abs().max())
        rec.update(check="BWD_REL, of the largest magnitude",
                   tol=BWD_REL[dtype], rel=rel)
        ok = rel <= BWD_REL[dtype]
    rec["within"] = ok
    return rec, ok


def inputs(cfg, sp, dtype):
    bh, L, d, dv = 96, 1024, cfg.head_dim, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, dy = (torch.randn(bh, L, n, generator=gen, device="cuda").to(dtype)
                for n in (d, d, dv))
    v = torch.randn(bh, L, dv, generator=gen, device="cuda").to(dtype)
    dpsi = torch.randn(bh * L, cfg.feature_dim, generator=gen,
                       device="cuda").to(dtype)
    return (q, k, v, sp["anchors"], sp["omegas"], dy, cfg, dpsi)


def time_all(builds, names, args, rounds) -> None:
    """K3 and K4 of every build, in turns: this, the others, the others in
    reverse, this, ``rounds`` times; the port's wrappers (kernel and the
    sum of its node shares), or an older build's call."""
    q, k, v, a, w, dy, cfg, _ = args
    _build._LIBS.update(builds[0])
    y, den = slay_fused._launch(q, k, v, a, w, cfg, 1e-6)
    bwd = (q, k, v, a, w, y, den, dy, cfg)
    fns = [bwd_fns(libs) for libs in builds]
    got = {(kn, i): [] for kn in ("K3", "K4") for i in range(len(builds))}
    order = list(range(len(builds)))
    for _ in range(rounds):
        for i in order + order[:0:-1] + [0]:
            _build._LIBS.update(builds[i])
            for kn, fn in fns[i].items():
                got[kn, i].append(time_ms(lambda: fn(bwd), iters=20))
    card = smi()
    for kn in ("K3", "K4"):
        this = statistics.median(got[kn, 0])
        for i in range(1, len(builds)):
            other = statistics.median(got[kn, i])
            print(json.dumps({
                "time": kn, "dtype": "bfloat16",
                "shape": "BH=96 L=1024 d=dv=64", "other": names[i],
                "this_ms": got[kn, 0], "other_ms": got[kn, i],
                "this_median": this, "other_median": other,
                "other_over_this": other / this, "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", required=True,
                    help="csrc directory of a tree to compare against "
                    "(repeatable)")
    ap.add_argument("--time", action="store_true",
                    help="also time K3 and K4 of every build (bf16)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of timing turns (with --time)")
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="extra nvcc flag for every build (repeatable)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    trees = [_build.CSRC, *opts.other]
    builds = build(trees, opts.nvcc_flag)
    cfg = configs.get_config("slayformer-124m").slay_config()
    sp = init_feature_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    ok = True
    for dt in (torch.float32, torch.bfloat16):
        args = inputs(cfg, sp, dt)
        got_here = run(builds[0], args)
        for tree, libs in zip(opts.other, builds[1:]):
            got_other = run(libs, args, *got_here["K1"])
            for kern, names in OUTPUTS.items():
                for name, x, y in zip(names, got_here[kern], got_other[kern],
                                      strict=True):
                    rec, passed = compare(kern, name, x, y, dt)
                    ok &= passed
                    rec.update(other=str(tree), nvcc_flags=opts.nvcc_flag)
                    print(json.dumps(rec), flush=True)
            del got_other
        del args, got_here
    if opts.time:
        time_all(builds, [str(t) for t in trees],
                 inputs(cfg, sp, torch.bfloat16), opts.rounds)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
