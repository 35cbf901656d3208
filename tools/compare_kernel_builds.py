"""Compare every CUDA kernel of the port built from this tree and from
other source trees on one CUDA card, and optionally time them.

Builds the five kernel libraries (``slay_fused``, ``slay_fused_bwd``,
``decode_step``, ``feature_map``, ``slay_scan``) from this checkout's
``src/repro_torch/csrc`` and from each other ``csrc`` directory (for
example a parent commit unpacked with ``git archive`` into the
git-ignored ``build/``), every ``nvcc`` started at once, runs each build
on the same random inputs and prints one JSON line per output and other
tree, in fp32 and bf16: K1, K3, K4 at slayformer-124m's training shape
(BH = 96, L = 1024, d = dv = 64; K3 and K4 of every build read this
build's y and den), B7 and B8 on its N = 96·1024 q rows, B5, B6a and B6b
on the features of those rows (B6a and B6b of every build read this
build's B5 output), K2 at the serving shape (BK = 48, m = 384), with and
without a mask. Every output but K2's y and B8's must be bit for bit the
same (K2: the state updated in place too): the line gives how many
elements differ and the largest absolute difference. K2's y and B8's du,
dA and dΩ (the per-block partials summed), redesigned by this tree, may
round differently: their lines give the same counts and whether the
difference is within the card checks of ``chip_smoke.py`` (K2's y to
``K2_YTOL``; du to ``BWD_REL`` of its largest magnitude, dA and dΩ to
``DAW_REL`` relative in norm). Extra ``nvcc`` flags apply to every
build, so that ``-fmad=false`` tells whether a difference comes from the
compiler's contraction of multiplies and adds into FMAs.

``--time`` then times, in bf16, K1 and B5 at the training and the
serving shape (BH = 48, L = 512), K3, K4, B6a, B6b and B8 (N = 98,304)
at the training shape, B7 at both (N = 98,304 and 24,576), and K2 at the
serving shape (qf fp32, v bf16; and masked, all fp32, 32 of 48 rows
active) of every build, in turns (this, the others, the others in
reverse, this; repeated ``--rounds`` times; CUDA-event medians of 20
calls of the wrapper each, and for B7, B8 and K2 also their device time
from the profiler over 20 calls, without the wrappers' host time, which
is not small beside these kernels) and
prints each kernel's medians per build and each other build's ratio to
this one. The kernels
run through the port's wrappers, so K1's and B5's times include their
epilogue, K3's, K4's and B6b's the sum of their shares, and B8's the
launch alone (its partials are not summed).

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_kernel_builds.py \\
        --other build/parent/src/repro_torch/csrc [--other <csrc> ...] \\
        [--time [--rounds N]] [--nvcc-flag=-fmad=false]

Exits 1 if an output held bit for bit differs in any element or K2's y
or B8's outputs fall outside the checks, 0 otherwise.
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

from chip_smoke import (BWD_REL, DAW_REL, K2_YTOL,  # noqa: E402
                        device_ms, smi, time_ms)
from repro_torch import configs  # noqa: E402
from repro_torch.core.features import init_feature_params  # noqa: E402
from repro_torch.kernels import (_build, decode_step, feature_map,  # noqa: E402
                                 slay_fused, slay_scan)

LIBS = ("slay_fused", "slay_fused_bwd", "decode_step", "feature_map",
        "slay_scan")
OUTPUTS = {"K1": ("y", "den"), "K2": ("y", "s", "z"),
           "K2 masked": ("y", "s", "z"), "K3": ("dq", "dA", "dOmega"),
           "K4": ("dk", "dv", "dA", "dOmega"), "B5": ("y", "den"),
           "B6a": ("dq",), "B6b": ("dk", "dv"), "B7": ("psi",),
           "B8": ("du", "dA", "dOmega")}
# Outputs of the kernels this tree redesigned, held to the card checks;
# every other output bit for bit.
REDESIGNED = {("K2", "y"), ("K2 masked", "y"), ("B8", "du"), ("B8", "dA"),
              ("B8", "dOmega")}
TIMED = ("K1", "K1 serving", "K3", "K4", "B5", "B5 serving", "B6a", "B6b",
         "B7", "B7 serving", "B8", "K2", "K2 masked")
# Also timed on the card by the profiler (chip_smoke.device_ms), beside the
# CUDA events around the wrapper: their wrappers' host time (allocations,
# checks, the ctypes call) is not small beside the kernel.
DEVICE_TIMED = ("B7", "B7 serving", "B8", "K2", "K2 masked")
DELTA = 1e-6


def build(trees: list[Path], flags: list[str]) -> list[dict[str, ctypes.CDLL]]:
    """The libraries compiled from each ``csrc`` in ``trees`` with the
    repo's flags plus ``flags`` (one ``nvcc`` per source and tree, all
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


def use(libs) -> None:
    """Route the port's wrappers to the build ``libs``."""
    _build._LIBS.update(libs)


def b5(qf, kf, v):
    """B5 through its wrapper (the kernel and K1's epilogue)."""
    return slay_scan.launch_fwd(qf, kf, v, DELTA)


def k1(q, k, v, a, w, cfg):
    """K1 through its wrapper (the kernel and its epilogue)."""
    return slay_fused._launch(q, k, v, a, w, cfg, DELTA)


def run(libs, inp, ref=None) -> dict[str, tuple]:
    """Every kernel of the build ``libs``; K3/K4 and B6a/B6b read the
    (y, den) of K1 and of B5 in ``ref`` (another build's outputs), else
    this build's own."""
    use(libs)
    q, k, v, a, w, dy, cfg, dpsi = inp["fused"]
    ref = ref or {}
    outs = {"K1": k1(q, k, v, a, w, cfg)}
    bwd = (q, k, v, a, w, *ref.get("K1", outs["K1"]), dy, cfg)
    outs["K3"] = slay_fused.launch_bwd_q(*bwd)
    outs["K4"] = slay_fused.launch_bwd_kv(*bwd)
    u = q.reshape(-1, q.shape[-1])
    outs["B7"] = (feature_map.launch_fwd(u, a, w, cfg),)
    outs["B8"] = feature_map.feature_map_bwd(u, a, w, dpsi, cfg)
    qf, kf, sv, sdy = inp["scan"]
    outs["B5"] = b5(qf, kf, sv)
    sargs = (qf, kf, sv, *ref.get("B5", outs["B5"]), sdy)
    outs["B6a"] = (slay_scan.launch_bwd_q(*sargs, DELTA),)
    outs["B6b"] = slay_scan.launch_bwd_kv(*sargs, DELTA)
    dqf, dkf, dvv, s, z, active = inp["decode"]
    for kern, act in (("K2", None), ("K2 masked", active)):
        outs[kern] = decode_step.decode_linear_attention(
            dqf, dkf, dvv, s.clone(), z.clone(), act)
    torch.cuda.synchronize()
    return outs


def _ratio(err: float, scale: float) -> float:
    """err / scale, infinite where a zero reference meets an error."""
    if scale > 0:
        return err / scale
    return 0.0 if err == 0 else float("inf")


def compare(kern, name, x, y, dtype) -> tuple[dict, bool]:
    """One output of two builds: the JSON record and whether it passes
    (an output in REDESIGNED: within the card checks; every other one:
    bit for bit). ``y`` is the other build's, the reference."""
    rec = {"dtype": str(dtype).split(".")[-1], "kernel": kern,
           "output": name, "elements": x.numel()}
    if x.shape != y.shape:
        rec["shapes"] = [list(x.shape), list(y.shape)]
        return rec, False
    ne = int((x != y).sum())
    xf, yf = x.float(), y.float()
    diff = (xf - yf).abs()
    rec.update(differ=ne, max_abs_diff=float(diff.max()))
    if (kern, name) not in REDESIGNED:
        return rec, ne == 0
    if kern.startswith("K2"):
        atol, rtol = K2_YTOL[x.dtype]
        rec.update(check="K2_YTOL", atol=atol, rtol=rtol)
        ok = bool((diff <= atol + rtol * yf.abs()).all())
    elif name == "du":
        rel = _ratio(rec["max_abs_diff"], float(yf.abs().max()))
        rec.update(check="BWD_REL, of the largest magnitude",
                   tol=BWD_REL[dtype], rel=rel)
        ok = rel <= BWD_REL[dtype]
    else:
        rel = _ratio(float(torch.linalg.vector_norm(xf - yf)),
                     float(torch.linalg.vector_norm(yf)))
        rec.update(check="DAW_REL, relative in norm", tol=DAW_REL, rel=rel)
        ok = rel <= DAW_REL
    rec["within"] = ok
    return rec, ok


def inputs(cfg, sp, dtype, bh=96, L=1024) -> dict:
    """Random inputs of every kernel from one seed: the fused kernels' q,
    k, v, dy and B8's dΨ at (bh, L); the scan's Ψq, Ψk (the plain feature
    map of q and k), v and dy; K2's step at the serving shape."""
    d, dv, m = cfg.head_dim, 64, cfg.feature_dim
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, dy = randn(bh, L, d), randn(bh, L, d), randn(bh, L, dv), randn(
        bh, L, dv)
    a, w = sp["anchors"], sp["omegas"]
    feats = [feature_map.feature_map_plain(x.reshape(-1, d), a, w, cfg)
             .reshape(bh, L, m) for x in (q, k)]
    bk = 48
    dec = (torch.rand(bk, m, generator=gen, device="cuda").to(dtype),
           torch.rand(bk, m, generator=gen, device="cuda").to(dtype),
           randn(bk, dv),
           torch.randn(bk, m, dv, generator=gen, device="cuda"),
           10.0 * torch.rand(bk, m, generator=gen, device="cuda"),
           (torch.arange(bk, device="cuda") % 3 != 1).to(torch.int32))
    return {"fused": (q, k, v, a, w, dy, cfg, randn(bh * L, m)),
            "scan": (*feats, v, dy), "decode": dec}


def _k2_timed(dqt, dvt, n_active=None):
    """K2's inputs at the serving shape (BK = 48, m = 384, dv = 64): qf and
    kf in ``dqt``, v in ``dvt``, and with ``n_active`` a mask of that many
    active rows spread over the 48."""
    bk, m, dv = 48, 384, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = (torch.rand(bk, m, generator=gen, device="cuda").to(dqt),
           torch.rand(bk, m, generator=gen, device="cuda").to(dqt),
           torch.randn(bk, dv, generator=gen, device="cuda").to(dvt),
           torch.randn(bk, m, dv, generator=gen, device="cuda"),
           10.0 * torch.rand(bk, m, generator=gen, device="cuda"))
    if n_active is None:
        return (*out, None)
    act = (torch.arange(bk, device="cuda") % 3 != 1).to(torch.int32)
    assert int(act.sum()) == n_active
    return (*out, act)


def time_all(builds, names, cfg, sp, rounds) -> None:
    """Every kernel of TIMED of every build, in turns: this, the others,
    the others in reverse, this, ``rounds`` times."""
    inp = inputs(cfg, sp, torch.bfloat16)
    serve = inputs(cfg, sp, torch.bfloat16, bh=48, L=512)
    q, k, v, a, w, dy, _, dpsi = inp["fused"]
    u = q.reshape(-1, q.shape[-1])
    u_serve = serve["fused"][0].reshape(-1, q.shape[-1])
    use(builds[0])
    bwd = (q, k, v, a, w, *k1(q, k, v, a, w, cfg), dy, cfg)
    qf, kf, sv, sdy = inp["scan"]
    sargs = (qf, kf, sv, *b5(qf, kf, sv), sdy)
    dec = _k2_timed(torch.float32, torch.bfloat16)
    dec_masked = _k2_timed(torch.float32, torch.float32, n_active=32)
    calls = {"K1": lambda: k1(q, k, v, a, w, cfg),
             "K1 serving": lambda: k1(*serve["fused"][:5], cfg),
             "K3": lambda: slay_fused.launch_bwd_q(*bwd),
             "K4": lambda: slay_fused.launch_bwd_kv(*bwd),
             "B5": lambda: b5(qf, kf, sv),
             "B5 serving": lambda: b5(*serve["scan"][:3]),
             "B6a": lambda: slay_scan.launch_bwd_q(*sargs, DELTA),
             "B6b": lambda: slay_scan.launch_bwd_kv(*sargs, DELTA),
             "B7": lambda: feature_map.launch_fwd(u, a, w, cfg),
             "B7 serving": lambda: feature_map.launch_fwd(u_serve, a, w, cfg),
             "B8": lambda: feature_map.launch_bwd(u, a, w, dpsi, cfg),
             "K2": lambda: decode_step.decode_linear_attention(*dec),
             "K2 masked": lambda: decode_step.decode_linear_attention(
                 *dec_masked)}
    got = {(kn, i): [] for kn in TIMED for i in range(len(builds))}
    dev = {(kn, i): [] for kn in DEVICE_TIMED for i in range(len(builds))}
    order = list(range(len(builds)))
    for _ in range(rounds):
        for i in order + order[:0:-1] + [0]:
            use(builds[i])
            for kn in TIMED:
                got[kn, i].append(time_ms(calls[kn], iters=20))
                if kn in DEVICE_TIMED:
                    dev[kn, i].append(device_ms(calls[kn], iters=20))
    card = smi()
    scan = "BH=96 L=1024 m=384 dv=64"
    shapes = {"K1 serving": "BH=48 L=512 d=dv=64",
              "B5 serving": "BH=48 L=512 m=384 dv=64", "B5": scan,
              "B6a": scan, "B6b": scan, "B7": "N=98304 d=64 m=384",
              "B7 serving": "N=24576 d=64 m=384", "B8": "N=98304 d=64 m=384",
              "K2": "BK=48 G=1 m=384 dv=64, qf fp32, v bf16",
              "K2 masked": "BK=48 (32 active) G=1 m=384 dv=64, fp32"}
    for kn in TIMED:
        this = statistics.median(got[kn, 0])
        for i in range(1, len(builds)):
            other = statistics.median(got[kn, i])
            rec = {"time": kn, "dtype": "bfloat16",
                   "shape": shapes.get(kn, "BH=96 L=1024 d=dv=64"),
                   "other": names[i], "this_ms": got[kn, 0],
                   "other_ms": got[kn, i], "this_median": this,
                   "other_median": other, "other_over_this": other / this}
            if kn in DEVICE_TIMED:
                this_dev = statistics.median(dev[kn, 0])
                other_dev = statistics.median(dev[kn, i])
                rec.update(this_device_ms=dev[kn, 0],
                           other_device_ms=dev[kn, i],
                           this_device_median=this_dev,
                           other_device_median=other_dev,
                           other_over_this_device=other_dev / this_dev)
            print(json.dumps({**rec, "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", required=True,
                    help="csrc directory of a tree to compare against "
                    "(repeatable)")
    ap.add_argument("--time", action="store_true",
                    help="also time K1, K2, K3, K4, B5, B6a, B6b, B7 and B8 of "
                    "every build")
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
        inp = inputs(cfg, sp, dt)
        got_here = run(builds[0], inp)
        for tree, libs in zip(opts.other, builds[1:]):
            got_other = run(libs, inp, ref=got_here)
            for kern, names in OUTPUTS.items():
                for name, x, y in zip(names, got_here[kern], got_other[kern],
                                      strict=True):
                    rec, passed = compare(kern, name, x, y, dt)
                    ok &= passed
                    rec.update(other=str(tree), nvcc_flags=opts.nvcc_flag)
                    print(json.dumps(rec), flush=True)
            del got_other
        del inp, got_here
    if opts.time:
        time_all(builds, [str(t) for t in trees], cfg, sp, opts.rounds)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
