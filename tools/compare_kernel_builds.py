"""Compare every CUDA kernel of the port built from this tree and from
other source trees on one CUDA card, and optionally time the redesigned
ones of all.

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
without a mask. Every kernel but K1 and B6b must be bit for bit the same
(B8: du and its per-block dA/dΩ partials; K2: y and the state updated in
place): the line gives how many elements differ and the largest
absolute difference. K1 and B6b, redesigned by this tree, may round
differently: their lines give the same counts and whether the
difference is within the card checks of ``chip_smoke.py`` (K1's y to
``K1_TOL``, den to ``DEN_RTOL``; B6b's dk and dv to ``BWD_REL`` of each
output's largest magnitude). Extra ``nvcc`` flags apply to every build,
so that ``-fmad=false`` tells whether a difference comes from the
compiler's contraction of multiplies and adds into FMAs.

``--time`` then times K1 at the training and the serving shape (BH = 48,
L = 512), K3, K4 and B6b of every build in bf16, in turns (this, the
others, the others in reverse, this; repeated ``--rounds`` times;
CUDA-event medians of 20 calls each) and prints each kernel's medians
per build and each other build's ratio to this one. This tree's kernels
run through the port's wrappers, so K1's time includes its epilogue and
K3's, K4's and B6b's the sum of their shares; a build from before K1's
and B6b's split (one block per q row, outputs in the input dtype) is
called through its own C signature.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_kernel_builds.py \\
        --other build/parent/src/repro_torch/csrc [--other <csrc> ...] \\
        [--time [--rounds N]] [--nvcc-flag=-fmad=false]

Exits 1 if a kernel other than K1 and B6b differs in any element or K1 or
B6b falls outside the checks, 0 otherwise.
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

from chip_smoke import (BWD_REL, DEN_RTOL, K1_TOL, smi,  # noqa: E402
                        time_ms)
from repro_torch import configs  # noqa: E402
from repro_torch.core.features import init_feature_params  # noqa: E402
from repro_torch.kernels import (_build, decode_step, feature_map,  # noqa: E402
                                 slay_fused, slay_scan)
from repro_torch.kernels.common import feature_statics  # noqa: E402

LIBS = ("slay_fused", "slay_fused_bwd", "decode_step", "feature_map",
        "slay_scan")
OUTPUTS = {"K1": ("y", "den"), "K2": ("y", "s", "z"),
           "K2 masked": ("y", "s", "z"), "K3": ("dq", "dA", "dOmega"),
           "K4": ("dk", "dv", "dA", "dOmega"), "B5": ("y", "den"),
           "B6a": ("dq",), "B6b": ("dk", "dv"), "B7": ("psi",),
           "B8": ("du", "dA partials", "dOmega partials")}
REDESIGNED = ("K1", "B6b")   # held to the card checks; the rest bit for bit
TIMED = ("K1", "K1 serving", "K3", "K4", "B6b")
DELTA = 1e-6
# K1's C signature before its split by quadrature node (y and den written
# by the one kernel, no scratch for the node shares), and the shared-memory
# queries of that time, which still took R (K1's used it, K3/K4's not).
_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.POINTER(ctypes.c_double))
LEGACY = {"slay_fused_fwd": (_I, [_P] * 7 + [_I] * 8 + [_D, _D, _F, _I, _P]),
          "slay_fused_smem_bytes": (ctypes.c_longlong, [_I] * 5),
          "slay_fused_bwd_smem_bytes": (ctypes.c_longlong, [_I] * 5)}


def _older(csrc: Path) -> bool:
    """Whether ``csrc`` predates K1's split by quadrature node."""
    return "slay_fused_fwd_occupancy" not in (csrc / "slay_fused.cu").read_text()


def build(trees: list[Path], flags: list[str]) -> list[dict[str, ctypes.CDLL]]:
    """The libraries compiled from each ``csrc`` in ``trees`` with the
    repo's flags plus ``flags`` (one ``nvcc`` per source and tree, all
    started together), loaded with the repo's C signatures (a helper that
    a tree lacks is left unbound; an older tree gets its own signatures)."""
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
        sigs = dict(_build.SIGNATURES[name])
        if _older(csrc):
            sigs.update({f: sig for f, sig in LEGACY.items() if f in sigs})
        for fn, (restype, argtypes) in sigs.items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        if _older(csrc) and name == "slay_fused_bwd":
            # The port's wrappers ask with four arguments; that build
            # ignored R.
            raw = lib.slay_fused_bwd_smem_bytes
            lib.slay_fused_bwd_smem_bytes = lambda d, dv, P, D: raw(d, dv, P,
                                                                    D, 1)
        builds[i // len(LIBS)][name] = lib
    return builds


def _legacy_k1(lib, q, k, v, a, w, cfg):
    """K1 of a build from before the split by quadrature node: one kernel
    that writes y and den itself."""
    bh, L, d = q.shape
    bk, _, dv = v.shape
    R = cfg.num_quad_nodes
    if lib.slay_fused_smem_bytes(d, dv, cfg.num_anchors, cfg.num_prf,
                                 R) > _build.SMEM_LIMIT:
        raise ValueError("shapes too large for the older K1")
    st = feature_statics(cfg)
    s_nodes = (ctypes.c_double * R)(*st.s_nodes)
    sqrt_w = (ctypes.c_double * R)(*st.sqrt_w)
    y = torch.empty(bh, L, dv, dtype=v.dtype, device=q.device)
    den = torch.empty(bh, L, dtype=torch.float32, device=q.device)
    err = lib.slay_fused_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(), w.data_ptr(),
        y.data_ptr(), den.data_ptr(), bh, bk, L, d, dv, cfg.num_anchors,
        cfg.num_prf, cfg.num_quad_nodes, s_nodes, sqrt_w, DELTA,
        _build.DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "slay_fused_fwd")
    return y, den


def _legacy_b6b(lib, qf, kf, v, y, den, dy):
    """B6b of a build from before the split by feature slice: per-q-head
    dk and dv in the input dtype, through the same C signature."""
    bh, L, m = qf.shape
    dk = torch.empty(bh, L, m, dtype=kf.dtype, device=qf.device)
    dv = torch.empty(bh, L, v.shape[-1], dtype=v.dtype, device=qf.device)
    err = lib.slay_scan_bwd_kv(
        qf.data_ptr(), kf.data_ptr(), v.data_ptr(), dy.data_ptr(),
        y.data_ptr(), den.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        kf.shape[0], L, m, v.shape[-1], DELTA, _build.DTYPE_CODES[qf.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "slay_scan_bwd_kv")
    return dk, dv


def use(libs) -> dict:
    """Route the port's wrappers to the build ``libs``; returns its K1 and
    B6b callers: the wrappers, or for an older build the calls above."""
    _build._LIBS.update(libs)
    fns = {"K1": lambda *x: slay_fused._launch(*x, DELTA),
           "B6b": slay_scan.launch_bwd_kv}
    if not hasattr(libs["slay_fused"], "slay_fused_fwd_occupancy"):
        fns["K1"] = lambda *x: _legacy_k1(libs["slay_fused"], *x)
    if not hasattr(libs["slay_scan"], "slay_scan_bwd_kv_slices"):
        fns["B6b"] = lambda *x: _legacy_b6b(libs["slay_scan"], *x)
    return fns


def run(libs, inp, ref=None) -> dict[str, tuple]:
    """Every kernel of the build ``libs``; K3/K4 and B6a/B6b read the
    (y, den) of K1 and of B5 in ``ref`` (another build's outputs), else
    this build's own."""
    fns = use(libs)
    q, k, v, a, w, dy, cfg, dpsi = inp["fused"]
    ref = ref or {}
    outs = {"K1": fns["K1"](q, k, v, a, w, cfg)}
    bwd = (q, k, v, a, w, *ref.get("K1", outs["K1"]), dy, cfg)
    outs["K3"] = slay_fused.launch_bwd_q(*bwd)
    outs["K4"] = slay_fused.launch_bwd_kv(*bwd)
    u = q.reshape(-1, q.shape[-1])
    outs["B7"] = (feature_map.launch_fwd(u, a, w, cfg),)
    outs["B8"] = feature_map.launch_bwd(u, a, w, dpsi, cfg)
    qf, kf, sv, sdy = inp["scan"]
    outs["B5"] = slay_scan.launch_fwd(qf, kf, sv, DELTA)
    sargs = (qf, kf, sv, *ref.get("B5", outs["B5"]), sdy)
    outs["B6a"] = (slay_scan.launch_bwd_q(*sargs, DELTA),)
    outs["B6b"] = fns["B6b"](*sargs)
    dqf, dkf, dvv, s, z, active = inp["decode"]
    for kern, act in (("K2", None), ("K2 masked", active)):
        outs[kern] = decode_step.decode_linear_attention(
            dqf, dkf, dvv, s.clone(), z.clone(), act)
    torch.cuda.synchronize()
    return outs


def compare(kern, name, x, y, dtype) -> tuple[dict, bool]:
    """One output of two builds: the JSON record and whether it passes
    (K1, B6b: within the card checks; every other kernel: bit for bit)."""
    rec = {"dtype": str(dtype).split(".")[-1], "kernel": kern,
           "output": name, "elements": x.numel()}
    if x.shape != y.shape:
        rec["shapes"] = [list(x.shape), list(y.shape)]
        return rec, False
    ne = int((x != y).sum())
    xf, yf = x.float(), y.float()
    diff = (xf - yf).abs()
    rec.update(differ=ne, max_abs_diff=float(diff.max()))
    if kern not in REDESIGNED:
        return rec, ne == 0
    if kern == "K1":
        atol, rtol = K1_TOL[dtype] if name == "y" else (0.0, DEN_RTOL)
        rec.update(check="K1_TOL / DEN_RTOL", atol=atol, rtol=rtol)
        ok = bool((diff <= atol + rtol * yf.abs()).all())
    else:
        rel = rec["max_abs_diff"] / float(yf.abs().max())
        rec.update(check="BWD_REL, of the largest magnitude",
                   tol=BWD_REL[dtype], rel=rel)
        ok = rel <= BWD_REL[dtype]
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


def time_all(builds, names, cfg, sp, rounds) -> None:
    """K1 (training and serving shape), K3, K4 and B6b of every build in
    bf16, in turns: this, the others, the others in reverse, this,
    ``rounds`` times."""
    inp = inputs(cfg, sp, torch.bfloat16)
    serve = inputs(cfg, sp, torch.bfloat16, bh=48, L=512)["fused"]
    q, k, v, a, w, dy, _, _ = inp["fused"]
    fns = use(builds[0])
    bwd = (q, k, v, a, w, *fns["K1"](q, k, v, a, w, cfg), dy, cfg)
    qf, kf, sv, sdy = inp["scan"]
    sargs = (qf, kf, sv, *slay_scan.launch_fwd(qf, kf, sv, DELTA), sdy)
    got = {(kn, i): [] for kn in TIMED for i in range(len(builds))}
    order = list(range(len(builds)))
    for _ in range(rounds):
        for i in order + order[:0:-1] + [0]:
            fns = use(builds[i])
            calls = {"K1": lambda: fns["K1"](q, k, v, a, w, cfg),
                     "K1 serving": lambda: fns["K1"](*serve[:5], cfg),
                     "K3": lambda: slay_fused.launch_bwd_q(*bwd),
                     "K4": lambda: slay_fused.launch_bwd_kv(*bwd),
                     "B6b": lambda: fns["B6b"](*sargs)}
            for kn, fn in calls.items():
                got[kn, i].append(time_ms(fn, iters=20))
    card = smi()
    shapes = {"K1 serving": "BH=48 L=512 d=dv=64",
              "B6b": "BH=96 L=1024 m=384 dv=64"}
    for kn in TIMED:
        this = statistics.median(got[kn, 0])
        for i in range(1, len(builds)):
            other = statistics.median(got[kn, i])
            print(json.dumps({
                "time": kn, "dtype": "bfloat16",
                "shape": shapes.get(kn, "BH=96 L=1024 d=dv=64"),
                "other": names[i], "this_ms": got[kn, 0],
                "other_ms": got[kn, i], "this_median": this,
                "other_median": other, "other_over_this": other / this,
                "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", required=True,
                    help="csrc directory of a tree to compare against "
                    "(repeatable)")
    ap.add_argument("--time", action="store_true",
                    help="also time K1, K3, K4 and B6b of every build (bf16)")
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
