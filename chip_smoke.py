#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (nonzero exit) on failure:

1. environment: card name and power limit (nvidia-smi), torch and nvcc
   versions; TF32 switched off for float32 matmuls and convolutions;
2. build: every CUDA kernel library from ``src/repro_torch/csrc`` with
   nvcc, one process per source, all started together;
3. K1, the fused causal SLAY forward, against its plain PyTorch version
   on the card: slayformer shapes in fp32 and bf16, GQA, a ragged L =
   1000 (a partial last tile), head dim 128 and P = 16, D = 24, R = 1 in
   fp32 (the grid is BH x R; the last takes the Ψ map's default thread
   mapping), head dim 15 with P = 3, D = 4 in fp32 and bf16 (rows copied
   in narrower pieces, Ψ padded), the serving path's own shape, and ragged L through
   ``ops.slay_fused_attention``; error, kernel and plain times, bounds
   (the state products on 3xTF32 tensor cores, as K1 runs them, and
   beside it every operation on the fp32 pipes); kernel times at three
   more shapes (one long sequence, a batch of 16, and the training shape
   BH = 96, L = 1024 in bf16 beside its bounds); grid, blocks resident,
   registers and spills at the serving and training shapes;
4. K2, the decode step, against its plain version: masked and unmasked,
   drained rows bit-identical, state updated in place, at the serving
   shape and at m = 390 with G = 8 (a ragged last feature slice; masked,
   whole clusters idle); times and bounds of the unmasked and the masked
   step; grid, cluster size, residency, registers and spills;
5. K3 and K4, the fused backward's two scans, against their plain
   versions on the card: slayformer's training shape (BH = 96, L = 1024)
   in fp32 and bf16, GQA (BH = 2·BK), R = 2 quadrature nodes, head dim
   128 and P = 16, D = 24, R = 1 at a small shape in fp32 (the grid is
   BH x R; the last takes the Ψ map's default thread mapping), and ragged
   L = 1000 through ``ops.slay_fused_attention`` under autograd; in fp32
   also against autograd through the plain forward; kernel and plain
   times, bounds (the state products on 3xTF32 tensor cores, as the
   kernels run them, and beside it every operation on the fp32 pipes);
   the grid, tile, blocks resident per SM and on the card (CUDA's
   occupancy calculator), registers and spills (``-Xptxas -v``);
6. B7/B8, the feature map and its VJP (the two-dispatch path's first
   dispatch), against their plain versions at the training shape (N =
   8·1024·12 tokens) in fp32 and bf16 and at a ragged N; times (B7 and
   B8 also on the card by the profiler), bounds; B7's and B8's grid,
   residency, registers and spills;
7. B5/B6a/B6b, the scan on precomputed features and its two backward
   scans, against their plain versions at the training shape (fp32 and
   bf16), the serving shape, GQA, m = 390 random features in fp32 and
   bf16 (the kernels' slices: three full and a partial one; rows not on
   16 bytes) and m = 45 in bf16 (rows not on 4 bytes), BH = 192, L = 512
   in bf16 (576 blocks, more than one wave), and ragged L = 1000 through
   ``ops.slay_causal_attention`` under autograd; in fp32 also against
   autograd through the plain forward; times, bounds (the state products
   on 3xTF32 tensor cores, and beside it on the fp32 pipes); each
   kernel's grid, residency, registers and spills;
8. serve: full-width slayformer-124m (random weights from a seed) through
   ``ServingEngine.generate`` on 4 ragged prompts, 32 greedy new tokens,
   launch counters read around that call; prefill and decode tokens/s;
   a ``torch.profiler`` window over one prefill and four decode steps
   (device busy time, idle share, the largest kernels); last-token
   prefill logits of one request held against the port's own CPU plain
   path in fp32;
9. train: full-width slayformer-124m, 8 AdamW steps of 8 x 1024 tokens
   through ``Trainer.run`` with launch counters read around that call
   (12 K1, 12 K3 and 12 K4 per step), a falling finite loss, a
   bit-identical resume from the checkpoint, one step with ``remat``
   (24 K1), ms per step and tokens/s, a ``torch.profiler`` window over one
   step, the losses of the same 8 steps at two higher learning rates (a
   reading, not a check), and one step's loss and gradients held against
   the port's CPU plain path in fp32 at full width and 2 layers;
10. serve, two-dispatch: ``generate`` on the same prompts with
    ``fuse_attention_features=False`` (24 feature-map and 12 scan
    launches in the prefill, no K1), card fp32 last-token logits against
    the CPU plain path, the share of greedy tokens equal to the fused
    path's (a reading);
11. train, two-dispatch: 4 steps through ``Trainer.run`` with
    ``TrainConfig(fuse_attention_features=False)``, launch counters per
    step (24/24 feature map forward/backward, 12/12/12 scan forward and
    backward, no K1, K3, K4), finite losses, the first loss against the
    fused path's, ms per step beside the fused path's, a profiler window,
    and card fp32 loss and gradients at 2 layers against the CPU plain
    path;
12. serve, continuous: ``ContinuousServingEngine`` with
    ``ServingConfig(num_slots=8, max_len=2048, prefill_chunk=128,
    macro_ticks=8)`` on 16 requests (prompts of 64-512 tokens, 16-48 new
    tokens, one arrival every 2 ticks), launch counters read around that
    run (12 x 8 masked decode launches, B4b, per dispatch; no K1, the
    chunked prefill being torch code); the greedy streams for K = 8 and
    K = 1 (the first 8 requests) identical, and the sampled ones (T =
    0.8); the Gumbel rows on
    the card against numpy; one slot NaN-corrupted at tick 40,
    quarantined at its next dispatch and retried, every stream equal to
    the fault-free run's; pool decode tokens/s, ms per dispatch and per
    prefill tick, TTFT in ticks and ms, host syncs per token; one
    full-pool dispatch's idle share (profiler) and its tick's pieces
    timed alone; in fp32, 4 requests' chunked-prefill first-token logits
    against the whole-prompt prefill (K1) and their streams against the
    lockstep engine's, up to a near-tie; B4b at the pool's shape against
    its plain version.

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Every ``ms`` is CUDA events around the
kernel's wrapper; K2's, B7's and B8's rows also carry ``device_ms``, the
kernel's own time on the card by the profiler, without the wrapper's host
time. Nothing of JAX is imported.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch import configs, prng  # noqa: E402
from repro_torch.configs.base import ServingConfig  # noqa: E402
from repro_torch.core.features import init_feature_params  # noqa: E402
from repro_torch.kernels import (_build, decode_step, feature_map, ops,  # noqa: E402
                                 slay_fused, slay_scan)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.serving import engine, faults, sampling  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves, tree_map  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM, dense TF32 tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time per call of the CUDA kernels that ``fn()`` launches,
    summed over ``iters`` calls by ``torch.profiler`` (CUPTI), after
    warm-up. For a kernel shorter than its wrapper's host time, where CUDA
    events around the call measure the host's enqueue gap as well. A
    window in which the profiler recorded no device kernel at all (seen
    once in a long run of windows) is taken again, at most twice."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return sum(e.self_device_time_total for e in kernels) / iters / 1e3
    raise AssertionError("the profiler recorded no device kernels")


def close(got, want, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol·|want| everywhere; return
    the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    bad = err > atol + rtol * want.abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    log(f"  {what}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(tol atol={atol:g} rtol={rtol:g})")
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of "
                             f"tolerance, max_abs_err={max_abs:.3e}")
    return max_abs


# -- bounds: least time the card could take for the same work ------------


# The bounds count the fewest operations the function needs. The causal sum
# is folded into the carried state one token at a time, each token added
# before its own row reads the state, so no intra-tile (tril) term remains:
# what is left per token is the Ψ map, its VJP where it is differentiated,
# and the state terms at 2·m·dv each. The kernels walk 16-token tiles and do
# more work than this.


def k1_bound(bh, bk, L, d, dv, P, D, R, es):
    """(bound_ms, bound_by, n_ops, bytes) of the fused forward. Operations
    count the Ψ map once per q row and once per kv row, the state read-out
    (2·m·dv + 2m per q row, then y/den) and update (2·m·dv + m per kv row),
    all on the fp32 pipes."""
    m = R * P * D
    psi, _ = _psi_ops(d, P, D, R)
    per_q = psi + 2 * m * dv + 2 * m + dv
    per_kv = psi + 2 * m * dv + m
    n_ops = bh * L * per_q + bk * L * per_kv
    nbytes = (bh * L * (d + dv) * es + bk * L * (d + dv) * es + bh * L * 4
              + (P + D) * d * 4)
    return _bound(n_ops, nbytes)


def k2_bound(bh, bk, bk_active, m, dv, qes, ves):
    """(bound_ms, bound_by, n_ops, bytes) of one decode step over the
    bk_active of bk kv rows that are active: their state read and
    write-back, features and v, the G = bh / bk q rows of each, and y
    written for all bh q rows (zero on drained ones)."""
    rows_q = bk_active * (bh // bk)
    nbytes = (2 * bk_active * (m * dv + m) * 4 + (rows_q + bk_active) * m * qes
              + bk_active * dv * ves + bh * dv * ves)
    n_ops = bk_active * (2 * m * dv + m) + rows_q * (2 * m * dv + 2 * m + dv)
    return _bound(n_ops, nbytes)


def _psi_ops(d, P, D, R):
    """fp32 operations of Ψ for one row (normalize, projections, φ_p, φ_e,
    Kronecker), and of its VJP (dpa, dpw, dû, dA/dΩ sums, du)."""
    m = R * P * D
    fwd = 3 * d + 2 * d * (P + D) + 2 * P + 4 * R * D + 2 * m
    bwd = 6 * m + 3 * R * D + 3 * P + 4 * (P + D) * d + 4 * d
    return fwd, bwd


def bwd_bounds(bh, bk, L, d, dv, P, D, R, es):
    """{kernel: (bound_ms, bound_by, n_ops, bytes)} of K3 and K4. Each
    counts Ψ once per q row and once per kv row and its VJP once per row
    it differentiates; the cotangents G, h (3·dv); the state terms (K3:
    dΨq = G Sᵀ + h zᵀ and the (S, z) update; K4, per q-head row:
    dΨk = V dSᵀ + dz, dV = Ψk dS and the (dS, dz) update), each token in
    the state before its own row reads it. Bytes: q, k, v, dy, y, den read
    once, the kernel's outputs written once."""
    m = R * P * D
    psi, psi_b = _psi_ops(d, P, D, R)
    k3_q = psi + psi_b + 3 * dv + 2 * m * dv + 2 * m
    k3_kv = psi + 2 * m * dv + m
    k4_q = psi + psi_b + 3 * dv + 3 * (2 * m * dv) + 3 * m
    k4_kv = psi
    read = (bh * L * (d + 2 * dv) * es + bk * L * (d + dv) * es + bh * L * 4
            + (P + D) * d * 4)
    partials = bh * (P + D) * d * 4
    return {
        "slay_fused_bwd_q": _bound(bh * L * k3_q + bk * L * k3_kv,
                                   read + bh * L * d * es + partials),
        "slay_fused_bwd_kv": _bound(bh * L * k4_q + bk * L * k4_kv,
                                    read + bh * L * (d + dv) * es + partials),
    }


def _tc_bound(bound, state):
    """``bound`` (from ``_bound``: every operation on the fp32 pipes) with
    ``state`` of its operations, the state products, on the tensor cores
    in 3xTF32, three TF32 products each (495/3 TFLOP/s), as the kernels
    run them; the rest stays on the fp32 pipes."""
    _, _, n_ops, nbytes = bound
    t_ops = (state / (TF32_FLOP_PER_S / 3)
             + (n_ops - state) / FP32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", n_ops, nbytes
    return t_bytes, "bytes", n_ops, nbytes


def bwd_tc_bounds(bh, bk, L, d, dv, P, D, R, es):
    """{kernel: (bound_ms, bound_by, n_ops, bytes)} of K3 and K4 with the
    work of ``bwd_bounds`` at the rates of the units that the kernels run
    it on (``_tc_bound``): the state products (2·m·dv operations per term
    and token, the whole of the G Sᵀ, Ψk dS, V dSᵀ and carry-update work,
    which the kernels split into tile products and state products) on the
    tensor cores. These are the kernels' rows' bounds; ``bwd_bounds``
    (everything on the fp32 pipes) stays the figure that compares with
    earlier designs."""
    st = 2 * R * P * D * dv
    state = {"slay_fused_bwd_q": (bh + bk) * L * st,
             "slay_fused_bwd_kv": bh * L * 3 * st}
    return {name: _tc_bound(b, state[name]) for name, b in
            bwd_bounds(bh, bk, L, d, dv, P, D, R, es).items()}


def k1_tc_bound(bh, bk, L, d, dv, P, D, R, es):
    """K1's bound with the read-out Ψq S (per q row) and the update Ψkᵀ V
    (per kv row), 2·m·dv operations each, on the tensor cores
    (``_tc_bound``), as K1 runs them; ``k1_bound`` stays the all-fp32
    figure."""
    return _tc_bound(k1_bound(bh, bk, L, d, dv, P, D, R, es),
                     (bh + bk) * L * 2 * R * P * D * dv)


def scan_tc_bounds(bh, bk, L, m, dv, es):
    """{kernel: (bound_ms, bound_by, n_ops, bytes)} of B5, B6a and B6b with
    their state products on the tensor cores (``_tc_bound``), as the
    kernels run them: B5's read-out Ψq S and B6a's G Sᵀ (per q row) and
    their update Ψkᵀ V (per kv row), 2·m·dv operations each, as
    ``k1_tc_bound`` counts K1's; B6b's three state terms per q-head row
    (Ψk dS, V dSᵀ and the (dS, dz) update). ``scan_bounds`` stays the
    all-fp32 figure."""
    st = 2 * m * dv
    state = {"slay_scan_fwd": (bh + bk) * L * st,
             "slay_scan_bwd_q": (bh + bk) * L * st,
             "slay_scan_bwd_kv": bh * L * 3 * st}
    return {name: _tc_bound(b, state[name]) for name, b in
            scan_bounds(bh, bk, L, m, dv, es).items()}


def ptxas_report(name: str) -> dict:
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from the ``-Xptxas -v`` log that the build of kernel library ``name``
    left beside it."""
    text = (_build.lib_path(name).parent / f"{name}.log").read_text()
    out, entry, spills = {}, None, (0, 0)
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry, spills = ln.split("'")[1], (0, 0)
        elif entry and "spill stores" in ln:
            st = re.search(r"(\d+) bytes spill stores", ln)
            ld = re.search(r"(\d+) bytes spill loads", ln)
            spills = (int(st.group(1)) if st else 0,
                      int(ld.group(1)) if ld else 0)
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            out[entry] = (int(m.group(1)), *spills)
            entry = None
    return out


def feature_map_bounds(n, d, P, D, R, es):
    """{kernel: (bound_ms, bound_by, n_ops, bytes)} of B7 and B8 over n
    tokens. B7: the Ψ map per token; u and the projections read, Ψ
    written. B8: the Ψ map and its VJP per token; u, dΨ and the projections
    read, du and one dA/dΩ written. The per-block dA/dΩ partials that B8's
    grid writes and the wrapper sums are overhead of its tiling, not part
    of the function, so they are not counted."""
    m = R * P * D
    psi, psi_b = _psi_ops(d, P, D, R)
    proj = (P + D) * d * 4
    return {
        "feature_map_fwd": _bound(n * psi, n * (d + m) * es + proj),
        "feature_map_bwd": _bound(n * (psi + psi_b),
                                  n * (2 * d + m) * es + 2 * proj),
    }


def scan_bounds(bh, bk, L, m, dv, es):
    """{kernel: (bound_ms, bound_by, n_ops, bytes)} of B5, B6a and B6b:
    the state terms of ``k1_bound`` and ``bwd_bounds`` without the Ψ map
    and its VJP. Bytes: each kernel's inputs read once (B6a reads no Ψq),
    its outputs written once."""
    st = 2 * m * dv
    den = bh * L * 4
    return {
        "slay_scan_fwd": _bound(
            bh * L * (st + 2 * m + dv) + bk * L * (st + m),
            (bh + bk) * L * m * es + bk * L * dv * es + bh * L * dv * es
            + den),
        "slay_scan_bwd_q": _bound(
            bh * L * (3 * dv + st + 2 * m) + bk * L * (st + m),
            bk * L * (m + dv) * es + 2 * bh * L * dv * es + den
            + bh * L * m * es),
        "slay_scan_bwd_kv": _bound(
            bh * L * (3 * dv + 3 * st + 3 * m),
            bh * L * (m + 2 * dv) * es + bk * L * (m + dv) * es + den
            + bh * L * (m + dv) * es),
    }


def _bound(n_ops, nbytes):
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", n_ops, nbytes
    return t_bytes, "bytes", n_ops, nbytes


def profile(what: str, fn, untraced_ms: float) -> None:
    """Where the time goes in ``fn()``: the summed time of the device
    kernels (torch.profiler / CUPTI), the kernels that take most of it,
    and the device's idle share of ``untraced_ms``, the wall time of the
    same work timed with tracing off. The traced wall time is printed
    beside it: their difference is the tracing overhead."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"  profile {what}: the profiler recorded no device kernels; "
            f"device busy time not measured")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profile {what}: device kernels {busy_ms:.3f} ms of "
        f"{untraced_ms:.3f} ms wall untraced: device idle "
        f"{1 - busy_ms / untraced_ms:.1%} (traced wall {wall_us / 1e3:.3f} "
        f"ms)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


# -- phases ---------------------------------------------------------------


def phase_env() -> str:
    line = smi()
    log(line)
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60, check=True).stdout
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc: {nvcc_v.strip().splitlines()[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {sorted(_build.SIGNATURES)} in {time.perf_counter() - t0:.1f}"
        f" s (newly built: {sorted(logs)})")
    for name, text in logs.items():
        seen = {ln.split(":", 1)[-1].strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln}
        for ln in sorted(seen):
            log(f"  {name}: {ln}")
    for name in _build.SIGNATURES:
        _build.load(name)


def _k1_inputs(gen, bh, bk, L, d, dv, dtype):
    dev = "cuda"
    q = torch.randn(bh, L, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bk, L, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bk, L, dv, generator=gen, device=dev).to(dtype)
    return q, k, v


def _other_configs(feat) -> dict:
    """{name: (cfg, anchors, omegas)} of the feature shapes that the kernel
    phases run beside slayformer's: R = 2 nodes (the fused kernels' grid is
    BH x R blocks); head dim 128, the widest the backward takes; P = 16,
    D = 24, R = 1, where P + D = 40 > 32 and P = 16 take the default
    thread mapping of psi_rows and psi_bwd_rows, past the shape limits of
    the one-node mappings (projections, Kronecker, dproj); head dim 15
    with P = 3, D = 4, which only K1 takes: its raw rows are not whole
    16-byte (fp32) or 4-byte (bf16) chunks, and P·D = 12 is padded to 16
    columns."""
    other = {}
    for key, cfg in (("R=2", dataclasses.replace(feat, num_quad_nodes=2)),
                     ("d=128", dataclasses.replace(feat, head_dim=128)),
                     ("P=16 D=24", dataclasses.replace(
                         feat, num_anchors=16, num_prf=24,
                         num_quad_nodes=1)),
                     ("d=15 P=3 D=4", dataclasses.replace(
                         feat, head_dim=15, num_anchors=3, num_prf=4))):
        p = init_feature_params(cfg, torch.Generator().manual_seed(SEED + 5),
                                device="cuda")
        other[key] = (cfg, p["anchors"], p["omegas"])
    return other


# (atol, rtol) of K1's y. fp32: the kernel and the plain version differ
# only in summation order (16-token tiles vs 256-token chunks, the node
# shares added at the end) and the 3xTF32 tile products (about 1e-7
# relative). bf16: y is a nonnegative-weighted mean of v (|y| < 8 here),
# rounded once to bf16 on each side, so one bf16 step (2^-8 relative)
# apart. den, an fp32 sum of at most L terms, to 1e-4 relative.
K1_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}
DEN_RTOL = 1e-4


def _k1_check(q, k, v, a, w, cfg, what):
    """K1 against its plain version at a bf16 shape: y at K1_TOL, den at
    DEN_RTOL."""
    log(f"K1 {what}")
    y, den = slay_fused.fused_causal_attention(q, k, v, a, w, cfg)
    yp, denp = slay_fused.fused_causal_attention_plain(q, k, v, a, w, cfg)
    torch.cuda.synchronize()
    close(y, yp, *K1_TOL[q.dtype], "y")
    close(den, denp, 0.0, DEN_RTOL, "den")


def phase_k1(feat, sp, main_shape) -> dict:
    """K1 vs plain on the card; returns the main-path case's numbers."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = feat
    a, w = sp["anchors"], sp["omegas"]
    d = cfg.head_dim
    other = _other_configs(feat)
    tol = K1_TOL
    cases = [("slayformer B=4 L=1024 fp32", 48, 48, 1024, torch.float32),
             ("slayformer B=4 L=1024 bf16", 48, 48, 1024, torch.bfloat16),
             ("GQA BH=2*BK L=512 fp32", 48, 24, 512, torch.float32),
             ("ragged L=1000 GQA BH=2*BK=8 fp32", 8, 4, 1000, torch.float32),
             ("head dim d=128 GQA BH=2*BK=8 L=256 fp32", 8, 4, 256,
              torch.float32),
             ("P=16 D=24 R=1 GQA BH=2*BK=8 L=256 fp32", 8, 4, 256,
              torch.float32),
             ("d=15 P=3 D=4 GQA BH=2*BK=8 L=90 fp32", 8, 4, 90,
              torch.float32),
             ("d=15 P=3 D=4 GQA BH=2*BK=8 L=90 bf16", 8, 4, 90,
              torch.bfloat16)]
    bh_m, L_m = main_shape
    cases.append((f"serving path BH={bh_m} L={L_m} bf16", bh_m, bh_m, L_m,
                  torch.bfloat16))
    result = {}
    for name, bh, bk, L, dt in cases:
        log(f"K1 {name}")
        ccfg, ca, cw = next((o for key, o in other.items() if key in name),
                            (cfg, a, w))
        # The kernel walks 16-token tiles whatever the chunk; a ragged L
        # (a partial last tile) is one chunk of the plain version.
        chunk = 256 if L % 256 == 0 else L
        q, k, v = _k1_inputs(gen, bh, bk, L, ccfg.head_dim, 64, dt)
        y, den = slay_fused.fused_causal_attention(q, k, v, ca, cw, ccfg,
                                                   chunk_size=chunk)
        yp, denp = slay_fused.fused_causal_attention_plain(
            q, k, v, ca, cw, ccfg, chunk_size=chunk)
        torch.cuda.synchronize()
        err = close(y, yp, *tol[dt], "y")
        close(den, denp, 0.0, DEN_RTOL, "den")
        if name.startswith("serving path"):
            ms = time_ms(lambda: slay_fused.fused_causal_attention(
                q, k, v, a, w, cfg))
            plain_ms = time_ms(lambda: slay_fused.fused_causal_attention_plain(
                q, k, v, a, w, cfg), iters=10)
            shape = (bh, bk, L, d, 64, cfg.num_anchors, cfg.num_prf,
                     cfg.num_quad_nodes, q.element_size())
            result = _kernel_row(
                "slay_fused_fwd", ms, plain_ms, k1_tc_bound(*shape), err,
                "SLAY attention", "with the state products on 3xTF32 tensor "
                "cores")
            result["bound_fp32_ms"] = k1_bound(*shape)[0]
            log(f"  {ms / result['bound_ms']:.1f}x its bound; "
                f"{ms / result['bound_fp32_ms']:.1f}x the bound with every "
                f"operation on the fp32 pipes, "
                f"{result['bound_fp32_ms']:.4f} ms")
    # Ragged L through the model-layout wrapper (zero padding in ops).
    log("K1 ragged L=1000 bf16 via ops.slay_fused_attention (B=4, H=12)")
    qm = torch.randn(4, 1000, 12, d, generator=gen, device="cuda").bfloat16()
    km = torch.randn(4, 1000, 12, d, generator=gen, device="cuda").bfloat16()
    vm = torch.randn(4, 1000, 12, 64, generator=gen, device="cuda").bfloat16()
    ym = ops.slay_fused_attention(qm, km, vm, sp, cfg)
    want = ops._headmajor_call(
        lambda qh, kh, vh: slay_fused.fused_causal_attention_plain(
            qh, kh, vh, a, w, cfg)[0], qm, km, vm, chunk_size=256)
    torch.cuda.synchronize()
    if ym.shape != (4, 1000, 12, 64):
        raise AssertionError(f"ragged output shape {tuple(ym.shape)}")
    close(ym, want, *tol[torch.bfloat16], "y")
    # Other shapes: one long sequence (36 blocks) and a batch of 16 (576
    # blocks, more than the 264 resident at once, so a second and third
    # wave: held against the plain version too).
    for bh, L in ((12, 8192), (192, 512)):
        q, k, v = _k1_inputs(gen, bh, bh, L, d, 64, torch.bfloat16)
        if bh == 192:
            _k1_check(q, k, v, a, w, cfg, f"sweep BH={bh} L={L} bf16")
        ms = time_ms(lambda: slay_fused.fused_causal_attention(
            q, k, v, a, w, cfg), iters=5)
        bound = k1_tc_bound(bh, bh, L, d, 64, cfg.num_anchors, cfg.num_prf,
                            cfg.num_quad_nodes, 2)[0]
        log(f"K1 sweep BH={bh} L={L} bf16: kernel {ms:.4f} ms = "
            f"{ms * 1e6 / (bh * L):.1f} ns per q-row token; bound "
            f"{bound:.4f} ms ({bound / ms:.2%} of the kernel's time)")
    # The training step's shape (8 sequences x 12 heads of 1024 tokens):
    # 288 blocks, more than the 264 resident at once, so the only main-path
    # shape that runs a second wave.
    q, k, v = _k1_inputs(gen, 96, 96, 1024, d, 64, torch.bfloat16)
    _k1_check(q, k, v, a, w, cfg, "training shape BH=96 L=1024 bf16")
    ms = time_ms(lambda: slay_fused.fused_causal_attention(q, k, v, a, w, cfg),
                 iters=10)
    shape = (96, 96, 1024, d, 64, cfg.num_anchors, cfg.num_prf,
             cfg.num_quad_nodes, 2)
    bound, by, n_ops, _ = k1_tc_bound(*shape)
    b32 = k1_bound(*shape)[0]
    log(f"K1 at the training shape BH=96 L=1024 bf16: kernel {ms:.4f} ms, "
        f"bound {bound:.4f} ms by {by} ({n_ops:.3e} FLOP, the state products "
        f"on 3xTF32 tensor cores), {ms / bound:.1f}x the bound; "
        f"{ms / b32:.1f}x the all-fp32 bound of {b32:.4f} ms")
    for bh in (bh_m, 96):
        log_residency("slay_fused_fwd", "slay_fused", "fused_fwd_kernel",
                      slay_fused.fwd_residency(bh, d, 64, cfg, torch.bfloat16),
                      64, f"bf16, BH={bh}, dv=64")
    return result


# (atol, rtol) of K2's y by v's dtype: fp32 summation order over m = 384
# terms, or one bf16 step.
K2_YTOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1.6e-2)}


def _k2_inputs(gen, bh, bk, m, dv, qdt, vdt):
    dev = "cuda"
    qf = torch.rand(bh, m, generator=gen, device=dev).to(qdt)
    kf = torch.rand(bk, m, generator=gen, device=dev).to(qdt)
    v = torch.randn(bk, dv, generator=gen, device=dev).to(vdt)
    s = torch.randn(bk, m, dv, generator=gen, device=dev)
    z = 10.0 * torch.rand(bk, m, generator=gen, device=dev)
    return qf, kf, v, s, z


def phase_k2(m_main) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dv, result = 64, {}
    # K2 runs one thread-block cluster per kv row, its blocks splitting the
    # m feature rows (48 each at m = 384). m = 390 with G = 8: seven slices
    # of 49 rows and a ragged one of 47; masked, rows 1, 4, 7 (whole
    # clusters) idle.
    cases = [("serving path BK=48 qf fp32 v bf16", 48, 48, m_main,
              torch.float32, torch.bfloat16, False),
             ("BK=48 all fp32", 48, 48, m_main, torch.float32, torch.float32,
              False),
             ("GQA G=2 bf16 masked", 96, 48, m_main, torch.bfloat16,
              torch.bfloat16, True),
             ("BK=48 fp32 masked", 48, 48, m_main, torch.float32,
              torch.float32, True),
             ("m=390 G=8 fp32", 64, 8, 390, torch.float32, torch.float32,
              False),
             ("m=390 G=8 bf16 masked, whole clusters idle", 64, 8, 390,
              torch.bfloat16, torch.bfloat16, True)]
    for name, bh, bk, m, qdt, vdt, masked in cases:
        log(f"K2 {name}")
        qf, kf, v, s, z = _k2_inputs(gen, bh, bk, m, dv, qdt, vdt)
        active = None
        if masked:
            active = (torch.arange(bk, device="cuda") % 3 != 1).to(torch.int32)
        s0, z0 = s.clone(), z.clone()
        sp_, zp_ = s.clone(), z.clone()
        yp, _, _ = decode_step.decode_linear_attention_plain(
            qf, kf, v, sp_, zp_, active)
        y, s2, z2 = decode_step.decode_linear_attention(qf, kf, v, s, z,
                                                       active)
        torch.cuda.synchronize()
        if s2 is not s or z2 is not z:
            raise AssertionError("decode state not updated in place")
        # s', z': one product and one add per element on both sides.
        err = close(y, yp, *K2_YTOL[vdt], "y")
        close(s, sp_, 1e-5, 1e-6, "s' (in place)")
        close(z, zp_, 1e-5, 1e-6, "z' (in place)")
        if masked:
            off = active == 0
            g = bh // bk
            if not (torch.equal(s[off], s0[off]) and torch.equal(z[off], z0[off])):
                raise AssertionError("drained rows' state changed")
            if not bool((y.reshape(bk, g, dv)[off] == 0).all()):
                raise AssertionError("drained rows' y is not zero")
            log(f"  drained rows: {int(off.sum())} of {bk} bit-identical, y=0")
        # ms: CUDA events around the wrapper, as for every kernel; beside
        # it the kernel's device time from the profiler (device_ms), which
        # leaves out the wrapper's host time (checks, allocation, the
        # ctypes call), longer than the kernel here.
        if name.startswith("serving path"):
            step = functools.partial(decode_step.decode_linear_attention, qf,
                                     kf, v, s, z)
            ms, dev_ms = time_ms(step, iters=50), device_ms(step)
            plain_ms = time_ms(lambda: decode_step.decode_linear_attention_plain(
                qf, kf, v, s, z), iters=20)
            bound, by, n_ops, nb = k2_bound(bh, bk, bk, m, dv,
                                            qf.element_size(),
                                            v.element_size())
            log(f"  kernel {ms:.4f} ms ({dev_ms:.4f} ms on the card without "
                f"the wrapper's host time), plain {plain_ms:.4f} ms, bound "
                f"{bound:.4f} ms by {by} ({n_ops:.3e} FLOP, {nb:.3e} B); "
                f"library: none, no single PyTorch call computes this step")
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by, device_ms=dev_ms)
            log_residency("slay_decode_step", "decode_step",
                          "decode_step_kernel",
                          decode_step.residency(bk, bh // bk, m, dv, qdt, vdt),
                          dv, f"qf fp32, v bf16, BK={bk}, m={m}, dv={dv}",
                          inst="If13__nv_bfloat16Li64E", unit="feature rows")
        if name == "BK=48 fp32 masked":
            # B4b: the masked step, its bound over the active rows only.
            step = functools.partial(decode_step.decode_linear_attention, qf,
                                     kf, v, s, z, active)
            ms, dev_ms = time_ms(step, iters=50), device_ms(step)
            plain_ms = time_ms(lambda: decode_step.decode_linear_attention_plain(
                qf, kf, v, s, z, active), iters=20)
            n_act = int(active.sum())
            bound, by, n_ops, nb = k2_bound(bh, bk, n_act, m, dv,
                                            qf.element_size(),
                                            v.element_size())
            log(f"  masked ({n_act} of {bk} rows active): kernel {ms:.4f} ms "
                f"({dev_ms:.4f} ms on the card), plain "
                f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} "
                f"({n_ops:.3e} FLOP, {nb:.3e} B)")
    return result


def _kernel_row(name, ms, plain_ms, bound, err, what,
                rates="on the fp32 pipes") -> dict:
    b_ms, by, n_ops, nb = bound
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {by} ({n_ops:.3e} FLOP {rates}, {nb:.3e} B); "
        f"library: none, no single PyTorch call computes {what}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by)


def _norm_rel(got, want, rtol: float, what: str) -> float:
    """Raise unless ‖got − want‖ <= rtol·‖want‖ (sums over many terms,
    where one element's error says little); return the max abs error."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    max_abs = float((got - want).abs().max())
    log(f"  {what}: norm_rel_err={rel:.3e} max_abs_err={max_abs:.3e} "
        f"(tol {rtol:g} relative in norm)")
    if not rel <= rtol:
        raise AssertionError(f"{what}: relative error {rel:.3e} in norm")
    return max_abs


# dq/dk/dv and their per-head partials: fp32 to 1e-4 of their largest
# magnitude (the kernel's 16-token tiles against the plain version's
# 256-token chunks, and Ψ's VJP in another order); bf16 to 8e-3, one bf16
# rounding of the partials (2^-8 relative) on each side. dA and dΩ sum
# over L·BH terms: 1e-4 relative in norm in both dtypes, since they stay
# fp32 from the same inputs.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
DAW_REL = 1e-4


K3_OUT = ("dq", "dA", "dOmega")              # per-head partials
K4_OUT = ("dk", "dv", "dA", "dOmega")
ALL_OUT = ("dq", "dk", "dv", "dA", "dOmega")  # summed, as autograd returns


def _check_grads(got, want, names, dtype, what) -> float:
    """Outputs against the same from another route; returns the max abs
    error over the token gradients."""
    err = 0.0
    for name, g, w in zip(names, got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"{what} {name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if name in ("dA", "dOmega"):
            _norm_rel(g, w, DAW_REL, f"{what} {name}")
        else:
            scale = float(w.float().abs().max())
            err = max(err, close(g, w, BWD_REL[dtype] * scale, 0.0,
                                 f"{what} {name}"))
    return err


def phase_k34(feat, sp) -> dict:
    """K3/K4 against their plain versions (and, in fp32, autograd through
    the plain forward); returns each kernel's numbers at the training
    shape in bf16, the main path's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    d, dv = feat.head_dim, 64
    other = _other_configs(feat)
    cases = [("train shape BH=96 L=1024 fp32", 96, 96, 1024, torch.float32),
             ("train shape BH=96 L=1024 bf16", 96, 96, 1024, torch.bfloat16),
             ("GQA BH=2*BK=48 L=512 fp32", 48, 24, 512, torch.float32),
             ("R=2 nodes GQA BH=2*BK=8 L=256 fp32", 8, 4, 256, torch.float32),
             ("head dim d=128 GQA BH=2*BK=8 L=256 fp32", 8, 4, 256,
              torch.float32),
             ("P=16 D=24 R=1 GQA BH=2*BK=8 L=256 fp32", 8, 4, 256,
              torch.float32)]
    result = {}
    for name, bh, bk, L, dt in cases:
        log(f"K3/K4 {name}")
        cfg, a, w = next((o for key, o in other.items() if key in name),
                         (feat, sp["anchors"], sp["omegas"]))
        q, k, v = _k1_inputs(gen, bh, bk, L, cfg.head_dim, dv, dt)
        dy = torch.randn(bh, L, dv, generator=gen, device="cuda").to(dt)
        y, den = slay_fused.fused_causal_attention(q, k, v, a, w, cfg)
        args = (q, k, v, a, w, y, den, dy, cfg)
        k3 = slay_fused.launch_bwd_q(*args)
        k4 = slay_fused.launch_bwd_kv(*args)
        p3 = slay_fused.fused_bwd_q_plain(*args)
        p4 = slay_fused.fused_bwd_kv_plain(*args)
        torch.cuda.synchronize()
        e3 = _check_grads(k3, p3, K3_OUT, dt, "K3 vs plain")
        e4 = _check_grads(k4, p4, K4_OUT, dt, "K4 vs plain")
        got = slay_fused.fused_causal_attention_bwd(*args)
        _check_grads(got, slay_fused.fused_causal_attention_bwd_plain(*args),
                     ALL_OUT, dt, "summed vs plain")
        if dt == torch.float32:
            xs = [t.clone().requires_grad_(True) for t in (q, k, v, a, w)]
            yp, _ = slay_fused.fused_causal_attention_plain(*xs, cfg)
            _check_grads(got, torch.autograd.grad(yp, xs, dy), ALL_OUT, dt,
                         "summed vs autograd of the plain forward")
            del xs, yp
        if dt == torch.bfloat16:
            shape = (bh, bk, L, d, dv, cfg.num_anchors, cfg.num_prf,
                     cfg.num_quad_nodes, q.element_size())
            bounds, fp32 = bwd_tc_bounds(*shape), bwd_bounds(*shape)
            for kname, kern, plain, err in (
                    ("slay_fused_bwd_q", slay_fused.launch_bwd_q,
                     slay_fused.fused_bwd_q_plain, e3),
                    ("slay_fused_bwd_kv", slay_fused.launch_bwd_kv,
                     slay_fused.fused_bwd_kv_plain, e4)):
                result[kname] = _kernel_row(
                    kname, time_ms(lambda: kern(*args), iters=10),
                    time_ms(lambda: plain(*args), iters=10, warmup=1),
                    bounds[kname], err, "this scan",
                    "with the state products on 3xTF32 tensor cores")
                b32 = fp32[kname][0]
                result[kname]["bound_fp32_ms"] = b32
                log(f"  {kname}: {result[kname]['ms'] / bounds[kname][0]:.1f}"
                    f"x its bound; bound with every operation on the fp32 "
                    f"pipes, as earlier designs were ranked, {b32:.4f} ms "
                    f"({result[kname]['ms'] / b32:.1f}x)")
        del q, k, v, dy, y, den, k3, k4, p3, p4, got
    cfg, a, w = feat, sp["anchors"], sp["omegas"]
    # Ragged L through the model-layout wrapper under autograd: the pad,
    # reshape and permute carry the gradients back.
    log("K3/K4 ragged L=1000 fp32 via ops.slay_fused_attention, autograd "
        "(B=2, H=12, Hkv=6)")
    xs = [torch.randn(2, 1000, h, d, generator=gen, device="cuda")
          .requires_grad_(True) for h in (12, 6, 6)]
    ym = ops.slay_fused_attention(*xs, sp, cfg)
    dym = torch.randn(ym.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(ym, xs, dym)
    yp = ops._headmajor_call(
        lambda qh, kh, vh: slay_fused.fused_causal_attention_plain(
            qh, kh, vh, a, w, cfg)[0], *xs, chunk_size=256)
    want = torch.autograd.grad(yp, xs, dym)
    for nm, g, wnt in zip(("dq", "dk", "dv"), got, want):
        close(g, wnt, BWD_REL[torch.float32] * float(wnt.abs().max()), 0.0,
              f"ragged {nm} vs autograd of the plain forward")
    k34_residency(feat, d, dv)
    return result


def log_residency(kname: str, lib: str, entry: str, res: dict, dv: int,
                  what: str, inst: str | None = None,
                  unit: str = "tokens") -> None:
    """One kernel's residency line: grid (and cluster size), tile, blocks
    per SM and resident at once (CUDA's occupancy calculator), registers,
    local memory and shared memory per block (``res``), and ptxas's
    registers and spills for the instantiation of kernel ``entry`` of
    library ``lib`` whose mangled name holds ``inst`` (default: bf16 at
    this dv). ``unit`` names what the tile counts."""
    gx, gy = res["grid"]
    inst = inst or f"bfloat16Li{dv}E"
    found = [v for name, v in ptxas_report(lib).items()
             if entry in name and inst in name]
    regs, st, ld = found[0] if found else ("not in the log",) * 3
    cluster = (f", clusters of {res['cluster']} blocks" if "cluster" in res
               else "")
    log(f"  {kname} ({what}): grid {gx} x {gy} = {gx * gy} blocks{cluster}, "
        f"tile {res['tile']} {unit}, {res['blocks_per_sm']} blocks per SM, "
        f"{res['blocks_resident']} resident at once "
        f"({-(-gx * gy // res['blocks_resident'])} waves), "
        f"{res['registers']} registers and {res['local_bytes']} B local "
        f"memory per thread, {res['smem_bytes']} B shared memory per block; "
        f"ptxas: {regs} registers, {st} B spill stores, {ld} B spill loads")


def k34_residency(cfg, d, dv) -> None:
    """How K3 and K4 sit on the card at the training shape in bf16."""
    for kv, kname, entry in ((False, "slay_fused_bwd_q", "fused_bwd_q_kernel"),
                             (True, "slay_fused_bwd_kv",
                              "fused_bwd_kv_kernel")):
        res = slay_fused.bwd_residency(kv, 96, d, dv, cfg, torch.bfloat16)
        log_residency(kname, "slay_fused_bwd", entry, res, dv,
                      f"bf16, BH=96, dv={dv}")


# Ψ from the kernel against its plain twin: fp32 differs in summation
# order inside the projections (1e-5 relative); bf16 rounds the same fp32
# value once on each side, so at most one bf16 step (2^-7 relative) apart.
PSI_TOL = {torch.float32: (1e-7, 1e-5), torch.bfloat16: (0.0, 8e-3)}
FMAP_OUT = ("du", "dA", "dOmega")           # summed over blocks


def phase_fmap(feat, sp, n_main) -> dict:
    """B7/B8 against their plain versions on the card at the training
    shape (n_main tokens of q, or of k, per layer) and a ragged N; returns
    each kernel's numbers at the training shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cfg, a, w = feat, sp["anchors"], sp["omegas"]
    d, m = cfg.head_dim, cfg.feature_dim
    result = {}
    for n, dt in ((n_main, torch.float32), (n_main, torch.bfloat16),
                  (n_main - 37, torch.bfloat16)):
        log(f"B7/B8 N={n} {dt}")
        u = torch.randn(n, d, generator=gen, device="cuda").to(dt)
        dpsi = torch.randn(n, m, generator=gen, device="cuda").to(dt)
        psi = feature_map.launch_fwd(u, a, w, cfg)
        psip = feature_map.feature_map_plain(u, a, w, cfg)
        torch.cuda.synchronize()
        e7 = close(psi, psip, *PSI_TOL[dt], "psi")
        del psi, psip
        bwd = (u, a, w, dpsi, cfg)
        e8 = _check_grads(feature_map.feature_map_bwd(*bwd),
                          feature_map.feature_map_bwd_plain(*bwd), FMAP_OUT,
                          dt, "B8 vs plain")
        if n == n_main and dt == torch.bfloat16:
            log(f"  B8 grid: {feature_map.launch_bwd(*bwd)[1].shape[0]} "
                f"persistent blocks, one dA/dOmega partial each")
            log_residency("feature_map_bwd", "feature_map",
                          "feature_map_bwd_kernel",
                          feature_map.bwd_residency(n, cfg, dt), d,
                          f"bf16, N={n}, d={d}, two tokens per warp at a time",
                          inst="bfloat16Li2ELb1E", unit="warps per block")
            log_residency("feature_map_fwd", "feature_map",
                          "feature_map_fwd_kernel",
                          feature_map.fwd_residency(n, cfg, dt), d,
                          f"bf16, N={n}, d={d}", inst="bfloat16")
            bounds = feature_map_bounds(n, d, cfg.num_anchors, cfg.num_prf,
                                        cfg.num_quad_nodes, u.element_size())
            for name, kern, plain, err in (
                    ("feature_map_fwd", lambda: feature_map.launch_fwd(
                        u, a, w, cfg), lambda: feature_map.feature_map_plain(
                        u, a, w, cfg), e7),
                    ("feature_map_bwd", lambda: feature_map.launch_bwd(*bwd),
                     lambda: feature_map.feature_map_bwd_plain(*bwd), e8)):
                row = result[name] = _kernel_row(
                    name, time_ms(kern), time_ms(plain, iters=10),
                    bounds[name], err, "the feature map")
                # Beside ms (CUDA events around the wrapper), the kernel's
                # device time without the wrapper's host time.
                row["device_ms"] = device_ms(kern)
                log(f"  {name}: {row['device_ms']:.4f} ms on the card "
                    f"without the wrapper's host time")
        del u, dpsi, bwd
    return result


SCAN_B6_OUT = ("dq", "dk", "dv")


def _scan_inputs(gen, feat, sp, bh, bk, L, dv, dt):
    """Ψ of random q and k rows (the plain feature map, so that the scan's
    inputs do not depend on B7), v and a cotangent."""
    a, w, d = sp["anchors"], sp["omegas"], feat.head_dim
    q, k, v = _k1_inputs(gen, bh, bk, L, d, dv, dt)
    qf = feature_map.feature_map_plain(q.reshape(-1, d), a, w, feat)
    kf = feature_map.feature_map_plain(k.reshape(-1, d), a, w, feat)
    dy = torch.randn(bh, L, dv, generator=gen, device="cuda").to(dt)
    return qf.reshape(bh, L, -1), kf.reshape(bk, L, -1), v, dy


def phase_scan(feat, sp, serve_shape) -> dict:
    """B5, B6a and B6b against their plain versions (and in fp32 against
    autograd of the plain forward); returns each kernel's numbers at the
    training shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tol = K1_TOL       # y: as K1's, the same sums and one rounding
    bh_s, L_s = serve_shape
    # B5, B6a and B6b run one block per (q row, slice of 128 feature
    # columns): m = 390 (random nonnegative features) is three full slices
    # and one of 6 columns, and its rows do not start on 16 bytes; in bf16
    # the rows of m = 45 do not start on 4 bytes. BH = 192 is 576 blocks,
    # more than are resident at once.
    cases = [("train shape BH=96 L=1024 fp32", 96, 96, 1024, torch.float32),
             ("train shape BH=96 L=1024 bf16", 96, 96, 1024, torch.bfloat16),
             (f"serving path BH={bh_s} L={L_s} bf16", bh_s, bh_s, L_s,
              torch.bfloat16),
             ("GQA BH=2*BK=48 L=512 fp32", 48, 24, 512, torch.float32),
             ("m=390 GQA BH=2*BK=8 L=256 fp32", 8, 4, 256, torch.float32),
             ("m=390 GQA BH=2*BK=8 L=256 bf16", 8, 4, 256, torch.bfloat16),
             ("m=45 GQA BH=2*BK=8 L=256 bf16", 8, 4, 256, torch.bfloat16),
             ("BH=192 L=512 bf16", 192, 192, 512, torch.bfloat16)]
    result = {}
    for name, bh, bk, L, dt in cases:
        log(f"B5/B6 {name}")
        if name.startswith("m="):
            m = int(name[2:name.index(" ")])
            qf, kf = (torch.rand(n, L, m, generator=gen, device="cuda")
                      .to(dt) for n in (bh, bk))
            v = torch.randn(bk, L, 64, generator=gen, device="cuda").to(dt)
            dy = torch.randn(bh, L, 64, generator=gen, device="cuda").to(dt)
        else:
            qf, kf, v, dy = _scan_inputs(gen, feat, sp, bh, bk, L, 64, dt)
        y, den = slay_scan.launch_fwd(qf, kf, v)
        yp, denp = slay_scan.causal_linear_attention_plain(qf, kf, v)
        torch.cuda.synchronize()
        e5 = close(y, yp, *tol[dt], "y")
        close(den, denp, 0.0, DEN_RTOL, "den")     # fp32 sum of <= L terms
        args = (qf, kf, v, y, den, dy)
        b6a = slay_scan.launch_bwd_q(*args)
        b6b = slay_scan.launch_bwd_kv(*args)
        e6a = _check_grads([b6a], [slay_scan.scan_bwd_q_plain(*args)], ("dq",),
                           dt, "B6a vs plain")
        e6b = _check_grads(b6b, slay_scan.scan_bwd_kv_plain(*args),
                           ("dk", "dv"), dt, "B6b vs plain")
        got = slay_scan.causal_linear_attention_bwd(*args)
        _check_grads(got, slay_scan.causal_linear_attention_bwd_plain(*args),
                     SCAN_B6_OUT, dt, "summed vs plain")
        if dt == torch.float32:
            xs = [t.clone().requires_grad_(True) for t in (qf, kf, v)]
            yp2, _ = slay_scan.causal_linear_attention_plain(*xs)
            _check_grads(got, torch.autograd.grad(yp2, xs, dy), SCAN_B6_OUT,
                         dt, "summed vs autograd of the plain forward")
            del xs, yp2
        es, m = qf.element_size(), qf.shape[-1]
        if name.startswith("serving path"):
            ms = time_ms(lambda: slay_scan.launch_fwd(qf, kf, v), iters=10)
            b = scan_tc_bounds(bh, bk, L, m, 64, es)["slay_scan_fwd"]
            b32 = scan_bounds(bh, bk, L, m, 64, es)["slay_scan_fwd"][0]
            log(f"  slay_scan_fwd at the serving shape: kernel {ms:.4f} ms, "
                f"bound {b[0]:.4f} ms by {b[1]} (the state products on "
                f"3xTF32 tensor cores), {ms / b[0]:.1f}x; {b32:.4f} ms on "
                f"the fp32 pipes")
            log_residency("slay_scan_fwd", "slay_scan", "scan_fwd_kernel",
                          slay_scan.residency("slay_scan_fwd", bh, m, 64, dt),
                          64, f"bf16, BH={bh}, m={m}, dv=64")
        elif name.startswith("train shape") and dt == torch.bfloat16:
            bounds = scan_tc_bounds(bh, bk, L, m, 64, es)
            fp32 = scan_bounds(bh, bk, L, m, 64, es)
            for kname, kern, plain, err in (
                    ("slay_scan_fwd", lambda: slay_scan.launch_fwd(qf, kf, v),
                     lambda: slay_scan.causal_linear_attention_plain(
                         qf, kf, v), e5),
                    ("slay_scan_bwd_q", lambda: slay_scan.launch_bwd_q(*args),
                     lambda: slay_scan.scan_bwd_q_plain(*args), e6a),
                    ("slay_scan_bwd_kv",
                     lambda: slay_scan.launch_bwd_kv(*args),
                     lambda: slay_scan.scan_bwd_kv_plain(*args), e6b)):
                row = result[kname] = _kernel_row(
                    kname, time_ms(kern, iters=10),
                    time_ms(plain, iters=10, warmup=1), bounds[kname], err,
                    "this scan", "with the state products on 3xTF32 tensor "
                    "cores")
                row["bound_fp32_ms"] = b32 = fp32[kname][0]
                log(f"  {kname}: {row['ms'] / row['bound_ms']:.1f}x its "
                    f"bound; {row['ms'] / b32:.1f}x the bound with every "
                    f"operation on the fp32 pipes, {b32:.4f} ms")
            for kname in bounds:     # B5, B6a, B6b
                log_residency(kname, "slay_scan",
                              kname.replace("slay_", "") + "_kernel",
                              slay_scan.residency(kname, bh, m, 64, dt), 64,
                              f"bf16, BH={bh}, m={m}, dv=64")
        del qf, kf, v, dy, y, den, args, b6a, b6b, got
    # Ragged L through the model-layout wrapper under autograd: the pad,
    # reshape and permute carry the gradients back.
    log("B5/B6 ragged L=1000 fp32 via ops.slay_causal_attention, autograd "
        "(B=2, H=12, Hkv=6)")
    feats = [ops.slay_features(torch.randn(2, 1000, h, feat.head_dim,
                                           generator=gen, device="cuda"),
                               sp, feat).detach().requires_grad_(True)
             for h in (12, 6)]
    xs = [*feats, torch.randn(2, 1000, 6, 64, generator=gen, device="cuda")
          .requires_grad_(True)]
    ym = ops.slay_causal_attention(*xs)
    dym = torch.randn(ym.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(ym, xs, dym)
    yp = ops._headmajor_call(
        lambda qh, kh, vh: slay_scan.causal_linear_attention_plain(
            qh, kh, vh)[0], *xs, chunk_size=256)
    close(ym.detach(), yp.detach(), 1e-4, 1e-4, "ragged y")
    want = torch.autograd.grad(yp, xs, dym)
    for nm, g, wnt in zip(SCAN_B6_OUT, got, want):
        close(g, wnt, BWD_REL[torch.float32] * float(wnt.abs().max()), 0.0,
              f"ragged {nm} vs autograd of the plain forward")
    return result


PROMPT_LENS = (512, 397, 451, 300)
MAX_NEW = 32


def phase_serve(card: str) -> tuple:
    cfg = configs.get_config("slayformer-124m")
    log(f"serve {cfg.name}: {cfg.num_layers}L x {cfg.d_model}d, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, random weights from seed {SEED}")
    params = api.init_params(cfg, SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    reqs = [engine.Request(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng = engine.ServingEngine(cfg, params, device="cuda", max_len=2048)
    eng.generate([engine.Request(prompts[0][:64], max_new_tokens=2)])  # warm
    torch.cuda.synchronize()

    _build.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = MAX_NEW - 1
    log(f"  generate: {len(reqs)} requests in {wall:.3f} s; launches {launches}")
    if launches["slay_fused_fwd"] != cfg.num_layers:
        raise AssertionError(f"K1 launched {launches['slay_fused_fwd']} "
                             f"times, want {cfg.num_layers} (one per layer)")
    if launches["slay_decode_step"] != cfg.num_layers * steps:
        raise AssertionError(f"K2 launched {launches['slay_decode_step']} "
                             f"times, want {cfg.num_layers} x {steps}")
    for o in outs:
        if len(o) != MAX_NEW or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output stream {o}")

    # Throughput, timed outside the counted run: prefill, then decode steps.
    lp = max(PROMPT_LENS)
    toks = np.zeros((len(reqs), lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, lp - len(p):] = p
    toks = torch.from_numpy(toks).cuda()

    def prefill():
        return api.prefill(eng.params, cfg, toks)

    def decode(cache, tok, n):
        for _ in range(n):
            logits, cache = api.decode_step(eng.params, cfg, cache, tok)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return logits

    with torch.inference_mode():
        t_pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill()
            torch.cuda.synchronize()
            t_pre.append(time.perf_counter() - t0)
        t_pre = statistics.median(t_pre)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        logits = decode(cache, tok, steps)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite decode logits")
        lock_ms = t_dec / steps * 1e3
        log(f"  prefill: {sum(PROMPT_LENS)} prompt tokens ({len(reqs)}x{lp} "
            f"padded) in {t_pre * 1e3:.2f} ms (median of 3) = "
            f"{sum(PROMPT_LENS) / t_pre:.1f} tok/s; decode: {steps} steps x "
            f"{len(reqs)} in {t_dec * 1e3:.2f} ms = "
            f"{len(reqs) * steps / t_dec:.1f} tok/s, "
            f"{t_dec / steps * 1e3:.3f} ms/step  [{card}]")
        profile("prefill", prefill, t_pre * 1e3)
        logits, cache = prefill()
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        profile("decode x4", lambda: decode(cache, tok, 4),
                4 * t_dec / steps * 1e3)

    # One request against the port's CPU plain path, both in fp32.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    one = torch.from_numpy(prompts[0][None])
    with torch.inference_mode():
        p_gpu = api.init_params(cfg32, SEED, device="cuda")
        lg_gpu, _ = api.prefill(p_gpu, cfg32, one)
        del p_gpu
        p_cpu = api.init_params(cfg32, SEED, device="cpu")
        t0 = time.perf_counter()
        lg_cpu, _ = api.prefill(p_cpu, cfg32, one)
        t_cpu = time.perf_counter() - t0
    lg_gpu, lg_cpu = lg_gpu[0, -1].cpu(), lg_cpu[0, -1]
    scale = float(lg_cpu.abs().max())
    log(f"  card fp32 vs CPU plain fp32, request 0 ({len(prompts[0])} "
        f"tokens, CPU {t_cpu:.1f} s):")
    # fp32 on both sides: summation order differs (cuBLAS vs CPU, the
    # kernel's tiles vs chunks of 256) across 12 layers; 1e-5 of the
    # largest logit is far above that rounding and far below a fault.
    close(lg_gpu, lg_cpu, 1e-5 * scale, 0.0, "last-token prefill logits")
    first_cpu = int(lg_cpu.argmax())
    log(f"  greedy first token: CPU fp32 {first_cpu}, card fp32 "
        f"{int(lg_gpu.argmax())}, card bf16 serve {int(outs[0][0])}; "
        f"fp32 agree={first_cpu == int(lg_gpu.argmax())}, "
        f"bf16 agree={first_cpu == int(outs[0][0])}")
    return launches, outs, lock_ms


TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_LEN = 8, 1024
TRAIN_LR, LR_SWEEP = 3e-4, (3e-3, 1e-3)
CKPT_DIR = os.path.join(REPO, "build", "chip_smoke_ckpt")
TRAIN_KERNELS = ("slay_fused_fwd", "slay_fused_bwd_q", "slay_fused_bwd_kv")


def _launch_delta(before: dict) -> dict:
    return {k: _build.LAUNCHES[k] - before[k] for k in TRAIN_KERNELS}


def _expect_launches(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def lr_sweep(cfg, dcfg) -> None:
    """Loss per step at each rate of LR_SWEEP, from the main run's params
    and batches: a reading that shows why the main run uses TRAIN_LR, not
    a check."""
    for lr in LR_SWEEP:
        ocfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=TRAIN_STEPS)
        step = loop.make_train_step(cfg, ocfg, loop.TrainConfig(remat=False))
        params = api.init_params(cfg, SEED, device="cuda")
        opt, ef, losses = adamw_init(params, ocfg), torch.zeros(()), []
        for i in range(TRAIN_STEPS):
            params, opt, ef, m = step(params, opt, ef,
                                      pipeline.make_batch(dcfg, i))
            losses.append(float(m["loss"]))
        log(f"  lr sweep, lr {lr:g}: loss per step "
            f"{', '.join(f'{x:.4f}' for x in losses)}")
        del params, opt


def phase_train(card: str) -> tuple:
    cfg = configs.get_config("slayformer-124m")
    nl = cfg.num_layers
    log(f"train {cfg.name}: {nl}L x {cfg.d_model}d, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, random weights from seed {SEED}, {TRAIN_STEPS} AdamW "
        f"steps of {TRAIN_BATCH} x {TRAIN_LEN} tokens")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                               global_batch=TRAIN_BATCH, seed=SEED)
    # lr 3e-4: from these random weights (std-1 tied embedding, loss ≈ 113)
    # the loss does not fall over 8 steps at lr 3e-3. ``lr_sweep`` prints
    # the losses at LR_SWEEP beside this run's.
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    tcfg = loop.TrainConfig(remat=False, ckpt_dir=CKPT_DIR, ckpt_every=1000)
    tr = loop.Trainer(cfg, ocfg, tcfg, seed=SEED, device="cuda")
    per_step, inner = [], tr.step_fn

    def counted_step(*args):
        before = dict(_build.LAUNCHES)
        out = inner(*args)
        per_step.append(_launch_delta(before))
        return out

    tr.step_fn = counted_step
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    hist = tr.run(pipeline.batch_iterator(dcfg), TRAIN_STEPS, log_every=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    tr.step_fn = inner
    losses = [h["loss"] for h in hist]
    log(f"  Trainer.run: {len(hist)} steps in {wall:.3f} s (checkpoint "
        f"included); launches {launches}")
    log(f"  loss per step: {', '.join(f'{x:.4f}' for x in losses)}")
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"bad loss history {losses}")
    one = {k: nl for k in TRAIN_KERNELS}
    for i, got in enumerate(per_step):
        _expect_launches(got, one, f"train step {i}")
    _expect_launches({k: launches[k] for k in TRAIN_KERNELS},
                     {k: nl * TRAIN_STEPS for k in TRAIN_KERNELS}, "train run")
    times = [h["step_time_s"] for h in hist]
    step_s = statistics.median(times[1:])
    log(f"  step time: first {times[0] * 1e3:.1f} ms, median of steps 2-"
        f"{TRAIN_STEPS} {step_s * 1e3:.2f} ms = "
        f"{TRAIN_BATCH * TRAIN_LEN / step_s:.1f} tokens/s  [{card}]")

    # Resume: a new Trainer finds the checkpoint and has the same state.
    tr2 = loop.Trainer(cfg, ocfg, tcfg, seed=SEED, device="cuda")
    if tr2.step != TRAIN_STEPS:
        raise AssertionError(f"resumed at step {tr2.step}, want {TRAIN_STEPS}")
    state = {"params": tr.params, "opt": tr.opt_state}
    for (key, x), (_, x2) in zip(tree_items(state),
                                 tree_items({"params": tr2.params,
                                             "opt": tr2.opt_state})):
        if x.dtype != x2.dtype or not torch.equal(x, x2):
            raise AssertionError(f"resumed {key} differs")
    log(f"  resume: new Trainer at step {tr2.step}, "
        f"{len(tree_leaves(state))} tensors bit-identical")
    del tr2

    # One more step with remat, on a copy: each layer's forward runs again.
    batch = pipeline.make_batch(dcfg, TRAIN_STEPS)
    step_remat = loop.make_train_step(cfg, ocfg, loop.TrainConfig(remat=True))
    copy = (tree_map(torch.clone, tr.params), tree_map(torch.clone, tr.opt_state))
    before = dict(_build.LAUNCHES)
    _, _, _, m = step_remat(*copy, torch.zeros(()), batch)
    torch.cuda.synchronize()
    got = _launch_delta(before)
    _expect_launches(got, {"slay_fused_fwd": 2 * nl, "slay_fused_bwd_q": nl,
                           "slay_fused_bwd_kv": nl}, "remat step")
    log(f"  remat step: loss {float(m['loss']):.4f}, launches {got}")
    del copy

    # Where the time goes in one step (no remat), traced.
    step = loop.make_train_step(cfg, ocfg, tcfg)
    profile("train step", lambda: step(tr.params, tr.opt_state,
                                       torch.zeros(()), batch), step_s * 1e3)
    del tr, step, step_remat
    torch.cuda.empty_cache()
    lr_sweep(cfg, dcfg)

    # One step's loss and gradients, card against the port's CPU plain path,
    # fp32, full width, 2 layers, batch 1 x 256.
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    d2 = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=1, seed=SEED)
    b2 = pipeline.make_batch(d2, 0)
    loss_g, _, g_gpu = loop.value_and_grad(
        api.init_params(cfg2, SEED, device="cuda"), cfg2, b2)
    t0 = time.perf_counter()
    loss_c, _, g_cpu = loop.value_and_grad(
        api.init_params(cfg2, SEED, device="cpu"), cfg2, b2)
    log(f"  card fp32 vs CPU plain fp32, 2 layers, 1 x 256 tokens (CPU "
        f"{time.perf_counter() - t0:.1f} s):")
    # fp32 on both sides, summation order differs (cuBLAS and the kernels'
    # tiles vs the CPU and 256-token chunks): the loss to 1e-5 relative,
    # each gradient to 1e-4 of its largest magnitude.
    close(loss_g.cpu(), loss_c, 0.0, 1e-5, "loss")
    for (key, g), (_, c) in zip(tree_items(g_gpu), tree_items(g_cpu)):
        scale = float(c.abs().max()) or 1.0
        close(g.cpu(), c, 1e-4 * scale, 0.0, f"grad {key}")
    # Checked last, so that the phase's other checks run in any case.
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    return launches, losses[0], step_s


TWO_STEPS = 4
TWO_KERNELS = ("feature_map_fwd", "feature_map_bwd", "slay_scan_fwd",
               "slay_scan_bwd_q", "slay_scan_bwd_kv")
FUSED_KERNELS = ("slay_fused_fwd", "slay_fused_bwd_q", "slay_fused_bwd_kv")
# The first loss of the two-dispatch path against the fused path's from the
# same params and batch, both bf16: they differ by Ψ rounded to bf16 between
# the two dispatches, carried through 12 layers; that gap read 1.234e-4
# relative on an H100 (700 W limit), and the limit is 4x that reading.
TWO_LOSS_RTOL = 5e-4


def _two_dispatch(cfg):
    return dataclasses.replace(cfg, fuse_attention_features=False)


def phase_train_two(card: str, fused_loss0: float, fused_step_s: float) -> dict:
    """The two-dispatch path through ``Trainer.run``: launch counts, finite
    losses, the first loss against the fused path's, ms per step beside
    the fused path's, and card fp32 loss and gradients at 2 layers against
    the port's CPU plain path."""
    cfg = configs.get_config("slayformer-124m")
    nl = cfg.num_layers
    log(f"train (two-dispatch) {cfg.name}: {nl}L x {cfg.d_model}d, "
        f"{TWO_STEPS} AdamW steps of {TRAIN_BATCH} x {TRAIN_LEN} tokens, "
        f"TrainConfig(fuse_attention_features=False)")
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                               global_batch=TRAIN_BATCH, seed=SEED)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    tcfg = loop.TrainConfig(remat=False, fuse_attention_features=False,
                            ckpt_dir=os.path.join(CKPT_DIR, "two_dispatch"),
                            ckpt_every=1000)
    shutil.rmtree(tcfg.ckpt_dir, ignore_errors=True)
    tr = loop.Trainer(cfg, ocfg, tcfg, seed=SEED, device="cuda")
    per_step, inner = [], tr.step_fn
    names = TWO_KERNELS + FUSED_KERNELS

    def counted_step(*args):
        before = dict(_build.LAUNCHES)
        out = inner(*args)
        per_step.append({k: _build.LAUNCHES[k] - before[k] for k in names})
        return out

    tr.step_fn = counted_step
    torch.cuda.synchronize()
    _build.reset_launches()
    hist = tr.run(pipeline.batch_iterator(dcfg), TWO_STEPS, log_every=1000)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    tr.step_fn = inner
    losses = [h["loss"] for h in hist]
    log(f"  Trainer.run: {len(hist)} steps; launches {launches}")
    log(f"  loss per step: {', '.join(f'{x:.4f}' for x in losses)}")
    if len(hist) != TWO_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"bad loss history {losses}")
    want = {"feature_map_fwd": 2 * nl, "feature_map_bwd": 2 * nl,
            "slay_scan_fwd": nl, "slay_scan_bwd_q": nl, "slay_scan_bwd_kv": nl,
            **{k: 0 for k in FUSED_KERNELS}}
    for i, got in enumerate(per_step):
        _expect_launches(got, want, f"two-dispatch train step {i}")
    rel = abs(losses[0] - fused_loss0) / abs(fused_loss0)
    log(f"  first loss {losses[0]:.4f}, fused path {fused_loss0:.4f}: "
        f"relative difference {rel:.3e} (tol {TWO_LOSS_RTOL:g}, bf16)")
    if not rel <= TWO_LOSS_RTOL:
        raise AssertionError(f"two-dispatch first loss {losses[0]} vs fused "
                             f"{fused_loss0}")
    times = [h["step_time_s"] for h in hist]
    step_s = statistics.median(times[1:])
    log(f"  step time: first {times[0] * 1e3:.1f} ms, median of steps 2-"
        f"{TWO_STEPS} {step_s * 1e3:.2f} ms = {TRAIN_BATCH * TRAIN_LEN / step_s:.1f}"
        f" tokens/s; fused path {fused_step_s * 1e3:.2f} ms (ratio "
        f"{step_s / fused_step_s:.3f})  [{card}]")
    batch = pipeline.make_batch(dcfg, TWO_STEPS)
    step = loop.make_train_step(cfg, ocfg, tcfg)
    profile("two-dispatch train step", lambda: step(
        tr.params, tr.opt_state, torch.zeros(()), batch), step_s * 1e3)
    del tr, step
    torch.cuda.empty_cache()

    # Loss and gradients, card against the port's CPU plain path, fp32,
    # full width, 2 layers, batch 1 x 256 (tolerances as phase_train's).
    cfg2 = dataclasses.replace(_two_dispatch(cfg), num_layers=2,
                               dtype="float32")
    d2 = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                             global_batch=1, seed=SEED)
    b2 = pipeline.make_batch(d2, 0)
    _build.reset_launches()
    loss_g, _, g_gpu = loop.value_and_grad(
        api.init_params(cfg2, SEED, device="cuda"), cfg2, b2)
    got = {k: _build.LAUNCHES[k] for k in TWO_KERNELS}
    _expect_launches(got, {"feature_map_fwd": 4, "feature_map_bwd": 4,
                           "slay_scan_fwd": 2, "slay_scan_bwd_q": 2,
                           "slay_scan_bwd_kv": 2}, "2-layer fp32 step")
    loss_c, _, g_cpu = loop.value_and_grad(
        api.init_params(cfg2, SEED, device="cpu"), cfg2, b2)
    log("  card fp32 vs CPU plain fp32 (two-dispatch), 2 layers, 1 x 256:")
    close(loss_g.cpu(), loss_c, 0.0, 1e-5, "loss")
    for (key, g), (_, c) in zip(tree_items(g_gpu), tree_items(g_cpu)):
        scale = float(c.abs().max()) or 1.0
        close(g.cpu(), c, 1e-4 * scale, 0.0, f"grad {key}")
    return launches


def phase_serve_two(card: str, fused_outs) -> dict:
    """``generate`` on the serve phase's prompts with the two-dispatch
    prefill: launch counts, card fp32 last-token logits against the CPU
    plain path, and the share of bf16 greedy tokens equal to the fused
    path's (a reading)."""
    cfg = _two_dispatch(configs.get_config("slayformer-124m"))
    nl = cfg.num_layers
    log(f"serve (two-dispatch) {cfg.name}: the same {len(PROMPT_LENS)} "
        f"prompts, {MAX_NEW} greedy new tokens")
    params = api.init_params(cfg, SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    eng = engine.ServingEngine(cfg, params, device="cuda", max_len=2048)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate([engine.Request(p, max_new_tokens=MAX_NEW)
                         for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"  generate: {wall:.3f} s; launches {launches}")
    want = {"feature_map_fwd": 2 * nl, "slay_scan_fwd": nl,
            "slay_decode_step": nl * (MAX_NEW - 1), "slay_fused_fwd": 0}
    _expect_launches({k: launches[k] for k in want}, want, "two-dispatch "
                     "generate")
    same = sum(int(np.sum(a == b)) for a, b in zip(outs, fused_outs))
    total = sum(len(o) for o in outs)
    log(f"  bf16 greedy tokens equal to the fused path's: {same} of {total} "
        f"({same / total:.1%}; a reading: Ψ is rounded to bf16 between the "
        f"two dispatches)")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    one = torch.from_numpy(prompts[0][None])
    with torch.inference_mode():
        p_gpu = api.init_params(cfg32, SEED, device="cuda")
        lg_gpu, _ = api.prefill(p_gpu, cfg32, one)
        del p_gpu
        lg_cpu, _ = api.prefill(api.init_params(cfg32, SEED, device="cpu"),
                                cfg32, one)
    lg_gpu, lg_cpu = lg_gpu[0, -1].cpu(), lg_cpu[0, -1]
    log(f"  card fp32 vs CPU plain fp32 (two-dispatch), request 0 "
        f"({len(prompts[0])} tokens):")
    close(lg_gpu, lg_cpu, 1e-5 * float(lg_cpu.abs().max()), 0.0,
          "last-token prefill logits")
    return launches


CONT_SERVING = dict(num_slots=8, max_len=2048, prefill_chunk=128,
                    macro_ticks=8)
CONT_REQUESTS = 16
CONT_K1_REQUESTS = 8           # the greedy K = 1 run takes the first 8
CONT_HOT_REQUESTS = 4          # the sampled runs take the first 4
CONT_FP32 = 4                  # requests held against the lockstep engine
CONT_FAULT_TICK = 40           # the injected fault lands at this tick
GAP_FRAC = 1e-4                # a near-tie: top-2 gap under this x max logit
G_ULP = 4                      # Gumbel noise: ulp of max(|g|, 1)


@dataclasses.dataclass
class _OneFault(faults.FaultInjector):
    """NaN-corrupts the lowest live slot once, at the first engine step at
    or after tick ``at``; no other fault."""

    at: int = 0

    def corrupt_slots(self, tick, live_slots):
        if self.log or tick < self.at or not live_slots:
            return []
        slot = min(live_slots)
        self.log.append({"kind": "nan", "tick": tick, "slot": slot})
        return [slot]


def _cont_requests(cfg, n=CONT_REQUESTS):
    """The phase's trace: prompt lengths 64-512, 16-48 new tokens, one
    arrival every 2 ticks, from the script's seed."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, n)
    news = rng.integers(16, 49, n)
    return [engine.Request(rng.integers(0, cfg.vocab_size, int(L))
                           .astype(np.int32), max_new_tokens=int(m),
                           arrival_time=2.0 * i)
            for i, (L, m) in enumerate(zip(lens, news))]


def _cont_run(cfg, params, reqs, timed=None, **serving):
    """One ContinuousServingEngine run on the card: (outputs, summary,
    engine, wall seconds). ``timed`` collects the seconds of every decode
    dispatch and prefill tick, from CUDA events recorded around each (the
    engine syncs only where it would unwrapped: once per dispatch, once
    per finished prompt), and the wall time at which each step ends."""
    kw = {**CONT_SERVING, **serving}
    inj = kw.pop("fault_injector", None)
    eng = engine.ContinuousServingEngine(
        cfg, params, serving=ServingConfig(**kw), device="cuda",
        fault_injector=inj)
    events: list = []
    if timed is not None:
        marks = timed.setdefault("ticks", [(0, time.perf_counter())])
        step = eng.step

        def stepped():
            out = step()
            marks.append((eng.tick, time.perf_counter()))
            return out

        eng.step = stepped
        for name in ("_decode_macro", "_prefill_tick"):
            inner = getattr(eng, name)

            def run(inner=inner, name=name):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = inner()
                ev[1].record()
                events.append((name, *ev))
                return out

            setattr(eng, name, run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if timed is not None:
        timed["ticks"][0] = (0, t0)
    outs, s = eng.run([dataclasses.replace(r) for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, a, b in events:
        timed.setdefault(name, []).append(a.elapsed_time(b) * 1e-3)
    return outs, s, eng, wall


def _same_streams(ref, got, what):
    """Every stream of ``got`` equals the same request's in ``ref``."""
    bad = [r for r in got if r not in ref or not np.array_equal(ref[r],
                                                                got[r])]
    if bad or not got:
        raise AssertionError(f"{what}: streams differ for rids {bad}")


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def _greedy_gaps(params, cfg, prompt, stream):
    """Top-2 logit gaps and scales along a greedy stream, teacher-forced
    through the lockstep engine's ops (prefill, unmasked decode steps)."""
    gaps = []
    with torch.inference_mode():
        logits, cache = api.prefill(params, cfg,
                                    torch.from_numpy(prompt[None]).cuda())
        for t in range(len(stream)):
            row = logits[0, -1].float()
            top2 = torch.topk(row, 2).values
            gaps.append((float(top2[0] - top2[1]), float(row.abs().max())))
            tok = torch.tensor([[int(stream[t])]], dtype=torch.int32,
                               device="cuda")
            logits, cache = api.decode_step(params, cfg, cache, tok)
    return gaps


def _cont_fp32(cfg, reqs) -> None:
    """4 requests in fp32: chunked-prefill first-token logits against the
    whole-prompt prefill (K1), and the continuous engine's greedy streams
    against the lockstep engine's, each request alone, up to the first
    near-tie of the lockstep side."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = api.init_params(cfg32, SEED, device="cuda")
    reqs = reqs[:CONT_FP32]
    C = CONT_SERVING["prefill_chunk"]
    log(f"  fp32, {len(reqs)} requests: chunked prefill (chunks of {C}) vs "
        f"whole-prompt prefill (K1), continuous vs lockstep streams")
    with torch.inference_mode():
        for r in reqs:
            p = torch.from_numpy(r.prompt[None]).cuda()
            cache = api.init_cache(cfg32, 1, device="cuda")
            for off in range(0, p.shape[1], C):
                lg, cache = api.prefill_chunk(cfg32, params, cache,
                                              p[:, off:off + C])
            whole, _ = api.prefill(params, cfg32, p)
            scale = float(whole.abs().max())
            close(lg[0, -1].cpu(), whole[0, -1].cpu(), 1e-5 * scale, 0.0,
                  f"first-token logits, {p.shape[1]}-token prompt")
    outs, _, _, _ = _cont_run(cfg32, params, reqs)
    lock = engine.ServingEngine(cfg32, params, device="cuda", max_len=2048)
    compared = total = 0
    for rid, r in enumerate(reqs):
        want = lock.generate([dataclasses.replace(r)])[0]
        gaps = _greedy_gaps(lock.params, cfg32, r.prompt, want)
        n = next((i for i, (g, sc) in enumerate(gaps) if g < GAP_FRAC * sc),
                 len(want))
        # Token n is decided by a near-tie: compare the tokens before it.
        if not np.array_equal(outs[rid][:n], want[:n]):
            raise AssertionError(f"fp32 rid {rid}: continuous {outs[rid]} "
                                 f"vs lockstep {want} before position {n}")
        compared += n
        total += len(want)
        log(f"    rid {rid}: {n} of {len(want)} tokens compared, equal "
            f"(min top-2 gap {min(g / sc for g, sc in gaps):.2e} of the "
            f"largest logit)")
    log(f"  fp32 streams: {compared} of {total} tokens compared, all equal")
    del params, lock
    torch.cuda.empty_cache()


def _cont_gumbel_check() -> None:
    """Gumbel rows on the card (seed 0, rid 0-3, idx 0-3) against the
    numpy version: words equal, values within G_ULP of max(|g|, 1)."""
    V = configs.get_config("slayformer-124m").vocab_size
    eps = float(np.finfo(np.float32).eps)
    rids = torch.arange(4, dtype=torch.int32, device="cuda")
    worst = 0.0
    for idx in range(4):
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), rids), idx)
        bits = prng.random_bits(keys, (V,)).cpu().numpy().astype(np.uint32)
        g = sampling._gumbel_row(SEED, rids, idx, V).cpu().numpy()
        for r in range(4):
            key = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), r), idx)
            if not np.array_equal(bits[r], prng.random_bits(key, (V,))):
                raise AssertionError(f"threefry words differ, rid {r} idx "
                                     f"{idx}")
            want = sampling._gumbel_row(SEED, r, idx, V)
            err = np.abs(g[r] - want) / (eps * np.maximum(np.abs(want), 1.0))
            worst = max(worst, float(err.max()))
    log(f"  Gumbel rows (seed {SEED}, rid 0-3, idx 0-3, {V} words each): "
        f"words equal, values within {worst:.2f} ulp of max(|g|, 1) (tol "
        f"{G_ULP})")
    if worst > G_ULP:
        raise AssertionError(f"Gumbel noise off by {worst:.2f} ulp")


def _b4b_pool_row(occupancy: float) -> dict:
    """B4b, the masked decode kernel, at the pool's shape (8 slots x 12
    heads kv rows, m = 384, qf fp32, v bf16, the pool's mean occupancy
    active): against its plain version, times and the bound over the
    active rows."""
    cfg = configs.get_config("slayformer-124m")
    S, H = CONT_SERVING["num_slots"], cfg.num_heads
    bk, m, dv = S * H, cfg.slay_config().feature_dim, cfg.resolved_head_dim
    n_slots = max(1, min(S, round(occupancy * S)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    qf, kf, v, s, z = _k2_inputs(gen, bk, bk, m, dv, torch.float32,
                                 torch.bfloat16)
    active = (torch.arange(bk, device="cuda") // H < n_slots).to(torch.int32)
    s0, z0 = s.clone(), z.clone()
    sp_, zp_ = s.clone(), z.clone()
    yp, _, _ = decode_step.decode_linear_attention_plain(qf, kf, v, sp_, zp_,
                                                         active)
    y, _, _ = decode_step.decode_linear_attention(qf, kf, v, s, z, active)
    torch.cuda.synchronize()
    log(f"B4b at the pool shape: BK = {S} x {H} kv rows, m = {m}, {n_slots} "
        f"of {S} slots active (the run's mean occupancy {occupancy:.3f})")
    err = close(y, yp, *K2_YTOL[torch.bfloat16], "y")
    close(s, sp_, 1e-5, 1e-6, "s' (in place)")
    off = active == 0
    if not (torch.equal(s[off], s0[off]) and torch.equal(z[off], z0[off])):
        raise AssertionError("drained rows' state changed")
    step = functools.partial(decode_step.decode_linear_attention, qf, kf, v,
                             s, z, active)
    ms, dev_ms = time_ms(step, iters=50), device_ms(step)
    plain_ms = time_ms(lambda: decode_step.decode_linear_attention_plain(
        qf, kf, v, s, z, active), iters=20)
    bound, by, n_ops, nb = k2_bound(bk, bk, int(active.sum()), m, dv, 4, 2)
    log(f"  kernel {ms:.4f} ms ({dev_ms:.4f} ms on the card), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} ({n_ops:.3e} FLOP, "
        f"{nb:.3e} B, active rows only); library: none")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, device_ms=dev_ms)


def _cont_profile(cfg, params, card: str) -> None:
    """One macro dispatch of a full pool (8 slots live): its wall time,
    the profiler's device time and idle share, and beside it the pieces
    of one tick timed alone (CUDA events): the model's masked decode
    step, sampling at T = 0.8 and greedy, the fault lane."""
    S, K = CONT_SERVING["num_slots"], CONT_SERVING["macro_ticks"]
    eng = engine.ContinuousServingEngine(
        cfg, params, serving=ServingConfig(**CONT_SERVING), device="cuda")
    rng = np.random.default_rng(SEED + 3)
    for _ in range(S):
        eng.submit(engine.Request(rng.integers(0, cfg.vocab_size, 128)
                                  .astype(np.int32), max_new_tokens=512))
    while eng._prefill is not None or eng.sched.ready or eng.sched.waiting:
        eng.step()
    if len(eng.sched.active) != S:
        raise AssertionError(f"pool not full: {sorted(eng.sched.active)}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    log(f"  one dispatch of a full pool ({S} slots, K = {K}): "
        f"{wall:.2f} ms wall (median of 3), {wall / K:.2f} ms a tick  "
        f"[{card}]")
    profile(f"continuous dispatch (K={K}, {S} slots)", eng.step, wall)
    with torch.inference_mode():
        pool = eng.pool
        tok = torch.ones(S, 1, dtype=torch.int32, device="cuda")
        act = torch.ones(S, dtype=torch.bool, device="cuda")
        rows = torch.randn(S, cfg.vocab_size, device="cuda")
        rids = torch.arange(S, dtype=torch.int32, device="cuda")
        dec = time_ms(lambda: api.decode_step(eng.params, cfg, pool, tok,
                                              act), iters=10)
        samp = time_ms(lambda: sampling.sample_tokens(
            rows, rids, rids, temperature=0.8, seed=SEED), iters=20)
        greedy = time_ms(lambda: sampling.sample_tokens(
            rows, rids, rids, temperature=0.0, seed=SEED), iters=20)
        lane = time_ms(lambda: api.slot_state_finite(cfg, pool)
                       & torch.isfinite(rows).all(-1), iters=20)
    log(f"  one tick's pieces alone (CUDA events): masked decode step "
        f"{dec:.3f} ms, sampling T=0.8 {samp:.3f} ms, greedy {greedy:.3f} "
        f"ms, fault lane {lane:.3f} ms  [{card}]")


def phase_serve_continuous(card: str, lockstep_ms: float) -> tuple:
    """``ContinuousServingEngine`` on the card at full width: 16 requests
    over an 8-slot pool, chunked prefill between K = 8 tick dispatches,
    every decode tick the masked decode kernel (B4b) once per layer.
    Checks launches, K invariance (greedy and sampled), fp32 parity with
    whole-prompt prefill and the lockstep engine, the Gumbel noise against
    numpy, and a quarantined, retried fault; prints throughput, dispatch
    time, TTFT, the sync cadence and one dispatch's idle share."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m")
    nl, K = cfg.num_layers, CONT_SERVING["macro_ticks"]
    log(f"serve (continuous) {cfg.name}: {nl}L x {cfg.d_model}d, {cfg.dtype}"
        f", ServingConfig({', '.join(f'{k}={v}' for k, v in CONT_SERVING.items())}"
        f"), {CONT_REQUESTS} requests, prompts 64-512, 16-48 new tokens, "
        f"one arrival every 2 ticks")
    params = api.init_params(cfg, SEED, device="cuda")
    reqs = _cont_requests(cfg)
    _cont_run(cfg, params, reqs[:2], max_len=1024)          # warm-up
    timed: dict = {}
    _build.reset_launches()
    outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed)
    launches = dict(_build.LAUNCHES)
    want = nl * K * s["decode_dispatches"]
    log(f"  run: {wall:.3f} s, {s['ticks']} ticks ({s['prefill_ticks']} "
        f"prefill, {s['decode_ticks']} decode in {s['decode_dispatches']} "
        f"dispatches); launches {launches}")
    if launches["slay_decode_step_masked"] != want or want == 0:
        raise AssertionError(f"B4b launched {launches['slay_decode_step_masked']}"
                             f" times, want {nl} x {K} x "
                             f"{s['decode_dispatches']} = {want}")
    if launches["slay_fused_fwd"] or launches["slay_decode_step"]:
        raise AssertionError("K1 or the unmasked K2 ran on the continuous "
                             f"path: {launches}")
    per = eng.metrics.per_request
    served = collections.Counter(st.slot for st in per.values())
    first_decode = min(st.first_token for st in per.values())
    if not (s["requests_completed"] == CONT_REQUESTS
            and s["max_queue_depth"] >= 1 and max(served.values()) > 1
            and any(st.admitted > first_decode for st in per.values())
            and s["final_occupancy"] == 0):
        raise AssertionError(f"the trace did not fill the queue, reuse "
                             f"slots and interleave prefill: {s}")
    for rid, r in enumerate(reqs):
        o = outs[rid]
        if (len(o) != r.max_new_tokens or o.min() < 0
                or o.max() >= cfg.vocab_size):
            raise AssertionError(f"bad stream rid {rid}: {o}")
    if not (s["host_syncs"] == s["decode_dispatches"]
            and s["host_syncs_per_token"] <= 1.0 / K):
        raise AssertionError(f"host syncs {s['host_syncs']} for "
                             f"{s['decode_dispatches']} dispatches")
    disp, pre = timed["_decode_macro"], timed["_prefill_tick"]
    dec_tokens = s["tokens_generated"] - CONT_REQUESTS   # minus prefill's
    ttft_t = [st.ttft_ticks for st in per.values()]
    # TTFT in ms from the wall time at which the engine's tick clock
    # passed the request's arrival (all were submitted at the start).
    marks = timed["ticks"]
    ttft_ms = [(st.first_token_wall - next(w for t, w in marks
                                           if t >= st.arrival)) * 1e3
               for st in per.values()]
    log(f"  pool decode {dec_tokens / sum(disp):.1f} tokens/s ({dec_tokens} "
        f"tokens in {sum(disp):.3f} s of {len(disp)} dispatches); "
        f"{(dec_tokens + s['prompt_tokens']) / wall:.1f} tokens/s end to end "
        f"({s['prompt_tokens']} prompt + {dec_tokens} decode in {wall:.3f} s)"
        f"  [{card}]")
    log(f"  ms per macro dispatch (CUDA events): median {statistics.median(disp) * 1e3:.2f}"
        f" (min {min(disp) * 1e3:.2f}, max {max(disp) * 1e3:.2f}); prefill "
        f"tick (a chunk of <= {CONT_SERVING['prefill_chunk']}) median "
        f"{statistics.median(pre) * 1e3:.2f} ms, {sum(pre):.3f} s in all; "
        f"lockstep decode {lockstep_ms:.3f} ms a step  [{card}]")
    log(f"  TTFT: ticks median {statistics.median(ttft_t):.1f}, p90 "
        f"{_pct(ttft_t, 0.9):.1f}; ms median {statistics.median(ttft_ms):.1f},"
        f" p90 {_pct(ttft_ms, 0.9):.1f}  [{card}]")
    log(f"  host syncs per token {s['host_syncs_per_token']:.4f} (<= 1/K = "
        f"{1 / K:.4f}); mean slot occupancy {s['mean_slot_occupancy']:.3f}, "
        f"max queue depth {s['max_queue_depth']}")

    # K invariance, greedy: the same streams with one tick per dispatch
    # (the first 8 requests, a smaller batch too: streams depend on
    # neither).
    k1 = reqs[:CONT_K1_REQUESTS]
    one, s1, _, wall1 = _cont_run(cfg, params, k1, macro_ticks=1)
    _same_streams(outs, one, "greedy, macro_ticks 8 vs 1")
    log(f"  greedy streams of rids 0-{len(k1) - 1} for macro_ticks 8 and 1: "
        f"identical (K = 1 run of {len(k1)} requests: {wall1:.3f} s, "
        f"{s1['ticks']} ticks, {s1['decode_dispatches']} dispatches)")

    # Sampling: the noise against numpy, and K invariance at T = 0.8. The
    # random model's logits are peaked (with the tied embedding a token's
    # own logit stands far above the rest), so at T = 0.8 few draws leave
    # the argmax; with the embedding divided by 8, as in the CPU and card
    # tests, the draws decide tokens, and at least one compared stream
    # must differ from its greedy stream.
    _cont_gumbel_check()
    soft = dict(params, embed=params["embed"] / 8)
    hot = reqs[:CONT_HOT_REQUESTS]
    cold, _, _, _ = _cont_run(cfg, soft, hot)
    hot8, _, _, _ = _cont_run(cfg, soft, hot, temperature=0.8)
    hot1, _, _, _ = _cont_run(cfg, soft, hot, temperature=0.8,
                              macro_ticks=1)
    _same_streams(hot8, hot1, "temperature 0.8, macro_ticks 8 vs 1")
    differ = [r for r in hot8 if not np.array_equal(hot8[r], cold[r])]
    moved = sum(int((hot8[r] != cold[r]).sum()) for r in hot8)
    log(f"  sampled streams (T = 0.8, embedding / 8) of rids 0-{len(hot) - 1}"
        f" for macro_ticks 8 and 1: identical; {len(differ)} of {len(hot8)}"
        f" differ from the greedy ones ({moved} of "
        f"{sum(len(o) for o in hot8.values())} tokens)")
    if not differ:
        raise AssertionError("no sampled stream differs from its greedy "
                             "stream: the draws decided no token")

    # The fault lane: one corrupted slot, quarantined, retried, the same
    # stream as the fault-free run.
    inj = _OneFault(at=CONT_FAULT_TICK)
    flt, sf, feng, _ = _cont_run(cfg, params, reqs, fault_injector=inj)
    ev, hit = sf["faults_detected"], inj.log
    lat = faults.detection_latencies(inj.log, feng.metrics.fault_events)
    if not (ev == 1 and sf["fault_retries"] == 1 and len(hit) == 1
            and len(lat) == 1 and lat[0] <= 1
            and sf["fault_retries_succeeded"] == 1):
        raise AssertionError(f"fault lane: injected {hit}, events "
                             f"{feng.metrics.fault_events}, summary {sf}")
    _same_streams(flt, outs, "faulted run vs fault-free run")
    rid = feng.metrics.fault_events[0]["rid"]
    log(f"  fault lane: slot {hit[0]['slot']} corrupted at tick "
        f"{hit[0]['tick']} (rid {rid}), quarantined at tick "
        f"{feng.metrics.fault_events[0]['tick']} (latency {lat[0]}), retried "
        f"once; every stream equal to the fault-free run's; summary "
        f"faults_detected={ev}")
    _cont_profile(cfg, params, card)
    del params, eng, feng
    torch.cuda.empty_cache()
    _cont_fp32(cfg, reqs)
    b4b = _b4b_pool_row(s["mean_slot_occupancy"])
    log(f"serve (continuous): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, b4b


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card_line = phase_env()
    phase_build()
    cfg = configs.get_config("slayformer-124m")
    feat = cfg.slay_config()
    sp = init_feature_params(feat, torch.Generator().manual_seed(SEED),
                             device="cuda")
    k1 = phase_k1(feat, sp, (len(PROMPT_LENS) * cfg.num_heads,
                             max(PROMPT_LENS)))
    k2 = phase_k2(feat.feature_dim)
    k34 = phase_k34(feat, sp)
    serve_shape = (len(PROMPT_LENS) * cfg.num_heads, max(PROMPT_LENS))
    fmap = phase_fmap(feat, sp, TRAIN_BATCH * TRAIN_LEN * cfg.num_heads)
    scan = phase_scan(feat, sp, serve_shape)
    launches, fused_outs, lock_ms = phase_serve(card_line)
    train, fused_loss0, fused_step_s = phase_train(card_line)
    phase_serve_two(card_line, fused_outs)
    two = phase_train_two(card_line, fused_loss0, fused_step_s)
    cont, b4b = phase_serve_continuous(card_line, lock_ms)
    kernels = [
        dict(name="slay_fused_fwd", route="cuda",
             source="src/repro_torch/csrc/slay_fused.cu",
             replaces="src/repro/kernels/slay_fused.py:89",
             launches=launches["slay_fused_fwd"], **k1, library_ms=None),
        dict(name="slay_decode_step", route="cuda",
             source="src/repro_torch/csrc/decode_step.cu",
             replaces="src/repro/kernels/decode_step.py:49",
             launches=launches["slay_decode_step"], **k2, library_ms=None),
        dict(name="slay_decode_step_masked", route="cuda",
             source="src/repro_torch/csrc/decode_step.cu",
             replaces="src/repro/kernels/decode_step.py:57",
             launches=cont["slay_decode_step_masked"], **b4b,
             library_ms=None),
        dict(name="slay_fused_bwd_q", route="cuda",
             source="src/repro_torch/csrc/slay_fused_bwd.cu",
             replaces="src/repro/kernels/slay_fused.py:161",
             launches=train["slay_fused_bwd_q"], **k34["slay_fused_bwd_q"],
             library_ms=None),
        dict(name="slay_fused_bwd_kv", route="cuda",
             source="src/repro_torch/csrc/slay_fused_bwd.cu",
             replaces="src/repro/kernels/slay_fused.py:208",
             launches=train["slay_fused_bwd_kv"], **k34["slay_fused_bwd_kv"],
             library_ms=None),
    ]
    new = (("feature_map_fwd", "feature_map.cu", "feature_map.py:46", fmap),
           ("feature_map_bwd", "feature_map.cu", "feature_map.py:104", fmap),
           ("slay_scan_fwd", "slay_scan.cu", "slay_scan.py:52", scan),
           ("slay_scan_bwd_q", "slay_scan.cu", "slay_scan.py:129", scan),
           ("slay_scan_bwd_kv", "slay_scan.cu", "slay_scan.py:163", scan))
    for name, src, jax_line, numbers in new:
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{jax_line}", launches=two[name],
            **numbers[name], library_ms=None))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
