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
   step; grid, cluster size, residency, registers and spills; then at the
   linear baselines' widths, dv = 64, v bf16: m = 64 (favor's fp32 and
   elu1's bf16 features) and m = 128 (cosformer's bf16 features, their
   second half zero), 48 kv rows (the lockstep shape) and 96 masked (the
   pool's), drained rows bit-identical, each timed beside its bound;
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
   (device busy time, idle share, the largest kernels); the engine's
   decode step, one CUDA graph per batch size and temperature, against
   the same engine run eagerly: equal tokens greedy and at T = 0.8, ms
   per step of each in turns and a profiler window over each; last-token
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
    run (12 x 8 masked decode launches, B4b, per dispatch, counted per
    replay of the dispatch's CUDA graph; no K1, the chunked prefill being
    torch code); one captured graph of the dispatch and one of a full
    prefill chunk, with their capture times; the first 8 requests with
    the graphs and without (eager), in turns, streams equal, with each
    side's ms per dispatch and prefill tick, pool tokens/s and TTFT; the
    greedy streams for K = 8 and K = 1 (the first 8 requests) identical,
    and the sampled ones (T = 0.8, graphed at K = 8 and 1 and eager);
    the Gumbel rows on
    the card against numpy; one slot NaN-corrupted at tick 40,
    quarantined at its next dispatch and retried, every stream equal to
    the fault-free run's; pool decode tokens/s, ms per dispatch and per
    prefill tick, TTFT in ticks and ms, host syncs per token; one
    full-pool dispatch graphed and eager in turns, each with its idle
    share (profiler), and a tick's pieces timed alone; in fp32, 4
    requests' chunked-prefill first-token logits
    against the whole-prompt prefill (K1) and their streams against the
    lockstep engine's, up to a near-tie; B4b at the pool's shape against
    its plain version;
13. serve, prefix cache and crash-safe (``phase_serve_durable``): the
    same pool with ``prefix_cache_bytes=160 << 20`` and
    ``checkpoint_every_ticks=64`` on 16 requests that share a 384-token
    system prompt (unique suffixes of 16-200 tokens, 16-48 new tokens,
    one arrival every 2 ticks; requests 12-15 repeat the prompts of 8-11):
    streams byte-identical to a cold run (no prefix cache), greedy and,
    for the first 8 requests, at T = 0.8; at least 15 prefix hits, 4 of
    whole prompts that run no prefill chunk, evictions, no pin left,
    fewer prefill ticks; then a journaled run crashed at tick 70 (after
    its first checkpoint, requests resident) and ``restore`` from its
    directory, every stream equal to the uncrashed run's, the checkpoint
    used, tokens replayed, each token delivered once, the graphs captured
    after the restore; the prefix entries' bf16 logits through a
    checkpoint file as ``ml_dtypes.bfloat16`` arrays, back bit for bit,
    and the checkpoint state pickled in turns by the port's writer and by
    the C pickler with those leaves widened to float32 (the old format);
    B4b's launches =
    12 x 8 per dispatch in every run; prefix hits, evictions and bytes,
    prefill ticks, TTFT cached against cold, checkpoint size and time,
    journal bytes per token, restore time;
14. serve, exact kinds, lockstep (``phase_serve_exact``): softmax
    slayformer-124m at 12 layers and yat_spherical at 4 (KV rings of
    2048 rows, no kernel) on phase 8's prompts, graphed equal to eager,
    ms per decode step of each in turns beside SLAY's, a profiler window;
    fp32 logits of a 64-token prompt and 4 decode steps on the card
    against the CPU plain path (softmax checked at 2 layers, where fp32
    rounding is well below the tolerance, and printed at 12 as a reading);
15. serve, exact kinds, continuous (``phase_serve_exact_continuous``):
    phase 12's trace and pool on softmax, unpaged, paged (64-row pages,
    every slot's ring) and overcommitted (half the pages), with
    ``debug_audit``: streams equal across the three and to eager (rids
    0-7), no page left allocated, ms per dispatch and prefill tick, pages
    peak, pool MB beside SLAY's; a full-pool dispatch graphed and eager
    with its idle share, unpaged and paged;
16. serve, exact kinds, prefix cache and crash-safe
    (``phase_serve_exact_durable``): phase 13's trace on the paged
    softmax pool with a prefix cache of as many ring snapshots as phase
    13's holds (S, z) ones: cached streams equal to cold ones, then a
    journaled run crashed after its first checkpoint (every 128 ticks)
    and restored to the uncrashed streams; MB and ms per checkpoint;
17. train, exact kind (``phase_train_exact``): 4 AdamW steps of softmax
    slayformer-124m (8 x 1024, plain autograd), a finite, falling loss,
    ms per step beside the fused SLAY step's;
18. serve, speculative (``phase_serve_spec``): the first 8 requests of
    phase 12's trace on its pool with ``speculative=True,
    spec_gamma=2``, the yat_spherical verifier at 12 layers and its SLAY
    twin as the draft (B4b on every draft and resync step): greedy
    streams equal to plain exact decoding's up to near ties of the
    verifier (printed as ties), graphed equal to eager over the first
    dispatches, paged (64-row pages) equal with no page left, the
    acceptance accounting against the rounds in the dispatch buffers,
    B4b 12 x 8 x 5 launches a dispatch, K = 8 and K = 1 equal at T = 0.8
    (4 requests, embedding / 8); ms and tokens per dispatch and pool
    tokens/s beside the plain run's, the acceptance rate, capture ms,
    the pools' MB, a full-pool dispatch's device time and idle share;
19. serve and train, linear baselines (``phase_serve_baselines``):
    favor, cosformer and elu1 slayformer-124m at 12 layers (their
    (S, z) at m = 64, 128 and 64): phase 8's prompts through the lockstep
    engine graphed and eager (equal streams, B4a 12 x 31 launches and no
    other kernel, ms per step in turns); phase 12's trace on its pool,
    graphed, with page_size 64 given and ignored (B4b 12 x 8 a dispatch
    and no other kernel, ms per dispatch, pool tokens/s, pool and prefix
    snapshot MB); a full-pool dispatch under the profiler; fp32 prefill
    and decode logits on the card against the CPU plain path at 12
    layers; 2 AdamW steps of 8 x 1024 tokens (plain autograd, no kernel);
20. the command-line drivers in-process (``phase_drivers``):
    ``train_slayformer --preset paper --attn-kind favor --steps 4`` and
    ``serve --attn-kind cosformer --no-smoke`` (continuous, B4b only);
21. kernels at head dim 128 (``phase_dense_kernels``): K1 at each dense
    decoder's lockstep prefill shape (4 prompts padded to 512; G = 3
    phi4-mini, 48 granite, 8 qwen3) and K3/K4 at its training shape (8 x
    1024), bf16, d = dv = 128, against their plain versions (K3/K4 also
    summed over the group), timed beside their bounds, with residency
    lines (one block of K1, K3, K4 per SM there); K2 at dv = 128 for G =
    1, 2, 3, 4, 6, 8, 48 and 64, masked and not, drained rows
    bit-identical, the groups of the dense configs and of phase 23's
    (gemma2 2, phi3.5-moe 4, grok-1 6) timed beside their byte bounds;
    then hymba-1.5b's cases at head dim 64, G = 5: K1 at its lockstep
    prefill shape (BH = 100, BK = 20, L = 512), K3/K4 at its training
    shape (BH = 200, BK = 40, L = 1024), K2 masked and not at its
    lockstep (20 kv rows) and pool (40) shapes;
22. the dense decoders at full width (``phase_dense``), random weights
    from the seed, the host init timed on its own line: phi4-mini-3.8b cut
    to 8 layers (reduced, for the script's time), granite-20b and
    qwen3-32b to 4 layers
    (reduced: full depth would draw 27.9 B and 32.8 B values on the
    host): phase 8's prompts through the lockstep engine graphed and
    eager (equal streams; K1 once a layer, B4a once a layer and step);
    phase 12's trace on its pool, graphed (B4b nl x 8 a dispatch), its
    first 4 requests again graphed and eager, equal streams; a full-pool
    dispatch under the profiler beside the least time a tick takes to
    read the weights; the first 2 layers in fp32 on the card against the
    CPU plain path (prefill and 2 decode steps' logits, one batch's loss
    and gradients); 4 AdamW steps (lr 1e-4) of 8 x 1024 tokens at 4
    layers through K1, K3 and K4, the step donating the weights and
    moments (a finite, falling loss; the batch halved only if the card
    cannot hold it, and the cut printed: qwen3's 151936-row logits take
    a batch of 4, where it starts, ``TRAIN_CUTS``);
23. gemma2-27b and the top-2 MoE decoders at full width
    (``phase_mixed``), random weights from the seed drawn on the host:
    gemma2-27b cut to 4 layers (0 and 2 local: sliding-window softmax
    over 4096 tokens, softcap 50; 1 and 3 global SLAY), phi3.5-moe-
    42b-a6.6b to 2 (16 experts of 6400, top 2) and grok-1-314b to 1 (8
    experts of 32768; 64 layers would draw 316 B values on the host), as
    phase 22 serves the dense ones (lockstep graphed and eager, phase
    12's trace graphed, a full-pool dispatch under the profiler beside
    the weights' read); the SLAY kernels' launches counted per layer kind
    (gemma2's local layers launch none); a 6144-token prompt (past the
    window) on the pool with rings of 4096 rows, graphed equal to eager,
    its first token against the whole-prompt prefill's argmax (gemma2;
    a reading for phi3.5-moe, whose capacity is per call); gemma2's
    last-token logits at 1 x 8192 through the banded route against the
    masked one; fp32 at 2 layers against the CPU (gemma2: one local, one
    global; logits, loss, ``moe_aux``, gradients); 4 AdamW steps of
    gemma2 (4 layers, from a batch of 2: ``TRAIN_CUTS``) and phi3.5-moe
    (2 layers) (batch halved only if the card cannot hold it; the peak
    memory printed); grok-1 gets no train step
    (one layer's would need about 78 GB), which a line says.
24. the SSM families at full width (``phase_ssm``), depth halved for
    the script's time, random weights from the seed drawn on the host:
    mamba2-780m (24 of its 48 attention-free SSD layers, a 37.7 MB carry
    per slot) and hymba-1.5b (16 of its 32 layers of SLAY at G = 5
    beside SSD heads), each served lockstep
    graphed and eager (hymba: K1 once a layer, B4a once a layer and
    step; mamba2: no SLAY kernel), phase 12's trace graphed (B4b nl x 8
    a dispatch for hymba) and its first 4 requests graphed and eager, a
    full-pool dispatch under the profiler beside the weights' read plus
    the pool state's read and write, a 6144-token prompt in 128-token
    chunks graphed and eager (its first token against the whole-prompt
    prefill's argmax), mamba2's prefix cache and crash-restore through a
    checkpoint of its pool, fp32 at 2 layers against the CPU (logits;
    the loss and gradients of one 256-token chunk, finite, ROADMAP
    C-10), and 4 AdamW steps of 8 x 1024 tokens with remat (hymba's
    through K1 twice, K3 and K4 once a layer), the peak memory printed.
25. the frontends (``phase_frontends``), random weights from the seed
    drawn on the host: internvl2-76b at full width, 4 of its 80 layers
    (reduced: 80 would be 70.6 B params, 141 GB), served as phase 22
    serves the dense decoders with every request behind its zero
    256-row patch prefix (the pool absorbs it in 2 chunks of 128 ahead
    of the prompt), the 6144-token prompt behind the prefix chunked
    against whole, fp32 at 2 layers against the CPU with random patch
    embeddings, 4 AdamW steps at 2 layers of 4 x (256 + 768) rows;
    whisper-small whole (12 + 12 layers x 768, 1500 frames): phase 8's
    prompts over zero frames lockstep, graphed and eager, phase 12's
    trace through the whole-prompt prefill (one tick a request, no
    prefix cache), its pool's MB a slot under SLAY against softmax, a
    full-pool dispatch under the profiler, fp32 at 2 + 2 layers against
    the CPU (logits, loss, gradients), B7 and B8 at its shapes, 4 AdamW
    steps of 8 x 448 tokens over 1500 random frames; and slayformer-124m
    on phase 12's trace with ``prefill_chunk=0`` (the bucketed masked
    prefill through K1), its bucket counters, its streams against the
    chunked run's (bf16 up to near-ties of the whole-prompt path, fp32
    up to each stream's first near-tie). Launches are checked per layer
    kind: whisper's decoder self-attention runs K1 (K3, K4) and K2, its
    encoder's and cross-attention's Ψ B7 (B8), twice a layer.
26. the rest of the core (``phase_core``): every feature config, the
    long-context example, a 32,768-token prompt, the quickstart.
27. the sharded paths on a one-rank NCCL group (``phase_sharded``; the
    card holds one device and NCCL puts one rank on a device, so the
    multi-rank arithmetic is the CPU tests' with gloo): the 1x1
    ``DeviceMesh`` on ``cuda``; slayformer-124m at full width through
    ``Trainer(mesh=...)`` (DTensor parameters and moments, the batch
    placed by ``batch_sharding``, K1, K3 and K4 through ``local_map``),
    4 steps of phase 9's batches from phase 9's weights: 12 K1, K3 and K4
    launches a step, losses within 1e-4 relative of phase 9's first 4, ms
    per step beside phase 9's; one ``remat="save_collectives"`` step (24
    K1); the continuous engine with ``mesh`` on the first 8 requests of
    phase 12's trace, graphed, beside the unsharded engine: equal
    streams, 12 x 8 B4b launches a dispatch, ms per dispatch of each.
28. ROADMAP C-15's configs on the routes ``ops.attention_route`` picks
    before any launch (``phase_c15``): slayformer-124m at 2 layers with
    R = 12 (Ψ in PyTorch ops, then B5, B6a, B6b), P = 4, D = 6 (the
    two-dispatch kernels under a gradient, K1 without) and head dim 128
    at P = D = 32 (Ψ in PyTorch ops: B8 would need 362,752 B), beside the
    fused default: 4 bf16 AdamW steps of 4 x 1024 tokens each, every
    step's launches the route's, step times against the default's; each
    C-15 config's fp32 loss of 1 x 512 tokens on the card within 1e-5
    relative of the CPU plain path's from the same weights; then
    full-depth R = 12
    (m = 1536) served by ``generate`` in fp32, its prefill through B5 and
    every decode step through K2, greedy streams equal to the CPU's on a
    trace with no near-tie.
29. the dry run (``phase_dryrun``): ``repro_torch.launch.dryrun`` of
    slayformer-124m at full depth on a one-rank ``fake`` world (meta
    tensors, in a child process: ``chip_smoke.py --dryrun-child PATH``)
    for one train step of phase 9's 8 x 1024 tokens (2 microbatches,
    remat), one prefill of phase 8's 4 x 512 and one decode step; the
    same three steps on the card (each after a warm-up call): launches
    per kernel and argument bytes equal to the dry run's, peak memory
    (``max_memory_allocated`` over the step) and the roofline's terms
    printed beside the measured step (the median of 10 calls timed by
    CUDA events, every reading, and a profiler window's device busy
    time and idle share); the continuous engine's trace contracts
    (``contract_traces``: one eager decode dispatch and a prefill tick)
    on the card with no finding.
The bounds every phase prints come from ``repro_torch.launch.roofline``.
Phases 14-17 and mamba2's part of phase 24 check that no SLAY kernel
launched, phases 19-20 that only K2 did; the kernel line's B4a launches
are phase 8's, 19's, 22's, 23's, 24's and 25's, its B4b launches phase
12's, 18's, 19's, 20's, 22's, 23's, 24's and 25's, its K1 launches phase
8's, 22's, 23's, 24's and 25's, its K3 and K4 launches phase 9's, 22's,
23's, 24's and 25's, its B7 and B8 launches phase 11's and 25's, and
every row phase 26's, 27's (B1-B4b), 28's and 29's (B1-B4b), under
``core``, ``sharded``, ``c15`` and ``dryrun`` too (each
row has the dense decoders' launches, G and head-dim-128 numbers per
config under ``dense_decoders``, phase 23's configs' under
``mixed_and_moe``, phase 24's, with hymba's kernels at head dim 64,
under ``ssm_families``, and phase 25's under ``frontends``, with B7's
and B8's numbers at whisper's shapes).

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
import gc
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch import configs, prng  # noqa: E402
from repro_torch.configs.base import ServingConfig  # noqa: E402
from repro_torch.core import features  # noqa: E402
from repro_torch.core import linear_attention as la  # noqa: E402
from repro_torch.core.features import init_feature_params  # noqa: E402
from repro_torch.core.slay import feature_dim  # noqa: E402
from repro_torch.examples import (long_context, quickstart, serve,  # noqa: E402
                                  train_slayformer)
from repro_torch.kernels import (_build, decode_step, feature_map, ops,  # noqa: E402
                                 slay_fused, slay_scan)
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BYTES_PER_S, HBM_PER_CARD, bwd_bounds, bwd_tc_bounds,
    feature_map_bounds, k1_bound, k1_tc_bound, k2_bound, scan_bounds,
    scan_tc_bounds)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.serving import (checkpoint, engine, faults,  # noqa: E402
                                 journal, sampling)
from repro_torch.train import loop  # noqa: E402
from repro_torch.tree import (tree_items, tree_leaves, tree_map,  # noqa: E402
                              tree_map_with_path)

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn):
    """Log the wall seconds each call of ``fn`` takes, a config's part
    (where the script's time goes)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log(f"  [{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out
    return run


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
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"device memory: {total} B reported by the card "
        f"({total / 2**30:.2f} GiB), {HBM_PER_CARD:.0f} B on the data sheet "
        f"(repro_torch.launch.roofline)  [{line}]")
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


# K2 at the linear baselines' widths (favor and elu1 m = 64: 4 blocks of
# 16 feature rows a kv row; cosformer m = 128: 8 of 16, its features'
# second half zero, ROADMAP C-8): (name, BK, m, qf dtype, masked), dv =
# 64, G = 1, v bf16 as the models' values. The lockstep engine's shape is
# BK = 4 prompts x 12 heads = 48, the pool's 8 slots x 12 = 96.
K2_BASELINE_CASES = (
    ("favor lockstep BK=48 m=64 qf fp32", 48, 64, torch.float32, False),
    ("favor pool BK=96 m=64 qf fp32 masked", 96, 64, torch.float32, True),
    ("elu1 lockstep BK=48 m=64 qf bf16", 48, 64, torch.bfloat16, False),
    ("elu1 pool BK=96 m=64 qf bf16 masked", 96, 64, torch.bfloat16, True),
    ("cosformer lockstep BK=48 m=128 qf bf16", 48, 128, torch.bfloat16,
     False),
    ("cosformer pool BK=96 m=128 qf bf16 masked", 96, 128, torch.bfloat16,
     True),
)


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
    cases += [(name, bk, bk, m, qdt, torch.bfloat16, masked)
              for name, bk, m, qdt, masked in K2_BASELINE_CASES]
    baselines = {}
    for name, bh, bk, m, qdt, vdt, masked in cases:
        log(f"K2 {name}")
        qf, kf, v, s, z = _k2_inputs(gen, bh, bk, m, dv, qdt, vdt)
        if name.startswith("cosformer"):
            qf[:, m // 2:] = 0
            kf[:, m // 2:] = 0
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
        if name.split()[0] in ("favor", "elu1", "cosformer"):
            baselines[name] = _k2_timed(
                name, qf, kf, v, s, z, active, err)
            if name.endswith("masked") and name.startswith(("favor",
                                                            "cosformer")):
                log_residency("slay_decode_step", "decode_step",
                              "decode_step_kernel",
                              decode_step.residency(bk, 1, m, dv, qdt, vdt),
                              dv, f"{name}, dv={dv}",
                              inst=("If13__nv_bfloat16Li64E"
                                    if qdt == torch.float32
                                    else "I13__nv_bfloat16S1_Li64E"),
                              unit="feature rows")
    return dict(result, baselines=baselines)


def _k2_timed(name, qf, kf, v, s, z, active, err) -> dict:
    """K2's times at one of K2_BASELINE_CASES: CUDA events around the
    wrapper, the profiler's device time, the plain version's, and the
    bound over the active rows."""
    step = functools.partial(decode_step.decode_linear_attention, qf, kf, v,
                             s, z, active)
    ms, dev_ms = time_ms(step, iters=50), device_ms(step)
    plain_ms = time_ms(lambda: decode_step.decode_linear_attention_plain(
        qf, kf, v, s, z, active), iters=20)
    bk, m = kf.shape
    n_act = bk if active is None else int(active.sum())
    bound, by, n_ops, nb = k2_bound(qf.shape[0], bk, n_act, m, v.shape[1],
                                    qf.element_size(), v.element_size())
    log(f"  {name}: kernel {ms:.4f} ms ({dev_ms:.4f} ms on the card), plain "
        f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by} ({n_ops:.3e} FLOP, "
        f"{nb:.3e} B, {n_act} of {bk} rows active); library: none")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


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

    step_ms = _lockstep_graphs(cfg, params, reqs, eng, outs, card)

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
    return launches, outs, lock_ms, step_ms


def _same_outputs(want, got, what: str) -> None:
    """Equal token streams, request by request (lists of arrays)."""
    bad = [i for i, (w, g) in enumerate(zip(want, got))
           if not np.array_equal(w, g)]
    if bad or len(want) != len(got):
        raise AssertionError(f"{what}: streams differ for requests {bad}")


def _lockstep_graphs(cfg, params, reqs, eng, outs, card: str) -> None:
    """The lockstep decode step (model and sampler) replayed as one CUDA
    graph per batch size and temperature, against the same engine run
    eagerly (``_graphs=False``): equal tokens greedy and at T = 0.8 (the
    embedding divided by 8, as phase 12, so that the draws decide tokens;
    at least one stream must then differ from greedy), and ms per decode
    step of each, in turns (CUDA events around each step, which ends in
    a sync as ``generate``'s does)."""
    eager = engine.ServingEngine(cfg, params, device="cuda", max_len=2048,
                                 _graphs=False)
    _same_outputs(outs, eager.generate(reqs), "lockstep greedy, graphed vs "
                  "eager")
    soft = dict(params, embed=params["embed"] / 8)
    hot = [engine.ServingEngine(cfg, soft, device="cuda", max_len=2048,
                                _graphs=g) for g in (True, False)]
    greedy = hot[0].generate(reqs)
    sampled = [e.generate(reqs, temperature=0.8, seed=SEED) for e in hot]
    _same_outputs(*sampled, "lockstep T = 0.8, graphed vs eager")
    differ = sum(not np.array_equal(a, b) for a, b in zip(sampled[0], greedy))
    if not differ:
        raise AssertionError("lockstep T = 0.8: no stream differs from "
                             "greedy, the draws decided no token")
    graphs = eng.graph_cache_entries()
    if graphs != {"decode": 2}:      # batch 1 (the warm-up) and batch 4
        raise AssertionError(f"lockstep graphs {graphs}, want 2")
    B = len(reqs)
    steps = {"graphed": eng._lockstep(B, 0.0).step,
             "eager": eager._lockstep(B, 0.0).step}
    ms: dict = {k: [] for k in steps}
    with torch.inference_mode():
        for name in ("graphed", "eager", "eager", "graphed"):
            ms[name].append(time_ms(steps[name], iters=MAX_NEW - 1,
                                    warmup=2))
        med = {k: statistics.median(v) for k, v in ms.items()}
        each = {k: ", ".join(f"{x:.3f}" for x in v) for k, v in ms.items()}
        log(f"  lockstep graphs: {graphs}; streams equal to eager greedy "
            f"({B}) and at T = 0.8 ({differ} of {B} off greedy); ms per "
            f"decode step graphed {med['graphed']:.3f} ({each['graphed']}), "
            f"eager {med['eager']:.3f} ({each['eager']}) (in turns)  "
            f"[{card}]")
        for name in ("graphed", "eager"):
            profile(f"lockstep decode step, {name}", steps[name], med[name])
    return med


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
    return launches, losses, step_s


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
CONT_HOT_REQUESTS = 8          # the sampled runs take the first 8
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


def _cont_run(cfg, params, reqs, timed=None, graphs=True, **serving):
    """One ContinuousServingEngine run on the card: (outputs, summary,
    engine, wall seconds). ``timed`` collects the seconds of every decode
    dispatch and prefill tick, from CUDA events recorded around each (the
    engine syncs only where it would unwrapped: once per dispatch, once
    per finished prompt), and the wall time at which each step ends.
    ``graphs=False`` runs the engine's programs eagerly instead of
    replaying their CUDA graphs."""
    kw = {**CONT_SERVING, **serving}
    inj = kw.pop("fault_injector", None)
    eng = engine.ContinuousServingEngine(
        cfg, params, serving=ServingConfig(**kw), device="cuda",
        fault_injector=inj, _graphs=graphs)
    return _timed_run(eng, reqs, timed)


def _timed_run(eng, reqs, timed=None, max_ticks=None):
    """``eng.run`` over copies of ``reqs`` on the card (up to
    ``max_ticks``), timed as :func:`_cont_run` says; (outputs, summary,
    engine, wall seconds)."""
    events: list = []
    if timed is not None:
        marks = timed.setdefault("ticks", [(0, time.perf_counter())])
        step = eng.step

        def stepped():
            out = step()
            marks.append((eng.tick, time.perf_counter()))
            return out

        eng.step = stepped
        for name in ("_decode_macro", "_decode_spec", "_prefill_tick"):
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
    outs, s = eng.run([dataclasses.replace(r) for r in reqs],
                      max_ticks=max_ticks)
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


def _ttft_ms(per, timed) -> list:
    """TTFT in ms of every request in ``per`` (RequestStats by rid), from
    the wall time at which the engine's tick clock passed the request's
    arrival (all were submitted at the start of a ``_cont_run``)."""
    marks = timed["ticks"]
    return [(st.first_token_wall - next(w for t, w in marks
                                        if t >= st.arrival)) * 1e3
            for st in per.values()]


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


def _cont_profile(cfg, params, card: str, extra=None,
                  pieces: bool = True, sampled: bool = True,
                  eager: bool = True) -> dict:
    """One macro dispatch of a full pool (8 slots live), replayed as the
    engine's CUDA graph and run eagerly (``_graphs=False``), in turns, and
    graphed at T = 0.8 (the sampler's device time): the wall time of each
    (median of 3), the profiler's device time and idle share, and beside
    it (``pieces``) the pieces of one tick timed alone (CUDA events):
    the model's masked decode step, sampling at T = 0.8 and greedy, the
    fault lane. ``extra`` adds ServingConfig fields (paging);
    ``sampled=False`` leaves out the T = 0.8 engine, ``eager=False`` the
    eager one. Returns the median wall ms by name."""
    S, K = CONT_SERVING["num_slots"], CONT_SERVING["macro_ticks"]
    engs = {}
    for name, graphed, temp in (("graphed", True, 0.0),
                                ("eager", False, 0.0),
                                ("graphed, T = 0.8", True, 0.8)):
        if (temp and not sampled) or not (graphed or eager):
            continue
        eng = engine.ContinuousServingEngine(
            cfg, params, serving=ServingConfig(**CONT_SERVING, **(extra or {}),
                                               temperature=temp),
            device="cuda", _graphs=graphed)
        rng = np.random.default_rng(SEED + 3)
        for _ in range(S):
            eng.submit(engine.Request(rng.integers(0, cfg.vocab_size, 128)
                                      .astype(np.int32), max_new_tokens=512))
        while eng._prefill is not None or eng.sched.ready or eng.sched.waiting:
            eng.step()
        if len(eng.sched.active) != S:
            raise AssertionError(f"pool not full: {sorted(eng.sched.active)}")
        eng.step()                   # a full-pool dispatch (captured first)
        engs[name] = eng
    graphs = engs["graphed"].graph_cache_entries()
    if graphs.get("spec_macro", graphs["macro_decode"]) != 1:
        raise AssertionError(f"the full-pool engine captured no dispatch "
                             f"graph: {graphs}")
    walls: dict = {name: [] for name in engs}
    for name in ("graphed", "eager", "eager", "graphed", "graphed", "eager",
                 "graphed, T = 0.8", "graphed, T = 0.8", "graphed, T = 0.8"):
        if name not in engs:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engs[name].step()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    med = {}
    for name, eng in engs.items():
        wall = med[name] = statistics.median(walls[name])
        log(f"  one dispatch of a full pool ({S} slots, K = {K}), {name}: "
            f"{wall:.2f} ms wall (median of 3: "
            f"{', '.join(f'{w:.2f}' for w in walls[name])}), "
            f"{wall / K:.2f} ms a tick  [{card}]")
        profile(f"continuous dispatch (K={K}, {S} slots), {name}", eng.step,
                wall)
    if not pieces:
        return med
    eng = engs["eager"]
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
    return med


def _cont_graphs_vs_eager(cfg, params, sub, outs, card: str) -> None:
    """The first requests of the trace, greedy, with the engine's CUDA
    graphs and without (``_graphs=False``), in turns (eager, graphed,
    graphed, eager): every stream equal to the main run's; per side the
    median over its runs of ms per dispatch and per prefill tick (CUDA
    events), pool decode tokens/s, TTFT and the run's wall time. Then, on
    the last engine of each side, ms per full prefill chunk (a replay of
    its graph, or the program run eagerly) in turns, and of a tail of
    half a chunk, which runs eagerly on both."""
    side: dict = {True: [], False: []}
    engs = {}
    for graphed in (False, True, True, False):
        timed: dict = {}
        o, s, e, wall = _cont_run(cfg, params, sub, timed=timed,
                                  graphs=graphed)
        engs[graphed] = e
        name = "graphed" if graphed else "eager"
        _same_streams(outs, o, f"greedy rids 0-{len(sub) - 1}, {name} vs "
                      f"the main run")
        disp, pre = timed["_decode_macro"], timed["_prefill_tick"]
        side[graphed].append(dict(
            disp=statistics.median(disp) * 1e3,
            pre=statistics.median(pre) * 1e3,
            tps=(s["tokens_generated"] - len(sub)) / sum(disp),
            ttft=statistics.median(_ttft_ms(e.metrics.per_request, timed)),
            wall=wall, graphs=e.graph_cache_entries(),
            n=s["decode_dispatches"]))
    for graphed in (True, False):
        runs = side[graphed]

        def med(k, runs=runs):
            return statistics.median(r[k] for r in runs)

        each = ", ".join(f"{r['disp']:.2f}" for r in runs)
        log(f"  {'graphed' if graphed else 'eager'}, rids 0-{len(sub) - 1} "
            f"({len(runs)} runs, in turns): ms per dispatch {med('disp'):.2f}"
            f" (runs {each}; {runs[0]['n']} dispatches), prefill tick "
            f"{med('pre'):.2f} ms, "
            f"pool decode {med('tps'):.1f} tokens/s, TTFT median "
            f"{med('ttft'):.1f} ms, run {med('wall'):.3f} s; graphs "
            f"{runs[0]['graphs']}  [{card}]")
    log(f"  greedy streams of rids 0-{len(sub) - 1} graphed and eager: "
        f"identical to the main run's")
    C = CONT_SERVING["prefill_chunk"]
    tail = torch.from_numpy(sub[0].prompt[None, :C // 2]).cuda()
    chunk: dict = {True: [], False: []}
    with torch.inference_mode():
        for graphed in (True, False, False, True):
            chunk[graphed].append(time_ms(engs[graphed]._chunk, iters=10))
        tails = {g: time_ms(lambda e=e: e._absorb(tail), iters=10)
                 for g, e in engs.items()}
    each = {g: ", ".join(f"{x:.2f}" for x in v) for g, v in chunk.items()}
    log(f"  a full prefill chunk ({C} tokens), in turns: graphed "
        f"{statistics.median(chunk[True]):.2f} ms ({each[True]}), eager "
        f"{statistics.median(chunk[False]):.2f} ms ({each[False]}); a "
        f"{C // 2}-token tail, eager in both: {tails[True]:.2f} ms "
        f"(graphed engine), {tails[False]:.2f} ms (eager engine)  [{card}]")


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
    ttft_ms = _ttft_ms(per, timed)
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
    graphs = eng.graph_cache_entries()
    if graphs != {"macro_decode": 1, "chunk": 1}:
        raise AssertionError(f"graphs after the run: {graphs}")
    log(f"  graphs {graphs}: one decode dispatch replayed "
        f"{s['decode_dispatches'] - 1} times after its eager first call "
        f"(capture {eng._decode.capture_s * 1e3:.1f} ms, "
        f"{eng._decode.launches} per replay); one full prefill chunk "
        f"(capture {eng._chunk.capture_s * 1e3:.1f} ms); a tail shorter "
        f"than the chunk runs eagerly  [{card}]")
    _cont_graphs_vs_eager(cfg, params, reqs[:CONT_K1_REQUESTS], outs, card)

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
    hot_eager, _, _, _ = _cont_run(cfg, soft, hot, temperature=0.8,
                                   graphs=False)
    _same_streams(hot_eager, hot8, "temperature 0.8, graphed vs eager")
    differ = [r for r in hot8 if not np.array_equal(hot8[r], cold[r])]
    moved = sum(int((hot8[r] != cold[r]).sum()) for r in hot8)
    log(f"  sampled streams (T = 0.8, embedding / 8) of rids 0-{len(hot) - 1}"
        f" for macro_ticks 8 and 1 and eager: identical; {len(differ)} of "
        f"{len(hot8)}"
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
    pool = dict(dispatch_ms=_cont_profile(cfg, params, card),
                pool_mb=_tree_mb(eng.pool))
    del params, eng, feng
    torch.cuda.empty_cache()
    _cont_fp32(cfg, reqs)
    b4b = _b4b_pool_row(s["mean_slot_occupancy"])
    log(f"serve (continuous): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, b4b, pool


DUR_SERVING = dict(CONT_SERVING, prefix_cache_bytes=160 << 20,
                   checkpoint_every_ticks=64)
DUR_SYSTEM = 384               # the shared system prompt: 3 chunks of 128
DUR_REPEATS = (8, 9, 10, 11)   # requests 12-15 repeat these prompts
DUR_HOT = 8                    # the sampled runs take the first 8
DUR_CRASH = (70, 70)           # the crashed run dies at its first step from it


def _dur_requests(cfg):
    """The phase's trace: 16 requests, each a shared 384-token system
    prompt and a unique suffix of 16-200 tokens, 16-48 new tokens, one
    arrival every 2 ticks, from the script's seed. Requests 12-15 repeat
    the prompts of requests 8-11: admitted in arrival order, each finds
    the whole-prompt entry that its original stored a few admissions
    before (the prompts of requests 0-3 would have been evicted by then,
    the LRU holding 11 snapshots of the 20 that 12 prompts store)."""
    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size
    system = rng.integers(0, V, DUR_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, V, int(n))])
               .astype(np.int32) for n in rng.integers(16, 201, 12)]
    prompts += [prompts[i] for i in DUR_REPEATS]
    news = rng.integers(16, 49, len(prompts))
    return [engine.Request(p, max_new_tokens=int(m), arrival_time=2.0 * i)
            for i, (p, m) in enumerate(zip(prompts, news))]


def _b4b_launches(what: str, dispatches: int, nl: int, K: int) -> int:
    """B4b's launches since the last reset: nl x K per dispatch, and no
    fused-forward or unmasked decode launch."""
    got = _build.LAUNCHES["slay_decode_step_masked"]
    if got != nl * K * dispatches or not dispatches:
        raise AssertionError(f"{what}: B4b launched {got} times, want {nl} x "
                             f"{K} x {dispatches} dispatches")
    if _build.LAUNCHES["slay_fused_fwd"] or _build.LAUNCHES[
            "slay_decode_step"]:
        raise AssertionError(f"{what}: K1 or the unmasked K2 ran: "
                             f"{_build.LAUNCHES}")
    return got


def _timed_checkpoints(eng, ms: list) -> None:
    """Record the ms of every ``eng.checkpoint()`` (the journal flush,
    the pool's copy to the host, pickling, writing and fsync)."""
    inner = eng.checkpoint

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.checkpoint = timed


def _widened(node):
    """``node`` with every bf16 leaf widened to float32, as the port wrote
    its checkpoints before it wrote them in the JAX writer's format."""
    if isinstance(node, dict):
        return {k: _widened(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_widened(v) for v in node]
    if isinstance(node, checkpoint.Bf16Words):
        return (node.words.astype(np.uint32) << 16).view(np.float32)
    return node


def _checkpoint_format(eng, card: str) -> None:
    """The bf16 last-token logits of the cached run's whole-prompt prefix
    entries through a checkpoint file and back: the payload names the
    JAX writer's ``ml_dtypes.bfloat16`` global (the port never imports
    it), and the loaded words are the tensors' own, bit for bit. Then the
    engine's checkpoint state pickled in turns by the port's writer and
    by the C pickler with the bf16 leaves widened to float32 (the format
    before), ms and MB of each."""
    ents = [e for e in eng.prefix_cache.entries() if e.logits is not None]
    if not ents or ents[0].logits.dtype != torch.bfloat16:
        raise AssertionError("no bf16 logits in the prefix cache")
    d = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        path = checkpoint.checkpoint_path(d, 0)
        checkpoint.save(path, {"logits": [checkpoint.to_numpy(e.logits)
                                          for e in ents]})
        with open(path, "rb") as f:
            named = b"\x8c\tml_dtypes\x94\x8c\x08bfloat16\x94\x93" in f.read()
        back = checkpoint.load(path)["logits"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for e, lg in zip(ents, back):
        got = torch.from_numpy(lg).to(torch.bfloat16)
        if not (named and torch.equal(got.view(torch.int16),
                                      e.logits.cpu().view(torch.int16))):
            raise AssertionError("a bf16 leaf did not come back bit for bit"
                                 " as the JAX writer's bfloat16 array")
    log(f"  bf16 checkpoint leaves: {len(ents)} prefix entries' logits "
        f"({tuple(ents[0].logits.shape)}) written as ml_dtypes.bfloat16 "
        f"arrays and read back bit for bit")
    state = checkpoint.snapshot_engine(eng)
    old = _widened(state)
    writers = {"port": lambda: checkpoint.dumps(state),
               "float32": lambda: pickle.dumps(old, protocol=4)}
    ms: dict = {k: [] for k in writers}
    mb = {}
    for name in ("port", "float32", "float32", "port", "port", "float32"):
        t0 = time.perf_counter()
        mb[name] = len(writers[name]()) / 1e6
        ms[name].append((time.perf_counter() - t0) * 1e3)
    each = {k: ", ".join(f"{x:.1f}" for x in v) for k, v in ms.items()}
    log(f"  the checkpoint state pickled, in turns: the port's writer "
        f"(bf16 leaves as ml_dtypes.bfloat16, pure-Python pickler) "
        f"{statistics.median(ms['port']):.1f} ms ({each['port']}), "
        f"{mb['port']:.1f} MB; the C pickler, bf16 leaves widened to "
        f"float32 {statistics.median(ms['float32']):.1f} ms "
        f"({each['float32']}), {mb['float32']:.1f} MB  [{card}]")


def _dur_crash_restore(cfg, params, reqs, want, card: str, *, serving=None,
                       crash_window=DUR_CRASH, launches=None) -> None:
    """The cached trace on a journaled engine that crashes mid-run, then
    ``restore`` from its directory and the run to the end: every stream
    equal to the uncrashed cached run's, each token delivered once across
    the two engines, the checkpoint used and tokens replayed. ``serving``
    (default phase 13's) and ``launches`` (default B4b's count) serve the
    exact kinds' durable phase."""
    nl, K = cfg.num_layers, DUR_SERVING["macro_ticks"]
    serving = serving or ServingConfig(**DUR_SERVING)
    launches = launches or _b4b_launches
    d = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        delivered = collections.defaultdict(list)

        def on_token(rid, tok):
            delivered[rid].append(int(tok))

        ckpt_ms: list = []
        eng = engine.ContinuousServingEngine(
            cfg, params, serving=serving, device="cuda",
            journal=journal.Journal(os.path.join(d, journal.JOURNAL_NAME)),
            fault_injector=faults.FaultInjector(seed=SEED,
                                                crash_window=crash_window))
        _timed_checkpoints(eng, ckpt_ms)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            eng.run([dataclasses.replace(r, on_token=on_token)
                     for r in reqs])
        except faults.EngineCrash as crash:
            tick = crash.tick
        else:
            raise AssertionError("the injected crash did not fire")
        crashed_s = time.perf_counter() - t0
        m = eng.metrics
        n1 = launches("crashed run", m.decode_dispatches, nl, K)
        resident = sorted(rec.rid for rec in eng.sched.active.values())
        if not (m.checkpoints_written >= 1 and resident):
            raise AssertionError(f"crash at tick {tick}: {m.checkpoints_written}"
                                 f" checkpoints, residents {resident}")
        log(f"  crashed run: died at tick {tick} after {crashed_s:.3f} s, "
            f"{m.checkpoints_written} checkpoints, rids {resident} resident, "
            f"{m.decode_dispatches} dispatches, B4b launched {n1} times")
        del eng
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng2 = engine.ContinuousServingEngine.restore(
            d, cfg, params, serving=serving, device="cuda",
            on_token=on_token)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        rec = eng2.recovery
        _timed_checkpoints(eng2, ckpt_ms)
        _build.reset_launches()
        outs, s, _, wall = _timed_run(eng2, [])
        n2 = launches("restored run", s["decode_dispatches"], nl, K)
        if eng2.graph_cache_entries()["macro_decode"] != 1:
            raise AssertionError(f"restored engine graphs "
                                 f"{eng2.graph_cache_entries()}")
        _same_streams(want, outs, "restored vs uncrashed cached run")
        if set(outs) != set(want):
            raise AssertionError(f"restored rids {sorted(outs)}")
        if not (rec["checkpoint_used"] and rec["resident_resumed"] >= 1
                and s["tokens_replayed"] > 0):
            raise AssertionError(f"restore: {rec}, {s['tokens_replayed']} "
                                 f"tokens replayed")
        twice = [r for r in want if delivered[r] != want[r].tolist()]
        if twice:
            raise AssertionError(f"on_token did not see each token of rids "
                                 f"{twice} exactly once")
        sizes = [os.path.getsize(p) for _, p in
                 checkpoint.list_checkpoints(d)]
        tokens = sum(len(o) for o in outs.values())
        log(f"  restore: {restore_ms:.1f} ms (checkpoint of tick "
            f"{rec['checkpoint_tick']} used, {rec['resident_resumed']} "
            f"resident, {rec['requeued']} queued again, "
            f"{rec['terminal_from_journal']} ended in the journal); the run "
            f"after it {wall * 1e3:.1f} ms, {s['decode_dispatches']} "
            f"dispatches, B4b launched {n2} times, {s['tokens_replayed']} "
            f"tokens replayed; every stream equal to the uncrashed run's, "
            f"each token delivered once; graphs captured after restore "
            f"{eng2.graph_cache_entries()}  [{card}]")
        log(f"  checkpoints: {len(ckpt_ms)} written, {np.mean(sizes) / 1e6:.1f}"
            f" MB each (min {min(sizes) / 1e6:.1f}, max {max(sizes) / 1e6:.1f}"
            f"), ms per checkpoint() median {statistics.median(ckpt_ms):.1f} "
            f"(min {min(ckpt_ms):.1f}, max {max(ckpt_ms):.1f}), fsync "
            f"included; journal {s['journal_bytes']} bytes, "
            f"{s['journal_bytes'] / tokens:.1f} bytes per token  [{card}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_serve_durable(card: str) -> None:
    """The prefix cache and crash-safe serving on the card at full width:
    16 requests on a shared 384-token system prompt through
    ``ContinuousServingEngine`` with a 160 MiB prefix cache, held to a
    cold run (greedy, and sampled at T = 0.8), then crashed mid-run with a
    journal and checkpoints every 64 ticks and restored. Checks streams,
    hits, evictions, pins and B4b's launches; prints the cache's numbers,
    prefill ticks, TTFT, checkpoint and restore costs."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m")
    nl, K = cfg.num_layers, DUR_SERVING["macro_ticks"]
    budget = DUR_SERVING["prefix_cache_bytes"]
    log(f"serve (prefix cache, crash-safe) {cfg.name}: {nl}L x "
        f"{cfg.d_model}d, {cfg.dtype}, ServingConfig("
        f"{', '.join(f'{k}={v}' for k, v in DUR_SERVING.items())}), 16 "
        f"requests on a {DUR_SYSTEM}-token system prompt, suffixes of "
        f"16-200, 16-48 new tokens, requests 12-15 repeating 8-11")
    params = api.init_params(cfg, SEED, device="cuda")
    reqs = _dur_requests(cfg)
    runs = {}
    for name, nbytes in (("cold", 0), ("cached", budget)):
        timed: dict = {}
        _build.reset_launches()
        outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed,
                                       prefix_cache_bytes=nbytes)
        n = _b4b_launches(f"{name} run", s["decode_dispatches"], nl, K)
        runs[name] = (outs, s, eng, _ttft_ms(eng.metrics.per_request, timed))
        log(f"  {name} run: {wall:.3f} s, {s['ticks']} ticks "
            f"({s['prefill_ticks']} prefill, {s['decode_dispatches']} "
            f"dispatches), {s['prompt_tokens']} prompt tokens absorbed, B4b "
            f"launched {n} times  [{card}]")
    (cold, sc, _, cold_ms), (warm, sw, eng, warm_ms) = (runs["cold"],
                                                        runs["cached"])
    _same_streams(cold, warm, "greedy, cached vs cold")
    if set(warm) != set(cold):
        raise AssertionError(f"rids {sorted(warm)} vs {sorted(cold)}")
    pc, per = eng.prefix_cache, eng.metrics.per_request
    st = pc.stats()
    full = [r for r, x in per.items() if x.prefix_tokens == x.prompt_len]
    if not (st["hits"] >= 15 and sw["prefix_hits"] == st["hits"]
            and full == [12, 13, 14, 15]
            and all(per[r].first_token == per[r].admitted for r in full)
            and st["evictions"] > 0 and pc.live_refs() == 0
            and sw["prefill_ticks"] < sc["prefill_ticks"]):
        raise AssertionError(f"prefix cache: {st}, full hits {full}, "
                             f"prefill ticks {sw['prefill_ticks']} vs "
                             f"{sc['prefill_ticks']}")
    log(f"  prefix cache: {st['hits']} hits ({len(full)} of whole prompts, "
        f"rids {full}, each admitted and first token in one tick with no "
        f"chunk), {st['misses']} misses, {st['evictions']} evictions, "
        f"{st['entries']} entries, {st['bytes'] / 2 ** 20:.1f} of "
        f"{budget / 2 ** 20:.0f} MiB, {st['tokens_reused']} prompt tokens "
        f"reused; no pin left; streams equal to the cold run's")
    log(f"  prefill ticks: cold {sc['prefill_ticks']}, cached "
        f"{sw['prefill_ticks']}; prompt tokens absorbed {sc['prompt_tokens']}"
        f" vs {sw['prompt_tokens']}")
    log(f"  TTFT ticks p50/p95: cold {sc['ttft_ticks_p50']}/"
        f"{sc['ttft_ticks_p95']}, cached {sw['ttft_ticks_p50']}/"
        f"{sw['ttft_ticks_p95']} (its hits {sw['ttft_cached_ticks_p50']}/"
        f"{sw['ttft_cached_ticks_p95']}); ms p50/p95: cold "
        f"{_pct(cold_ms, 0.5):.1f}/{_pct(cold_ms, 0.95):.1f}, cached "
        f"{_pct(warm_ms, 0.5):.1f}/{_pct(warm_ms, 0.95):.1f}  [{card}]")

    # Sampled: T = 0.8 with the embedding divided by 8 (as phase 12), the
    # first 8 requests, cached against cold; the draws must decide tokens
    # (held against the greedy streams of the first 2).
    soft = dict(params, embed=params["embed"] / 8)
    hot = reqs[:DUR_HOT]
    greedy, _, _, _ = _cont_run(cfg, soft, hot[:2])
    hot_cold, _, _, _ = _cont_run(cfg, soft, hot, temperature=0.8)
    hot_warm, sh, _, _ = _cont_run(cfg, soft, hot, temperature=0.8,
                                   prefix_cache_bytes=budget)
    _same_streams(hot_cold, hot_warm, "T = 0.8, cached vs cold")
    differ = [r for r in greedy if not np.array_equal(hot_warm[r],
                                                      greedy[r])]
    if not differ or sh["prefix_hits"] < len(hot) - 1:
        raise AssertionError(f"sampled: {len(differ)} streams off greedy, "
                             f"{sh['prefix_hits']} prefix hits")
    log(f"  sampled (T = 0.8, embedding / 8) rids 0-{len(hot) - 1}: cached "
        f"streams equal to cold ({sh['prefix_hits']} hits); {len(differ)} "
        f"of rids 0-{len(greedy) - 1} differ from greedy")
    _checkpoint_format(eng, card)
    del eng
    _dur_crash_restore(cfg, params, reqs, warm, card)
    del params
    torch.cuda.empty_cache()
    log(f"serve (prefix cache, crash-safe): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")


# -- the exact kinds (softmax, yat, yat_spherical) --------------------------

EXACT_FP32_PROMPT = 64         # the short prompt held against the CPU
EXACT_FP32_DECODE = 4          # decode steps after it, also held
# fp32 on both sides, the order of sums differs (cuBLAS against the CPU).
# With these random weights a softmax layer amplifies a rounding about
# threefold (the full-depth comparison is printed as a reading), so the
# check runs softmax at EXACT_FP32_LAYERS, where rounding moves the
# logits by about 1e-4 of their largest; 5e-4 of it is far below a fault.
EXACT_FP32_TOL = 5e-4
EXACT_FP32_LAYERS = 2
SPHERICAL_LAYERS = 4           # yat_spherical's lockstep phase: depth cut
EXACT_PAGE = 64                # page_size of the paged runs
EXACT_CKPT_EVERY = 128         # the durable phase's checkpoint cadence,
EXACT_CRASH = (140, 140)       # its crash: after the first checkpoint
EXACT_TRAIN_STEPS = 4


def _tree_mb(tree) -> float:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e6


def _no_slay_kernels(what: str) -> None:
    """An exact kind launches none of the SLAY kernels."""
    ran = {k: n for k, n in _build.LAUNCHES.items() if n}
    if ran:
        raise AssertionError(f"{what}: SLAY kernels ran on an exact kind: "
                             f"{ran}")


def _exact_fp32(cfg, check_layers: int) -> None:
    """One short prompt's last-token prefill logits, then the logits of a
    few decode steps on fixed tokens, on the card and on the CPU plain
    path, both in fp32: held to EXACT_FP32_TOL of the largest logit at
    ``check_layers`` (the config's first layers), printed as a reading at
    the config's depth."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    full = api.init_params(cfg32, SEED, device="cpu")
    for depth in sorted({check_layers, cfg.num_layers}):
        p = dict(full, layers=tree_map(lambda t: t[:depth], full["layers"]))
        _exact_fp32_at(dataclasses.replace(cfg32, num_layers=depth), p,
                       check=depth == check_layers)


def _exact_fp32_at(cfg32, params, check: bool) -> None:
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(0, cfg32.vocab_size, EXACT_FP32_PROMPT)
    feed = rng.integers(0, cfg32.vocab_size, EXACT_FP32_DECODE)
    rows, secs = {}, {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t, dev=dev: t.to(dev), params)
            t0 = time.perf_counter()
            lg, cache = api.prefill(
                p, cfg32, torch.from_numpy(prompt[None].astype(np.int32)),
                max_len=128)
            out = [lg[0, -1].float().cpu()]
            for tok in feed:
                lg, cache = api.decode_step(
                    p, cfg32, cache, torch.tensor([[int(tok)]],
                                                  dtype=torch.int32))
                out.append(lg[0, -1].float().cpu())
            rows[dev] = torch.stack(out)
            secs[dev] = time.perf_counter() - t0
            del p, cache
    scale = float(rows["cpu"].abs().max())
    what = (f"{cfg32.attn_kind} ({cfg32.num_layers}L) fp32 card vs CPU: "
            f"prefill "
            f"+ {EXACT_FP32_DECODE} decode logits ({EXACT_FP32_PROMPT}-token "
            f"prompt, CPU {secs['cpu']:.1f} s)")
    if check:
        close(rows["cuda"], rows["cpu"], EXACT_FP32_TOL * scale, 0.0, what)
        return
    err = float((rows["cuda"] - rows["cpu"]).abs().max())
    log(f"  {what}, a reading: max_abs_err={err:.3e} of a largest logit "
        f"{scale:.2f} ({err / scale:.2e})")


def _exact_lockstep(cfg, params, reqs, card: str, slay: dict,
                    k2: int = 0) -> dict:
    """``ServingEngine.generate`` of the serve phase's prompts (32 greedy
    tokens) graphed and eager: equal tokens, and no SLAY kernel but ``k2``
    unmasked decode launches (a linear baseline's B4a) in the graphed
    run; ms per decode step of each, in turns, beside SLAY's (``slay``)."""
    engs = {g: engine.ServingEngine(cfg, params, device="cuda", max_len=2048,
                                    _graphs=g) for g in (True, False)}
    engs[True].generate([engine.Request(reqs[0].prompt[:64],
                                        max_new_tokens=2)])      # warm
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engs[True].generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if k2:
        _only_k2(f"{cfg.attn_kind} lockstep generate",
                 {"slay_decode_step": k2})
    else:
        _no_slay_kernels(f"{cfg.attn_kind} lockstep generate")
    for o in outs:
        if len(o) != MAX_NEW or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output stream {o}")
    _same_outputs(outs, engs[False].generate(reqs),
                  f"{cfg.attn_kind} lockstep greedy, graphed vs eager")
    B = len(reqs)
    steps = {"graphed": engs[True]._lockstep(B, 0.0).step,
             "eager": engs[False]._lockstep(B, 0.0).step}
    ms: dict = {k: [] for k in steps}
    with torch.inference_mode():
        for name in ("graphed", "eager", "eager", "graphed"):
            ms[name].append(time_ms(steps[name], iters=MAX_NEW - 1,
                                    warmup=2))
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"  {cfg.attn_kind} ({cfg.num_layers}L) lockstep: generate {B} x "
        f"{MAX_NEW} tokens in {wall:.3f} s, streams graphed equal to eager, "
        f"{f'B4a {k2} launches' if k2 else 'no SLAY kernel'}; ms per decode "
        f"step graphed {med['graphed']:.3f}, "
        f"eager {med['eager']:.3f} (in turns); SLAY (12L) graphed "
        f"{slay['graphed']:.3f}, eager {slay['eager']:.3f}; graphs "
        f"{engs[True].graph_cache_entries()}  [{card}]")
    with torch.inference_mode():
        profile(f"{cfg.attn_kind} lockstep decode step, graphed",
                steps["graphed"], med["graphed"])
    return med


def phase_serve_exact(card: str, slay_step_ms: dict) -> None:
    """The exact kinds' lockstep serving at full width: softmax at 12
    layers and yat_spherical at SPHERICAL_LAYERS, each on the serve
    phase's 4 prompts graphed against eager, and its fp32 logits on the
    card against the CPU plain path. ``slay_step_ms``: the serve phase's
    ms per step, graphed and eager."""
    t_phase = time.perf_counter()
    for kind, over in (("softmax", {}),
                       ("yat_spherical", {"num_layers": SPHERICAL_LAYERS})):
        cfg = configs.get_config("slayformer-124m", attn_kind=kind, **over)
        log(f"serve (exact kind, lockstep) {cfg.name} attn_kind={kind}: "
            f"{cfg.num_layers}L x {cfg.d_model}d, {cfg.dtype}, KV rings of "
            f"2048 rows, random weights from seed {SEED}")
        params = api.init_params(cfg, SEED, device="cuda")
        if "slay" in params:
            raise AssertionError(f"{kind} drew SLAY projections")
        rng = np.random.default_rng(SEED)
        reqs = [engine.Request(rng.integers(0, cfg.vocab_size, n)
                               .astype(np.int32), max_new_tokens=MAX_NEW)
                for n in PROMPT_LENS]
        _exact_lockstep(cfg, params, reqs, card, slay_step_ms)
        del params
        torch.cuda.empty_cache()
        _exact_fp32(cfg, EXACT_FP32_LAYERS if kind == "softmax"
                    else cfg.num_layers)
    log(f"serve (exact kind, lockstep): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")


def _exact_regimes(S: int, L: int) -> dict:
    lp = L // EXACT_PAGE
    return {"unpaged": {},
            "paged": dict(page_size=EXACT_PAGE, num_pages=S * lp),
            "overcommitted": dict(page_size=EXACT_PAGE, num_pages=S * lp // 2)}


def phase_serve_exact_continuous(card: str, slay: dict) -> None:
    """Phase 12's trace and pool on softmax slayformer-124m, unpaged,
    paged (every slot's ring in pages) and overcommitted (half the
    pages), graphed, with ``debug_audit``: streams equal across the
    three, no page left allocated, no SLAY kernel; rids 0-7 eager against
    graphed (unpaged and paged); a full-pool dispatch graphed and eager
    with its idle share; ms per dispatch and pool MB beside SLAY's
    (``slay``: phase 12's ``dispatch_ms`` and ``pool_mb``)."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m", attn_kind="softmax")
    S, K, L = (CONT_SERVING[k] for k in ("num_slots", "macro_ticks",
                                          "max_len"))
    regimes = _exact_regimes(S, L)
    log(f"serve (exact kind, continuous) {cfg.name} attn_kind=softmax: "
        f"phase 12's ServingConfig and {CONT_REQUESTS} requests; unpaged, "
        f"paged (page_size {EXACT_PAGE}, {S * L // EXACT_PAGE} pages) and "
        f"overcommitted ({S * L // EXACT_PAGE // 2} pages)")
    params = api.init_params(cfg, SEED, device="cuda")
    reqs = _cont_requests(cfg)
    _cont_run(cfg, params, reqs[:2], max_len=1024)          # warm-up
    runs, mb = {}, {}
    for name, kw in regimes.items():
        timed: dict = {}
        _build.reset_launches()
        outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed,
                                       debug_audit=True, **kw)
        _no_slay_kernels(f"softmax continuous, {name}")
        if not (s["requests_completed"] == CONT_REQUESTS
                and s["final_occupancy"] == 0
                and s["final_pages_in_use"] == 0
                and s["pages_peak"] <= s["num_pages"]
                and (s["pages_peak"] > 0) == bool(kw)):
            raise AssertionError(f"softmax continuous, {name}: {s}")
        disp, pre = timed["_decode_macro"], timed["_prefill_tick"]
        mb[name] = _tree_mb(eng.pool)
        runs[name] = outs
        log(f"  {name}: {wall:.3f} s, {s['ticks']} ticks "
            f"({s['prefill_ticks']} prefill, {s['decode_dispatches']} "
            f"dispatches); ms per dispatch median "
            f"{statistics.median(disp) * 1e3:.2f}, prefill tick "
            f"{statistics.median(pre) * 1e3:.2f}; pool decode "
            f"{(s['tokens_generated'] - CONT_REQUESTS) / sum(disp):.1f} "
            f"tokens/s; pool {mb[name]:.1f} MB; pages {s['num_pages']}, peak "
            f"{s['pages_peak']}, left {s['final_pages_in_use']}; graphs "
            f"{eng.graph_cache_entries()}, captured in "
            f"{(eng._decode.capture_s or 0) * 1e3:.1f} (dispatch) and "
            f"{(eng._chunk.capture_s or 0) * 1e3:.1f} ms (chunk)  [{card}]")
        del eng
    for name in ("paged", "overcommitted"):
        _same_streams(runs["unpaged"], runs[name], f"softmax {name} vs "
                      f"unpaged")
    sub = reqs[:CONT_HOT_REQUESTS]
    for name in ("unpaged", "paged"):
        timed = {}
        o, s, _, wall = _cont_run(cfg, params, sub, timed=timed,
                                  graphs=False, **regimes[name])
        _same_streams(runs[name], o, f"softmax {name}, rids 0-{len(sub) - 1}"
                      f" eager vs graphed")
        log(f"  {name}, rids 0-{len(sub) - 1} eager: {wall:.3f} s, ms per "
            f"dispatch median "
            f"{statistics.median(timed['_decode_macro']) * 1e3:.2f}; streams "
            f"equal to the graphed run's  [{card}]")
    full = {name: _cont_profile(cfg, params, card, extra=regimes[name],
                                pieces=False, sampled=False)
            for name in ("unpaged", "paged")}
    sd = slay["dispatch_ms"]
    log(f"  a full-pool dispatch (K = {K}), graphed/eager ms: softmax "
        f"unpaged {full['unpaged']['graphed']:.2f}/"
        f"{full['unpaged']['eager']:.2f}, paged {full['paged']['graphed']:.2f}"
        f"/{full['paged']['eager']:.2f}, SLAY {sd['graphed']:.2f}/"
        f"{sd['eager']:.2f}; pool MB softmax {mb['unpaged']:.1f} (paged "
        f"{mb['paged']:.1f}, overcommitted {mb['overcommitted']:.1f}), SLAY "
        f"{slay['pool_mb']:.1f}; streams equal across the three "
        f"regimes  [{card}]")
    del params
    torch.cuda.empty_cache()
    log(f"serve (exact kind, continuous): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")


def phase_serve_exact_durable(card: str) -> None:
    """Phase 13's shared-prompt trace on the paged softmax pool: a prefix
    cache of as many ring snapshots as phase 13's holds (S, z) ones, cold
    against cached (streams equal), then a journaled run crashed after
    its first checkpoint and restored (streams equal to the uncrashed
    cached run's); MB and ms per checkpoint."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m", attn_kind="softmax")
    S, L = CONT_SERVING["num_slots"], CONT_SERVING["max_len"]
    paging = _exact_regimes(S, L)["paged"]
    ring = _tree_mb(api.init_cache(cfg, 1, L, device="cuda"))
    state = _tree_mb(api.init_cache(configs.get_config("slayformer-124m"), 1,
                                    L, device="cuda"))
    budget = int(DUR_SERVING["prefix_cache_bytes"] * ring / state)
    serving = dict(DUR_SERVING, prefix_cache_bytes=budget,
                   checkpoint_every_ticks=EXACT_CKPT_EVERY, **paging)
    log(f"serve (exact kind, prefix cache, crash-safe) {cfg.name} "
        f"attn_kind=softmax: phase 13's trace, paged ({paging}), a prefix "
        f"cache of {budget / 2 ** 20:.0f} MiB ({ring:.1f} MB a snapshot, "
        f"SLAY's {state:.1f}), checkpoints every {EXACT_CKPT_EVERY} ticks")
    params = api.init_params(cfg, SEED, device="cuda")
    reqs = _dur_requests(cfg)
    runs = {}
    for name, nbytes in (("cold", 0), ("cached", budget)):
        _build.reset_launches()
        outs, s, eng, wall = _cont_run(cfg, params, reqs, debug_audit=True,
                                       prefix_cache_bytes=nbytes, **paging)
        _no_slay_kernels(f"softmax durable, {name}")
        runs[name] = (outs, s, eng)
        log(f"  {name} run: {wall:.3f} s, {s['ticks']} ticks "
            f"({s['prefill_ticks']} prefill, {s['decode_dispatches']} "
            f"dispatches), {s['prompt_tokens']} prompt tokens absorbed, "
            f"pages peak {s['pages_peak']}  [{card}]")
    (cold, sc, _), (warm, sw, eng) = runs["cold"], runs["cached"]
    _same_streams(cold, warm, "softmax paged, cached vs cold")
    st = eng.prefix_cache.stats()
    if not (set(warm) == set(cold) and st["hits"] >= 15
            and sw["final_pages_in_use"] == 0
            and eng.prefix_cache.live_refs() == 0
            and sw["prefill_ticks"] < sc["prefill_ticks"]):
        raise AssertionError(f"softmax prefix cache: {st}, {sw}")
    log(f"  prefix cache: {st['hits']} hits, {st['evictions']} evictions, "
        f"{st['entries']} entries, {st['bytes'] / 2 ** 20:.1f} MiB; prefill "
        f"ticks cold {sc['prefill_ticks']}, cached {sw['prefill_ticks']}; "
        f"streams equal to the cold run's")
    del eng, runs
    _dur_crash_restore(cfg, params, reqs, warm, card,
                       serving=ServingConfig(**serving),
                       crash_window=EXACT_CRASH, launches=_no_slay_launches)
    del params
    torch.cuda.empty_cache()
    log(f"serve (exact kind, prefix cache, crash-safe): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")


def _no_slay_launches(what: str, dispatches: int, nl: int, K: int) -> int:
    """:func:`_b4b_launches`' counterpart for an exact kind: no kernel."""
    _no_slay_kernels(what)
    if not dispatches:
        raise AssertionError(f"{what}: no decode dispatch")
    return 0


def phase_train_exact(card: str, fused_step_s: float) -> None:
    """Softmax slayformer-124m: EXACT_TRAIN_STEPS AdamW steps (the
    quadratic against the linear kind at L = 1024)."""
    cfg = configs.get_config("slayformer-124m", attn_kind="softmax")
    log(f"train (exact kind) {cfg.name} attn_kind=softmax: "
        f"{EXACT_TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} x {TRAIN_LEN} "
        f"tokens, as the train phase (lr {TRAIN_LR}, no remat)")
    _train_plain(cfg, EXACT_TRAIN_STEPS, card, fused_step_s)


def _train_plain(cfg, n_steps: int, card: str, fused_step_s: float) -> float:
    """``n_steps`` AdamW steps of the train phase's batches through
    ``Trainer.run`` of a kind without a training kernel: plain autograd,
    no kernel launch; a finite, falling loss; ms per step beside the
    fused SLAY step's. Returns the median ms of steps 2 on."""
    kind = cfg.attn_kind
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                               global_batch=TRAIN_BATCH, seed=SEED)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=n_steps)
    d = tempfile.mkdtemp(prefix="chip_smoke_plain_train_")
    try:
        tr = loop.Trainer(cfg, ocfg, loop.TrainConfig(
            remat=False, ckpt_dir=d, ckpt_every=1000), seed=SEED,
            device="cuda")
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        hist = tr.run(pipeline.batch_iterator(dcfg), n_steps,
                      log_every=1000)
        _no_slay_kernels(f"{kind} training")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del tr
    finally:
        shutil.rmtree(d, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    if not (len(hist) == n_steps and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"{kind} training: loss {losses}")
    times = [h["step_time_s"] for h in hist]
    step_s = statistics.median(times[1:])
    log(f"  loss per step: {', '.join(f'{x:.4f}' for x in losses)} (finite, "
        f"falling); step time first {times[0] * 1e3:.1f} ms, median of "
        f"steps 2-{n_steps} {step_s * 1e3:.2f} ms = "
        f"{TRAIN_BATCH * TRAIN_LEN / step_s:.1f} tokens/s; fused SLAY "
        f"{fused_step_s * 1e3:.2f} ms ({kind} / SLAY "
        f"{step_s / fused_step_s:.3f}); peak memory {peak:.1f} GB  [{card}]")
    torch.cuda.empty_cache()
    return step_s * 1e3


SPEC_KW = dict(speculative=True, spec_gamma=2)
SPEC_REQUESTS = 8              # the first 8 requests of phase 12's trace
SPEC_HOT = 4                   # the sampled K-invariance runs take 4
SPEC_EAGER_TICKS = 28          # the eager run: its first dispatches
# A near-tie of the bf16 verifier: a top-2 gap under this share of the
# largest logit. Decode steps and verify chunks are different programs,
# each rounding to bf16 (2**-8 relative) through 12 layers, so their
# argmax may differ only where the top two logits are that close; a
# divergence above it is a fault.
SPEC_TIE_FRAC = 2e-2


def _spec_ties(cfg, params, reqs, want, got, what: str) -> int:
    """Every stream of ``got`` equals ``want``'s, or first diverges where
    the verifier's top-2 gap (fp32 of the bf16 logits, teacher-forced
    along ``want`` by decode steps) is under SPEC_TIE_FRAC of its largest
    logit: a near tie (ROADMAP C-2), printed as such. The number of
    ties."""
    ties = 0
    for rid, w in want.items():
        g = got[rid]
        if np.array_equal(w, g):
            continue
        n = min(len(w), len(g))
        diff = np.flatnonzero(w[:n] != g[:n])
        if len(w) != len(g) or not len(diff):
            raise AssertionError(f"{what}: rid {rid} streams of lengths "
                                 f"{len(w)} and {len(g)}")
        i = int(diff[0])
        gap, scale = _greedy_gaps(params, cfg, reqs[rid].prompt,
                                  w[:i + 1])[i]
        if gap >= SPEC_TIE_FRAC * scale:
            raise AssertionError(
                f"{what}: rid {rid} diverges at token {i} ({w[i:i + 4]} vs "
                f"{g[i:i + 4]}) where the verifier's top-2 gap is {gap:.4g} "
                f"of a largest logit {scale:.4g}: not a near tie")
        log(f"  {what}: rid {rid} diverges at token {i}, a near tie of the "
            f"verifier (top-2 gap {gap:.3e} of a largest logit {scale:.2f},"
            f" under {SPEC_TIE_FRAC}); printed as a tie")
        ties += 1
    return ties


def _spec_launches(what: str, s: dict, nl: int, K: int, G: int) -> int:
    """B4b's launches since the last reset: nl x K x (2 gamma + 1) per
    speculative dispatch (gamma draft steps and gamma + 1 resync steps a
    round), and no fused-forward or unmasked decode launch."""
    got = _build.LAUNCHES["slay_decode_step_masked"]
    want = nl * K * (2 * G + 1) * s["decode_dispatches"]
    if got != want or not want:
        raise AssertionError(f"{what}: B4b launched {got} times, want {nl} x "
                             f"{K} x {2 * G + 1} x {s['decode_dispatches']} "
                             f"dispatches = {want}")
    if _build.LAUNCHES["slay_fused_fwd"] or _build.LAUNCHES[
            "slay_decode_step"]:
        raise AssertionError(f"{what}: K1 or the unmasked K2 ran: "
                             f"{_build.LAUNCHES}")
    return got


def phase_serve_spec(card: str) -> int:
    """Draft-verify speculative decoding at full width: the yat_spherical
    verifier (12 layers, KV rings of 2048 rows) and its SLAY twin as the
    draft on phase 12's pool, gamma = 2, the first 8 requests of its
    trace, greedy. Checks the streams against plain exact decoding (up to
    near ties of the verifier), graphed against eager over the first
    dispatches, paged (64-row pages) against unpaged with no page left,
    the acceptance accounting against the rounds counted in the dispatch
    buffers, B4b's launches (nl x K x (2 gamma + 1) a dispatch), and K
    invariance at T = 0.8 (4 requests, embedding / 8); prints ms and
    tokens per dispatch, the acceptance rate, tokens/s beside the plain
    run's, capture ms, the pools' MB and a full-pool dispatch's device
    time and idle share. Returns B4b's launches in the greedy run."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m", attn_kind="yat_spherical")
    nl, K, G = cfg.num_layers, CONT_SERVING["macro_ticks"], SPEC_KW[
        "spec_gamma"]
    log(f"serve (speculative) {cfg.name}: verifier attn_kind=yat_spherical "
        f"({nl}L x {cfg.d_model}d, {cfg.dtype}, KV rings of "
        f"{CONT_SERVING['max_len']} rows), draft its SLAY twin (m = "
        f"{cfg.slay_config().feature_dim}), gamma {G}; phase 12's "
        f"ServingConfig, its first {SPEC_REQUESTS} requests, greedy")
    params = api.init_params(cfg, SEED, device="cuda")
    reqs = _cont_requests(cfg)[:SPEC_REQUESTS]
    timed_p: dict = {}
    plain, sp, _, wall_p = _cont_run(cfg, params, reqs, timed=timed_p)
    eng = engine.ContinuousServingEngine(
        cfg, params, serving=ServingConfig(**CONT_SERVING, **SPEC_KW),
        device="cuda")
    prog, first_rows = eng._spec_decode, []

    def recorded():
        buf = prog()
        first_rows.append(buf[:, G + 1].clone())   # emitted j = 0: a round
        return buf

    eng._spec_decode = recorded
    timed: dict = {}
    _build.reset_launches()
    outs, s, _, wall = _timed_run(eng, reqs, timed)
    launches = _spec_launches("speculative, greedy", s, nl, K, G)
    eng._spec_decode = prog
    rounds = sum(int(r.sum()) for r in first_rows)
    if not (s["draft_tokens_proposed"] == G * rounds > 0
            and 0 <= s["draft_tokens_accepted"] <= s["draft_tokens_proposed"]
            and s["requests_completed"] == len(reqs)
            and s["final_occupancy"] == 0
            and s["host_syncs"] == s["decode_dispatches"]):
        raise AssertionError(f"speculative accounting: {rounds} rounds "
                             f"counted in the buffers, summary {s}")
    graphs = eng.graph_cache_entries()
    if graphs != {"macro_decode": 0, "chunk": 1, "spec_macro": 1}:
        raise AssertionError(f"graphs after the speculative run: {graphs}")
    ties = _spec_ties(cfg, params, reqs, plain, outs,
                      "greedy speculative vs plain exact")
    disp, pdisp = timed["_decode_spec"], timed_p["_decode_macro"]
    dec, pdec = (x["tokens_generated"] - len(reqs) for x in (s, sp))
    log(f"  speculative run: {wall:.3f} s, {s['ticks']} ticks "
        f"({s['prefill_ticks']} prefill, {s['decode_dispatches']} "
        f"dispatches of {K} rounds); tokens per dispatch "
        f"{s['tokens_per_dispatch']:.3f} (plain "
        f"{sp['tokens_per_dispatch']:.3f}); draft acceptance "
        f"{s['draft_acceptance_rate']:.4f} ({s['draft_tokens_accepted']} of "
        f"{s['draft_tokens_proposed']} proposed in {rounds} rounds); B4b "
        f"{launches} launches  [{card}]")
    log(f"  ms per dispatch (CUDA events), median: speculative "
        f"{statistics.median(disp) * 1e3:.2f} (min {min(disp) * 1e3:.2f}), "
        f"plain exact {statistics.median(pdisp) * 1e3:.2f}; pool decode "
        f"{dec / sum(disp):.1f} tokens/s speculative, "
        f"{pdec / sum(pdisp):.1f} plain; run {wall:.3f} s against "
        f"{wall_p:.3f} s ({sp['ticks']} ticks, {sp['decode_dispatches']} "
        f"dispatches); streams equal but for {ties} near ties  [{card}]")
    log(f"  capture: spec dispatch {prog.capture_s * 1e3:.1f} ms ("
        f"{prog.launches} per replay), chunk (verifier and draft) "
        f"{eng._chunk.capture_s * 1e3:.1f} ms; pools: verifier "
        f"{_tree_mb(eng.pool):.1f} MB, draft {_tree_mb(eng.draft_pool):.1f} "
        f"MB and its scratch twin {_tree_mb(eng._draft_scratch):.1f} MB  "
        f"[{card}]")
    del eng

    timed_e: dict = {}
    eager = engine.ContinuousServingEngine(
        cfg, params, serving=ServingConfig(**CONT_SERVING, **SPEC_KW),
        device="cuda", _graphs=False)
    e_outs, se, _, _ = _timed_run(eager, reqs, timed_e,
                                  max_ticks=SPEC_EAGER_TICKS)
    edisp = timed_e["_decode_spec"]
    bad = [r for r, o in e_outs.items() if len(o) and not np.array_equal(
        o, outs[r][:len(o)])]
    if bad or se["decode_dispatches"] < 2:
        raise AssertionError(f"eager speculative run: rids {bad} differ "
                             f"from the graphed run; {se}")
    log(f"  eager, its first {se['ticks']} ticks ({se['decode_dispatches']} "
        f"dispatches, {sum(len(o) for o in e_outs.values())} tokens): "
        f"every stream a prefix of the graphed run's; ms per dispatch eager "
        f"median {statistics.median(edisp) * 1e3:.2f} against graphed "
        f"{statistics.median(disp) * 1e3:.2f}  [{card}]")
    del eager

    _build.reset_launches()
    paged, spg, peng, wall_pg = _cont_run(
        cfg, params, reqs, debug_audit=True, page_size=EXACT_PAGE, **SPEC_KW)
    _spec_launches("speculative, paged", spg, nl, K, G)
    _same_streams(outs, paged, "speculative, paged vs unpaged")
    if spg["final_pages_in_use"] or not spg["pages_peak"]:
        raise AssertionError(f"speculative, paged: {spg}")
    log(f"  paged ({EXACT_PAGE}-row pages, {spg['num_pages']}): streams "
        f"equal, pages peak {spg['pages_peak']}, left "
        f"{spg['final_pages_in_use']}, {wall_pg:.3f} s  [{card}]")
    del peng

    soft = dict(params, embed=params["embed"] / 8)
    hot = reqs[:SPEC_HOT]
    hot8, sh8, _, w8 = _cont_run(cfg, soft, hot, temperature=0.8, **SPEC_KW)
    hot1, _, _, w1 = _cont_run(cfg, soft, hot, temperature=0.8,
                               macro_ticks=1, **SPEC_KW)
    _same_streams(hot8, hot1, "speculative T = 0.8, macro_ticks 8 vs 1")
    log(f"  T = 0.8 (embedding / 8), rids 0-{len(hot) - 1}: streams equal "
        f"for K = 8 and K = 1 (runs {w8:.3f} and {w1:.3f} s); acceptance "
        f"{sh8['draft_acceptance_rate']:.4f}, tokens per dispatch "
        f"{sh8['tokens_per_dispatch']:.3f}")
    del soft
    log(f"  a full-pool speculative dispatch, graphed (the eager one's ms "
        f"above), at {time.perf_counter() - t_phase:.1f} s into the phase:")
    _cont_profile(cfg, params, card, extra=SPEC_KW, pieces=False,
                  sampled=False, eager=False)
    del params
    torch.cuda.empty_cache()
    log(f"serve (speculative): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


BASELINE_KINDS = ("favor", "cosformer", "elu1")
BASELINE_TRAIN_STEPS = 2


def _only_k2(what: str, want: dict) -> None:
    """The launches since the last reset are exactly ``want`` (K2's
    unmasked and masked counts): a linear baseline runs no other kernel."""
    got = {k: n for k, n in _build.LAUNCHES.items() if n}
    need = {k: n for k, n in want.items() if n}
    if got != need or not need:
        raise AssertionError(f"{what}: launches {got}, want {need} and no "
                             f"other kernel")


def _baseline_continuous(cfg, params, card: str) -> tuple:
    """Phase 12's 16-request trace on its pool, graphed and greedy: B4b nl
    x K a dispatch and no other kernel, every request complete, one graph
    of the dispatch and one of a chunk; ms per dispatch, pool tokens/s;
    the pool's and a prefix snapshot's MB; a full-pool dispatch under the
    profiler. Returns (readings, B4b launches)."""
    nl, K = cfg.num_layers, CONT_SERVING["macro_ticks"]
    reqs = _cont_requests(cfg)
    _cont_run(cfg, params, reqs[:2])                         # warm-up
    timed: dict = {}
    _build.reset_launches()
    outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed,
                                   page_size=64)
    want = nl * K * s["decode_dispatches"]
    _only_k2(f"{cfg.attn_kind} continuous", {"slay_decode_step_masked": want})
    if not (s["requests_completed"] == CONT_REQUESTS
            and s["final_occupancy"] == 0 and s["num_pages"] == 0
            and eng.page_pool is None):
        raise AssertionError(f"{cfg.attn_kind} continuous: {s}")
    for rid, r in enumerate(reqs):
        o = outs[rid]
        if (len(o) != r.max_new_tokens or o.min() < 0
                or o.max() >= cfg.vocab_size):
            raise AssertionError(f"bad stream rid {rid}: {o}")
    graphs = eng.graph_cache_entries()
    if graphs != {"macro_decode": 1, "chunk": 1}:
        raise AssertionError(f"graphs after the run: {graphs}")
    disp, pre = timed["_decode_macro"], timed["_prefill_tick"]
    dec_tokens = s["tokens_generated"] - CONT_REQUESTS
    pool_mb = _tree_mb(eng.pool)
    snap_mb = _tree_mb(api.init_cache(cfg, 1, device="cuda"))
    out = dict(dispatch_ms=statistics.median(disp) * 1e3,
               tokens_s=dec_tokens / sum(disp), pool_mb=pool_mb,
               snapshot_mb=snap_mb)
    log(f"  continuous (page_size 64 given, ignored): {wall:.3f} s, "
        f"{s['ticks']} ticks ({s['prefill_ticks']} prefill, "
        f"{s['decode_dispatches']} dispatches); B4b {want} launches ({nl} x "
        f"{K} x {s['decode_dispatches']}) and no other kernel; ms per "
        f"dispatch median {out['dispatch_ms']:.2f} (min "
        f"{min(disp) * 1e3:.2f}, max {max(disp) * 1e3:.2f}), prefill tick "
        f"{statistics.median(pre) * 1e3:.2f}; pool decode "
        f"{out['tokens_s']:.1f} tokens/s; pool {pool_mb:.1f} MB, a prefix "
        f"snapshot {snap_mb:.2f} MB; graphs {graphs}, captured in "
        f"{(eng._decode.capture_s or 0) * 1e3:.1f} (dispatch) and "
        f"{(eng._chunk.capture_s or 0) * 1e3:.1f} ms (chunk)  [{card}]")
    del eng
    full = _cont_profile(cfg, params, card, pieces=False, sampled=False,
                         eager=False)
    out["full_dispatch_ms"] = full["graphed"]
    return out, want


def phase_serve_baselines(card: str, slay: dict, fused_step_s: float) -> dict:
    """The linear baselines favor, cosformer and elu1 at full width and
    depth (12 x 768, bf16, random weights from seed 0): lockstep graphed
    against eager, the continuous engine on phase 12's trace, a full-pool
    dispatch under the profiler, fp32 logits on the card against the CPU
    plain path, and BASELINE_TRAIN_STEPS train steps; every decode step
    one K2 launch a layer and no other kernel. ``slay``: SLAY's readings
    beside them. Returns the B4a and B4b launches of the lockstep and
    continuous runs."""
    t_phase = time.perf_counter()
    launches = {"slay_decode_step": 0, "slay_decode_step_masked": 0}
    rows = {}
    for kind in BASELINE_KINDS:
        cfg = configs.get_config("slayformer-124m", attn_kind=kind)
        m = feature_dim(cfg.attention_spec(), cfg.resolved_head_dim)
        log(f"serve and train (linear baseline) {cfg.name} attn_kind={kind}: "
            f"{cfg.num_layers}L x {cfg.d_model}d, {cfg.dtype}, (S, z) at m = "
            f"{m}, random weights from seed {SEED}")
        params = api.init_params(cfg, SEED, device="cuda")
        if ("slay" in params) != (kind == "favor"):
            raise AssertionError(f"{kind}: projections {list(params)}")
        rng = np.random.default_rng(SEED)
        reqs = [engine.Request(rng.integers(0, cfg.vocab_size, n)
                               .astype(np.int32), max_new_tokens=MAX_NEW)
                for n in PROMPT_LENS]
        n_a = cfg.num_layers * (MAX_NEW - 1)
        med = _exact_lockstep(cfg, params, reqs, card, slay["step_ms"],
                              k2=n_a)
        cont, n_b = _baseline_continuous(cfg, params, card)
        launches["slay_decode_step"] += n_a
        launches["slay_decode_step_masked"] += n_b
        del params
        torch.cuda.empty_cache()
        _exact_fp32(cfg, cfg.num_layers)
        log(f"  train: {BASELINE_TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} "
            f"x {TRAIN_LEN} tokens, plain autograd")
        train_ms = _train_plain(cfg, BASELINE_TRAIN_STEPS, card,
                                fused_step_s)
        rows[kind] = dict(step_ms=med["graphed"], train_ms=train_ms, **cont)
    sd = slay["dispatch_ms"]
    log("  beside SLAY (12L, m = 384): "
        + "; ".join(f"{k} step {r['step_ms']:.3f} ms, dispatch "
                    f"{r['dispatch_ms']:.2f} ms, full pool "
                    f"{r['full_dispatch_ms']:.2f} ms, {r['tokens_s']:.1f} "
                    f"tokens/s, pool {r['pool_mb']:.1f} MB, train "
                    f"{r['train_ms']:.2f} ms" for k, r in rows.items())
        + f"; SLAY step {slay['step_ms']['graphed']:.3f} ms, full pool "
        f"{sd['graphed']:.2f} ms, pool {slay['pool_mb']:.1f} MB  [{card}]")
    log(f"serve and train (linear baselines): the phase took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


def phase_drivers(card: str) -> dict:
    """The port's command-line drivers in-process on the card: training
    (``--preset paper --attn-kind favor --steps 4``, a fresh checkpoint
    directory, removed after) and continuous serving of the full-width
    cosformer model; every kernel launch a K2 one. Returns their K2
    launches."""
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_driver_ckpt_")
    try:
        _build.reset_launches()
        hist = train_slayformer.main(["--preset", "paper", "--attn-kind",
                                      "favor", "--steps", "4", "--ckpt-dir",
                                      d])
        ran = {k: n for k, n in _build.LAUNCHES.items() if n}
        losses = [h["loss"] for h in hist]
        if ran or len(losses) != 4 or not all(np.isfinite(losses)):
            raise AssertionError(f"train driver: losses {losses}, launches "
                                 f"{ran}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _build.reset_launches()
    outs = serve.main(["--attn-kind", "cosformer", "--no-smoke"])
    n_b = _build.LAUNCHES["slay_decode_step_masked"]
    _only_k2("serve driver", {"slay_decode_step_masked": n_b})
    if len(outs) != 4 or any(len(o) != 24 for o in outs):
        raise AssertionError(f"serve driver: streams {outs}")
    log(f"drivers: train_slayformer --preset paper --attn-kind favor --steps "
        f"4 (losses {', '.join(f'{x:.4f}' for x in losses)}, no kernel); "
        f"serve --attn-kind cosformer --no-smoke (4 streams of 24, B4b {n_b}"
        f" launches); {time.perf_counter() - t_phase:.1f} s  [{card}]")
    torch.cuda.empty_cache()
    return {"slay_decode_step_masked": n_b}


# -- the dense decoders: phi4-mini-3.8b, granite-20b, qwen3-32b -----------

DENSE_ARCHS = ("phi4-mini-3.8b", "granite-20b", "qwen3-32b")
# phi4-mini served at 8 of its 32 layers (reduced, to keep the script
# within its time with phases 23 and 24 beside it); granite and qwen3 at
# 4.
DENSE_SERVE_LAYERS = {"phi4-mini-3.8b": 8}
DENSE_LAYERS = 4               # granite's and qwen3's depth; every training's
DENSE_TRAIN_STEPS = 4
# AdamWConfig's default rate (paper App. H). Phase 9's 3e-4 overshoots at
# these widths: qwen3-32b's loss (untied 151936-row unembedding) rose over
# 4 steps at 3e-4 and fell at 1e-4 on an H100, its fp32 gradients equal to
# the CPU's.
DENSE_LR = 1e-4
DENSE_FP32_LAYERS = 2          # the card-vs-CPU logits: the first 2 layers
DENSE_FP32_PROMPT = 128
DENSE_SUB = 4                  # requests run again graphed and eager
# K2's groups at head dim 128: the dense configs' (phi4-mini 3, qwen3 8,
# granite 48), phase 23's (gemma2 2, phi3.5-moe 4, grok-1 6) and 1 and 64
# beside them.
K2_DENSE_G = (1, 2, 3, 4, 6, 8, 48, 64)


def _dense_kernel_cases(feat, a, w, name, G, dims, gen) -> dict:
    """K1 at a config's lockstep prefill shape (4 prompts padded to 512)
    and K3/K4 at its training shape (8 x 1024), bf16, d = dv = 128,
    against their plain versions (K3/K4 also summed over the group, as
    autograd returns them), timed beside their bounds, with residency
    lines. Returns each kernel's row."""
    d = dv = feat.head_dim
    H, Hkv = dims
    rows = {}
    P, D, R = feat.num_anchors, feat.num_prf, feat.num_quad_nodes
    bh, bk, L = len(PROMPT_LENS) * H, len(PROMPT_LENS) * Hkv, max(PROMPT_LENS)
    log(f"K1 {name}: BH={bh} BK={bk} (G={G}) L={L} d=dv={d} bf16")
    q, k, v = _k1_inputs(gen, bh, bk, L, d, dv, torch.bfloat16)
    y, den = slay_fused.fused_causal_attention(q, k, v, a, w, feat)
    yp, denp = slay_fused.fused_causal_attention_plain(q, k, v, a, w, feat)
    torch.cuda.synchronize()
    err = close(y, yp, *K1_TOL[torch.bfloat16], "y")
    close(den, denp, 0.0, DEN_RTOL, "den")
    shape = (bh, bk, L, d, dv, P, D, R, 2)
    row = _kernel_row(
        "slay_fused_fwd",
        time_ms(lambda: slay_fused.fused_causal_attention(q, k, v, a, w, feat),
                iters=10),
        time_ms(lambda: slay_fused.fused_causal_attention_plain(
            q, k, v, a, w, feat), iters=5, warmup=1),
        k1_tc_bound(*shape), err, "SLAY attention",
        "with the state products on 3xTF32 tensor cores")
    rows["slay_fused_fwd"] = dict(row, G=G, bound_fp32_ms=k1_bound(*shape)[0],
                                  shape=f"BH={bh} BK={bk} L={L} d=dv={d} bf16")
    log_residency("slay_fused_fwd", "slay_fused", "fused_fwd_kernel",
                  slay_fused.fwd_residency(bh, d, dv, feat, torch.bfloat16),
                  dv, f"{name}, bf16, BH={bh}, d=dv={d}")
    del q, k, v, y, den, yp, denp

    bh, bk, L = TRAIN_BATCH * H, TRAIN_BATCH * Hkv, TRAIN_LEN
    log(f"K3/K4 {name}: BH={bh} BK={bk} (G={G}) L={L} d=dv={d} bf16")
    q, k, v = _k1_inputs(gen, bh, bk, L, d, dv, torch.bfloat16)
    dy = torch.randn(bh, L, dv, generator=gen, device="cuda").bfloat16()
    y, den = slay_fused.fused_causal_attention(q, k, v, a, w, feat)
    args = (q, k, v, a, w, y, den, dy, feat)
    e3 = _check_grads(slay_fused.launch_bwd_q(*args),
                      slay_fused.fused_bwd_q_plain(*args), K3_OUT,
                      torch.bfloat16, "K3 vs plain")
    e4 = _check_grads(slay_fused.launch_bwd_kv(*args),
                      slay_fused.fused_bwd_kv_plain(*args), K4_OUT,
                      torch.bfloat16, "K4 vs plain")
    _check_grads(slay_fused.fused_causal_attention_bwd(*args),
                 slay_fused.fused_causal_attention_bwd_plain(*args), ALL_OUT,
                 torch.bfloat16, f"summed over the group of {G} vs plain")
    torch.cuda.synchronize()
    shape = (bh, bk, L, d, dv, P, D, R, 2)
    bounds, fp32 = bwd_tc_bounds(*shape), bwd_bounds(*shape)
    for kname, kern, plain, err, kv, entry in (
            ("slay_fused_bwd_q", slay_fused.launch_bwd_q,
             slay_fused.fused_bwd_q_plain, e3, False, "fused_bwd_q_kernel"),
            ("slay_fused_bwd_kv", slay_fused.launch_bwd_kv,
             slay_fused.fused_bwd_kv_plain, e4, True, "fused_bwd_kv_kernel")):
        row = _kernel_row(kname, time_ms(lambda: kern(*args), iters=5),
                          time_ms(lambda: plain(*args), iters=3, warmup=0),
                          bounds[kname], err, "this scan",
                          "with the state products on 3xTF32 tensor cores")
        rows[kname] = dict(row, G=G, bound_fp32_ms=fp32[kname][0],
                           shape=f"BH={bh} BK={bk} L={L} d=dv={d} bf16")
        log_residency(kname, "slay_fused_bwd", entry,
                      slay_fused.bwd_residency(kv, bh, d, dv, feat,
                                               torch.bfloat16),
                      dv, f"{name}, bf16, BH={bh}, d=dv={d}")
    del q, k, v, dy, y, den, args
    torch.cuda.empty_cache()
    return rows


def _dense_k2(gen, timed: set, dv: int = 128, groups=K2_DENSE_G,
              kv_rows=None) -> dict:
    """K2 at head dim ``dv`` (128 by default; m = 384, qf fp32 and v bf16
    as the models' decode gives them) for every group of ``groups``,
    masked and not, against its plain version: y, S' and z' in place,
    drained rows bit-identical with y = 0. The lockstep shape has 4
    prompts' kv rows (32 at G <= 8, 4 at G >= 48), the pool's 8 slots'
    (64 or 8), every third masked row drained. The groups in ``timed``
    (the configs') are timed beside their bounds, with residency lines.
    ``kv_rows`` (lockstep, pool) sets the rows instead. Returns {(G,
    masked): row} of the timed cases."""
    m = 384
    rows = {}
    for G in sorted(set(groups) | timed):
        for masked in (False, True):
            bk = (4 if G >= 48 else 32) * (2 if masked else 1)
            if kv_rows:
                bk = kv_rows[masked]
            bh = bk * G
            what = (f"G={G} BK={bk} BH={bh} d=dv={dv} m={m} qf fp32 v bf16"
                    f"{' masked' if masked else ''}")
            log(f"K2 {what}")
            qf, kf, v, s, z = _k2_inputs(gen, bh, bk, m, dv, torch.float32,
                                         torch.bfloat16)
            active = ((torch.arange(bk, device="cuda") % 3 != 1)
                      .to(torch.int32) if masked else None)
            s0, z0 = s.clone(), z.clone()
            sp_, zp_ = s.clone(), z.clone()
            yp, _, _ = decode_step.decode_linear_attention_plain(
                qf, kf, v, sp_, zp_, active)
            y, s2, z2 = decode_step.decode_linear_attention(qf, kf, v, s, z,
                                                           active)
            torch.cuda.synchronize()
            if s2 is not s or z2 is not z:
                raise AssertionError("decode state not updated in place")
            err = close(y, yp, *K2_YTOL[torch.bfloat16], "y")
            close(s, sp_, 1e-5, 1e-6, "s' (in place)")
            close(z, zp_, 1e-5, 1e-6, "z' (in place)")
            if masked:
                off = active == 0
                if not (torch.equal(s[off], s0[off])
                        and torch.equal(z[off], z0[off])):
                    raise AssertionError("drained rows' state changed")
                if not bool((y.reshape(bk, G, dv)[off] == 0).all()):
                    raise AssertionError("drained rows' y is not zero")
                log(f"  drained rows: {int(off.sum())} of {bk} "
                    f"bit-identical, y=0")
            if G in timed:
                s.copy_(s0)
                z.copy_(z0)
                rows[(G, masked)] = _k2_timed(what, qf, kf, v, s, z, active,
                                              err)
                if not masked:
                    log_residency("slay_decode_step", "decode_step",
                                  "decode_step_kernel",
                                  decode_step.residency(bk, G, m, dv,
                                                        torch.float32,
                                                        torch.bfloat16),
                                  dv, what,
                                  inst=f"If13__nv_bfloat16Li{dv}E",
                                  unit="feature rows")
    return rows


def phase_dense_kernels() -> dict:
    """K1, K2, K3 and K4 at head dim 128 and the dense decoders' groups,
    K2 also at phase 23's (gemma2 2, phi3.5-moe 4, grok-1 6), and all
    four at hymba-1.5b's head dim 64 and G = 5 (phase 21). Returns
    {kernel: {config: row}}."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out: dict = collections.defaultdict(dict)
    for name in DENSE_ARCHS + (HYBRID,):
        cfg = configs.get_config(name)
        feat = cfg.slay_config()
        sp = init_feature_params(feat, torch.Generator().manual_seed(SEED),
                                 device="cuda")
        G = cfg.num_heads // cfg.num_kv_heads
        rows = _dense_kernel_cases(feat, sp["anchors"], sp["omegas"], name, G,
                                   (cfg.num_heads, cfg.num_kv_heads), gen)
        for kname, row in rows.items():
            out[kname][name] = row
    groups = {name: configs.get_config(name).num_heads
              // configs.get_config(name).num_kv_heads
              for name in DENSE_ARCHS + MIXED_ARCHS}
    k2 = _dense_k2(gen, set(groups.values()))
    for name, G in groups.items():
        out["slay_decode_step"][name] = dict(k2[(G, False)], G=G)
        out["slay_decode_step_masked"][name] = dict(k2[(G, True)], G=G)
    hy = configs.get_config(HYBRID)
    G = hy.num_heads // hy.num_kv_heads
    # hymba's lockstep rows (4 prompts x 5 kv heads) and its pool's (8
    # slots x 5).
    k2 = _dense_k2(gen, {G}, dv=hy.resolved_head_dim, groups=(G,),
                   kv_rows=(len(PROMPT_LENS) * hy.num_kv_heads,
                            CONT_SERVING["num_slots"] * hy.num_kv_heads))
    out["slay_decode_step"][HYBRID] = dict(k2[(G, False)], G=G)
    out["slay_decode_step_masked"][HYBRID] = dict(k2[(G, True)], G=G)
    log(f"kernels at the configs' head dims and groups: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(out)


def _slay_layers(cfg) -> int:
    """The layers that run the SLAY kernels: every layer but gemma2's
    local (windowed softmax) ones, which are PyTorch ops, and none of
    mamba2's (no attention)."""
    if cfg.family == "ssm":
        return 0
    return int((api.layer_kinds(cfg) == 0).sum())


def _cut_config(name: str, layers: int | None):
    cfg = configs.get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


class _HostDraws:
    """Draws the random weights of phases 22-24's configs on the host in
    one background thread, in the order the phases take them, at most
    two configs ahead: ``init_params(device="cpu")``, the same
    ``torch.Generator`` values as a draw for the card, while the card
    runs the phases before. Drawing 22 B values takes a few minutes of
    the host's time (one core, serially), which the script would
    otherwise spend with the card idle."""

    def __init__(self, specs: list):
        self._specs = list(specs)
        self._ready: list = []
        self._cond = threading.Condition()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        for name, layers in self._specs:
            with self._cond:
                self._cond.wait_for(lambda: len(self._ready) < 2)
            t0 = time.perf_counter()
            try:
                item = (name, layers, api.init_params(
                    _cut_config(name, layers), SEED, device="cpu"), None)
            except BaseException as e:     # re-raised by take()
                item = (name, layers, None, e)
            with self._cond:
                self._ready.append(item + (time.perf_counter() - t0,))
                self._cond.notify_all()

    def take(self, name: str, layers: int | None):
        """(host weights, seconds the draw took, seconds waited for it)."""
        t0 = time.perf_counter()
        with self._cond:
            self._cond.wait_for(lambda: bool(self._ready))
            got, got_layers, params, err, draw_s = self._ready.pop(0)
            self._cond.notify_all()
        if err is not None:
            raise err
        if (got, got_layers) != (name, layers):
            raise AssertionError(f"host draws out of order: {got} x "
                                 f"{got_layers} for {name} x {layers}")
        return params, draw_s, time.perf_counter() - t0


_HOST_DRAWS: _HostDraws | None = None


def _dense_init(name: str, layers: int | None, card: str):
    """A config (depth cut to ``layers`` if given) and its random
    weights from the script's seed, drawn on the host (``init_params``'s
    CPU generator; in the background when ``main`` started the draws)
    and moved to the card; the times on their own line."""
    cfg = _cut_config(name, layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if _HOST_DRAWS is None:
        params = api.init_params(cfg, SEED, device="cuda")
        how = f"{time.perf_counter() - t0:.1f} s"
    else:
        host, draw_s, waited = _HOST_DRAWS.take(name, layers)
        params = tree_map(lambda t: t.to("cuda"), host)
        del host
        how = (f"drawn in {draw_s:.1f} s in the background while the card "
               f"ran earlier phases; {waited:.1f} s waited for it, "
               f"{time.perf_counter() - t0:.1f} s in all with the copy")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    full = configs.get_config(name).num_layers
    cut = f" (reduced from {full})" if cfg.num_layers < full else ""
    layers = ("SSD blocks only" if cfg.family == "ssm" else
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, qk_norm="
              f"{cfg.qk_norm}, experts {cfg.moe_experts} (top "
              f"{cfg.moe_top_k}), window {cfg.local_window} (layers "
              f"{''.join(map(str, api.layer_kinds(cfg)))}, 1 = local)"
              + (", SSD heads beside" if cfg.family == "hybrid" else ""))
    log(f"{name}: {cfg.num_layers}L{cut} x {cfg.d_model}d, {layers}, vocab "
        f"{cfg.vocab_size}, tied={cfg.tie_embeddings}, {cfg.dtype}; "
        f"{n / 1e9:.3f} B params, {_tree_mb(params) / 1e3:.2f} GB")
    log(f"  host init of {n / 1e9:.3f} B params (torch.Generator on the CPU, "
        f"then to the card): {how}")
    return cfg, params


@_timed
def _dense_lockstep(cfg, params, card: str, extra_want=None) -> dict:
    """Phase 8's 4 prompts, 32 greedy tokens, through the lockstep engine
    (its decode step one CUDA graph; a frontend config's prompts behind
    the engine's zero stand-ins), launch counters read around that call
    (K1 once a SLAY layer, B4a once a SLAY layer and step, and
    ``extra_want`` besides: whisper's B7 in its prefill); the same engine
    eager, equal streams; ms per step of each in turns; a profiler window
    over the graphed step. Returns the launches."""
    nl = _slay_layers(cfg)
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
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    want = {k: n for k, n in (("slay_fused_fwd", nl),
                              ("slay_decode_step", nl * (MAX_NEW - 1))) if n}
    want.update(extra_want or {})
    if launches != want:
        raise AssertionError(f"{cfg.name} lockstep: launches {launches}, "
                             f"want {want}")
    for o in outs:
        if len(o) != MAX_NEW or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name}: bad output stream {o}")
    eager = engine.ServingEngine(cfg, params, device="cuda", max_len=2048,
                                 _graphs=False)
    _same_outputs(outs, eager.generate(reqs),
                  f"{cfg.name} lockstep greedy, graphed vs eager")
    B = len(reqs)
    steps = {"graphed": eng._lockstep(B, 0.0).step,
             "eager": eager._lockstep(B, 0.0).step}
    ms: dict = {k: [] for k in steps}
    with torch.inference_mode():
        for nm in ("graphed", "eager", "eager", "graphed"):
            ms[nm].append(time_ms(steps[nm], iters=MAX_NEW - 1, warmup=2))
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"  lockstep: {B} requests x {MAX_NEW} greedy tokens in {wall:.3f} s "
        f"(prefill included); launches {launches}; streams equal to eager; "
        f"ms per decode step graphed {med['graphed']:.3f}, eager "
        f"{med['eager']:.3f} (in turns)  [{card}]")
    profile(f"{cfg.name} lockstep decode step, graphed", steps["graphed"],
            med["graphed"])
    del eng, eager
    return launches


@_timed
def _dense_continuous(cfg, params, card: str, carry: bool = False) -> int:
    """Phase 12's trace on its 8-slot pool, graphed: B4b's launches (nl x
    K a dispatch, no other kernel), every request served, ms per dispatch
    and prefill tick, pool tokens/s; its first 4 requests again graphed
    and eager, streams equal to the whole run's; one full-pool dispatch
    under the profiler beside the least time a tick can take, the weights
    read once from device memory (with ``carry``, also the pool's state
    read and written once: an SSM carry is as large as a share of the
    weights). Returns B4b's launches (nl x K a dispatch, nl the SLAY
    layers)."""
    nl, K = _slay_layers(cfg), CONT_SERVING["macro_ticks"]
    reqs = _cont_requests(cfg)
    _cont_run(cfg, params, reqs[:2], max_len=1024)          # warm-up
    timed: dict = {}
    _build.reset_launches()
    outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed)
    n_b = _b4b_launches(f"{cfg.name} continuous", s["decode_dispatches"], nl,
                        K)
    for rid, r in enumerate(reqs):
        o = outs[rid]
        if (len(o) != r.max_new_tokens or o.min() < 0
                or o.max() >= cfg.vocab_size):
            raise AssertionError(f"{cfg.name}: bad stream rid {rid}: {o}")
    if not (s["requests_completed"] == CONT_REQUESTS
            and s["final_occupancy"] == 0
            and s["host_syncs"] == s["decode_dispatches"]):
        raise AssertionError(f"{cfg.name} continuous: {s}")
    graphs = eng.graph_cache_entries()
    if graphs != {"macro_decode": 1, "chunk": 1}:
        raise AssertionError(f"{cfg.name}: graphs after the run: {graphs}")
    disp, pre = timed["_decode_macro"], timed["_prefill_tick"]
    dec_tokens = s["tokens_generated"] - CONT_REQUESTS
    log(f"  continuous: {wall:.3f} s, {s['ticks']} ticks ({s['prefill_ticks']}"
        f" prefill, {s['decode_dispatches']} dispatches), B4b {n_b} launches "
        f"({nl} x {K} a dispatch, G = {cfg.num_heads // max(cfg.num_kv_heads, 1)}); "
        f"ms per dispatch median {statistics.median(disp) * 1e3:.2f}, "
        f"prefill tick median {statistics.median(pre) * 1e3:.2f}; pool "
        f"decode {dec_tokens / sum(disp):.1f} tokens/s; pool "
        f"{_tree_mb(eng.pool):.1f} MB  [{card}]")
    sub = reqs[:DENSE_SUB]
    graphed, _, _, g_wall = _cont_run(cfg, params, sub)
    eager, _, _, e_wall = _cont_run(cfg, params, sub, graphs=False)
    _same_streams(outs, graphed, f"{cfg.name} continuous rids 0-3, graphed")
    _same_streams(outs, eager, f"{cfg.name} continuous rids 0-3, eager")
    log(f"  rids 0-{DENSE_SUB - 1} alone, graphed {g_wall:.3f} s and eager "
        f"{e_wall:.3f} s: streams equal to the whole run's")
    pool_mb = _tree_mb(eng.pool) if carry else 0.0
    del eng
    wall_ms = _cont_profile(cfg, params, card, pieces=False, sampled=False,
                            eager=False)["graphed"]
    floor = (_tree_mb(params) + 2 * pool_mb) * 1e6 / HBM_BYTES_PER_S * 1e3
    what = (f"read the {_tree_mb(params) / 1e3:.2f} GB of weights once"
            + (f" and the {pool_mb:.1f} MB pool state once each way"
               if carry else ""))
    log(f"  a full-pool tick {wall_ms / K:.3f} ms graphed against "
        f"{floor:.3f} ms to {what} at 3.35 TB/s ({floor / (wall_ms / K):.1%}"
        f" of it)  [{card}]")
    return n_b


@_timed
def _dense_fp32(cfg, params, card: str) -> None:
    """The first 2 layers of the served weights widened to fp32, on the
    card against the port's CPU plain path: a 128-token prompt's
    last-token prefill logits (K1) and 2 decode steps' (B4a); the loss,
    the MoE aux loss and every gradient of one 1 x 256 batch (K1, K3,
    K4), as phase 9 holds slayformer's; gemma2's with its embedding
    divided by UNSATURATE; a vision config's prompt and batch behind
    random patch embeddings from the seed."""
    cfg32 = dataclasses.replace(cfg, num_layers=DENSE_FP32_LAYERS,
                                dtype="float32")
    p32 = tree_map_with_path(
        lambda path, t: (t[:DENSE_FP32_LAYERS] if path.startswith("layers")
                         else t).float(), _unsaturated(cfg, params))
    rng = np.random.default_rng(SEED + 9)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, DENSE_FP32_PROMPT)).astype(
            np.int32))
    toks = [torch.tensor([[int(t)]], dtype=torch.int32)
            for t in rng.integers(0, cfg.vocab_size, 2)]
    batch = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, global_batch=1, seed=SEED), 0)
    kw = {}
    if cfg.frontend == "vision":
        pe = torch.from_numpy(rng.standard_normal(
            (1, cfg.num_patches, cfg.d_model)).astype(np.float32))
        kw = {"patch_embeds": pe}
        batch = dict(batch, patch_embeds=pe)

    def run(p):
        with torch.inference_mode():
            lg, cache = api.prefill(p, cfg32, prompt, **kw)
            rows = [lg[0, -1].cpu()]
            for t in toks:
                lg, cache = api.decode_step(p, cfg32, cache, t)
                rows.append(lg[0, -1].cpu())
        loss, mx, grads = loop.value_and_grad(p, cfg32, batch)
        return rows, loss.cpu(), grads, mx["moe_aux"].cpu()

    got = run(p32)
    p_cpu = tree_map(lambda t: t.cpu(), p32)
    del p32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = run(p_cpu)
    log(f"  card fp32 vs CPU plain fp32, {DENSE_FP32_LAYERS} layers at full "
        f"width: a {DENSE_FP32_PROMPT}-token prompt and 2 decode steps, the "
        f"loss and gradients of 1 x 256 tokens (CPU "
        f"{time.perf_counter() - t0:.1f} s):")
    # fp32 on both sides, summation order differs (cuBLAS and the kernels'
    # tiles vs the CPU's GEMMs and 256-token chunks) through 2 layers as
    # wide as 25600: logits to 1e-5 of the largest, as phase 8 holds 12
    # layers of slayformer; the loss to 1e-5 relative and each gradient to
    # 1e-4 of its largest magnitude, as phase 9.
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        scale = float(w.abs().max())
        close(g, w, 1e-5 * scale, 0.0,
              "prefill logits" if i == 0 else f"decode step {i} logits")
    close(got[1], want[1], 0.0, 1e-5, "loss")
    close(got[3], want[3], 0.0, 1e-5, "moe_aux")
    # gemma2's local layers (a softcapped softmax over random weights)
    # amplify the rounding, as on the CPU, where the port's tests need 5x
    # the dense decoders' logit tolerance against the JAX package: its
    # attention gradients reached 1.06e-4 of their largest on the card.
    grad_rel = 5e-4 if cfg.mixed_layers else 1e-4
    _close_grads(got[2], want[2], lambda key: grad_rel)


def _close_grads(card, cpu, rel) -> None:
    """Each gradient leaf of the card's run (on the card) within ``rel(
    path)`` of its largest magnitude of the CPU's, compared on the card
    one leaf at a time: the comparison's passes over several GB of fp32
    took longer on the host than the CPU run itself."""
    for (key, g), (_, c) in zip(tree_items(card), tree_items(cpu)):
        c = c.to(g.device)
        close(g, c, rel(key) * (float(c.abs().max()) or 1.0), 0.0,
              f"grad {key}")


def _free_card() -> None:
    """Collect what reference cycles keep alive (a timed engine's wrapped
    step closes over the engine, with its pool and graphs), then hand the
    cached blocks back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


@_timed
def _dense_train(cfg, box: list, card: str, cuts=None,
                 remat: bool = False, held: bool = False,
                 seq_len: int = TRAIN_LEN, batch0: int = TRAIN_BATCH,
                 extra=None, extra_launches=None) -> dict:
    """4 AdamW steps of 8 x 1024 tokens (lr DENSE_LR) at the
    config's width and depth, every SLAY layer through K1, K3 and K4 once
    a step; a finite, falling loss. The step donates the weights and
    moments (``make_train_step(donate=True)``, as the JAX package's jitted
    step and the port's ``Trainer``): with new tensors beside the old,
    the update alone would need 28 bytes a parameter. ``box`` holds the
    weights, taken out of it so that nothing else keeps them. ``cuts``
    is the (layers, batch) tried in turn while the card cannot hold the
    step (by default the batch halved, never the width), each cut
    printed, the weights copied back from a host copy taken before the
    first step. ``remat`` recomputes every layer in the backward (K1
    then twice a SLAY layer and step). ``held`` judges the fall on the
    first batch, its loss after the 4 steps against before them, where
    the batches' own losses differ by more than 4 steps move them
    (hymba-1.5b's rose from batch to batch at every rate of 1e-5 to 1e-4
    while its first batch's fell). Batches are ``batch0`` x ``seq_len``
    tokens unless cut; ``extra(batch, step)`` adds the frontend's inputs
    to each (patch or frame embeddings on the card), and
    ``extra_launches`` the launches a step makes besides (whisper's B7
    and B8). Returns the launches (each kernel once a SLAY layer and
    step, K1 twice with ``remat``)."""
    if cuts:
        log(f"  train {cfg.name}: from {cuts[0][0]} layers x batch "
            f"{cuts[0][1]} (TRAIN_CUTS: {cfg.num_layers} x {TRAIN_BATCH} did "
            f"not fit the card in PR 26's runs)")
    cuts = cuts or [(cfg.num_layers, b) for b in
                    (batch0, batch0 // 2, batch0 // 4) if b]
    ocfg = AdamWConfig(lr=DENSE_LR, warmup_steps=1,
                       total_steps=DENSE_TRAIN_STEPS)
    p = box.pop()
    host = tree_map(lambda t: t.cpu(), p)
    _free_card()
    log(f"  train {cfg.name}: {torch.cuda.memory_allocated() / 1e9:.1f} GB "
        f"allocated before the first step (the weights), "
        f"{torch.cuda.memory_reserved() / 1e9:.1f} GB reserved")
    for n, (layers, batch) in enumerate(cuts):
        tcfg = dataclasses.replace(cfg, num_layers=layers)
        step = loop.make_train_step(tcfg, ocfg,
                                    loop.TrainConfig(remat=remat),
                                    donate=True)
        dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=seq_len, global_batch=batch,
                                   seed=SEED)

        def make(i, dcfg=dcfg, batch=batch):
            b = pipeline.make_batch(dcfg, i)
            return dict(b, **extra(batch, i)) if extra else b

        if p is None:
            p = tree_map_with_path(
                lambda path, t: (t[:layers] if path.startswith("layers")
                                 else t).to("cuda"), host)
        opt, ef, losses, times = adamw_init(p, ocfg), torch.zeros(()), [], []
        auxes = []
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        try:
            for i in range(DENSE_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, opt, ef, mx = step(p, opt, ef, make(i))
                losses.append(float(mx["loss"]))
                auxes.append(float(mx["moe_aux"]))
                times.append(time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:
            why = " ".join(str(e).split())[:420]
        else:
            break
        p = opt = ef = step = None
        _free_card()
        nxt = (f"cut to {cuts[n + 1][0]} layers x batch {cuts[n + 1][1]}"
               if n + 1 < len(cuts) else "no cut left")
        log(f"  train {cfg.name}: {layers} layers x batch {batch} x "
            f"{seq_len} does not fit the card ({why}); "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after "
            f"it; {nxt}, the same weights copied back")
    else:
        raise AssertionError(f"train {cfg.name}: no cut fits the card")
    cfg = tcfg
    nl = _slay_layers(cfg)
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    per = {k: nl * DENSE_TRAIN_STEPS * (2 if remat and k == TRAIN_KERNELS[0]
                                        else 1) for k in TRAIN_KERNELS}
    for k, n in (extra_launches or {}).items():
        per[k] = n * DENSE_TRAIN_STEPS
    _expect_launches(launches, {k: n for k, n in per.items() if n},
                     f"train {cfg.name}")
    cut = (" (reduced)" if cfg.num_layers
           < configs.get_config(cfg.name).num_layers else " (full depth)")
    log(f"  train: {DENSE_TRAIN_STEPS} AdamW steps (lr {DENSE_LR:g}) of "
        f"{batch} x {seq_len} tokens, {cfg.num_layers} layers{cut}"
        f"{', remat' if remat else ''}; "
        f"loss per step {', '.join(f'{x:.4f}' for x in losses)}"
        + (f" (moe_aux {', '.join(f'{x:.4f}' for x in auxes)})"
           if cfg.moe_experts else "") + "; ms per step "
        f"{', '.join(f'{x * 1e3:.1f}' for x in times)} (median of steps 2-"
        f"{DENSE_TRAIN_STEPS} {statistics.median(times[1:]) * 1e3:.1f} = "
        f"{batch * seq_len / statistics.median(times[1:]):.1f} tokens/s); "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
        f"launches {launches}  [{card}]")
    last = losses[-1]
    if held:
        with torch.no_grad():
            last = float(api.loss_fn(p, cfg, make(0))[0])
        log(f"  train: the first batch's loss {losses[0]:.4f} before the "
            f"{DENSE_TRAIN_STEPS} steps, {last:.4f} after them")
    if not all(np.isfinite(losses + [last])) or not last < losses[0]:
        raise AssertionError(f"train {cfg.name}: losses {losses}, the "
                             f"first batch's after them {last}")
    del p, opt, ef, step, host
    _free_card()
    return launches


def phase_dense(card: str) -> dict:
    """The dense decoders at full width (phase 22): phi4-mini-3.8b cut to
    8 layers, granite-20b and qwen3-32b to 4, each served lockstep
    and continuous, its fp32 logits at 2 layers against the CPU, and
    trained 4 steps at 4 layers. Returns {config: launches by kernel}."""
    t_phase = time.perf_counter()
    out = {}
    for name in DENSE_ARCHS:
        _free_card()                 # earlier phases' and configs' engines
        t_cfg = time.perf_counter()
        cfg, params = _dense_init(name, DENSE_SERVE_LAYERS.get(
            name, DENSE_LAYERS), card)
        got = collections.Counter(_dense_lockstep(cfg, params, card))
        got["slay_decode_step_masked"] += _dense_continuous(cfg, params, card)
        _dense_fp32(cfg, params, card)
        if cfg.num_layers > DENSE_LAYERS:
            cut = dataclasses.replace(cfg, num_layers=DENSE_LAYERS)
            params = tree_map_with_path(
                lambda path, t: (t[:DENSE_LAYERS].clone()
                                 if path.startswith("layers") else t), params)
            cfg = cut
        box = [params]
        del params
        got.update(_dense_train(cfg, box, card, TRAIN_CUTS.get(name)))
        out[name] = dict(got)
        log(f"{name}: {time.perf_counter() - t_cfg:.1f} s; launches {dict(got)}"
            f"  [{card}]")
    log(f"dense decoders: {time.perf_counter() - t_phase:.1f} s")
    return out


# -- gemma2-27b and the top-2 MoE decoders (phase 23) ----------------------

# Each at full width, depth cut: gemma2-27b to 4 layers (0 and 2 local, 1
# and 3 global), phi3.5-moe-42b-a6.6b to 2 (its train step holds no
# more at 8 x 1024; 4 until phase 24 needed the script's time),
# grok-1-314b to 1 (64 layers would draw 316 B values on the host).
MIXED_LAYERS = {"gemma2-27b": 4, "phi3.5-moe-42b-a6.6b": 2,
                "grok-1-314b": 1}
MIXED_ARCHS = tuple(MIXED_LAYERS)
# One request longer than gemma2's 4096-token window on the continuous
# pool (rings of min(8192, 4096) rows), chunks of 128.
LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 6144, 16, 8192
LONG_ARCHS = ("gemma2-27b", "phi3.5-moe-42b-a6.6b")
# The train steps' first cut, (layers, batch), where the card was shown
# not to hold 8 x 1024 (each tried and out of memory in PR 26's runs, on
# an H100 80GB): qwen3's 151936-wide and gemma2's 256000-wide fp32
# logits (qwen3 4 x 1024, gemma2 2 x 1024, their peaks 69.0 and 64.7
# GB); halved further only if the card cannot hold that either.
TRAIN_CUTS = {"qwen3-32b": [(4, 4), (4, 2)], "gemma2-27b": [(4, 2), (4, 1)]}
# A near-tie of bf16 logits through 4 layers: a top-2 gap under this
# fraction of the largest logit decides nothing between two programs.
LONG_GAP_FRAC = 3e-2
# An SSM config's long prompt in fp32, chunked against whole: the last
# token's logits within this fraction of the largest (fp32 in another
# order of sums through every layer's carry).
LONG_FP32_REL = 1e-3
# gemma2's local layers at 1 x 8192 (8192 % 4096 == 0: the banded route)
# against the masked route: the last token's bf16 logits within this
# fraction of the largest (each route's own bf16 rounding of the
# attention, through 4 layers).
BANDED_LEN, BANDED_REL = 8192, 3e-2
# gemma2's final softcap (30) saturates the logits of random weights
# (their scale is about sqrt(4608) x the tied embedding's 1): every
# comparison of logits (the long prompt's first token, fp32 against the
# CPU) runs with the embedding divided by this, so that the logits it
# compares are not flattened to the cap and tied there.
UNSATURATE = 64.0


def _unsaturated(cfg, params):
    """``params`` with the embedding divided by UNSATURATE for a config
    with a final logit softcap; the same tree otherwise."""
    if not cfg.final_logit_softcap:
        return params
    return dict(params, embed=params["embed"] / UNSATURATE)


def _pool_parts(pool) -> str:
    """The MB of a pool's kinds of state: rings, (S, z), SSD carry."""
    a, parts = pool.attn, []
    if a is not None and a.k is not None:
        parts.append(f"rings {_tree_mb({"k": a.k, "v": a.v}):.1f} MB")
    if a is not None and a.s is not None:
        parts.append(f"(S, z) {_tree_mb({"s": a.s, "z": a.z}):.1f} MB")
    if pool.ssm is not None:
        parts.append(f"SSD carry {_tree_mb(pool.ssm.h):.1f} MB and conv "
                     f"tail {_tree_mb(pool.ssm.conv):.1f} MB")
    return ", ".join(parts)


@_timed
def _long_prompt(cfg, params, card: str) -> int:
    """One 6144-token request (16 greedy tokens) on the continuous pool
    with rings of 4096 rows, chunks of 128: graphed and eager streams
    equal, B4b's launches (SLAY layers x K a dispatch); its first token
    against the whole-prompt prefill's argmax (for gemma2 equal unless a
    bf16 near-tie decides; an MoE layer's capacity is per call, so a
    chunked prefill may drop tokens a whole one keeps: a reading there).
    gemma2's embedding is divided by UNSATURATE. Returns B4b's
    launches."""
    nl, K = _slay_layers(cfg), CONT_SERVING["macro_ticks"]
    params = _unsaturated(cfg, params)
    rng = np.random.default_rng(SEED + 11)
    req = engine.Request(rng.integers(0, cfg.vocab_size, LONG_PROMPT)
                         .astype(np.int32), max_new_tokens=LONG_NEW)
    timed: dict = {}
    _build.reset_launches()
    outs, s, eng, wall = _cont_run(cfg, params, [req], timed=timed,
                                   max_len=LONG_MAX_LEN)
    n_b = _b4b_launches(f"{cfg.name} {LONG_PROMPT}-token prompt",
                        s["decode_dispatches"], nl, K)
    pool_mb, parts = _tree_mb(eng.pool), _pool_parts(eng.pool)
    del eng
    _free_card()
    eager, _, _, e_wall = _cont_run(cfg, params, [req], graphs=False,
                                    max_len=LONG_MAX_LEN)
    _same_streams(outs, eager, f"{cfg.name} {LONG_PROMPT}-token prompt, "
                  f"graphed vs eager")
    pre = timed["_prefill_tick"]
    log(f"  {LONG_PROMPT}-token prompt, {LONG_NEW} greedy tokens, pool of "
        f"{CONT_SERVING['num_slots']} slots at max_len {LONG_MAX_LEN} "
        f"({pool_mb:.1f} MB: {parts}): graphed {wall:.3f} s ({s['prefill_ticks']}"
        f" prefill ticks, median {statistics.median(pre) * 1e3:.2f} ms), eager"
        f" {e_wall:.3f} s, streams equal; B4b {n_b}  [{card}]")
    with torch.inference_mode():
        logits, _ = api.prefill(params, cfg,
                                torch.from_numpy(req.prompt[None]).cuda(),
                                **_stand_ins(cfg))
    row = logits[0, -1].float()
    top2 = torch.topk(row, 2)
    gap, scale = float(top2.values[0] - top2.values[1]), float(row.abs().max())
    whole, first = int(top2.indices[0]), int(outs[0][0])
    tie = gap < LONG_GAP_FRAC * scale
    log(f"  first token chunked {first}, whole-prompt prefill argmax {whole} "
        f"(top-2 gap {gap:.4f} of max |logit| {scale:.3f}"
        f"{', a bf16 near-tie' if tie else ''})")
    if cfg.family in ("ssm", "hybrid"):
        tie = _ssm_long_check(cfg, params, req.prompt, row, first, gap) or tie
    if first != whole and not tie:
        if cfg.moe_experts:
            log("  (a reading: the chunks' MoE capacity drops differ from "
                "the whole prompt's)")
        else:
            raise AssertionError(f"{cfg.name}: the {LONG_PROMPT}-token "
                                 f"prompt's first token {first} != whole-"
                                 f"prompt argmax {whole}")
    return n_b


def _stand_ins(cfg, batch: int = 1) -> dict:
    """The serving engines' zero frontend stand-ins of ``batch`` requests
    on the card, as ``api.prefill`` keywords (none for a plain
    decoder)."""
    return engine._frontend_kw(cfg, batch, torch.device("cuda"))


def _chunked_row(cfg, params, prompt, max_len=LONG_MAX_LEN) -> torch.Tensor:
    """The last-token logits (fp32) of ``prompt`` absorbed in the engine's
    chunks (``prefill_chunk`` from a zero batch-1 cache)."""
    C = CONT_SERVING["prefill_chunk"]
    with torch.inference_mode():
        cache = api.init_cache(cfg, 1, max_len, device="cuda")
        for o in range(0, len(prompt), C):
            lg, cache = api.prefill_chunk(
                cfg, params, cache,
                torch.from_numpy(prompt[None, o:o + C]).cuda())
    return lg[0, -1].float()


def _ssm_long_check(cfg, params, prompt, whole_row, first: int,
                    gap: float) -> bool:
    """The long prompt of an SSM config, chunked against whole: in bf16
    the engine's first token must be the chunked path's own argmax, and
    it counts as a near-tie when the two paths' logits differ by at
    least the whole prompt's top-2 gap (their bf16 roundings, through
    every layer's carry, decide it); in fp32 (the weights widened) the
    two paths' logits must agree within LONG_FP32_REL of the largest.
    Returns whether the bf16 decision is such a near-tie."""
    row = _chunked_row(cfg, params, prompt)
    drift = float((row - whole_row).abs().max())
    if int(row.argmax()) != first:
        raise AssertionError(f"{cfg.name}: the engine's first token {first}"
                             f" != its chunked prefill's argmax "
                             f"{int(row.argmax())}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    got = _chunked_row(cfg32, p32, prompt)
    with torch.inference_mode():
        want = api.prefill(p32, cfg32,
                           torch.from_numpy(prompt[None]).cuda())[0][0, -1]
    del p32
    _free_card()
    scale = float(want.abs().max())
    close(got, want.float(), LONG_FP32_REL * scale, 0.0,
          f"fp32 {LONG_PROMPT}-token prompt's last-token logits, chunks of "
          f"{CONT_SERVING['prefill_chunk']} vs whole")
    log(f"  bf16: chunked and whole logits differ by up to {drift:.4f} "
        f"(top-2 gap {gap:.4f}); fp32 argmax chunked {int(got.argmax())}, "
        f"whole {int(want.argmax())}")
    return drift >= gap


@_timed
def _banded_vs_masked(cfg, params, card: str) -> None:
    """gemma2's last-token logits of a 1 x 8192 prompt, the local layers
    through the banded route (8192 % 4096 == 0) against the same prompt
    with ``windowed_softmax_attention`` pointed at the masked route; the
    embedding divided by UNSATURATE."""
    from repro_torch.core import kernels as exact
    params = _unsaturated(cfg, params)
    rng = np.random.default_rng(SEED + 12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, BANDED_LEN))
                            .astype(np.int32)).cuda()
    banded = exact.windowed_softmax_attention
    calls = []

    def masked(q, k, v, window, logit_softcap=0.0):
        calls.append(q.shape[-3])
        return exact.masked_softmax_attention(q, k, v, True, logit_softcap,
                                              window)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg, _ = api.prefill(params, cfg, toks, max_len=LONG_MAX_LEN)
        torch.cuda.synchronize()
        return lg[0, -1].float(), (time.perf_counter() - t0) * 1e3

    def counted(*a, **kw):
        calls.append(-1)
        return banded(*a, **kw)

    exact.windowed_softmax_attention = counted
    try:
        got, b_ms = run()
        n_banded = len(calls)
        exact.windowed_softmax_attention = masked
        want, m_ms = run()
    finally:
        exact.windowed_softmax_attention = banded
    n_local = int(api.layer_kinds(cfg).sum())
    if n_banded != n_local or len(calls) != 2 * n_local:
        raise AssertionError(f"banded route taken {n_banded} times, masked "
                             f"{len(calls) - n_banded}; want {n_local} each")
    scale = float(want.abs().max())
    err = close(got, want, BANDED_REL * scale, 0.0,
                f"1 x {BANDED_LEN} last-token logits, banded vs masked local "
                f"layers (bf16)")
    log(f"  banded route {b_ms:.1f} ms, masked {m_ms:.1f} ms (the prefill, "
        f"first calls); argmax {int(got.argmax())} / {int(want.argmax())}; "
        f"max_abs_err {err:.4f} of max |logit| {scale:.3f}  [{card}]")
    _free_card()


def phase_mixed(card: str) -> dict:
    """gemma2-27b, phi3.5-moe-42b-a6.6b and grok-1-314b at full width
    (phase 23), depth cut: served lockstep and continuous (graphed against
    eager), the 6144-token prompt (gemma2, phi3.5-moe), gemma2's banded
    against masked route, fp32 at 2 layers against the CPU (gemma2,
    phi3.5-moe) and 4 train steps (gemma2, phi3.5-moe); the SLAY kernels'
    launches counted per layer kind. Returns {config: launches}."""
    t_phase = time.perf_counter()
    out = {}
    for name in MIXED_ARCHS:
        _free_card()
        t_cfg = time.perf_counter()
        cfg, params = _dense_init(name, MIXED_LAYERS[name], card)
        got = collections.Counter(_dense_lockstep(cfg, params, card))
        got["slay_decode_step_masked"] += _dense_continuous(cfg, params, card)
        if name in LONG_ARCHS:
            got["slay_decode_step_masked"] += _long_prompt(cfg, params, card)
        if cfg.local_window:
            _banded_vs_masked(cfg, params, card)
        if cfg.num_layers >= DENSE_FP32_LAYERS:
            _dense_fp32(cfg, params, card)
        if name in LONG_ARCHS:
            box = [params]
            del params
            got.update(_dense_train(cfg, box, card, TRAIN_CUTS.get(name)))
        else:
            n = sum(t.numel() for t in tree_leaves(params))
            log(f"  train {name}: not run (reduced): one layer's AdamW step "
                f"needs about 12 bytes a parameter (bf16 weights and "
                f"gradients, fp32 moments) x {n / 1e9:.2f} B = "
                f"{12 * n / 1e9:.0f} GB, more than the card's 80 GB")
            del params
        out[name] = dict(got)
        log(f"{name}: {time.perf_counter() - t_cfg:.1f} s; launches "
            f"{dict(got)}  [{card}]")
    log(f"gemma2 and the MoE decoders: {time.perf_counter() - t_phase:.1f} s")
    return out


# -- the SSM families mamba2-780m and hymba-1.5b (phase 24) ----------------

SSM_ARCH, HYBRID = "mamba2-780m", "hymba-1.5b"
SSM_ARCHS = (SSM_ARCH, HYBRID)
# Each at half its depth (reduced, for the script's time: whole, the
# phase took 218.7 s of a 926.0 s run on a fast host).
SSM_LAYERS = {SSM_ARCH: 24, HYBRID: 16}
# mamba2's durable runs: phase 13's trace and checkpoint cadence; the
# cached run's prefix cache holds every snapshot the trace stores (20 of
# 38.8 MB at 24 layers: one slot's SSD carry and conv tail, and the
# logits), the crashed run has none (its checkpoints hold the pool alone).
SSM_DUR_SERVING = dict(DUR_SERVING, prefix_cache_bytes=2 << 30)
# Without a cache this trace's pool holds one request at a time, and none
# at tick 64: the crashed run checkpoints every 216 ticks and dies at its
# first step from tick 220, so the checkpoint before the crash (tick 217)
# holds the carry of a request still live at the crash, and the restored
# run writes one more (each is the 309.7 MB pool at 24 layers).
SSM_CRASH_SERVING = dict(DUR_SERVING, prefix_cache_bytes=0,
                         checkpoint_every_ticks=216)
SSM_CRASH = (220, 220)


@_timed
def _ssm_durable(cfg, params, card: str) -> None:
    """mamba2 on phase 13's trace (16 requests on a shared 384-token
    system prompt): a cached run's streams equal to a cold run's, its
    hits (12-15 by their whole prompt), no pin left; then the run without
    a cache crashed at tick 220 after a checkpoint of the pool (every
    slot's SSD carry and tail, 309.7 MB) and restored, the cold run's
    streams, each token once. No SLAY kernel runs."""
    reqs = _dur_requests(cfg)
    runs = {}
    for name, nbytes in (("cold", 0),
                         ("cached", SSM_DUR_SERVING["prefix_cache_bytes"])):
        _build.reset_launches()
        outs, s, eng, wall = _cont_run(cfg, params, reqs,
                                       prefix_cache_bytes=nbytes)
        _no_slay_launches(f"{cfg.name} {name} run", s["decode_dispatches"],
                          0, 0)
        runs[name] = (outs, s, eng)
        log(f"  {name} run: {wall:.3f} s, {s['ticks']} ticks "
            f"({s['prefill_ticks']} prefill, {s['decode_dispatches']} "
            f"dispatches), {s['prompt_tokens']} prompt tokens absorbed  "
            f"[{card}]")
    (cold, sc, _), (warm, sw, eng) = runs["cold"], runs["cached"]
    _same_streams(cold, warm, f"{cfg.name} greedy, cached vs cold")
    pc, per = eng.prefix_cache, eng.metrics.per_request
    st = pc.stats()
    full = [r for r, x in per.items() if x.prefix_tokens == x.prompt_len]
    if not (set(warm) == set(cold) and st["hits"] >= 15
            and full == [12, 13, 14, 15] and pc.live_refs() == 0
            and sw["prefill_ticks"] < sc["prefill_ticks"]):
        raise AssertionError(f"{cfg.name} prefix cache: {st}, full hits "
                             f"{full}")
    log(f"  prefix cache: {st['hits']} hits ({len(full)} of whole prompts), "
        f"{st['entries']} entries of {st['bytes'] / st['entries'] / 1e6:.1f}"
        f" MB, {st['bytes'] / 2 ** 20:.1f} MiB, {st['evictions']} evictions;"
        f" prefill ticks {sc['prefill_ticks']} cold, {sw['prefill_ticks']} "
        f"cached; streams equal to the cold run's  [{card}]")
    del eng, runs
    _free_card()
    _dur_crash_restore(cfg, params, reqs, cold, card,
                       serving=ServingConfig(**SSM_CRASH_SERVING),
                       crash_window=SSM_CRASH, launches=_no_slay_launches)


def phase_ssm(card: str) -> dict:
    """mamba2-780m (24 of 48 SSD layers, no attention) and hymba-1.5b
    (16 of 32 layers of SLAY at G = 5 beside SSD heads) at full width
    (phase 24), random weights from the seed drawn on the host: phase 8's
    prompts lockstep, graphed and eager; phase 12's trace on the 8-slot
    pool, graphed, and its first 4 requests again graphed and eager; a
    full-pool dispatch under the profiler beside the weights' read and
    the pool's state read and written; a 6144-token prompt in 128-token
    chunks, graphed and eager, its first token against the whole-prompt
    prefill's argmax; mamba2's prefix cache and crash-restore; fp32 at 2
    layers against the CPU (logits, and the loss and gradients of 1 x
    256 tokens in one 256-step chunk, all finite: ROADMAP C-10); 4 AdamW
    steps of 8 x 1024 tokens with remat. mamba2 launches no SLAY kernel.
    Returns {config: launches}."""
    t_phase = time.perf_counter()
    out = {}
    for name in SSM_ARCHS:
        _free_card()
        t_cfg = time.perf_counter()
        cfg, params = _dense_init(name, SSM_LAYERS[name], card)
        di = cfg.ssm_expand * cfg.d_model
        slot = _tree_mb(api.abstract_cache(cfg, 1))
        log(f"  SSD blocks: d_inner {di}, {di // cfg.ssm_head_dim} heads of "
            f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv width "
            f"{cfg.ssm_conv_width}, chunk {cfg.chunk_size}; decode state "
            f"{slot:.1f} MB a slot")
        got = collections.Counter(_dense_lockstep(cfg, params, card))
        got["slay_decode_step_masked"] += _dense_continuous(
            cfg, params, card, carry=True)
        got["slay_decode_step_masked"] += _long_prompt(cfg, params, card)
        if cfg.family == "ssm":
            _ssm_durable(cfg, params, card)
        _dense_fp32(cfg, params, card)
        box = [params]
        del params
        got.update(_dense_train(cfg, box, card, remat=True, held=True))
        out[name] = dict(got)
        log(f"{name}: {time.perf_counter() - t_cfg:.1f} s; launches "
            f"{dict(got)}  [{card}]")
    log(f"the SSM families: {time.perf_counter() - t_phase:.1f} s")
    return out


# -- internvl2-76b's vision prefix and whisper-small (phase 25) ------------

VISION, AUDIO = "internvl2-76b", "whisper-small"
FRONTEND_ARCHS = (VISION, AUDIO)
# internvl2 served at 4 of its 80 layers (reduced: 80 would draw 70.6 B
# values, 141 GB in bf16, which no H100 holds); trained at 2 on 4 x 768
# text tokens behind its 256 patch rows, the batch halved only if the
# card cannot hold it.
VISION_LAYERS, VISION_TRAIN_LAYERS = 4, 2
VISION_TRAIN_BATCH, VISION_TRAIN_LEN = 4, 768
# whisper-small whole (12 + 12 layers); trained on 8 x 448 tokens (the
# decoder context of arXiv:2212.04356, not a config field) over 1500
# frames.
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_LEN = 8, 448
AUDIO_FP32_LAYERS = 2          # encoder and decoder layers held to the CPU
# The cross-attention's query and key side: gradients 1e-3 of the other
# leaves' (the normalisation of a non-causal linear attention nearly
# cancels them), where fp32 alone puts the JAX package's CPU run 0.7-1.1e-4
# of their largest from its float64 run (2 + 2 layers at full width) and
# the card 4.3e-4 from the CPU; held to 1e-3.
AUDIO_CROSS_QK = ("dec_layers/cross/wq", "dec_layers/cross/wk",
                  "dec_layers/pre_cross")


def _b7_per_pass(cfg) -> int:
    """B7 launches of one forward over whisper: Ψ of q and of k in every
    encoder layer's self-attention and every decoder layer's
    cross-attention (the decoder's self-attention runs K1)."""
    return 2 * (cfg.enc_layers + cfg.num_layers)


def _embeds(shape, step: int) -> torch.Tensor:
    """Random bf16 frontend embeddings on the card, from the seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100 + step)
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _vision(card: str) -> dict:
    """internvl2-76b at full width, 4 of 80 layers: phase 8's prompts
    behind the zero 256-row prefix (lockstep, graphed and eager), phase
    12's trace on the 8-slot pool with each prefix absorbed in 2 chunks of
    128, a full-pool dispatch under the profiler beside the weights'
    read, a 6144-token prompt behind the prefix chunked against whole,
    fp32 at 2 layers against the CPU, 4 AdamW steps at 2 layers. Returns
    (the launches, no kernel numbers)."""
    cfg, params = _dense_init(VISION, VISION_LAYERS, card)
    log(f"  vision prefix: {cfg.num_patches} patch rows ahead of every "
        f"prompt (zero stand-ins for the frontend's embeddings)")
    got = collections.Counter(_dense_lockstep(cfg, params, card))
    got["slay_decode_step_masked"] += _dense_continuous(cfg, params, card)
    got["slay_decode_step_masked"] += _long_prompt(cfg, params, card)
    _dense_fp32(cfg, params, card)
    n = VISION_TRAIN_LAYERS
    params = tree_map_with_path(
        lambda path, t: (t[:n].clone() if path.startswith("layers") else t),
        params)
    box = [params]
    del params
    got.update(_dense_train(
        dataclasses.replace(cfg, num_layers=n), box, card,
        seq_len=VISION_TRAIN_LEN, batch0=VISION_TRAIN_BATCH, held=True,
        extra=lambda b, i: {"patch_embeds": _embeds(
            (b, cfg.num_patches, cfg.d_model), i)}))
    return dict(got), {}


@_timed
def _audio_continuous(cfg, params, card: str) -> int:
    """Phase 12's trace on the 8-slot pool through whisper's whole-prompt
    prefill (one tick a request over 1500 zero frames: K1 once a decoder
    layer, B7 twice an encoder and a decoder layer; no prefix cache, no
    bucket), decode graphed (B4b once a layer and tick); its first 4
    requests again graphed and eager; the pool's MB under SLAY against
    softmax, reckoned from the shapes; a full-pool dispatch under the
    profiler beside the decoder's weights and the pool state read once.
    Returns the launches."""
    nl, K = cfg.num_layers, CONT_SERVING["macro_ticks"]
    reqs = _cont_requests(cfg)
    _cont_run(cfg, params, reqs[:2])                       # warm-up
    timed: dict = {}
    _build.reset_launches()
    outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed)
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    d = s["decode_dispatches"]
    _expect_launches(launches, {
        "slay_decode_step_masked": nl * K * d,
        "slay_fused_fwd": nl * CONT_REQUESTS,
        "feature_map_fwd": _b7_per_pass(cfg) * CONT_REQUESTS},
        f"{cfg.name} continuous")
    for rid, r in enumerate(reqs):
        o = outs[rid]
        if (len(o) != r.max_new_tokens or o.min() < 0
                or o.max() >= cfg.vocab_size):
            raise AssertionError(f"{cfg.name}: bad stream rid {rid}: {o}")
    graphs = eng.graph_cache_entries()
    if not (s["requests_completed"] == CONT_REQUESTS
            and s["prefill_ticks"] == CONT_REQUESTS
            and s["bucket_hits"] == 0 == s["bucket_misses"]
            and eng.prefix_cache is None
            and graphs == {"macro_decode": 1, "chunk": 0}):
        raise AssertionError(f"{cfg.name} continuous: {s}, graphs {graphs}")
    disp, pre = timed["_decode_macro"], timed["_prefill_tick"]
    dec_tokens = s["tokens_generated"] - CONT_REQUESTS
    slot = {kind: _tree_mb(api.abstract_cache(
        dataclasses.replace(cfg, attn_kind=kind), 1,
        CONT_SERVING["max_len"])) for kind in ("slay", "softmax")}
    enc_kv = _tree_mb(api.abstract_cache(
        dataclasses.replace(cfg, attn_kind="softmax"), 1, 1).cross_s) * 2
    log(f"  continuous: {wall:.3f} s, {s['ticks']} ticks ({s['prefill_ticks']}"
        f" whole-prompt prefills, {d} dispatches), launches {launches}; ms "
        f"per dispatch median {statistics.median(disp) * 1e3:.2f}, prefill "
        f"tick median {statistics.median(pre) * 1e3:.2f} (encoder, prompt "
        f"and cross state, eager); pool decode {dec_tokens / sum(disp):.1f} "
        f"tokens/s  [{card}]")
    log(f"  decode state a slot: SLAY {slot['slay']:.1f} MB (self and cross "
        f"(S, z)); softmax {slot['softmax']:.1f} MB at max_len "
        f"{CONT_SERVING['max_len']} ({enc_kv:.1f} MB of it the encoder's "
        f"fp32 keys and values); the pool {_tree_mb(eng.pool):.1f} MB")
    sub = reqs[:DENSE_SUB]
    graphed, _, _, g_wall = _cont_run(cfg, params, sub)
    eager, _, _, e_wall = _cont_run(cfg, params, sub, graphs=False)
    _same_streams(outs, graphed, f"{cfg.name} continuous rids 0-3, graphed")
    _same_streams(outs, eager, f"{cfg.name} continuous rids 0-3, eager")
    log(f"  rids 0-{DENSE_SUB - 1} alone, graphed {g_wall:.3f} s and eager "
        f"{e_wall:.3f} s: streams equal to the whole run's")
    pool_mb = _tree_mb(eng.pool)
    del eng
    wall_ms = _cont_profile(cfg, params, card, pieces=False, sampled=False,
                            eager=False)["graphed"]
    dec_mb = _tree_mb({k: v for k, v in params.items()
                       if k not in ("enc_layers", "enc_pos", "enc_norm")})
    floor = (dec_mb + pool_mb) * 1e6 / HBM_BYTES_PER_S * 1e3
    log(f"  a full-pool tick {wall_ms / K:.3f} ms graphed against {floor:.3f}"
        f" ms to read the decoder's {dec_mb:.1f} MB of weights and the "
        f"{pool_mb:.1f} MB pool once at 3.35 TB/s ({floor / (wall_ms / K):.1%}"
        f" of it)  [{card}]")
    return launches


@_timed
def _audio_fp32(cfg, params, card: str) -> None:
    """whisper's first 2 encoder and 2 decoder layers widened to fp32, on
    the card against the port's CPU plain path, over random frames from
    the seed: a 128-token prompt's last-token prefill logits and 2 decode
    steps' logits; the loss and every gradient of one 1 x 256 batch (the
    cross-attention's query and key side to 1e-3 of its largest,
    ``AUDIO_CROSS_QK``)."""
    n = AUDIO_FP32_LAYERS
    cfg32 = dataclasses.replace(cfg, num_layers=n, enc_layers=n,
                                dtype="float32")
    p32 = tree_map_with_path(
        lambda path, t: (t[:n] if path.startswith(("enc_layers",
                                                   "dec_layers"))
                         else t).float(), params)
    rng = np.random.default_rng(SEED + 13)
    frames = torch.from_numpy(rng.standard_normal(
        (1, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, DENSE_FP32_PROMPT)).astype(np.int32))
    toks = [torch.tensor([[int(t)]], dtype=torch.int32)
            for t in rng.integers(0, cfg.vocab_size, 2)]
    batch = dict(pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, global_batch=1, seed=SEED),
        0), frame_embeds=frames)

    def run(p):
        with torch.inference_mode():
            lg, cache = api.prefill(p, cfg32, prompt, frame_embeds=frames)
            rows = [lg[0, -1].cpu()]
            for t in toks:
                lg, cache = api.decode_step(p, cfg32, cache, t)
                rows.append(lg[0, -1].cpu())
        loss, _, grads = loop.value_and_grad(p, cfg32, batch)
        return rows, loss.cpu(), grads

    _build.reset_launches()
    got = run(p32)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    b7 = _b7_per_pass(cfg32)
    _expect_launches(launches, {
        "slay_fused_fwd": 2 * n, "slay_decode_step": 2 * n,
        "feature_map_fwd": 2 * b7, "feature_map_bwd": b7,
        "slay_fused_bwd_q": n, "slay_fused_bwd_kv": n},
        f"{cfg.name} fp32 at {n} + {n} layers")
    p_cpu = tree_map(lambda t: t.cpu(), p32)
    del p32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = run(p_cpu)
    log(f"  card fp32 vs CPU plain fp32, {n} encoder and {n} decoder layers "
        f"at full width over {cfg.enc_seq} random frames: a "
        f"{DENSE_FP32_PROMPT}-token prompt and 2 decode steps, the loss and "
        f"gradients of 1 x 256 tokens (CPU {time.perf_counter() - t0:.1f} s;"
        f" launches on the card {launches}):")
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        close(g, w, 1e-5 * float(w.abs().max()), 0.0,
              "prefill logits" if i == 0 else f"decode step {i} logits")
    close(got[1], want[1], 0.0, 1e-5, "loss")
    _close_grads(got[2], want[2],
                 lambda key: 1e-3 if key in AUDIO_CROSS_QK else 1e-4)


@_timed
def _audio_fmap(cfg, params) -> dict:
    """B7 and B8 at whisper's shapes, bf16, head dim 64: N = 8 x 1500 x 12
    rows (an encoder layer's q in the 8 x 448 training batch) against
    their plain versions, timed beside their bounds, and N = 1500 x 12
    (one request's prefill) checked. Returns each kernel's numbers at the
    training shape."""
    feat, sp = cfg.slay_config(), params["slay"]
    a, w = sp["anchors"], sp["omegas"]
    d, m = feat.head_dim, feat.feature_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    rows = {}
    for n in (AUDIO_TRAIN_BATCH * cfg.enc_seq * cfg.num_heads,
              cfg.enc_seq * cfg.num_heads):
        log(f"B7/B8 at whisper's shape: N={n}, d={d}, m={m}, bf16")
        u = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
        dpsi = torch.randn(n, m, generator=gen,
                           device="cuda").to(torch.bfloat16)
        e7 = close(feature_map.launch_fwd(u, a, w, feat),
                   feature_map.feature_map_plain(u, a, w, feat),
                   *PSI_TOL[torch.bfloat16], "psi")
        bwd = (u, a, w, dpsi, feat)
        e8 = _check_grads(feature_map.feature_map_bwd(*bwd),
                          feature_map.feature_map_bwd_plain(*bwd), FMAP_OUT,
                          torch.bfloat16, "B8 vs plain")
        if rows:
            continue
        bounds = feature_map_bounds(n, d, feat.num_anchors, feat.num_prf,
                                    feat.num_quad_nodes, u.element_size())
        for name, kern, plain, err in (
                ("feature_map_fwd",
                 lambda: feature_map.launch_fwd(u, a, w, feat),
                 lambda: feature_map.feature_map_plain(u, a, w, feat), e7),
                ("feature_map_bwd", lambda: feature_map.launch_bwd(*bwd),
                 lambda: feature_map.feature_map_bwd_plain(*bwd), e8)):
            row = rows[name] = _kernel_row(
                name, time_ms(kern), time_ms(plain, iters=10), bounds[name],
                err, "the feature map")
            row["device_ms"] = device_ms(kern)
            row["n"] = n
            log(f"  {name}: {row['device_ms']:.4f} ms on the card without "
                f"the wrapper's host time")
    return rows


def _audio(card: str) -> tuple:
    """whisper-small whole (12 encoder and 12 decoder layers x 768, 1500
    frames): phase 8's prompts over 1500 zero frames, lockstep graphed
    and eager (K1 once a decoder layer, B7 twice an encoder and a decoder
    layer, B4a once a decoder layer and step); phase 12's trace through
    the whole-prompt prefill; fp32 at 2 + 2 layers against the CPU; B7
    and B8 at its shapes; 4 AdamW steps of 8 x 448 tokens over 1500
    random frames (K1, K3, K4 once a decoder layer, B7 and B8 twice an
    encoder and a decoder layer, a step). Returns (launches, B7/B8
    numbers)."""
    cfg, params = _dense_init(AUDIO, None, card)
    b7 = _b7_per_pass(cfg)
    log(f"  encoder: {cfg.enc_layers} layers over {cfg.enc_seq} frames "
        f"(zero stand-ins when served); the decoder's cross-attention reads "
        f"its (S, z) summaries")
    got = collections.Counter(_dense_lockstep(
        cfg, params, card, extra_want={"feature_map_fwd": b7}))
    got.update(_audio_continuous(cfg, params, card))
    _audio_fp32(cfg, params, card)
    fmap = _audio_fmap(cfg, params)
    box = [params]
    del params
    got.update(_dense_train(
        cfg, box, card, seq_len=AUDIO_TRAIN_LEN, batch0=AUDIO_TRAIN_BATCH,
        held=True, extra=lambda b, i: {"frame_embeds": _embeds(
            (b, cfg.enc_seq, cfg.d_model), i)},
        extra_launches={"feature_map_fwd": b7, "feature_map_bwd": b7}))
    return dict(got), fmap


@_timed
def _bucketed(card: str) -> dict:
    """Full-width slayformer-124m on phase 12's trace with
    ``prefill_chunk=0``: every prompt right-padded to its pow-2 bucket and
    prefilled whole through K1 (once a layer and request), masked by its
    true length; the bucket counters; the greedy streams against the
    chunked run's (bf16: equal, or parted at a bf16 near-tie of the
    whole-prompt path; fp32: equal up to each stream's first near-tie, 4
    requests). Returns (the launches, no kernel numbers)."""
    cfg = configs.get_config("slayformer-124m")
    params = api.init_params(cfg, SEED, device="cuda")
    nl, K = cfg.num_layers, CONT_SERVING["macro_ticks"]
    reqs = _cont_requests(cfg)
    runs, total = {}, collections.Counter()
    for name, C in (("chunked", CONT_SERVING["prefill_chunk"]),
                    ("bucketed", 0)):
        timed: dict = {}
        _build.reset_launches()
        outs, s, eng, wall = _cont_run(cfg, params, reqs, timed=timed,
                                       prefill_chunk=C)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        want = {"slay_decode_step_masked": nl * K * s["decode_dispatches"]}
        if not C:
            want["slay_fused_fwd"] = nl * CONT_REQUESTS
        _expect_launches(launches, want, f"slayformer {name} run")
        total.update(launches)
        runs[name] = outs
        pre = timed["_prefill_tick"]
        log(f"  slayformer, prefill_chunk={C} ({name}): {wall:.3f} s, "
            f"{s['prefill_ticks']} prefill ticks (median "
            f"{statistics.median(pre) * 1e3:.2f} ms), bucket hits "
            f"{s['bucket_hits']}, misses {s['bucket_misses']}, TTFT p50 "
            f"{s['ttft_ticks_p50']} ticks; launches {launches}  [{card}]")
        if not C:
            lo = ServingConfig(**CONT_SERVING).prefill_bucket_min
            buckets = {engine._bucket_len(len(r.prompt), lo,
                                          CONT_SERVING["max_len"])
                       for r in reqs}
            if not (s["bucket_misses"] == len(buckets)
                    and s["bucket_hits"] == CONT_REQUESTS - len(buckets)
                    and s["prefill_ticks"] == CONT_REQUESTS):
                raise AssertionError(f"bucketed run: {s}, buckets "
                                     f"{sorted(buckets)}")
        del eng
    parted = []
    for rid, r in enumerate(reqs):
        a, b = runs["chunked"][rid], runs["bucketed"][rid]
        if np.array_equal(a, b):
            continue
        j = int(np.flatnonzero(a[:len(b)] != b[:len(a)])[0])
        gap, scale = _greedy_gaps(params, cfg, r.prompt, b[:j + 1])[j]
        if gap >= LONG_GAP_FRAC * scale:
            raise AssertionError(f"bucketed rid {rid} parts from the chunked "
                                 f"run at token {j} with a top-2 gap {gap:.4f}"
                                 f" of {scale:.3f}: not a near-tie")
        parted.append((rid, j, gap))
    log(f"  bf16 streams, bucketed vs chunked: {CONT_REQUESTS - len(parted)} "
        f"of {CONT_REQUESTS} equal; parted at bf16 near-ties (rid, token, "
        f"top-2 gap): {parted}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    sub = reqs[:CONT_FP32]
    chunked, _, _, _ = _cont_run(cfg32, p32, sub)
    whole, _, _, _ = _cont_run(cfg32, p32, sub, prefill_chunk=0)
    compared = 0
    for rid, r in enumerate(sub):
        gaps = _greedy_gaps(p32, cfg32, r.prompt, whole[rid])
        n = next((i for i, (g, sc) in enumerate(gaps) if g < GAP_FRAC * sc),
                 len(whole[rid]))
        if not np.array_equal(chunked[rid][:n], whole[rid][:n]):
            raise AssertionError(f"fp32 rid {rid}: bucketed {whole[rid]} vs "
                                 f"chunked {chunked[rid]} before {n}")
        compared += n
    log(f"  fp32, {len(sub)} requests: bucketed and chunked streams equal over"
        f" {compared} of {sum(len(o) for o in whole.values())} tokens (up to "
        f"each stream's first near-tie)")
    del params, p32
    _free_card()
    return dict(total), {}


def phase_frontends(card: str) -> tuple:
    """internvl2-76b's vision prefix at full width (4 of 80 layers),
    whisper-small whole, and slayformer-124m's bucketed whole-prompt
    prefill (phase 25). Returns ({config: launches}, whisper's B7/B8
    numbers)."""
    t_phase = time.perf_counter()
    out, numbers = {}, {}
    for name, fn in ((VISION, _vision), (AUDIO, _audio),
                     ("slayformer-124m", _bucketed)):
        _free_card()
        t_cfg = time.perf_counter()
        out[name], numbers[name] = fn(card)
        log(f"{name}: {time.perf_counter() - t_cfg:.1f} s; launches "
            f"{out[name]}  [{card}]")
    log(f"the frontends: {time.perf_counter() - t_phase:.1f} s")
    return out, numbers[AUDIO]


# -- phase 26: the rest of the core ---------------------------------------

# (a)'s cases: every poly kind and fusion at slayformer's head shape (d =
# dv = 64, P = 8, D = 16, R = 3) over 1 x 1024 tokens and 12 heads;
# ``exact`` (m = R·d²·D = 196,608 under the tensor fusion, a 9.7 GB Ψ at
# 12 heads) over 2; ``subsample`` at 96 of the P·D columns (m = 288, a
# ragged last slice of the scan; laplace's P·D is 16: 12 of those); then
# Table 2's "large" budget, d = 32, P = D = 32 (m = 3072) over 1 x 256
# tokens, 2 heads, chunks of 64, past the fused kernels' width.
CORE_L, CORE_HEADS, CORE_EXACT_HEADS, CORE_CHUNK = 1024, 12, 2, 256
LARGE = dict(head_dim=32, num_anchors=32, num_prf=32)
LARGE_L, LARGE_HEADS, LARGE_CHUNK = 256, 2, 64
# The kernel route's num = y·(den + δ) and den against the plain route's,
# each within this fraction of the plain's largest |num| or |den|: fp32 in
# another summation order (B5's 3xTF32 tiles, K1's node shares). Signed
# kinds (rm, tensorsketch, nystrom, a subsampled or exact Ψ) can drive a
# row's den toward 0, where y alone says nothing of the kernel.
CORE_REL = 1e-4
# Gradients against autograd of the plain route, within this fraction of
# each one's largest |value|: rm's signed den amplifies the fp32
# differences (1e-3); anchor's is a sum of nonnegative terms (1e-4).
CORE_GRAD_REL = {"rm": 1e-3, "anchor": 1e-4}
# The long-context example's (S, z) against the feature map's plain twin
# then la.prefill_state, within this fraction of the largest |S|, |z|:
# B7 and its twin round the same fp32 Ψ to bf16 and differ only where
# their last fp32 bits straddle a rounding; its decode outputs (bf16)
# against la.decode_step at one bf16 rounding of the largest |y|.
LONGCTX_REL, LONGCTX_Y_REL = 1e-4, 2e-2
# (c): one 32,768-token prompt on slayformer-124m, 16 greedy tokens, each
# engine with room for it; the last-token prefill logits of the lockstep
# engine (K1 over the whole prompt) against the continuous engine's
# chunks (fp32 state carried over 256 chunks of 128), within this
# fraction of the largest |logit| (bf16 rounded in other places through
# 12 layers); a greedy token may differ only at a top-2 gap under
# LONG_GAP_FRAC of the largest (C-2).
CORE_PROMPT, CORE_NEW = 32768, 16
CORE_MAX_LEN = CORE_PROMPT + CORE_NEW
CORE_SHORT = 512
CORE_TIMED = 64                # new tokens of the tick-timing runs
CORE_LOGIT_REL = 3e-2


def _core_config(kind, fusion, **extra):
    sketch = 0
    if fusion == "subsample":
        sketch = 12 if kind == "laplace" else 96
    return features.SlayFeatureConfig(poly_kind=kind, fusion=fusion,
                                      sketch_dim=sketch, **extra)


def _core_inputs(cfg, L, h, dv):
    p = init_feature_params(cfg, torch.Generator().manual_seed(SEED),
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k = (torch.randn(1, L, h, cfg.head_dim, generator=gen, device="cuda")
            for _ in range(2))
    v, dy = (torch.randn(1, L, h, dv, generator=gen, device="cuda")
             for _ in range(2))
    return p, q, k, v, dy


def _core_route(route: str) -> dict:
    """The launches one call of ``ops.slay_fused_attention`` must make on
    ``route`` (``ops.attention_route``)."""
    if route == ops.FUSED:
        return {"slay_fused_fwd": 1}
    if route == ops.TWO_DISPATCH:
        return {"feature_map_fwd": 2, "slay_scan_fwd": 1}
    return {"slay_scan_fwd": 1}


def _plain_route(p, q, k, v, cfg, chunk):
    """The plain route on the card: Ψ of core.features (PyTorch ops), then
    the scan's plain twin, head-major; -> (y, den)."""
    def hm(x):
        return x[0].transpose(0, 1).contiguous()
    qf, kf = (features.slay_features(x, p, cfg) for x in (q, k))
    return slay_scan.causal_linear_attention_plain(hm(qf), hm(kf), hm(v),
                                                   chunk_size=chunk)


def _kernel_route(p, q, k, v, cfg, chunk, route: str):
    """The kernels ``ops.slay_fused_attention`` routes to, head-major;
    -> (y, den): K1, or Ψ (B7 or PyTorch ops) then B5."""
    def hm(x):
        return x[0].transpose(0, 1).contiguous()
    if route == ops.FUSED:
        return slay_fused.fused_causal_attention(
            hm(q), hm(k), hm(v), p["anchors"], p["omegas"], cfg,
            chunk_size=chunk)
    qf, kf = (ops.slay_features(x, p, cfg) for x in (q, k))
    return slay_scan.launch_fwd(hm(qf), hm(kf), hm(v))


def _core_case(kind, fusion, L, h, chunk, dv=64, **extra) -> tuple:
    """One feature config through ``ops.slay_fused_attention`` (its
    launches counted) against the plain route: num and den compared
    apart; -> (launches, kernel ms, plain ms)."""
    cfg = _core_config(kind, fusion, **extra)
    route = ops.attention_route(cfg, cfg.head_dim, dv, False, "cuda")
    p, q, k, v, _ = _core_inputs(cfg, L, h, dv)
    what = f"{kind}+{fusion} m={cfg.feature_dim} ({h} heads x {L})"
    with torch.inference_mode():
        _build.reset_launches()
        y = ops.slay_fused_attention(q, k, v, p, cfg, chunk_size=chunk)
        torch.cuda.synchronize()
        got = {n: c for n, c in _build.LAUNCHES.items() if c}
        want = _core_route(route)
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        yk, dk = _kernel_route(p, q, k, v, cfg, chunk, route)
        if not torch.equal(y[0].transpose(0, 1), yk):
            raise AssertionError(f"{what}: the routed call's y is not the "
                                 f"kernel's")
        yp, dp = _plain_route(p, q, k, v, cfg, chunk)
        num_k, num_p = (a.float() * (b[..., None] + 1e-6)
                        for a, b in ((yk, dk), (yp, dp)))
        close(num_k, num_p, CORE_REL * float(num_p.abs().max()), 0.0,
              f"{what} num")
        close(dk, dp, CORE_REL * float(dp.abs().max()), 0.0, f"{what} den")
        del yk, dk, yp, dp, num_k, num_p
        ms = time_ms(lambda: ops.slay_fused_attention(q, k, v, p, cfg,
                                                      chunk_size=chunk),
                     iters=5, warmup=1)
        pms = time_ms(lambda: _plain_route(p, q, k, v, cfg, chunk), iters=3,
                      warmup=1)
    log(f"    {what}: route {sorted(got)}, {ms:.3f} ms (plain {pms:.3f})")
    return got, ms, pms


def _core_grads(kind, L, h, chunk, dv=64, **extra) -> dict:
    """dq, dk, dv, dA, dΩ through ``ops.slay_fused_attention`` against
    autograd of the plain route (core.features, la.causal_chunked), fp32;
    -> the launches."""
    cfg = _core_config(kind, "tensor", **extra)
    p, q, k, v, dy = _core_inputs(cfg, L, h, dv)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (q, k, v, p["anchors"], p["omegas"])]
        prm = dict(p, anchors=leaves[3], omegas=leaves[4])
        (fn(prm, *leaves[:3]) * dy).sum().backward()
        return [t.grad for t in leaves]

    _build.reset_launches()
    got = grads(lambda prm, q, k, v: ops.slay_fused_attention(
        q, k, v, prm, cfg, chunk_size=chunk))
    torch.cuda.synchronize()
    counts = {n: c for n, c in _build.LAUNCHES.items() if c}
    route = {"slay_scan_fwd": 1, "slay_scan_bwd_q": 1, "slay_scan_bwd_kv": 1}
    if cfg.kernelizable:
        route.update(feature_map_fwd=2, feature_map_bwd=2)
    if counts != route:
        raise AssertionError(f"{kind} backward: launches {counts}, want "
                             f"{route}")
    want = grads(lambda prm, q, k, v: la.causal_chunked(
        features.slay_features(q, prm, cfg),
        features.slay_features(k, prm, cfg), v, chunk_size=chunk))
    rel = CORE_GRAD_REL[kind]
    for name, g, w in zip(("dq", "dk", "dv", "dA", "dOmega"), got, want,
                          strict=True):
        if w is None:      # rm reads no anchors
            if g is not None:
                raise AssertionError(f"{kind}: a {name} for unread anchors")
            continue
        close(g, w, rel * float(w.abs().max()), 0.0,
              f"{kind} m={cfg.feature_dim} {name} vs plain autograd")
    log(f"    {kind} m={cfg.feature_dim} backward: launches {counts}")
    return counts


@_timed
def _core_kinds(card: str) -> collections.Counter:
    """(a): every poly kind x fusion through ``slay_attention``'s causal
    entry, and the anchor kind past the fused kernels' width, against the
    plain route; two backwards. Returns the launches."""
    launches: collections.Counter = collections.Counter()
    log(f"  (a) every feature config, causal, fp32, d = 64, P = 8, D = 16, "
        f"R = 3; num and den within {CORE_REL:g} of the plain's largest")
    for kind in features.POLY_KINDS:
        for fusion in features.FUSIONS:
            h = CORE_EXACT_HEADS if kind == "exact" else CORE_HEADS
            got, _, _ = _core_case(kind, fusion, CORE_L, h, CORE_CHUNK,
                                   head_dim=64)
            launches.update(got)
            _free_card()
    log(f"  Table 2's large budget, d = 32, P = D = 32, R = 3 "
        f"(K1 and K4 need {slay_fused.fused_smem_bytes(32, 32, 32, 32)} and "
        f"{slay_fused.fused_bwd_smem_bytes(32, 32, 32, 32)} B > "
        f"{_build.SMEM_LIMIT})")
    for kind in features.POLY_KINDS:
        got, _, _ = _core_case(kind, "tensor", LARGE_L, LARGE_HEADS,
                               LARGE_CHUNK, dv=32, **LARGE)
        if kind == "anchor" and got.get("slay_fused_fwd", 0):
            raise AssertionError("anchor at P = D = 32 launched K1")
        launches.update(got)
    launches.update(_core_grads("rm", CORE_L, CORE_HEADS, CORE_CHUNK,
                                head_dim=64))
    launches.update(_core_grads("anchor", LARGE_L, LARGE_HEADS, LARGE_CHUNK,
                                dv=32, **LARGE))
    log(f"  (a) launches {dict(launches)}  [{card}]")
    return launches


@_timed
def _core_long_context(card: str, lock_ms: dict) -> collections.Counter:
    """(b): ``examples/long_context.py`` in-process at its defaults (32,768
    tokens, 16 steps): its (S, z) against the feature map's plain twin
    then la.prefill_state, its decode outputs against la.decode_step from
    that state. Returns the launches."""
    _build.reset_launches()
    r = long_context.main([])
    counts = collections.Counter(
        {n: c for n, c in _build.LAUNCHES.items() if c})
    steps = len(r["ys"])
    want = {"feature_map_fwd": 1 + 2 * steps, "slay_decode_step": steps}
    if counts != want:
        raise AssertionError(f"long context: launches {dict(counts)}, want "
                             f"{want}")
    cfg, a, w = r["cfg"], r["params"]["anchors"], r["params"]["omegas"]

    def psi(u):
        return feature_map.feature_map_plain(
            u.reshape(-1, u.shape[-1]), a, w, cfg).reshape(*u.shape[:-1], -1)

    with torch.inference_mode():
        plain = la.prefill_state(psi(r["k"]), r["v"])
        for name, got, exp in zip("sz", r["state0"], plain, strict=True):
            close(got, exp, LONGCTX_REL * float(exp.abs().max()), 0.0,
                  f"long context prefill {name}")
        qf = psi(r["q"])
        st, err = r["state0"], 0.0
        for y in r["ys"]:
            yw, st = la.decode_step(qf, qf, r["q"], st)
            err = max(err, close(y, yw, LONGCTX_Y_REL * float(
                yw.float().abs().max()), 0.0, "long context decode y"))
        for name, got, exp in zip("sz", r["state"], st, strict=True):
            close(got, exp, LONGCTX_REL * float(exp.abs().max()), 0.0,
                  f"long context state after {steps} steps, {name}")
    log(f"  (b) long context: state {r['state_mb']:.2f} MB against a "
        f"{r['kv_mb']:.2f} MB KV cache; prefill {r['prefill_s'] * 1e3:.1f} ms"
        f"; decode {r['ms_per_token']:.4f} ms/token (one layer's 8 heads, "
        f"batch 1) beside phase 8's lockstep step (12 layers x 4 requests) "
        f"{lock_ms['graphed']:.3f} ms graphed, {lock_ms['eager']:.3f} "
        f"eager; launches {dict(counts)}  [{card}]")
    return counts


@_timed
def _core_long_prompt(card: str, lock_ms: dict) -> collections.Counter:
    """(c): one 32,768-token prompt on slayformer-124m (12 x 768) through
    the lockstep engine (K1 once a layer over the whole prompt) and the
    continuous engine (chunks of 128, fp32 state carried in PyTorch ops,
    B4b ticks); equal greedy streams but for C-2 ties, last-token logits
    within CORE_LOGIT_REL; decode ms per step at 32,768 against 512
    tokens. Returns the launches."""
    cfg = configs.get_config("slayformer-124m")
    nl, K = cfg.num_layers, CONT_SERVING["macro_ticks"]
    laps = [("start", time.perf_counter())]
    params = api.init_params(cfg, SEED, device="cuda")
    laps.append(("weights", time.perf_counter()))
    rng = np.random.default_rng(SEED + 26)
    prompt = rng.integers(0, cfg.vocab_size, CORE_PROMPT).astype(np.int32)
    req = engine.Request(prompt, max_new_tokens=CORE_NEW)
    launches: collections.Counter = collections.Counter()

    lock = engine.ServingEngine(cfg, params, device="cuda",
                                max_len=CORE_MAX_LEN + 64)
    lock.generate([engine.Request(prompt[:64], max_new_tokens=2)])   # warm
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out_l = lock.generate([req])[0]
    torch.cuda.synchronize()
    wall_l = time.perf_counter() - t0
    got = {n: c for n, c in _build.LAUNCHES.items() if c}
    want = {"slay_fused_fwd": nl, "slay_decode_step": nl * (CORE_NEW - 1)}
    if got != want:
        raise AssertionError(f"32k lockstep: launches {got}, want {want}")
    launches.update(got)
    # The graphed lockstep step (batch 1) at 32,768 and 512 tokens of
    # context, in turns: CUDA events around each replay, after a
    # generate that leaves the engine's cache at that context.
    short = prompt[-CORE_SHORT:]
    step_ms: dict = {CORE_PROMPT: [], CORE_SHORT: []}
    with torch.inference_mode():
        for p in (short, prompt, prompt, short):
            lock.generate([engine.Request(p, max_new_tokens=2)])
            step_ms[len(p)].append(time_ms(lock._lockstep(1, 0.0).step,
                                           iters=16, warmup=2))
    del lock
    _free_card()
    laps.append(("lockstep", time.perf_counter()))

    timed: dict = {}
    _build.reset_launches()
    outs, s, eng, wall_c = _cont_run(cfg, params, [req], timed=timed,
                                     max_len=CORE_MAX_LEN)
    n_b = _b4b_launches("32k continuous", s["decode_dispatches"], nl, K)
    launches["slay_decode_step_masked"] += n_b
    out_c = outs[next(iter(outs))]
    del eng
    _free_card()
    pre = timed["_prefill_tick"]
    laps.append(("continuous", time.perf_counter()))
    # Tick time at 32,768 and 512 tokens of context, in turns: graphed
    # dispatches of K ticks after the first two (the eager warm-up and the
    # capture), CUDA events around each.
    tick_ms: dict = {CORE_PROMPT: [], CORE_SHORT: []}
    for p in (short, prompt, prompt, short):
        timed_p: dict = {}
        _cont_run(cfg, params, [engine.Request(p, max_new_tokens=CORE_TIMED)],
                  timed=timed_p, max_len=len(p) + CORE_TIMED)
        tick_ms[len(p)] += [t / K * 1e3 for t in timed_p["_decode_macro"][2:]]
        _free_card()
    laps.append(("tick timing", time.perf_counter()))

    gaps = _greedy_gaps(params, cfg, prompt, out_l)
    laps.append(("gaps", time.perf_counter()))
    diff = [t for t in range(CORE_NEW) if out_l[t] != out_c[t]]
    if diff:
        t = diff[0]
        gap, scale = gaps[t]
        if gap >= LONG_GAP_FRAC * scale:
            raise AssertionError(f"32k prompt: streams differ at token {t} "
                                 f"(top-2 gap {gap:.4f} of {scale:.3f})")
        log(f"  streams part at token {t}, a near-tie (top-2 gap {gap:.4f} "
            f"of max |logit| {scale:.3f}): C-2")
    with torch.inference_mode():
        whole, _ = api.prefill(params, cfg, torch.from_numpy(prompt[None])
                               .cuda(), max_len=CORE_MAX_LEN)
    whole = whole[0, -1].float()
    chunked = _chunked_row(cfg, params, prompt, max_len=CORE_MAX_LEN)
    laps.append(("whole and chunked logits", time.perf_counter()))
    close(whole, chunked, CORE_LOGIT_REL * float(whole.abs().max()), 0.0,
          "32k last-token logits, K1 whole vs chunked")
    lock = {n: statistics.median(v) for n, v in step_ms.items()}
    tick = {n: statistics.median(v) for n, v in tick_ms.items()}
    log(f"  (c) {CORE_PROMPT}-token prompt, {CORE_NEW} greedy tokens: "
        f"lockstep {wall_l:.3f} s (K1 {nl}), continuous {wall_c:.3f} s "
        f"({s['prefill_ticks']} prefill ticks, median "
        f"{statistics.median(pre) * 1e3:.2f} ms; B4b {n_b}); streams "
        f"{'equal' if not diff else 'equal up to a tie'}")
    log(f"  decode ms per step at {CORE_PROMPT} against {CORE_SHORT} tokens "
        f"of context, in turns: lockstep graphed step (batch 1) "
        f"{lock[CORE_PROMPT]:.3f} / {lock[CORE_SHORT]:.3f} (phase 8's, 4 "
        f"requests: graphed {lock_ms['graphed']:.3f}, eager "
        f"{lock_ms['eager']:.3f}); continuous graphed tick (1 of "
        f"{CONT_SERVING['num_slots']} slots, a dispatch / {K}) "
        f"{tick[CORE_PROMPT]:.3f} / {tick[CORE_SHORT]:.3f}  [{card}]")
    log("  (c) seconds: " + ", ".join(
        f"{name} {t - laps[i][1]:.1f}" for i, (name, t) in
        enumerate(laps[1:])))
    return launches


@_timed
def _core_quickstart(card: str) -> collections.Counter:
    """(d): ``examples/quickstart.py`` in-process: its rel-L2 against exact
    spherical Yat and its 30 train steps. Returns the launches."""
    _build.reset_launches()
    rel, losses = quickstart.main([])
    counts = collections.Counter(
        {n: c for n, c in _build.LAUNCHES.items() if c})
    n = len(losses)
    nl = configs.get_smoke_config("slayformer-124m").num_layers
    want = {"slay_fused_fwd": 1 + nl * n, "slay_fused_bwd_q": nl * n,
            "slay_fused_bwd_kv": nl * n}
    if counts != want or not np.isfinite(rel) or losses[-1] >= losses[0]:
        raise AssertionError(f"quickstart: rel-L2 {rel}, losses {losses[0]}"
                             f" -> {losses[-1]}, launches {dict(counts)}, "
                             f"want {want}")
    log(f"  (d) quickstart: rel-L2 {rel:.4f}; loss {losses[0]:.4f} at step 0,"
        f" {losses[-1]:.4f} at step {n - 1}; launches {dict(counts)}  "
        f"[{card}]")
    return counts


def phase_core(card: str, lock_ms: dict) -> dict:
    """Phase 26: the rest of the core. (a) every feature config through
    the causal entry, (b) the long-context example at 32,768 tokens, (c)
    slayformer-124m's 32,768-token prompt through both engines, (d) the
    quickstart. ``lock_ms`` is phase 8's lockstep step, graphed and
    eager. Returns the launches per part."""
    t_phase = time.perf_counter()
    out = {"kinds": _core_kinds(card)}
    _free_card()
    out["long_context"] = _core_long_context(card, lock_ms)
    _free_card()
    out["long_prompt"] = _core_long_prompt(card, lock_ms)
    _free_card()
    out["quickstart"] = _core_quickstart(card)
    log(f"the core: {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 27: the sharded paths on a one-rank NCCL group -------------------

SHARD_STEPS = 4
SHARD_LOSS_RTOL = 1e-4           # fp32 reductions in another order, bf16 model
SHARD_REQUESTS = CONT_K1_REQUESTS
ROWS_B1_B4 = ("slay_fused_fwd", "slay_fused_bwd_q", "slay_fused_bwd_kv",
              "slay_decode_step", "slay_decode_step_masked")


def _one_rank_group():
    """A one-rank NCCL process group (rank 0 of 1 on a free loopback
    port) and its 1x1 mesh on ``cuda``. NCCL or nothing: a failure to
    start raises, no other backend is tried."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return make_mesh((1, 1), ("data", "model"))


def _sharded_train(cfg, mesh, card: str, train_losses, fused_step_s) -> dict:
    """``Trainer(mesh=...)``: phase 9's weights, batches and optimizer for
    SHARD_STEPS steps, then one ``save_collectives`` step. Its launches."""
    from torch.distributed.tensor import DTensor
    nl = cfg.num_layers
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                               global_batch=TRAIN_BATCH, seed=SEED)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        tr = loop.Trainer(cfg, ocfg, loop.TrainConfig(
            remat=False, ckpt_dir=ckpt, ckpt_every=1000), seed=SEED,
            device="cuda", mesh=mesh)
        if not all(isinstance(x, DTensor) for x in tree_leaves(
                {"p": tr.params, "m": tr.opt_state.m})):
            raise AssertionError("the sharded Trainer holds plain tensors")
        per_step, inner = [], tr.step_fn

        def counted_step(*args):
            before = dict(_build.LAUNCHES)
            out = inner(*args)
            per_step.append(_launch_delta(before))
            return out

        tr.step_fn = counted_step
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        hist = tr.run(pipeline.batch_iterator(dcfg), SHARD_STEPS,
                      log_every=1000)
        torch.cuda.synchronize()
        tr.step_fn = inner
        one = {k: nl for k in TRAIN_KERNELS}
        for i, got in enumerate(per_step):
            _expect_launches(got, one, f"sharded train step {i}")
        losses = [h["loss"] for h in hist]
        want = train_losses[:SHARD_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        log(f"  sharded Trainer.run: {len(hist)} steps; launches a step "
            f"{per_step[-1]}; loss per step "
            f"{', '.join(f'{x:.4f}' for x in losses)} against phase 9's "
            f"{', '.join(f'{x:.4f}' for x in want)}: largest relative "
            f"difference {rel:.2e} (limit {SHARD_LOSS_RTOL:g})")
        if len(losses) != SHARD_STEPS or not rel <= SHARD_LOSS_RTOL:
            raise AssertionError(f"sharded losses {losses} vs {want}")
        times = [h["step_time_s"] for h in hist]
        step_s = statistics.median(times[1:])
        log(f"  sharded step: median of steps 2-{SHARD_STEPS} "
            f"{step_s * 1e3:.2f} ms against phase 9's {fused_step_s * 1e3:.2f}"
            f" ms unsharded (first {times[0] * 1e3:.1f} ms)  [{card}]")
        # One remat="save_collectives" step on the sharded state.
        step = loop.sharded_train_step(
            cfg, ocfg, loop.TrainConfig(remat="save_collectives"), mesh,
            donate=False)
        b0 = dict(_build.LAUNCHES)
        _, _, _, m = step(tr.params, tr.opt_state, torch.zeros(()),
                          pipeline.make_batch(dcfg, SHARD_STEPS))
        torch.cuda.synchronize()
        got = _launch_delta(b0)
        _expect_launches(got, {"slay_fused_fwd": 2 * nl,
                               "slay_fused_bwd_q": nl,
                               "slay_fused_bwd_kv": nl},
                         "save_collectives step")
        log(f"  save_collectives step: loss {float(m['loss']):.4f}, "
            f"launches {got}")
        return _delta_b1_b4(before)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _delta_b1_b4(before: dict) -> dict:
    """Launches of rows B1-B4b since ``before``."""
    return {k: _build.LAUNCHES[k] - before[k] for k in ROWS_B1_B4}


def _sharded_serve(cfg, mesh, card: str) -> dict:
    """The continuous engine with ``mesh`` beside the unsharded one on the
    first SHARD_REQUESTS requests of phase 12's trace, in turns
    (unsharded, sharded, sharded, unsharded; each engine new, so each
    captures its graphs at its first dispatch). The first sharded run's
    launches."""
    nl, K = cfg.num_layers, CONT_SERVING["macro_ticks"]
    params = api.init_params(cfg, SEED, device="cuda")
    reqs = _cont_requests(cfg)[:SHARD_REQUESTS]
    t_u, t_s = {}, {}

    def sharded(timed):
        eng = engine.ContinuousServingEngine(
            cfg, params, serving=ServingConfig(**CONT_SERVING),
            device="cuda", mesh=mesh)
        return _timed_run(eng, reqs, timed)

    ref, s_u, _, wall_u = _cont_run(cfg, params, reqs, timed=t_u)
    before = dict(_build.LAUNCHES)
    got, s, eng, wall = sharded(t_s)
    launches = _delta_b1_b4(before)
    _same_streams(ref, got, "sharded engine vs unsharded engine")
    _same_streams(ref, sharded(t_s)[0], "sharded engine, second run")
    _same_streams(ref, _cont_run(cfg, params, reqs, timed=t_u)[0],
                  "unsharded engine, second run")
    want = nl * K * s["decode_dispatches"]
    if (launches.get("slay_decode_step_masked", 0) != want or not want
            or s["decode_dispatches"] != s_u["decode_dispatches"]
            or s["slot_shards"] != 1 or eng.slot_shard_fallbacks):
        raise AssertionError(f"sharded engine: launches {launches}, want "
                             f"{want} B4b; summary {s}")
    graphs = eng.graph_cache_entries()
    if graphs != {"macro_decode": 1, "chunk": 1}:
        raise AssertionError(f"sharded engine graphs {graphs}")
    du, ds = (statistics.median(t["_decode_macro"]) * 1e3 for t in (t_u, t_s))
    log(f"  sharded continuous engine: {len(reqs)} requests, streams equal "
        f"to the unsharded engine's; {s['decode_dispatches']} dispatches, "
        f"B4b {launches.get('slay_decode_step_masked', 0)} = {nl} x {K} x "
        f"{s['decode_dispatches']}; graphs {graphs}; ms per dispatch median "
        f"over two runs each, in turns (unsharded, sharded, sharded, "
        f"unsharded): {ds:.2f} sharded against {du:.2f} unsharded (first "
        f"runs' wall {wall:.3f} s against {wall_u:.3f} s)  [{card}]")
    return launches


def phase_sharded(card: str, train_losses, fused_step_s: float) -> dict:
    """Phase 27: the sharded train step and the slot-sharded engine on a
    one-rank NCCL group and its 1x1 mesh. Returns the launches of the
    sharded runs by kernel."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m")
    mesh = _one_rank_group()
    log(f"sharded: {dist.get_backend()} group of {dist.get_world_size()} "
        f"rank, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{mesh.device_type}; {cfg.name} at full width")
    try:
        train = _sharded_train(cfg, mesh, card, train_losses, fused_step_s)
        _free_card()
        serve_l = _sharded_serve(cfg, mesh, card)
    finally:
        dist.destroy_process_group()
    _free_card()
    out = {k: train.get(k, 0) + serve_l.get(k, 0) for k in ROWS_B1_B4}
    log(f"sharded: launches {out}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 28: ROADMAP C-15's configs, each on its route ----------------------

# slayformer-124m with each of C-15's feature configs, beside its own
# (the fused default): the quadrature nodes past the kernels' 8, P·D not a
# multiple of 16 (K3 and K4 refuse it, B8 takes it) and head dim 128 at
# P = D = 32 (B8 needs 362,752 B a block). ops.attention_route picks
# each one's route before any launch.
C15_CONFIGS = {
    "fused default": {},
    "R = 12": dict(slay_quad_nodes=12),
    "P = 4, D = 6": dict(slay_anchors=4, slay_prf=6),
    "head dim 128, P = D = 32": dict(head_dim=128, slay_anchors=32,
                                     slay_prf=32),
}
C15_LAYERS = 2
C15_BATCH = 4                  # the timed bf16 steps: 4 x TRAIN_LEN tokens
C15_TIMED = 3                  # timed steps after one untimed
# Each C-15 config's fp32 loss on the card at 1 x C15_CHECK_LEN tokens
# against the CPU plain path's from the same weights: fp32 in another
# summation order (phase 9 holds the fused default's).
C15_LOSS_RTOL = 1e-5
C15_CHECK_LEN = 512
C15_PROMPTS = (200, 131)       # the lockstep generate at R = 12, fp32
C15_NEW = 16
# Launches per SLAY layer of one training step on each route.
ROUTE_TRAIN = {
    ops.FUSED: {"slay_fused_fwd": 1, "slay_fused_bwd_q": 1,
                "slay_fused_bwd_kv": 1},
    ops.TWO_DISPATCH: {"feature_map_fwd": 2, "feature_map_bwd": 2,
                       "slay_scan_fwd": 1, "slay_scan_bwd_q": 1,
                       "slay_scan_bwd_kv": 1},
    ops.TORCH_PSI: {"slay_scan_fwd": 1, "slay_scan_bwd_q": 1,
                    "slay_scan_bwd_kv": 1},
}


def _all_delta(before: dict) -> dict:
    """Every kernel's launches since ``before``, the nonzero ones."""
    return {k: n - before[k] for k, n in _build.LAUNCHES.items()
            if n != before[k]}


@_timed
def _c15_train(name: str, over: dict, card: str) -> tuple[dict, float]:
    """One config at C15_LAYERS layers: C15_TIMED bf16 AdamW steps of
    C15_BATCH x TRAIN_LEN tokens (phase 9's TrainConfig, no remat, the
    fused default; each step's launches the route's after one untimed
    step), then, for a C-15 config, the fp32 loss and gradients of
    1 x C15_CHECK_LEN tokens on the card against the CPU plain path's
    from the same weights. Returns (launches, median ms per bf16 step)."""
    cfg = dataclasses.replace(configs.get_config("slayformer-124m", **over),
                              num_layers=C15_LAYERS)
    f = cfg.slay_config()
    route = ops.attention_route(f, f.head_dim, cfg.resolved_head_dim, True,
                                "cuda")
    per_step = {k: n * C15_LAYERS for k, n in ROUTE_TRAIN[route].items()}
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    step = loop.make_train_step(cfg, ocfg, loop.TrainConfig(remat=False))
    params = api.init_params(cfg, SEED, device="cuda")
    opt = adamw_init(params, ocfg)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LEN,
                               global_batch=C15_BATCH, seed=SEED)
    before = dict(_build.LAUNCHES)
    times, losses = [], []
    for i in range(C15_TIMED + 1):
        batch = pipeline.make_batch(dcfg, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b0 = dict(_build.LAUNCHES)
        params, opt, _, m = step(params, opt, torch.zeros(()), batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _expect_launches(_all_delta(b0), per_step, f"{name}: step {i}")
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    step_ms = statistics.median(times[1:]) * 1e3
    del params, opt, step
    _free_card()
    log(f"  {name} (d = {f.head_dim}, P = {f.num_anchors}, D = "
        f"{f.num_prf}, R = {f.num_quad_nodes}, m = {f.feature_dim}): route "
        f"{route}; launches a step {per_step}; bf16 {C15_BATCH} x "
        f"{TRAIN_LEN} losses {', '.join(f'{x:.4f}' for x in losses)}, "
        f"median of steps 2-{C15_TIMED + 1} {step_ms:.2f} ms  [{card}]")
    if not over:
        return _all_delta(before), step_ms
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b1 = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=C15_CHECK_LEN, global_batch=1,
        seed=SEED), 0)
    p_cpu = api.init_params(cfg32, SEED, device="cpu")
    b32 = dict(_build.LAUNCHES)
    loss_g, _, g_gpu = loop.value_and_grad(
        tree_map(lambda t: t.cuda(), p_cpu), cfg32, b1)
    torch.cuda.synchronize()
    _expect_launches(_all_delta(b32), per_step, f"{name}: fp32 step")
    loss_c, _, g_cpu = loop.value_and_grad(p_cpu, cfg32, b1)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_rel = max(float((g.cpu() - c).abs().max())
                   / (float(c.abs().max()) or 1.0)
                   for (_, g), (_, c) in zip(tree_items(g_gpu),
                                             tree_items(g_cpu)))
    log(f"    fp32 1 x {C15_CHECK_LEN}: card loss {float(loss_g):.6f}, CPU plain "
        f"{float(loss_c):.6f}, relative difference {rel:.2e} (limit "
        f"{C15_LOSS_RTOL:g}); largest gradient difference {grad_rel:.2e} "
        f"of its largest (a reading)")
    if not rel <= C15_LOSS_RTOL:
        raise AssertionError(f"{name}: card loss {float(loss_g)} against "
                             f"the CPU's {float(loss_c)}")
    del g_gpu, g_cpu
    _free_card()
    return _all_delta(before), step_ms


@_timed
def _c15_serve(card: str) -> dict:
    """``ServingEngine.generate`` at R = 12 (full depth, fp32): the
    prefill on the PyTorch-Ψ route (B5 once a layer), every decode step
    through K2 at m = 1536; greedy streams equal to the CPU plain path's
    on a trace whose top-2 gaps are no near-ties (C-2). Its launches."""
    over = C15_CONFIGS["R = 12"]
    cfg = configs.get_config("slayformer-124m", dtype="float32", **over)
    nl, f = cfg.num_layers, cfg.slay_config()
    params = api.init_params(cfg, SEED, device="cuda")
    rng = np.random.default_rng(SEED + 28)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in C15_PROMPTS]
    reqs = [engine.Request(p, max_new_tokens=C15_NEW) for p in prompts]
    eng = engine.ServingEngine(cfg, params, device="cuda", max_len=512)
    eng.generate([engine.Request(prompts[0][:32], max_new_tokens=2)])  # warm
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_delta(before)
    _expect_launches(launches, {"slay_scan_fwd": nl,
                                "slay_decode_step": nl * (C15_NEW - 1)},
                     "R = 12 generate")
    worst = min(g / s for p, o in zip(prompts, outs)
                for g, s in _greedy_gaps(params, cfg, p, o))
    if worst < GAP_FRAC:
        raise AssertionError(f"R = 12 generate: a top-2 gap of {worst:.2e} "
                             f"of the largest logit, a near-tie (C-2)")
    cpu = engine.ServingEngine(cfg, api.init_params(cfg, SEED, device="cpu"),
                               device="cpu", max_len=512).generate(reqs)
    _same_outputs(outs, cpu, "R = 12 generate, card vs CPU plain path")
    log(f"  R = 12 (m = {f.feature_dim}) generate: {len(reqs)} prompts of "
        f"{C15_PROMPTS} tokens, {C15_NEW} greedy tokens each in {wall:.3f} s;"
        f" prefill route "
        f"{ops.attention_route(f, f.head_dim, f.head_dim, False, 'cuda')}"
        f"; launches {launches}; streams equal to the CPU's, smallest top-2 "
        f"gap {worst:.2e} of the largest logit  [{card}]")
    del eng
    _free_card()
    return launches


def phase_c15(card: str) -> dict:
    """Phase 28: C-15's configs, routed before any launch: one training
    config each on its route (bf16 step times beside the fused default's,
    fp32 loss against the CPU), then R = 12 served through K2. Returns
    the phase's launches by kernel."""
    t_phase = time.perf_counter()
    log(f"C-15 routes: slayformer-124m at {C15_LAYERS} layers, "
        f"{C15_TIMED + 1} bf16 steps of {C15_BATCH} x {TRAIN_LEN} tokens "
        f"each config, fp32 loss against the CPU at 1 x {C15_CHECK_LEN}")
    launches: collections.Counter = collections.Counter()
    ms = {}
    for name, over in C15_CONFIGS.items():
        got, ms[name] = _c15_train(name, over, card)
        launches.update(got)
    base = ms["fused default"]
    log("  step time against the fused default's "
        + ", ".join(f"{n} {t / base:.2f}x" for n, t in ms.items()
                    if n != "fused default")
        + f"  [{card}]")
    launches.update(_c15_serve(card))
    log(f"C-15: launches {dict(launches)}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches)


# Phase 29: the dry run of slayformer-124m at full depth, at the shapes
# phases 8 and 9 run, against the same steps on the card.
DRY_CELLS = (
    configs.ShapeCell("chip_train", TRAIN_LEN, TRAIN_BATCH, "train"),
    configs.ShapeCell("chip_prefill", max(PROMPT_LENS), len(PROMPT_LENS),
                      "prefill"),
    configs.ShapeCell("chip_decode", max(PROMPT_LENS), len(PROMPT_LENS),
                      "decode"))
DRY_PEAK_GAP = 0.10            # a peak gap past this is explained in PERF.md
DRY_TIMED = 10                 # timed calls of each real step (median)
DRY_CONTRACT = ServingConfig(num_slots=8, max_len=1024, prefill_chunk=128,
                             macro_ticks=8)


def _dry_train_cfg(cfg) -> loop.TrainConfig:
    """The dry run's step on a one-rank world: the reference's
    microbatches for the cell (2 at 8 x 1024 tokens), remat on."""
    from repro_torch.launch import dryrun
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    return loop.TrainConfig(
        microbatches=dryrun.default_microbatches(cfg, DRY_CELLS[0], one),
        remat=True)


def _dryrun_child(path: str) -> int:
    """``chip_smoke.py --dryrun-child PATH``: phase 29's dry run in a
    process of its own (its fake one-rank world never meets phase 27's
    NCCL group); writes the three records to PATH. Needs no card."""
    from repro_torch.launch import dryrun
    cfg = configs.get_config("slayformer-124m")
    recs = [dryrun.run_cell(cfg.name, cell, mesh_shape=(1, 1), world_size=1,
                            train_cfg=_dry_train_cfg(cfg), verbose=False)
            for cell in DRY_CELLS]
    with open(path, "w") as f:
        json.dump(recs, f)
    for r in recs:
        if r["status"] != "ok":
            print(f"{r['shape']}: {r['status']}: {r.get('error')}\n"
                  f"{r.get('traceback')}", file=sys.stderr)
    return 0 if all(r["status"] == "ok" for r in recs) else 1


def _dry_measured(what: str, fn) -> tuple:
    """(fn's launches and the bytes it allocated at most beyond what was
    live, in one call; then the ms of each of DRY_TIMED calls, timed by
    CUDA events around each) on the card, and a profiler window over one
    more call beside their median (``profile``: device busy time and
    idle share)."""
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    launches = _all_delta(before)
    temp = torch.cuda.max_memory_allocated() - base
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(DRY_TIMED)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = [start.elapsed_time(end) for start, end in events]
    profile(what, fn, statistics.median(ms))
    return launches, temp, ms


def _nbytes(*trees) -> int:
    return sum(t.nbytes for tree in trees for t in tree_leaves(tree))


def _dry_real(cfg) -> dict:
    """The dry run's three steps for real on the card, from seed-0
    weights: {cell: (launches, argument bytes, temp bytes, [ms of each
    timed call])}. Each runs once untimed first (its warm-up), then as
    ``_dry_measured`` says."""
    params = api.init_params(cfg, SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}

    def toks(b, L):
        return torch.randint(0, cfg.vocab_size, (b, L), generator=gen,
                             device="cuda", dtype=torch.int32)

    train, prefill, decode = DRY_CELLS
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=2)
    opt = adamw_init(params, ocfg)
    ef = torch.zeros((), device="cuda")
    batch = {"tokens": toks(train.global_batch, train.seq_len),
             "labels": toks(train.global_batch, train.seq_len)}
    step = loop.make_train_step(cfg, ocfg, _dry_train_cfg(cfg), donate=True)
    step(params, opt, ef, batch)
    got = _dry_measured(train.name, lambda: step(params, opt, ef, batch))
    out[train.name] = (got[0], _nbytes(params, opt, ef, batch), *got[1:])
    tokens = toks(prefill.global_batch, prefill.seq_len)
    with torch.no_grad():
        api.prefill(params, cfg, tokens)
        got = _dry_measured(prefill.name,
                            lambda: api.prefill(params, cfg, tokens))
    out[prefill.name] = (got[0], _nbytes(params, tokens), *got[1:])
    cache = api.init_cache(cfg, decode.global_batch, decode.seq_len,
                           device="cuda")
    tokens = toks(decode.global_batch, 1)
    with torch.no_grad():
        api.decode_step(params, cfg, cache, tokens)
        got = _dry_measured(decode.name, lambda: api.decode_step(
            params, cfg, cache, tokens))
    out[decode.name] = (got[0], _nbytes(params, cache, tokens), *got[1:])
    return out


def _dry_contracts(cfg, card: str) -> dict:
    """The trace contracts on one eager decode dispatch (and a prefill
    tick) of the continuous engine on the card: no collective, no host
    op, the pool written in place. Returns the launches."""
    from repro_torch.analysis import trace
    params = api.init_params(cfg, SEED, device="cuda")
    eng = engine.ContinuousServingEngine(cfg, params, serving=DRY_CONTRACT,
                                         device="cuda", _graphs=False)
    before = dict(_build.LAUNCHES)
    findings = []
    for name, (tr, donated) in eng.contract_traces().items():
        found = (trace.check_no_collectives(tr, name)
                 + trace.check_no_host_ops(tr, name)
                 + trace.check_donation(tr, donated, name))
        findings += found
        log(f"  contracts {name}: {len(tr.ops)} ops, {len(donated)} donated "
            f"leaves, {len(found)} findings  [{card}]")
    if findings:
        raise RuntimeError("trace contracts broken on the card:\n"
                           + "\n".join(f.render() for f in findings))
    return _all_delta(before)


def phase_dryrun(card: str) -> dict:
    """Phase 29: slayformer-124m's dry run (a one-rank fake world, meta
    tensors, in a child process, beside the engine's trace contracts on
    the card) against the same three steps on the card, run once the
    child is done: launches and argument bytes equal, peak memory and the
    roofline printed beside the measured (the median of DRY_TIMED calls,
    and a profiler window's idle share). Returns the phase's launches."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("slayformer-124m")
    log(f"dry run: {cfg.name} at {cfg.num_layers} layers, one train step "
        f"of {TRAIN_BATCH} x {TRAIN_LEN} tokens, one prefill of "
        f"{len(PROMPT_LENS)} x {max(PROMPT_LENS)}, one decode step, on "
        f"meta against the card")
    before = dict(_build.LAUNCHES)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "dryrun.json")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-child", path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        contract_launches = _dry_contracts(cfg, card)
        child_log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    try:
        if child.returncode:
            raise RuntimeError(f"the dry run failed (exit "
                               f"{child.returncode}):\n{child_log[-4000:]}")
        with open(path) as f:
            recs = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    real = _dry_real(cfg)
    for rec in recs:
        got, argument, temp, ms = real[rec["shape"]]
        want = {k: v["launches"] for k, v in rec["kernels"].items()}
        bpd, roof = rec["bytes_per_device"], rec["roofline"]
        log(f"  {rec['shape']}: launches dry {want} card {got}; argument "
            f"dry {bpd['argument']} card {argument} B; routes "
            f"{rec['routes']}, trace {rec['trace_s']} s  [{card}]")
        if want != got:
            raise RuntimeError(f"{rec['shape']}: the dry run's launches "
                               f"{want} are not the card's {got}")
        if bpd["argument"] != argument:
            raise RuntimeError(f"{rec['shape']}: argument bytes "
                               f"{bpd['argument']} on meta, {argument} on "
                               f"the card")
        peak = argument + temp
        gap = bpd["peak"] / peak - 1
        log(f"  {rec['shape']}: peak dry {bpd['peak']} B (temp "
            f"{bpd['temp']}) card {peak} B (max_memory_allocated over the "
            f"step, temp {temp}), ratio {bpd['peak'] / peak:.4f}"
            + (" (gap past 10%, PERF.md)" if abs(gap) > DRY_PEAK_GAP
               else "") + f"  [{card}]")
        log(f"  {rec['shape']}: roofline t_compute {roof['t_compute_s']:.6g}"
            f" s, t_memory {roof['t_memory_s']:.6g} s, dominant "
            f"{roof['dominant']}, roofline_fraction "
            f"{roof['roofline_fraction']:.4g}; measured step median "
            f"{statistics.median(ms):.3f} ms of {len(ms)} calls (CUDA "
            f"events; min {min(ms):.3f}, max {max(ms):.3f}; each "
            f"{[round(x, 3) for x in ms]}) (bound "
            f"{max(roof['t_compute_s'], roof['t_memory_s']) * 1e3:.3f} ms)"
            f"  [{card}]")
    _free_card()
    launches = _all_delta(before)
    log(f"dry run: launches {launches} (the contract traces' "
        f"{contract_launches}; each card step {DRY_TIMED + 3} times: a "
        f"warm-up, the counted call, {DRY_TIMED} timed calls and one under "
        f"the profiler); the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card_line = phase_env()
    global _HOST_DRAWS
    _HOST_DRAWS = _HostDraws(
        [(n, DENSE_SERVE_LAYERS.get(n, DENSE_LAYERS)) for n in DENSE_ARCHS]
        + [(n, MIXED_LAYERS[n]) for n in MIXED_ARCHS]
        + [(n, SSM_LAYERS[n]) for n in SSM_ARCHS]
        + [(VISION, VISION_LAYERS), (AUDIO, None)])
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
    launches, fused_outs, lock_ms, slay_step_ms = phase_serve(card_line)
    train, train_losses, fused_step_s = phase_train(card_line)
    phase_serve_two(card_line, fused_outs)
    two = phase_train_two(card_line, train_losses[0], fused_step_s)
    cont, b4b, slay_pool = phase_serve_continuous(card_line, lock_ms)
    phase_serve_durable(card_line)
    phase_serve_exact(card_line, slay_step_ms)
    phase_serve_exact_continuous(card_line, slay_pool)
    phase_serve_exact_durable(card_line)
    phase_train_exact(card_line, fused_step_s)
    spec_b4b = phase_serve_spec(card_line)
    bl = phase_serve_baselines(card_line, dict(slay_pool,
                                               step_ms=slay_step_ms),
                               fused_step_s)
    drv = phase_drivers(card_line)
    dense_k = phase_dense_kernels()
    dense = phase_dense(card_line)
    mixed = phase_mixed(card_line)
    ssm = phase_ssm(card_line)
    front, audio_fmap = phase_frontends(card_line)
    core = phase_core(card_line, slay_step_ms)
    sharded = phase_sharded(card_line, train_losses, fused_step_s)
    c15 = phase_c15(card_line)
    dry = phase_dryrun(card_line)
    k2_bl = k2.pop("baselines")
    kernels = [
        dict(name="slay_fused_fwd", route="cuda",
             source="src/repro_torch/csrc/slay_fused.cu",
             replaces="src/repro/kernels/slay_fused.py:89",
             launches=launches["slay_fused_fwd"], **k1, library_ms=None),
        dict(name="slay_decode_step", route="cuda",
             source="src/repro_torch/csrc/decode_step.cu",
             replaces="src/repro/kernels/decode_step.py:49",
             launches=launches["slay_decode_step"] + bl["slay_decode_step"],
             **k2, library_ms=None,
             baseline_widths={k: v for k, v in k2_bl.items()
                              if not k.endswith("masked")}),
        dict(name="slay_decode_step_masked", route="cuda",
             source="src/repro_torch/csrc/decode_step.cu",
             replaces="src/repro/kernels/decode_step.py:57",
             launches=(cont["slay_decode_step_masked"] + spec_b4b
                       + bl["slay_decode_step_masked"]
                       + drv["slay_decode_step_masked"]), **b4b,
             library_ms=None,
             baseline_widths={k: v for k, v in k2_bl.items()
                              if k.endswith("masked")}),
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
    # The dense decoders' launches (phase 22) join each row's count; beside
    # them, per config, its group G and the kernel at head dim 128 (phase
    # 21).
    # Phase 23's launches join them too; its configs' K2 rows at their
    # groups (phase 21) sit under ``mixed_and_moe``; phase 24's under
    # ``ssm_families`` (hymba's kernels at head dim 64 and G = 5).
    for row in kernels[:5]:
        name = row["name"]
        for phase in (dense, mixed, ssm):
            row["launches"] += sum(d.get(name, 0) for d in phase.values())
        row["ssm_families"] = {
            arch: dict(dense_k.get(name, {}).get(arch, {}),
                       launches=ssm[arch].get(name, 0))
            for arch in SSM_ARCHS}
        row["dense_decoders"] = {
            arch: dict(dense_k[name][arch], launches=dense[arch].get(name, 0))
            for arch in DENSE_ARCHS}
        row["mixed_and_moe"] = {
            arch: dict(dense_k.get(name, {}).get(arch, {}),
                       launches=mixed[arch].get(name, 0))
            for arch in MIXED_ARCHS}
    # Phase 25's launches join every row's count, per config under
    # ``frontends`` (whisper's B7 and B8 rows with their numbers at its
    # shapes).
    for row in kernels:
        name = row["name"]
        row["launches"] += sum(d.get(name, 0) for d in front.values())
        row["frontends"] = {arch: dict(audio_fmap.get(name, {})
                                       if arch == AUDIO else {},
                                       launches=d.get(name, 0))
                            for arch, d in front.items()}
    # Phase 26's launches join every row's count, per part under ``core``.
    for row in kernels:
        name = row["name"]
        row["launches"] += sum(c.get(name, 0) for c in core.values())
        row["core"] = {part: c.get(name, 0) for part, c in core.items()}
    # Phase 27's sharded runs join rows B1-B4b, under ``sharded`` too.
    for row in kernels[:5]:
        row["launches"] += sharded[row["name"]]
        row["sharded"] = sharded[row["name"]]
    # Phase 28's C-15 routes join every row's count, under ``c15`` too.
    for row in kernels:
        row["launches"] += c15.get(row["name"], 0)
        row["c15"] = c15.get(row["name"], 0)
    # Phase 29's steps on the card join rows B1-B4b, under ``dryrun`` too.
    for row in kernels:
        row["launches"] += dry.get(row["name"], 0)
        row["dryrun"] = dry.get(row["name"], 0)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-child"]:
        sys.exit(_dryrun_child(sys.argv[2]))
    sys.exit(main())
