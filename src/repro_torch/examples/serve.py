"""Serving driver: continuous batching (slot pool, staggered arrivals,
streaming) or the lockstep engine, the counterpart of the JAX package's
``examples/serve.py``. A linear kind (SLAY, favor, cosformer, elu1)
decodes from a constant-size (S, z) state, the exact kinds from a KV
ring. ``--arch`` takes every config of ``configs.ALL_ARCHS``: the
dense decoders, gemma2-27b (windowed KV rings of its local layers
beside the global layers' state in one slot pool) and the MoE decoders
phi3.5-moe-42b-a6.6b and grok-1-314b, the SSM families mamba2-780m
(attention-free: each slot carries its SSD scan state and conv tail) and
hymba-1.5b (that carry beside the attention state), internvl2-76b (each
request behind a zero vision patch prefix, absorbed in chunks) and
whisper-small (encoder-decoder over zero audio frames, each prompt
prefilled whole), the frontends' stand-ins as the JAX driver's. It runs
on the card unless given ``--device cpu``::

    python -m repro_torch.examples.serve --attn-kind favor
    python -m repro_torch.examples.serve --lockstep
    python -m repro_torch.examples.serve --arch gemma2-27b
    python -m repro_torch.examples.serve --arch mamba2-780m --no-smoke
    python -m repro_torch.examples.serve --arch whisper-small --lockstep
    PYTHONPATH=src python -m repro_torch.examples.serve --device cpu \\
        --attn-kind softmax --page-size 16 --prefix-cache 64
    torchrun --nproc-per-node 2 -m repro_torch.examples.serve \\
        --slot-shards 2

The smoke config is served by default, as by the JAX driver;
``--no-smoke`` serves the arch's full-width config. Paged slot memory
(``--page-size``, ignored for the constant-state kinds) and the prefix
cache (``--prefix-cache`` MB) keep the streams byte-identical;
``--speculative`` drafts with the SLAY twin of an exact verifier
(yat_spherical unless ``--attn-kind`` names another exact kind; not
for the SSM families, whose carry cannot be rewound; the engine refuses
it for internvl2 and whisper, as the reference's). mamba2 has no
attention, so ``--attn-kind`` is refused for it. ``--slot-shards N``
shards the slot pool over N ranks (``make_serving_mesh(N)``, one
process per device under ``torchrun``: NCCL on the card, gloo with
``--device cpu``); rank 0 prints. In one process it raises the
mesh-mismatch error of ``pool_slot_axes``, as the reference does.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ServingConfig
from repro_torch.core.slay import ATTN_KINDS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import api
from repro_torch.serving.engine import (AdmissionError,
                                        ContinuousServingEngine, Request,
                                        ServingEngine)
from repro_torch.serving.prefix_cache import PrefixCache, tree_bytes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="slayformer-124m",
                    choices=list(configs.ALL_ARCHS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the smoke config (default) or, "
                    "with --no-smoke, the full-width one")
    ap.add_argument("--attn-kind", default=None, choices=list(ATTN_KINDS))
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lockstep", action="store_true",
                    help="lockstep engine instead of continuous batching")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--slot-shards", type=int, default=0,
                    help="shard the slot pool N-way (not ported yet: N > 1 "
                         "raises)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue (0 = unbounded); with "
                         "the default reject_new policy, overflow raises a "
                         "typed AdmissionError this driver catches")
    ap.add_argument("--overload-policy", default="reject_new",
                    choices=("reject_new", "shed_oldest", "queue_wait"))
    ap.add_argument("--page-size", type=int, default=0,
                    help="page the pooled KV rings into pages of this many "
                         "rows; 0 = unpaged. Ignored for constant-state "
                         "kinds (nothing to page)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="MB",
                    help="prompt-prefix cache budget in MB; 0 = off")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-verify decode: the SLAY twin drafts, the "
                         "exact verifier scores gamma+1 tokens per "
                         "dispatch. Needs an exact attn kind; yat_spherical "
                         "if --attn-kind is not given")
    ap.add_argument("--spec-gamma", type=int, default=2,
                    help="draft tokens per speculative round")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.speculative and args.prefix_cache:
        ap.error("--speculative and --prefix-cache are mutually exclusive")
    if args.speculative and args.lockstep:
        ap.error("--speculative needs the continuous engine")
    family = configs.get_config(args.arch).family
    if args.attn_kind and family == "ssm":
        ap.error(f"--attn-kind: {args.arch} has no attention")
    if args.speculative and family in ("ssm", "hybrid"):
        ap.error(f"--speculative: {args.arch} (family={family!r}) cannot "
                 f"verify drafts; an SSM carry cannot be rewound")
    return args


def build_config(args):
    overrides = {"attn_kind": args.attn_kind} if args.attn_kind else {}
    if args.speculative and not args.attn_kind:
        # An exact verifier and a deliberately small SLAY draft trunk, so
        # that the draft steps stay cheap, as the JAX driver picks them.
        overrides = {"attn_kind": "yat_spherical",
                     "slay_anchors": 16, "slay_prf": 32}
    get = configs.get_smoke_config if args.smoke else configs.get_config
    return get(args.arch, **overrides)


def requests(cfg, args) -> list[Request]:
    """``--batch`` prompts of 4-11 tokens, one arrival every 2 ticks."""
    rng = np.random.default_rng(0)
    return [Request(rng.integers(3, cfg.vocab_size,
                                 size=rng.integers(4, 12)).astype(np.int32),
                    max_new_tokens=args.max_new, arrival_time=float(2 * i))
            for i in range(args.batch)]


def _serving_mesh(args):
    """Under ``torchrun`` with ``--slot-shards`` N > 1: the process group
    (NCCL on the card, gloo on the CPU) and the (N, 1) serving mesh;
    None in a plain process."""
    if args.slot_shards <= 1 or "WORLD_SIZE" not in os.environ:
        return None
    if args.device != "cpu":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        args.device = "cuda"
    if not dist.is_initialized():
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    return make_serving_mesh(args.slot_shards)


def main(argv=None) -> list[np.ndarray]:
    """Serve; returns the token stream of every admitted request."""
    args = parse_args(argv)
    mesh = _serving_mesh(args)
    quiet = mesh is not None and dist.get_rank() != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet \
            else contextlib.nullcontext():
        return _serve(args, mesh)


def _serve(args, mesh) -> list[np.ndarray]:
    cfg = build_config(args)
    params = api.init_params(cfg, 0, device=args.device)   # seed 0
    reqs = requests(cfg, args)
    print(f"serving {len(reqs)} requests on {cfg.name} "
          f"(attn={cfg.attn_kind}, {cfg.num_layers}L x {cfg.d_model}d, "
          f"device={params['embed'].device})...")
    t0 = time.perf_counter()
    if args.lockstep:
        engine = ServingEngine(cfg, params, device=args.device, max_len=256)
        outs = engine.generate(reqs, temperature=0.8)
    else:
        pc = (PrefixCache(args.prefix_cache * 1024 * 1024)
              if args.prefix_cache else None)
        engine = ContinuousServingEngine(
            cfg, params, prefix_cache=pc, device=args.device, mesh=mesh,
            serving=ServingConfig(num_slots=args.slots, max_len=256,
                                  prefill_chunk=8, temperature=0.8,
                                  slot_shards=args.slot_shards,
                                  max_queue=args.max_queue,
                                  overload_policy=args.overload_policy,
                                  page_size=args.page_size,
                                  speculative=args.speculative,
                                  spec_gamma=args.spec_gamma))
        # Typed admission: a refused request raises an AdmissionError
        # subclass carrying queue_depth / max_queue.
        admitted = []                      # (rid, request) pairs
        for r in reqs:
            try:
                admitted.append((engine.submit(r), r))
            except AdmissionError as e:
                print(f"  refused ({type(e).__name__}, queue "
                      f"{e.queue_depth}/{e.max_queue}): {e}")
        out_map, summary = engine.run()
        outs = [out_map[rid] for rid, _ in admitted]
        reqs = [r for _, r in admitted]
        print(f"  finish reasons: {summary['finish_reasons']}")
        print(f"  pool: {args.slots} slots x {summary['slot_shards']} "
              f"shard(s) | occupancy "
              f"{summary['mean_slot_occupancy']:.2f} | TTFT p50 "
              f"{summary['ttft_ticks_p50']} ticks | "
              f"{summary['decode_tokens_per_s']:.1f} decode tok/s")
        if summary["num_pages"]:
            print(f"  pages: {summary['pages_peak']}/"
                  f"{summary['num_pages']} peak in use "
                  f"({args.page_size} rows/page); leaked "
                  f"{summary['final_pages_in_use']}")
        if pc is not None:
            print(f"  prefix cache: {summary['prefix_hits']} hits, "
                  f"{summary['prefix_tokens_reused']} prompt tokens "
                  f"reused | {pc.stats()}")
        if summary["speculative"]:
            print(f"  speculative: gamma={summary['spec_gamma']} | "
                  f"acceptance {summary['draft_acceptance_rate']:.3f} "
                  f"({summary['draft_tokens_accepted']}/"
                  f"{summary['draft_tokens_proposed']} drafts) | "
                  f"{summary['tokens_per_dispatch']:.1f} tok/dispatch")
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"req {i}: prompt_len={len(reqs[i].prompt)} -> {o[:12]}...")
    print(f"\n{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s batched)")

    # The long-context pitch: a linear kind's decode state does not grow
    # with the context (meta tensors, nothing allocated).
    small = tree_bytes(api.abstract_cache(cfg, args.batch, 256))
    huge = tree_bytes(api.abstract_cache(cfg, args.batch, 524_288))
    print(f"decode-state bytes @256 ctx:  {small:,}")
    print(f"decode-state bytes @524288 ctx: {huge:,} "
          + ("(constant — the paper's O(1) long-context memory)"
             if huge == small else "(grows with the context: a KV ring)"))
    return outs


if __name__ == "__main__":
    main()
