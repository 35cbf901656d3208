"""Long-context decode with SLAY, the counterpart of the JAX package's
``examples/long_context.py``: absorb a 32k-token prompt into the
linear-attention state and decode with O(1) memory, then contrast the
quadratic path's L² cost curve (paper Fig. 2 / §3.2). It runs on the card
unless given ``--device cpu``::

    python -m repro_torch.examples.long_context [--prompt-len 32768]
    PYTHONPATH=src python -m repro_torch.examples.long_context \\
        --device cpu --prompt-len 1024 --decode-steps 2

On the card Ψ(k) goes through the feature-map kernel B7 and each decode
step through B7 and the decode kernel K2; timings bracket the work with
``torch.cuda.synchronize``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import kernels
from repro_torch.core.slay import (SlayConfig, slay_decode_step, slay_init,
                                   slay_prefill_state)
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run the example; returns its inputs, states and readings (the
    prefill state ``state0``, each decode step's output ``ys``, the
    seconds and MB it printed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt-len", type=int, default=32768)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    d, H, L = args.head_dim, args.heads, args.prompt_len
    cfg = SlayConfig(head_dim=d)
    gen = torch.Generator().manual_seed(0)
    params = slay_init(cfg, gen, device=dev)
    k = torch.randn(1, L, H, d, generator=gen).to(dev, torch.bfloat16)
    v = torch.randn(1, L, H, d, generator=gen).to(dev, torch.bfloat16)

    print(f"prompt: {L} tokens x {H} heads x {d} dims")
    _sync(dev)
    t0 = time.perf_counter()
    state0 = slay_prefill_state(params, k, v, cfg)
    _sync(dev)
    t_pre = time.perf_counter() - t0
    state_bytes = sum(x.numel() * 4 for x in state0)
    kv_bytes = 2 * L * H * d * 2
    print(f"prefill (linear absorb): {t_pre:.2f}s")
    print(f"SLAY decode state: {state_bytes / 1e6:.2f} MB "
          f"(m={cfg.feature_dim} features/head)")
    print(f"equivalent KV cache:  {kv_bytes / 1e6:.2f} MB "
          f"({kv_bytes / state_bytes:.1f}x larger, grows with L)")

    q1 = torch.randn(1, H, d, generator=gen).to(dev, torch.bfloat16)
    y, state = slay_decode_step(params, q1, q1, q1, state0, cfg)   # warm-up
    ys = [y]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.decode_steps):
        y, state = slay_decode_step(params, q1, q1, q1, state, cfg)
        ys.append(y)
    _sync(dev)
    per_tok = (time.perf_counter() - t0) / max(args.decode_steps, 1) * 1e3
    print(f"decode: {per_tok:.2f} ms/token — independent of the {L}-token "
          "context (O(m*dv) per step)")

    # Quadratic comparison at small L (its scores grow as L²).
    print("\nquadratic spherical-Yat attention cost curve (for contrast):")
    quad_ms = {}
    for Lq in (256, 512, 1024):
        kk, vv = k[:, :Lq].float(), v[:, :Lq].float()
        qq = torch.randn(1, Lq, H, d, generator=gen).to(dev)
        kernels.yat_attention(qq, kk, vv, causal=True, spherical=True)
        _sync(dev)
        t0 = time.perf_counter()
        kernels.yat_attention(qq, kk, vv, causal=True, spherical=True)
        _sync(dev)
        quad_ms[Lq] = (time.perf_counter() - t0) * 1e3
        print(f"  L={Lq:5d}: {quad_ms[Lq]:8.1f} ms, "
              f"scores matrix {H * Lq * Lq * 4 / 1e6:.1f} MB")
    return dict(cfg=cfg, params=params, k=k, v=v, q=q1, state0=state0,
                ys=ys, state=state, prefill_s=t_pre,
                state_mb=state_bytes / 1e6, kv_mb=kv_bytes / 1e6,
                ms_per_token=per_tok, quadratic_ms=quad_ms)


if __name__ == "__main__":
    main()
