"""Training driver: slayformer on synthetic LM data through the port's
``Trainer`` (microbatching, int8 gradient compression, checkpoints,
resume, the step-time watchdog), the counterpart of the JAX package's
``examples/train_slayformer.py``.

The CPU preset (default) trains a small model (4 layers x 128, vocab
512, fp32); ``--preset paper`` is the 124M GPT-2-small-scale slayformer
of Table 5; ``--attn-kind`` picks any attention kind of the port (SLAY,
the linear baselines favor, cosformer, elu1, and the exact softmax, yat,
yat_spherical; not on mamba2, which has no attention); ``--arch`` any
config of ``configs.ALL_ARCHS`` (the MoE decoders report their
load-balance loss as ``moe_aux``; mamba2-780m and hymba-1.5b train their
SSD blocks by plain autograd). The synthetic batches carry tokens and
labels only, as the JAX driver's (``data/pipeline.py``): internvl2-76b
trains as a plain decoder without its patch prefix, and whisper-small,
which needs frame embeddings, is refused. It runs on the card unless given
``--device cpu``::

    python -m repro_torch.examples.train_slayformer --preset paper \\
        --attn-kind favor --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_slayformer \\
        --device cpu --smoke --steps 8

Re-running with the same ``--ckpt-dir`` resumes from its latest
checkpoint: the trainer logs "resumed from step N", and the step losses
every 10 steps, at INFO, which a run from the command line prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import tempfile

from repro_torch import configs
from repro_torch.core.slay import ATTN_KINDS
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.tree import tree_leaves


def build_config(args):
    """The presets of the JAX package's script: ``paper`` the full
    config, ``cpu`` (or ``--smoke``) the smoke config, for
    slayformer-124m widened to 4 layers x 128 in fp32 under ``cpu``;
    ``full`` the arch's config."""
    if args.preset == "paper":
        cfg = configs.get_config("slayformer-124m")
    elif args.smoke or args.preset == "cpu":
        cfg = configs.get_smoke_config(args.arch)
        if args.preset == "cpu" and args.arch == "slayformer-124m":
            cfg = dataclasses.replace(cfg, num_layers=4, d_model=128,
                                      num_heads=4, num_kv_heads=4, d_ff=512,
                                      vocab_size=512, dtype="float32")
    else:
        cfg = configs.get_config(args.arch)
    if args.attn_kind:
        cfg = dataclasses.replace(cfg, attn_kind=args.attn_kind)
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="slayformer-124m",
                    choices=list(configs.ALL_ARCHS))
    ap.add_argument("--preset", default="cpu",
                    choices=["cpu", "paper", "full"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn-kind", default=None, choices=list(ATTN_KINDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_slayformer_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    family = configs.get_config(args.arch).family
    if args.attn_kind and family == "ssm":
        ap.error(f"--attn-kind: {args.arch} has no attention")
    if family == "encdec":
        ap.error(f"--arch {args.arch}: an encoder-decoder trains on frame "
                 f"embeddings (batch['frame_embeds']), and the synthetic "
                 f"LM batches carry tokens and labels only")
    return args


def main(argv=None) -> list[dict]:
    """Train; returns the per-step metric history of this run."""
    args = parse_args(argv)
    cfg = build_config(args)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    train_cfg = TrainConfig(microbatches=args.microbatches, remat=False,
                            compress_grads=args.compress_grads,
                            ckpt_dir=args.ckpt_dir, ckpt_every=50)
    trainer = Trainer(cfg, opt_cfg, train_cfg, device=args.device)
    n_params = sum(t.numel() for t in tree_leaves(trainer.params))
    print(f"arch={cfg.name} attn={cfg.attn_kind} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} params~{n_params / 1e6:.1f}M "
          f"device={trainer.params['embed'].device}")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    history = trainer.run(batch_iterator(dcfg, start_step=trainer.step),
                          num_steps=args.steps, log_every=10)
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"\nloss {first:.4f} -> {last:.4f} over {len(history)} steps "
              f"(resume from step {trainer.step} by re-running)")
    return history


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    main()
