"""The port's command-line drivers (``repro_torch.examples.train_slayformer``
and ``repro_torch.examples.serve``), run in-process through ``main(argv)``
on the CPU with ``--device cpu``.

Training at the CPU preset's smoke size: the loss falls within 8 steps,
and a second run on the same checkpoint directory resumes from step 8.
Serving: the serve script's streams equal those of the engine called
directly with the same config, weights, requests and sampling; its
decode-state bytes equal those of the JAX package's ``abstract_cache``
for the same config. Refusals: a sharded slot pool, and a run without ``--device cpu``
on a machine without a card (no silent fallback to the CPU).
"""
import argparse
import logging

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro_torch.configs.base import ServingConfig
from repro_torch.examples import serve, train_slayformer
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving.prefix_cache import PrefixCache

torch.set_num_threads(1)    # small ops; the suite runs one process per core


@pytest.mark.parametrize("kind", ["slay", "favor", "cosformer", "elu1",
                                  "softmax"])
def test_train_loss_falls_and_a_rerun_resumes(kind, tmp_path, caplog):
    argv = ["--device", "cpu", "--smoke", "--steps", "8", "--seq", "32",
            "--batch", "4", "--attn-kind", kind, "--ckpt-dir",
            str(tmp_path)]
    hist = train_slayformer.main(argv)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    caplog.set_level(logging.INFO, logger="repro_torch.train")
    assert train_slayformer.main(argv) == []      # nothing left to run
    assert "resumed from step 8" in caplog.text
    args = train_slayformer.parse_args(["--preset", "paper",
                                        "--attn-kind", kind])
    cfg = train_slayformer.build_config(args)
    assert (cfg.num_layers, cfg.d_model, cfg.attn_kind) == (12, 768, kind)


# argv of the serve driver -> the ServingConfig fields it implies.
SERVE_CASES = {
    "favor": (["--attn-kind", "favor"], {}),
    "cosformer_prefix": (["--attn-kind", "cosformer", "--prefix-cache", "4",
                          "--page-size", "8"], {"page_size": 8}),
    "elu1_lockstep": (["--attn-kind", "elu1", "--lockstep"], None),
    "softmax_paged": (["--attn-kind", "softmax", "--page-size", "8"],
                      {"page_size": 8}),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_streams_equal_the_engine_called_directly(case, capsys):
    extra, fields = SERVE_CASES[case]
    argv = ["--device", "cpu", "--max-new", "10"] + extra
    got = serve.main(argv)
    printed = capsys.readouterr().out
    args = serve.parse_args(argv)
    cfg = serve.build_config(args)
    params = api.init_params(cfg, 0, device="cpu")
    reqs = serve.requests(cfg, args)
    if fields is None:
        want = tengine.ServingEngine(cfg, params, device="cpu",
                                     max_len=256).generate(
            reqs, temperature=0.8, seed=0)
    else:
        pc = PrefixCache(4 << 20) if args.prefix_cache else None
        eng = tengine.ContinuousServingEngine(
            cfg, params, device="cpu", prefix_cache=pc,
            serving=ServingConfig(num_slots=2, max_len=256, prefill_chunk=8,
                                  temperature=0.8, **fields))
        outs, _ = eng.run(reqs)
        want = [outs[rid] for rid in sorted(outs)]
        assert "finish reasons: {'length': 4}" in printed
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jcfg = jax_smoke_config("slayformer-124m", attn_kind=cfg.attn_kind)
    nbytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                 for x in jax.tree.leaves(japi.abstract_cache(jcfg, 4, 256)))
    assert f"decode-state bytes @256 ctx:  {nbytes:,}" in printed


def test_serve_refuses_a_sharded_pool_and_bad_combinations():
    # A sharded pool needs a mesh of that many ranks (torchrun): in one
    # process it is pool_slot_axes's mismatch error, as the reference's.
    with pytest.raises(ValueError, match="slot_shards=2 but mesh"):
        serve.main(["--device", "cpu", "--slot-shards", "2"])
    for bad in (["--speculative", "--prefix-cache", "4"],
                ["--speculative", "--lockstep"],
                ["--attn-kind", "mamba"]):
        with pytest.raises(SystemExit):
            serve.parse_args(bad)


@pytest.mark.parametrize("driver", ["train", "serve"])
def test_without_device_cpu_and_no_card_the_drivers_raise(driver, tmp_path,
                                                           monkeypatch):
    # The default device is the card; without one the drivers raise
    # rather than run on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if driver == "train":
            train_slayformer.main(["--smoke", "--steps", "1", "--ckpt-dir",
                                   str(tmp_path)])
        else:
            serve.main([])
    assert isinstance(serve.parse_args([]), argparse.Namespace)
