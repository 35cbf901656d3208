"""The port's sharded training on gloo ranks (CPU), against the JAX package
and the unsharded port.

Two spawns of 4 ranks each (``tests/torch_dist_ranks.py``, which imports
no JAX; each with its own 300 s limit), shared by the tests below:

* ``train``: on a (data 2, model 2) mesh the sharded step
  (``train.loop.sharded_train_step``) of the smoke slayformer, fp32,
  microbatches 2, remat, 3 steps, from the JAX init's weights (through
  ``repro_torch.convert``) on the JAX batches. Losses within 1e-5
  relative of ``repro.train.loop.make_train_step``'s, computed here;
  parameters after 3 steps within 1e-5 of the tree's largest magnitude of
  the port's unsharded step (fp32 in other summation orders, through
  AdamW, whose update divides by each gradient's root mean square); the
  same with int8 gradient compression. ``remat="save_collectives"``
  against ``remat=True``: the same loss, gradients within 1e-6 of each
  leaf's largest, and fewer all-reduces in the backward, counted over the
  ``_c10d_functional`` ops, no more than without remat. The elastic
  checkpoint: saved on (2, 2), restored onto (1, 4) and onto no mesh, bit
  for bit.
* ``forward``: one config per family sharded on (2, 2), logits within
  1e-5 of their largest magnitude of the unsharded port's, granite with
  ``kv_heads`` replicated while ``heads`` shard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train import loop as jloop

torch.set_num_threads(1)    # small ops; the suite runs one process per core


def _jax_losses(cfg, jp, toks, compress: bool) -> list[float]:
    ocfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = jax.jit(jloop.make_train_step(cfg, ocfg, jloop.TrainConfig(
        microbatches=2, remat=True, compress_grads=compress)))
    p, o = jp, jadamw.adamw_init(jp, ocfg)
    e = jcompress.init(jp) if compress else jnp.zeros(())
    out = []
    for s in range(toks.shape[0]):
        p, o, e, m = step(p, o, e, {"tokens": jnp.asarray(toks[s, :, :-1]),
                                    "labels": jnp.asarray(toks[s, :, 1:])})
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    cfg = jax_smoke_config("slayformer-124m", dtype="float32")
    jp = jtr.init_params(cfg, jax.random.PRNGKey(0))
    np.savez(d / "params.npz", **{
        "/".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]})
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (3, 8, 33)).astype(np.int32)
    np.savez(d / "batches.npz", tokens=toks[:, :, :-1],
             labels=toks[:, :, 1:])
    out = ranks.spawn("train", 4, d, timeout=300)
    out["jax"] = {c: _jax_losses(cfg, jp, toks, c) for c in (False, True)}
    return out


@pytest.fixture(scope="module")
def forward(tmp_path_factory):
    return ranks.spawn("forward", 4, tmp_path_factory.mktemp("forward"),
                       timeout=300)


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_train_step_matches_the_reference_and_the_unsharded_port(
        train, compress):
    tag = "compress" if compress else "plain"
    np.testing.assert_allclose(train[f"{tag}_losses"], train["jax"][compress],
                               rtol=1e-5)
    assert train[f"{tag}_losses"][-1] < train[f"{tag}_losses"][0]
    worst = max(train[f"{tag}_param_rel"].values())
    assert worst < 1e-5, train[f"{tag}_param_rel"]
    # The moments (and residuals) keep the parameters' placements.
    assert train[f"{tag}_placements_kept"]


def test_save_collectives_matches_remat_with_fewer_backward_all_reduces(
        train):
    losses = train["remat_losses"]
    assert losses["save_collectives"] == losses["True"] == losses["False"]
    assert train["save_vs_remat_grad_rel"] <= 1e-6
    c = train["backward_collectives"]
    remat = c["True"].get("all_reduce", 0)
    saved = c["save_collectives"].get("all_reduce", 0)
    assert remat > 0, c        # remat=True re-runs the forward all-reduces
    assert saved < remat and saved <= c["False"].get("all_reduce", 0), c


def test_elastic_checkpoint_restores_bit_for_bit(train):
    assert train["elastic_steps"] == [7, 7]
    assert train["elastic_mesh_b_exact"] and train["elastic_no_mesh_exact"]
    assert train["elastic_placements"]


@pytest.mark.parametrize("name", ranks.FAMILIES)
def test_sharded_forward_matches_the_unsharded_port(forward, name):
    assert forward[name]["rel"] < 1e-5, forward[name]
    want = ["kv_heads:1:model"] if name == "granite-20b" else []
    assert forward[name]["fallbacks"] == want
