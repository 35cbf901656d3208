"""Sharded gradients and decode where heads fall back to replicated, on
4 gloo ranks (CPU), against the unsharded port.

One spawn of ``tests/torch_dist_ranks.py``'s ``fallback`` check on a
(data 2, model 2) mesh, for the smoke configs of
``torch_dist_ranks.fallback_configs`` (fp32): granite's one kv head
(kv heads replicated while q heads shard, under slay and softmax), three
q and kv heads (both replicated), and hymba with three SSD heads (the
out-projection of ``ssm._gated_out`` on whole rows), beside slayformer
under softmax with no fallback as a control. For each: the loss
and every gradient of ``api.loss_fn`` with remat, two steps of
``train.loop.sharded_train_step`` (microbatches 2, remat) against
``make_train_step``, and, but for softmax, a prefill then three decode
steps with the cache in ``cache_sharding``'s placements, every state
leaf's batch split kept.

Tolerances: gradients within 1e-5 of each leaf's largest magnitude, and
parameters after two AdamW steps within 1e-5 of the tree's largest; under
softmax 3e-5 for both. The smoke model's softmax is saturated at its init
(loss about 23.8 against ln 256 = 5.5), which magnifies fp32's other
summation orders: the control, with no fallback, differs by about 1e-5
of a leaf's largest too. A misplaced partial sum or replica errs by the
size of the gradient itself. Decode logits and the
cache within 1e-5.
"""
import pytest
import torch

import torch_dist_ranks as ranks

torch.set_num_threads(1)    # small ops; the suite runs one process per core

NAMES = ("granite_kv1", "granite_kv1_softmax", "heads3", "hymba_ssd3",
         "control_softmax")
FALLBACKS = {"granite_kv1": ["kv_heads:1:model"],
             "granite_kv1_softmax": ["kv_heads:1:model"],
             "heads3": ["heads:3:model", "kv_heads:3:model"],
             "hymba_ssd3": ["mlp:403:model"], "control_softmax": []}


def _tol(name: str) -> float:
    return 3e-5 if name.endswith("softmax") else 1e-5


@pytest.fixture(scope="module")
def fallback(tmp_path_factory):
    return ranks.spawn("fallback", 4, tmp_path_factory.mktemp("fallback"),
                       timeout=300)


def test_the_configs_fall_back_as_named():
    assert tuple(ranks.fallback_configs()) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_the_unsharded_port(fallback, name):
    rec = fallback[name]
    assert rec["fallbacks"] == FALLBACKS[name]
    sharded, whole = rec["loss"]
    assert abs(sharded - whole) <= 1e-5 * abs(whole), rec["loss"]
    assert len(rec["grad_rel"]) >= 10
    worst = max(rec["grad_rel"].values())
    assert worst < _tol(name), rec["grad_rel"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_step_matches_the_unsharded_port(fallback, name):
    rec = fallback[name]
    for sharded, whole in rec["step_losses"]:
        assert abs(sharded - whole) <= 1e-5 * abs(whole), rec["step_losses"]
    assert rec["step_param_rel"] < _tol(name), rec["step_param_rel"]


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if not n.endswith("softmax")])
def test_decode_matches_the_unsharded_port(fallback, name):
    rec = fallback[name]
    assert len(rec["decode_rel"]) == 4          # the prefill and 3 steps
    assert max(rec["decode_rel"]) < 1e-5, rec["decode_rel"]
    assert rec["cache_rel"] < 1e-5
    # Every state leaf keeps its batch split over data: none comes back a
    # partial sum (hymba's conv tail did, through DTensor's in_proj).
    assert all(p.startswith("(Shard(dim=1)")
               for p in rec["state_placements"].values()), rec
    if name == "granite_kv1":
        # The (S, z) state is replicated over model while q heads shard.
        assert set(rec["state_placements"].values()) == {
            "(Shard(dim=1), Replicate())"}
