"""The slot-sharded serving pool (DESIGN.md §8) on gloo ranks (CPU),
against the unsharded engine on the same traces.

One spawn of 4 ranks (``tests/torch_dist_ranks.py``'s ``serving``, 300 s
limit), shared by the tests below, with the port's smoke slayformer
(fp32, embedding divided by 8 so greedy streams vary) on a seeded trace
of the check's own:

* data = 4 with 4 slots: SLAY at T = 0 and 0.8 with K = 8 and 1,
  softmax at T = 0 with K = 8, and mamba2's SSD carries, whisper's
  encoder-decoder pool and softmax verifying SLAY drafts; streams
  identical, ``ticks`` and ``decode_dispatches`` equal, ``slot_shards``
  4 and 1;
* 2 slots a shard under a burst of arrivals: the first admissions spread
  over the shards, evicted slots are reused, streams identical;
* 6 slots over data = 4: the pool replicates and logs
  ``("slots", 6, "data")``;
* a paged softmax pool over 2 shards (pod 2 x data 2): streams identical,
  every page in its owner's block, ``PagePool.check()`` holds, no page
  leaked;
* (data 2, model 2): tensor-parallel parameters and (S, z) heads, the
  continuous and lockstep engines' streams identical, the dispatch's
  collectives all on the model group;
* collectives: none inside a dispatch (the functional collectives and
  ``torch.distributed``'s, counted), one ``all_gather`` after each;
* a prefix-cached run and a journaled run crashed and restored from a
  checkpoint of the sharded pool (8 slots over data = 4): the unsharded
  engine's streams.

And the serving driver under ``torchrun --standalone`` with
``--slot-shards 2`` (its own 300 s limit): the unsharded driver's
streams.
"""
import os
import subprocess
import sys

import pytest
import torch

import torch_dist_ranks as ranks

torch.set_num_threads(1)    # small ops; the suite runs one process per core


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    return ranks.spawn("serving", 4, tmp_path_factory.mktemp("serving"),
                       timeout=300)


@pytest.mark.parametrize("case", ["slay_T0.0_K8", "slay_T0.0_K1",
                                  "slay_T0.8_K8", "slay_T0.8_K1",
                                  "softmax_T0.0_K8", "mamba2", "whisper",
                                  "softmax_spec"])
def test_sharded_streams_equal_the_unsharded_engine(serving, case):
    r = serving[case]
    assert r["same"], r
    assert r["ticks"][0] == r["ticks"][1]
    assert r["dispatches"][0] == r["dispatches"][1]
    assert r["shards"] == [4, 1]
    assert r["gathers"] == r["dispatches"][0]


def test_admission_spreads_over_shards_and_reuses_evicted_slots(serving):
    r = serving["evict"]
    assert r["same"]
    assert sorted(r["first_shards"]) == [0, 1, 2, 3]
    assert len(r["slots"]) == 12 and len(set(r["slots"])) == 8


def test_indivisible_pool_replicates_and_logs_the_fallback(serving):
    r = serving["fallback"]
    assert r["same"] and r["shards"] == 1 and r["gathers"] == 0
    assert r["log"] == [["slots", 6, "data"]]


def test_paged_pool_keeps_pages_in_their_owners_block(serving):
    r = serving["paged"]
    assert r["same"] and r["shards"] == 2
    assert r["own_block"] and r["leaked"] == 0 and r["pages_peak"] > 0


def test_dispatch_runs_no_collective_and_one_gather_follows(serving):
    r = serving["collectives"]
    assert r["inside"] == {}
    assert r["all"] == {"all_gather": r["dispatches"]} and r["dispatches"]


def test_tensor_parallel_pool_streams_and_model_group_collectives(serving):
    # (data 2, model 2): parameters and each slot's (S, z) heads over
    # model, slots over data. A dispatch's only collectives are the model
    # group's: per tick an all-reduce of the vocab-sharded embedding's
    # rows, one after each layer's attention-out and MLP-down (the
    # reference's tensor-parallel reductions), one for the fault probe,
    # and the logits row gathered whole for sampling.
    r = serving["tp"]
    assert r["same"] and r["lockstep_same"] and r["shards"] == 2
    assert r["dispatches"][0] == r["dispatches"][1]
    assert r["model_group_only"]
    assert r["inside"] == {"all_reduce": r["ticks"] * (2 * r["layers"] + 2),
                           "all_gather_into_tensor": r["ticks"]}


def test_prefix_cache_and_crash_restore_on_the_sharded_pool(serving):
    # Each rank journals into its own directory and checkpoints the whole
    # pool (gathered); the restored engine takes its block back.
    r = serving["durable"]
    assert r["prefix_same"] and r["prefix_hits"] > 0
    assert r["crashed"] and r["checkpoint_used"] and r["restored_same"]


def test_serve_driver_under_torchrun_shards_the_pool(capsys):
    # torchrun --standalone picks a free port itself; 2 gloo ranks, rank 0
    # prints, the same streams as the driver in one process unsharded.
    from repro_torch.examples import serve
    env = dict(os.environ, PYTHONPATH=str(ranks.ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    args = ["--device", "cpu", "--slots", "4"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.examples.serve", *args,
         "--slot-shards", "2"], env=env, cwd=ranks.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    assert "4 slots x 2 shard(s)" in out.stdout, out.stdout
    serve.main(args)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("req ")]
    got = [ln for ln in out.stdout.splitlines() if ln.startswith("req ")]
    assert got == want and len(want) == 4, (got, want)
