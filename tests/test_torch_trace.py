"""The trace contracts (``repro_torch.analysis.trace``), the counterpart of
the reference's HLO contracts (``repro.analysis.hlo``): each rule trips
on a fixture made to break it, and the continuous engine's contract
traces (``ContinuousServingEngine.contract_traces``) under ``slay`` and
``softmax`` on a 4-rank fake world show no finding. The fake worlds run
in one subprocess (a process group is process-global)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import trace

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

_WORLDS = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch.analysis import trace
from repro_torch.launch.dryrun import fake_world

torch.set_num_threads(1)
out = {}
with fake_world(2):
    tr = trace.record(lambda x: funcol.all_reduce(x, "sum", dist.group.WORLD),
                      torch.ones(8))
    out["all_reduce"] = [f.rule for f in trace.check_no_collectives(tr, "ar")]
out["engines"] = {}
real_check = trace.check_engine


def check(eng, label):
    found = real_check(eng, label)
    out["engines"][label] = {
        "findings": [f.render() for f in found],
        "programs": {n: [len(t.ops), list(d)] for n, (t, d)
                     in eng.contract_traces().items()}}
    return found


trace.check_engine = check
out["rc"] = trace.main()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "worlds.json"
    subprocess.run([sys.executable, "-c", _WORLDS, str(path)], check=True,
                   timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)},
                   stdout=subprocess.DEVNULL)
    return json.loads(path.read_text())


def test_an_all_reduce_trips_the_collectives_rule(worlds):
    assert worlds["all_reduce"] == ["HLO001"]


HOST = {
    "item": lambda x: x.sum().item(),
    "nonzero": lambda x: torch.nonzero(x > 0),
    "mask_index": lambda x: x[x > 0],
}


@pytest.mark.parametrize("name", sorted(HOST))
def test_a_host_read_trips_the_host_ops_rule(name):
    tr = trace.record(HOST[name], torch.arange(8.0) - 3)
    assert {f.rule for f in trace.check_no_host_ops(tr, name)} == {"HLO002"}


class _Holder:
    def __init__(self):
        self.pool = torch.zeros(64, 64)


def _out_of_place(h):
    h.pool = h.pool + 1.0


def _full_copy(h):
    h.pool.copy_(h.pool + 1.0)


def _in_place(h):
    h.pool[3].add_(1.0)


@pytest.mark.parametrize("fn", [_out_of_place, _full_copy])
def test_a_pool_written_out_of_place_trips_the_donation_rule(fn):
    h = _Holder()
    tr = trace.record(fn, h, leaves=lambda: {"pool": h.pool})
    found = trace.check_donation(tr, ["pool"], fn.__name__)
    assert [f.rule for f in found] == ["DON001"]


def test_an_in_place_program_shows_no_finding():
    h = _Holder()
    tr = trace.record(_in_place, h, leaves=lambda: {"pool": h.pool})
    assert (trace.check_no_collectives(tr, "ok")
            + trace.check_no_host_ops(tr, "ok")
            + trace.check_donation(tr, ["pool"], "ok")) == []
    assert tr.ops[-1].name.startswith("aten.add_.")


@pytest.mark.parametrize("kind", ["slay", "softmax"])
def test_the_engine_traces_show_no_finding(worlds, kind):
    """The decode macro (every pool tensor donated) and a prefill tick of
    the slot-sharded engine, built as the reference's --hlo pass builds
    it."""
    eng = worlds["engines"][kind]
    assert eng["findings"] == []
    progs = eng["programs"]
    assert set(progs) == {"macro_decode", "prefill_chunk"}
    n_ops, donated = progs["macro_decode"]
    assert n_ops > 0 and donated and all(
        d.startswith("pool/") for d in donated)
    assert progs["prefill_chunk"][1] == []
    assert worlds["rc"] == 0
