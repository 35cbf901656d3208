"""The shared-memory audit of the CUDA kernels (``repro_torch.analysis.
smem``): clean on the tree, and each of SMEM001-003 tripped by its
fixture. The probes' bytes come from the kernels' Python layout copies,
which ``tests/test_torch_routes.py`` pins by hand and
``tests/test_torch_card.py`` holds to the C entries on the card."""
import dataclasses
import json
import shutil

import torch

from repro_torch.analysis import smem
from repro_torch.kernels import _build

torch.set_num_threads(1)    # small ops; the suite runs one process per core


def _rules(findings):
    return sorted((f.rule, f.symbol) for f in findings)


def test_audit_is_clean_on_the_tree():
    findings = smem.check()
    assert not findings, "\n".join(f.render() for f in findings)
    probes = smem.probe_all()
    assert {p.kernel for p in probes.values()} == {
        "K1", "K3", "K4", "K2", "B5", "B6a", "B6b", "B7", "B8"}
    # Every config with SLAY layers and every extra shape sends something.
    sources = {s for p in probes.values() for s in p.sources}
    assert set(smem.EXTRA) <= sources
    assert {"slayformer-124m", "granite-20b", "hymba-1.5b"} <= sources
    # The route keeps d = 128, P = D = 32 off B8 (362,752 B).
    assert "B8[d=128,P=32,D=32,R=3,fp32]" not in probes
    assert "B7[d=128,P=32,D=32,R=3,fp32]" in probes


def test_a_probe_past_the_limit_trips_smem001():
    probes = smem.probe_all()
    name = "K1[d=64,dv=64,P=8,D=16,bf16]"
    wide = dict(probes, **{name: dataclasses.replace(
        probes[name], nbytes=_build.SMEM_LIMIT + 16)})
    baseline = {k: p.nbytes for k, p in wide.items()}
    assert _rules(smem.check(wide, baseline)) == [("SMEM001", name)]
    assert "slayformer-124m" in smem.check(wide, baseline)[0].message


def test_a_baseline_off_by_one_byte_trips_smem002():
    probes = smem.probe_all()
    baseline = {k: p.nbytes for k, p in probes.items()}
    name = "B8[d=64,P=8,D=16,R=3,bf16]"
    baseline[name] += 1
    assert _rules(smem.check(probes, baseline)) == [("SMEM002", name)]


def test_missing_and_stale_entries_trip_smem003():
    probes = smem.probe_all()
    baseline = {k: p.nbytes for k, p in probes.items()}
    gone = "K2[g=48,m=384,dv=128]"
    del baseline[gone]
    assert _rules(smem.check(probes, baseline)) == [("SMEM003", gone)]
    baseline[gone] = probes[gone].nbytes
    baseline["K1[d=96,dv=96,P=8,D=16,bf16]"] = 1
    assert _rules(smem.check(probes, baseline)) == [
        ("SMEM003", "K1[d=96,dv=96,P=8,D=16,bf16]")]


def test_update_baseline_writes_what_it_reads_back(tmp_path, capsys):
    path = tmp_path / "smem_baseline.json"
    shutil.copy(smem.DEFAULT_BASELINE, path)
    raw = json.loads(path.read_text())
    raw["probes"]["K1[d=64,dv=64,P=8,D=16,bf16]"] += 1
    path.write_text(json.dumps(raw))
    assert smem.main(["--baseline", str(path)]) == 1
    assert "SMEM002" in capsys.readouterr().out
    assert smem.main(["--update-baseline", "--baseline", str(path)]) == 0
    assert smem.load_baseline(str(path)) == {
        k: p.nbytes for k, p in smem.probe_all().items()}
    assert json.loads(path.read_text())["limit_bytes"] == _build.SMEM_LIMIT
    assert path.read_text() == open(smem.DEFAULT_BASELINE).read()
    assert smem.main(["--baseline", str(path)]) == 0
