"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.core import features
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.serving import engine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
no_card = pytest.mark.skipif(
    "torch.cuda.is_available()",
    reason="checks what happens on a machine without a CUDA card")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30      # every module was imported


def _forbidden_imports(path: pathlib.Path) -> list[str]:
    """Every import of JAX or the JAX package in the file at ``path``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.relative_to(ROOT)}: {n}" for n in names
                  if _forbidden(n)]
    return found


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [bad for path in files for bad in _forbidden_imports(path)]
    assert not offenders, offenders


def test_card_tests_import_no_jax():
    # The card has no JAX: the tests that run there hold the kernels
    # against the port's own plain versions.
    path = ROOT / "tests" / "test_torch_card.py"
    assert "def test_scan_kernels_match_plain_on_card" in path.read_text()
    assert _forbidden_imports(path) == []


@no_card
def test_entry_points_without_device_raise_instead_of_using_the_cpu():
    cfg = configs.get_smoke_config("slayformer-124m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        features.init_feature_params(cfg.slay_config(), torch.Generator())
    params = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ContinuousServingEngine(cfg, params)


@no_card
def test_chip_smoke_fails_without_a_card(tmp_path):
    # Here: nonzero exit and no result line.
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, without the rest of the repository.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_nvcc_lookup(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc() == str(fake)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", "")
    if os.access(_build.DEFAULT_NVCC, os.X_OK):
        assert _build.nvcc() == _build.DEFAULT_NVCC
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()


def test_build_is_keyed_by_sources_and_ignored_by_git():
    path = _build.lib_path("slay_fused")
    assert path.parent.parent == ROOT / "build" / "repro_torch"
    assert path != _build.lib_path("decode_step")
    assert path != _build.lib_path("slay_fused_bwd")
    assert path != _build.lib_path("feature_map")
    assert path != _build.lib_path("slay_scan")
    assert set(_build.SIGNATURES) == {"slay_fused", "slay_fused_bwd",
                                      "decode_step", "feature_map",
                                      "slay_scan"}
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
