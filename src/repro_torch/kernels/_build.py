"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into ``lib<name>.so`` with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

The output goes to ``build/repro_torch/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads at once. Nothing is built at import time: the
first launch builds, or :func:`build_all` builds every kernel at once with
one ``nvcc`` process per source, all started together.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"    # the toolkit's default prefix
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_D = ctypes.POINTER(ctypes.c_double)
# C signature of every exported function: (restype, argtypes).
SIGNATURES = {
    "slay_fused": {
        "slay_fused_smem_bytes": (ctypes.c_longlong, [_I] * 4),
        "slay_fused_fwd": (_I, [_P] * 9 + [_I] * 8 + [_D, _D, _F, _I, _P]),
        "slay_fused_fwd_occupancy": (_I, [_I] * 5 + [ctypes.POINTER(_I)]),
    },
    "slay_fused_bwd": {
        "slay_fused_bwd_smem_bytes": (ctypes.c_longlong, [_I] * 4),
        "slay_fused_bwd_q": (_I, [_P] * 11 + [_I] * 8 + [_D, _D, _F, _I, _P]),
        "slay_fused_bwd_kv": (_I, [_P] * 12 + [_I] * 8 + [_D, _D, _F, _I, _P]),
        "slay_fused_bwd_occupancy": (_I, [_I] * 6 + [ctypes.POINTER(_I)]),
    },
    "decode_step": {
        "slay_decode_step": (_I, [_P] * 7 + [_I] * 6 + [_F, _P]),
        "slay_decode_step_occupancy": (_I, [_I] * 5 + [ctypes.POINTER(_I)]),
    },
    "feature_map": {
        "slay_feature_map_smem_bytes": (ctypes.c_longlong, [_I] * 6),
        "slay_feature_map_bwd_blocks": (_I, [_I] * 6),
        "slay_feature_map_bwd_occupancy": (_I, [_I] * 5 + [ctypes.POINTER(_I)]),
        "slay_feature_map_fwd_occupancy": (_I, [_I] * 5 + [ctypes.POINTER(_I)]),
        "slay_feature_map_fwd": (_I, [_P] * 4 + [_I] * 5 + [_D, _D, _I, _P]),
        "slay_feature_map_bwd": (_I, [_P] * 7 + [_I] * 6 + [_D, _D, _I, _P]),
    },
    "slay_scan": {
        "slay_scan_smem_bytes": (ctypes.c_longlong, [_I] * 3),
        "slay_scan_slices": (_I, [_I]),
        "slay_scan_fwd": (_I, [_P] * 7 + [_I] * 5 + [_F, _I, _P]),
        "slay_scan_bwd_q": (_I, [_P] * 7 + [_I] * 5 + [_F, _I, _P]),
        "slay_scan_bwd_kv": (_I, [_P] * 8 + [_I] * 5 + [_F, _I, _P]),
        "slay_scan_occupancy": (_I, [_I] * 4 + [ctypes.POINTER(_I)]),
    },
}

SMEM_LIMIT = 232448   # dynamic shared memory one Hopper block may use

# dtype codes of the C interface: 0 float32, 1 bfloat16.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: dict[str, int] = {
    "slay_fused_fwd": 0, "slay_fused_bwd_q": 0, "slay_fused_bwd_kv": 0,
    "slay_decode_step": 0, "slay_decode_step_masked": 0,
    "feature_map_fwd": 0, "feature_map_bwd": 0,
    "slay_scan_fwd": 0, "slay_scan_bwd_q": 0, "slay_scan_bwd_kv": 0}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises if there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on "
        "PATH; the repro_torch CUDA kernels are built from csrc/ at first use")


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    (out.parent / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)    # atomic: a concurrent build never sees a half file
    return log


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all at once. Returns each new build's compiler log."""
    started = {n: s for n in names if (s := _start(n)) is not None}
    logs = {}
    try:
        for name, (out, tmp, proc) in started.items():
            logs[name] = _finish(name, out, tmp, proc)
    finally:
        for _, tmp, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, fn: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


def residency(name: str, fn: str, *args, grid: tuple,
              clustered: bool = False) -> dict:
    """How a kernel sits on the current card, from its library's
    occupancy entry ``fn`` (its shape arguments, then six ints out): its
    grid, tokens per tile, blocks per SM and resident at once (CUDA's
    occupancy calculator), registers and local-memory bytes per thread,
    shared memory per block. A ``clustered`` entry writes a seventh int,
    the blocks per thread-block cluster (``cluster``), which is also the
    grid's last extent after those of ``grid``. Launches nothing."""
    out = (ctypes.c_int * (7 if clustered else 6))()
    check(getattr(load(name), fn)(*args, out), fn)
    res = {"grid": grid, "tile": out[5], "blocks_per_sm": out[0],
           "blocks_resident": out[1], "registers": out[2],
           "local_bytes": out[3], "smem_bytes": out[4]}
    if clustered:
        res.update(grid=(*grid, out[6]), cluster=out[6])
    return res
