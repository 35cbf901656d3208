"""Config registry of the port: slayformer-124m, the dense decoders
phi4-mini-3.8b, granite-20b and qwen3-32b, gemma2-27b (local/global
layers), the top-2 MoE decoders phi3.5-moe-42b-a6.6b and grok-1-314b,
the SSM families mamba2-780m (attention-free) and hymba-1.5b
(attention beside mamba heads), internvl2-76b (a vision patch prefix
ahead of a decoder) and whisper-small (encoder-decoder), all 11 of the
JAX package's configs, with every attention kind of the port
(``core.slay.ATTN_KINDS``) as an override (not on mamba2, which has no
attention).

    cfg = configs.get_config("slayformer-124m")          # full width
    cfg = configs.get_smoke_config("slayformer-124m")    # CPU smoke size
    cfg = configs.get_config("slayformer-124m", attn_kind="favor")

The reference's shape cells (``SHAPE_CELLS``, ``get_cell``) and
``input_specs``, the model inputs of a cell as ``meta`` tensors.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (SHAPE_CELLS, ArchConfig, ShapeCell,
                                      get_cell, input_specs)

# In the reference's order, so that ALL_ARCHS and ASSIGNED_ARCHS equal its.
_MODULES = {
    "phi4-mini-3.8b": "phi4_mini",
    "qwen3-32b": "qwen3_32b",
    "granite-20b": "granite_20b",
    "gemma2-27b": "gemma2_27b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-small": "whisper_small",
    "internvl2-76b": "internvl2_76b",
    "mamba2-780m": "mamba2_780m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "grok-1-314b": "grok1_314b",
    "slayformer-124m": "slayformer_124m",
}
# The ported configs (the command-line drivers' --arch choices), and the
# ten of them beside the paper's own model.
ALL_ARCHS = tuple(_MODULES)
ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "slayformer-124m")


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = [
    "ArchConfig", "ShapeCell", "SHAPE_CELLS", "ASSIGNED_ARCHS", "ALL_ARCHS",
    "get_cell", "get_config", "get_smoke_config", "input_specs",
]
