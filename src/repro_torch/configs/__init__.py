"""Config registry of the port: slayformer-124m so far.

    cfg = configs.get_config("slayformer-124m")          # full width
    cfg = configs.get_smoke_config("slayformer-124m")    # CPU smoke size
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "slayformer-124m": "slayformer_124m",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_MODULES)} (ROADMAP Queue A item 12)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ArchConfig:
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ArchConfig", "get_config", "get_smoke_config"]
