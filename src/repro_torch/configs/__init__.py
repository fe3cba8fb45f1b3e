"""Config registry: ``get_config(arch_id)`` -> ArchConfig.

Holds the architectures the port runs so far; the other families join
with their model code.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCHS = ("llama3p2_1b", "mamba2_2p7b")

_BY_ID: dict[str, ArchConfig] = {}


def _load():
    if _BY_ID:
        return
    for mod_name in _ARCHS:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg: ArchConfig = mod.CONFIG
        _BY_ID[cfg.arch_id] = cfg


def get_config(arch_id: str) -> ArchConfig:
    _load()
    if arch_id not in _BY_ID:
        raise KeyError(f"{arch_id!r} is not ported yet; the port runs "
                       f"{sorted(_BY_ID)}")
    return _BY_ID[arch_id]
