"""Architecture registry of the port: ``--arch <id>`` resolves here (the
dense yi-6b, the ssm mamba2-130m and the hybrid hymba-1.5b so far; the moe
and mla archs of ``repro.configs`` come later)."""
from __future__ import annotations

from typing import List

from ..models.config import ModelConfig
from . import hymba_1_5b, mamba2_130m, yi_6b

_MODULES = {m.ARCH_ID: m for m in (yi_6b, mamba2_130m, hymba_1_5b)}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return _MODULES[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return _MODULES[arch_id].smoke_config()
