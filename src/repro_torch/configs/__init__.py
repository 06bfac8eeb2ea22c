"""Architecture registry of the port: ``--arch <id>`` resolves here (the
ten archs of ``repro/configs/registry.py``, in its order)."""
from __future__ import annotations

from typing import List

from ..models.config import ModelConfig
from . import (command_r_35b, gemma_2b, granite_moe_3b, hymba_1_5b,
               mamba2_130m, minicpm3_4b, mixtral_8x7b, musicgen_medium,
               pixtral_12b, yi_6b)
from .shapes import SHAPES, ShapeSpec, applicable_shapes, input_specs

_MODULES = {
    m.ARCH_ID: m
    for m in (pixtral_12b, mamba2_130m, granite_moe_3b, mixtral_8x7b,
              gemma_2b, command_r_35b, minicpm3_4b, yi_6b,
              musicgen_medium, hymba_1_5b)
}

ARCH_IDS: List[str] = list(_MODULES)

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "list_archs",
           "SHAPES", "ShapeSpec", "applicable_shapes", "input_specs"]


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return _MODULES[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return _MODULES[arch_id].smoke_config()
