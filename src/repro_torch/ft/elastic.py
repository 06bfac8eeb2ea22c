"""Elastic scaling helpers: choose a new mesh after losing devices (torch
port of ``repro/ft/elastic.py``).

Policy: keep the model axis intact (TP degree is a property of the
weights' sharding math), shrink the data axis to the largest value that
fits the surviving device count, and drop the remainder (hot spares).
Checkpoints are mesh-agnostic (logical tensors, chunk-addressed), so a
restore onto the new mesh reads the same image.
"""
from __future__ import annotations

from typing import Tuple


def shrink_mesh_shape(alive_devices: int, model: int = 16,
                      pods: int = 1) -> Tuple[int, ...]:
    """-> (data, model) (or (pod, data, model)) for the surviving devices."""
    per_pod = alive_devices // pods
    data = max(1, per_pod // model)
    if pods > 1:
        return (pods, data, model)
    return (data, model)
