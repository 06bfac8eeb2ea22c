"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` if one is present, else an error.
    The port never drops to the CPU on its own; pass ``device="cpu"`` to
    run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
