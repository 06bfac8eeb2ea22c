"""Mesh construction (torch port of ``make_mesh`` and ``mesh_context`` in
``repro/launch/mesh.py``): a ``torch.distributed`` ``DeviceMesh``.

The process group belongs to the caller (``torchrun``, the launcher or a
test): ``make_mesh`` lays the mesh over the ranks of the group that is
initialized. Where none is and the mesh has one device, it starts a
single-rank group itself: NCCL for ``cuda``, gloo for ``cpu``. A mesh larger
than the world raises, and so does one that does not fill it.

``make_production_mesh`` (256 and 512 chips) is not here: its only user is
the dry-run, which is not ported yet.
"""
from __future__ import annotations

import math
import os
import tempfile

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _single_rank_group(device_type: str) -> None:
    """A world of one rank, through a file store of its own (no port)."""
    fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
    os.close(fd)
    os.unlink(path)
    store = dist.FileStore(path, 1)
    dist.init_process_group(_BACKEND[device_type], store=store, rank=0,
                            world_size=1)


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    initialized group, on the card unless ``device="cpu"`` is asked for.
    On the card each rank uses ``cuda:<local rank>``, which the caller
    sets as the current device before calling."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    device = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {shape} mesh needs {n} ranks; start them with torchrun "
                "(or init_process_group) first")
        _single_rank_group(device.type)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {shape} has {n} devices; the world has "
                         f"{world} ranks")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def mesh_context(mesh):
    """``with mesh_context(mesh):``, the reference's ``jax.set_mesh``: the
    ``DeviceMesh`` is its own context manager (DTensor calls inside take it
    as their default mesh). The port's steps also take ``mesh=`` directly."""
    return mesh
