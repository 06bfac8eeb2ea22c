"""Elastic reshard-restore: load a checkpoint onto a DIFFERENT mesh (torch
port of ``repro/ckpt/reshard.py``).

Checkpoints store logical (unsharded) tensors chunk-addressed, so restoring
onto any mesh is a placement decision, not a data transformation: every
rank reads the same image and keeps only its own block of each leaf
(``sharding.ctx.from_full``), so the values are bit-equal to
``mgr.restore``'s full tensors whatever mesh saved them.

This is the node-failure story: lose devices -> rebuild a smaller mesh ->
reshard-restore -> continue.
"""
from __future__ import annotations

from typing import Optional

from ..sharding.ctx import shard_tree
from .manager import CheckpointManager


def reshard_restore(mgr: CheckpointManager, mesh, param_spec_tree,
                    opt_spec_tree=None, step: Optional[int] = None):
    """Restore + place: returns (params, opt_state, step) with leaves laid
    out on ``mesh`` (a ``DeviceMesh``) at the given PartitionSpec trees
    (the optimizer state stays whole on the mesh's device without
    ``opt_spec_tree``), or None when the image has no checkpoint."""
    out = mgr.restore(step, device=mesh.device_type)
    if out is None:
        return None
    params, opt_state, saved_step = out
    if param_spec_tree is not None:
        params = shard_tree(params, mesh, param_spec_tree)
    if opt_spec_tree is not None:
        opt_state = shard_tree(opt_state, mesh, opt_spec_tree)
    return params, opt_state, saved_step
