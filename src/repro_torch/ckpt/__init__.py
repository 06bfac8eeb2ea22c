from .manager import CheckpointManager, CheckpointPolicy
from .reshard import reshard_restore

__all__ = ["CheckpointManager", "CheckpointPolicy", "reshard_restore"]
