from .manager import CheckpointManager, CheckpointPolicy

__all__ = ["CheckpointManager", "CheckpointPolicy"]
