from .engine import (CheckpointFollower, Engine, EngineHealth,
                     FollowerHealth, GenerationResult, PassivePullStats,
                     SparseUpdate, changed_tensor_paths)

__all__ = ["CheckpointFollower", "Engine", "EngineHealth", "FollowerHealth",
           "GenerationResult", "PassivePullStats", "SparseUpdate",
           "changed_tensor_paths"]
