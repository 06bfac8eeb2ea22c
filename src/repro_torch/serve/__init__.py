from .engine import (Engine, EngineHealth, GenerationResult,
                     changed_tensor_paths)

__all__ = ["Engine", "EngineHealth", "GenerationResult",
           "changed_tensor_paths"]
