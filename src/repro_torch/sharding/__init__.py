from .ctx import (NamedSharding, activation_ctx, constrain, current_mesh,
                  full_tree, local_call, placements, shard_tree, spec_tree)
from .rules import (PartitionSpec, Recipe, batch_specs, cache_specs,
                    opt_specs, param_specs_tree, recipe_for)

__all__ = ["NamedSharding", "activation_ctx", "constrain", "current_mesh",
           "full_tree", "local_call", "placements", "shard_tree",
           "spec_tree", "PartitionSpec", "Recipe",
           "batch_specs", "cache_specs", "opt_specs", "param_specs_tree",
           "recipe_for"]
