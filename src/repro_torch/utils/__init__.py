from repro_torch.utils.logging import MetricsLogger
from repro_torch.utils.tree import (FlatSpec, global_norm, lanes_ravel,
                                    make_flat_spec, stacked_ravel,
                                    stacked_unravel, tree_add, tree_cast,
                                    tree_flatten, tree_leaves, tree_map,
                                    tree_ravel, tree_ravel_into, tree_scale,
                                    tree_size, tree_unflatten, tree_unravel)

__all__ = ["FlatSpec", "MetricsLogger", "global_norm", "lanes_ravel",
           "make_flat_spec", "stacked_ravel", "stacked_unravel", "tree_add",
           "tree_cast", "tree_flatten", "tree_leaves", "tree_map",
           "tree_ravel", "tree_ravel_into", "tree_scale", "tree_size",
           "tree_unflatten", "tree_unravel"]
