from repro_torch.utils.logging import MetricsLogger
from repro_torch.utils.tree import (FlatSpec, make_flat_spec, stacked_ravel,
                                    stacked_unravel, tree_flatten,
                                    tree_leaves, tree_map, tree_ravel,
                                    tree_ravel_into, tree_unflatten,
                                    tree_unravel)

__all__ = ["FlatSpec", "MetricsLogger", "make_flat_spec", "stacked_ravel",
           "stacked_unravel", "tree_flatten", "tree_leaves", "tree_map",
           "tree_ravel", "tree_ravel_into", "tree_unflatten", "tree_unravel"]
