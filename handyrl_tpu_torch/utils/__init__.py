from .platform import resolve_device
from .tree import (softmax, to_numpy, tree_concat, tree_leaves, tree_map, tree_max_rel_err,
                   tree_stack, tree_to_numpy, tree_unflatten)

__all__ = ["resolve_device", "softmax", "to_numpy", "tree_concat", "tree_leaves", "tree_map",
           "tree_max_rel_err", "tree_stack", "tree_to_numpy", "tree_unflatten"]
