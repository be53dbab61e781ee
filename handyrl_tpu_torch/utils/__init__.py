from .platform import resolve_device
from .tree import softmax, tree_concat, tree_leaves, tree_map, tree_stack

__all__ = ["resolve_device", "softmax", "tree_concat", "tree_leaves", "tree_map", "tree_stack"]
