"""Nested-structure helpers for observation / hidden-state trees.

Counterpart of ``handyrl_tpu/utils/tree.py`` without ``jax.tree``: a tree
is a dict, list or tuple of leaves (numpy arrays, torch tensors, scalars or
None).  Dict children are visited in sorted-key order, the order
``jax.tree_util`` uses, so a flattened observation lists its leaves in the
same order as the JAX package's (Geister: ``board`` before ``scalar``).
"""

from __future__ import annotations

import numpy as np


def tree_leaves(tree):
    """Leaves in flatten order (None is a leaf)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def tree_map(fn, tree, *rest):
    """Map ``fn`` leaf-wise over one or more trees of the same structure.

    Output dicts hold their keys in sorted order, as ``jax.tree.map``
    rebuilds them: the codec writes dicts in key order, so this keeps
    episode blocks byte-equal to the JAX package's."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, child, *(r[i] for r in rest)) for i, child in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_stack(trees, axis=0):
    """Stack structurally identical trees leaf-wise (numpy).

    [{'a': (3,)}, {'a': (3,)}] -> {'a': (2, 3)}
    """
    trees = list(trees)
    return tree_map(lambda *leaves: np.stack(leaves, axis=axis), *trees)


def tree_concat(trees, axis=0):
    trees = list(trees)
    return tree_map(lambda *leaves: np.concatenate(leaves, axis=axis), *trees)


def softmax(x):
    """Numerically stable softmax over the last axis (numpy, host-side)."""
    x = np.asarray(x, dtype=np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
