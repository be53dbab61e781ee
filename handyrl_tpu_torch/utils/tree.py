"""Nested-structure helpers for observation / hidden-state trees.

Counterpart of ``handyrl_tpu/utils/tree.py`` without ``jax.tree``: a tree
is a dict, list or tuple of leaves (numpy arrays, torch tensors, scalars or
None).  Dict children are visited in sorted-key order, the order
``jax.tree_util`` uses, so a flattened observation lists its leaves in the
same order as the JAX package's (Geister: ``board`` before ``scalar``).
"""

from __future__ import annotations

import numpy as np
import torch


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


def tree_unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def to_numpy(x):
    """A leaf on the host: a tensor's numpy copy, None as None, else an array."""
    if x is None:
        return None
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def tree_to_numpy(tree):
    return tree_map(to_numpy, tree)


def tree_max_rel_err(got, want) -> float:
    """The largest error of ``got``'s leaves against ``want``'s, each relative
    to max(1, that reference leaf's largest magnitude); NaN if any is (so a
    non-finite output never reads as a small error)."""
    errs = [0.0]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = np.asarray(to_numpy(g), np.float64), np.asarray(to_numpy(w), np.float64)
        if w.size:
            errs.append(np.abs(g - w).max() / max(1.0, float(np.abs(w).max())))
    return float(np.max(errs))


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
