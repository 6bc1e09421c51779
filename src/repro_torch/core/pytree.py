"""Nested containers of arrays ("pytrees") without JAX.

A pytree here is a ``dict``, ``list`` or ``tuple`` (named tuples included)
nesting torch tensors, numpy arrays or other leaves, the parameter trees the
port's quantization and pruning take.  ``None`` is an empty subtree, as in
JAX: :func:`tree_map` never calls its function on it and keeps it.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of ``tree`` (and the leaves at the same
    place in each of ``rest``, which share its structure); the containers
    are rebuilt with the same types and keys."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):                      # named tuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Every leaf of ``tree``, dict values in sorted key order (JAX's)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in the order of
    :func:`tree_leaves` (``like``'s own leaves are only counted); the
    inverse of ``tree_leaves``.  A leaf may itself be a container."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return type(t)((k, done[k]) for k in t)
        if isinstance(t, (list, tuple)):
            items = [build(v) for v in t]
            return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def is_float_matrix(leaf) -> bool:
    """A ``>= 2``-D floating-point tensor or array: the weight matrices that
    quantization and pruning act on (biases and scalars are left alone)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dim() >= 2 and leaf.is_floating_point()
    return (hasattr(leaf, "ndim") and leaf.ndim >= 2
            and np.issubdtype(leaf.dtype, np.floating))
