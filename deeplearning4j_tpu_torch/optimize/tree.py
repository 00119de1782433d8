"""Parameter trees: nested tuples, lists and dicts of tensors.

The port's stand-in for JAX pytrees, for the params tuple (one dict per
layer) and for the updater's flat-buffer tuples. Leaves are visited in JAX's
order: containers in sequence, dict keys sorted.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import torch


def tree_leaves(tree) -> List:
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    which share its structure."""
    if isinstance(tree, (tuple, list)):
        mapped = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        # a NamedTuple (the updater state) takes its fields as arguments
        return type(tree)(*mapped) if hasattr(tree, "_fields") \
            else type(tree)(mapped)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _unflatten(like, it: Iterator):
    if isinstance(like, (tuple, list)):
        parts = [_unflatten(x, it) for x in like]
        return type(like)(*parts) if hasattr(like, "_fields") \
            else type(like)(parts)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    return next(it)


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` in `tree_leaves`
    order."""
    return _unflatten(like, iter(leaves))


def ravel_tree(tree) -> Tuple[torch.Tensor, Callable]:
    """(flat, unravel): every leaf of `tree` in `tree_leaves` order in one
    1-D tensor, promoted to the leaves' common dtype (JAX's
    `ravel_pytree`), and the function taking such a vector back to a tree
    of `tree`'s structure, each leaf a view of the vector in its own shape
    and dtype."""
    leaves = tree_leaves(tree)
    dtype = leaves[0].dtype
    for t in leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    sizes = [t.numel() for t in leaves]
    shapes = [tuple(t.shape) for t in leaves]
    dtypes = [t.dtype for t in leaves]
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in leaves])

    def unravel(v: torch.Tensor):
        parts = torch.split(v, sizes)
        return tree_unflatten(tree, [p.view(s).to(dt) for p, s, dt in
                                     zip(parts, shapes, dtypes)])

    return flat, unravel
