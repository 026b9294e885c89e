"""Parameter-tree helpers over nested dicts of tensors.

The counterpart of ``p2pfl_tpu/core/pytree.py``. A model's parameters
keep the flax tree's shape — ``{"params": {"Conv_0": {"kernel": ...,
"bias": ...}, ...}}`` — with tensors as leaves. A federation's tree
carries a leading ``[n]`` node axis on every leaf ("stacked" form).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Params = Any  # a nested dict of torch.Tensor


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """Apply ``fn`` leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """Leaves in the tree's key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Params, leaves: list[torch.Tensor]) -> Params:
    """Inverse of :func:`tree_leaves` with the structure of ``like``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_param_count(tree: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_weighted_mean(stacked: Params, weights: torch.Tensor) -> Params:
    """Weighted mean over the leading node axis, accumulated in f32.

    A zero total weight falls back to the uniform mean over all rows,
    as the JAX package does.
    """
    total = weights.sum()
    n = weights.shape[0]
    weights = torch.where(total > 0, weights, torch.ones_like(weights))
    total = torch.where(total > 0, total, torch.full_like(total, n))
    w = (weights / total).float()

    def leaf_mean(x):
        wshape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return (x.float() * w.reshape(wshape)).sum(0).to(x.dtype)

    return tree_map(leaf_mean, stacked)
