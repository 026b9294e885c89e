"""Carry parameters between the JAX package and the port.

``params_from_jax`` takes a flax parameter dict whose leaves the caller
has already turned into numpy arrays (``jax.tree.map(np.asarray, ...)``
on the JAX side, so this module never imports JAX) and returns the
port's stacked tensors. The layouts are the same on both sides (HWIO
conv kernels, ``[in, out]`` dense kernels, the flax names), so the
conversion only adds or keeps the node axis. ``params_to_numpy`` goes
back.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import Params, tree_map


def params_from_jax(tree, n_nodes: int | None = None,
                    device: torch.device | str = "cpu") -> Params:
    """numpy flax tree -> stacked tensor tree on ``device``.

    With ``n_nodes=None`` every leaf keeps its shape: a stacked tree (a
    leading node axis, as the JAX federation holds it) stays stacked,
    one node's tree stays one node's. With ``n_nodes=k`` the tree is
    one node's and is repeated ``k`` times along a new node axis.
    """
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if n_nodes is not None:
            t = t.unsqueeze(0).repeat((n_nodes,) + (1,) * t.dim())
        return t.to(device)

    return tree_map(leaf, _as_dicts(tree))


def _as_dicts(tree):
    if isinstance(tree, Mapping):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


def params_to_numpy(params: Params) -> dict:
    """Stacked (or single) tensor tree -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
