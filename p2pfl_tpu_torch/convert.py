"""Carry parameters and optimizer state between the JAX package and the
port.

``params_from_jax`` takes a flax parameter dict whose leaves the caller
has already turned into numpy arrays (``jax.tree.map(np.asarray, ...)``
on the JAX side, so this module never imports JAX) and returns the
port's stacked tensors. The layouts are the same on both sides (HWIO
conv kernels, ``[in, out]`` dense kernels, the flax names, top-level
leaves such as the one-class SVM's ``w`` and ``rho``), so the
conversion only adds or keeps the node axis. bfloat16 arrays (numpy's
``ml_dtypes`` bfloat16) come across bit for bit. ``params_to_numpy``
goes back, widening bfloat16 to float32 (exactly), since numpy has no
bfloat16 of its own.

``adam_state_from_optax`` does the same for an optax
``ScaleByAdamState`` given as numpy ``(count, mu, nu)``, so that both
packages can start from one optimizer state. ``federated_state_from_jax``
carries a whole JAX ``FederatedState`` (flax's ``to_state_dict`` of it,
leaves as numpy) into the port's, the checkpoint's layout: the port's
shuffle generator is seeded from the JAX keys, and the port then writes
the JAX package's checkpoint bytes for it.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import Params, tree_map
from p2pfl_tpu_torch.learning.learner import AdamState


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, n_nodes: int | None = None,
                    device: torch.device | str = "cpu") -> Params:
    """numpy flax tree -> stacked tensor tree on ``device``.

    With ``n_nodes=None`` every leaf keeps its shape: a stacked tree (a
    leading node axis, as the JAX federation holds it) stays stacked,
    one node's tree stays one node's. With ``n_nodes=k`` the tree is
    one node's and is repeated ``k`` times along a new node axis.
    """
    def leaf(a):
        t = _tensor(a)
        if n_nodes is not None:
            t = t.unsqueeze(0).repeat((n_nodes,) + (1,) * t.dim())
        return t.to(device)

    return tree_map(leaf, _as_dicts(tree))


def adam_state_from_optax(state, n_nodes: int | None = None,
                          device: torch.device | str = "cpu") -> AdamState:
    """An optax ``ScaleByAdamState`` (anything with ``count``, ``mu`` and
    ``nu``, leaves as numpy) -> :class:`AdamState` on ``device``. The
    count is one node's scalar or a stacked ``[n]``; ``n_nodes`` repeats
    one node's state as :func:`params_from_jax` does."""
    count = torch.from_numpy(np.array(state.count, np.int32, copy=True))
    if n_nodes is not None:
        count = count.reshape(1).repeat(n_nodes)
    return AdamState(count=count.reshape(-1).to(device),
                     mu=params_from_jax(state.mu, n_nodes, device),
                     nu=params_from_jax(state.nu, n_nodes, device))


def _as_dicts(tree):
    if isinstance(tree, Mapping):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


def params_to_numpy(params: Params) -> dict:
    """Stacked (or single) tensor tree -> the same tree of numpy arrays
    (bfloat16 leaves as float32)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, params)


def federated_state_from_jax(state_dict: dict, template,
                             optimizer: str | None = None):
    """flax's ``to_state_dict`` of a JAX ``FederatedState`` (numpy
    leaves) -> the port's ``FederatedState`` in the structure, dtypes and
    devices of ``template`` (``federation.checkpoint.from_state_dict``;
    ``optimizer`` as there)."""
    from p2pfl_tpu_torch.federation.checkpoint import from_state_dict

    return from_state_dict(template, state_dict, optimizer)
