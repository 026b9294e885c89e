"""Adversarial transforms on outgoing model updates.

The counterpart of ``p2pfl_tpu/adversary/attacks.py``. A model-level
attack is one transform ``poison_update(params, ref, node_idx,
round_num, spec)`` of a node's trained parameters against ``ref``, the
parameters it started the round from:

- ``signflip``: ``ref - scale * (params - ref)``;
- ``scale``: ``ref + scale * (params - ref)``;
- ``noise``: ``params + scale * std(params - ref) * N(0, 1)`` per leaf;
- ``freerider``: ``ref`` unchanged;
- ``none`` and ``labelflip``: identity (``labelflip`` poisons the data,
  :func:`flip_labels`).

The arithmetic is the JAX package's, in f32, rounded once to each
leaf's dtype. ``noise`` draws from a ``torch.Generator`` seeded from
``(spec.seed, node, round, leaf position)`` by numpy's ``SeedSequence``,
so the same node, round and seed give the same bits on the same device
(not the JAX package's bits, which come from ``jax.random``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import (
    Params,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

#: model-level update transforms + the learner-level data attack
ATTACKS = ("none", "signflip", "scale", "noise", "freerider", "labelflip")

#: attacks that transform the outgoing update (vs poisoning the data)
MODEL_ATTACKS = ("signflip", "scale", "noise", "freerider")


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """What a malicious node does to its outgoing update: attack
    ``kind`` (one of :data:`ATTACKS`) at strength ``scale``; ``seed``
    roots the noise attack's draws."""

    kind: str = "none"
    scale: float = 10.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ATTACKS:
            raise ValueError(
                f"unknown attack kind {self.kind!r}; have {ATTACKS}")

    @property
    def poisons_updates(self) -> bool:
        return self.kind in MODEL_ATTACKS


def attack_seed(seed: int, node_idx: int, round_num: int, leaf: int) -> int:
    """The noise attack's generator seed for one leaf of one node's
    update in one round: a pure function of its four arguments."""
    words = np.random.SeedSequence(
        [int(seed), int(node_idx), int(round_num), int(leaf)]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) | (int(words[1]) >> 1)


def _along_delta(params: Params, ref: Params, factor: float) -> Params:
    """``ref + factor * (params - ref)`` in f32, rounded to each leaf's
    dtype (``r + (-s) d`` is ``r - s d`` bit for bit)."""
    def leaf(p, r):
        r32 = r.float()
        return (r32 + factor * (p.float() - r32)).to(p.dtype)

    return tree_map(leaf, params, ref)


def poison_update(params: Params, ref: Params, node_idx: int,
                  round_num: int, spec: AttackSpec) -> Params:
    """Transform ONE node's outgoing update (see the module doc); every
    leaf keeps its shape and dtype."""
    kind = spec.kind
    if kind in ("none", "labelflip"):
        return params
    if kind == "freerider":
        return tree_map(lambda p, r: r.to(p.dtype), params, ref)
    s = float(np.float32(spec.scale))
    if kind == "signflip":
        return _along_delta(params, ref, -s)
    if kind == "scale":
        return _along_delta(params, ref, s)
    if kind == "noise":
        out = []
        for i, (p, r) in enumerate(zip(tree_leaves(params),
                                       tree_leaves(ref))):
            d = p.float() - r.float()
            std = torch.sqrt((d * d).mean() + 1e-12)
            gen = torch.Generator(device=p.device).manual_seed(
                attack_seed(spec.seed, node_idx, round_num, i))
            noise = torch.randn(p.shape, generator=gen, device=p.device,
                                dtype=torch.float32)
            out.append((p.float() + s * std * noise).to(p.dtype))
        return tree_unflatten(params, out)
    raise ValueError(f"unknown attack kind {kind!r}")


def poison_stacked(stacked: Params, ref_stacked: Params,
                   malicious: np.ndarray, round_num: int,
                   spec: AttackSpec) -> Params:
    """:func:`poison_update` on the rows of a ``[n, ...]``-stacked tree
    that the host mask ``malicious`` selects, one row at a time (each
    row's arithmetic is the per-node function's); the other rows are
    returned unchanged, in a new tree."""
    if spec.kind in ("none", "labelflip"):
        return stacked
    out = tree_map(torch.clone, stacked)
    for i in np.flatnonzero(np.asarray(malicious, bool)):
        i = int(i)
        row = tree_map(lambda x: x[i], stacked)
        ref = tree_map(lambda x: x[i], ref_stacked)
        poisoned = poison_update(row, ref, i, round_num, spec)
        tree_map(lambda o, v: o[i].copy_(v), out, poisoned)
    return out


def flip_labels(y: np.ndarray, num_classes: int) -> np.ndarray:
    """Label-flip data poisoning: ``y -> (C - 1) - y``, applied to a
    malicious node's train shard."""
    return (num_classes - 1 - np.asarray(y)).astype(np.asarray(y).dtype)


def malicious_indices(n_nodes: int, fraction: float, seed: int = 0,
                      nodes: tuple[int, ...] | list[int] = ()) -> np.ndarray:
    """The malicious cohort as an ``[n]`` bool mask: explicit ``nodes``
    win; otherwise ``floor(fraction * n)`` nodes from a seeded
    permutation."""
    mask = np.zeros(n_nodes, bool)
    if nodes:
        mask[list(int(i) for i in nodes)] = True
        return mask
    k = int(fraction * n_nodes)
    if k <= 0:
        return mask
    order = np.random.default_rng(seed).permutation(n_nodes)
    mask[order[:k]] = True
    return mask
