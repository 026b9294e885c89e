"""DP-FedAvg: per-node update clipping and calibrated Gaussian noise.

The counterpart of ``p2pfl_tpu/privacy/dp.py``. A node privatizes its
outgoing update against ``ref``, the params it started the round from:
it sends ``ref + clip(update - ref) + N(0, (C * sigma_mult)^2)``, where
the clip rescales the whole delta so that its L2 norm over every leaf
is at most ``C = clip_norm``. ``privatize_stacked`` applies this to the
rows of a ``[n, ...]`` stack that a host mask selects, one row at a
time, so each row is the per-node function's result.

Arithmetic, as in the JAX package: every leaf's delta in f32; the
squared norm is the sum of the per-leaf f32 sums taken in the JAX
package's flatten order (dict keys sorted), so a leaf's position
``i`` below means the same leaf in both packages. XLA contracts
``ref + scale * d`` into one fused multiply-add under jit; PyTorch's
``addcmul`` may or may not fuse it, so the results differ by up to
half an f32 ulp of the product plus one ulp of the sum.

Noise comes from one ``torch.Generator`` per (seed, node, round,
leaf), on the parameter's device, seeded by :func:`dp_seed`: the same
inputs give the same bits on the same device, not the JAX package's
bits (``jax.random`` threefry), and a CPU and a CUDA generator give
different numbers for one seed. With ``noise_multiplier == 0`` no
noise is drawn (the JAX package adds ``0 * noise``, an exact zero).

The (epsilon, delta) spend of ``T`` full-participation Gaussian
compositions at multiplier sigma has the closed form
``eps = c + 2 sqrt(c ln(1/delta))`` with ``c = T / (2 sigma^2)``
(:func:`epsilon_at`, :class:`PrivacyAccountant`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import (
    Params,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# stream tag mixed into every DP seed, so no DP draw shares its seed
# with the noise attack's (adversary.attacks.attack_seed)
_DP_STREAM = 0x4450


@dataclasses.dataclass(frozen=True)
class DPSpec:
    """How a node privatizes its outgoing update: L2 bound
    ``clip_norm``, Gaussian std ``clip_norm * noise_multiplier``, and
    ``seed``, the root of the noise streams."""

    clip_norm: float = 1.0
    noise_multiplier: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not self.clip_norm > 0.0:
            raise ValueError(
                f"dp clip_norm must be > 0, got {self.clip_norm}")
        if self.noise_multiplier < 0.0:
            raise ValueError(
                f"dp noise_multiplier must be >= 0, "
                f"got {self.noise_multiplier}")


def dp_seed(seed: int, node_idx: int, round_num: int, leaf: int) -> int:
    """The generator seed of one leaf's noise: a pure function of its
    four arguments."""
    words = np.random.SeedSequence(
        [int(seed), int(node_idx), int(round_num), int(leaf)],
        spawn_key=(_DP_STREAM,),
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) | (int(words[1]) >> 1)


def clip_factor(norm, clip_norm: float):
    """The clip scale ``min(1, C / max(norm, 1e-12))`` in f32: a numpy
    f32 for a numpy (or Python) norm, a tensor on the norm's device for
    a tensor norm (built without a host-to-device copy, which would
    wait for the device)."""
    if isinstance(norm, torch.Tensor):
        n = torch.clamp(norm.float(), min=float(np.float32(1e-12)))
        c = torch.full_like(n, float(np.float32(clip_norm)))
        return torch.clamp(torch.div(c, n), max=1.0)
    n = np.maximum(np.asarray(norm, np.float32), np.float32(1e-12))
    return np.minimum(np.float32(1.0), np.float32(clip_norm) / n)


def noise_sigma(clip_norm: float, noise_multiplier: float) -> np.float32:
    """The noise std ``clip_norm * noise_multiplier``, in f32."""
    return np.float32(np.float32(clip_norm) * np.float32(noise_multiplier))


def _jax_order(tree: Params) -> list[int]:
    """Positions in ``tree_leaves(tree)`` of the JAX package's flatten
    order (dict keys sorted at every level)."""
    paths: list[tuple] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            paths.append(path)

    walk(tree, ())
    return sorted(range(len(paths)), key=paths.__getitem__)


def _sq_norm(deltas: Params) -> torch.Tensor:
    """Sum of the per-leaf f32 sums of squares, in the JAX package's
    flatten order."""
    leaves = tree_leaves(deltas)
    sq = None
    for i in _jax_order(deltas):
        d = leaves[i].reshape(-1)
        s = torch.dot(d, d)
        sq = s if sq is None else sq + s
    return sq


def _deltas(update: Params, ref: Params) -> Params:
    return tree_map(lambda p, r: p.float() - r.float(), update, ref)


def update_norm(update: Params, ref: Params) -> torch.Tensor:
    """L2 norm of ``update - ref`` over every leaf, in f32: the sum of
    the per-leaf f32 sums in the JAX package's flatten order."""
    return torch.sqrt(_sq_norm(_deltas(update, ref)))


def privatize_update(update: Params, ref: Params, clip_norm: float,
                     noise_multiplier: float,
                     key: tuple[int, int, int]) -> Params:
    """Privatize ONE node's update (see the module doc); every leaf
    keeps its shape and dtype. ``key`` is ``(seed, node, round)``; leaf
    ``i`` of the JAX package's flatten order draws from
    ``dp_seed(*key, i)``."""
    deltas = _deltas(update, ref)
    scale = clip_factor(torch.sqrt(_sq_norm(deltas)), clip_norm)
    sigma = float(noise_sigma(clip_norm, noise_multiplier))
    ps = tree_leaves(update)
    rs = tree_leaves(tree_map(lambda p, r: r, update, ref))
    ds = tree_leaves(deltas)
    gen = None
    out = [None] * len(ps)
    for pos, i in enumerate(_jax_order(update)):
        p = ps[i]
        v = torch.addcmul(rs[i].float(), scale, ds[i])
        if sigma != 0.0:
            if gen is None:
                gen = torch.Generator(device=p.device)
            gen.manual_seed(dp_seed(*key, pos))
            v.add_(torch.randn(p.shape, generator=gen, device=p.device,
                               dtype=torch.float32), alpha=sigma)
        out[i] = v.to(p.dtype)
    return tree_unflatten(update, out)


def privatize_stacked(stacked: Params, ref_stacked: Params,
                      mask: np.ndarray, round_num: int,
                      spec: DPSpec) -> Params:
    """:func:`privatize_update` on the rows of a ``[n, ...]``-stacked
    tree that the host mask ``mask`` selects, one row at a time, keyed
    by ``(spec.seed, row, round_num)``; the other rows are
    returned unchanged, in a new tree."""
    out = tree_map(torch.clone, stacked)
    for i in np.flatnonzero(np.asarray(mask, bool)):
        i = int(i)
        row = tree_map(lambda x: x[i], stacked)
        ref = tree_map(lambda x: x[i], ref_stacked)
        priv = privatize_update(row, ref, spec.clip_norm,
                                spec.noise_multiplier,
                                (spec.seed, i, round_num))
        tree_map(lambda o, v: o[i].copy_(v), out, priv)
    return out


def epsilon_at(noise_multiplier: float, steps: int,
               delta: float) -> float:
    """(epsilon, delta)-DP spend of ``steps`` Gaussian compositions at
    std multiplier sigma: ``c + 2 sqrt(c ln(1/delta))``, ``c = steps /
    (2 sigma^2)``."""
    if steps <= 0:
        return 0.0
    if noise_multiplier <= 0.0:
        return math.inf
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    c = steps / (2.0 * noise_multiplier * noise_multiplier)
    return c + 2.0 * math.sqrt(c * math.log(1.0 / delta))


@dataclasses.dataclass
class PrivacyAccountant:
    """Running (epsilon, delta) ledger of one federation: a pure
    function of the step count (rounds completed)."""

    noise_multiplier: float
    delta: float = 1e-5
    steps: int = 0

    def step(self, n: int = 1) -> None:
        self.steps += int(n)

    @property
    def epsilon(self) -> float:
        return epsilon_at(self.noise_multiplier, self.steps, self.delta)

    def spent_fraction(self, epsilon_budget: float) -> float:
        """Share of an epsilon budget spent; an infinite or zero budget
        reports none."""
        if not epsilon_budget or not math.isfinite(epsilon_budget):
            return 0.0
        return self.epsilon / float(epsilon_budget)
