"""Aggregation over stacked parameter trees.

The counterpart of ``p2pfl_tpu/core/aggregators.py``. Every aggregator
is a function ``aggregate(stacked, weights, mask) -> params`` over a
tree whose leaves carry a leading ``[n]`` node axis, with ``weights``
``[n]`` sample counts and ``mask`` ``[n]`` bool (which rows arrived):

- ``FedAvg``: the sample-count-weighted mean;
- ``FedMedian``: the coordinate-wise median (an even row count averages
  the two middle values, as ``jnp.median`` does);
- ``TrimmedMean(beta)``: drop the ``beta`` largest and smallest values
  of each coordinate and average the rest;
- ``Krum(f, m)``: score each row by its ``n_present - f - 2`` smallest
  squared distances to the others and average the ``m`` best rows.

Masked rows are filled with the masked mean (median, trimmed mean), or
can never be selected (Krum). The sums run in f32 on the device the
tree lies on; the Gram product of Krum is one plain ``[n, d] @ [d, n]``
matmul, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from p2pfl_tpu_torch.core.pytree import (
    Params,
    tree_leaves,
    tree_map,
    tree_weighted_mean,
)

__all__ = ["Aggregator", "FedAvg", "FedMedian", "TrimmedMean", "Krum",
           "get_aggregator"]


def _masked_weights(weights: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
    w = weights.float()
    if mask is not None:
        w = torch.where(mask, w, torch.zeros_like(w))
    return w


def _filled(x: torch.Tensor, fill: torch.Tensor,
            present: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` in f32, absent rows replaced by ``fill``."""
    keep = present.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x.float(), fill.float())


class Aggregator:
    """Base class: subclasses implement :meth:`aggregate`."""

    name = "base"

    def aggregate(self, stacked: Params, weights: torch.Tensor,
                  mask: torch.Tensor | None = None) -> Params:
        raise NotImplementedError

    def __call__(self, stacked, weights, mask=None):
        return self.aggregate(stacked, weights, mask)


class FedAvg(Aggregator):
    """Sample-count-weighted mean over the rows ``mask`` keeps."""

    name = "FedAvg"

    def aggregate(self, stacked, weights, mask=None):
        return tree_weighted_mean(stacked, _masked_weights(weights, mask))


class FedMedian(Aggregator):
    """Coordinate-wise median over all ``n`` rows, absent rows filled
    with the masked mean; with an even ``n`` the two middle values are
    averaged (``(lo + hi) * 0.5``, ``jnp.median``'s midpoint rule), and a
    coordinate with a NaN in any row is NaN."""

    name = "FedMedian"

    def aggregate(self, stacked, weights, mask=None):
        w = _masked_weights(weights, mask)
        fill = tree_weighted_mean(stacked, w)
        present = w > 0

        def leaf(x, f):
            xf = _filled(x, f, present)
            n = xf.shape[0]
            xs = torch.sort(xf, dim=0).values
            mid = (xs[(n - 1) // 2] + xs[n // 2]) * 0.5
            mid = torch.where(torch.isnan(xf).any(0),
                              torch.full_like(mid, float("nan")), mid)
            return mid.to(x.dtype)

        return tree_map(leaf, stacked, fill)


class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean: sort the ``n`` rows of each
    coordinate (absent rows filled with the masked mean), drop ``beta``
    from each end (``beta`` clipped to ``(n - 1) // 2``), average the
    rest."""

    name = "TrimmedMean"

    def __init__(self, beta: int = 1):
        if beta < 0:
            raise ValueError(f"trim count beta must be >= 0, got {beta}")
        self.beta = beta

    def aggregate(self, stacked, weights, mask=None):
        w = _masked_weights(weights, mask)
        fill = tree_weighted_mean(stacked, w)
        present = w > 0
        n = w.shape[0]
        beta = min(self.beta, max((n - 1) // 2, 0))

        def leaf(x, f):
            xs = torch.sort(_filled(x, f, present), dim=0).values
            return xs[beta:n - beta].mean(0).to(x.dtype)

        return tree_map(leaf, stacked, fill)


class Krum(Aggregator):
    """(Multi-)Krum over flattened f32 rows: ``d2 = sq_i + sq_j -
    2 Gram``, self and absent columns set to ``finfo(f32).max / 4``,
    each row's score the sum of its ``clip(n_present - f - 2, 1, n - 1)``
    smallest distances, absent rows scored ``inf``; the mean of the
    ``m`` lowest scores (ties to the lower index). Fewer than ``f + 3``
    rows raises; fewer than ``f + 3`` present rows warns once."""

    name = "Krum"

    def __init__(self, f: int = 1, m: int = 1):
        self.f = f
        self.m = m
        self._small_cohort_warned = False

    def aggregate(self, stacked, weights, mask=None):
        w = _masked_weights(weights, mask)
        present = w > 0
        n = w.shape[0]
        if n < self.f + 3:
            raise ValueError(
                f"Krum(f={self.f}) needs at least f+3={self.f + 3} rows "
                f"to score n_present-f-2 neighbors, got n={n}; lower f "
                "or use TrimmedMean/FedMedian for small cohorts")
        n_present = int(present.sum())
        if n_present < self.f + 3 and not self._small_cohort_warned:
            warnings.warn(
                f"Krum(f={self.f}) aggregating only {n_present} present "
                f"rows (< f+3={self.f + 3}): neighbor count clipped to 1 — "
                "selection is NOT Byzantine-robust this round",
                RuntimeWarning, stacklevel=2)
            self._small_cohort_warned = True  # once per instance

        flat = torch.cat([x.reshape(n, -1).float()
                          for x in tree_leaves(stacked)], dim=1)
        sq = (flat * flat).sum(1)
        gram = flat @ flat.T
        d2 = sq[:, None] + sq[None, :] - 2.0 * gram
        big = torch.finfo(torch.float32).max / 4
        eye = torch.eye(n, dtype=torch.bool, device=d2.device)
        d2 = d2.masked_fill(eye | ~present[None, :], big)
        k = min(max(n_present - self.f - 2, 1), n - 1)
        d2_sorted = torch.sort(d2, dim=1).values
        scores = d2_sorted[:, :k].sum(1)
        scores = torch.where(present, scores,
                             torch.full_like(scores, float("inf")))
        m = min(self.m, n)
        best = torch.sort(scores, stable=True).indices[:m]
        sel = torch.zeros(n, dtype=torch.float32, device=w.device)
        sel[best] = 1.0
        sel = torch.where(present, sel, torch.zeros_like(sel))
        return tree_weighted_mean(stacked, sel)


_REGISTRY: dict[str, Callable[..., Aggregator]] = {
    "fedavg": FedAvg,
    "fedmedian": FedMedian,
    "median": FedMedian,
    "trimmedmean": TrimmedMean,
    "krum": Krum,
}


def get_aggregator(name: str, **kwargs) -> Aggregator:
    """Factory by name (``fedavg``, ``fedmedian``/``median``,
    ``trimmedmean``, ``krum``)."""
    key = name.lower().replace("_", "").replace("-", "")
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown aggregator {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
