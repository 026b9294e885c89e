"""Aggregation over stacked parameter trees: FedAvg.

The counterpart of ``p2pfl_tpu/core/aggregators.py``. Only FedAvg is
ported; the robust aggregators are ROADMAP.md queue A, item A14, and
``ScenarioConfig`` rejects them before a run starts.
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.core.pytree import Params, tree_weighted_mean


class FedAvg:
    """Sample-count-weighted mean over the rows ``mask`` keeps."""

    name = "FedAvg"

    def aggregate(self, stacked: Params, weights: torch.Tensor,
                  mask: torch.Tensor | None = None) -> Params:
        w = weights.float()
        if mask is not None:
            w = torch.where(mask, w, torch.zeros_like(w))
        return tree_weighted_mean(stacked, w)

    def __call__(self, stacked, weights, mask=None):
        return self.aggregate(stacked, weights, mask)
