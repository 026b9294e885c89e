"""Loss and metric functions over the node axis, all mask-aware.

The counterpart of ``p2pfl_tpu/learning/objectives.py`` (classification
only; the autoencoder and one-class-SVM objectives are ROADMAP.md queue
A, item A16). Inputs carry a leading node axis: logits ``[n, b, c]``,
labels and masks ``[n, b]``; every function returns one value per node.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-node mean of ``values [n, b]`` over the rows ``mask`` keeps."""
    m = mask.to(values.dtype)
    return (values * m).sum(-1) / m.sum(-1).clamp(min=1.0)


def cross_entropy_loss(logits: torch.Tensor, y: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, masked mean per node."""
    n, b, c = logits.shape
    losses = F.cross_entropy(logits.reshape(n * b, c).float(),
                             y.reshape(n * b).long(), reduction="none")
    return masked_mean(losses.reshape(n, b), mask)


def masked_accuracy(logits: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    correct = (logits.argmax(-1) == y.long()).float()
    return masked_mean(correct, mask)


_OBJECTIVES = {"classification": cross_entropy_loss}


def get_objective(name: str):
    if name not in _OBJECTIVES:
        raise NotImplementedError(
            f"objective {name!r} is not ported to p2pfl_tpu_torch yet "
            "(ROADMAP.md queue A, item A16)")
    return _OBJECTIVES[name]
