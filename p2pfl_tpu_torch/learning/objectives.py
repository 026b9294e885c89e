"""Loss and metric functions over the node axis, all mask-aware.

The counterpart of ``p2pfl_tpu/learning/objectives.py``: the
classification, autoencoder (MSE against the input) and one-class-SVM
objectives. Inputs carry a leading node axis: logits ``[n, b, c]``,
reconstructions ``[n, b, ...]``, scores, labels and masks ``[n, b]``;
every function returns one value per node.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: objectives whose outputs are not class logits: accuracy reads 0.0
NO_ACCURACY_OBJECTIVES = ("autoencoder", "ocsvm")


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


def mse_loss(pred: torch.Tensor, x: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Each row's mean squared error over every non-batch axis of
    ``pred - x.reshape(pred.shape)``, masked mean per node."""
    d = pred.float() - x.reshape(pred.shape).float()
    per_row = (d * d).mean(dim=tuple(range(2, pred.dim())))
    return masked_mean(per_row, mask)


def ocsvm_loss(scores: torch.Tensor, _y: torch.Tensor, mask: torch.Tensor,
               nu: float = 0.1) -> torch.Tensor:
    """The data term of the linear nu-one-class SVM, ``mean(max(0, -s))
    / nu`` per node for scores ``s = w.x - rho``; the learner adds
    :func:`ocsvm_penalty`.

    The hinge is written ``(|s| - s) / 2``: the same values, exactly, and
    at ``s = 0`` (every score of the SVM's zero init) the gradient
    ``-1/2`` that ``jnp.maximum`` gives a tie, where a clamp gives
    ``-1``."""
    s = scores.float()
    hinge = (s.abs() - s) * 0.5
    return masked_mean(hinge, mask) / nu


def ocsvm_penalty(params) -> torch.Tensor:
    """The parameter term ``0.5 * sum(w^2) - rho``, one value a node,
    from a stacked tree (``w [n, d]``, ``rho [n]``)."""
    inner = params["params"] if "params" in params else params
    w = inner["w"]
    return 0.5 * (w * w).reshape(w.shape[0], -1).sum(-1) - inner["rho"]


def masked_accuracy(logits: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    correct = (logits.argmax(-1) == y.long()).float()
    return masked_mean(correct, mask)


_OBJECTIVES = {
    "classification": cross_entropy_loss,
    "autoencoder": mse_loss,
    "ocsvm": ocsvm_loss,
}


def get_objective(name: str):
    if name not in _OBJECTIVES:
        raise ValueError(
            f"unknown objective {name!r}; have {sorted(_OBJECTIVES)}")
    return _OBJECTIVES[name]
