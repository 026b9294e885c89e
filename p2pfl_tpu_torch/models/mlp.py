"""MLP family: the counterpart of ``p2pfl_tpu/models/mlp.py``.

``mnist-mlp`` (784 -> 256 -> 128 -> 10) is ``run.py``'s default model;
``syscall-mlp`` (17 -> 64 -> 64 -> 9) and ``wadi-mlp`` (123 -> 128 ->
64 -> 32 -> 2) are the tabular classifiers. They run no kernel in the
forward pass: their layers are the plain dense of ``models.base``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from p2pfl_tpu_torch.models.base import dense, dense_init, register_model


class MLP(nn.Module):
    """Flatten -> Dense+ReLU stack -> logits (f32), computed in
    ``dtype``, parameters stored in ``param_dtype``."""

    def __init__(self, features: Sequence[int] = (256, 128),
                 num_classes: int = 10, dtype=torch.bfloat16,
                 param_dtype=torch.float32):
        super().__init__()
        self.features = tuple(features)
        self.num_classes = num_classes
        self.dtype = dtype
        self.param_dtype = param_dtype

    def init(self, generator: torch.Generator,
             sample_x: torch.Tensor) -> dict:
        """One node's parameters (CPU, ``param_dtype``) for inputs shaped
        like ``sample_x [b, ...]``."""
        d = math.prod(sample_x.shape[1:])
        tree = {}
        for i, f in enumerate(self.features + (self.num_classes,)):
            tree[f"Dense_{i}"] = dense_init(d, f, generator)
            d = f
        return {"params": {k: {n: t.to(self.param_dtype) for n, t in v.items()}
                           for k, v in tree.items()}}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params["params"]
        x = x.reshape(x.shape[0], x.shape[1], -1).to(self.dtype)
        for i in range(len(self.features)):
            x = torch.relu(dense(x, p[f"Dense_{i}"], self.dtype))
        x = dense(x, p[f"Dense_{len(self.features)}"], self.dtype)
        return x.float()


@register_model("mlp", "mnist-mlp", "mnistmodelmlp")
def MNISTModelMLP(num_classes: int = 10, **kw) -> MLP:
    return MLP(features=(256, 128), num_classes=num_classes, **kw)



@register_model("syscall-mlp", "syscallmodelmlp")
def SyscallModelMLP(in_features: int = 17, num_classes: int = 9,
                    **kw) -> MLP:
    """Tabular syscall-trace classifier; ``in_features`` is accepted and
    dropped (the first layer's width follows the input), as in JAX."""
    del in_features
    return MLP(features=(64, 64), num_classes=num_classes, **kw)


@register_model("wadi-mlp", "wadimodelmlp")
def WADIModelMLP(in_features: int = 123, num_classes: int = 2, **kw) -> MLP:
    """WADI anomaly-detection MLP; ``in_features`` as above."""
    del in_features
    return MLP(features=(128, 64, 32), num_classes=num_classes, **kw)
