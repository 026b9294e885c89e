"""SYSCALL behavioural-fingerprinting models: the counterpart of
``p2pfl_tpu/models/syscall.py``.

- ``Autoencoder``: a dense autoencoder (17 -> 64 -> 16 -> 64 -> 17,
  ReLU between), flax's ``Dense_0..Dense_3`` names, computed in
  ``dtype`` (bf16 by default) with an f32 output; its anomaly score is
  the reconstruction error (the ``autoencoder`` objective).
- ``OneClassSVM``: the linear nu-one-class SVM head, scores ``w.x -
  rho`` from top-level parameters ``w [in_features]`` and ``rho []``
  (zero at init), computed in f32 by default: a 17-wide dot has
  nothing to gain from bf16 and the margin is precision-sensitive (the
  ``ocsvm`` objective).

Both run plain PyTorch (no kernel): the JAX package computes them with
XLA ops. The MLP classifier of the family is ``syscall-mlp`` in
``models/mlp.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from p2pfl_tpu_torch.models.base import dense, dense_init, register_model


class Autoencoder(nn.Module):
    """Dense autoencoder over ``[n, b, in_features]`` rows."""

    def __init__(self, in_features: int = 17,
                 encoder: Sequence[int] = (64, 16), dtype=torch.bfloat16,
                 param_dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.encoder = tuple(encoder)
        self.dtype = dtype
        self.param_dtype = param_dtype

    def _widths(self) -> tuple[int, ...]:
        return (self.encoder + tuple(reversed(self.encoder[:-1]))
                + (self.in_features,))

    def init(self, generator: torch.Generator,
             sample_x: torch.Tensor) -> dict:
        """One node's parameters (CPU, ``param_dtype``) for rows shaped
        like ``sample_x [b, ...]``."""
        d = math.prod(sample_x.shape[1:])
        tree = {}
        for i, f in enumerate(self._widths()):
            tree[f"Dense_{i}"] = dense_init(d, f, generator)
            d = f
        return {"params": {k: {n: t.to(self.param_dtype) for n, t in v.items()}
                           for k, v in tree.items()}}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params["params"]
        x = x.reshape(x.shape[0], x.shape[1], -1).to(self.dtype)
        last = len(self._widths()) - 1
        for i in range(last):
            x = torch.relu(dense(x, p[f"Dense_{i}"], self.dtype))
        return dense(x, p[f"Dense_{last}"], self.dtype).float()


class OneClassSVM(nn.Module):
    """Linear one-class SVM head: decision scores ``w.x - rho`` ``[n,
    b]`` (f32)."""

    def __init__(self, in_features: int = 17, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.dtype = dtype
        self.param_dtype = param_dtype

    def init(self, generator: torch.Generator,
             sample_x: torch.Tensor) -> dict:
        del generator, sample_x  # zero init, as flax's initializer
        return {"params": {
            "w": torch.zeros(self.in_features, dtype=self.param_dtype),
            "rho": torch.zeros((), dtype=self.param_dtype)}}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params["params"]
        x = x.reshape(x.shape[0], x.shape[1], -1).to(self.dtype)
        w = p["w"].to(self.dtype)
        # products summed in f32 and rounded once to the compute dtype
        s = torch.matmul(x.float(), w.float()[:, :, None])[..., 0]
        s = s.to(self.dtype) - p["rho"].to(self.dtype)[:, None]
        return s.float()


@register_model("syscall-autoencoder", "syscallmodelautoencoder")
def SyscallModelAutoencoder(in_features: int = 17, **kw) -> Autoencoder:
    return Autoencoder(in_features=in_features, **kw)


@register_model("syscall-svm", "syscallmodelsgdoneclasssvm")
def SyscallModelOneClassSVM(in_features: int = 17, **kw) -> OneClassSVM:
    return OneClassSVM(in_features=in_features, **kw)
