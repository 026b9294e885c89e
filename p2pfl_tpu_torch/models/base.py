"""Model registry, parameter init and the plain layers models share.

The counterpart of ``p2pfl_tpu/models/base.py``. A model is an
``nn.Module`` that holds no parameters itself: ``init`` returns a flax-
shaped parameter tree (``{"params": {"Dense_0": {"kernel", "bias"}}}``)
and ``forward(params, x)`` takes that tree with a leading ``[n]`` node
axis on every leaf and inputs ``[n, b, ...]``, so one call runs every
node of a federation. Layouts follow the JAX package: NHWC activations,
HWIO conv kernels, ``[in, out]`` dense kernels.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}

#: names the JAX package registers that this port does not have yet
_UNPORTED = ("fastermobilenet", "simplemobilenet", "simplemobilenetv1",
             "resnet9", "cifar10-resnet9", "cifar10modelresnet", "resnet18",
             "cifar10-resnet18", "resnet34", "cifar10-resnet34", "resnet50",
             "cifar10-resnet50", "vit-tiny", "vit")

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "float32": torch.float32}


def register_model(*names: str):
    """Decorator registering a model factory under one or more names."""

    def deco(fn):
        for name in names:
            key = name.lower()
            if key in _REGISTRY:
                raise ValueError(f"model name {name!r} already registered")
            _REGISTRY[key] = fn
        return fn

    return deco


def get_model(name: str, **kwargs) -> nn.Module:
    key = name.lower()
    if key not in _REGISTRY:
        if key in _UNPORTED:
            raise NotImplementedError(
                f"model {name!r} is not ported to p2pfl_tpu_torch yet "
                "(ROADMAP.md queue A, item A21)")
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def build_model(model_cfg) -> nn.Module:
    """Construct a model from a ``ModelConfig``; ``compute_dtype`` and
    ``param_dtype`` set the model's ``dtype``/``param_dtype`` unless
    ``kwargs`` names them. ``None`` keeps the model's own choice (the
    one-class SVM computes in f32 on purpose)."""
    kwargs = dict(model_cfg.kwargs)
    if model_cfg.compute_dtype is not None:
        kwargs.setdefault("dtype", _DTYPES[model_cfg.compute_dtype])
    if model_cfg.param_dtype is not None:
        kwargs.setdefault("param_dtype", _DTYPES[model_cfg.param_dtype])
    return get_model(model_cfg.model, **kwargs)


def lecun_normal(shape: tuple[int, ...], fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def dense_init(d_in: int, d_out: int, generator: torch.Generator) -> dict:
    return {"kernel": lecun_normal((d_in, d_out), d_in, generator),
            "bias": torch.zeros(d_out)}


def node_bias(b: torch.Tensor, dtype: torch.dtype, ndim: int) -> torch.Tensor:
    """A stacked bias ``[n, f]`` cast to ``dtype`` and shaped to add to
    an ``[n, ..., f]`` activation of ``ndim`` dims."""
    return b.to(dtype).reshape((b.shape[0],) + (1,) * (ndim - 2)
                               + (b.shape[-1],))


def dense(x: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` in ``dtype`` over the node axis: ``x [n,b,in]``
    and kernel ``[n,in,out]`` cast to ``dtype``, products summed in f32
    and rounded once, then the bias added in ``dtype``."""
    k = p["kernel"].to(dtype)
    y = torch.matmul(x.to(dtype).float(), k.float()).to(dtype)
    return y + node_bias(p["bias"], dtype, y.dim())
