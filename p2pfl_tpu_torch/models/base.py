"""Model registry, parameter init and the plain layers models share.

The counterpart of ``p2pfl_tpu/models/base.py``. A model is an
``nn.Module`` that holds no parameters itself: ``init`` returns a flax-
shaped parameter tree (``{"params": {"Dense_0": {"kernel", "bias"}}}``)
and ``forward(params, x)`` takes that tree with a leading ``[n]`` node
axis on every leaf and inputs ``[n, b, ...]``, so one call runs every
node of a federation. Layouts follow the JAX package: NHWC activations,
HWIO conv kernels, ``[in, out]`` dense kernels.

The conv-net family (``models/resnet.py``, ``models/mobilenet.py``)
carries its activations between layers node-packed, ``[b, H, W, n*C]``
(node i's channels at ``[i*C, (i+1)*C)``): that is ``channels_last``
memory for the NCHW view ``[b, n*C, H, W]``, so the stacked conv is one
grouped ``F.conv2d`` over the nodes (the JAX package's vmapped
``nn.Conv``, which XLA lowers to the same grouped conv) and GroupNorm a
reduction over one view, with no permute copies between layers; the
model converts at its entry and its exit only.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}

# per-model LoRA adapter-target metadata (``learning/lora.py``): the
# default target patterns and each pattern's (out_axes, base_ndim)
# kernel view, how many trailing axes are outputs and how many axes the
# unscanned kernel has (extra leading axes broadcast, e.g. the scanned
# ViT's depth axis). Registered beside the factory, as in the JAX
# package: the split is a property of the architecture.
_LORA_TARGETS: dict[str, tuple[tuple[str, ...],
                               dict[str, tuple[int, int]]]] = {}

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
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def register_lora_targets(*names: str, default: tuple[str, ...],
                          specs: dict[str, tuple[int, int]] | None = None
                          ) -> None:
    """Register a model's default LoRA targets and kernel axis specs."""
    entry = (tuple(default), dict(specs or {}))
    for name in names:
        _LORA_TARGETS[name.lower()] = entry


def default_lora_targets(name: str) -> tuple[str, ...]:
    """A model's registered default adapter targets; loud when it
    registers none (adapting nothing would report a fine-tune that
    never ran), so the scenario must then set ``lora.targets``."""
    entry = _LORA_TARGETS.get(name.lower())
    if entry is None or not entry[0]:
        raise ValueError(
            f"model {name!r} registers no default lora targets "
            f"(have {sorted(_LORA_TARGETS)}); set lora.targets "
            "explicitly")
    return entry[0]


def lora_axis_specs(name: str) -> dict[str, tuple[int, int]]:
    """Per-pattern (out_axes, base_ndim) kernel views; a pattern absent
    here takes the plain 2-D ``(..., d_in, d_out)`` view."""
    entry = _LORA_TARGETS.get(name.lower())
    return dict(entry[1]) if entry else {}


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


# ---------------------------------------------------------------------------
# the conv-net family's plain layers, over node-packed activations
# ---------------------------------------------------------------------------

#: flax ``nn.GroupNorm``'s epsilon (PyTorch's ``F.group_norm`` takes 1e-5)
GROUP_NORM_EPS = 1e-6


def pack_nodes(x: torch.Tensor) -> torch.Tensor:
    """``[n, b, H, W, C]`` -> node-packed ``[b, H, W, n*C]`` (a copy)."""
    n, b, h, w, c = x.shape
    return x.permute(1, 2, 3, 0, 4).reshape(b, h, w, n * c)


def unpack_nodes(x: torch.Tensor, n: int) -> torch.Tensor:
    """Node-packed ``[b, H, W, n*C]`` -> ``[n, b, H, W, C]`` (a view)."""
    b, h, w, nc = x.shape
    return x.reshape(b, h, w, n, nc // n).permute(3, 0, 1, 2, 4)


def conv_init(kh: int, kw: int, cin: int, cout: int,
              generator: torch.Generator) -> dict:
    """A bias-free flax ``nn.Conv``: an HWIO lecun-normal kernel (fan-in
    ``kh * kw * cin``, ``cin`` per feature group)."""
    return {"kernel": lecun_normal((kh, kw, cin, cout), kh * kw * cin,
                                   generator)}


def group_norm_init(c: int) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ``ceil(size / stride)``
    outputs, the total pad split with the odd element at the end. At
    stride 2 on an even axis a 3-wide window gets (0, 1), where
    PyTorch's ``padding=1`` would give (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, n: int, dtype: torch.dtype,
         stride: int = 1, feature_groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` (SAME padding, no bias, ``feature_group_count =
    feature_groups``) of every node at once: node-packed ``x [b, H, W,
    n*Cin]`` and stacked HWIO kernels ``[n, kh, kw, Cin/feature_groups,
    Cout]``, cast to ``dtype``, as one ``F.conv2d`` with ``groups = n *
    feature_groups``. Returns node-packed ``[b, H', W', n*Cout]``."""
    b, h, w, _ = x.shape
    _, kh, kw, cin_g, cout = kernel.shape
    # [n, kh, kw, I, O] -> [n*O, kh, kw, I], cast in the same copy: the
    # channels_last layout of the conv weight [n*O, I, kh, kw]
    wt = kernel.permute(0, 4, 1, 2, 3).to(
        dtype=dtype, memory_format=torch.contiguous_format)
    wt = wt.reshape(n * cout, kh, kw, cin_g).permute(0, 3, 1, 2)
    (top, bottom), (left, right) = (same_pads(h, kh, stride),
                                    same_pads(w, kw, stride))
    if top == bottom and left == right:
        pad = (top, left)
    else:  # asymmetric SAME: pad W and H explicitly, then a VALID conv
        x = F.pad(x, (0, 0, left, right, top, bottom))
        pad = (0, 0)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), wt, stride=stride,
                 padding=pad, groups=n * feature_groups)
    return y.permute(0, 2, 3, 1).contiguous()


def group_norm(x: torch.Tensor, p: dict, n: int,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups=min(32, C))`` of every node at
    once over node-packed ``x [b, H, W, n*C]`` with stacked ``scale``
    and ``bias [n, C]``, in flax 0.12's arithmetic: statistics in f32
    over (H, W, the group's channels) per image, the fast variance
    ``max(0, E[x²] - E[x]²)``, ``(x - mean) * (rsqrt(var + 1e-6) *
    scale) + bias`` in f32, cast once to ``dtype``."""
    b, h, w, nc = x.shape
    c = nc // n
    g = min(32, c)
    xf = x.float().reshape(b, h * w, n * g, c // g)
    mean = xf.mean((1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean((1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    scale = p["scale"].float().reshape(1, 1, n * g, c // g)
    bias = p["bias"].float().reshape(1, 1, n * g, c // g)
    y = (xf - mean) * (torch.rsqrt(var + GROUP_NORM_EPS) * scale) + bias
    return y.to(dtype).reshape(b, h, w, nc)


def max_pool_packed(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool((2, 2), strides=(2, 2))`` (VALID) over
    node-packed ``[b, H, W, n*C]``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


def head(x: torch.Tensor, p: dict, n: int, dtype: torch.dtype,
         pool: str) -> torch.Tensor:
    """Global pool over H, W of node-packed ``x``, then flax ``nn.Dense``
    per node: ``[n, b, classes]`` in ``dtype``. ``pool`` "max", or
    "mean": an f32 mean rounded once to ``dtype`` (``jnp.mean``)."""
    b = x.shape[0]
    if pool == "max":
        x = x.amax(dim=(1, 2))
    else:
        x = x.float().mean((1, 2)).to(dtype)
    return dense(x.reshape(b, n, -1).transpose(0, 1), p, dtype)


class NodePackedModule(nn.Module):
    """A block or model of the conv-net family. It holds no parameters:
    ``init(generator, sample_x [b, H, W, C])`` returns one node's
    ``{"params": ...}`` tree (flax's names and shapes, ``param_dtype``);
    ``forward(params, x [n, b, H, W, C])`` runs a stacked tree. A
    subclass gives ``tree(generator, cin) -> (tree, cout)`` and
    ``packed(p, x, n)`` over node-packed activations; a model overrides
    ``forward`` with its head."""

    def __init__(self, dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.param_dtype = param_dtype

    def tree(self, generator: torch.Generator, cin: int) -> tuple[dict, int]:
        raise NotImplementedError

    def packed(self, p: dict, x: torch.Tensor, n: int) -> torch.Tensor:
        raise NotImplementedError

    def init(self, generator: torch.Generator,
             sample_x: torch.Tensor) -> dict:
        tree, _ = self.tree(generator, sample_x.shape[-1])

        def cast(t):
            return (t.to(self.param_dtype) if torch.is_tensor(t)
                    else {k: cast(v) for k, v in t.items()})

        return {"params": cast(tree)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        y = self.packed(params["params"], pack_nodes(x.to(self.dtype)), n)
        return unpack_nodes(y, n)


class StemBlocksHead(NodePackedModule):
    """A plain 3x3 stem conv of ``stem`` features -> GroupNorm -> ReLU,
    the ``blocks`` (named ``{block_name}_{i}`` in the tree), a global
    mean-pool and a dense head: ResNet18/34/50 and the MobileNets."""

    block_name = ""

    def __init__(self, stem: int, blocks: list, num_classes: int = 10,
                 **kw):
        super().__init__(**kw)
        self.stem = stem
        self.blocks = blocks
        self.num_classes = num_classes

    def tree(self, generator, cin):
        tree = {"Conv_0": conv_init(3, 3, cin, self.stem, generator),
                "GroupNorm_0": group_norm_init(self.stem)}
        c = self.stem
        for i, blk in enumerate(self.blocks):
            tree[f"{self.block_name}_{i}"], c = blk.tree(generator, c)
        tree["Dense_0"] = dense_init(c, self.num_classes, generator)
        return tree, self.num_classes

    def forward(self, params, x):
        p, n = params["params"], x.shape[0]
        x = conv(pack_nodes(x.to(self.dtype)), p["Conv_0"]["kernel"], n,
                 self.dtype)
        x = torch.relu(group_norm(x, p["GroupNorm_0"], n, self.dtype))
        for i, blk in enumerate(self.blocks):
            x = blk.packed(p[f"{self.block_name}_{i}"], x, n)
        return head(x, p["Dense_0"], n, self.dtype, "mean").float()
