"""Small convnets for MNIST / FEMNIST: the counterpart of
``p2pfl_tpu/models/cnn.py``.

``SmallCNN`` is conv(kxk, c1) -> pool -> conv(kxk, c2) -> pool ->
dense(hidden) -> logits, computed in bf16 over f32 parameters, NHWC,
with the node axis leading every tensor. Both convs run as patches
(im2col) plus a kernel GEMM, with no gate:

- a conv whose contraction ``cin*k*k`` is at most 64 (conv1) is the JAX
  package's ``PatchConv``: ``ops.gemm.patches_matmul``, K1 forward, K2
  weight gradient;
- a larger one (conv2) is its ``gate_kind="conv2"`` branch:
  ``ops.gemm.conv2_matmul``, K1 forward, K2 weight gradient, plain
  input gradient.

``Dense_0`` is ``GatedDense``: plain forward, K3 backward
(``ops.gemm.dense_matmul``). ``Dense_1``, relu and max-pool are plain
PyTorch, as they were XLA ops in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from p2pfl_tpu_torch.models.base import (
    dense,
    dense_init,
    lecun_normal,
    node_bias,
    register_model,
)
from p2pfl_tpu_torch.ops import gemm

#: contraction size at or below which a conv is the JAX package's
#: PatchConv (patches_matmul) rather than its conv2 branch
PATCH_CONV_MAX_CONTRACTION = 64


def patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """SAME-padded kxk patches of ``x [n, b, H, W, C]`` as rows
    ``[n, b*H*W, C*k*k]``: rows in ``(b, h, w)`` order, features in
    ``(cin, kh, kw)`` order — ``conv_general_dilated_patches``'s
    channel-major layout.

    Built as strided windows of the padded input and one copy. (On CUDA
    ``F.unfold`` launches one im2col kernel per image.) The windows are
    taken in f32 so that their backward sums the up to k*k overlapping
    gradients in f32, rounding once, as a conv transpose does; the
    patch values themselves are exact copies either way."""
    n, b, h, w, c = x.shape
    p = k // 2
    xp = F.pad(x.float(), (0, 0, p, p, p, p))  # pad W and H
    win = xp.unfold(2, k, 1).unfold(3, k, 1)  # [n, b, H, W, C, kh, kw]
    return win.reshape(n, b * h * w, c * k * k).to(x.dtype)


def patch_conv(x: torch.Tensor, p: dict, dtype: torch.dtype,
               use_bias: bool = True) -> torch.Tensor:
    """Conv of ``x [n, b, H, W, C]`` with HWIO kernels ``[n, k, k, C, F]``
    as patches times a ``[C*k*k, F]`` weight, through the kernels; plus
    the stacked bias ``[n, F]`` with ``use_bias`` (the ResNet stem has
    none)."""
    n, b, h, w, c = x.shape
    kern = p["kernel"]
    k, f = kern.shape[1], kern.shape[-1]
    flat = patches(x.to(dtype), k)
    # HWIO (kh, kw, cin) -> the patches' (cin, kh, kw) feature order
    wf = kern.to(dtype).permute(0, 3, 1, 2, 4).reshape(n, c * k * k, f)
    if c * k * k <= PATCH_CONV_MAX_CONTRACTION:
        out = gemm.patches_matmul(flat, wf)
    else:
        out = gemm.conv2_matmul(flat, wf)
    out = out.reshape(n, b, h, w, f)
    if not use_bias:
        return out
    return out + node_bias(p["bias"], dtype, out.dim())


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, over ``[n, b, H, W, C]``."""
    n, b, h, w, c = x.shape
    y = F.max_pool2d(x.reshape(n * b, h, w, c).permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).reshape(n, b, h // 2, w // 2, c)


class SmallCNN(nn.Module):
    """conv(kxk,c1) -> pool -> conv(kxk,c2) -> pool -> dense(hidden) ->
    logits. Holds no parameters: ``init`` makes one node's tree,
    ``forward(params, x)`` runs a stacked tree on ``x [n, b, H, W(, C)]``.
    """

    def __init__(self, channels: tuple[int, int] = (32, 64), kernel: int = 5,
                 hidden: int = 2048, num_classes: int = 62,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.channels = tuple(channels)
        self.kernel = kernel
        self.hidden = hidden
        self.num_classes = num_classes
        self.dtype = dtype
        self.param_dtype = param_dtype

    def init(self, generator: torch.Generator,
             sample_x: torch.Tensor) -> dict:
        """One node's parameters (CPU, ``param_dtype``) for inputs shaped
        like ``sample_x [b, H, W(, C)]``: lecun-normal kernels, zero
        biases, as flax initializes them."""
        h, w = sample_x.shape[1], sample_x.shape[2]
        cin = sample_x.shape[3] if sample_x.dim() == 4 else 1
        k = self.kernel
        tree = {}
        for i, c in enumerate(self.channels):
            tree[f"Conv_{i}"] = {
                "kernel": lecun_normal((k, k, cin, c), k * k * cin, generator),
                "bias": torch.zeros(c),
            }
            cin, h, w = c, h // 2, w // 2
        tree["Dense_0"] = dense_init(h * w * cin, self.hidden, generator)
        tree["Dense_1"] = dense_init(self.hidden, self.num_classes, generator)
        return {"params": {k: {n: t.to(self.param_dtype) for n, t in v.items()}
                           for k, v in tree.items()}}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params["params"]
        if x.dim() == 4:
            x = x[..., None]  # HW -> HWC
        x = x.to(self.dtype)
        for i in range(len(self.channels)):
            x = torch.relu(patch_conv(x, p[f"Conv_{i}"], self.dtype))
            x = max_pool_2x2(x)
        n, b = x.shape[:2]
        x = x.reshape(n, b, -1)  # NHWC flatten: (h, w, c)
        d0 = p["Dense_0"]
        x = gemm.dense_matmul(x, d0["kernel"].to(self.dtype))
        x = torch.relu(x + node_bias(d0["bias"], self.dtype, x.dim()))
        x = dense(x, p["Dense_1"], self.dtype)
        return x.float()


@register_model("mnist-cnn", "cnn", "mnistmodelcnn")
def MNISTModelCNN(num_classes: int = 10, hidden: int = 512, **kw) -> SmallCNN:
    return SmallCNN(channels=(32, 64), kernel=3, hidden=hidden,
                    num_classes=num_classes, **kw)


@register_model("femnist-cnn", "femnistmodelcnn")
def FEMNISTModelCNN(num_classes: int = 62, hidden: int = 2048,
                    **kw) -> SmallCNN:
    """The LEAF FEMNIST CNN: two 5x5 conv blocks, 2048-wide dense, 62
    classes — the main path's model."""
    return SmallCNN(channels=(32, 64), kernel=5, hidden=hidden,
                    num_classes=num_classes, **kw)
