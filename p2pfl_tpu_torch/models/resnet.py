"""ResNets for CIFAR-10: the counterpart of ``p2pfl_tpu/models/resnet.py``.

NHWC, bf16 compute over f32 parameters, GroupNorm instead of BatchNorm
(a pure parameter tree, robust under non-IID shards), every node of a
federation in one call. Activations travel node-packed between layers
(``models.base``): each conv is one grouped ``F.conv2d`` over the nodes,
GroupNorm, ReLU, pooling and the residual adds are plain PyTorch in the
compute dtype, as they were XLA ops in the JAX package.

One conv runs through the kernels: a ``ConvBlock`` whose contraction
``Cin * 9`` is at most ``PATCH_CONV_MAX_CONTRACTION`` is the JAX
package's ``PatchConv`` (``models.cnn.patch_conv``: K1 forward, K2
weight gradient, no input gradient since its input is the image). Of
the registered models only ResNet9's RGB stem (contraction 27) takes
it; ResNet18/34/50 open with a plain 3x3 conv, as in JAX.

The parameter trees carry flax's automatic names: ``ConvBlock_i``,
``Residual_i`` (``ConvBlock_0..1`` each) and ``Dense_0`` in ResNet9;
``Conv_0``/``GroupNorm_0``, ``BasicBlock_i`` or ``Bottleneck_i`` and
``Dense_0`` in ResNet; ``Conv_j``/``GroupNorm_j`` inside a block, the
shortcut last.
"""

from __future__ import annotations

from typing import Sequence

import torch

from p2pfl_tpu_torch.models.base import (
    NodePackedModule,
    StemBlocksHead,
    conv,
    conv_init,
    dense_init,
    group_norm,
    group_norm_init,
    head,
    max_pool_packed,
    pack_nodes,
    register_model,
    unpack_nodes,
)
from p2pfl_tpu_torch.models.cnn import PATCH_CONV_MAX_CONTRACTION, patch_conv


class ConvBlock(NodePackedModule):
    """3x3 conv (no bias) -> GroupNorm -> ReLU (-> 2x2 max-pool)."""

    def __init__(self, features: int, pool: bool = False, **kw):
        super().__init__(**kw)
        self.features = features
        self.pool = pool

    def tree(self, generator, cin):
        return {"Conv_0": conv_init(3, 3, cin, self.features, generator),
                "GroupNorm_0": group_norm_init(self.features)}, self.features

    def packed(self, p, x, n):
        if x.shape[-1] // n * 9 <= PATCH_CONV_MAX_CONTRACTION:
            # the RGB stem: PatchConv(use_bias=False, name="Conv_0")
            y = patch_conv(unpack_nodes(x, n), p["Conv_0"], self.dtype,
                           use_bias=False)
            x = pack_nodes(y)
        else:
            x = conv(x, p["Conv_0"]["kernel"], n, self.dtype)
        x = torch.relu(group_norm(x, p["GroupNorm_0"], n, self.dtype))
        return max_pool_packed(x) if self.pool else x


class Residual(NodePackedModule):
    """``x + ConvBlock(ConvBlock(x))``, added in the compute dtype."""

    def __init__(self, features: int, **kw):
        super().__init__(**kw)
        self.blocks = [ConvBlock(features, **kw) for _ in range(2)]

    def tree(self, generator, cin):
        tree, c = {}, cin
        for i, blk in enumerate(self.blocks):
            tree[f"ConvBlock_{i}"], c = blk.tree(generator, c)
        return tree, c

    def packed(self, p, x, n):
        y = x
        for i, blk in enumerate(self.blocks):
            y = blk.packed(p[f"ConvBlock_{i}"], y, n)
        return x + y


class ResNet9(NodePackedModule):
    """The fast CIFAR ResNet9: prep -> 2 x (conv-pool + residual) ->
    global max-pool -> dense; f32 logits scaled by 0.125."""

    def __init__(self, num_classes: int = 10, **kw):
        super().__init__(**kw)
        self.num_classes = num_classes
        self.layers = [("ConvBlock_0", ConvBlock(64, **kw)),
                       ("ConvBlock_1", ConvBlock(128, pool=True, **kw)),
                       ("Residual_0", Residual(128, **kw)),
                       ("ConvBlock_2", ConvBlock(256, pool=True, **kw)),
                       ("ConvBlock_3", ConvBlock(512, pool=True, **kw)),
                       ("Residual_1", Residual(512, **kw))]

    def tree(self, generator, cin):
        tree, c = {}, cin
        for name, layer in self.layers:
            tree[name], c = layer.tree(generator, c)
        tree["Dense_0"] = dense_init(c, self.num_classes, generator)
        return tree, self.num_classes

    def forward(self, params, x):
        p, n = params["params"], x.shape[0]
        x = pack_nodes(x.to(self.dtype))
        for name, layer in self.layers:
            x = layer.packed(p[name], x, n)
        return head(x, p["Dense_0"], n, self.dtype, "max").float() * 0.125


class BasicBlock(NodePackedModule):
    """Two 3x3 convs with GroupNorm; a 1x1 conv + GroupNorm shortcut where
    the shape changes; ReLU after the add."""

    expansion = 1

    def __init__(self, features: int, strides: int = 1, **kw):
        super().__init__(**kw)
        self.features = features
        self.strides = strides

    def _convs(self):
        """``(kernel, features, stride)`` of the main branch's convs."""
        f = self.features
        return [(3, f, self.strides), (3, f, 1)]

    def tree(self, generator, cin):
        tree, c = {}, cin
        convs = self._convs()
        for j, (k, f, _) in enumerate(convs):
            tree[f"Conv_{j}"] = conv_init(k, k, c, f, generator)
            tree[f"GroupNorm_{j}"] = group_norm_init(f)
            c = f
        if self._shortcut(cin):
            j = len(convs)
            tree[f"Conv_{j}"] = conv_init(1, 1, cin, c, generator)
            tree[f"GroupNorm_{j}"] = group_norm_init(c)
        return tree, c

    def _shortcut(self, cin: int) -> bool:
        # flax's ``x.shape != y.shape``: the stride or the width changes
        return self.strides != 1 or cin != self.features * self.expansion

    def packed(self, p, x, n):
        convs = self._convs()
        y = x
        for j, (_, _, s) in enumerate(convs):
            y = conv(y, p[f"Conv_{j}"]["kernel"], n, self.dtype, stride=s)
            y = group_norm(y, p[f"GroupNorm_{j}"], n, self.dtype)
            if j < len(convs) - 1:
                y = torch.relu(y)
        if self._shortcut(x.shape[-1] // n):
            j = len(convs)
            x = conv(x, p[f"Conv_{j}"]["kernel"], n, self.dtype,
                     stride=self.strides)
            x = group_norm(x, p[f"GroupNorm_{j}"], n, self.dtype)
        return torch.relu(x + y)


class Bottleneck(BasicBlock):
    """1x1 -> 3x3 (strided) -> 1x1 to ``4 * features``, GroupNorm after
    each; a 1x1 + GroupNorm shortcut where the shape changes."""

    expansion = 4

    def _convs(self):
        f = self.features
        return [(1, f, 1), (3, f, self.strides), (1, 4 * f, 1)]


class ResNet(StemBlocksHead):
    """Generic CIFAR-style ResNet-{18,34,50}: 3x3 stem, no max-pool,
    stages of 64 * 2**stage features, global mean-pool, dense."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False, num_classes: int = 10, **kw):
        block = Bottleneck if bottleneck else BasicBlock
        blocks = [
            block(64 * 2 ** stage, strides=2 if stage > 0 and b == 0 else 1,
                  **kw)
            for stage, n_blocks in enumerate(stage_sizes)
            for b in range(n_blocks)]
        super().__init__(64, blocks, num_classes, **kw)
        self.stage_sizes = tuple(stage_sizes)
        self.bottleneck = bottleneck
        self.block_name = block.__name__


@register_model("resnet9", "cifar10-resnet9", "cifar10modelresnet")
def resnet9(num_classes: int = 10, **kw) -> ResNet9:
    return ResNet9(num_classes=num_classes, **kw)


@register_model("resnet18", "cifar10-resnet18")
def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes, **kw)


@register_model("resnet34", "cifar10-resnet34")
def resnet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)


@register_model("resnet50", "cifar10-resnet50")
def resnet50(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                  num_classes=num_classes, **kw)


def CIFAR10ModelResNet(depth: int = 9, **kw) -> NodePackedModule:
    """The reference's classifier-dict factory: ResNet of ``depth`` 9,
    18, 34 or 50."""
    factories = {9: resnet9, 18: resnet18, 34: resnet34, 50: resnet50}
    return factories[depth](**kw)
