"""MobileNets for CIFAR-10: the counterpart of
``p2pfl_tpu/models/mobilenet.py``.

A plain 3x3 stem conv (flax ``nn.Conv``, not ``PatchConv``: it runs no
kernel), depthwise-separable blocks and a linear head, GroupNorm after
every conv, NHWC bf16 over f32 parameters. Node-packed activations as
in ``models/resnet.py``: a depthwise conv is one ``F.conv2d`` with
``groups = n * C``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from p2pfl_tpu_torch.models.base import (
    NodePackedModule,
    StemBlocksHead,
    conv,
    conv_init,
    group_norm,
    group_norm_init,
    register_model,
)


class DepthwiseSeparable(NodePackedModule):
    """3x3 depthwise conv (``strides``) -> GroupNorm -> ReLU -> 1x1 conv
    to ``features`` -> GroupNorm -> ReLU."""

    def __init__(self, features: int, strides: int = 1, **kw):
        super().__init__(**kw)
        self.features = features
        self.strides = strides

    def tree(self, generator, cin):
        return {"Conv_0": conv_init(3, 3, 1, cin, generator),
                "GroupNorm_0": group_norm_init(cin),
                "Conv_1": conv_init(1, 1, cin, self.features, generator),
                "GroupNorm_1": group_norm_init(self.features)
                }, self.features

    def packed(self, p, x, n):
        cin = x.shape[-1] // n
        x = conv(x, p["Conv_0"]["kernel"], n, self.dtype,
                 stride=self.strides, feature_groups=cin)
        x = torch.relu(group_norm(x, p["GroupNorm_0"], n, self.dtype))
        x = conv(x, p["Conv_1"]["kernel"], n, self.dtype)
        return torch.relu(group_norm(x, p["GroupNorm_1"], n, self.dtype))


class MobileNet(StemBlocksHead):
    """Stem conv + depthwise-separable ``blocks`` ((features, strides)
    each) + global mean-pool + dense."""

    block_name = "DepthwiseSeparable"

    def __init__(self, blocks: Sequence[tuple[int, int]] = (
            (64, 1), (128, 2), (128, 1), (256, 2)), stem: int = 32,
            num_classes: int = 10, **kw):
        super().__init__(stem, [DepthwiseSeparable(f, strides=s, **kw)
                                for f, s in blocks], num_classes, **kw)


@register_model("fastermobilenet")
def FasterMobileNet(num_classes: int = 10, **kw) -> MobileNet:
    """The small 4-block variant (the reference's fastermobilenet.py)."""
    return MobileNet(blocks=((64, 1), (128, 2), (128, 1), (256, 2)),
                     num_classes=num_classes, **kw)


@register_model("simplemobilenet", "simplemobilenetv1")
def SimpleMobileNet(num_classes: int = 10, **kw) -> MobileNet:
    """The fuller MobileNetV1-style stack (the reference's
    simplemobilenet.py)."""
    return MobileNet(
        blocks=((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                (512, 1), (512, 1)),
        num_classes=num_classes, **kw)
