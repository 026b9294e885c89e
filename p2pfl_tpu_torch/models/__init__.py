"""Model registry; importing the package registers every ported model."""

from p2pfl_tpu_torch.models import cnn, mlp, syscall, vit  # noqa: F401
from p2pfl_tpu_torch.models.base import build_model, get_model
from p2pfl_tpu_torch.models.mobilenet import FasterMobileNet, SimpleMobileNet
from p2pfl_tpu_torch.models.resnet import CIFAR10ModelResNet, ResNet
from p2pfl_tpu_torch.models.vit import ViT

__all__ = [
    "build_model",
    "get_model",
    "ResNet",
    "CIFAR10ModelResNet",
    "FasterMobileNet",
    "SimpleMobileNet",
    "ViT",
]
