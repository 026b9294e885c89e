"""Model registry; importing the package registers every ported model."""

from p2pfl_tpu_torch.models import cnn, mlp, syscall  # noqa: F401
from p2pfl_tpu_torch.models.base import build_model, get_model

__all__ = ["build_model", "get_model"]
