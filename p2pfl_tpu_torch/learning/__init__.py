"""Local training over the node axis, its objectives, adapter-only
federation (``learning/lora.py``), and one node's learner for the
socket plane (``learner.TorchLearner``)."""

from p2pfl_tpu_torch.learning.learner import (
    SharedTrainer,
    TorchLearner,
)
from p2pfl_tpu_torch.learning.lora import (
    LoraModel,
    lora_init,
    maybe_wrap_lora,
    merge_adapters,
    split_adapters,
)

__all__ = [
    "SharedTrainer",
    "TorchLearner",
    "LoraModel",
    "lora_init",
    "maybe_wrap_lora",
    "merge_adapters",
    "split_adapters",
]
