"""Local training over the node axis, its objectives, and adapter-only
federation (``learning/lora.py``)."""

from p2pfl_tpu_torch.learning.lora import (
    LoraModel,
    lora_init,
    maybe_wrap_lora,
    merge_adapters,
    split_adapters,
)

__all__ = [
    "LoraModel",
    "lora_init",
    "maybe_wrap_lora",
    "merge_adapters",
    "split_adapters",
]
