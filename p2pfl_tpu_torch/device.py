"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is a CUDA
    device and none is available. The port never moves to the CPU on
    its own: the CPU runs only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card "
            "unless the CPU is asked for (device='cpu', or --platform cpu "
            "on the command line)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_numerics(dev: torch.device) -> None:
    """On the card, the JAX package's numerics: f32 products and convs in
    full f32 (no TF32), bf16 products with f32 sums, and only cuDNN's
    deterministic conv algorithms, so a run repeats bit for bit."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
