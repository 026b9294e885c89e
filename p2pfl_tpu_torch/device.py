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
