"""Private federation: DP-FedAvg (the counterpart of
``p2pfl_tpu/privacy``; secure aggregation is socket-plane work,
ROADMAP item A22)."""

from p2pfl_tpu_torch.privacy.dp import (
    DPSpec,
    PrivacyAccountant,
    clip_factor,
    dp_seed,
    epsilon_at,
    noise_sigma,
    privatize_stacked,
    privatize_update,
    update_norm,
)

__all__ = [
    "DPSpec",
    "PrivacyAccountant",
    "clip_factor",
    "dp_seed",
    "epsilon_at",
    "noise_sigma",
    "privatize_stacked",
    "privatize_update",
    "update_norm",
]
