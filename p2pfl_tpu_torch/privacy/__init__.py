"""Private federation (the counterpart of ``p2pfl_tpu/privacy``):
DP-FedAvg on the stacked plane (``dp``), and pairwise-mask secure
aggregation on the socket plane (``secagg``)."""

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
from p2pfl_tpu_torch.privacy.secagg import (
    DEFAULT_BITS,
    PairwiseMasker,
    SecaggError,
    SecaggUnmaskError,
    dequantize_sum,
    ecdh_pair_secret,
    fallback_pair_secret,
    masked_add,
    masked_sum,
    pair_secrets_from_tls,
    quantize_update,
    round_pair_seed,
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
    "DEFAULT_BITS",
    "PairwiseMasker",
    "SecaggError",
    "SecaggUnmaskError",
    "dequantize_sum",
    "ecdh_pair_secret",
    "fallback_pair_secret",
    "masked_add",
    "masked_sum",
    "pair_secrets_from_tls",
    "quantize_update",
    "round_pair_seed",
]
