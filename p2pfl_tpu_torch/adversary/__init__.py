"""Adversary and trust: attack injection and reputation.

The counterpart of ``p2pfl_tpu/adversary``: ``attacks`` transforms a
malicious node's outgoing update (or flips its labels), ``reputation``
scores every node's update against the cohort and keeps an EWMA trust
that rescales the mixing weights.
"""

from p2pfl_tpu_torch.adversary.attacks import (
    ATTACKS,
    MODEL_ATTACKS,
    AttackSpec,
    attack_seed,
    flip_labels,
    malicious_indices,
    poison_stacked,
    poison_update,
)
from p2pfl_tpu_torch.adversary.reputation import (
    ReputationMonitor,
    cohort_scores,
    spmd_trust_obs,
)

__all__ = [
    "ATTACKS",
    "MODEL_ATTACKS",
    "AttackSpec",
    "attack_seed",
    "flip_labels",
    "malicious_indices",
    "poison_stacked",
    "poison_update",
    "ReputationMonitor",
    "cohort_scores",
    "spmd_trust_obs",
]
