"""K-of-N client sampling for the cross-device regime.

A copy of ``p2pfl_tpu/federation/sampling.py`` (pure numpy), so both
packages draw the same cohorts. A draw is

- seeded and round-keyed: ``(seed, round)`` alone reproduces it;
- replacement-free: a client appears at most once a round;
- optionally data-weighted: clients with more examples are drawn more
  often.

Dead clients are not filtered here: a sampled-but-dead client is masked
out of training and aggregation inside the round, so the sample stream
does not depend on the history of faults.
"""

from __future__ import annotations

import numpy as np

# folded into the per-round generator key so cohort draws never collide
# with other consumers of the scenario seed
_SAMPLER_DOMAIN = 0x5A3C


def sample_clients(
    n_clients: int,
    k: int,
    round_num: int,
    seed: int = 0,
    weights: np.ndarray | None = None,
) -> np.ndarray:
    """Draw K of N client ids for ``round_num``, deterministic in
    ``(seed, round_num)``, without replacement. ``weights`` (e.g. the
    clients' data sizes) bias the draw and need not sum to 1;
    zero-weight clients are never drawn."""
    if k < 1 or k > n_clients:
        raise ValueError(f"cannot sample k={k} of n_clients={n_clients}")
    rng = np.random.default_rng([seed, round_num, _SAMPLER_DOMAIN])
    p = None
    if weights is not None:
        w = np.asarray(weights, np.float64)
        if w.shape != (n_clients,):
            raise ValueError(
                f"weights shape {w.shape} != ({n_clients},)"
            )
        if np.any(w < 0) or not np.all(np.isfinite(w)):
            raise ValueError("sampling weights must be finite and >= 0")
        total = w.sum()
        if total <= 0:
            raise ValueError("sampling weights sum to zero")
        if np.count_nonzero(w) < k:
            raise ValueError(
                f"only {np.count_nonzero(w)} clients have positive "
                f"weight; cannot draw k={k} without replacement"
            )
        p = w / total
    return rng.choice(n_clients, size=k, replace=False, p=p).astype(np.int64)


def sample_cohorts(
    n_clients: int,
    clients_per_round: int,
    cohort_size: int,
    round_num: int,
    seed: int = 0,
    weights: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One round's draw shaped for the cohort scan: ``(sampled [K],
    cohorts [cohort_size, n_slots])`` row-major — cohort step t runs
    clients ``sampled[t*n_slots:(t+1)*n_slots]``. Every arm (the
    materialized round, the chunked round, the streamed round) takes
    its client-to-slot assignment from here."""
    if clients_per_round % cohort_size:
        raise ValueError(
            f"clients_per_round={clients_per_round} must be a multiple "
            f"of cohort_size={cohort_size}")
    sampled = sample_clients(n_clients, clients_per_round, round_num,
                             seed=seed, weights=weights)
    n_slots = clients_per_round // cohort_size
    return sampled, sampled.reshape(cohort_size, n_slots)
