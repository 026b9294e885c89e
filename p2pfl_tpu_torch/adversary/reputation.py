"""Per-node trust from round-wise update statistics.

The counterpart of ``p2pfl_tpu/adversary/reputation.py`` for the
stacked federation. Every round each node's update delta (trained
params minus the round-start params) is scored against the cohort
(:func:`cohort_scores`); a host-side EWMA (:class:`ReputationMonitor`)
folds the scores into a trust per node, and the scenario multiplies the
trust into the mixing matrix's columns for the next round (a zeroed
column is a masked row for the robust aggregators).

A score is ``clip(cos, 0, 1) * ratio``: ``cos`` is the cosine of the
node's delta to the cohort's mean unit direction, ``ratio`` is
``min(|d|, med) / max(|d|, med)`` against the median norm of the
present rows (with an even count the two middle norms averaged, as
``jnp.nanmedian`` does). A non-finite delta scores 0 and leaves the
consensus.

The socket plane's session scores its stored entries at finish
(``observe_entries``, host numpy over decoded trees, the JAX package's
arithmetic through :func:`cohort_scores_np`) and rescales each entry's
weight by the least trust among its contributors (``entry_scales``).
The flight-recorder events the JAX monitor emits on exclusion and
restoration are ROADMAP item A23.
"""

from __future__ import annotations

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import Params, tree_leaves
from p2pfl_tpu_torch.core.serialize import as_f32, tree_leaves_sorted


def _masked_median(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The median of ``values[keep]`` (the two middle values averaged
    for an even count), 0 when nothing is kept; no host sync."""
    count = keep.sum()
    inf = torch.full_like(values, float("inf"))
    vals = torch.sort(torch.where(keep, values, inf)).values
    lo = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(count, 2, rounding_mode="floor"),
                     max=values.shape[0] - 1)
    med = (vals[lo] + vals[hi]) * 0.5
    return torch.where(count > 0, med, torch.zeros_like(med))


def cohort_scores(deltas: torch.Tensor,
                  present: torch.Tensor | None = None) -> torch.Tensor:
    """Score each row of a ``[k, d]`` delta matrix in ``[0, 1]``;
    ``present`` (``[k]`` bool) masks rows out of the consensus and
    scores them 0."""
    eps = 1e-12
    deltas = deltas.float()
    k = deltas.shape[0]
    pm = (torch.ones(k, device=deltas.device) if present is None
          else present.float())
    norms = torch.sqrt((deltas * deltas).sum(1))
    finite = torch.isfinite(norms)
    pm = pm * finite.float()
    norms = torch.where(finite, norms, torch.zeros_like(norms))
    deltas = torch.where(finite[:, None], deltas, torch.zeros_like(deltas))
    unit = deltas / (norms + eps)[:, None]
    direction = (unit * pm[:, None]).sum(0) / torch.clamp(pm.sum(), min=1.0)
    dnorm = torch.sqrt((direction * direction).sum()) + eps
    cos = unit @ (direction / dnorm)
    med = _masked_median(norms, pm > 0)
    ratio = ((torch.minimum(norms, med) + eps)
             / (torch.maximum(norms, med) + eps))
    score = torch.clamp(cos, 0.0, 1.0) * ratio
    return torch.where(pm > 0, score, torch.zeros_like(score))


def cohort_scores_np(deltas: np.ndarray) -> np.ndarray:
    """:func:`cohort_scores` in numpy over every row, as the JAX
    package's socket session computes it (``xp=np``): the socket plane
    scores host trees whose entry count varies with gossip timing."""
    eps = 1e-12
    deltas = deltas.astype(np.float32)
    pm = np.ones((deltas.shape[0],), np.float32)
    norms = np.sqrt(np.sum(deltas * deltas, axis=1))
    finite = np.isfinite(norms)
    pm = pm * finite.astype(np.float32)
    norms = np.where(finite, norms, 0.0)
    deltas = np.where(finite[:, None], deltas, 0.0)
    unit = deltas / (norms + eps)[:, None]
    direction = np.sum(unit * pm[:, None], axis=0) / np.maximum(
        np.sum(pm), 1.0)
    dnorm = np.sqrt(np.sum(direction * direction)) + eps
    cos = unit @ (direction / dnorm)
    vals = norms[pm > 0]
    med = np.float32(np.median(vals)) if vals.size else np.float32(0.0)
    ratio = (np.minimum(norms, med) + eps) / (np.maximum(norms, med) + eps)
    score = np.clip(cos, 0.0, 1.0) * ratio
    return np.where(pm > 0, score, 0.0)


def _flat(tree) -> np.ndarray:
    """A host tree's leaves in f32, flattened in JAX's order."""
    return np.concatenate([as_f32(leaf).ravel()
                           for leaf in tree_leaves_sorted(tree)])


def spmd_trust_obs(params_stacked: Params, ref_stacked: Params,
                   present: torch.Tensor) -> torch.Tensor:
    """The round's per-node score: each node's flattened delta against
    its round-start params, scored over the ``present`` cohort."""
    n = tree_leaves(params_stacked)[0].shape[0]
    deltas = torch.cat(
        [(p.float() - r.float()).reshape(n, -1)
         for p, r in zip(tree_leaves(params_stacked),
                         tree_leaves(ref_stacked))], dim=1)
    return cohort_scores(deltas, present=present)


class ReputationMonitor:
    """Host-side EWMA trust (numpy). ``observe(scores, mask)`` folds one
    round of scores into the nodes ``mask`` selects (absent nodes keep
    their trust); a node's first observation replaces the optimistic
    prior of 1. ``weights_vector()`` is the trust, hard-zeroed below
    ``cutoff``."""

    def __init__(self, n_nodes: int, alpha: float = 0.7,
                 cutoff: float = 0.15):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n_nodes = n_nodes
        self.alpha = float(alpha)
        self.cutoff = float(cutoff)
        self.trust = np.ones(n_nodes, np.float32)
        self._seen = np.zeros(n_nodes, bool)
        # nodes caught by direct evidence: a singleton entry (one
        # contributor) scoring below the cutoff; only these anchor the
        # explaining-away of ``observe_entries``
        self._confirmed_bad = np.zeros(n_nodes, bool)
        #: per-round trust snapshots
        self.history: list[list[float]] = []

    def observe(self, scores: np.ndarray, mask: np.ndarray | None = None):
        scores = np.asarray(scores, np.float32)
        scores = np.where(np.isfinite(scores), scores, 0.0)
        obs = (np.ones(self.n_nodes, bool) if mask is None
               else np.asarray(mask, bool))
        a = self.alpha
        blended = np.where(self._seen, (1.0 - a) * self.trust + a * scores,
                           scores)
        self.trust = np.where(obs, blended, self.trust).astype(np.float32)
        self._seen = self._seen | obs
        self.history.append([float(t) for t in self.trust])

    def observe_entries(self, reference, entries) -> None:
        """The socket plane's observation: ``entries`` is ``[(contributor
        frozenset, host params tree), ...]`` from one session and
        ``reference`` the round-start params its owner trained from.
        Each entry's delta is scored against the others; the score is an
        observation of every contributor it is attributed to, with
        evidence weight ``1 / |attributed|``. A singleton entry scoring
        below the cutoff confirms its contributor as bad (sticky), and
        an entry holding a confirmed node is attributed to the confirmed
        nodes alone (explaining away)."""
        ref_flat = _flat(reference)
        keys = [k for k, _ in entries]
        deltas = np.stack([_flat(p) - ref_flat for _, p in entries])
        scores = cohort_scores_np(deltas)
        for key, s in zip(keys, scores):
            ids = [c for c in key if 0 <= c < self.n_nodes]
            if len(ids) == 1 and float(s) < self.cutoff:
                self._confirmed_bad[ids[0]] = True
        obs_sum = np.zeros(self.n_nodes, np.float64)
        obs_cnt = np.zeros(self.n_nodes, np.float64)
        for key, s in zip(keys, scores):
            ids = [c for c in key if 0 <= c < self.n_nodes]
            if not ids:
                continue
            targets = [c for c in ids if self._confirmed_bad[c]] or ids
            ev = 1.0 / len(targets)
            for c in targets:
                obs_sum[c] += float(s) * ev
                obs_cnt[c] += ev
        mask = obs_cnt > 0
        per_node = np.where(mask, obs_sum / np.maximum(obs_cnt, 1e-9), 0.0)
        self.observe(per_node.astype(np.float32), mask)

    def weights_vector(self) -> np.ndarray:
        """Per-node weight multipliers: trust, zero below the cutoff."""
        return np.where(self.trust < self.cutoff, 0.0, self.trust).astype(
            np.float32)

    def entry_scales(self, keys) -> np.ndarray:
        """Per-entry weight multipliers for a session's stored models: the
        least multiplier among each entry's contributors (1.0 for an
        entry naming none): a partial merged with a distrusted node is
        poisoned through and through."""
        wv = self.weights_vector()
        out = []
        for key in keys:
            ids = [c for c in key if 0 <= c < self.n_nodes]
            out.append(float(np.min(wv[ids])) if ids else 1.0)
        return np.asarray(out, np.float32)

    def suspects(self) -> list[int]:
        """Nodes currently below the trust cutoff."""
        return [int(i) for i in np.flatnonzero(self.trust < self.cutoff)]
