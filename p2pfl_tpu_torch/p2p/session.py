"""The aggregation session: contributor-set bookkeeping for gossip.

The counterpart of ``p2pfl_tpu/p2p/session.py::AggregationSession``
and ``p2pfl_tpu/p2p/aggd.py::fuse_numpy``:

- models are stored keyed by their contributor set; a model whose
  contributors are already covered is ignored, one that supersedes
  stored models evicts them, and one that overlaps without
  superseding is rejected (it would count a contributor twice);
- ``get_partial_aggregation(peer_has)`` is the aggregate of the stored
  models the peer does not have yet (memoized per peer coverage until
  the store changes);
- the session finishes when the train set is covered, or on its
  timeout with whatever arrived; in waiting mode (trainer, proxy,
  idle) the first model that arrives is adopted as it is.

FedAvg is the host numpy weighted mean (``fuse_numpy``: f32
accumulation, the leaf's dtype kept) in both packages, so the two give
the same bits. Any other aggregator runs the port's
``core/aggregators.py`` over the stacked entries on the CPU.
``SidecarSession`` and the secure-aggregation masker are A22c; the
async close rule and the reputation ``entry_scales`` are A22d.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

import numpy as np
import torch

from p2pfl_tpu_torch.config.schema import _unported
from p2pfl_tpu_torch.core.aggregators import Aggregator, FedAvg
from p2pfl_tpu_torch.core.serialize import (
    as_f32,
    astype,
    dtype_name,
    from_host,
    own_params,
    to_host,
    tree_map_sorted,
)

Params = Any


def fuse_numpy(trees, weights) -> tuple[Any, float]:
    """The socket plane's FedAvg: a weighted mean in f32 over host trees,
    each leaf cast back to its own dtype. A zero total weight falls back
    to the uniform mean. Returns ``(fused_tree, total_weight)``."""
    weights = np.asarray(weights, np.float32)
    total = float(weights.sum())
    if total > 0:
        wn = weights / total
    else:
        wn = np.full_like(weights, 1.0 / len(trees))
        total = float(len(trees))

    def leaf(*xs):
        acc = as_f32(xs[0]) * wn[0]
        for wi, x in zip(wn[1:], xs[1:]):
            acc += as_f32(x) * wi
        return astype(acc, dtype_name(xs[0]))

    return tree_map_sorted(leaf, *trees), total


def _stacked_aggregate(aggregator: Aggregator, trees, weights) -> Params:
    """A robust aggregator over the stacked host trees, on the CPU."""
    stacked = tree_map_sorted(
        lambda *xs: torch.stack([from_host(x) for x in xs]), *trees)
    agg = aggregator(stacked, torch.from_numpy(np.asarray(weights, np.float32)))
    return tree_map_sorted(to_host, agg)


class AggregationSession:
    """One round's aggregation state for one node."""

    def __init__(self, aggregator: Aggregator | None = None,
                 timeout_s: float = 60.0, reputation=None,
                 min_received: float = 1.0, staleness_beta: float = 0.0,
                 masker=None):
        if reputation is not None:
            raise _unported("reputation-weighted socket sessions", "A22d")
        if min_received < 1.0 or staleness_beta:
            raise _unported("async aggregation on the socket plane", "A22d")
        if masker is not None:
            raise _unported("secure aggregation (the masker)", "A22c")
        self.aggregator = aggregator or FedAvg()
        self.timeout_s = timeout_s
        self.models: dict[frozenset[int], tuple[Params, float]] = {}
        self.train_set: frozenset[int] = frozenset()
        self.waiting = False
        self.done = asyncio.Event()
        self.result: tuple[Params, tuple[int, ...]] | None = None
        self._deadline: float | None = None
        self._partial_memo: dict[
            frozenset[int], tuple[Params, tuple[int, ...], float] | None
        ] = {}

    # -- setup ----------------------------------------------------------
    def set_nodes_to_aggregate(self, train_set) -> None:
        self.train_set = frozenset(int(i) for i in train_set)
        self._deadline = time.monotonic() + self.timeout_s

    def set_waiting_aggregated_model(self) -> None:
        """Trainer, proxy, idle: adopt the next aggregate received."""
        self.waiting = True

    # -- state ----------------------------------------------------------
    @property
    def covered(self) -> frozenset[int]:
        out: frozenset[int] = frozenset()
        for key in self.models:
            out = out | key
        return out

    def timed_out(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline

    # -- adding models ---------------------------------------------------
    def add_model(self, params: Params, contributors, weight: float,
                  staleness: float = 0.0) -> tuple[int, ...]:
        """The contributors now covered (empty: rejected)."""
        if staleness > 0.0:
            raise _unported("stale-update folds on the socket plane", "A22d")
        contrib = frozenset(int(i) for i in contributors)
        if not contrib:
            return ()
        if self.waiting:
            self.result = (own_params(params), tuple(sorted(contrib)))
            self.done.set()
            return tuple(sorted(contrib))
        if contrib <= self.covered:
            return ()
        evict = [k for k in self.models if k <= contrib]
        explained: frozenset[int] = frozenset()
        for k in evict:
            explained = explained | k
        if (contrib & self.covered) - explained:
            return ()  # overlapping but not superseding
        for key in evict:
            del self.models[key]
        self.models[contrib] = (params, float(weight))
        self._partial_memo.clear()
        if self.train_set and self.covered >= self.train_set:
            self._finish()
        return tuple(sorted(self.covered))

    # -- partial aggregation for a peer ----------------------------------
    def get_partial_aggregation(
        self, peer_has
    ) -> tuple[Params, tuple[int, ...], float] | None:
        """Aggregate of the stored models holding no contributor the peer
        already has; None if there is nothing new to send."""
        peer = frozenset(int(i) for i in peer_has)
        if peer in self._partial_memo:
            return self._partial_memo[peer]
        send = [(p, k, w) for k, (p, w) in self.models.items()
                if not (k & peer)]
        if not send:
            self._partial_memo[peer] = None
            return None
        params, _, weight = self._aggregate([(p, w) for p, _, w in send])
        all_contrib: frozenset[int] = frozenset()
        for _, k, _ in send:
            all_contrib = all_contrib | k
        out = (params, tuple(sorted(all_contrib)), weight)
        self._partial_memo[peer] = out
        return out

    # -- completion -------------------------------------------------------
    def check_and_run(self) -> bool:
        """Finish on coverage or on the timeout with whatever arrived."""
        if self.done.is_set():
            return True
        if self.models and (
            (self.train_set and self.covered >= self.train_set)
            or self.timed_out()
        ):
            self._finish()
            return True
        return False

    def _finish(self) -> None:
        params, _, _ = self._aggregate(list(self.models.values()))
        self.result = (own_params(params), tuple(sorted(self.covered)))
        self.done.set()

    def _aggregate(self, entries) -> tuple[Params, tuple[int, ...], float]:
        if len(entries) == 1:
            p, w = entries[0]
            return p, (), w
        weights = np.asarray([w for _, w in entries], np.float32)
        if type(self.aggregator) is FedAvg:
            tree, total = fuse_numpy([p for p, _ in entries], weights)
        else:
            tree = _stacked_aggregate(self.aggregator,
                                      [p for p, _ in entries], weights)
            total = float(weights.sum())
        return tree, (), total

    def clear(self) -> None:
        """Reset for the next round."""
        self.models.clear()
        self._partial_memo.clear()
        self.train_set = frozenset()
        self.waiting = False
        self.result = None
        self.done = asyncio.Event()
        self._deadline = None


class SidecarSession(AggregationSession):
    """The shared-memory aggregation sidecar's session: A22c."""

    def __init__(self, *args, **kwargs):
        raise _unported("the aggregation sidecar (SidecarSession)", "A22c")
