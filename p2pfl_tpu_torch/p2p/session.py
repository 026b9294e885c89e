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
the same bits; the sidecar's worker runs the same function. Any other
aggregator runs the port's ``core/aggregators.py`` over the stacked
entries on the CPU.

With a ``masker`` (``privacy/secagg.py``) the entries are masked uint64
trees with the weight folded in: fusing is the exact mod-2^64 sum, and
``_finish`` subtracts the evicted members' residue and dequantizes
against the round-start reference (``set_reference``).

The async mode (``min_received < 1``, FedBuff's close rule): the
round closes once a quorum ``max(1, ceil(min_received * |train set|))``
of the train set is covered, or on the timeout; a straggler's update
that missed its round folds into a later one with its weight scaled by
``staleness_scale(staleness, staleness_beta)`` when it is added (the
stacked plane's f32 formula, so the two planes weigh alike). Staleness
belongs to the update, so it is applied once, at entry, and composes
with the weighted partials gossip forwards.

With a ``reputation`` monitor (``adversary/reputation.py``) the session
scores its entries against the round-start reference at finish
(``observe_entries``, three entries or more) and scales each entry's
weight by ``entry_scales`` in the fuse, at finish only: a gossiped
partial is weighted again in each receiver's own finish.

``SidecarSession`` keeps its entries undecoded in the sidecar's arena
(``p2p/aggd.py``) and has the worker fuse them with the effective
weights (staleness and ``entry_scales`` folded in); it cannot score
entries it never decodes, so the schema refuses reputation with it.
"""

from __future__ import annotations

import asyncio
import math
import time
from typing import Any

import numpy as np
import torch

from p2pfl_tpu_torch.core.aggregators import Aggregator, FedAvg
from p2pfl_tpu_torch.core.serialize import (
    as_f32,
    astype,
    decode_parameters,
    dtype_name,
    encode_parameters,
    from_host,
    own_params,
    to_host,
    tree_map_sorted,
)
from p2pfl_tpu_torch.p2p.aggd import SlotEntry
from p2pfl_tpu_torch.parallel.federated import staleness_scale

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
        self.aggregator = aggregator or FedAvg()
        #: a ``privacy.secagg.PairwiseMasker``: entries are masked trees
        self.masker = masker
        #: the async close quorum as a share of the train set (1.0: the
        #: synchronous close, full coverage or the timeout)
        self.min_received = float(min_received)
        #: the staleness discount's exponent (0: stale weighs as fresh)
        self.staleness_beta = float(staleness_beta)
        #: an ``adversary.ReputationMonitor`` kept across rounds
        self.reputation = reputation
        #: the owner's round-start params: the delta reference of the
        #: reputation scores and the template a masked sum dequantizes
        #: against
        self.reference: Params | None = None
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

    def set_reference(self, params: Params) -> None:
        """The round-start params (what this node's round trained from)."""
        self.reference = params

    # -- state ----------------------------------------------------------
    @property
    def covered(self) -> frozenset[int]:
        out: frozenset[int] = frozenset()
        for key in self.models:
            out = out | key
        return out

    def timed_out(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline

    @property
    def async_mode(self) -> bool:
        return self.min_received < 1.0

    def quorum(self) -> int:
        """The covered count that closes an async round (the whole train
        set in sync mode)."""
        n = len(self.train_set)
        if not self.async_mode:
            return n
        return max(1, math.ceil(self.min_received * n))

    def quorum_met(self) -> bool:
        """The round closes: the async quorum, or in sync mode (quorum =
        the train set) full coverage."""
        return bool(self.train_set) and (
            len(self.covered & self.train_set) >= self.quorum())

    def _discounted(self, weight: float, staleness: float) -> float:
        """``weight`` scaled by the staleness discount of an update
        ``staleness`` rounds behind."""
        if staleness > 0.0 and self.staleness_beta > 0.0:
            return float(weight) * float(
                staleness_scale(staleness, self.staleness_beta))
        return weight

    # -- adding models ---------------------------------------------------
    def add_model(self, params: Params, contributors, weight: float,
                  staleness: float = 0.0) -> tuple[int, ...]:
        """The contributors now covered (empty: rejected). ``staleness``,
        in rounds behind, discounts the weight (see the module doc)."""
        return self._add_model(params, contributors,
                               self._discounted(weight, staleness))

    def _add_model(self, params: Params, contributors,
                   weight: float) -> tuple[int, ...]:
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
            self._evict_entry(self.models[key])
            del self.models[key]
        self.models[contrib] = (params, float(weight))
        self._partial_memo.clear()
        if self.quorum_met():
            self._finish()
        return tuple(sorted(self.covered))

    def _evict_entry(self, entry) -> None:
        """``entry`` (a ``(params, weight)``) is about to be superseded;
        ``SidecarSession`` releases its slot here."""

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
        if self.models and (self.quorum_met() or self.timed_out()):
            self._finish()
            return True
        return False

    def _finish(self) -> None:
        keys = list(self.models)
        if (self.masker is None and self.reputation is not None
                and self.reference is not None and len(self.models) >= 3):
            # scored before the fuse: a first-round attacker is cut at
            # once (under 3 entries the cohort statistics mean nothing)
            self.reputation.observe_entries(
                self.reference, [(k, p) for k, (p, _) in self.models.items()])
        params, _, total = self._aggregate(list(self.models.values()),
                                           keys=keys)
        if self.masker is not None:
            # the quorum's close is the one place masked bits become a
            # model: the evicted members' residue out, then dequantized
            from p2pfl_tpu_torch.privacy.secagg import SecaggError

            if self.reference is None:
                raise SecaggError(
                    "masked session closed without a round-start "
                    "reference (set_reference) to dequantize against"
                )
            params, _ = self.masker.unmask(params, total, self.covered,
                                           self.reference)
        self.result = (own_params(params), tuple(sorted(self.covered)))
        self.done.set()

    def _aggregate(self, entries,
                   keys=None) -> tuple[Params, tuple[int, ...], float]:
        if len(entries) == 1:
            p, w = entries[0]
            return p, (), w
        if self.masker is not None:
            # the weights are folded into the masked integers: the exact
            # modular sum, no reweighting (partials stay masked)
            from p2pfl_tpu_torch.privacy.secagg import masked_sum

            tree, total = masked_sum(entries)
            return tree, (), total
        weights = self._weights(entries, keys)
        if type(self.aggregator) is FedAvg:
            tree, total = fuse_numpy([p for p, _ in entries], weights)
        else:
            tree = _stacked_aggregate(self.aggregator,
                                      [p for p, _ in entries], weights)
            total = float(weights.sum())
        return tree, (), total

    def _weights(self, entries, keys) -> np.ndarray:
        """The entries' effective weights: the stored (staleness-scaled)
        weights, times ``entry_scales`` at a finish with reputation."""
        weights = np.asarray([w for _, w in entries], np.float32)
        if keys is not None and self.reputation is not None:
            weights = weights * self.reputation.entry_scales(keys)
        return weights

    def clear(self) -> None:
        """Reset for the next round."""
        self.models.clear()
        self._partial_memo.clear()
        self.reference = None
        self.train_set = frozenset()
        self.waiting = False
        self.result = None
        self.done = asyncio.Event()
        self._deadline = None


class SidecarSession(AggregationSession):
    """The aggregation session with its payloads in the sidecar's arena
    (``p2p/aggd.py``). The node drives it as the inline session, plus
    ``add_slot`` for a payload the protocol reader landed in a slot and
    ``add_blob`` for one that arrived as bytes when the arena was full:

    - entries are ``SlotEntry`` markers (undecoded bytes in the arena)
      or raw envelopes, never decoded trees: the loop never touches a
      payload;
    - ``_finish`` sends the fuse to the worker and completes when the
      reply comes; ``check_and_run`` answers False meanwhile, and the
      store is frozen (a late entry is refused and its slot released);
    - partial gossip serves the node's own model alone: the schema
      holds the sidecar to a full mesh, where every update reaches every
      aggregator from its origin;
    - a dead or stalled worker falls back to an in-process fuse of the
      same entries with the same function, off the loop, and counts it
      in the client's ``fallbacks``.
    """

    def __init__(self, aggregator: Aggregator | None = None,
                 timeout_s: float = 60.0, reputation=None,
                 min_received: float = 1.0, staleness_beta: float = 0.0,
                 client=None, spawn=None):
        super().__init__(aggregator, timeout_s=timeout_s,
                         reputation=reputation, min_received=min_received,
                         staleness_beta=staleness_beta)
        #: the host's ``aggd.SidecarClient`` (one a process)
        self.client = client
        #: a task spawner, the node's ``_track_task(coro, what)``; None
        #: when a test drives the session without a node
        self._spawn = spawn
        # the node's own trained model, decoded, for partial gossip
        self._own: tuple[Params, tuple[int, ...], float] | None = None
        self._fusing = False
        self._fuse_task = None

    # -- adding models ---------------------------------------------------
    def _entry(self, blob) -> Any:
        """``blob`` in a leased slot (a ``SlotEntry``), or the bytes
        themselves when the arena cannot take it."""
        lease = self.client.lease(len(blob)) if self.client else None
        if lease is None:
            return bytes(blob)
        slot, mv = lease
        mv[:len(blob)] = blob
        return SlotEntry(slot, len(blob))

    def _release_rejected(self, entry) -> None:
        if isinstance(entry, SlotEntry):
            self.client.release(entry.slot)

    def add_model(self, params: Params, contributors, weight: float,
                  staleness: float = 0.0) -> tuple[int, ...]:
        """The node's own model (and a waiting node's adoption, as the
        inline session): encoded into a leased slot, so every entry of a
        fuse is in the arena when it can be."""
        if self.waiting:
            return super().add_model(params, contributors, weight, staleness)
        weight = self._discounted(weight, staleness)
        contrib = tuple(int(i) for i in contributors)
        entry = self._entry(encode_parameters(params, contrib,
                                              max(1, int(weight))))
        covered = self._add_model(entry, contrib, weight)
        if covered:
            self._own = (params, contrib, float(weight))
        else:
            self._release_rejected(entry)
        return covered

    def add_slot(self, slot: int, length: int, contributors,
                 weight: float, staleness: float = 0.0) -> tuple[int, ...]:
        """A payload left undecoded in slot ``slot``: the session owns
        the lease from here (a refused entry's slot is released now, an
        accepted one's when its fuse or ``clear`` consumes it). A stale
        fold discounts the weight alone: the bytes stay undecoded."""
        covered = self._add_model(SlotEntry(slot, length), contributors,
                                  self._discounted(weight, staleness))
        if not covered and self.client is not None:
            self.client.release(slot)
        return covered

    def add_blob(self, blob, contributors, weight: float,
                 staleness: float = 0.0) -> tuple[int, ...]:
        """A payload that arrived as bytes (the arena was full when the
        reader asked): still never decoded here; a slot freed since may
        take it, else the bytes go to the worker in the descriptor."""
        entry = self._entry(blob)
        covered = self._add_model(entry, contributors,
                                  self._discounted(weight, staleness))
        if not covered:
            self._release_rejected(entry)
        return covered

    def _add_model(self, params, contributors, weight):
        if not self.waiting and (self._fusing or self.done.is_set()):
            # the round is closing: a superseding eviction now could
            # release a slot the worker is reading
            return ()
        return super()._add_model(params, contributors, weight)

    def _evict_entry(self, entry) -> None:
        p, _w = entry
        if isinstance(p, SlotEntry) and self.client is not None:
            self.client.release(p.slot)

    # -- partial aggregation for a peer ----------------------------------
    def get_partial_aggregation(self, peer_has):
        """The node's own model alone (see the class's note)."""
        if self._own is None:
            return None
        params, contribs, weight = self._own
        if {int(i) for i in peer_has} & set(contribs):
            return None
        return params, contribs, weight

    # -- completion -------------------------------------------------------
    def check_and_run(self) -> bool:
        if self.done.is_set():
            return True
        if not self._fusing and self.models and (
                self.quorum_met() or self.timed_out()):
            self._finish()
        # False while the fuse is in flight: the gossip loop keeps going
        return self.done.is_set()

    def _finish(self) -> None:
        if self._fusing or self.done.is_set():
            return
        self._fusing = True
        entries = list(self.models.values())
        covered = tuple(sorted(self.covered))
        # the effective weights the worker fuses with (observe_entries
        # needs decoded trees, which this plane never holds)
        weights = self._weights(entries, list(self.models))
        coro = self._fuse_and_close(entries, weights, covered)
        if self._spawn is not None:
            self._spawn(coro, "aggd_fuse")
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (a synchronous test): the in-process fuse
            coro.close()
            params = self._fallback_fuse(entries, weights)
            self._release_entries(entries)
            self._publish(params, covered)
            return
        self._fuse_task = loop.create_task(coro)

    async def _fuse_and_close(self, entries, weights, covered) -> None:
        loop = asyncio.get_running_loop()
        req = []
        for (p, _w), w in zip(entries, weights):
            if isinstance(p, SlotEntry):
                req.append(("s", p.slot, p.length, float(w)))
            else:
                req.append(("b", bytes(p), float(w)))
        out = None
        if self.client is not None:
            out = await self.client.fuse(req,
                                         timeout_s=max(5.0, self.timeout_s))
        if out is not None:
            slot, length, _stats = out
            try:
                payload = await loop.run_in_executor(
                    None, _decode_owned, self.client.view(slot, length))
            finally:
                self.client.release(slot)
            params = payload.params
        else:
            if self.client is not None:
                self.client.fallbacks += 1
            params = await loop.run_in_executor(
                None, self._fallback_fuse, entries, weights)
        self._release_entries(entries)
        self._publish(params, covered)

    def _fallback_fuse(self, entries, weights):
        """The in-process fuse of the session's own entries, with the
        worker's function (a dead or stalled worker, or no loop)."""
        trees = []
        for p, _w in entries:
            if isinstance(p, SlotEntry):
                trees.append(_decode_owned(
                    self.client.view(p.slot, p.length)).params)
            else:
                trees.append(_decode_owned(p).params)
        if len(trees) == 1:
            return trees[0]  # as _aggregate's single entry
        tree, _total = fuse_numpy(trees, weights)
        return tree

    def _release_entries(self, entries) -> None:
        if self.client is None:
            return
        for p, _w in entries:
            if isinstance(p, SlotEntry):
                self.client.release(p.slot)
        # the store still names these slots for its coverage: blank the
        # markers, so clear() cannot release a slot leased again since
        for k, (p, w) in list(self.models.items()):
            if isinstance(p, SlotEntry):
                self.models[k] = (None, w)

    def _publish(self, params, covered) -> None:
        self.result = (own_params(params), covered)
        self.done.set()

    def release_entries(self) -> None:
        """Release every slot this session still holds (the node's stop
        and the round's ``clear``), so an interrupted round strands no
        slot."""
        if self.client is None:
            return
        for k, (p, w) in list(self.models.items()):
            if isinstance(p, SlotEntry):
                self.client.release(p.slot)
                self.models[k] = (None, w)

    def clear(self) -> None:
        self.release_entries()
        super().clear()
        self._own = None
        self._fusing = False
        self._fuse_task = None


def _decode_owned(blob):
    """Decode and copy off the buffer in one executor hop: the slot (or
    blob) behind the decode is free to reuse at once."""
    return decode_parameters(blob).release()
