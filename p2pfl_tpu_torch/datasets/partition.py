"""Federated partitioning of a dataset across N nodes.

Reference semantics reproduced:
- ``iid``: contiguous equal ranges after a seeded shuffle
  (mnist.py:100-118 — ``rows_by_sub = floor(len/number_sub)``,
  node i takes rows [i*k, (i+1)*k)).
- ``sorted``: label-sort the dataset *then* contiguous ranges, giving
  each node a few labels only (mnist.py:76-83 non-IID flag).
- ``dirichlet``: per-class Dirichlet(α) allocation across nodes — the
  standard non-IID benchmark knob (BASELINE.json: "non-IID Dirichlet
  shards"), absent in the reference.

All return ``list[np.ndarray]`` of row indices, length N.

``lazy_partition_indices`` returns the same allocation laws as a
:class:`ClientPartition` (two arrays) for the cross-device regime's
10k-1M clients.

A copy of ``p2pfl_tpu/datasets/partition.py``. It imports only numpy,
so the two packages partition identically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Dirichlet partitions at/above this width take the vectorized
# assignment path (see dirichlet_partition's seed contract note)
_DIRICHLET_VECTORIZE_AT = 512


def iid_partition(labels: np.ndarray, n_nodes: int, seed: int = 0) -> list[np.ndarray]:
    n = len(labels)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    per = n // n_nodes
    return [order[i * per : (i + 1) * per] for i in range(n_nodes)]


def sorted_partition(labels: np.ndarray, n_nodes: int, seed: int = 0) -> list[np.ndarray]:
    order = np.argsort(labels, kind="stable")
    per = len(labels) // n_nodes
    return [order[i * per : (i + 1) * per] for i in range(n_nodes)]


def _dirichlet_assign(
    labels: np.ndarray, n_nodes: int, alpha: float, rng: np.random.Generator,
    min_per_node: int = 2, max_tries: int = 100,
) -> np.ndarray:
    """Vectorized Dirichlet allocation: one ``node_of[sample]`` array
    per attempt instead of ``classes x n_nodes`` Python list segments.

    Same allocation law as the legacy loop — per class, a shuffled
    index list cut at ``cumsum(Dirichlet(α)) * len`` — but the per-node
    ``np.split``/append/concatenate churn (the O(classes × N × retries)
    term that dominates setup at N=10k+) is replaced by a single
    ``searchsorted`` per class: position p of class c lands on the node
    whose cut interval contains p, which is exactly the segment
    ``np.split`` would have put it in.
    """
    if len(labels) < n_nodes * min_per_node:
        raise RuntimeError(
            f"dirichlet_partition could not give every node >= {min_per_node} "
            f"samples (n={len(labels)}, nodes={n_nodes}, alpha={alpha}): "
            f"need at least {n_nodes * min_per_node} samples"
        )
    classes = np.unique(labels)
    class_idx = [np.flatnonzero(labels == c) for c in classes]
    node_of = np.empty(len(labels), np.int64)
    # In the sparse regime (few samples per node on average) essentially
    # every draw leaves some node short, so redrawing is futile — fall
    # through to the deterministic repair after a handful of attempts.
    tries = max_tries if len(labels) >= 8 * min_per_node * n_nodes else 3
    for _ in range(tries):
        props = rng.dirichlet([alpha] * n_nodes, size=len(classes))
        for ci, idx in enumerate(class_idx):
            idx = idx.copy()
            rng.shuffle(idx)
            cuts = (np.cumsum(props[ci]) * len(idx)).astype(int)[:-1]
            node_of[idx] = np.searchsorted(
                cuts, np.arange(len(idx)), side="right"
            )
        counts = np.bincount(node_of, minlength=n_nodes)
        if counts.min() >= min_per_node:
            return node_of
    # Repair the last draw instead of failing: move surplus samples
    # (rank >= min_per_node within their node, so no donor ever drops
    # below the floor) from the largest nodes to the deficient ones.
    # Deterministic given the draw, so outputs stay a function of seed.
    deficit = np.maximum(min_per_node - counts, 0)
    total_deficit = int(deficit.sum())
    order = np.argsort(node_of, kind="stable")
    starts = np.zeros(n_nodes, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(len(order), dtype=np.int64) - starts[node_of[order]]
    movable = order[rank >= min_per_node]
    mrank = rank[rank >= min_per_node]
    key = counts[node_of[movable]] * np.int64(len(labels) + 1) + mrank
    sel = movable[np.argsort(-key, kind="stable")[:total_deficit]]
    node_of[sel] = np.repeat(np.arange(n_nodes), deficit)
    return node_of


def dirichlet_partition(
    labels: np.ndarray, n_nodes: int, alpha: float = 0.5, seed: int = 0,
    min_per_node: int = 2,
) -> list[np.ndarray]:
    """Per-class proportions ~ Dirichlet(α); α→∞ is IID, α→0 is 1-class
    nodes. Redraws until every node has ``min_per_node`` samples; the
    vectorized large-N path additionally repairs a short draw by moving
    surplus samples from the largest nodes (redraws can never satisfy
    the floor at e.g. 10k clients on a 60k-sample dataset), raising
    only when ``len(labels) < n_nodes * min_per_node``.

    Seed contract: below ``n_nodes == 512`` the legacy draw order is
    kept, so small-N outputs are byte-identical to every earlier round.
    At ``n_nodes >= 512`` (round 13, cross-device scale) the redraw
    path is vectorized — the Dirichlet rows are drawn in one batched
    call and per-node segments assigned by ``searchsorted`` — which
    consumes the generator in a different order: large-N outputs are
    deterministic in ``seed`` but NOT comparable to what the legacy
    loop would have produced. No prior release supported that width,
    so no stored partition changes.
    """
    rng = np.random.default_rng(seed)
    if n_nodes >= _DIRICHLET_VECTORIZE_AT:
        node_of = _dirichlet_assign(labels, n_nodes, alpha, rng,
                                    min_per_node=min_per_node)
        order = np.argsort(node_of, kind="stable")
        counts = np.bincount(node_of, minlength=n_nodes)
        parts = np.split(order, np.cumsum(counts)[:-1])
        for p in parts:
            rng.shuffle(p)
        return parts
    classes = np.unique(labels)
    for _ in range(100):
        shards: list[list[np.ndarray]] = [[] for _ in range(n_nodes)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_nodes)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for node, part in enumerate(np.split(idx, cuts)):
                shards[node].append(part)
        parts = [np.concatenate(s) if s else np.empty(0, np.int64) for s in shards]
        if min(len(p) for p in parts) >= min_per_node:
            for p in parts:
                rng.shuffle(p)
            return parts
    raise RuntimeError(
        f"dirichlet_partition could not give every node >= {min_per_node} "
        f"samples (n={len(labels)}, nodes={n_nodes}, alpha={alpha})"
    )


def writer_partition(groups: np.ndarray, n_nodes: int,
                     seed: int = 0) -> list[np.ndarray]:
    """LEAF-style natural non-IID: whole writers (source groups) are
    assigned to nodes, so every node inherits its writers' class skew
    and style — the reference's FEMNIST is partitioned exactly this
    way (femnist.py: one LEAF writer bundle per participant)."""
    rng = np.random.default_rng(seed)
    writers = rng.permutation(np.unique(groups))
    if len(writers) < n_nodes:
        raise ValueError(
            f"writer partition needs >= 1 writer per node: "
            f"{len(writers)} writers < {n_nodes} nodes"
        )
    assignment = {w: i % n_nodes for i, w in enumerate(writers)}
    node_of = np.vectorize(assignment.get, otypes=[np.int64])(groups)
    return [np.flatnonzero(node_of == i) for i in range(n_nodes)]


def partition_indices(
    labels: np.ndarray, n_nodes: int, scheme: str = "iid", seed: int = 0,
    alpha: float = 0.5, groups: np.ndarray | None = None,
) -> list[np.ndarray]:
    """Factory by scheme name (DataConfig.partition)."""
    if scheme == "iid":
        return iid_partition(labels, n_nodes, seed)
    if scheme in ("sorted", "non-iid", "noniid"):
        return sorted_partition(labels, n_nodes, seed)
    if scheme == "dirichlet":
        return dirichlet_partition(labels, n_nodes, alpha=alpha, seed=seed)
    if scheme == "writer":
        if groups is None:
            raise ValueError(
                "partition='writer' needs per-sample writer ids "
                "(dataset provides none)"
            )
        return writer_partition(groups, n_nodes, seed)
    raise ValueError(f"unknown partition scheme {scheme!r}")


# --------------------------------------------------------------------
# Lazy cross-device partition: index-on-demand at N=10k+
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientPartition:
    """Partition of a dataset across N clients without N eager arrays:
    ``order`` (every sample index, grouped by owning client) and
    ``offsets`` (``[n_clients + 1]`` group boundaries). A client's
    indices are an O(1) slice view, taken only when it is sampled."""

    order: np.ndarray  # [n_samples] sample indices grouped by client
    offsets: np.ndarray  # [n_clients + 1] int64 group boundaries

    @property
    def n_clients(self) -> int:
        return len(self.offsets) - 1

    def client_indices(self, client: int) -> np.ndarray:
        """Sample indices owned by ``client`` (a view, not a copy)."""
        return self.order[self.offsets[client]:self.offsets[client + 1]]

    def sizes(self) -> np.ndarray:
        """Per-client shard sizes, ``[n_clients]``."""
        return np.diff(self.offsets)

    def take_sizes(self, client_ids: np.ndarray) -> np.ndarray:
        """Shard sizes of just ``client_ids`` (any shape), O(k)."""
        ids = np.asarray(client_ids, np.int64)
        return self.offsets[ids + 1] - self.offsets[ids]


def _partition_from_assignment(node_of: np.ndarray,
                               n_clients: int) -> ClientPartition:
    order = np.argsort(node_of, kind="stable")
    counts = np.bincount(node_of, minlength=n_clients)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return ClientPartition(order=order, offsets=offsets)


def lazy_partition_indices(
    labels: np.ndarray, n_clients: int, scheme: str = "iid", seed: int = 0,
    alpha: float = 0.5, min_per_client: int = 1,
) -> ClientPartition:
    """:func:`partition_indices` twin for the cross-device regime: the
    same allocation laws as a :class:`ClientPartition`. Within-client
    order is not shuffled here (dirichlet is label-grouped);
    ``CrossDeviceData`` shuffles each client when it materializes it.
    A sparse dirichlet draw (too few samples a client for any redraw
    to give everyone ``min_per_client``) is repaired deterministically;
    it raises only when ``len(labels) < n_clients * min_per_client``."""
    n = len(labels)
    if scheme in ("iid", "sorted", "non-iid", "noniid"):
        per = n // n_clients
        if per < min_per_client:
            raise ValueError(
                f"{n} samples over {n_clients} clients gives {per} "
                f"per client < min_per_client={min_per_client}"
            )
        if scheme == "iid":
            order = np.random.default_rng(seed).permutation(n)
        else:
            order = np.argsort(labels, kind="stable")
        offsets = np.arange(n_clients + 1, dtype=np.int64) * per
        return ClientPartition(order=order[: per * n_clients],
                               offsets=offsets)
    if scheme == "dirichlet":
        rng = np.random.default_rng(seed)
        node_of = _dirichlet_assign(labels, n_clients, alpha, rng,
                                    min_per_node=min_per_client)
        return _partition_from_assignment(node_of, n_clients)
    raise ValueError(
        f"unknown cross-device partition scheme {scheme!r}; "
        "have ('iid', 'sorted', 'dirichlet')"
    )
