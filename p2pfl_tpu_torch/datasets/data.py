"""Federated dataset views: per-node shards and node-stacked arrays.

The counterpart of ``p2pfl_tpu/datasets/data.py``: ``FederatedDataset``
and ``NodeData`` for the stacked federation, ``CrossDeviceData`` for
the sampled cross-device regime. Host arrays stay numpy — the same seed
gives the same shards and cohorts as the JAX package — and the caller
moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from p2pfl_tpu_torch.config.schema import DataConfig
from p2pfl_tpu_torch.datasets.partition import (
    ClientPartition,
    lazy_partition_indices,
    partition_indices,
)
from p2pfl_tpu_torch.datasets.sources import DatasetSplits, get_dataset


@dataclasses.dataclass
class NodeData:
    """One node's shard."""

    x: np.ndarray
    y: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray

    @property
    def n_samples(self) -> int:  # the node's FedAvg weight
        return len(self.x)


@dataclasses.dataclass
class FederatedDataset:
    """All shards of a federation, ragged (per node) and stacked."""

    name: str
    num_classes: int
    input_shape: tuple[int, ...]
    nodes: list[NodeData]
    x_test: np.ndarray
    y_test: np.ndarray
    synthetic: bool = False

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def stacked(self, pad_to: int | None = None):
        """Pad each node's train shard to a common size and stack.

        Returns ``(x, y, mask, n_samples)`` with shapes
        ``[n, S, ...], [n, S], [n, S], [n]``. Padding rows are masked
        out of the loss and, being weight 0, out of FedAvg.
        """
        sizes = [nd.n_samples for nd in self.nodes]
        s = pad_to or max(sizes)
        if s < max(sizes):
            raise ValueError(f"pad_to={s} < largest shard {max(sizes)}")
        n = self.n_nodes
        x = np.zeros((n, s) + self.input_shape, np.float32)
        y = np.zeros((n, s), np.int32)
        mask = np.zeros((n, s), bool)
        for i, nd in enumerate(self.nodes):
            k = nd.n_samples
            x[i, :k] = nd.x
            y[i, :k] = nd.y
            mask[i, :k] = True
        return x, y, mask, np.asarray(sizes, np.int32)

    @staticmethod
    def make(config: DataConfig, n_nodes: int,
             splits: DatasetSplits | None = None) -> "FederatedDataset":
        """Build federated shards per the DataConfig partition scheme."""
        if splits is None:
            sizes = (
                (config.synthetic_train, config.synthetic_test or 4000)
                if config.synthetic_train else None
            )
            splits = get_dataset(config.dataset, seed=config.seed,
                                 synthetic_sizes=sizes,
                                 profile=config.surrogate_profile)
        parts = partition_indices(
            splits.y_train, n_nodes, scheme=config.partition,
            seed=config.seed, alpha=config.dirichlet_alpha,
            groups=splits.writer_train,
        )
        nodes = []
        for node_i, idx in enumerate(parts):
            # shuffle before capping: sorted/dirichlet partitions come
            # label-ordered, and an unshuffled head slice is one label
            rng = np.random.default_rng(config.seed * 100003 + node_i)
            idx = rng.permutation(idx)
            if config.samples_per_node is not None:
                idx = idx[: config.samples_per_node]
            n_val = int(len(idx) * config.val_percent)
            val_idx, train_idx = idx[:n_val], idx[n_val:]
            nodes.append(NodeData(
                x=splits.x_train[train_idx],
                y=splits.y_train[train_idx],
                x_val=splits.x_train[val_idx],
                y_val=splits.y_train[val_idx],
            ))
        return FederatedDataset(
            name=splits.name,
            num_classes=splits.num_classes,
            input_shape=splits.input_shape,
            nodes=nodes,
            x_test=splits.x_test,
            y_test=splits.y_test,
            synthetic=splits.synthetic,
        )


@dataclasses.dataclass
class CrossDeviceData:
    """Cross-device dataset view: a client is its row in a lazy
    :class:`ClientPartition`. Arrays materialize per round, only for the
    sampled clients, padded to one fixed ``shard_size`` so that every
    round's cohort batch has the same shapes. No per-client validation
    split: quality is measured on the shared test set."""

    name: str
    num_classes: int
    input_shape: tuple[int, ...]
    x_train: np.ndarray
    y_train: np.ndarray
    part: ClientPartition
    x_test: np.ndarray
    y_test: np.ndarray
    shard_size: int  # fixed pad target for every materialized shard
    seed: int = 0
    synthetic: bool = False

    @property
    def n_clients(self) -> int:
        return self.part.n_clients

    @property
    def client_sizes(self) -> np.ndarray:
        """Cap-clamped per-client sample counts: the FedAvg weights and
        the weighted-sampling distribution."""
        return np.minimum(self.part.sizes(), self.shard_size)

    def cohort_sizes(self, client_ids: np.ndarray) -> np.ndarray:
        """``client_sizes[client_ids]`` in O(k), int32."""
        return np.minimum(self.part.take_sizes(client_ids),
                          self.shard_size).astype(np.int32)

    def cohort_buffers(self, k: int):
        """Host buffers for a ``k``-client ``cohort_batch(out=...)``."""
        s = self.shard_size
        return (np.zeros((k, s) + self.input_shape, np.float32),
                np.zeros((k, s), np.int32),
                np.zeros((k, s), bool),
                np.zeros((k,), np.int32))

    def cohort_batch(self, client_ids: np.ndarray, out=None):
        """The sampled clients' shards padded to ``shard_size``: ``(x
        [k,S,...], y [k,S], mask [k,S], n_samples [k])``. Each client's
        rows go through a shuffle seeded ``seed * 100003 + cid`` before
        the cap. ``out`` (a ``cohort_buffers(k)`` tuple, or arrays of
        those shapes) is filled in place with the same values."""
        k = len(client_ids)
        s = self.shard_size
        if out is None:
            x, y, mask, sizes = self.cohort_buffers(k)
        else:
            x, y, mask, sizes = out
            x[:k] = 0.0
            y[:k] = 0
            mask[:k] = False
            sizes[:k] = 0
        for j, cid in enumerate(client_ids):
            idx = self.part.client_indices(int(cid))
            rng = np.random.default_rng(self.seed * 100003 + int(cid))
            idx = rng.permutation(idx)[:s]
            m = len(idx)
            x[j, :m] = self.x_train[idx]
            y[j, :m] = self.y_train[idx]
            mask[j, :m] = True
            sizes[j] = m
        return x, y, mask, sizes

    @staticmethod
    def make(config: DataConfig, n_clients: int) -> "CrossDeviceData":
        """The lazy N-client view per the DataConfig scheme.
        ``samples_per_node`` caps (and so fixes) the shard size; without
        it the pad target is the largest client shard."""
        sizes = (
            (config.synthetic_train, config.synthetic_test or 4000)
            if config.synthetic_train else None
        )
        splits = get_dataset(config.dataset, seed=config.seed,
                             synthetic_sizes=sizes,
                             profile=config.surrogate_profile)
        part = lazy_partition_indices(
            splits.y_train, n_clients, scheme=config.partition,
            seed=config.seed, alpha=config.dirichlet_alpha,
        )
        largest = int(part.sizes().max())
        shard = (
            min(config.samples_per_node, largest)
            if config.samples_per_node is not None else largest
        )
        return CrossDeviceData(
            name=splits.name,
            num_classes=splits.num_classes,
            input_shape=splits.input_shape,
            x_train=splits.x_train,
            y_train=splits.y_train,
            part=part,
            x_test=splits.x_test,
            y_test=splits.y_test,
            shard_size=shard,
            seed=config.seed,
            synthetic=splits.synthetic,
        )
