"""Federated dataset views: per-node shards and node-stacked arrays.

The counterpart of ``p2pfl_tpu/datasets/data.py`` (``FederatedDataset``
and ``NodeData`` only; the cross-device view is not ported yet). Host
arrays stay numpy — the same seed gives the same shards as the JAX
package — and the caller moves ``stacked()`` to its device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from p2pfl_tpu_torch.config.schema import DataConfig
from p2pfl_tpu_torch.datasets.partition import partition_indices
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
