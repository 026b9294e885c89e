"""Federation topologies as adjacency matrices.

TPU-native re-design of the reference's TopologyManager
(fedstellar/utils/topologymanager.py): the same four families —
fully-connected (:303-318), ring with optional random "convergence"
extra edges (:213-228), random symmetric/asymmetric (:230-301), and
star for CFL (:121-125) — produced as numpy boolean adjacency matrices.

The TPU twist: an adjacency matrix is also a **communication schedule**.
``Topology.mixing_matrix`` turns it into a row-stochastic weight matrix
W so one gossip round is ``params' = W @ params`` — executed on device
as a masked all-gather + einsum, or decomposed into ``ppermute`` steps
(see p2pfl_tpu.parallel.transport). Metropolis-Hastings weights make W
doubly stochastic, which is the standard convergence guarantee for
decentralized averaging that the reference's ad-hoc gossip lacks.

A copy of ``p2pfl_tpu/topology/topology.py``, which imports only
numpy: the port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected-or-directed federation graph over ``n`` nodes."""

    adjacency: np.ndarray  # [n, n] bool, no self-loops
    kind: str = "custom"

    def __post_init__(self):
        a = np.asarray(self.adjacency, dtype=bool)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        a = a.copy()
        np.fill_diagonal(a, False)
        object.__setattr__(self, "adjacency", a)

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    def neighbors(self, i: int) -> list[int]:
        """Out-neighbors of node i (topologymanager.py:188-211 equivalent)."""
        return [int(j) for j in np.flatnonzero(self.adjacency[i])]

    def degree(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    def is_symmetric(self) -> bool:
        return bool((self.adjacency == self.adjacency.T).all())

    def is_connected(self) -> bool:
        """Connectivity of the *communication* graph.

        Symmetric graphs: BFS over the edges. Directed graphs: strong
        connectivity (every node reachable from 0 following edges, and 0
        reachable from every node) — a weakly-connected directed gossip
        graph can still starve a node of incoming models.
        """
        if self.is_symmetric():
            return self._reachable_all(self.adjacency)
        return self._reachable_all(self.adjacency) and self._reachable_all(
            self.adjacency.T
        )

    def _reachable_all(self, a: np.ndarray) -> bool:
        seen = np.zeros(self.n, dtype=bool)
        frontier = [0]
        seen[0] = True
        while frontier:
            nxt = []
            for i in frontier:
                for j in np.flatnonzero(a[i]):
                    if not seen[j]:
                        seen[j] = True
                        nxt.append(int(j))
            frontier = nxt
        return bool(seen.all())

    def mixing_matrix(self, scheme: str = "metropolis") -> np.ndarray:
        """Row-stochastic gossip weight matrix (incl. self-loop weights).

        - ``metropolis``: W_ij = 1/(1+max(d_i,d_j)) for edges; doubly
          stochastic on symmetric graphs.
        - ``uniform``: average self with all neighbors equally — the
          reference's implicit FedAvg-over-neighborhood behavior
          (node.py:411-422 train_set = neighbors + self).
        """
        a = self.adjacency
        n = self.n
        if scheme == "metropolis":
            d = a.sum(axis=1)
            w = np.zeros((n, n), dtype=np.float64)
            ii, jj = np.nonzero(a)
            w[ii, jj] = 1.0 / (1.0 + np.maximum(d[ii], d[jj]))
            np.fill_diagonal(w, 1.0 - w.sum(axis=1))
        elif scheme == "uniform":
            w = a.astype(np.float64)
            np.fill_diagonal(w, 1.0)
            w = w / w.sum(axis=1, keepdims=True)
        else:
            raise ValueError(f"unknown mixing scheme {scheme!r}")
        return w

    def to_dict(self) -> dict:
        """JSON-able export (3-D topology export analog,
        topologymanager.py:320-355)."""
        return {
            "kind": self.kind,
            "n": self.n,
            "edges": [[int(i), int(j)] for i, j in zip(*np.nonzero(self.adjacency))],
        }

    def to_3d(self, seed: int = 0, geo: "np.ndarray | None" = None) -> dict:
        """3-D topology export (topologymanager.py:320-355): nodes on a
        unit sphere (deterministic Fibonacci lattice — uniform without
        randomness) plus optional geo coordinates, edges as index
        pairs. Rendered by the dashboard or any three.js-style viewer."""
        n = self.n
        k = np.arange(n, dtype=np.float64) + 0.5
        phi = np.arccos(1.0 - 2.0 * k / n)
        theta = np.pi * (1.0 + 5.0**0.5) * k
        xyz = np.stack(
            [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
             np.cos(phi)],
            axis=1,
        )
        out = {
            "kind": self.kind,
            "n": n,
            "nodes": [
                {"id": int(i), "x": round(float(x), 4),
                 "y": round(float(y), 4), "z": round(float(z), 4)}
                for i, (x, y, z) in enumerate(xyz)
            ],
            "edges": [
                [int(i), int(j)]
                for i, j in zip(*np.nonzero(self.adjacency)) if i < j
            ],
        }
        if geo is None:
            geo = geo_coordinates(n, seed=seed)
        for node, (lat, lon) in zip(out["nodes"], geo):
            node["lat"] = round(float(lat), 4)
            node["lon"] = round(float(lon), 4)
        return out

    @staticmethod
    def from_dict(d: dict) -> "Topology":
        a = np.zeros((d["n"], d["n"]), dtype=bool)
        for i, j in d["edges"]:
            a[i, j] = True
        return Topology(a, kind=d.get("kind", "custom"))


#: named lat/lon boxes for random node placement — the reference drops
#: participants into Spain or Switzerland for its monitoring map
#: (topologymanager.py:151-173)
GEO_BOUNDS = {
    "spain": (36.0, 43.5, -9.0, 3.0),
    "switzerland": (45.9, 47.8, 6.0, 10.5),
}


def geo_coordinates(n: int, seed: int = 0,
                    region: str = "spain") -> np.ndarray:
    """Random-but-deterministic per-node geo coordinates ``[n, 2]``
    (lat, lon) inside a named region (topologymanager.py:151-173's
    random Spain/Switzerland coordinates, seeded for reproducibility)."""
    if region not in GEO_BOUNDS:
        raise ValueError(
            f"unknown region {region!r}; have {sorted(GEO_BOUNDS)}"
        )
    lat0, lat1, lon0, lon1 = GEO_BOUNDS[region]
    rng = np.random.default_rng(seed)
    lat = rng.uniform(lat0, lat1, size=n)
    lon = rng.uniform(lon0, lon1, size=n)
    return np.stack([lat, lon], axis=1)


def fully_connected(n: int) -> Topology:
    a = np.ones((n, n), dtype=bool)
    return Topology(a, kind="fully")


def ring(n: int, convergence_edges: int = 0, seed: int = 0) -> Topology:
    """Bidirectional ring, optionally with extra random chords.

    Mirrors topologymanager.py:213-228 (watts_strogatz(n, 2, 0) == a
    ring; plus random convergence edges).
    """
    a = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = True
    a[(idx + 1) % n, idx] = True
    free = n * (n - 1) // 2 - int(np.triu(a, 1).sum())  # non-edges available
    if convergence_edges > free:
        raise ValueError(
            f"ring(n={n}) can take at most {free} extra edges, "
            f"asked for {convergence_edges}"
        )
    rng = np.random.default_rng(seed)
    added = 0
    while added < convergence_edges:
        i, j = rng.integers(0, n, size=2)
        if i != j and not a[i, j]:
            a[i, j] = a[j, i] = True
            added += 1
    return Topology(a, kind="ring")


def random_topology(
    n: int, prob: float = 0.5, symmetric: bool = True, seed: int = 0
) -> Topology:
    """Erdős–Rényi-style random graph, retried until connected
    (topologymanager.py:230-301 semantics: symmetric or directed)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        a = rng.random((n, n)) < prob
        np.fill_diagonal(a, False)
        if symmetric:
            a = np.triu(a, 1)
            a = a | a.T
        t = Topology(a, kind="random")
        if t.is_connected():
            return t
    raise RuntimeError(f"could not draw a connected random topology (n={n}, p={prob})")


def star(n: int, center: int = 0) -> Topology:
    """Hub-and-spoke for CFL; node ``center`` is the server
    (topologymanager.py:121-125)."""
    a = np.zeros((n, n), dtype=bool)
    a[center, :] = True
    a[:, center] = True
    a[center, center] = False
    return Topology(a, kind="star")


def generate_topology(kind: str, n: int, **kwargs) -> Topology:
    """Factory by name — mirrors the controller CLI's
    ``--topology {fully,ring,random,star}`` (app/main.py:11-40)."""
    kinds = {
        "fully": fully_connected,
        "ring": ring,
        "random": random_topology,
        "star": star,
    }
    key = kind.lower()
    if key not in kinds:
        raise ValueError(f"unknown topology {kind!r}; have {sorted(kinds)}")
    return kinds[key](n, **kwargs)


def metropolis_weights(adjacency: np.ndarray) -> np.ndarray:
    """Standalone helper: Metropolis-Hastings mixing weights."""
    return Topology(adjacency).mixing_matrix("metropolis")
