"""Membership: heartbeats, timeouts and eviction on a virtual clock.

A copy of ``p2pfl_tpu/federation/membership.py``. Time is a virtual
clock the round loop advances (one heartbeat period a round), so a
scripted fault gives the same alive masks in every run. Beating nodes
are seen at every period boundary; a node silent for longer than
``node_timeout_s`` turns suspect (alive False, ``NODE_DIED``). The
suspect/probe machine (``probes_due``, ``probe_failed``, ``evict``,
``amnesty``) is the socket plane's death detection, copied so that both
packages keep one state machine. Every transition is recorded in the
flight recorder (``obs/flight.py``) under the JAX package's kinds
(``membership.suspect``, ``.recover``, ``.join``, ``.restart``,
``.partition``, ``.heal``, ``.amnesty``, ``.probe_failed``, ``.evict``).
"""

from __future__ import annotations

import numpy as np

from p2pfl_tpu_torch.config.schema import FaultEvent, ProtocolConfig
from p2pfl_tpu_torch.federation.events import Events, Observable
from p2pfl_tpu_torch.obs import flight


class Membership(Observable):
    """Tracks ``last_seen`` per node and derives the alive mask.

    ``beat(i, t)`` is a heartbeat from node i at time t.
    ``advance_to(t)`` moves the clock, synthesizes the beats of the
    nodes still beating (``virtual=True``) and marks nodes silent for
    longer than ``node_timeout_s`` suspect. ``apply_fault`` stops or
    resumes a node's heartbeats. A suspect is probed under exponential
    backoff (``backoff_base_s * 2^k``, capped at ``backoff_max_s``) and
    after ``retry_limit`` failed probes the caller ``evict``s it, which
    is sticky against later beats until a recover, join or ``heal``.
    """

    def __init__(self, n_nodes: int, protocol: ProtocolConfig | None = None,
                 virtual: bool = True, retry_limit: int = 3,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 8.0):
        super().__init__()
        self.protocol = protocol or ProtocolConfig()
        self.n = n_nodes
        self.virtual = virtual
        self.last_seen = np.zeros(n_nodes, np.float64)
        self.beating = np.ones(n_nodes, bool)  # currently emitting beats
        self.alive = np.ones(n_nodes, bool)  # membership view
        self.departed = np.zeros(n_nodes, bool)  # sticky evictions
        self.clock = 0.0
        self.retry_limit = int(retry_limit)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.probe_failures = np.zeros(n_nodes, np.int64)
        self.next_probe = np.full(n_nodes, np.inf, np.float64)

    def beat(self, node: int, t: float | None = None) -> None:
        if self.departed[node]:
            # a late beat does not resurrect an evicted node
            return
        t = self.clock if t is None else t
        self.last_seen[node] = t
        self.probe_failures[node] = 0
        self.next_probe[node] = np.inf
        if not self.alive[node]:
            self.alive[node] = True
            flight.record("membership.recover", node=node, t=t)
            self.notify(Events.NODE_RECOVERED, {"node": node, "t": t})

    def apply_fault(self, fault: FaultEvent) -> None:
        if fault.kind == "crash":
            self.beating[fault.node] = False
        elif fault.kind in ("recover", "join", "restart"):
            # "join" is recover here; the state transfer is the caller's
            self.departed[fault.node] = False
            self.beating[fault.node] = True
            self.beat(fault.node)
            if fault.kind == "join":
                flight.record("membership.join", node=fault.node,
                              t=self.clock)
                self.notify(Events.NODE_JOINED,
                            {"node": fault.node, "t": self.clock})
            elif fault.kind == "restart":
                flight.record("membership.restart", node=fault.node,
                              t=self.clock)
                self.notify(Events.NODE_RESTARTED,
                            {"node": fault.node, "t": self.clock})
        elif fault.kind == "partition":
            # the cut itself lives in the transport
            flight.record("membership.partition", groups=fault.groups,
                          t=self.clock)
            self.notify(Events.LINK_PARTITIONED,
                        {"groups": fault.groups, "t": self.clock})
        elif fault.kind == "heal":
            for node in np.flatnonzero(self.departed):
                self.amnesty(int(node))
            flight.record("membership.heal", t=self.clock)
            self.notify(Events.LINK_HEALED, {"t": self.clock})
        else:
            raise ValueError(f"unknown fault kind {fault.kind!r}")

    def amnesty(self, node: int, t: float | None = None) -> None:
        """Clear a sticky departure: the node re-enters as a suspect
        with a fresh probe budget and a probe due now (it is not
        declared alive)."""
        t = self.clock if t is None else t
        if not self.departed[node] and self.alive[node]:
            return
        self.departed[node] = False
        self.probe_failures[node] = 0
        self.next_probe[node] = t
        flight.record("membership.amnesty", node=node, t=t)

    def probes_due(self, t: float | None = None) -> list[int]:
        """Suspects whose next reconnect probe is due at ``t``."""
        t = self.clock if t is None else t
        return [
            int(i) for i in range(self.n)
            if (not self.alive[i] and not self.departed[i]
                and self.probe_failures[i] < self.retry_limit
                and t >= self.next_probe[i])
        ]

    def probe_failed(self, node: int, t: float | None = None) -> bool:
        """Record one failed probe and schedule the next; True when the
        retry budget is spent (the caller then evicts)."""
        t = self.clock if t is None else t
        self.probe_failures[node] += 1
        k = int(self.probe_failures[node])
        flight.record("membership.probe_failed", node=node, k=k,
                      final=k >= self.retry_limit)
        if k >= self.retry_limit:
            return True
        delay = min(self.backoff_base_s * (2.0 ** k), self.backoff_max_s)
        self.next_probe[node] = t + delay
        return False

    def advance_to(self, t: float) -> np.ndarray:
        """Advance the clock to ``t``; returns the alive mask."""
        period = self.protocol.heartbeat_period_s
        if self.virtual:
            # the beats the beating nodes sent in (clock, t], vectorized
            # over every node (the cross-device clock spans all clients)
            self.last_seen = np.where(
                self.beating,
                np.maximum(self.last_seen, (t // period) * period),
                self.last_seen,
            )
        self.clock = t
        timeout = self.protocol.node_timeout_s
        died = np.flatnonzero(self.alive & (t - self.last_seen > timeout))
        if len(died):
            self.alive[died] = False
            self.probe_failures[died] = 0
            self.next_probe[died] = t + self.backoff_base_s
            for node in died:  # one event a node, in index order
                flight.record("membership.suspect", node=int(node), t=t)
                self.notify(Events.NODE_DIED, {"node": int(node), "t": t})
        return self.alive.copy()

    def evict(self, node: int) -> None:
        """Immediate, sticky departure (a STOP announcement)."""
        self.departed[node] = True
        self.beating[node] = False
        self.next_probe[node] = np.inf
        flight.record("membership.evict", node=node, t=self.clock)
        if self.alive[node]:
            self.alive[node] = False
            self.notify(Events.NODE_DIED, {"node": node, "t": self.clock})

    def get_nodes(self) -> list[int]:
        """The current members."""
        return [int(i) for i in np.flatnonzero(self.alive)]
