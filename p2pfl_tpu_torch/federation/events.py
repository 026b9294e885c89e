"""In-process event bus: a copy of ``p2pfl_tpu/federation/events.py``.

``Scenario``, ``CrossDeviceScenario`` and ``Membership`` are
``Observable``: an observer (an ``Observer`` or any callable taking
``(event, payload)``) added with ``add_observer`` is called
synchronously, in the order observers were added, for every event.
"""

from __future__ import annotations

import enum
from typing import Any, Callable


class Events(enum.Enum):
    ROUND_STARTED = "round_started"
    TRAIN_FINISHED = "train_finished"
    AGGREGATION_FINISHED = "aggregation_finished"
    ROUND_FINISHED = "round_finished"
    NODE_DIED = "node_died"  # heartbeat timeout or eviction
    NODE_RECOVERED = "node_recovered"
    NODE_JOINED = "node_joined"  # a join fault: recover + state transfer
    LEADERSHIP_TRANSFERRED = "leadership_transferred"
    LEARNING_FINISHED = "learning_finished"
    METRICS_REPORTED = "metrics_reported"
    CHECKPOINT_SAVED = "checkpoint_saved"
    LINK_PARTITIONED = "link_partitioned"
    LINK_HEALED = "link_healed"
    NODE_RESTARTED = "node_restarted"


class Observer:
    """Receives events."""

    def update(self, event: Events, payload: Any = None) -> None:
        raise NotImplementedError


class Observable:
    """Synchronous fan-out to registered observers; callables are
    accepted too: ``obs(event, payload)``."""

    def __init__(self):
        self._observers: list[Observer | Callable] = []

    def add_observer(self, obs: Observer | Callable) -> None:
        self._observers.append(obs)

    def get_observers(self) -> list:
        return list(self._observers)

    def notify(self, event: Events, payload: Any = None) -> None:
        for obs in self._observers:
            if isinstance(obs, Observer):
                obs.update(event, payload)
            else:
                obs(event, payload)
