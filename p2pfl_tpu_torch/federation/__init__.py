"""The port's scenario entry points: ``Scenario`` (the stacked
federation) and ``CrossDeviceScenario`` (the sampled K-of-N
cross-device regime), their event bus and the membership clock."""

from p2pfl_tpu_torch.federation.events import Events, Observable, Observer
from p2pfl_tpu_torch.federation.membership import Membership
from p2pfl_tpu_torch.federation.scenario import (
    CrossDeviceScenario,
    Scenario,
    ScenarioResult,
)

__all__ = [
    "CrossDeviceScenario",
    "Events",
    "Membership",
    "Observable",
    "Observer",
    "Scenario",
    "ScenarioResult",
]
