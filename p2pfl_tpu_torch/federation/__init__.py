"""The port's scenario entry points: ``Scenario`` (the stacked
federation) and ``CrossDeviceScenario`` (the sampled K-of-N
cross-device regime)."""

from p2pfl_tpu_torch.federation.scenario import (
    CrossDeviceScenario,
    Scenario,
    ScenarioResult,
)

__all__ = ["CrossDeviceScenario", "Scenario", "ScenarioResult"]
