"""Test harness: force an 8-device virtual CPU mesh.

Multi-chip TPU hardware is not available in CI; the sharded federation
paths are validated on 8 virtual CPU devices (the driver separately
dry-run-compiles the multi-chip path via __graft_entry__.dryrun_multichip).

This must run before JAX initializes a backend, hence the top-level
os.environ mutation in conftest (pytest imports conftest first).
"""

import os
import pathlib

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent XLA compile cache: the suite is compile-dominated (the
# vmapped round programs recompile identically every run), so warm
# runs skip most of the wall-clock. Separate dir from the TPU bench
# cache (.jax_cache) to keep either side prunable on its own.
# Min-compile-time 0: the suite's wall-clock is the SUM of hundreds
# of sub-second compiles, so the default 1s floor would persist
# almost none of it.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache_cpu"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    # tier-1 wall audit: always report the 10 slowest tests so a
    # creeping suite wall names its culprits in every run (an explicit
    # --durations=N on the command line wins)
    if not getattr(config.option, "durations", None):
        config.option.durations = 10
        config.option.durations_min = 1.0
    config.addinivalue_line(
        "markers",
        "slowtier: minutes-long redundancy-coverage tests, skipped "
        "unless P2PFL_SLOW_TESTS=1 (their mechanisms have faster "
        "in-suite guards; see each test's docstring)",
    )
    config.addinivalue_line(
        "markers",
        "adversary: attack-injection / reputation / robustness tests "
        "(select with -m adversary)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); "
        "skipped without one",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("P2PFL_SLOW_TESTS", "0") not in ("", "0"):
        return
    skip = pytest.mark.skip(
        reason="slow tier — set P2PFL_SLOW_TESTS=1 to run"
    )
    for item in items:
        if "slowtier" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def n_devices():
    n = len(jax.devices())
    assert n == 8, f"expected 8 virtual CPU devices, got {n}"
    return n
