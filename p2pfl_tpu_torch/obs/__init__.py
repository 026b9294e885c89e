"""Run-time observability: the span/counter tracer, the flight recorder,
the shared timestamped-record shape, and the tools that read them back
(``traceview``, ``critpath``, ``perf_report``, ``healthcheck``).

The counterpart of ``p2pfl_tpu/obs/``, with its span, counter and
flight-event names, its file formats, its status keys and its
environment variables (``P2PFL_TRACE``, ``P2PFL_FLIGHT``,
``P2PFL_DEVPROF``, ``P2PFL_PEAK_FLOPS``): one setting drives a fleet that
mixes the two packages, and either package's tools read the other's
files.
"""

from p2pfl_tpu_torch.obs.records import make_record
from p2pfl_tpu_torch.obs.trace import (
    NULL_SPAN,
    Tracer,
    configure,
    configure_from_env,
    get_tracer,
    install_xla_listener,
    reset_xla_counters,
    xla_compile_seconds,
    xla_recompiles,
)

__all__ = [
    "NULL_SPAN",
    "Tracer",
    "configure",
    "configure_from_env",
    "get_tracer",
    "install_xla_listener",
    "make_record",
    "reset_xla_counters",
    "xla_compile_seconds",
    "xla_recompiles",
]
