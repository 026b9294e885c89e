"""Device-level profiling below ``node.fit``: phases, MFU, memory.

The counterpart of ``p2pfl_tpu/obs/devprof.py``, with its modes, span
names and status keys. The critical-path plane (obs.critpath) attributes
round wall to fit/wire/wait/agg, but ``fit`` stays a black box. This
module opens that box two ways, both gated on ``P2PFL_DEVPROF``:

**gauges** (``P2PFL_DEVPROF=1``): the cheap, always-safe level. After
every fit the learner computes a live MFU / achieved-TFLOPs gauge (the
FLOP count of obs.cost_model over the measured fit wall) and the
memory watermarks, and stows them in ``devprof_last`` for the status
publisher. Nothing touches the training path: the fit's wall ends at
the device-to-host copy of the trained params, the one synchronize a
``TorchLearner`` fit already makes, and the only added work is the
once-per-shape FLOP count (cached) and two gauge reads per fit.

**step** (``P2PFL_DEVPROF=step``): explicit opt-in step profiling. The
fit runs the SAME step functions (``StepFns.prepare_epoch``,
``forward``, ``backward``, ``apply_update``; ``train_one_epoch`` is
built from them) with a synchronize of the learner's device closing
each phase's span, where the JAX package drains with
``block_until_ready``:

- ``devprof.data``: the epoch's shuffle and batch layout,
- ``devprof.forward``: the forward pass and the loss (the autograd
  graph is built here, so the backward recomputes nothing),
- ``devprof.backward``: ``torch.autograd.grad`` alone (K1's dgrad, K2
  and K3 in the FEMNIST CNN),
- ``devprof.update``: the optimizer update (K4 under SGD),
- ``devprof.accum``: the epilogue: the epoch's loss and the learner's
  device-to-host copy of the trained params.

The kernels run as they do in a fused fit (a CUDA tensor never takes a
plain version), and the split fit computes the fused fit's bits. Every
span measures work the fit executes once, so the phases sum to the
wrapping ``learner.fit`` span up to the host's own overhead (the same
<= 10% gate as critpath's components against the round wall). On a card
shared by several nodes of one process, each synchronize waits for the
whole device; the learner's device lock (held through fits,
evaluations and parameter loads) keeps that this node's work.

Spans ride the existing Tracer: disabled tracing keeps the shared
NULL_SPAN no-allocation path, and devprof itself is one env read per
fit when off.
"""

from __future__ import annotations

import os
import threading
from typing import Any

import torch

from p2pfl_tpu_torch.obs import cost_model
from p2pfl_tpu_torch.obs.trace import get_tracer

ENV_VAR = "P2PFL_DEVPROF"

# span names the step level records (perf_report joins on them)
PHASE_SPANS = ("devprof.data", "devprof.forward", "devprof.backward",
               "devprof.update", "devprof.accum")


def mode() -> str:
    """``off`` / ``gauges`` / ``step`` from ``P2PFL_DEVPROF``. Read per
    call: fits happen at round cadence, not frame cadence, so an env
    read is free and keeps child processes config-less."""
    raw = os.environ.get(ENV_VAR, "")
    if raw in ("", "0", "off"):
        return "off"
    return "step" if raw == "step" else "gauges"


def enabled() -> bool:
    return mode() != "off"


def step_enabled() -> bool:
    return mode() == "step"


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------
# phase-split fit (step level)
# ---------------------------------------------------------------------

def profiled_epoch(learner, x, y, mask):
    """One epoch of ``learner``'s fit through its step functions' phases,
    each closed by a synchronize inside its span. Returns ``(state,
    metrics)`` with ``train_epochs``' ``{"loss", "loss_per_epoch"}``
    contract at one epoch; the learner adopts the state exactly as on
    the fused path."""
    tracer = get_tracer()
    fns, dev = learner.fns, x.device
    state = learner.state
    with tracer.span("devprof.data"):
        bx, by, bm = fns.prepare_epoch(state, x, y, mask)
        _drain(dev)
    steps = int(bx.shape[1])
    loss_sum = torch.zeros(x.shape[0], device=dev)
    for i in range(steps):
        with tracer.span("devprof.forward"):
            loss, leaves = fns.forward(state.params, bx[:, i], by[:, i],
                                       bm[:, i])
            _drain(dev)
        with tracer.span("devprof.backward"):
            grads = fns.backward(state.params, leaves, loss)
            _drain(dev)
        with tracer.span("devprof.update"):
            state = fns.apply_update(state, grads, None)
            _drain(dev)
        loss_sum = loss_sum + loss.detach()
    with tracer.span("devprof.accum"):
        loss = loss_sum / steps
        metrics = {"loss": loss, "loss_per_epoch": loss[None]}
        _drain(dev)
    return state, metrics


# ---------------------------------------------------------------------
# live gauges (gauges + step levels)
# ---------------------------------------------------------------------

# (id(fns), shard shape, batch) -> one epoch's FLOPs; learners sharing a
# SharedTrainer hit the same entry, so the count runs once (the lock:
# the nodes of one process count from their executor threads)
_FLOPS_CACHE: dict[tuple, float | None] = {}
_FLOPS_LOCK = threading.Lock()


def fit_flops(learner) -> float | None:
    """Cached one-epoch FLOPs for one learner (obs.cost_model's count
    through the plain versions; see its docstring)."""
    memo = getattr(learner, "_devprof_flops", None)
    if memo is not None:
        return memo or None  # 0.0 sentinel = counted, unknown
    try:
        shape = tuple(getattr(learner.data.x, "shape",
                              (len(learner.data.x),)))
    except Exception:
        shape = ()
    key = (id(learner.fns), shape, learner.batch_size)
    with _FLOPS_LOCK:
        if key not in _FLOPS_CACHE:
            _FLOPS_CACHE[key] = cost_model.learner_fit_flops(learner)
        flops = _FLOPS_CACHE[key]
    learner._devprof_flops = flops or 0.0
    return flops


def fit_gauges(learner, wall_s: float, epochs: int) -> dict[str, Any]:
    """The ``devprof_*`` status gauges for one completed fit: measured
    wall, achieved TFLOPs and MFU (against one device: a TorchLearner
    fit runs on one), and the memory watermarks."""
    out: dict[str, Any] = {"devprof_fit_s": round(wall_s, 4)}
    flops = fit_flops(learner)
    if flops and wall_s > 0:
        achieved = flops * max(epochs, 1) / wall_s
        out["devprof_tflops"] = round(achieved / 1e12, 4)
        util = cost_model.mfu(flops * max(epochs, 1), wall_s, n_devices=1,
                              device=learner.device)
        if util is not None:
            out["devprof_mfu"] = round(util, 4)
    out.update(cost_model.memory_watermark(learner.device))
    return out


def round_gauges(flops: float | None, wall_s: float, n_devices: int,
                 device: Any | None = None) -> dict[str, Any]:
    """Federation-plane gauges: one stacked round over ``n_devices``
    (the scenario drivers publish the same number for every node:
    utilization is a property of the shared round)."""
    out: dict[str, Any] = {"devprof_fit_s": round(wall_s, 4)}
    if flops and wall_s > 0:
        out["devprof_tflops"] = round(flops / wall_s / 1e12, 4)
        util = cost_model.mfu(flops, wall_s, n_devices=n_devices,
                              device=device)
        if util is not None:
            out["devprof_mfu"] = round(util, 4)
    out.update(cost_model.memory_watermark(device))
    return out
