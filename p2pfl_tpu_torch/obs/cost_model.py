"""Honest-FLOP accounting shared by the live gauges and the card's checks.

The counterpart of ``p2pfl_tpu/obs/cost_model.py``: one cost model, so
the live per-node MFU gauge (``obs.devprof``) and whatever else divides
FLOPs by a wall agree on what a FLOP is.

**The count.** The JAX package reads the compiled program's own
``cost_analysis()``. Eager PyTorch has no compiled program, and a
counter of the operators a fit dispatches sees only aten operators: a
fit on the card runs K1-K3 through the compiled extension, so such a
count would miss the FEMNIST CNN's products there and read them on the
CPU. So the count never watches the real fit. :func:`step_flops` runs
ONE training step of the same step functions on fake CPU tensors
(``FakeTensorMode``: shapes and dtypes, no storage, no arithmetic) at the
fit's batch. On CPU tensors every kernel wrapper takes its plain
version, whose products are aten ``bmm``/``mm`` calls, and a dispatch
mode adds up what ``torch.utils.flop_counter``'s formulas give each of
them (2 x M x N x K a product; elementwise work counts 0, where XLA's
analysis counts it too). The count is therefore the same number on the
card and on the CPU, whatever implements each product.

The JAX package's scan-collapse correction (``cost_analysis`` counts a
``lax.scan`` body once) has no counterpart in an eager loop. Its probe
at the samples an epoch uses does: :func:`fit_flops` is one step's count
times the epoch's steps (``steps x batch`` samples, drop-remainder),
exact because every counted product is linear in the batch.

The peak table and the watermark reader live here too, so every MFU and
memory number of the port shares one denominator: ``chip_smoke.py``
takes its bounds from :data:`PEAKS`.
"""

from __future__ import annotations

import os
from typing import Any

# published dense peaks of the H100 family (NVIDIA data sheets), by a
# substring of the card's name: bytes/s of device memory, bf16 FLOP/s,
# f32 (non-tensor) FLOP/s, TF32 FLOP/s. Looked up most specific first.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12, 378e12),
    "H100": (3.35e12, 989e12, 67e12, 495e12),  # SXM
    "H200": (4.8e12, 989e12, 67e12, 495e12),
}
_LOOKUP_ORDER = ("H100 PCIe", "H200", "H100")

ENV_PEAK = "P2PFL_PEAK_FLOPS"  # per-device override (tests, odd parts)


def card_peaks(name: str) -> tuple[float, float, float, float] | None:
    """The :data:`PEAKS` row of the card named ``name``; None off the
    table."""
    for key in _LOOKUP_ORDER:
        if key in name:
            return PEAKS[key]
    return None


def peak_flops(device: Any | None = None) -> float | None:
    """Per-device bf16 peak FLOP/s, or None off the table (the CPU).
    ``P2PFL_PEAK_FLOPS`` overrides: how tests exercise the MFU arithmetic
    without a card, and how an unlisted part gets a denominator without
    a code change. ``device`` is a ``torch.device`` (or its string);
    None means the first CUDA device when there is one."""
    env = os.environ.get(ENV_PEAK)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    row = card_peaks(torch.cuda.get_device_name(device))
    return row[1] if row else None


# ---------------------------------------------------------------------
# the FLOP count: one step on fake CPU tensors
# ---------------------------------------------------------------------

def _counting_mode():
    """A dispatch mode that sums ``torch.utils.flop_counter``'s formula
    for every operator that has one (``FlopCounterMode`` itself tracks
    modules through hooks that ``torch.autograd.grad`` over leaves
    refuses)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    return _Count()


def step_flops(fns: Any, params: Any, x_shape: tuple, x_dtype: Any,
               y_dtype: Any, batch: int) -> float:
    """FLOPs of ONE training step of ``fns`` (a ``StepFns``) for ONE node
    at ``batch`` samples of ``x_shape`` (one sample's shape). ``params``
    gives the leaves' shapes and dtypes (any leading node axis is
    replaced by 1; the tensors themselves are never read). Runs the step
    on fake CPU tensors, so the wrappers take their plain versions."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from p2pfl_tpu_torch.core.pytree import tree_map
    from p2pfl_tpu_torch.learning.learner import TrainState

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = tree_map(
            lambda p: torch.empty((1,) + tuple(p.shape[1:]), dtype=p.dtype,
                                  device="cpu"), params)
        state = TrainState(params=fake, opt_state=fns.init_opt_state(fake),
                           rng=None,
                           step=torch.zeros(1, dtype=torch.int64))
        bx = torch.empty((1, batch) + tuple(x_shape), dtype=x_dtype)
        by = torch.zeros((1, batch), dtype=y_dtype)
        bm = torch.ones((1, batch), dtype=torch.bool)
        with _counting_mode() as count:
            fns.train_step(state, bx, by, bm)
    return float(count.total)


def fit_flops(fns: Any, params: Any, x_shape: tuple, x_dtype: Any,
              y_dtype: Any, n_samples: int, batch_size: int) -> float:
    """FLOPs of one epoch of one node over a shard of ``n_samples``: the
    step's count at the fit's batch times the epoch's steps (the epoch
    of ``make_step_fns``: ``min(batch_size, n_samples)`` a step,
    drop-remainder)."""
    bsz = min(int(batch_size), int(n_samples))
    if bsz <= 0:
        return 0.0
    steps = int(n_samples) // bsz
    return steps * step_flops(fns, params, x_shape, x_dtype, y_dtype, bsz)


def _torch_dtype(np_dtype: Any):
    import numpy as np
    import torch

    return torch.from_numpy(np.zeros(1, dtype=np_dtype)).dtype


def learner_fit_flops(learner: Any) -> float | None:
    """Honest FLOPs of ONE epoch of a ``TorchLearner`` fit (its shard,
    its batch size, its step functions); None before ``init`` or when
    the count fails (a model whose step cannot run on fake CPU
    tensors). Callers cache (obs.devprof does)."""
    if learner.state is None or learner.data is None or learner.fns is None:
        return None
    x, y = learner.data.x, learner.data.y
    try:
        return fit_flops(learner.fns, learner.state.params,
                         tuple(x.shape[1:]), _torch_dtype(x.dtype),
                         _torch_dtype(y.dtype), len(x), learner.batch_size)
    except Exception:
        return None


def mix_flops(n_nodes: int, n_params: int) -> float:
    """FLOPs of the stacked round's mix: ``[n, n] @ [n, P]``, as XLA
    counts a dot (2 x n x n x P)."""
    return 2.0 * n_nodes * n_nodes * n_params


def mfu(flops: float | None, wall_s: float | None,
        n_devices: int = 1, peak: float | None = None,
        device: Any | None = None) -> float | None:
    """Model-FLOP utilization: achieved FLOP/s over the aggregate peak
    of the devices the work spans. None without a peak (the CPU)."""
    if not flops or not wall_s or wall_s <= 0:
        return None
    peak = peak if peak is not None else peak_flops(device)
    if not peak:
        return None
    return flops / wall_s / (peak * max(int(n_devices), 1))


def memory_watermark(device: Any | None = None) -> dict[str, float]:
    """Peak-memory gauges for a status record: the card's allocator
    high-water (``torch.cuda.max_memory_allocated``) and its total
    memory where ``device`` is (or, for None, a card is) CUDA; the host
    RSS peak always (the CPU's only watermark)."""
    import torch

    out: dict[str, float] = {}
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        device = torch.device(device)
        peak = torch.cuda.max_memory_allocated(device)
        limit = torch.cuda.get_device_properties(device).total_memory
        if peak:
            out["devprof_hbm_peak_mb"] = round(float(peak) / 1e6, 1)
        if limit:
            out["devprof_hbm_limit_mb"] = round(float(limit) / 1e6, 1)
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KiB; darwin reports bytes
        scale = 1024.0 if os.uname().sysname == "Linux" else 1.0
        out["devprof_rss_peak_mb"] = round(ru * scale / 1e6, 1)
    except Exception:
        pass
    return out
