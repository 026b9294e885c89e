"""Phase 8b's f32 step check of ``chip_smoke.py``, on the CPU.

``chip_smoke.check_f32_grads`` holds every leaf's gradient of an f32
training step (a zero trace, so the new trace is the gradient) against
the step in f64 that takes the same max-pool and ReLU decisions, in
relative L2 node by node, and needs the plain step with K1 and K3 one
TF32 pass (the control) to fall outside the limit. Here, on the FEMNIST
CNN at full width with 2 nodes and batches of 8:

- the f64 step that replays its own decisions gives its own gradients
  (to f64 rounding: a bias sum may take another order), so the replay
  adds nothing of its own;
- the kernel step (on CPU tensors the wrappers' plain versions) and the
  plain f32 step lie within ``F32_GRAD_TOL``;
- the control's worst leaf lies outside it, and it takes more
  decisions otherwise than the f64 step than the f32 step does.
"""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from p2pfl_tpu_torch.federation.scenario import Scenario  # noqa: E402


@pytest.fixture(scope="module", params=[0, 1])
def ring(request):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "BATCH", 8)
    cfg = cs.ring_config(f"f32-gate-{request.param}", n=2,
                         seed=request.param, model={"compute_dtype": "float32"})
    sc = Scenario(cfg, device=torch.device("cpu"))
    yield sc
    mp.undo()


def test_f64_replay_of_its_own_decisions_gives_its_gradients(ring):
    x, y, mask, _ = ring._data_args
    b = cs.BATCH
    state = ring.fed.states
    args = (ring.model, state, x[:, :b], y[:, :b], mask[:, :b],
            ring.config.training.learning_rate, ring.config.training.momentum)
    seen = []
    free = cs.plain_step(*args, f64=True, record=seen)[3]
    assert len(seen) == 5  # two convs' ReLU and pool, dense1's ReLU
    replay = cs.plain_step(*args, f64=True, taken=seen)[3]
    for a, r in zip(free, replay):
        assert a.dtype == torch.float64
        assert float((a - r).norm() / a.norm()) <= 1e-14


def test_f32_steps_within_the_limit_and_the_tf32_control_outside(ring):
    r = cs.f32_grad_readings(ring, ring.fed.states, 0)
    kernel, plain, control = (r[arm]["vs f64"] for arm in
                              ("kernel", "plain_f32", "tf32_control"))
    assert len(kernel) == len(cs.FEMNIST_CNN_LEAVES)
    assert kernel == plain  # on the CPU both are the plain versions
    assert max(max(leaf) for leaf in plain) <= cs.F32_GRAD_TOL
    assert max(max(leaf) for leaf in control) > cs.F32_GRAD_TOL
    assert r["tf32_control"]["flips"] > r["plain_f32"]["flips"]
