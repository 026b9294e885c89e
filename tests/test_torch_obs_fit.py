"""The port's FLOP count, devprof and the scenario's observability, on
the CPU.

- ``cost_model.learner_fit_flops`` against the JAX package's count of
  the same fit (mnist-mlp and the FEMNIST CNN, one node, the same shard
  and batch). The port counts the products of its plain versions (2 x M
  x N x K each) and nothing elementwise; XLA's ``cost_analysis`` also
  counts the elementwise work (activations, the loss, the optimizer)
  and its own lowering of the convolutions. So the two agree within 15%
  (mnist-mlp reads about 12% under XLA, the CNN about 6% over), while
  the port's CNN count equals the analytic product count exactly.
- The count never touches the learner's tensors: it runs one step on
  fake CPU tensors, so a learner's count does not depend on where its
  tensors live, and the cache answers the second learner of a shared
  trainer.
- ``P2PFL_DEVPROF=step``: the split fit gives the fused fit's params
  bit for bit (the same step functions), and its five phases sum to
  the ``learner.fit`` span within 10% (the JAX package's gate).
- Gauges: ``devprof_last`` after a fit (MFU under ``P2PFL_PEAK_FLOPS``),
  nothing with devprof off.
- A ``Scenario`` under ``P2PFL_TRACE`` and ``P2PFL_DEVPROF``: one
  ``scenario.round`` span a round in the exported trace, the
  ``devprof_*`` gauges in every status record from the round's count
  (every node's fit and the mix), ``healthcheck`` exits 0 over its log
  dir; a ``CrossDeviceScenario`` likewise.

Torch is pinned to two threads (several test processes share the CPU).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.config.schema import (
    CrossDeviceConfig,
    DataConfig,
    ModelConfig,
    ScenarioConfig,
    TrainingConfig,
)
from p2pfl_tpu_torch.core.pytree import tree_leaves
from p2pfl_tpu_torch.datasets.data import FederatedDataset
from p2pfl_tpu_torch.federation.scenario import CrossDeviceScenario, Scenario
from p2pfl_tpu_torch.learning.learner import SharedTrainer, TorchLearner
from p2pfl_tpu_torch.models import get_model
from p2pfl_tpu_torch.obs import cost_model, devprof, flight, healthcheck
from p2pfl_tpu_torch.obs.trace import get_tracer
from p2pfl_tpu_torch.utils.monitor import read_statuses

#: one FEMNIST-CNN sample's products, forward and backward (conv1
#: 784x25x32, no dgrad; conv2 196x800x64 with dgrad; dense 3136x2048 and
#: 2048x62, each with dx and dw), 2 FLOPs a multiply-add
CNN_SAMPLE_FLOPS = 2 * (784 * 25 * 32 * 2 + 196 * 800 * 64 * 3
                        + 3136 * 2048 * 3 + 2048 * 62 * 3)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _obs_state(monkeypatch):
    for var in ("P2PFL_TRACE", "P2PFL_DEVPROF", "P2PFL_PEAK_FLOPS"):
        monkeypatch.delenv(var, raising=False)
    yield
    tr = get_tracer()
    tr.configure(enabled=False)
    tr.reset()
    rec = flight.get_recorder()
    rec.dump_dir = None
    rec.clear()


_SHARDS: dict[str, object] = {}


def _shard(dataset: str):
    """One node's shard of 48 samples (32 train), made once a module."""
    if dataset not in _SHARDS:
        _SHARDS[dataset] = FederatedDataset.make(
            DataConfig(dataset=dataset, samples_per_node=48,
                       batch_size=16), 1).nodes[0]
    return _SHARDS[dataset]


def _learner(model="femnist-cnn", dataset="femnist", seed=0, trainer=None,
             **model_kw):
    ln = TorchLearner(model=get_model(model, **model_kw),
                      data=_shard(dataset), learning_rate=0.05, seed=seed,
                      batch_size=16, trainer=trainer, device="cpu")
    ln.init()
    return ln


@pytest.mark.parametrize("model,dataset,lo,hi", [
    ("mnist-mlp", "mnist", 0.85, 1.0),
    ("femnist-cnn", "femnist", 1.0, 1.10),
])
def test_fit_flops_against_the_jax_count(model, dataset, lo, hi):
    from p2pfl_tpu.config.schema import DataConfig as JData
    from p2pfl_tpu.datasets import FederatedDataset as JFed
    from p2pfl_tpu.learning import JaxLearner
    from p2pfl_tpu.models import get_model as j_get_model
    from p2pfl_tpu.obs import cost_model as j_cost

    jfed = JFed.make(JData(dataset=dataset, samples_per_node=48,
                           batch_size=16), 1)  # the port's _shard
    jl = JaxLearner(model=j_get_model(model), data=jfed.nodes[0],
                    learning_rate=0.05, seed=0, batch_size=16)
    jl.init()
    want = j_cost.learner_fit_flops(jl)
    ln = _learner(model, dataset)
    assert len(ln.data.x) == len(jfed.nodes[0].x)
    got = cost_model.learner_fit_flops(ln)
    assert lo <= got / want <= hi, (got, want)
    if model == "femnist-cnn":
        steps = len(ln.data.x) // 16
        assert got == steps * 16 * CNN_SAMPLE_FLOPS


def test_the_count_reads_no_tensor_and_is_cached():
    shared = SharedTrainer(get_model("femnist-cnn", hidden=64),
                           batch_size=16)
    a, b = _learner(trainer=shared), _learner(trainer=shared, seed=3)
    devprof._FLOPS_CACHE.clear()
    first = devprof.fit_flops(a)
    assert len(devprof._FLOPS_CACHE) == 1
    # the second learner of the shared trainer hits the cache
    assert devprof.fit_flops(b) == first
    assert len(devprof._FLOPS_CACHE) == 1
    # the count is of shapes: other weights give the same number
    tree_leaves(a.state.params)[0].mul_(3.0)
    assert cost_model.learner_fit_flops(a) == first
    # linear in the batch: one step at 32 is two epochs' steps at 16
    assert cost_model.step_flops(
        a.fns, a.state.params, a.data.x.shape[1:], torch.float32,
        torch.int64, 32) == first
    assert cost_model.mix_flops(8, 10) == 2.0 * 8 * 8 * 10


def _spans(names):
    out: dict[str, float] = {}
    for name, _lane, _t0, dur, _args in get_tracer().spans():
        if name in names:
            out[name] = out.get(name, 0.0) + dur
    return out


def test_step_mode_fit_is_the_fused_fit_and_its_phases_sum(monkeypatch):
    fused, split = _learner(hidden=256), _learner(hidden=256)
    for ln in (fused, split):
        ln.set_epochs(2)
    fused.fit()
    monkeypatch.setenv("P2PFL_DEVPROF", "step")
    get_tracer().configure(enabled=True)
    split.fit()
    for a, b in zip(tree_leaves(fused.state.params),
                    tree_leaves(split.state.params)):
        assert torch.equal(a, b)
    assert fused.train_losses == split.train_losses
    for a, b in zip(tree_leaves(fused.state.opt_state),
                    tree_leaves(split.state.opt_state)):
        assert torch.equal(a, b)
    spans = _spans(set(devprof.PHASE_SPANS) | {"learner.fit"})
    assert set(spans) == set(devprof.PHASE_SPANS) | {"learner.fit"}
    fit_s = spans.pop("learner.fit")
    phase_s = sum(spans.values())
    assert abs(phase_s - fit_s) / fit_s <= 0.10, (spans, fit_s)
    # step mode also leaves the gauges
    assert split.devprof_last["devprof_fit_s"] > 0


def test_gauges_follow_the_mode(monkeypatch):
    ln = _learner("mnist-mlp", "mnist")
    ln.fit()
    assert ln.devprof_last == {}
    monkeypatch.setenv("P2PFL_DEVPROF", "1")
    monkeypatch.setenv("P2PFL_PEAK_FLOPS", "1e12")
    ln.fit()
    g = ln.devprof_last
    assert {"devprof_fit_s", "devprof_tflops", "devprof_mfu",
            "devprof_rss_peak_mb"} <= set(g)
    flops = devprof.fit_flops(ln)
    assert g["devprof_mfu"] == pytest.approx(
        flops / g["devprof_fit_s"] / 1e12, rel=0.01, abs=1e-4)
    # a CPU learner has no device-memory limit to publish
    assert "devprof_hbm_limit_mb" not in g


def _ring(tmp_path, **kw) -> ScenarioConfig:
    return ScenarioConfig(
        name="obs-ring", federation="DFL", topology="ring", n_nodes=3,
        data=DataConfig(dataset="mnist", samples_per_node=48,
                        batch_size=16, synthetic_test=64),
        model=ModelConfig(model="mnist-mlp"),
        training=TrainingConfig(rounds=2, epochs_per_round=1,
                                learning_rate=0.05),
        transport="dense", wire_dtype="f32", log_dir=str(tmp_path), **kw)


def _trace_events(trace_dir):
    files = sorted(trace_dir.glob("proc*.trace.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def test_a_traced_scenario_publishes_gauges_and_round_spans(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("P2PFL_TRACE", "1")
    monkeypatch.setenv("P2PFL_DEVPROF", "gauges")
    monkeypatch.setenv("P2PFL_PEAK_FLOPS", "1e12")
    sc = Scenario(_ring(tmp_path), device="cpu")
    res = sc.run()
    root = tmp_path / "obs-ring"
    rounds = [e for e in _trace_events(root / "trace")
              if e.get("ph") == "X" and e["name"] == "scenario.round"]
    assert [e["args"]["round"] for e in rounds] == [0, 1]
    # the round's count: every node's fit and the mix
    x = sc._data_args[0]
    fit = cost_model.fit_flops(sc.fns, sc.fed.states.params,
                               tuple(x.shape[2:]), x.dtype, torch.int64,
                               x.shape[1], 16)
    n_params = sum(int(np.prod(p.shape[1:]))
                   for p in tree_leaves(sc.fed.states.params))
    assert sc._devprof_flops == 3 * fit + 2.0 * 9 * n_params
    records = read_statuses(root / "status")
    assert [r["node"] for r in records] == [0, 1, 2]
    for r in records:
        assert r["devprof_fit_s"] > 0 and r["devprof_tflops"] > 0
        assert 0 < r["devprof_mfu"]
        assert r["devprof_mfu"] == records[0]["devprof_mfu"]
    assert healthcheck.main([str(root)]) == 0
    assert len(res.round_times_s) == 2


def test_a_cross_device_scenario_publishes_its_gauges(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("P2PFL_TRACE", str(tmp_path / "trace"))
    monkeypatch.setenv("P2PFL_DEVPROF", "1")
    cfg = ScenarioConfig(
        name="obs-cd", n_nodes=4,
        data=DataConfig(dataset="mnist", samples_per_node=16,
                        batch_size=16, synthetic_train=1024,
                        synthetic_test=32),
        model=ModelConfig(model="mnist-mlp"),
        training=TrainingConfig(rounds=2, epochs_per_round=1,
                                learning_rate=0.05),
        cross_device=CrossDeviceConfig(n_clients=32, clients_per_round=8,
                                       cohort_size=2, seed=1),
        wire_dtype="f32", log_dir=str(tmp_path))
    sc = CrossDeviceScenario(cfg, device="cpu")
    sc.run()
    rounds = [e for e in _trace_events(tmp_path / "trace")
              if e.get("ph") == "X" and e["name"] == "scenario.round"]
    assert len(rounds) == 2
    assert sc._devprof_flops and sc._devprof_flops > 0
    (rec,) = read_statuses(tmp_path / "obs-cd" / "status")
    assert rec["devprof_fit_s"] > 0 and rec["devprof_tflops"] > 0
