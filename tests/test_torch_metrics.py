"""Metric logging, status records and the profiled round, on the CPU.

The JAX ``Scenario`` and the port's on one scenario JSON (the f32 tier
of ``test_torch_federation.py``: FEMNIST-CNN at hidden 64, 4 nodes on a
ring, f32 compute and wire, one batch an epoch, the port from the JAX
package's initial weights), each with ``log_dir``:

- the logger's records: the same keys, steps, rounds and nodes in the
  same order; the losses within rtol 1e-5, accuracies equal (the
  resources' and the round times' values are the host's own);
- the per-node CSVs and metrics.jsonl line for line in the same shape;
- TensorBoard (``tensorboard=True``): the same runs, tags and steps;
- the status records: the JAX package's ``read_statuses`` reads the
  port's, whose keys lie inside the JAX package's ``STATUS_KEYS`` (the
  port's registry is the same tuple), with the same roles, rounds,
  peers, leaders and ``recompiles`` 0; under DP both carry the same
  ``dp_epsilon`` and ``dp_epsilon_budget``;
- the cross-device scenario's records and its one status record;
- ``wandb=True`` without the package fails at construction;
- ``profile_dir``: one Chrome trace of the run's second round;
- a resumed run continues the FL-aware global step.
"""

from __future__ import annotations

import csv
import dataclasses
import json

import jax
import numpy as np
import pytest

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation.scenario import CrossDeviceScenario as JaxCrossDev
from p2pfl_tpu.federation.scenario import Scenario as JaxScenario
from p2pfl_tpu.utils import monitor as jmonitor
from p2pfl_tpu.utils.telemetry import resource_snapshot as jax_resources
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax
from p2pfl_tpu_torch.federation.scenario import CrossDeviceScenario, Scenario
from p2pfl_tpu_torch.parallel.federated import reseed_params
from p2pfl_tpu_torch.utils import monitor
from p2pfl_tpu_torch.utils.metrics import MetricsLogger
from p2pfl_tpu_torch.utils.telemetry import resource_snapshot

F32_RTOL = 1e-5
SHARD = 18  # 20 samples a node less the 10% validation split
# values that are the host's own (clock, load), compared by key only
HOST_KEYS = ("ts", "Train/round_time_s")


def _config(directory, **kw) -> jschema.ScenarioConfig:
    return jschema.ScenarioConfig(
        name="logs", federation="DFL", topology="ring", n_nodes=4,
        data=jschema.DataConfig(dataset="femnist", samples_per_node=20,
                                batch_size=SHARD, synthetic_train=2000,
                                synthetic_test=128),
        model=jschema.ModelConfig(model="femnist-cnn", kwargs={"hidden": 64},
                                  compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=2, epochs_per_round=2,
                                        learning_rate=0.05),
        transport="dense", wire_dtype="f32", log_dir=str(directory), **kw)


def _run_both(tmp_path, **kw):
    """The JAX Scenario and the port's, each logging into its own
    directory; the port from the JAX initial weights."""
    jcfg = _config(tmp_path / "jax", **kw)
    jcfg.save(tmp_path / "scenario.json")
    js = JaxScenario(jcfg)
    tcfg = dataclasses.replace(ScenarioConfig.load(tmp_path / "scenario.json"),
                               log_dir=str(tmp_path / "port"))
    ts = Scenario(tcfg, device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    js.run(), ts.run()
    js.close(), ts.close()
    return js, ts


def _assert_same_records(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k in HOST_KEYS or k.startswith("Resources/"):
                continue
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=F32_RTOL, err_msg=k)
            else:
                assert g[k] == v, k


def test_logs_match_jax(tmp_path):
    js, ts = _run_both(tmp_path)
    _assert_same_records(ts.logger.history, js.logger.history)
    assert {r["step"] for r in ts.logger.history} == {2, 4}
    jdir, tdir = tmp_path / "jax" / "logs", tmp_path / "port" / "logs"
    jrows = [json.loads(x) for x in (jdir / "metrics.jsonl").read_text()
             .splitlines()]
    trows = [json.loads(x) for x in (tdir / "metrics.jsonl").read_text()
             .splitlines()]
    _assert_same_records(trows, jrows)
    for i in range(4):
        with open(jdir / f"node_{i}.csv") as f:
            jcsv = list(csv.reader(f))
        with open(tdir / f"node_{i}.csv") as f:
            tcsv = list(csv.reader(f))
        # step, round and metric name per row (ts and values aside)
        assert [r[1:4] for r in tcsv] == [r[1:4] for r in jcsv]
    assert (tdir / "topology_3d.json").read_text() == (
        jdir / "topology_3d.json").read_text()


def test_status_records_match_jax_and_read_through_its_monitor(tmp_path):
    js, ts = _run_both(tmp_path)
    assert monitor.STATUS_KEYS == jmonitor.STATUS_KEYS
    jst = jmonitor.read_statuses(tmp_path / "jax" / "logs" / "status")
    tst = jmonitor.read_statuses(tmp_path / "port" / "logs" / "status")
    assert tst == monitor.read_statuses(tmp_path / "port" / "logs" / "status")
    assert len(tst) == len(jst) == 4
    for t, j in zip(tst, jst):
        assert set(t) <= set(jmonitor.STATUS_KEYS)
        assert set(t) == set(j)
        for k in ("node", "role", "round", "peers", "leader", "trust",
                  "dp_epsilon", "dp_epsilon_budget", "accuracy", "seq"):
            assert t[k] == j[k], k
        assert t["recompiles"] == 0
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=F32_RTOL)


def test_dp_status_carries_epsilon_as_jax(tmp_path):
    """DP-FedAvg (noise 1.0, clip 1.0): the status records' epsilon and
    budget are JAX's (a function of the rounds and the noise alone)."""
    js, ts = _run_both(tmp_path, privacy=jschema.PrivacyConfig(
        dp=True, clip_norm=1.0, noise_multiplier=1.0, delta=1e-5,
        epsilon_budget=8.0))
    jst = jmonitor.read_statuses(tmp_path / "jax" / "logs" / "status")
    tst = monitor.read_statuses(tmp_path / "port" / "logs" / "status")
    assert [s["dp_epsilon"] for s in tst] == [s["dp_epsilon"] for s in jst]
    assert all(s["dp_epsilon"] > 0 and s["dp_epsilon_budget"] == 8.0
               for s in tst)


def _tb_scalars(run_dir) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {tag: [e.step for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_tags_and_steps_match_jax(tmp_path):
    _run_both(tmp_path, tensorboard=True)
    jtb, ttb = tmp_path / "jax" / "logs" / "tb", tmp_path / "port" / "logs" / "tb"
    runs = sorted(p.name for p in jtb.iterdir())
    assert sorted(p.name for p in ttb.iterdir()) == runs
    assert "federation" in runs and "node_3" in runs
    for run in runs:
        assert _tb_scalars(ttb / run) == _tb_scalars(jtb / run), run


def test_cross_device_logs_match_jax(tmp_path):
    raw = jschema.ScenarioConfig(
        name="cd-logs", n_nodes=4,
        data=jschema.DataConfig(dataset="femnist", synthetic_train=2000,
                                synthetic_test=96, samples_per_node=SHARD,
                                batch_size=SHARD),
        model=jschema.ModelConfig(model="femnist-cnn", kwargs={"hidden": 64},
                                  compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=2, epochs_per_round=1,
                                        learning_rate=0.05),
        cross_device=jschema.CrossDeviceConfig(
            n_clients=64, clients_per_round=8, cohort_size=2, seed=1),
        wire_dtype="f32", log_dir=str(tmp_path / "jax"))
    raw.save(tmp_path / "cd.json")
    js = JaxCrossDev(raw)
    ts = CrossDeviceScenario(dataclasses.replace(
        ScenarioConfig.load(tmp_path / "cd.json"),
        log_dir=str(tmp_path / "port")), device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    js.run(), ts.run()
    _assert_same_records(ts.logger.history, js.logger.history)
    jst = jmonitor.read_statuses(tmp_path / "jax" / "cd-logs" / "status")
    tst = jmonitor.read_statuses(tmp_path / "port" / "cd-logs" / "status")
    assert len(tst) == len(jst) == 1
    # the crossdev gauges are the host's own; the record's keys and
    # identity are JAX's
    assert set(tst[0]) == set(jst[0])
    assert {k: tst[0][k] for k in ("node", "role", "round", "peers")} == {
        k: jst[0][k] for k in ("node", "role", "round", "peers")}


def test_resource_snapshot_keys_match_jax():
    assert sorted(resource_snapshot()) == sorted(jax_resources())


def test_wandb_without_the_package_fails_at_construction(tmp_path):
    with pytest.raises(ImportError):  # the package is not installed
        import wandb  # noqa: F401
    with pytest.raises(ImportError):
        MetricsLogger(tmp_path, wandb=True)
    cfg = dataclasses.replace(
        ScenarioConfig.from_dict(json.loads(_config(tmp_path).to_json())),
        wandb=True)
    with pytest.raises(ImportError):
        Scenario(cfg, device="cpu")


def test_a_profiled_cpu_run_leaves_one_trace(tmp_path):
    cfg = ScenarioConfig.from_dict(json.loads(_config(
        tmp_path / "logs", profile_dir=str(tmp_path / "prof")).to_json()))
    cfg = dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, rounds=3))
    sc = Scenario(cfg, device="cpu")
    sc.run()
    traces = list((tmp_path / "prof").iterdir())
    assert traces == [tmp_path / "prof" / "logs_round00001.pt.trace.json"]
    assert sc.profile_path == traces[0]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_a_resumed_run_continues_the_global_step(tmp_path):
    base = json.loads(_config(tmp_path / "logs").to_json())
    base["training"]["rounds"] = 3
    cfg = ScenarioConfig.from_dict(
        {**base, "checkpoint_dir": str(tmp_path / "ck"),
         "checkpoint_every": 2})
    whole = Scenario(cfg, device="cpu")
    whole.run()
    steps = [r["step"] for r in whole.logger.history if r["round"] == 2]
    resumed = Scenario(dataclasses.replace(
        cfg, log_dir=str(tmp_path / "again")), device="cpu")
    assert resumed.fed.round == 2
    resumed.run(rounds=1)
    assert [r["step"] for r in resumed.logger.history] == steps == [6] * len(
        steps)


def test_a_failed_profiled_round_stops_the_profiler(tmp_path):
    """An exception inside the profiled round leaves no profiler
    running."""
    import torch

    from p2pfl_tpu_torch.federation.events import Events

    cfg = ScenarioConfig.from_dict(json.loads(_config(
        tmp_path / "logs", profile_dir=str(tmp_path / "prof")).to_json()))
    sc = Scenario(cfg, device="cpu")

    def fail_round_1(event, payload):
        if event is Events.ROUND_STARTED and payload["round"] == 1:
            raise RuntimeError("round 1 fails")

    sc.add_observer(fail_round_1)
    with pytest.raises(RuntimeError, match="round 1 fails"):
        sc.run()
    assert sc.profile_path is None
    assert not torch.autograd._profiler_enabled()
