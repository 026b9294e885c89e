"""The socket launcher's child processes and its supervisor, on the CPU.

- ``launch`` runs a scenario with an adversary, reputation, DP, async
  aggregation and node checkpoints in child processes: their status
  records carry the JAX package's privacy keys and each node's trust,
  and every node's checkpoint file is written.
- With ``--max-restarts 1`` a child SIGKILLed once its node saved its
  round-0 checkpoint is spawned again with ``--resume`` (the sync close rule: the
  survivors' open round waits for it), it rejoins, and every group exits
  0 with every node at the last round.
- The restart backoff doubles from its base and is capped at 30 s.

Every deadline that is not under test is wide.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.config.schema import ScenarioConfig as JScenarioConfig
from p2pfl_tpu.p2p import launch as jlaunch
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.obs import flight
from p2pfl_tpu_torch.p2p.launch import launch, restart_backoff_delay


@pytest.fixture(autouse=True)
def _flight_into_tmp(tmp_path):
    """The port's flight recorder dumps (a crash, a dead peer's
    eviction) into the test's directory, and is emptied after."""
    rec = flight.get_recorder()
    rec.configure(dump_dir=tmp_path / "flight")
    yield
    rec.dump_dir = None
    rec.clear()


pytestmark = [
    pytest.mark.filterwarnings("error::ResourceWarning"),
    pytest.mark.filterwarnings("error:.*was never awaited:RuntimeWarning"),
]

LIMIT = 300


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_restart_backoff_doubles_and_is_capped():
    assert [restart_backoff_delay(1.0, a) for a in (1, 2, 3, 4)] == \
        [1.0, 2.0, 4.0, 8.0]
    assert restart_backoff_delay(1.0, 6) == 30.0
    assert restart_backoff_delay(0.25, 3) == 1.0
    assert restart_backoff_delay(20.0, 2) == 30.0


def _launch_cfg(tmp_path, **raw):
    base = {
        "name": "launched", "n_nodes": 3, "topology": "fully",
        "data": {"dataset": "mnist", "samples_per_node": 60},
        "training": {"rounds": 2, "learning_rate": 0.05},
        "protocol": {"heartbeat_period_s": 0.2,
                     "aggregation_timeout_s": 60.0,
                     "vote_timeout_s": 10.0},
        "elastic": {"async_aggregation": True, "min_received": 0.5,
                    "staleness_beta": 0.5},
        "checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_every": 1,
    }
    base.update(raw)
    cfg = ScenarioConfig.from_dict(base)
    path = tmp_path / "scenario.json"
    cfg.save(path)
    return cfg, path


def test_launch_runs_the_adversarial_private_async_scenario(tmp_path):
    cfg, path = _launch_cfg(
        tmp_path,
        adversary={"nodes": [2], "kind": "signflip", "reputation": True},
        privacy={"dp": True, "clip_norm": 1.0, "noise_multiplier": 0.5},
        log_dir=str(tmp_path / "logs"))
    res = launch(cfg, path, platform="cpu", nodes_per_proc=3, timeout=LIMIT)
    assert sorted(r["node"] for r in res) == [0, 1, 2]
    assert all(r["round"] == 2 and r["restarts"] == 0 for r in res)
    want = jlaunch._privacy_status(
        JScenarioConfig.from_dict(json.loads(cfg.to_json())), 2)
    from p2pfl_tpu_torch.utils.monitor import read_statuses

    recs = read_statuses(tmp_path / "logs" / "launched" / "status")
    assert [r["node"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert r["dp_epsilon"] == want["dp_epsilon"]
        assert 0.0 <= r["trust"] <= 1.0
    for i in range(3):
        assert (tmp_path / "ckpt" / f"node_{i:03d}.ckpt.msgpack").is_file()


def _children(config: pathlib.Path) -> dict[int, list[str]]:
    """pid -> argv of the live launcher children of ``config``."""
    out = {}
    for d in pathlib.Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            argv = (d / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        argv = [a.decode() for a in argv if a]
        if str(config) in argv and "--node" in argv:
            out[int(d.name)] = argv
    return out


def test_the_supervisor_respawns_a_killed_child_with_resume(tmp_path):
    """Three children of one node each, the sync close rule; the child of
    node 1 is SIGKILLed once node 1 has saved its round-0 checkpoint, and the
    supervisor spawns it again with ``--resume``: it adopts its
    checkpoint (or a newer STATE_SYNC), the survivors' open round takes
    its update, and every group exits 0."""
    cfg, path = _launch_cfg(
        tmp_path, training={"rounds": 4, "learning_rate": 0.05},
        protocol={"heartbeat_period_s": 0.2, "aggregation_timeout_s": 120.0,
                  "vote_timeout_s": 5.0, "node_timeout_s": 2.0,
                  "gossip_exit_on_equal_rounds": 60},
        elastic={"heartbeat_retry_limit": 40,
                 "heartbeat_backoff_base_s": 0.2,
                 "heartbeat_backoff_max_s": 0.5},
        log_dir=str(tmp_path / "logs"))
    box: dict = {}

    def run():
        try:
            box["res"] = launch(cfg, path, platform="cpu", max_restarts=1,
                                restart_backoff_s=0.2, timeout=LIMIT)
        except BaseException as e:  # noqa: BLE001 - reported below
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    # node 1's round-0 checkpoint: it is in round 1 now, and the others'
    # round 1 waits for its update under the sync close
    ckpt = tmp_path / "ckpt" / "node_001.ckpt.msgpack"
    killed = None
    deadline = time.monotonic() + LIMIT
    while killed is None and time.monotonic() < deadline and t.is_alive():
        if ckpt.exists():
            for pid, argv in _children(path).items():
                if argv[argv.index("--node") + 1] == "1":
                    os.kill(pid, signal.SIGKILL)
                    killed = pid
        time.sleep(0.01)
    t.join(LIMIT)
    assert killed is not None
    assert "err" not in box, box.get("err")
    res = {r["node"]: r for r in box["res"]}
    assert sorted(res) == [0, 1, 2]
    assert res[1]["restarts"] == 1
    assert res[0]["restarts"] == res[2]["restarts"] == 0
    assert all(r["round"] == 4 for r in res.values())
    assert not _children(path)  # every child reaped
    assert np.isfinite(res[1]["accuracy"])
