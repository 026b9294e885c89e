"""The socket plane's chaos layer on the CPU: scripted partitions,
crashes and restarts from a node's own checkpoint through
``run_simulation``, and the fault driver's round-front timing on lossy
links.

- The README's 8-node chaos scenario (halves cut at round 1, node 5
  crashed at 1, heal and restart at 4; async quorum 0.5, a checkpoint a
  round): every node finishes all rounds, the churn record holds one
  partition, one heal, the crash and the restart, a recovery time, and
  node 5 came back with a model (its own checkpoint, or the running
  nodes'); the mean accuracy is within 0.05 of a fault-free twin on the
  same seed (the JAX package's acceptance, ``tests/test_chaos.py``).
  The minority side of the cut closes its rounds on the aggregation
  timeout in both packages, so that timeout is the JAX test's 10-15 s,
  not a wide one.
- On 5%-lossy links every fault fires once a live node has reached the
  fault's round, never earlier.
- A full mesh whose every lane fills (15 MB models, lanes two frames
  deep) keeps draining and finishes: a read loop never waits on a full
  lane (it waited in both packages, and such a fleet deadlocked).
- A read loop's relay onto a full lane waits in the lane's overflow and
  arrives once the lane drains (a vote on a ring is never sent again);
  only a beat or a role is dropped there, and counted.

The launcher's child processes and its supervisor are held in
``tests/test_torch_socket_supervisor.py``.

Every deadline that is not under test is wide.
"""

from __future__ import annotations


import asyncio
import contextlib

import pytest
import torch

from p2pfl_tpu_torch.config.schema import (
    DataConfig,
    ProtocolConfig,
    ScenarioConfig,
)
from p2pfl_tpu_torch.datasets.data import FederatedDataset
from p2pfl_tpu_torch.learning.learner import SharedTrainer, TorchLearner
from p2pfl_tpu_torch.models.mlp import MLP
from p2pfl_tpu_torch.federation import checkpoint as ck
from p2pfl_tpu_torch.p2p import P2PNode
from p2pfl_tpu_torch.p2p.launch import run_simulation
from p2pfl_tpu_torch.p2p.protocol import Message, MsgType

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


def _chaos(name, tmp_path, faults, **over):
    raw = {
        "name": name, "n_nodes": 8, "topology": "fully",
        "data": {"dataset": "mnist", "samples_per_node": 150},
        "training": {"rounds": 6, "epochs_per_round": 1,
                     "learning_rate": 0.1},
        # the cut's minority closes rounds on this timeout (in both
        # packages), so it is the JAX test's, not a wide one
        "protocol": {"heartbeat_period_s": 0.2,
                     "aggregation_timeout_s": 10.0,
                     "vote_timeout_s": 3.0, "node_timeout_s": 1.0},
        # the probe budget burns fast, so cross-cut evictions land while
        # the cut is open and the heal's amnesty has work to do
        "elastic": {"async_aggregation": True, "min_received": 0.5,
                    "staleness_beta": 0.5,
                    "heartbeat_backoff_base_s": 0.05,
                    "heartbeat_backoff_max_s": 0.2},
        "checkpoint_dir": str(tmp_path / name / "ckpt"),
        "checkpoint_every": 1,
        "faults": faults,
    }
    raw.update(over)
    return ScenarioConfig.from_dict(raw)


HALVES = [[0, 1, 2, 3], [4, 5, 6, 7]]
README_FAULTS = [
    {"kind": "partition", "round": 1, "groups": HALVES},
    {"kind": "crash", "node": 5, "round": 1},
    {"kind": "heal", "round": 4},
    {"kind": "restart", "node": 5, "round": 4},
]


def test_the_readme_chaos_scenario_recovers(tmp_path):
    nodes: list = []
    out = run_simulation(_chaos("chaos", tmp_path, README_FAULTS),
                         timeout=LIMIT, device="cpu", nodes_out=nodes)
    assert out["rounds"] == 6
    churn = out["churn"]
    assert churn["partitions"] == 1 and churn["heals"] == 1
    assert churn["crashes"] == [5] and churn["restarted"] == [5]
    assert churn["joined"] == [] and churn["async"] is True
    assert churn["recovery_s"] > 0
    five = nodes[5]
    assert five.resume and five.joiner and five.initialized
    # its own checkpoint when it saved one before the crash, else the
    # running nodes' model (a newer STATE_SYNC or their pushed weights)
    assert five.adopted and set(five.adopted) <= {
        "checkpoint", "state_sync", "initial"}
    # every node saved its final round
    for i in range(8):
        assert ck.load_node_checkpoint(
            tmp_path / "chaos" / "ckpt", i,
            nodes[i].learner.get_parameters())[1] == 6
    clean = run_simulation(_chaos("clean", tmp_path, []), timeout=LIMIT,
                           device="cpu")
    assert clean["rounds"] == 6 and clean["churn"]["crashes"] == []
    assert clean["mean_accuracy"] > 0.4
    assert out["mean_accuracy"] >= clean["mean_accuracy"] - 0.05


def test_faults_fire_on_the_round_front_on_lossy_links(tmp_path,
                                                       monkeypatch):
    """Each fault is applied when a live node has reached its round; on
    lossy links round boundaries spread, and a clock would fire early."""
    nodes: list = []
    fired: list[tuple[str, int, int]] = []

    def front():
        return max(nd.round for nd in nodes if not nd.finished.is_set())

    crash, partition = P2PNode.crash, P2PNode.apply_partition

    async def recording_crash(self):
        fired.append(("crash", 2, front()))
        await crash(self)

    def recording_partition(self, groups):
        if not fired or fired[-1][0] != "partition":
            fired.append(("partition", 1, front()))
        partition(self, groups)

    monkeypatch.setattr(P2PNode, "crash", recording_crash)
    monkeypatch.setattr(P2PNode, "apply_partition", recording_partition)
    faults = [{"kind": "partition", "round": 1, "groups": [[0, 1], [2, 3]]},
              {"kind": "heal", "round": 2},
              {"kind": "crash", "node": 3, "round": 2}]
    cfg = _chaos("lossy", tmp_path, faults, n_nodes=4,
                 training={"rounds": 3, "learning_rate": 0.1},
                 protocol={"heartbeat_period_s": 0.2,
                           "aggregation_timeout_s": 5.0,
                           "vote_timeout_s": 3.0, "node_timeout_s": 1.0},
                 network={"loss_pct": 5.0, "seed": 3})
    out = run_simulation(cfg, timeout=LIMIT, device="cpu", nodes_out=nodes)
    assert out["rounds"] == 3 or nodes[3]._crashed
    assert [k for k, _, _ in fired] == ["partition", "crash"]
    for kind, due, at in fired:
        assert at >= due, (kind, due, at)


def test_a_saturated_full_mesh_keeps_draining():
    n = 4
    data = FederatedDataset.make(
        DataConfig(dataset="mnist", samples_per_node=64), n)
    shared = SharedTrainer(MLP(features=(2048, 1024)), learning_rate=0.05,
                           batch_size=32)
    proto = ProtocolConfig(heartbeat_period_s=0.2, aggregation_timeout_s=60.0,
                           vote_timeout_s=30.0, send_queue_depth=2)
    nodes = [P2PNode(i, TorchLearner(data=data.nodes[i], batch_size=32,
                                     seed=0, trainer=shared, device="cpu"),
                     n_nodes=n, protocol=proto, gossip_period_s=0.02,
                     full_mesh=True)
             for i in range(n)]

    async def main():
        try:
            for nd in nodes:
                await nd.start()
            for i in range(n):
                for j in range(i + 1, n):
                    await nodes[i].connect_to(nodes[j].host, nodes[j].port)
            nodes[0].learner.init()
            nodes[0].set_start_learning(rounds=2, epochs=1)
            await asyncio.wait_for(asyncio.gather(
                *(nd.finished.wait() for nd in nodes)), timeout=LIMIT)
        finally:
            for nd in nodes:
                await nd.stop()

    asyncio.run(main())
    assert all(nd.error is None and nd.round == 2 for nd in nodes)


def test_a_full_lane_delays_a_relayed_vote_and_drops_only_beats():
    """A ring 2 - 0 - 1 whose lane 0 -> 1 is full and not draining: node
    0's read path relays node 2's vote without waiting on the lane and
    without losing it (node 1 holds the vote once the lane drains again),
    and drops a beat it would relay onto that lane, counting it."""
    n = 3
    data = FederatedDataset.make(
        DataConfig(dataset="mnist", samples_per_node=16), n)
    shared = SharedTrainer(MLP(features=(8,)), learning_rate=0.05,
                           batch_size=8)
    # beats far apart: the lane holds only the frames this test puts there
    proto = ProtocolConfig(heartbeat_period_s=60.0, node_timeout_s=600.0,
                           send_queue_depth=2)
    nodes = [P2PNode(i, TorchLearner(data=data.nodes[i], batch_size=8,
                                     seed=0, trainer=shared, device="cpu"),
                     n_nodes=n, protocol=proto)
             for i in range(n)]
    hub = nodes[0]

    async def until(cond):
        async def poll():
            while not cond():
                await asyncio.sleep(0.01)
        await asyncio.wait_for(poll(), timeout=LIMIT)

    async def main():
        try:
            for nd in nodes:
                await nd.start()
            for j in (1, 2):
                await hub.connect_to(nodes[j].host, nodes[j].port)
            await until(lambda: {1, 2} <= set(hub.peers))
            lane, source = hub.peers[1], hub.peers[2]
            lane.send_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await lane.send_task
            while not lane.send_q.full():
                lane.send_q.put_nowait(
                    Message(MsgType.METRICS, 0, {"round": 0}))
            vote = Message(MsgType.VOTE_TRAIN_SET, 2,
                           {"round": 0, "candidates": [0, 1, 2]})
            beat = Message(MsgType.BEAT, 2, {"n": 1})
            await asyncio.wait_for(hub._dispatch(source, vote), timeout=1.0)
            # (the nodes' own first beats may meet the full lane too)
            dropped = hub.floods_dropped
            await asyncio.wait_for(hub._dispatch(source, beat), timeout=1.0)
            assert hub.floods_dropped >= dropped + 1
            assert [m.type for m in lane.overflow] == [
                MsgType.VOTE_TRAIN_SET]
            assert 2 not in nodes[1]._votes.get(0, {})
            lane.send_task = asyncio.create_task(hub._drain_send_q(lane))
            await until(lambda: 2 in nodes[1]._votes.get(0, {}))
            assert nodes[1]._votes[0][2] == (0, 1, 2)
            assert not lane.overflow
        finally:
            for nd in nodes:
                await nd.stop()

    asyncio.run(main())
