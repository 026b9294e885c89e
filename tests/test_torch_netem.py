"""The port's link shaper and partitions (``p2p/netem.py``, the node's
``apply_partition`` / ``heal_partition``) on the CPU, against the JAX
package's.

- Parity, tolerance 0: for one seed and one sequence of sends (two
  links, payloads of several sizes, delay, jitter, loss and rate), the
  port's shaper drops the same message indices and gives every kept
  message the same due time as the JAX package's, under a fake clock;
  the partition windows (their seeded jitter included) and the cut's
  semantics are the JAX package's.
- FIFO under jitter (the link never reorders), the loss counters near
  the configured rate, an all-zero config builds no shaper and a
  partition plan alone does.
- A 2-node port federation at 10 ± 3 ms and 2% loss finishes its round
  (as ``tests/test_netem.py``'s every-run guard); a shaper window's
  edges reach the node's membership as partition and heal.
- ``apply_partition`` / ``heal_partition`` on a 4-node port fleet: no
  frame crosses the cut while it is applied, frames flow inside each
  side, and again across after the heal.
- A START_LEARNING lost on its one path reaches the node again, and
  the fleet finishes.
"""

from __future__ import annotations

import asyncio
import time

import pytest
import torch

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.p2p import netem as jnetem
from p2pfl_tpu.p2p import protocol as jproto
from p2pfl_tpu_torch.config.schema import NetworkConfig, PartitionSpec
from p2pfl_tpu_torch.obs import flight
from p2pfl_tpu_torch.p2p import netem as tnetem
from p2pfl_tpu_torch.p2p.node import P2PNode
from p2pfl_tpu_torch.p2p.protocol import Message, MsgType
from test_torch_socket import _fleet, _port_nodes


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


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch's intra-op threads pinned for this module (the suite runs
    six workers), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _Writer:
    @staticmethod
    def is_closing() -> bool:
        return False


class _Peer:
    def __init__(self, idx):
        self.idx = idx
        self.writer = _Writer()


def _schedule(module, message_cls, kind, n: int = 300) -> list:
    """Each send's fate under ``module``'s shaper with a fake clock: None
    for a drop, else its due time. No message is delivered (the workers
    never wake)."""

    async def main():
        loop = asyncio.get_running_loop()
        clock = [1000.0]
        loop.time = lambda: clock[0]
        s = module.LinkShaper(src=2, delay_ms=20, jitter_ms=7, loss_pct=15,
                              rate_mbps=80, seed=5)
        s.QUEUE_DEPTH = 10 ** 6
        peers = [_Peer(0), _Peer(1)]
        out = []
        for i in range(n):
            peer = peers[i % 3 == 0]
            before = s.dropped
            msg = message_cls(kind, 2, payload=b"x" * (1000 * (i % 7)))
            await s.send(peer, msg)
            out.append(None if s.dropped > before else s._last_due[peer.idx])
            clock[0] += 0.0005 * (i % 5)
        s.close()
        return out

    return asyncio.run(main())


def test_drops_and_due_times_equal_jax():
    want = _schedule(jnetem, jproto.Message, jproto.MsgType.BEAT)
    got = _schedule(tnetem, Message, MsgType.BEAT)
    assert got == want
    dropped = sum(x is None for x in got)
    assert 20 < dropped < 80  # 15% of 300


def test_partition_windows_equal_jax():
    specs = [dict(start_s=1.0, duration_s=2.0, groups=[[0, 1], [2, 3]],
                  jitter_s=0.5),
             dict(start_s=4.0, duration_s=1.0, groups=[[0], [1, 2]])]
    for seed in (0, 7, 8):
        j = jnetem.LinkShaper(0, seed=seed, partitions=[
            jschema.PartitionSpec(**d) for d in specs])
        t = tnetem.LinkShaper(0, seed=seed, partitions=[
            PartitionSpec(**d) for d in specs])
        assert t._windows == j._windows
        for dst in range(5):
            for at in (0.5, 1.2, 2.9, 3.2, 4.5, 5.5):
                assert t.severed(dst, at) == j.severed(dst, at)
    s = tnetem.LinkShaper(0, partitions=[PartitionSpec(
        start_s=1.0, duration_s=2.0, groups=[[0, 1], [2, 3]])])
    assert s.severed(2, 1.5) and s.severed(3, 1.0)
    assert not s.severed(1, 1.5) and not s.severed(4, 1.5)
    assert not s.severed(2, 0.99) and not s.severed(2, 3.0)


def test_network_config_equals_jax_and_validates():
    raw = {"delay_ms": 5, "loss_pct": 1, "seed": 3,
           "partitions": [{"start_s": 1, "duration_s": 2,
                           "groups": [[0], [1]]}]}
    assert (tnetem.shaper_from_config(0, NetworkConfig(**raw)) is not None)
    j, t = jschema.NetworkConfig(**raw), NetworkConfig(**raw)
    assert t.partitions[0].groups == j.partitions[0].groups
    for bad in (dict(groups=[[0]]), dict(groups=[[0], [0, 1]]),
                dict(start_s=-1, groups=[[0], [1]])):
        with pytest.raises(ValueError) as want:
            jschema.PartitionSpec(**bad)
        with pytest.raises(ValueError) as got:
            PartitionSpec(**bad)
        assert str(got.value) == str(want.value)


class _Recorder:
    def __init__(self):
        self.delivered = []

    async def write(self, writer, msg):
        self.delivered.append((time.monotonic(), msg))


def test_fifo_under_jitter(monkeypatch):
    async def main():
        rec = _Recorder()
        monkeypatch.setattr(tnetem, "write_message", rec.write)
        s = tnetem.LinkShaper(src=0, delay_ms=5, jitter_ms=30, seed=1)
        t_send = time.monotonic()
        for i in range(50):
            await s.send(_Peer(1), i)
        deadline = time.monotonic() + 5
        while len(rec.delivered) < 50 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        got = [m for _, m in rec.delivered]
        assert got == list(range(50))
        assert rec.delivered[0][0] - t_send >= 0.005
        s.close()

    asyncio.run(main())


def test_loss_counters_and_the_zero_config(monkeypatch):
    async def main():
        monkeypatch.setattr(tnetem, "write_message", _Recorder().write)
        s = tnetem.LinkShaper(src=0, loss_pct=25.0, seed=7)
        for i in range(400):
            await s.send(_Peer(1), f"m{i}")
        for _ in range(100):
            if s.sent + s.dropped == 400:
                break
            await asyncio.sleep(0.01)
        assert s.sent + s.dropped == 400
        assert 0.15 < s.dropped / 400 < 0.35
        s.close()

    asyncio.run(main())
    assert tnetem.shaper_from_config(0, None) is None
    assert tnetem.shaper_from_config(0, NetworkConfig()) is None
    assert tnetem.shaper_from_config(0, NetworkConfig(delay_ms=10)) is not None


def test_two_node_federation_on_shaped_links():
    net = NetworkConfig(delay_ms=10, jitter_ms=3, loss_pct=2, seed=4)
    nodes = asyncio.run(_fleet(_port_nodes(["aggregator"] * 2, netem=net),
                               rounds=1))
    assert all(nd.round == 1 for nd in nodes)
    assert all(nd.shaper is not None and nd.shaper.sent > 0 for nd in nodes)
    assert all(nd.bytes_out > 0 for nd in nodes)


def test_a_shaper_window_reaches_membership(monkeypatch):
    edges = []
    orig = P2PNode._on_netem_transition

    def recording(nd, kind, groups):
        edges.append((nd.idx, kind))
        orig(nd, kind, groups)

    monkeypatch.setattr(P2PNode, "_on_netem_transition", recording)
    net = NetworkConfig(partitions=[PartitionSpec(
        start_s=0.0, duration_s=0.4, groups=[[0], [1]])])

    async def main():
        nodes = _port_nodes(["aggregator"] * 2, netem=net)
        for nd in nodes:
            await nd.start()
        await nodes[0].connect_to(nodes[1].host, nodes[1].port)
        try:
            await asyncio.sleep(1.0)  # beats every 0.2 s cross the edges
        finally:
            for nd in nodes:
                await nd.stop()
        return nodes

    nodes = asyncio.run(main())
    assert all(nd.shaper.part_dropped > 0 for nd in nodes)
    for i in (0, 1):
        assert [k for j, k in edges if j == i][:2] == ["partition", "heal"]


def test_apply_and_heal_partition_on_a_port_fleet():
    async def main():
        nodes = _port_nodes(["aggregator"] * 4)
        for nd in nodes:
            await nd.start()
        for i in range(4):
            for j in range(i + 1, 4):
                await nodes[i].connect_to(nodes[j].host, nodes[j].port)
        try:
            await asyncio.sleep(0.5)
            cut = [[0, 1], [2, 3]]
            for nd in nodes:
                nd.apply_partition(cut)
            assert nodes[0]._link_severed(2) and not nodes[0]._link_severed(1)
            await asyncio.sleep(0.1)
            before = [dict(nd.peer_bytes_out) for nd in nodes]
            await asyncio.sleep(0.6)  # three beats
            for nd, b in zip(nodes, before):
                side = 0 if nd.idx < 2 else 1
                for peer, n in nd.peer_bytes_out.items():
                    if (peer < 2) == (side == 0):
                        assert n > b.get(peer, 0)  # the same side
                    else:
                        assert n == b.get(peer, 0)  # nothing crosses
            for nd in nodes:
                nd.heal_partition()
            assert not nodes[0]._link_severed(2)
            mid = [dict(nd.peer_bytes_out) for nd in nodes]
            await asyncio.sleep(0.6)
            assert nodes[0].peer_bytes_out[2] > mid[0].get(2, 0)
            assert nodes[3].peer_bytes_out[1] > mid[3].get(1, 0)
        finally:
            for nd in nodes:
                await nd.stop()

    asyncio.run(main())


def test_a_lost_start_learning_reaches_the_node_again(monkeypatch):
    """On a line 0-1-2 node 2 hears START_LEARNING from node 1 alone; the
    one copy is lost. Node 1 sends the frame again (its id unchanged)
    to the peer it has not seen in a round, and every node finishes."""
    dispatch = P2PNode._dispatch
    lost = []

    async def lossy(nd, peer, msg):
        if nd.idx == 2 and msg.type is MsgType.START_LEARNING and not lost:
            lost.append(msg.msg_id)
            return
        await dispatch(nd, peer, msg)

    monkeypatch.setattr(P2PNode, "_dispatch", lossy)
    nodes = _port_nodes(["aggregator"] * 3)
    for nd in nodes:  # as the launcher warms every learner up
        nd.learner.init()
    nodes = asyncio.run(_fleet(nodes, rounds=1, links=[(0, 1), (1, 2)]))
    assert lost and all(nd.round == 1 for nd in nodes)
    assert nodes[2]._start_msg.msg_id == lost[0]
