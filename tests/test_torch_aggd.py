"""The port's aggregation sidecar (``p2p/aggd.py``, ``SidecarSession``,
``protocol.read_message``'s slot sink) on the CPU, against the JAX
package's.

- Parity, tolerance 0: the worker's fuse of three envelopes (weights 2,
  3, 5) equals the port's inline session and the JAX package's
  ``fuse_numpy`` bit for bit; the in-process fallback fuse too, and one
  entry comes back as it is.
- Slots: two sessions share one arena, every slot is back after both
  rounds, and a full arena leases None; a worker killed before the fuse
  falls back, is counted, and gives the same bits.
- The slot sink diverts a PARAMS payload into the leased view and
  returns the lease when the payload is cut short.
- A 4-node ``run_simulation`` A/B (as ``tests/test_aggd.py``): the
  sidecar arm decodes no payload byte on the loop, the inline arm does;
  the same accuracy; no fallback; at least rounds x nodes fuses.
- ``launch``: 3 nodes in a child on 2 ms links with its sidecar, every
  fuse through the worker.
- The schema's sidecar refusals carry the JAX package's messages.
- Residue: the arena's own name leaves ``/dev/shm`` once the worker
  attaches and stays gone after close; the port's names never match the
  JAX package's ``p2pfl_aggd_*`` (no glob over another package's
  prefix is made).
"""

from __future__ import annotations

import asyncio
import fnmatch
import os
import time

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.p2p.aggd import fuse_numpy as j_fuse_numpy
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.core.serialize import (
    decode_parameters,
    encode_parameters,
    tree_leaves_sorted,
)
from p2pfl_tpu_torch.obs import flight
from p2pfl_tpu_torch.p2p.aggd import SHM_PREFIX, SidecarClient
from p2pfl_tpu_torch.p2p.launch import run_simulation
from p2pfl_tpu_torch.p2p.protocol import Message, MsgType, read_message
from p2pfl_tpu_torch.p2p.session import (
    AggregationSession,
    SidecarSession,
    fuse_numpy,
)


@pytest.fixture(autouse=True)
def _flight_into_tmp(tmp_path):
    """The port's flight recorder dumps (a crash, a dead peer's
    eviction) into the test's directory, and is emptied after."""
    rec = flight.get_recorder()
    rec.configure(dump_dir=tmp_path / "flight")
    yield
    rec.dump_dir = None
    rec.clear()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch's intra-op threads pinned for this module (the suite runs
    six workers), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _equal(a, b) -> bool:
    la, lb = tree_leaves_sorted(a), tree_leaves_sorted(b)
    return len(la) == len(lb) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(la, lb))


def _in_shm(client: SidecarClient) -> bool:
    return bool(client.name) and os.path.exists(f"/dev/shm/{client.name}")


def _put(client: SidecarClient, blob: bytes) -> int:
    slot, mv = client.lease(len(blob))
    mv[:len(blob)] = blob
    mv.release()
    return slot


@pytest.fixture(scope="module")
def client():
    """One sidecar for the tests that need a live worker (each worker
    is an interpreter that imports torch: the suite runs in parallel)."""
    cl = SidecarClient(n_slots=8)
    yield cl
    cl.close()


async def _closed(session, limit: float = 30.0) -> None:
    deadline = time.monotonic() + limit
    while not session.check_and_run():
        assert time.monotonic() < deadline, "the fuse never completed"
        await asyncio.sleep(0.01)


def test_prefix_is_the_ports_own():
    assert SHM_PREFIX == "p2pfl_torch_aggd_"
    assert not fnmatch.fnmatch(SHM_PREFIX + "0123abcd", "p2pfl_aggd_*")


def test_sidecar_fuse_equals_inline_and_jax_at_tolerance_zero(client):
    blobs = [encode_parameters(_tree(i), (i,), 1) for i in range(3)]
    trees = [decode_parameters(b).params for b in blobs]
    weights = (2, 3, 5)

    async def inline():
        s = AggregationSession(timeout_s=30.0)
        s.set_nodes_to_aggregate([0, 1, 2])
        for i, w in enumerate(weights):
            s.add_model(trees[i], (i,), w)
        assert s.done.is_set()
        return s.result

    async def sidecar():
        fused, fallbacks = client.fused_rounds, client.fallbacks
        s = SidecarSession(timeout_s=30.0, client=client)
        s.set_nodes_to_aggregate([0, 1, 2])
        s.add_model(trees[0], (0,), weights[0])
        for i in (1, 2):
            s.add_slot(_put(client, blobs[i]), len(blobs[i]), (i,),
                       weights[i])
        await _closed(s)
        assert client.fallbacks == fallbacks
        assert client.fused_rounds == fused + 1
        return s.result

    want, want_cov = asyncio.run(inline())
    got, got_cov = asyncio.run(sidecar())
    assert got_cov == want_cov == (0, 1, 2)
    assert _equal(got, want)
    jax_fused, _ = j_fuse_numpy(trees, np.asarray(weights, np.float32))
    assert _equal(want, jax.tree.map(np.asarray, jax_fused))


def test_fallback_fuse_parity_and_a_single_entry():
    blobs = [encode_parameters(_tree(10 + i), (i,), 1) for i in range(2)]
    trees = [decode_parameters(b).params for b in blobs]
    s = SidecarSession(timeout_s=30.0, client=None)
    s.set_nodes_to_aggregate([0, 1])
    s.add_model(trees[0], (0,), 1)
    s.add_blob(blobs[1], (1,), 4)
    assert s.check_and_run()  # no loop: the in-process fuse
    want, _ = fuse_numpy(trees, np.asarray([1.0, 4.0], np.float32))
    assert _equal(s.result[0], want)
    one = SidecarSession(timeout_s=30.0, client=None)
    one.set_nodes_to_aggregate([0])
    one.add_model(trees[0], (0,), 7)
    assert one.check_and_run()
    assert _equal(one.result[0], trees[0])


def test_leases_under_concurrent_sessions(client):
    blobs = {i: encode_parameters(_tree(20 + i), (i,), 1) for i in range(4)}

    async def run():
        fused, fallbacks = client.fused_rounds, client.fallbacks

        async def one_round(own: int, peer: int):
            s = SidecarSession(timeout_s=30.0, client=client)
            s.set_nodes_to_aggregate([own, peer])
            s.add_model(decode_parameters(blobs[own]).params, (own,), 1)
            s.add_slot(_put(client, blobs[peer]), len(blobs[peer]),
                       (peer,), 2)
            await _closed(s)

        await asyncio.gather(one_round(0, 1), one_round(2, 3))
        assert client.fused_rounds == fused + 2
        assert client.fallbacks == fallbacks
        assert len(client._free) == client.n_slots
        assert not client._leased
        held = []
        while (lease := client.lease(1024)) is not None:
            held.append(lease[0])
        assert len(held) == client.n_slots
        for slot in held:
            client.release(slot)
        assert len(client._free) == client.n_slots

    asyncio.run(run())


def test_a_worker_killed_mid_round_falls_back_and_is_counted():
    blobs = [encode_parameters(_tree(30 + i), (i,), 1) for i in range(2)]
    trees = [decode_parameters(b).params for b in blobs]

    async def run():
        client = SidecarClient(n_slots=6)
        try:
            s = SidecarSession(timeout_s=30.0, client=client)
            s.set_nodes_to_aggregate([0, 1])
            s.add_model(trees[0], (0,), 1)
            slot = _put(client, blobs[1])
            client._proc.terminate()
            client._proc.join(timeout=5.0)
            t0 = time.monotonic()
            s.add_slot(slot, len(blobs[1]), (1,), 4)
            await _closed(s)
            assert time.monotonic() - t0 < 5.0
            assert client.fallbacks == 1 and client.fused_rounds == 0
            want, _ = fuse_numpy(trees, np.asarray([1.0, 4.0], np.float32))
            assert _equal(s.result[0], want)
            assert len(client._free) == client.n_slots
        finally:
            client.close()
            client.close()  # idempotent
        assert not _in_shm(client)

    asyncio.run(run())


def test_the_arena_name_leaves_dev_shm_at_the_attach(client):
    async def run():
        blob = encode_parameters(_tree(40), (0,), 1)
        slot = _put(client, blob)
        assert client.name.startswith(SHM_PREFIX)
        deadline = time.monotonic() + 20
        while not client._unlinked and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert client._unlinked and not _in_shm(client)
        out = await client.fuse([("s", slot, len(blob), 1.0)], timeout_s=20)
        assert out is not None  # the mapping outlives the name
        rslot, length, _ = out
        got = decode_parameters(bytes(client.view(rslot, length)))
        assert _equal(got.params, _tree(40))
        client.release(rslot)
        client.release(slot)

    asyncio.run(run())


def test_read_message_slot_sink_diverts_and_releases_on_error():
    payload = bytes(range(256)) * 8
    frame = Message(MsgType.PARAMS, 3, {"round": 0, "c": [3], "w": 5},
                    payload).encode()

    async def run():
        buf = bytearray(len(payload) + 64)
        released = []

        def sink(obj, pl):
            assert obj["b"]["c"] == [3] and pl == len(payload)
            return 7, memoryview(buf)[:pl], released.append

        def reader(data):
            r = asyncio.StreamReader()
            r.feed_data(data)
            r.feed_eof()
            return r

        got = await read_message(reader(frame), slot_sink=sink)
        assert got.payload == b"" and got._slot == 7
        assert got._slot_len == len(payload) and got._wire_bytes == len(frame)
        assert bytes(buf[:len(payload)]) == payload and not released
        got2 = await read_message(reader(frame), slot_sink=lambda o, n: None)
        assert got2.payload == payload and got2._slot is None
        with pytest.raises(asyncio.IncompleteReadError):
            await read_message(reader(frame[:-100]), slot_sink=sink)
        assert released == [7]

    asyncio.run(run())


def _sim_cfg(plane: str, **over):
    raw = dict(name=f"aggd-{plane}", n_nodes=4, topology="fully",
               data={"dataset": "mnist", "samples_per_node": 30},
               training={"rounds": 2, "epochs_per_round": 1,
                         "learning_rate": 0.05},
               protocol={"heartbeat_period_s": 0.5,
                         "aggregation_timeout_s": 30.0,
                         "vote_timeout_s": 10.0, "train_set_size": 4,
                         "gossip_fanout": 3},
               aggregation_plane=plane)
    raw.update(over)
    return raw


def test_run_simulation_sidecar_against_inline():
    clients: list = []
    sidecar = run_simulation(tschema.ScenarioConfig.from_dict(
        _sim_cfg("sidecar")), timeout=150, device="cpu", sidecar_out=clients)
    inline = run_simulation(tschema.ScenarioConfig.from_dict(
        _sim_cfg("inline")), timeout=150, device="cpu")
    assert sidecar["rounds"] == inline["rounds"] == 2
    assert sidecar["loop_payload_touch_bytes"] == 0
    assert inline["loop_payload_touch_bytes"] > 0
    assert sidecar["mean_accuracy"] == inline["mean_accuracy"]
    assert sidecar["aggd_fallbacks"] == 0
    assert sidecar["aggd_fused_rounds"] >= 2 * 4
    assert sidecar["aggd_bytes_ingested"] > 0
    assert not clients[0].alive() and not _in_shm(clients[0])


@pytest.mark.parametrize("over", [
    {"aggregator": "krum"}, {"federation": "CFL"}, {"federation": "SDFL"},
    {"topology": "ring"}, {"encrypt": True},
    {"aggregation_plane": "offload"},
    {"adversary": {"reputation": True}},
    {"cross_device": {"n_clients": 100, "clients_per_round": 8}},
    {"lora": {"rank": 4}},
])
def test_schema_refuses_the_sidecars_combinations_as_jax_does(over):
    raw = _sim_cfg("sidecar", **over)
    with pytest.raises(ValueError) as want:
        jschema.ScenarioConfig.from_dict(raw)
    with pytest.raises(ValueError) as got:
        tschema.ScenarioConfig.from_dict(raw)
    assert str(got.value) == str(want.value)


def test_launch_runs_a_child_with_its_sidecar_on_shaped_links(
        tmp_path, monkeypatch):
    """3 nodes in one child with its sidecar, on links delayed by 2 ms:
    every fuse goes through the worker (one child: each one spawned is
    an interpreter and a worker more on a loaded test machine)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the child's torch threads
    from p2pfl_tpu_torch.p2p.launch import launch

    raw = _sim_cfg("sidecar", n_nodes=3, network={"delay_ms": 2, "seed": 1})
    raw["protocol"]["train_set_size"] = 3
    cfg = tschema.ScenarioConfig.from_dict(raw)
    path = tmp_path / "socket.json"
    cfg.save(path)
    res = launch(cfg, path, platform="cpu", nodes_per_proc=3, timeout=150)
    assert sorted(r["node"] for r in res) == [0, 1, 2]
    for r in res:
        assert r["round"] == 2 and r["aggd_fallbacks"] == 0
        assert r["aggd_fused_rounds"] >= 2 and r["aggd_bytes_ingested"] > 0
