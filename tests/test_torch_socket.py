"""The port's socket plane on the CPU: port-only fleets, a mixed fleet of
JAX and PyTorch nodes, the launcher, and the loud refusals.

Every await sits under ``asyncio.wait_for`` with a generous limit, and
no assertion is on wall time.

- Port-only: DFL over 3 nodes (converges, agrees, floods METRICS),
  CFL (the trainers adopt the server's aggregate, the same bits), SDFL
  (the token moves), a proxy bridging two unlinked aggregators, bf16
  and int8 wire (negotiated on every PARAMS send), STOP evicting its
  sender, ``run_simulation``, and ``launch`` with 2 children under
  ``--platform cpu``.
- Mixed, 4 nodes fully connected, DFL, mnist-mlp: nodes 0 and 1 are
  the JAX package's (``JaxLearner``), 2 and 3 the port's
  (``TorchLearner``). f32 tier (f32 compute, f32 wire, one batch an
  epoch, the JAX node 0 starting, so every node trains from JAX's own
  initial weights, received over the wire): every node's final params
  within rtol 1e-5, atol 1e-6 of the same node in an all-JAX fleet on
  the same inputs. A port starter: the fleet completes and agrees. bf16
  tier (bf16 compute and wire): the fleet completes and its nodes agree
  within rtol 2e-2, atol 2e-3 (two bf16 roundings of the partials).
- Partitions applied by hand, and the A22c sections loading (those
  layers run in ``tests/test_torch_{aggd,netem,tls,secagg}.py``, the
  A22d layers in ``tests/test_torch_socket_{adversary,elastic,
  chaos}.py``).
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.config.schema import DataConfig as JDataConfig
from p2pfl_tpu.config.schema import ProtocolConfig as JProtocol
from p2pfl_tpu.datasets import FederatedDataset as JDataset
from p2pfl_tpu.learning import JaxLearner
from p2pfl_tpu.learning.learner import SharedTrainer as JShared
from p2pfl_tpu.models import get_model as j_get_model
from p2pfl_tpu.p2p import P2PNode as JNode
from p2pfl_tpu_torch.config.schema import (
    DataConfig,
    ProtocolConfig,
    ScenarioConfig,
    TrainingConfig,
)
from p2pfl_tpu_torch.core.serialize import (
    decode_parameters,
    tree_leaves_sorted,
)
from p2pfl_tpu_torch.learning.learner import (
    SharedTrainer,
    TorchLearner,
    device_lock,
)
from p2pfl_tpu_torch.models import get_model
from p2pfl_tpu_torch.p2p import P2PNode
from p2pfl_tpu_torch.p2p.launch import launch, main, run_simulation

pytestmark = [
    pytest.mark.filterwarnings("error::ResourceWarning"),
    pytest.mark.filterwarnings("error:.*was never awaited:RuntimeWarning"),
]

PROTO = ProtocolConfig(heartbeat_period_s=0.2, aggregation_timeout_s=30.0,
                       vote_timeout_s=10.0)
J_PROTO = JProtocol(heartbeat_period_s=0.2, aggregation_timeout_s=30.0,
                    vote_timeout_s=10.0)
LIMIT = 180  # seconds for a whole fleet


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch's intra-op threads pinned for this module (the suite runs
    six workers), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _data(n: int, samples: int = 150) -> JDataset:
    return JDataset.make(JDataConfig(dataset="mnist",
                                     samples_per_node=samples), n)


def _port_learner(data, shared: SharedTrainer, batch: int = 32):
    return TorchLearner(data=data, batch_size=batch, seed=0, trainer=shared,
                        device="cpu")


def _port_shared(lr: float = 0.05, batch: int = 32, **model) -> SharedTrainer:
    return SharedTrainer(get_model("mnist-mlp", **model), learning_rate=lr,
                         batch_size=batch)


async def _fleet(nodes, start: int = 0, rounds: int = 2, wire=None,
                 links=None):
    """Start, link (all pairs unless ``links``), learn, wait; returns
    the nodes, stopped."""
    for nd in nodes:
        await nd.start()
    n = len(nodes)
    for i, j in links or [(i, j) for i in range(n) for j in range(i + 1, n)]:
        await nodes[i].connect_to(nodes[j].host, nodes[j].port)
    nodes[start].learner.init()
    nodes[start].set_start_learning(rounds=rounds, epochs=1)
    try:
        await asyncio.wait_for(
            asyncio.gather(*(nd.finished.wait() for nd in nodes)),
            timeout=LIMIT)
        # the last METRICS floods
        await asyncio.wait_for(_metrics_everywhere(nodes), timeout=30)
    finally:
        for nd in nodes:
            await nd.stop()
    for nd in nodes:
        assert getattr(nd, "error", None) is None, nd.error
    return nodes


async def _metrics_everywhere(nodes) -> None:
    want = {nd.idx for nd in nodes if nd.role != "proxy"}
    while any(not want <= set(nd.peer_metrics) for nd in nodes):
        await asyncio.sleep(0.05)


def _params(node) -> list[np.ndarray]:
    return [np.asarray(x, np.float32)
            for x in tree_leaves_sorted(node.learner.get_parameters())]


def _port_nodes(roles, shared=None, data=None, **kw):
    n = len(roles)
    data = data or _data(n)
    shared = shared or _port_shared()
    return [P2PNode(i, _port_learner(data.nodes[i], shared), role=roles[i],
                    n_nodes=n, protocol=PROTO, gossip_period_s=0.02, **kw)
            for i in range(n)]


def test_dfl_fleet_converges_and_floods_metrics():
    nodes = asyncio.run(_fleet(_port_nodes(["aggregator"] * 3)))
    assert all(nd.round == 2 for nd in nodes)
    for a, b in zip(_params(nodes[0]), _params(nodes[2])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert nodes[1].learner.evaluate()["accuracy"] > 0.5
    for nd in nodes:
        assert len(nd.peer_metrics) == 3
        assert all(0.0 <= m["accuracy"] <= 1.0
                   for m in nd.peer_metrics.values())
        assert nd.bytes_in > 0 and nd.bytes_out > 0


def test_nodes_set_parameters_off_the_event_loop(monkeypatch):
    """The starter's weights and every round's aggregate reach the
    learner in the loop's executor, never on the loop's thread."""
    threads = []
    set_parameters = TorchLearner.set_parameters

    def recording(ln, params):
        threads.append(threading.current_thread())
        set_parameters(ln, params)

    monkeypatch.setattr(TorchLearner, "set_parameters", recording)
    nodes = asyncio.run(_fleet(_port_nodes(["aggregator"] * 2)))
    assert all(nd.round == 2 for nd in nodes)
    # node 1 adopts the starter's weights; both adopt two aggregates
    assert len(threads) >= 5
    assert threading.main_thread() not in threads


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_set_parameters_takes_the_host_leaves(param_dtype):
    """``set_parameters`` from a decoded envelope (read-only views of the
    blob): the device state holds the leaves' values in the model's
    dtype, and ``get_parameters`` answers with the leaves themselves."""
    data = _data(1)
    shared = SharedTrainer(get_model("mnist-mlp", param_dtype=param_dtype),
                           learning_rate=0.05)
    src, dst = (_port_learner(data.nodes[0], shared) for _ in range(2))
    src.init()
    dst.seed = 1
    dst.init()
    blob = src.encode_parameters()
    params = decode_parameters(blob).params
    dst.set_parameters(params)
    got = tree_leaves_sorted(dst.get_parameters())
    for a, b in zip(got, tree_leaves_sorted(params)):
        assert a is b
    for t, want in zip(tree_leaves_sorted(dst.state.params),
                       tree_leaves_sorted(src.state.params)):
        assert t.dtype == param_dtype and t.shape == want.shape
        assert torch.equal(t, want)
    # the device state is its own copy, not a view of the blob
    for t, a in zip(tree_leaves_sorted(dst.state.params), got):
        assert t.data_ptr() != a.__array_interface__["data"][0]


def test_device_lock_is_keyed_by_the_resolved_device(monkeypatch):
    """``cuda`` and ``cuda:0`` name one card: one lock (the current
    device stubbed, so the check runs without a card)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert device_lock("cuda") is device_lock(torch.device("cuda", 0))
    assert device_lock("cuda:1") is not device_lock("cuda:0")
    assert device_lock("cpu") is device_lock(torch.device("cpu"))


def test_cfl_trainers_adopt_the_servers_aggregate():
    nodes = asyncio.run(_fleet(_port_nodes(
        ["server", "trainer", "trainer"], federation="CFL")))
    assert all(nd.round == 2 for nd in nodes)
    for nd in nodes[1:]:  # the server's aggregate, adopted bit for bit
        for a, b in zip(_params(nodes[0]), _params(nd)):
            np.testing.assert_array_equal(a, b)


def test_sdfl_token_rotates():
    nodes = asyncio.run(_fleet(_port_nodes(
        ["aggregator", "trainer", "trainer"], federation="SDFL", seed=1),
        rounds=3))
    assert all(nd.round == 3 for nd in nodes)
    history = [h for nd in nodes for h in nd.leader_history]
    assert any(h != 0 for h in history), history
    assert len({nd.leader for nd in nodes}) == 1


def test_proxy_bridges_unlinked_aggregators():
    nodes = asyncio.run(_fleet(
        _port_nodes(["aggregator", "proxy", "aggregator"]), rounds=1,
        links=[(0, 1), (1, 2)]))
    assert all(nd.round == 1 for nd in nodes)
    assert nodes[0].session.covered == frozenset({0, 2})
    assert nodes[2].session.covered == frozenset({0, 2})
    for a, b in zip(_params(nodes[0]), _params(nodes[2])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_reduced_wire_fleets_converge(wire, monkeypatch):
    from p2pfl_tpu_torch.p2p import node as node_module

    sent = []
    encode = node_module.encode_parameters

    def recording(params, contributors=(), weight=1, wire_dtype=None):
        sent.append(wire_dtype)
        return encode(params, contributors, weight, wire_dtype=wire_dtype)

    monkeypatch.setattr(node_module, "encode_parameters", recording)
    nodes = _port_nodes(["aggregator"] * 3, wire_dtype=wire)
    nodes = asyncio.run(_fleet(nodes))
    assert all(nd.round == 2 for nd in nodes)
    assert nodes[1].learner.evaluate()["accuracy"] > 0.5
    # every peer advertised the dtype: the round's sends are reduced,
    # the initial diffusion is f32
    assert all(wire in nd._peer_wire[j] for nd in nodes
               for j in nd._peer_wire)
    assert wire in sent and set(sent) <= {wire, None}


def test_int8_error_feedback_matches_jax():
    """The carried residual and the shipped tree equal the JAX node's,
    send after send."""
    rng = np.random.default_rng(0)
    jn = JNode(0, None, n_nodes=2, wire_dtype="int8")
    tn = P2PNode(0, None, n_nodes=2, wire_dtype="int8")
    for _ in range(3):
        tree = {"w": rng.standard_normal((5, 4)).astype(np.float32),
                "b": rng.standard_normal(4).astype(np.float32)}
        ja, ta = jn._apply_error_feedback(tree), tn._apply_error_feedback(tree)
        for x, y in zip(jax.tree.leaves(ja), tree_leaves_sorted(ta)):
            np.testing.assert_array_equal(np.asarray(x), y)
        for x, y in zip(jn._ef_residual, tn._ef_residual):
            np.testing.assert_array_equal(x, y)


def test_stop_evicts_its_sender_through_the_flood():
    async def main_():
        nodes = _port_nodes(["aggregator"] * 3)
        for nd in nodes:
            await nd.start()
        await nodes[0].connect_to(nodes[1].host, nodes[1].port)
        await nodes[1].connect_to(nodes[2].host, nodes[2].port)
        try:
            async def all_seen():
                while set(nodes[0].membership.get_nodes()) != {0, 1, 2}:
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(all_seen(), timeout=30)
            await nodes[2].stop()

            async def evicted():
                while (2 in nodes[0].membership.get_nodes()
                       or 2 in nodes[1].peers):
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(evicted(), timeout=30)
        finally:
            for nd in nodes[:2]:
                await nd.stop()

    asyncio.run(main_())


def _sim_config(**kw) -> ScenarioConfig:
    return ScenarioConfig(
        name="sim", n_nodes=3, topology="fully",
        data=DataConfig(dataset="mnist", samples_per_node=120),
        training=TrainingConfig(rounds=2, epochs_per_round=1,
                                learning_rate=0.05),
        protocol=ProtocolConfig(heartbeat_period_s=0.2,
                                aggregation_timeout_s=30.0,
                                vote_timeout_s=10.0), **kw)


def test_run_simulation_in_process(tmp_path):
    from p2pfl_tpu_torch.utils.monitor import read_statuses

    nodes: list = []
    res = run_simulation(_sim_config(log_dir=str(tmp_path)), timeout=LIMIT,
                         device="cpu", nodes_out=nodes)
    assert res["n_nodes"] == 3 and res["rounds"] == 2
    assert res["xla_recompiles"] == 0
    assert 0.0 <= res["mean_accuracy"] <= 1.0
    assert res["bytes_out"] >= res["params_bytes_out"] > 0
    assert all(nd.learner.device.type == "cpu" for nd in nodes)
    assert all(nd.learner.global_step > 0 for nd in nodes)
    # one status record a node, at its final round
    records = read_statuses(tmp_path / "sim" / "status")
    assert [r["node"] for r in records] == [0, 1, 2]
    assert all(r["round"] == 2 and r["recompiles"] == 0 for r in records)


def test_launch_two_children_on_the_cpu(tmp_path):
    """3 nodes, 2 a process: one child runs nodes 0 and 1 on its event
    loop, the other node 2."""
    cfg = _sim_config()
    path = tmp_path / "socket.json"
    cfg.save(path)
    res = launch(cfg, path, platform="cpu", nodes_per_proc=2, timeout=LIMIT)
    assert sorted(r["node"] for r in res) == [0, 1, 2]
    for r in res:
        assert r["round"] == 2 and r["device"] == "cpu"
        assert r["learn_wall_s"] > 0 and r["bytes_in"] > 0
        assert 0.0 <= r["accuracy"] <= 1.0


def test_cli_without_a_card_exits_with_a_message(tmp_path, capsys):
    if torch.cuda.is_available():
        return  # the card is the default there
    path = tmp_path / "socket.json"
    _sim_config().save(path)
    assert main([str(path)]) == 2
    assert "--platform cpu" in capsys.readouterr().err


# ---- the mixed fleet ------------------------------------------------------

def _mixed(kinds, *, f32: bool, start: int, samples: int = 64,
           wire: str = "f32"):
    """Nodes of ``kinds`` ("jax" / "port") on one dataset; f32: f32
    compute and one batch an epoch."""
    n = len(kinds)
    data = _data(n, samples)
    batch = samples if f32 else 32
    jshared = JShared(
        j_get_model("mnist-mlp", **({"dtype": jnp.float32} if f32 else {})),
        learning_rate=0.05, batch_size=batch)
    tshared = _port_shared(batch=batch,
                           **({"dtype": torch.float32} if f32 else {}))
    nodes = []
    for i, kind in enumerate(kinds):
        if kind == "jax":
            ln = JaxLearner(model=None, data=data.nodes[i], learning_rate=0.05,
                            batch_size=batch, seed=0, trainer=jshared)
            nodes.append(JNode(i, ln, n_nodes=n, protocol=J_PROTO,
                               gossip_period_s=0.02, wire_dtype=wire))
        else:
            nodes.append(P2PNode(i, _port_learner(data.nodes[i], tshared,
                                                  batch),
                                 n_nodes=n, protocol=PROTO,
                                 gossip_period_s=0.02, wire_dtype=wire))
    return asyncio.run(_fleet(nodes, start=start))


@pytest.fixture(scope="module")
def all_jax_f32():
    return _mixed(["jax"] * 4, f32=True, start=0)


def test_mixed_fleet_f32_matches_the_all_jax_fleet(all_jax_f32):
    mixed = _mixed(["jax", "jax", "port", "port"], f32=True, start=0)
    assert all(nd.round == 2 for nd in mixed)
    assert all(len(nd.peer_metrics) == 4 for nd in mixed)
    for ref, got in zip(all_jax_f32, mixed):
        for a, b in zip(_params(ref), _params(got)):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_mixed_fleet_with_a_port_starter_completes():
    mixed = _mixed(["port", "jax", "port", "jax"], f32=True, start=0)
    assert all(nd.round == 2 for nd in mixed)
    for nd in mixed[1:]:
        for a, b in zip(_params(mixed[0]), _params(nd)):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_mixed_fleet_bf16_completes_and_agrees():
    mixed = _mixed(["jax", "port", "jax", "port"], f32=False, start=1,
                   wire="bf16")
    assert all(nd.round == 2 for nd in mixed)
    for nd in mixed[1:]:
        for a, b in zip(_params(mixed[0]), _params(nd)):
            np.testing.assert_allclose(b, a, rtol=2e-2, atol=2e-3)


# ---- what stays true of the A22c sections ----------------------------------

def test_left_out_partitions_and_launcher_options_raise(tmp_path, capsys):
    """A cut applied by hand severs the link and a heal mends it; the
    launcher knows ``--resume``, ``--max-restarts`` and
    ``--restart-backoff-s`` and refuses an option it does not know; the
    A22c sections load (their own test files run them; the A22d layers
    run in ``tests/test_torch_socket_{adversary,elastic,chaos,
    supervisor}.py``)."""
    path = tmp_path / "s.json"
    _sim_config().save(path)
    with pytest.raises(SystemExit):
        main([str(path), "--help"])
    usage = capsys.readouterr().out
    for flag in ("--resume", "--max-restarts", "--restart-backoff-s"):
        assert flag in usage
    with pytest.raises(SystemExit):
        main([str(path), "--platform", "cpu", "--no-such-option"])
    nd = P2PNode(0, None, n_nodes=2)
    nd.apply_partition([[0], [1]])
    assert nd._link_severed(1)
    nd.heal_partition()
    assert not nd._link_severed(1)
    for raw, loaded in (
            ({"network": {"delay_ms": 5}}, lambda c: c.network.delay_ms == 5),
            ({"encrypt": True}, lambda c: c.encrypt),
            ({"aggregation_plane": "sidecar"},
             lambda c: c.aggregation_plane == "sidecar"),
            ({"privacy": {"secagg": True}}, lambda c: c.privacy.secagg)):
        assert loaded(ScenarioConfig.from_dict({"n_nodes": 2, **raw}))


def test_the_port_modules_import_no_jax():
    code = ("import sys\n"
            "import p2pfl_tpu_torch.p2p.launch, p2pfl_tpu_torch.p2p.node\n"
            "import p2pfl_tpu_torch.core.serialize\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=root).stdout
    top = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "optax", "msgpack",
                      "p2pfl_tpu"}
