"""The socket plane's elastic layer against the JAX package's, on the CPU:
the async quorum close and stale folds on both session kinds, the live
join (the "jr" hello and STATE_SYNC), node checkpoints, mixed fleets
that fold each other's late updates and join through each other's
STATE_SYNC, and churning federations.

- Quorum math: ``quorum()`` equals the JAX session's for every train
  set size (exact).
- Fusion: the same adds (fresh and stale, inline entries, arena slots
  and blobs) into the JAX and the port session give the same returns,
  covered sets, stored weights (exact) and fused params (rtol 1e-6,
  atol 1e-7), and close at the same add.
- Node checkpoint files: the same bytes from both packages (f32 and
  bf16), each package loads the other's bit for bit, a torn file fails
  naming it, the newest save wins.
- Mixed pairs over TCP: a JAX node's update for round r - 1 reaching a
  port node in round r folds with staleness 1 (inline and sidecar
  plane), and the reverse; a stale aggregate and a sync node's stale
  update are dropped. A port joiner adopts a JAX node's STATE_SYNC bit
  for bit, and a JAX joiner a port node's; a resumed node takes a
  STATE_SYNC only when its round is newer than its checkpoint's.
- Federations: crash, eviction and a live rejoin under the async quorum
  with the crashed node a straggler caught mid-fit (its fit stops at
  the next epoch and releases the device lock); declarative churn
  through ``run_simulation``.

Every deadline that is not under test is wide.
"""

from __future__ import annotations

import asyncio
import math
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.config.schema import DataConfig as JDataConfig
from p2pfl_tpu.config.schema import ElasticConfig as JElastic
from p2pfl_tpu.config.schema import ProtocolConfig as JProtocol
from p2pfl_tpu.datasets import FederatedDataset as JDataset
from p2pfl_tpu.federation import checkpoint as jck
from p2pfl_tpu.learning import JaxLearner
from p2pfl_tpu.learning.learner import SharedTrainer as JShared
from p2pfl_tpu.models import get_model as j_get_model
from p2pfl_tpu.p2p import P2PNode as JNode
from p2pfl_tpu.p2p.session import AggregationSession as JSession
from p2pfl_tpu.p2p.session import SidecarSession as JSidecarSession
from p2pfl_tpu_torch.config.schema import (
    DataConfig,
    ElasticConfig,
    ProtocolConfig,
    ScenarioConfig,
    TrainingConfig,
)
from p2pfl_tpu_torch.core.serialize import (
    BF16Array,
    as_f32,
    decode_parameters,
    encode_parameters,
    tree_leaves_sorted,
)
from p2pfl_tpu_torch.federation import checkpoint as ck
from p2pfl_tpu_torch.learning.learner import SharedTrainer, TorchLearner
from p2pfl_tpu_torch.models import get_model
from p2pfl_tpu_torch.p2p import P2PNode
from p2pfl_tpu_torch.p2p.aggd import SidecarClient, SlotEntry
from p2pfl_tpu_torch.p2p.launch import run_simulation
from p2pfl_tpu_torch.p2p.session import AggregationSession, SidecarSession
from p2pfl_tpu_torch.parallel.federated import staleness_scale

pytestmark = [
    pytest.mark.filterwarnings("error::ResourceWarning"),
    pytest.mark.filterwarnings("error:.*was never awaited:RuntimeWarning"),
]

PROTO = ProtocolConfig(heartbeat_period_s=0.2, aggregation_timeout_s=60.0,
                       vote_timeout_s=30.0)
J_PROTO = JProtocol(heartbeat_period_s=0.2, aggregation_timeout_s=60.0,
                    vote_timeout_s=30.0)
ASYNC = dict(async_aggregation=True, min_received=0.5, staleness_beta=0.5)
LIMIT = 120
FUSE_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(rng, bf16=False):
    t = {"Dense_0": {"bias": rng.standard_normal(5).astype(np.float32),
                     "kernel": rng.standard_normal((7, 5)).astype(np.float32)}}
    if bf16:
        t["Dense_0"]["bias"] = t["Dense_0"]["bias"].astype(ml_dtypes.bfloat16)
    return t


def _port(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return a.view(np.uint16).view(BF16Array)
        return a

    return {k: _port(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _same_bits(jtree, ttree) -> None:
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves_sorted(ttree)):
        assert np.array_equal(_bits(a), _bits(b))


# ---- quorum math and fusion -----------------------------------------------

@pytest.mark.parametrize("min_received", [0.25, 0.4, 0.5, 0.75, 1.0])
def test_quorum_matches_jax(min_received):
    js = JSession(timeout_s=60, min_received=min_received)
    ts = AggregationSession(timeout_s=60, min_received=min_received)
    assert ts.async_mode == js.async_mode == (min_received < 1.0)
    for n in (1, 2, 3, 4, 7, 10, 16, 24):
        js.set_nodes_to_aggregate(set(range(n)))
        ts.set_nodes_to_aggregate(set(range(n)))
        assert ts.quorum() == js.quorum()
        if ts.async_mode:
            assert ts.quorum() == max(1, math.ceil(min_received * n))


class _Arena:
    """A stand-in for the sidecar's client: slots in one bytearray, no
    worker (a session without a running loop fuses in process)."""

    def __init__(self, n_slots=16, slot_bytes=1 << 14):
        self.buf = bytearray(n_slots * slot_bytes)
        self.slot_bytes = slot_bytes
        self.free = list(range(n_slots))
        self.fallbacks = 0

    def lease(self, nbytes):
        if not self.free or nbytes > self.slot_bytes:
            return None
        slot = self.free.pop()
        return slot, self.view(slot, nbytes)

    def view(self, slot, length):
        off = slot * self.slot_bytes
        return memoryview(self.buf)[off:off + length]

    def release(self, slot):
        if slot not in self.free:
            self.free.append(slot)


# (contributors, weight, staleness, how it arrives) in order; the train
# set is {0, .., 5}
ADDS = [((0,), 10, 0.0, "model"), ((1,), 12, 1.0, "slot"),
        ((2,), 9, 2.0, "blob"), ((3, 4), 20, 0.0, "slot"),
        ((1,), 12, 1.0, "slot"), ((5,), 11, 3.0, "blob")]


def _run_adds(kind, beta, min_received, bf16):
    rng = np.random.default_rng(9)
    trees = [_tree(rng, bf16) for _ in ADDS]
    out = []
    if kind == "inline":
        sessions = [JSession(timeout_s=60, min_received=min_received,
                             staleness_beta=beta),
                    AggregationSession(timeout_s=60, min_received=min_received,
                                       staleness_beta=beta)]
    else:
        sessions = [JSidecarSession(timeout_s=60, min_received=min_received,
                                    staleness_beta=beta, client=_Arena()),
                    SidecarSession(timeout_s=60, min_received=min_received,
                                   staleness_beta=beta, client=_Arena())]
    for s in sessions:
        s.set_nodes_to_aggregate(set(range(6)))
    for (contrib, w, stale, how), tree in zip(ADDS, trees):
        rets = []
        for pkg, s in zip(("jax", "port"), sessions):
            t = tree if pkg == "jax" else _port(tree)
            if kind == "inline" or how == "model":
                rets.append(s.add_model(t, contrib, w, staleness=stale))
                continue
            blob = (jax_encode(t, contrib, w) if pkg == "jax"
                    else encode_parameters(t, contrib, w))
            if how == "blob":
                rets.append(s.add_blob(blob, contrib, w, staleness=stale))
            else:
                slot, mv = s.client.lease(len(blob))
                mv[:len(blob)] = blob
                rets.append(s.add_slot(slot, len(blob), contrib, w,
                                       staleness=stale))
        out.append((rets, [s.done.is_set() for s in sessions],
                    [sorted((sorted(k), w) for k, (_, w) in s.models.items())
                     for s in sessions]))
    return sessions, out


def jax_encode(tree, contrib, w):
    from p2pfl_tpu.core.serialize import encode_parameters as jenc

    return jenc(tree, tuple(contrib), int(w))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("min_received", [1.0, 0.6])
@pytest.mark.parametrize("beta", [0.0, 0.5, 2.0])
@pytest.mark.parametrize("kind", ["inline", "sidecar"])
def test_staleness_weighted_fusion_matches_jax(kind, beta, min_received,
                                               bf16):
    (js, ts), steps = _run_adds(kind, beta, min_received, bf16)
    for rets, done, weights in steps:
        assert rets[0] == rets[1]
        assert done[0] == done[1]
        assert weights[0] == weights[1]  # the discount, exactly
    closed_at = [done[1] for _, done, _ in steps].index(True) \
        if ts.done.is_set() else None
    # async: the quorum (4 of 6) closes at 5 covered; sync: full coverage
    assert closed_at == (3 if min_received < 1.0 else 5)
    assert js.done.is_set() and ts.done.is_set()
    assert js.result[1] == ts.result[1]
    for a, b in zip(jax.tree.leaves(js.result[0]),
                    tree_leaves_sorted(ts.result[0])):
        np.testing.assert_allclose(as_f32(b), np.asarray(a, np.float32),
                                   **FUSE_TOL)


def test_the_discount_is_the_stacked_planes():
    s = AggregationSession(min_received=0.5, staleness_beta=0.5)
    for stale in (1.0, 2.0, 5.0):
        assert s._discounted(8, stale) == 8 * float(
            staleness_scale(stale, 0.5))
    assert s._discounted(8, 0.0) == 8


# ---- node checkpoint files ------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_node_checkpoint_files_are_the_jax_bytes(tmp_path, bf16):
    rng = np.random.default_rng(2)
    tree = _tree(rng, bf16)
    jpath = jck.save_node_checkpoint(tmp_path / "jax", 3, tree, 7)
    tpath = ck.save_node_checkpoint(tmp_path / "port", 3, _port(tree), 7)
    assert jpath.name == tpath.name == "node_003.ckpt.msgpack"
    assert tpath.read_bytes() == jpath.read_bytes()
    # each package loads the other's file bit for bit
    got, rnd = ck.load_node_checkpoint(tmp_path / "jax", 3, _port(tree))
    assert rnd == 7
    _same_bits(tree, got)
    jgot, jrnd = jck.load_node_checkpoint(tmp_path / "port", 3, tree)
    assert jrnd == 7
    _same_bits(jgot, _port(tree))
    # tensors in, tensors out
    tensors = {"Dense_0": {k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in tree["Dense_0"].items()}}
    got_t, _ = ck.load_node_checkpoint(tmp_path / "port", 3, tensors)
    assert isinstance(got_t["Dense_0"]["kernel"], torch.Tensor)


def test_a_torn_node_checkpoint_fails_naming_the_file(tmp_path):
    tree = _port(_tree(np.random.default_rng(4)))
    ck.save_node_checkpoint(tmp_path, 0, tree, 7)
    path = ck.node_checkpoint_path(tmp_path, 0)
    blob = path.read_bytes()
    for cut in (len(blob) // 2, 5):
        path.write_bytes(blob[:cut])
        with pytest.raises(ValueError, match=path.name):
            ck.load_node_checkpoint(tmp_path, 0, tree)
    path.write_bytes(blob)
    assert ck.load_node_checkpoint(tmp_path, 0, tree)[1] == 7


def test_the_newest_node_checkpoint_wins(tmp_path):
    rng = np.random.default_rng(5)
    a, b = _port(_tree(rng)), _port(_tree(rng))
    ck.save_node_checkpoint(tmp_path, 2, a, 1)
    ck.save_node_checkpoint(tmp_path, 2, b, 4)
    got, rnd = ck.load_node_checkpoint(tmp_path, 2, a)
    assert rnd == 4
    for x, y in zip(tree_leaves_sorted(got), tree_leaves_sorted(b)):
        assert np.array_equal(x, y)
    assert [p.name for p in tmp_path.iterdir()] == ["node_002.ckpt.msgpack"]
    assert ck.load_node_checkpoint(tmp_path, 3, a) is None


# ---- mixed pairs over TCP: stale folds ------------------------------------

async def _until(cond, timeout=LIMIT, period=0.02):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached in time")
        await asyncio.sleep(period)


def _open_round(node, round_no, train_set):
    node.round = round_no
    node.session.clear()
    node.session.set_nodes_to_aggregate(train_set)
    node._round_active = True


@pytest.mark.parametrize("case", ["jax->port", "jax->port-sidecar",
                                  "port->jax", "aggregate-dropped",
                                  "sync-dropped"])
def test_a_late_update_folds_across_packages(case):
    """The receiver is in round 3 with a session open over {0, 1, 2}; the
    sender ships its own update for round 2. Staleness is the receiver's
    round minus the message's, as in JAX."""
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    port_receives = case != "port->jax"
    el = ElasticConfig(**ASYNC) if case != "sync-dropped" else None
    jel = JElastic(**ASYNC)

    async def main():
        sidecar = SidecarClient(n_slots=8) if "sidecar" in case else None
        if port_receives:
            rx = P2PNode(1, None, n_nodes=3, protocol=PROTO, elastic=el,
                         sidecar=sidecar)
            tx = JNode(0, None, n_nodes=3, protocol=J_PROTO, elastic=jel)
        else:
            rx = JNode(1, None, n_nodes=3, protocol=J_PROTO, elastic=jel)
            tx = P2PNode(0, None, n_nodes=3, protocol=PROTO,
                         elastic=ElasticConfig(**ASYNC))
        try:
            await rx.start()
            await tx.start()
            await tx.connect_to(rx.host, rx.port)
            await _until(lambda: 0 in rx.peers and 1 in tx.peers)
            _open_round(rx, 3, {0, 1, 2})
            body = {"aggregated": True} if case == "aggregate-dropped" else {}
            await tx._send_params(tx.peers[1], tree if not port_receives
                                  else tree, (0,), 7, round=2, **body)
            if case in ("aggregate-dropped", "sync-dropped"):
                # a fresh update after it proves the stale one was read
                await tx._send_params(tx.peers[1], tree, (2,), 5, round=3)
                await _until(lambda: rx.session.models)
                assert list(rx.session.models) == [frozenset({2})]
                return
            await _until(lambda: rx.session.models)
            (key, (params, w)), = rx.session.models.items()
            assert key == frozenset({0})
            assert w == 7 * float(staleness_scale(1.0, 0.5))
            if isinstance(params, SlotEntry):
                params = decode_parameters(bytes(sidecar.view(
                    params.slot, params.length))).params
            for a, b in zip(jax.tree.leaves(tree),
                            jax.tree.leaves(params) if not port_receives
                            else tree_leaves_sorted(params)):
                assert np.array_equal(np.asarray(a), np.asarray(b))
        finally:
            await tx.stop()
            await rx.stop()
            if sidecar is not None:
                sidecar.close()

    asyncio.run(main())


# ---- the live join, across packages ---------------------------------------

def _jax_learner(data, i, seed):
    shared = JShared(j_get_model("mnist-mlp", dtype=jnp.float32),
                     learning_rate=0.05, batch_size=32)
    return JaxLearner(model=None, data=data.nodes[i], learning_rate=0.05,
                      batch_size=32, seed=seed, trainer=shared)


def _port_learner(data, i, seed):
    shared = SharedTrainer(get_model("mnist-mlp", dtype=torch.float32),
                           learning_rate=0.05, batch_size=32)
    return TorchLearner(data=data.nodes[i], batch_size=32, seed=seed,
                        trainer=shared, device="cpu")


def _data(n, samples=64):
    return JDataset.make(JDataConfig(dataset="mnist",
                                     samples_per_node=samples), n)


def _finished_at(node, rnd):
    """An established node whose run ended at round ``rnd``."""
    node.learner.init()
    node.initialized = True
    node.round = node.total_rounds = rnd
    node.epochs = 1
    node.leader = node.idx
    node.finished.set()


@pytest.mark.parametrize("joiner_kind", ["port", "jax"])
def test_a_joiner_adopts_the_other_packages_state_sync(joiner_kind):
    data = _data(2)

    async def main():
        if joiner_kind == "port":
            est = JNode(0, _jax_learner(data, 0, 0), n_nodes=2,
                        protocol=J_PROTO, gossip_period_s=0.02)
            joiner = P2PNode(1, _port_learner(data, 1, 1), n_nodes=2,
                             protocol=PROTO, gossip_period_s=0.02,
                             joiner=True)
        else:
            est = P2PNode(0, _port_learner(data, 0, 0), n_nodes=2,
                          protocol=PROTO, gossip_period_s=0.02)
            joiner = JNode(1, _jax_learner(data, 1, 1), n_nodes=2,
                           protocol=J_PROTO, gossip_period_s=0.02,
                           joiner=True)
        _finished_at(est, 5)
        try:
            await est.start()
            await joiner.start()
            await joiner.connect_to(est.host, est.port)
            await asyncio.wait_for(joiner.finished.wait(), timeout=LIMIT)
            assert joiner.round == 5 and joiner.initialized
            want = est.learner.get_parameters()
            got = joiner.learner.get_parameters()
            if joiner_kind == "port":
                _same_bits(want, got)
                assert joiner.adopted == ["state_sync"]
            else:
                _same_bits(got, want)
        finally:
            await joiner.stop()
            await est.stop()

    asyncio.run(main())


def test_a_mid_round_state_sync_fast_forwards_at_the_boundary():
    """A joiner that is already learning when STATE_SYNC lands jumps at
    its next round boundary, and never rewinds."""
    data = _data(2)

    async def main():
        est = JNode(0, _jax_learner(data, 0, 0), n_nodes=2, protocol=J_PROTO,
                    gossip_period_s=0.02)
        joiner = P2PNode(1, _port_learner(data, 1, 1), n_nodes=2,
                         protocol=PROTO, gossip_period_s=0.02, joiner=True)
        est.learner.init()
        est.initialized, est.learning = True, True
        est.round, est.total_rounds, est.epochs, est.leader = 3, 5, 1, 0
        try:
            await est.start()
            await joiner.start()
            await joiner.connect_to(est.host, est.port)
            await _until(lambda: joiner.round >= 3)
            assert joiner.learning and joiner.total_rounds == 5
            _same_bits(est.learner.get_parameters(),
                       joiner.learner.get_parameters())
            # an older answer moves nothing
            await est._send_state_sync(est.peers[1])
            await asyncio.sleep(0.2)
            assert joiner.round >= 3
        finally:
            await joiner.stop()
            await est.stop()

    asyncio.run(main())


@pytest.mark.parametrize("sync_round, adopts", [(4, True), (1, False)])
def test_a_resumed_node_takes_only_a_newer_state_sync(tmp_path, sync_round,
                                                      adopts):
    data = _data(2)

    async def main():
        mine = _port_learner(data, 1, 1)
        mine.init()
        ck.save_node_checkpoint(tmp_path, 1, mine.get_parameters(), 2)
        est = JNode(0, _jax_learner(data, 0, 0), n_nodes=2, protocol=J_PROTO,
                    gossip_period_s=0.02)
        _finished_at(est, sync_round)
        node = P2PNode(1, _port_learner(data, 1, 7), n_nodes=2,
                       protocol=PROTO, gossip_period_s=0.02, joiner=True,
                       resume=True, checkpoint_dir=str(tmp_path))
        try:
            await node.start()
            assert node.round == 2 and node.adopted == ["checkpoint"]
            _same_bits(_jax_host(mine.get_parameters()),
                       node.learner.get_parameters())
            await est.start()
            await node.connect_to(est.host, est.port)
            await asyncio.wait_for(node.finished.wait(), timeout=LIMIT)
            if adopts:
                assert node.adopted == ["checkpoint", "state_sync"]
                assert node.round == 4
                _same_bits(est.learner.get_parameters(),
                           node.learner.get_parameters())
            else:
                assert node.adopted == ["checkpoint"] and node.round == 2
                _same_bits(_jax_host(mine.get_parameters()),
                           node.learner.get_parameters())
        finally:
            await node.stop()
            await est.stop()

    asyncio.run(main())


def test_a_learning_resumed_node_decides_once(tmp_path):
    """The peers' catch-up starts the resumed node learning before their
    STATE_SYNCs land: the first answer still decides, and the node adopts
    one model, not every peer's in turn."""
    data = _data(3)

    async def main():
        mine = _port_learner(data, 2, 2)
        mine.init()
        ck.save_node_checkpoint(tmp_path, 2, mine.get_parameters(), 1)
        ests = [JNode(i, _jax_learner(data, i, i), n_nodes=3,
                      protocol=J_PROTO, gossip_period_s=0.02)
                for i in range(2)]
        for est in ests:
            est.learner.init()
            est.initialized, est.learning = True, True
            est.round, est.total_rounds, est.epochs, est.leader = 4, 6, 1, 0
        node = P2PNode(2, _port_learner(data, 2, 7), n_nodes=3,
                       protocol=PROTO, gossip_period_s=0.02, joiner=True,
                       resume=True, checkpoint_dir=str(tmp_path))
        try:
            await node.start()
            for est in ests:
                await est.start()
                await node.connect_to(est.host, est.port)
            await _until(lambda: all(
                est.peers.get(2) is not None for est in ests)
                and node.round >= 4)
            await asyncio.sleep(0.3)  # the second answer has landed
            assert node.learning
            assert node.adopted == ["checkpoint", "state_sync"]
        finally:
            await node.stop()
            for est in ests:
                await est.stop()

    asyncio.run(main())


def _jax_host(tree):
    return jax.tree.map(np.asarray, tree)


# ---- federations ----------------------------------------------------------

def test_a_straggler_crashed_mid_fit_then_rejoins():
    """Crash the straggler while its fit runs in the executor: the fit
    stops at its next epoch (the shared device lock comes free), the
    async quorum keeps the rounds closing, the survivors evict the dead
    node, and a fresh joiner enters through the "jr" hello and STATE_SYNC
    and finishes converged; the crashed learner is not the joiner's."""
    n, rounds = 4, 5
    data = _data(n, samples=120)
    shared = SharedTrainer(get_model("mnist-mlp"), learning_rate=0.05,
                           batch_size=32)
    el = ElasticConfig(heartbeat_backoff_base_s=0.1,
                       heartbeat_backoff_max_s=0.5, **ASYNC)
    proto = ProtocolConfig(heartbeat_period_s=0.2, aggregation_timeout_s=60.0,
                           vote_timeout_s=5.0, node_timeout_s=1.0)
    learners = [TorchLearner(data=data.nodes[i], batch_size=32, seed=0,
                             trainer=shared, device="cpu") for i in range(n)]
    in_fit, fit_over = threading.Event(), threading.Event()
    fit = learners[3].fit

    def slow_fit():
        in_fit.set()
        fit()
        fit_over.set()

    learners[3].fit = slow_fit
    learners[3].set_epochs = lambda e: setattr(learners[3], "epochs", 400)

    async def main():
        nodes = [P2PNode(i, learners[i], n_nodes=n, protocol=proto,
                         gossip_period_s=0.02, elastic=el,
                         fit_slowdown=3.0 if i == 3 else 1.0)
                 for i in range(n)]
        joiner = None
        try:
            for nd in nodes:
                await nd.start()
            for i in range(n):
                for j in range(i + 1, n):
                    await nodes[i].connect_to(nodes[j].host, nodes[j].port)
            nodes[0].learner.init()
            nodes[0].set_start_learning(rounds=rounds, epochs=1)
            await _until(in_fit.is_set)
            await nodes[3].crash()
            await _until(fit_over.is_set, timeout=30)
            await _until(lambda: all(bool(nd.membership.departed[3])
                                     for nd in nodes[:3]))
            ln = TorchLearner(data=data.nodes[3], batch_size=32, seed=0,
                              trainer=shared, device="cpu")
            joiner = P2PNode(3, ln, n_nodes=n, protocol=proto,
                             gossip_period_s=0.02, elastic=el, joiner=True)
            await joiner.start()
            for i in range(3):
                await joiner.connect_to(nodes[i].host, nodes[i].port)
            await asyncio.wait_for(asyncio.gather(
                *(nd.finished.wait() for nd in (*nodes[:3], joiner))),
                timeout=LIMIT)
            assert all(nd.error is None for nd in (*nodes[:3], joiner))
            assert all(nd.round == rounds for nd in nodes[:3])
            assert joiner.initialized and joiner.round == rounds
            assert "state_sync" in joiner.adopted
            assert joiner.learner is not learners[3]
            assert joiner.learner.evaluate()["accuracy"] > 0.5
            assert all(3 in nd.membership.get_nodes() for nd in nodes[:3])
        finally:
            for nd in nodes:
                await nd.stop()
            if joiner is not None:
                await joiner.stop()

    asyncio.run(main())


def test_run_simulation_declarative_churn():
    """The elastic block's fractions become a straggler and a churner; a
    crash and a live rejoin run through ``run_simulation``."""
    cfg = ScenarioConfig(
        name="elastic-sim", n_nodes=4, topology="fully",
        data=DataConfig(dataset="mnist", samples_per_node=60),
        training=TrainingConfig(rounds=3, epochs_per_round=1,
                                learning_rate=0.05),
        protocol=ProtocolConfig(heartbeat_period_s=0.2,
                                aggregation_timeout_s=60.0,
                                vote_timeout_s=5.0, node_timeout_s=1.5),
        elastic=ElasticConfig(heartbeat_backoff_base_s=0.1,
                              heartbeat_backoff_max_s=0.5,
                              straggler_fraction=0.25, straggler_factor=2.0,
                              churn_fraction=0.25, **ASYNC))
    slow = [i for i, nc in enumerate(cfg.nodes) if nc.fit_slowdown > 1.0]
    crashed = sorted({f.node for f in cfg.faults if f.kind == "crash"})
    assert len(slow) == 1 and len(crashed) == 1 and slow != crashed
    nodes: list = []
    out = run_simulation(cfg, timeout=240, device="cpu", nodes_out=nodes)
    assert out["rounds"] == 3
    churn = out["churn"]
    assert churn["async"] is True
    assert churn["crashes"] == churn["joined"] == crashed
    assert churn["stragglers"] == slow and churn["restarted"] == []
    assert 0.0 < out["mean_accuracy"] <= 1.0
    rejoined = nodes[crashed[0]]
    assert rejoined.joiner and rejoined.initialized
