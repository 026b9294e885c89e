"""The port's secure aggregation (``privacy/secagg.py``) against the JAX
package's, on the CPU.

- Bit parity, tolerance 0: the seeded pair secrets, the round seeds,
  ``_pair_stream``, the quantized update and every masked update equal
  the JAX package's for one seed, one tree and one weight (an f32 tree
  and a bf16 one, by their words), and so do the reveal shares and the
  residue of a dead member.
- Exactness, tolerance 0, on dyadic-grid trees (every value and every
  power-of-two weighted mean exact in f32 and int64): the masks cancel
  in the sum; a masked ``AggregationSession`` equals plain FedAvg; a
  member evicted before its entry lands is unmasked from the seeded
  secrets, or, under ECDH-style secrets, only once the survivors'
  reveal shares are in (atol 2^-22 for a total weight of 3).
- The masker's guards, the session's missing reference, the node's
  refusal of a sidecar with a masker, and the schema's refusals, with
  the JAX package's messages; the stacked ``Scenario`` refuses secagg
  as JAX's does.
- A mixed fleet under secure aggregation, 4 mnist-mlp nodes fully
  connected (JAX nodes 0 and 1, port nodes 2 and 3, f32, one batch an
  epoch, 2 rounds): every node within rtol 1e-5, atol 1e-6 of the same
  node in an all-JAX fleet under secure aggregation on the same inputs.
- ``run_simulation`` with ``privacy.secagg`` on shaped links.
"""

from __future__ import annotations

import asyncio
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.privacy import secagg as J
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.core.aggregators import FedAvg
from p2pfl_tpu_torch.core.serialize import BF16Array, tree_leaves_sorted
from p2pfl_tpu_torch.obs import flight
from p2pfl_tpu_torch.p2p import P2PNode
from p2pfl_tpu_torch.p2p.session import AggregationSession
from p2pfl_tpu_torch.privacy import secagg as T


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
    return {"dense": {"kernel": rng.standard_normal((5, 4)).astype(np.float32),
                      "bias": rng.standard_normal(4).astype(np.float32)},
            "a": rng.standard_normal(3).astype(np.float32)}


def _grid_tree(seed: int) -> dict:
    """An f32 tree on the grid k / 2^10, |k| < 2^12: every value, its
    quantization and every power-of-two weighted mean are exact."""
    rng = np.random.default_rng(seed)
    return {"w": rng.integers(-2048, 2048, (4, 3)).astype(np.float32) / 1024,
            "b": rng.integers(-2048, 2048, 3).astype(np.float32) / 1024}


def _same_bits(a, b) -> bool:
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _trees_bitwise(jax_tree, port_tree) -> None:
    got = tree_leaves_sorted(port_tree)
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert _same_bits(a, b)


# ---- bit parity with the JAX package ---------------------------------------

def test_pair_secrets_round_seeds_and_streams_equal_jax():
    for i, j, root in ((0, 1, 0), (5, 2, 9), (3, 7, 2**40 + 3)):
        s = T.fallback_pair_secret(i, j, root)
        assert s == J.fallback_pair_secret(i, j, root)
        assert s == T.fallback_pair_secret(j, i, root)
        for rnd in (0, 1, 17):
            assert T.round_pair_seed(s, rnd) == J.round_pair_seed(s, rnd)
    layout = [((5, 4), np.float32), ((3,), np.float32), ((), np.float32)]
    seed = T.round_pair_seed(T.fallback_pair_secret(1, 2, 3), 4)
    for a, b in zip(J._pair_stream(seed, layout),
                    T._pair_stream(seed, layout)):
        assert _same_bits(a, b) and b.dtype == np.uint64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_and_masked_updates_equal_jax(dtype):
    """Every member's masked update, the quantized update, a reveal
    share and the residue of a dead member: the JAX package's bits (a
    bf16 tree as ml_dtypes in JAX and as its words in the port)."""
    tree = _tree(1)
    jtree = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16)
                         if dtype == "bfloat16" else x, tree)
    ttree = jax.tree.map(
        lambda x: np.asarray(x).view(np.uint16).view(BF16Array)
        if dtype == "bfloat16" else x, jtree)
    _trees_bitwise(J.quantize_update(jtree, 7), T.quantize_update(ttree, 7))
    members, rnd = [0, 1, 2, 3], 3
    jm = [J.PairwiseMasker(i, root_seed=11) for i in members]
    tm = [T.PairwiseMasker(i, root_seed=11) for i in members]
    for a, b in zip(jm, tm):
        a.begin_round(rnd, members)
        b.begin_round(rnd, members)
        _trees_bitwise(a.mask_update(jtree, 5), b.mask_update(ttree, 5))
        assert a.reveal_share(3) == b.reveal_share(3)
    jm[0].note_evicted(3)
    tm[0].note_evicted(3)
    _trees_bitwise(jm[0].residue({0, 1, 2}), tm[0].residue({0, 1, 2}))


def test_dequantized_sum_equals_jax():
    trees = [_tree(10 + i) for i in range(3)]
    jacc, jt = J.masked_sum([(J.quantize_update(t, 2), 2) for t in trees])
    tacc, tt = T.masked_sum([(T.quantize_update(t, 2), 2) for t in trees])
    assert jt == tt == 6.0
    _trees_bitwise(jacc, tacc)
    _trees_bitwise(J.dequantize_sum(jacc, jt, trees[0]),
                   T.dequantize_sum(tacc, tt, trees[0]))


def test_ecdh_pair_secret_equals_jax_and_is_symmetric():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric import ec

    k1 = ec.generate_private_key(ec.SECP256R1())
    k2 = ec.generate_private_key(ec.SECP256R1())
    s12 = T.ecdh_pair_secret(k1, k2.public_key())
    assert s12 == T.ecdh_pair_secret(k2, k1.public_key())
    assert s12 == J.ecdh_pair_secret(k1, k2.public_key()) and len(s12) == 32


# ---- exactness --------------------------------------------------------

def test_masks_cancel_in_the_sum():
    members, rnd = [0, 1, 2], 5
    maskers = [T.PairwiseMasker(i, root_seed=11) for i in members]
    for m in maskers:
        m.begin_round(rnd, members)
    trees = [_grid_tree(20 + i) for i in members]
    weights = [1, 1, 2]  # a power-of-two total: the mean is exact
    entries = []
    for m, t, w in zip(maskers, trees, weights):
        masked = m.mask_update(t, w)
        assert not _same_bits(masked["w"], T.quantize_update(t, w)["w"])
        entries.append((masked, w))
    acc, total = T.masked_sum(entries)
    got = T.dequantize_sum(acc, total, trees[0])
    for k in ("w", "b"):
        want = sum(np.float32(w) * t[k] for w, t in zip(weights, trees)) / 4
        assert _same_bits(got[k], want)


def test_pair_seed_symmetry_and_round_freshness():
    a, b = T.PairwiseMasker(0, root_seed=3), T.PairwiseMasker(2, root_seed=3)
    assert a.pair_seed(0, 2, 4) == b.pair_seed(2, 0, 4)
    assert a.pair_seed(0, 2, 4) != a.pair_seed(0, 2, 5)


def test_masker_guards():
    m = T.PairwiseMasker(0, root_seed=0)
    with pytest.raises(T.SecaggError, match="begin_round"):
        m.mask_update(_grid_tree(0), 1)
    with pytest.raises(T.SecaggError, match="reveal_share"):
        m.reveal_share(1)
    with pytest.raises(T.SecaggError, match="bits"):
        T.PairwiseMasker(0, bits=50)
    with pytest.raises(T.SecaggError, match="zero entries"):
        T.masked_sum([])
    with pytest.raises(T.SecaggError, match="weight"):
        T.quantize_update(_grid_tree(0), 0)


def _drive(session, entries, reference=None):
    async def run():
        session.set_nodes_to_aggregate(range(len(entries)))
        if reference is not None:
            session.set_reference(reference)
        for i, (tree, w) in enumerate(entries):
            session.add_model(tree, [i], w)
        assert session.done.is_set()
        return session.result[0]

    return asyncio.run(run())


def test_masked_session_equals_plain_fedavg_bit_for_bit():
    n = 4
    trees = [_grid_tree(40 + i) for i in range(n)]
    plain = _drive(AggregationSession(FedAvg()), [(t, 1.0) for t in trees])
    maskers = [T.PairwiseMasker(i, root_seed=5) for i in range(n)]
    for m in maskers:
        m.begin_round(2, range(n))
    masked = _drive(
        AggregationSession(FedAvg(), masker=maskers[0]),
        [(m.mask_update(t, 1), 1.0) for m, t in zip(maskers, trees)],
        reference=jax.tree.map(np.zeros_like, trees[0]))
    for k in ("w", "b"):
        assert _same_bits(plain[k], masked[k])


def test_masked_session_requires_a_reference():
    maskers = [T.PairwiseMasker(i, root_seed=5) for i in range(2)]
    for m in maskers:
        m.begin_round(0, range(2))
    with pytest.raises(T.SecaggError, match="reference"):
        _drive(AggregationSession(FedAvg(), masker=maskers[0]),
               [(m.mask_update(_grid_tree(80 + i), 1), 1.0)
                for i, m in enumerate(maskers)])


def test_dropout_residue_unmask_with_seeded_secrets():
    """Node 3 is evicted before its entry lands: the closer rebuilds the
    dead pairs' streams and recovers the survivors' exact mean."""
    members, rnd = [0, 1, 2, 3], 2
    maskers = [T.PairwiseMasker(i, root_seed=9) for i in members]
    for m in maskers:
        m.begin_round(rnd, members)
    trees = [_grid_tree(90 + i) for i in members]
    weights = [1, 1, 2, 1]
    masked = [m.mask_update(t, w) for m, t, w in zip(maskers, trees, weights)]
    closer = maskers[0]
    closer.note_evicted(3)
    acc, total = T.masked_sum(list(zip(masked[:3], weights[:3])))
    got, dead = closer.unmask(acc, total, {0, 1, 2}, trees[0])
    assert dead == [3]
    for k in ("w", "b"):
        want = sum(np.float32(w) * t[k]
                   for w, t in zip(weights[:3], trees[:3])) / 4
        assert _same_bits(got[k], want)
    # a dead member whose entry landed needs no reconstruction
    closer.note_evicted(2)
    assert closer.residue({0, 1, 2}) is not None  # 3's residue only
    acc4, total4 = T.masked_sum(list(zip(masked, weights)))
    _, dead4 = closer.unmask(acc4, total4, {0, 1, 2, 3}, trees[0])
    assert dead4 == []


def test_dropout_under_ecdh_secrets_needs_the_reveal_shares():
    members, rnd = [0, 1, 2, 3], 4
    rng = np.random.default_rng(0)
    secret = {(i, j): rng.bytes(32) for i in members for j in members
              if i < j}
    maskers = [T.PairwiseMasker(
        i, pair_secrets={j: secret[(min(i, j), max(i, j))]
                         for j in members if j != i}) for i in members]
    for m in maskers:
        m.begin_round(rnd, members)
    trees = [_grid_tree(130 + i) for i in members]
    masked = [m.mask_update(t, 1) for m, t in zip(maskers, trees)]
    closer = maskers[0]
    closer.note_evicted(3)
    acc, total = T.masked_sum([(t, 1) for t in masked[:3]])
    with pytest.raises(T.SecaggUnmaskError, match="reveal share"):
        closer.unmask(acc, total, {0, 1, 2}, trees[0])
    for survivor in (1, 2):
        closer.add_share(survivor, 3, rnd, maskers[survivor].reveal_share(3))
    got, dead = closer.unmask(acc, total, {0, 1, 2}, trees[0])
    assert dead == [3]
    for k in ("w", "b"):
        want = sum(t[k] for t in trees[:3]) / np.float32(3.0)
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2.0 ** -22)


# ---- refusals --------------------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(adversary={"reputation": True}),
    dict(aggregation_plane="sidecar"),
    dict(wire_dtype="bf16"),
    dict(elastic={"async_aggregation": True, "min_received": 0.5}),
    dict(cross_device={"n_clients": 64, "clients_per_round": 8,
                       "cohort_size": 2}),
])
def test_schema_refuses_secagg_as_jax_does(over):
    raw = {"n_nodes": 4, "privacy": {"secagg": True}, **over}
    with pytest.raises(ValueError) as want:
        jschema.ScenarioConfig.from_dict(raw)
    with pytest.raises(ValueError) as got:
        tschema.ScenarioConfig.from_dict(raw)
    assert str(got.value) == str(want.value)


def test_secagg_scenario_loads_equal_and_the_stacked_scenario_refuses(
        tmp_path):
    from p2pfl_tpu.federation.scenario import Scenario as JScenario
    from p2pfl_tpu_torch.federation.scenario import Scenario

    raw = {"n_nodes": 4, "privacy": {"secagg": True, "secagg_bits": 20},
           "topology": "fully"}
    jcfg = jschema.ScenarioConfig.from_dict(raw)
    path = tmp_path / "s.json"
    jcfg.save(path)
    tcfg = tschema.ScenarioConfig.load(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError) as want:
        JScenario(jcfg)
    with pytest.raises(ValueError) as got:
        Scenario(tcfg, device="cpu")
    assert str(got.value) == str(want.value)


def test_node_refuses_a_sidecar_with_a_masker():
    with pytest.raises(ValueError, match="sidecar"):
        P2PNode(0, None, n_nodes=2, sidecar=object(),
                masker=T.PairwiseMasker(0))


# ---- a mixed fleet -----------------------------------------------------

def _secagg_fleet(kinds, samples: int = 64, rounds: int = 2):
    """Nodes of ``kinds`` ("jax" / "port"), f32 compute and wire, one
    batch an epoch, each with its package's masker on seeded secrets;
    node 0 starts."""
    import jax.numpy as jnp

    from p2pfl_tpu.learning import JaxLearner
    from p2pfl_tpu.learning.learner import SharedTrainer as JShared
    from p2pfl_tpu.models import get_model as j_get_model
    from p2pfl_tpu.p2p import P2PNode as JNode
    from test_torch_socket import (
        J_PROTO,
        PROTO,
        _data,
        _fleet,
        _port_learner,
        _port_shared,
    )

    n = len(kinds)
    data = _data(n, samples)
    jshared = JShared(j_get_model("mnist-mlp", dtype=jnp.float32),
                      learning_rate=0.05, batch_size=samples)
    tshared = _port_shared(batch=samples, dtype=torch.float32)
    nodes = []
    for i, kind in enumerate(kinds):
        if kind == "jax":
            ln = JaxLearner(model=None, data=data.nodes[i],
                            learning_rate=0.05, batch_size=samples, seed=0,
                            trainer=jshared)
            nodes.append(JNode(i, ln, n_nodes=n, protocol=J_PROTO,
                               gossip_period_s=0.02,
                               masker=J.PairwiseMasker(i, root_seed=7)))
        else:
            nodes.append(P2PNode(
                i, _port_learner(data.nodes[i], tshared, samples),
                n_nodes=n, protocol=PROTO, gossip_period_s=0.02,
                masker=T.PairwiseMasker(i, root_seed=7)))
    return asyncio.run(_fleet(nodes, rounds=rounds))


def _params(node) -> list[np.ndarray]:
    return [np.asarray(x, np.float32)
            for x in tree_leaves_sorted(node.learner.get_parameters())]


def test_mixed_fleet_under_secagg_matches_the_all_jax_fleet():
    ref = _secagg_fleet(["jax"] * 4)
    mixed = _secagg_fleet(["jax", "jax", "port", "port"])
    assert all(nd.round == 2 for nd in ref + mixed)
    for a, b in zip(ref, mixed):
        for x, y in zip(_params(a), _params(b)):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)


def test_run_simulation_under_secagg_on_shaped_links():
    """A scenario with ``privacy.secagg`` and ``network`` shaping runs
    through ``run_simulation``: every node masks, every round closes."""
    from p2pfl_tpu_torch.p2p.launch import run_simulation

    cfg = tschema.ScenarioConfig.from_dict({
        "name": "secagg-sim", "n_nodes": 3, "topology": "fully",
        "data": {"dataset": "mnist", "samples_per_node": 40},
        "training": {"rounds": 2, "epochs_per_round": 1,
                     "learning_rate": 0.05},
        "protocol": {"heartbeat_period_s": 0.2, "aggregation_timeout_s": 30,
                     "vote_timeout_s": 10},
        "privacy": {"secagg": True},
        "network": {"delay_ms": 2, "jitter_ms": 1, "seed": 3}})
    nodes: list = []
    res = run_simulation(cfg, timeout=120, device="cpu", nodes_out=nodes)
    assert res["rounds"] == 2 and res["loop_payload_touch_bytes"] > 0
    assert all(nd.masker is not None and nd.shaper is not None
               for nd in nodes)
    assert all(nd.masker.round_num == 1 for nd in nodes)
