"""The socket plane's adversarial layer against the JAX package's, on the
CPU: reputation over session entries, attacks and DP on a node's own
update, and the federations that run them.

- ``ReputationMonitor.observe_entries`` / ``entry_scales``: the same
  entries (singletons, merged partials, an amplified sign-flipper, f32
  and bf16 leaves) give the JAX monitor's trust and scales within rtol
  1e-6, the same suspects and the same confirmed culprits.
- A session with reputation: the JAX session's fused result within rtol
  1e-6 (atol 1e-7) and its trust within rtol 1e-6.
- A socket node's own update (``_update_reference``, the fit,
  ``_transform_own_update`` on its device): signflip, scale and
  freerider give JAX's ``poison_update`` bits on the same host trees
  (f32 and bf16); every attack, DP, and an attack then DP give the
  bits of the port's ``poison_stacked`` / ``privatize_stacked`` row for
  that node (tolerance 0; noise and DP draw from the same CPU
  generators as the stacked rows).
- The schema's composition refusals (secagg with reputation, secagg
  with async) raise the JAX package's ``ValueError``.
- Federations through ``run_simulation``: the 4-node reputation
  recovery (undefended FedAvg collapses, every honest monitor ranks the
  sign-flipper below each honest peer), DP (the result's privacy keys
  are the JAX package's ``_privacy_status``, epsilon is ``epsilon_at``),
  and a label-flipper's poisoned shard.

Every deadline that is not under test is wide, and no happy path waits
out a timeout.
"""

from __future__ import annotations

import asyncio
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from p2pfl_tpu import adversary as jadv
from p2pfl_tpu.config.schema import ScenarioConfig as JScenarioConfig
from p2pfl_tpu.p2p import launch as jlaunch
from p2pfl_tpu.p2p.session import AggregationSession as JSession
from p2pfl_tpu_torch import adversary as tadv
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.core.pytree import tree_map
from p2pfl_tpu_torch.core.serialize import (
    BF16Array,
    to_host,
    tree_leaves_sorted,
)
from p2pfl_tpu_torch.datasets.data import FederatedDataset
from p2pfl_tpu_torch.learning.learner import SharedTrainer, TorchLearner
from p2pfl_tpu_torch.models import get_model
from p2pfl_tpu_torch.p2p import P2PNode
from p2pfl_tpu_torch.p2p.launch import run_simulation
from p2pfl_tpu_torch.p2p.session import AggregationSession
from p2pfl_tpu_torch.privacy.dp import DPSpec, epsilon_at, privatize_stacked

pytestmark = [
    pytest.mark.filterwarnings("error::ResourceWarning"),
    pytest.mark.filterwarnings("error:.*was never awaited:RuntimeWarning"),
]

TRUST_TOL = dict(rtol=1e-6, atol=0)
LIMIT = 300  # seconds for a whole federation


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _jax_host(tree):
    """A port host tree as the JAX package holds it (bf16 words as
    ``ml_dtypes.bfloat16``)."""
    def leaf(a):
        if isinstance(a, BF16Array):
            return np.asarray(a).view(np.uint16).view(ml_dtypes.bfloat16)
        return np.asarray(a)

    return {k: _jax_host(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def _port_host(tree):
    """A JAX host tree (ml_dtypes bf16) as the port's (``BF16Array``)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return a.view(np.uint16).view(BF16Array)
        return a

    return {k: _port_host(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def _words(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


# ---- reputation over entries ----------------------------------------------

def _entry_tree(rng, ref, scale=1.0, bf16=False):
    """``ref`` plus a common direction and some noise, times ``scale``."""
    out = {}
    for layer, leaves in ref.items():
        out[layer] = {}
        for name, r in leaves.items():
            base = np.linspace(-1, 1, r.size, dtype=np.float32).reshape(r.shape)
            d = scale * (base + 0.3 * rng.standard_normal(r.shape)
                         .astype(np.float32))
            v = np.asarray(r, np.float32) + d
            out[layer][name] = _bf16(v) if bf16 else v.astype(np.float32)
    return out


def _ref(rng, bf16=False):
    tree = {"Dense_0": {"bias": rng.standard_normal(6).astype(np.float32),
                        "kernel": rng.standard_normal((8, 6))
                        .astype(np.float32)},
            "Dense_1": {"bias": rng.standard_normal(3).astype(np.float32),
                        "kernel": rng.standard_normal((6, 3))
                        .astype(np.float32)}}
    if bf16:
        tree["Dense_1"] = {k: _bf16(v) for k, v in tree["Dense_1"].items()}
    return tree


@pytest.mark.parametrize("bf16", [False, True])
def test_observe_entries_and_entry_scales_match_jax(bf16):
    n = 6
    rng = np.random.default_rng(11)
    j = jadv.ReputationMonitor(n, alpha=0.7, cutoff=0.15)
    t = tadv.ReputationMonitor(n, alpha=0.7, cutoff=0.15)
    keysets = [
        [{0}, {1}, {2}, {3}, {4}, {5}],
        [{0, 1}, {2}, {3, 4}, {5}],
        [{0}, {1, 2}, {3}, {4, 5}],
        [{0, 2}, {1}, {3}, {4}, {5}],
    ]
    for rnd, keys in enumerate(keysets):
        ref = _ref(rng, bf16)
        entries = []
        for key in keys:
            # node 2 flips its sign at scale 8; node 4 rides free
            scale = -8.0 if 2 in key else (0.0 if key == {4} else 1.0)
            entries.append((frozenset(key),
                            _entry_tree(rng, ref, scale, bf16)))
        j.observe_entries(ref, entries)
        t.observe_entries(_port_host(ref),
                          [(k, _port_host(p)) for k, p in entries])
        np.testing.assert_allclose(t.trust, j.trust, **TRUST_TOL)
        keys = [frozenset(k) for k in keys] + [frozenset(), frozenset({9})]
        np.testing.assert_allclose(t.entry_scales(keys), j.entry_scales(keys),
                                   **TRUST_TOL)
        assert t.suspects() == j.suspects()
        assert np.array_equal(t._confirmed_bad, j._confirmed_bad)
    assert 2 in t.suspects() and t._confirmed_bad[2]


def test_session_with_reputation_matches_jax():
    """Three rounds of one session each: scored at finish (three entries
    or more), weighed by ``entry_scales`` in the fuse."""
    n = 5
    rng = np.random.default_rng(3)
    jmon, tmon = (jadv.ReputationMonitor(n), tadv.ReputationMonitor(n))

    async def main():
        js = JSession(timeout_s=60, reputation=jmon)
        ts = AggregationSession(timeout_s=60, reputation=tmon)
        for rnd in range(3):
            ref = _ref(rng)
            trees = [_entry_tree(rng, ref, -6.0 if i == 3 else 1.0)
                     for i in range(n)]
            for s in (js, ts):
                s.clear()
                s.set_nodes_to_aggregate(set(range(n)))
            js.set_reference(ref)
            ts.set_reference(_port_host(ref))
            for i, tree in enumerate(trees):
                a = js.add_model(tree, (i,), 10 + i)
                b = ts.add_model(_port_host(tree), (i,), 10 + i)
                assert a == b
            assert js.done.is_set() and ts.done.is_set()
            for x, y in zip(jax.tree.leaves(js.result[0]),
                            tree_leaves_sorted(ts.result[0])):
                np.testing.assert_allclose(y, np.asarray(x), rtol=1e-6,
                                           atol=1e-7)
            np.testing.assert_allclose(tmon.trust, jmon.trust, **TRUST_TOL)
        assert 3 in tmon.suspects()

    asyncio.run(main())


# ---- a socket node's own update -------------------------------------------

def _data(n: int, samples: int = 64) -> FederatedDataset:
    from p2pfl_tpu_torch.config.schema import DataConfig

    return FederatedDataset.make(
        DataConfig(dataset="mnist", samples_per_node=samples), n)


def _own_update(param_dtype, idx=2, rnd=1, attack=None, dp=None):
    """One node's round: the round-start reference, the fit and the
    transform, on the CPU. Returns (ref, trained, sent) device trees
    and the node."""
    data = _data(4)
    shared = SharedTrainer(get_model("mnist-mlp", param_dtype=param_dtype),
                           learning_rate=0.05, batch_size=32)
    ln = TorchLearner(data=data.nodes[idx], batch_size=32, seed=idx,
                      trainer=shared, device="cpu")
    ln.init()
    node = P2PNode(idx, ln, n_nodes=4, attack=attack, dp=dp)
    node.round = rnd

    async def main():
        ref = await node._update_reference()
        await node._fit()
        trained = ln.device_parameters()
        await node._transform_own_update(ref)
        return ref, trained, ln.device_parameters()

    return (*asyncio.run(main()), node)


def _stack_around(row: dict, idx: int, n: int, seed: int) -> dict:
    """An ``[n, ...]`` tree with ``row`` at ``idx`` and seeded rows else."""
    g = torch.Generator().manual_seed(seed)

    def leaf(x):
        rows = [torch.randn(x.shape, generator=g).to(x.dtype)
                for _ in range(n)]
        rows[idx] = x
        return torch.stack(rows)

    return tree_map(leaf, row)


def _assert_row_bits(stacked, idx, tree):
    for s, x in zip(tree_leaves_sorted(stacked), tree_leaves_sorted(tree)):
        assert s.dtype == x.dtype
        assert torch.equal(s[idx].view(torch.int16 if x.dtype == torch.bfloat16
                                       else torch.int32),
                           x.view(torch.int16 if x.dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["signflip", "scale", "freerider"])
def test_a_nodes_deterministic_attack_gives_the_jax_bits(kind, param_dtype):
    spec = tadv.AttackSpec(kind=kind, scale=7.5, seed=3)
    ref, trained, sent, node = _own_update(param_dtype, attack=spec)
    want = jadv.poison_update(
        _jax_host(tree_map(to_host, trained)), _jax_host(tree_map(to_host, ref)),
        2, 1, jadv.AttackSpec(kind=kind, scale=7.5, seed=3))
    got = node.learner.get_parameters()
    for w, g in zip(jax.tree.leaves(want), tree_leaves_sorted(got)):
        assert np.array_equal(_words(np.asarray(w)), _words(g))
    # the host copy the node ships is the device params
    for g, d in zip(tree_leaves_sorted(got), tree_leaves_sorted(sent)):
        assert np.array_equal(_words(g), _words(to_host(d)))


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["signflip", "scale", "freerider", "noise",
                                  "dp", "noise+dp"])
def test_a_nodes_update_has_the_stacked_rows_bits(what, param_dtype):
    attack = (tadv.AttackSpec(kind=what.split("+")[0], scale=10.0, seed=7)
              if what != "dp" else None)
    dp = (DPSpec(clip_norm=1.0, noise_multiplier=1.0, seed=5)
          if what.endswith("dp") else None)
    ref, trained, sent, _ = _own_update(param_dtype, attack=attack, dp=dp)
    n, idx = 4, 2
    stacked = _stack_around(trained, idx, n, seed=1)
    ref_stacked = _stack_around(ref, idx, n, seed=2)
    mask = np.zeros(n, bool)
    mask[idx] = True
    if attack is not None:
        stacked = tadv.poison_stacked(stacked, ref_stacked, mask, 1, attack)
    if dp is not None:
        stacked = privatize_stacked(stacked, ref_stacked, mask, 1, dp)
    _assert_row_bits(stacked, idx, sent)


def test_an_honest_nodes_update_is_left_alone():
    ref, trained, sent, node = _own_update(torch.float32)
    assert ref is None
    for a, b in zip(tree_leaves_sorted(trained), tree_leaves_sorted(sent)):
        assert torch.equal(a, b)


# ---- composition refusals -------------------------------------------------

@pytest.mark.parametrize("raw, match", [
    ({"privacy": {"secagg": True},
      "adversary": {"reputation": True}}, "reputation"),
    ({"privacy": {"secagg": True},
      "elastic": {"async_aggregation": True}}, "async"),
])
def test_secagg_compositions_are_refused_as_in_jax(raw, match):
    for cls in (ScenarioConfig, JScenarioConfig):
        with pytest.raises(ValueError, match=match):
            cls.from_dict({"n_nodes": 4, **raw})


# ---- federations ----------------------------------------------------------

def _fed(**raw):
    base = {
        "name": "sockadv", "n_nodes": 4, "topology": "fully",
        "data": {"dataset": "mnist", "batch_size": 16,
                 "samples_per_node": 64},
        "model": {"model": "mlp"},
        "training": {"rounds": 6, "eval_every": 0},
        "protocol": {"heartbeat_period_s": 0.2,
                     "aggregation_timeout_s": 120.0,
                     "vote_timeout_s": 60.0,
                     "gossip_exit_on_equal_rounds": 40},
    }
    base.update(raw)
    return base


def test_socket_reputation_recovery_4node():
    """One sign-flipper among 4: undefended FedAvg collapses, and with
    reputation every honest node's monitor ranks the attacker below each
    honest peer and excludes it."""
    def cfg(reputation):
        return ScenarioConfig.from_dict(_fed(adversary={
            "nodes": [2], "kind": "signflip", "reputation": reputation}))

    atk = run_simulation(cfg(False), timeout=LIMIT, device="cpu")
    rep = run_simulation(cfg(True), timeout=LIMIT, device="cpu")
    assert atk["rounds"] == rep["rounds"] == 6
    assert "trust" not in atk
    assert atk["mean_accuracy"] < 0.5
    assert rep["mean_accuracy"] > atk["mean_accuracy"] + 0.25
    assert 2 in rep["suspects"]
    for i, trust in enumerate(rep["trust"]):
        if i == 2:
            continue
        t = np.asarray(trust)
        assert all(t[2] < t[j] for j in range(4) if j not in (i, 2)), (i, t)


def test_dp_federation_reports_the_jax_privacy_keys(tmp_path):
    from p2pfl_tpu_torch.utils.monitor import read_statuses

    raw = _fed(name="dp", n_nodes=3, training={"rounds": 2},
               privacy={"dp": True, "clip_norm": 1.0,
                        "noise_multiplier": 1.0, "epsilon_budget": 50.0},
               log_dir=str(tmp_path))
    cfg = ScenarioConfig.from_dict(raw)
    nodes: list = []
    res = run_simulation(cfg, timeout=LIMIT, device="cpu", nodes_out=nodes)
    assert res["rounds"] == 2
    assert all(nd.dp == DPSpec(1.0, 1.0, cfg.seed) for nd in nodes)
    jcfg = JScenarioConfig.from_dict(json.loads(cfg.to_json()))
    want = jlaunch._privacy_status(jcfg, 2)
    assert {k: res[k] for k in want} == want
    assert res["dp_epsilon"] == round(epsilon_at(1.0, 2, cfg.privacy.delta), 4)
    for rec in read_statuses(tmp_path / "dp" / "status"):
        assert rec["dp_epsilon"] == want["dp_epsilon"]


def test_a_label_flipper_trains_on_its_flipped_shard():
    raw = _fed(name="flip", n_nodes=3, training={"rounds": 1},
               adversary={"nodes": [1], "kind": "labelflip"})
    nodes: list = []
    res = run_simulation(ScenarioConfig.from_dict(raw), timeout=LIMIT,
                         device="cpu", nodes_out=nodes)
    assert res["rounds"] == 1
    clean = FederatedDataset.make(ScenarioConfig.from_dict(raw).data, 3)
    y1 = nodes[1].learner.data.y
    assert np.array_equal(y1, tadv.flip_labels(clean.nodes[1].y, 10))
    assert np.array_equal(nodes[0].learner.data.y, clean.nodes[0].y)
    # a data attack leaves the update alone
    assert nodes[1].attack is not None and not nodes[1]._poisons_updates()

