"""The slice as a whole: the JAX Scenario and the port's Scenario on the
same scenario JSON, from the same initial weights.

FEMNIST-CNN (hidden 64) on 4 nodes, ring DFL and star CFL, dense
transport, 3 local epochs a round, 2 rounds, on the seeded synthetic
surrogate. The port starts from the JAX package's initial parameters
(``params_from_jax`` + ``reseed_params``). The batch is the whole shard,
so each epoch is one step and the JAX package's threefry permutation
only reorders rows inside that one batch: the two runs agree without
reproducing JAX's random numbers. Two tiers:

- the main path's arithmetic, bf16 compute and bf16 wire. Each side
  rounds to bf16 at its own points (XLA:CPU sums a bias gradient in
  bf16 steps, PyTorch in f32), and training amplifies the difference:
  round-1 train loss within rtol 5e-3, round-2 within 8e-2; final
  parameters within relative L2 2e-2 per kernel and 1e-1 per bias (the
  bias gradients are where the two round differently); per-node test
  accuracy within 0.07 (9 of 128 images).
- the same DFL scenario in f32 compute and f32 wire, where nothing is
  rounded to bf16: losses and parameters within rtol 1e-5, accuracies
  equal. This tier pins the round's logic; the first pins the bf16
  path the card runs.

A multi-step run (batch smaller than the shard) with the port's own
generator must train: the loss falls.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation.scenario import Scenario as JaxScenario
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.federation.scenario import Scenario
from p2pfl_tpu_torch.parallel.federated import reseed_params

N = 4
SHARD = 18  # 20 samples a node less the 10% validation split
BF16_LOSS_RTOL = (5e-3, 8e-2)  # round 1, round 2
BF16_PARAM_REL_L2 = {"kernel": 2e-2, "bias": 1e-1}
BF16_ACC_ATOL = 0.07
F32_RTOL = 1e-5


def _jax_config(federation: str, topology: str, batch: int = SHARD,
                rounds: int = 2) -> jschema.ScenarioConfig:
    return jschema.ScenarioConfig(
        name=f"parity-{federation}",
        federation=federation,
        topology=topology,
        n_nodes=N,
        data=jschema.DataConfig(dataset="femnist", samples_per_node=20,
                                batch_size=batch, synthetic_train=2000,
                                synthetic_test=128),
        model=jschema.ModelConfig(model="femnist-cnn",
                                  kwargs={"hidden": 64}),
        training=jschema.TrainingConfig(rounds=rounds, epochs_per_round=3,
                                        learning_rate=0.05),
        transport="dense",
        wire_dtype="bf16",
    )


def _jax_losses(history) -> np.ndarray:
    """[rounds, n] train loss from the JAX logger's records."""
    recs = [r for r in history if "Train/loss" in r]
    rounds = sorted({r["round"] for r in recs})
    out = np.zeros((len(rounds), N))
    for r in recs:
        out[rounds.index(r["round"]), r["node"]] = r["Train/loss"]
    return out


def _run_both(tmp_path, jcfg):
    """Run the JAX Scenario and the port's from the JAX initial params;
    returns (losses [rounds, n] each, params each, accuracies each)."""
    path = tmp_path / "scenario.json"
    jcfg.save(path)
    js = JaxScenario(jcfg)
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    tcfg = ScenarioConfig.load(path)
    ts = Scenario(tcfg, device="cpu")
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    jres, tres = js.run(), ts.run()
    jl = _jax_losses(jres.history)
    tl = np.array([h["train_loss"] for h in tres.history])
    assert tl.shape == jl.shape == (jcfg.training.rounds, N)
    jp = {tuple(k.key for k in path): np.asarray(leaf, np.float32)
          for path, leaf in jax.tree_util.tree_flatten_with_path(
              js.fed.states.params)[0]}
    tp = params_to_numpy(ts.fed.states.params)
    rel = {}
    for keys, j in jp.items():
        t = tp
        for k in keys:
            t = t[k]
        rel[keys] = float(np.linalg.norm(t - j) / np.linalg.norm(j))
    return (tl, jl, rel,
            np.array(tres.per_node_accuracy), np.array(jres.per_node_accuracy))


@pytest.mark.parametrize("federation,topology", [("DFL", "ring"),
                                                 ("CFL", "star")])
def test_scenario_matches_jax(tmp_path, federation, topology):
    """The main path's arithmetic (bf16 compute, bf16 wire)."""
    tl, jl, rel, tacc, jacc = _run_both(
        tmp_path, _jax_config(federation, topology))
    np.testing.assert_allclose(tl[0], jl[0], rtol=BF16_LOSS_RTOL[0])
    np.testing.assert_allclose(tl[1], jl[1], rtol=BF16_LOSS_RTOL[1])
    for keys, r in rel.items():
        assert r < BF16_PARAM_REL_L2[keys[-1]], (keys, r)
    np.testing.assert_allclose(tacc, jacc, atol=BF16_ACC_ATOL)


def test_scenario_matches_jax_in_f32(tmp_path):
    """The same DFL scenario with f32 compute and f32 wire on both
    sides: no bf16 rounding to amplify, so the round logic (gate, SGD,
    mix, evaluation) must agree to f32 summation-order noise."""
    jcfg = _jax_config("DFL", "ring")
    jcfg.model.compute_dtype = "float32"
    jcfg.wire_dtype = "f32"
    tl, jl, rel, tacc, jacc = _run_both(tmp_path, jcfg)
    np.testing.assert_allclose(tl, jl, rtol=F32_RTOL)
    assert max(rel.values()) < F32_RTOL, rel
    np.testing.assert_array_equal(tacc, jacc)


def test_port_trains_with_its_own_generator(tmp_path):
    """Batch 6 of an 18-row shard (3 steps an epoch),
    the port's own init and shuffle: the mean train loss falls."""
    jcfg = _jax_config("DFL", "ring", batch=6, rounds=3)
    path = tmp_path / "scenario.json"
    jcfg.save(path)
    ts = Scenario(ScenarioConfig.load(path), device="cpu")
    res = ts.run()
    losses = [np.mean(h["train_loss"]) for h in res.history]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert int(ts.fed.states.step[0]) == 3 * 3 * 3  # rounds x epochs x steps


def test_unported_sections_are_rejected_with_their_roadmap_item(tmp_path):
    cases = [
        ({"privacy": {"secagg": True}}, "A22"),
        ({"transport": "sparse"}, "A12"),
    ]
    for override, item in cases:
        raw = dataclasses.asdict(jschema.ScenarioConfig(n_nodes=2))
        raw.update(override)
        with pytest.raises(NotImplementedError, match=item):
            ScenarioConfig.from_dict(raw)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scenario(ScenarioConfig(n_nodes=2))


@pytest.mark.parametrize("federation", ["DFL", "CFL"])
def test_round_fn_with_a_dead_node_and_a_proxy_matches_jax(federation):
    """One round of ``build_round_fn`` on a 4-node ring, node 3 dead and
    node 2 a proxy (no training, no contribution), unequal sample
    counts, f32 MLP: the selection, weighting and keep logic the
    scenarios above never reach. f32 throughout, so rtol 1e-5; the dead
    node's parameters exactly unchanged on both sides."""
    import jax.numpy as jnp

    from p2pfl_tpu.learning.learner import make_step_fns as jfns
    from p2pfl_tpu.models.base import get_model as jmodel
    from p2pfl_tpu.parallel import federated as jfed
    from p2pfl_tpu.topology.topology import ring as jring
    from p2pfl_tpu_torch.learning.learner import make_step_fns
    from p2pfl_tpu_torch.models.base import get_model
    from p2pfl_tpu_torch.parallel import federated as tfed
    from p2pfl_tpu_torch.topology.topology import ring as tring

    rng = np.random.default_rng(5)
    s = 12
    x = rng.standard_normal((N, s, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(N, s)).astype(np.int32)
    mask = np.ones((N, s), bool)
    nsamp = np.array([10, 20, 30, 40], np.int32)
    alive = np.array([True, True, True, False])
    roles = ["aggregator", "trainer", "proxy", "trainer"]
    plan = jfed.make_round_plan(jring(N), roles, federation, leader=0)
    ident = federation == "DFL"

    jf = jfns(jmodel("mnist-mlp", dtype=jnp.float32), batch_size=s,
              learning_rate=0.05)
    jstate = jfed.init_federation(jf, jnp.asarray(x[0, :1]), N)
    jstate = jstate.replace(alive=jnp.asarray(alive))
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], jstate.states.params)
    jround = jax.jit(jfed.build_round_fn(jf, epochs=2, identity_adopt=ident))
    jout, _ = jround(jstate, *(jnp.asarray(a) for a in (x, y, mask, nsamp)),
                     jnp.asarray(plan.mix), jnp.asarray(plan.adopt),
                     jnp.asarray(plan.trains))

    tf = make_step_fns(get_model("mnist-mlp", dtype=torch.float32),
                       batch_size=s, learning_rate=0.05)
    tstate = tfed.init_federation(tf, torch.from_numpy(x[0, :1]), N)
    tstate = tfed.reseed_params(tstate, tf, params_from_jax(p0))
    tstate.alive = torch.from_numpy(alive)
    tplan = tfed.make_round_plan(tring(N), roles, federation, leader=0)
    np.testing.assert_array_equal(tplan.mix, plan.mix)
    tround = tfed.build_round_fn(tf, epochs=2, identity_adopt=ident)
    tout, _ = tround(tstate,
                     *(torch.from_numpy(a) for a in (x, y, mask, nsamp)),
                     torch.from_numpy(tplan.mix),
                     torch.from_numpy(tplan.adopt).long(),
                     torch.from_numpy(tplan.trains))

    tp = params_to_numpy(tout.states.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jout.states.params)[0]:
        t = tp
        for k in path:
            t = t[k.key]
        j = np.asarray(leaf)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
        start = p0
        for k in path:
            start = start[k.key]
        assert np.array_equal(t[3], start) and np.array_equal(j[3], start)


@pytest.mark.parametrize("mask", [[True, True, False, True],
                                  [False, False, False, False]])
def test_fedavg_aggregate_matches_jax(mask):
    """Sample-weighted mean over the kept rows, f32 accumulation; an
    all-masked call falls back to the uniform mean, as in JAX."""
    import jax.numpy as jnp

    from p2pfl_tpu.core.aggregators import FedAvg as JaxFedAvg
    from p2pfl_tpu_torch.core.aggregators import FedAvg

    rng = np.random.default_rng(6)
    tree = {"a": {"kernel": rng.standard_normal((N, 5, 3)).astype(np.float32),
                  "bias": rng.standard_normal((N, 3)).astype(np.float32)}}
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    m = np.array(mask)
    want = JaxFedAvg().aggregate(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(w), jnp.asarray(m))
    got = FedAvg().aggregate(params_from_jax(tree), torch.from_numpy(w),
                             torch.from_numpy(m))
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(got["a"][k].numpy(),
                                   np.asarray(want["a"][k]), rtol=1e-6)
