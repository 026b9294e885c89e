"""The Byzantine-robust round and scenario against the JAX package's.

- ``build_round_fn`` with each aggregator (FedAvg, FedMedian,
  TrimmedMean, Krum), per row on a ring and shared on a fully connected
  plan (DFL) or at the leader (CFL, FedAvg and TrimmedMean), with a
  sign-flip attack on two of six nodes and ``update_stats``: one round
  from the same initial params (carried over with ``convert.py``),
  mnist-mlp in f32, image-like inputs in [0, 1). Params, momentum and
  the trust observations within rtol 1e-5, atol 1e-6: both sides
  compute in f32 and sum in other orders.
- ``Scenario`` with a 25% sign-flip (or label-flip), reputation and
  Krum(f=2, m=6), 8 fully connected DFL nodes, mnist-mlp in f32, the
  whole shard one batch (so JAX's shuffle only reorders rows inside
  it), 2 rounds. ``m`` is the honest count: the honest rows start each
  round from one aggregate, so their Krum scores differ by less than
  the f32 cancellation in ``sq_i + sq_j - 2 Gram``, which the two
  frameworks sum in other orders; with ``m = 6`` the selection is the
  six honest rows on both sides (``m = 2`` picks another honest pair
  in round 2 and the params part). Checked:
  the malicious mask and the flipped labels exactly equal, the trust
  vectors within atol 1e-5 and the params within relative L2 1e-5 per
  leaf after each round.
"""

from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.adversary import AttackSpec as JAttack
from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.core import aggregators as jagg
from p2pfl_tpu.federation.scenario import Scenario as JaxScenario
from p2pfl_tpu.learning.learner import make_step_fns as jfns
from p2pfl_tpu.models.base import get_model as jmodel
from p2pfl_tpu.parallel import federated as jfed
from p2pfl_tpu.topology.topology import generate_topology as jtopo
from p2pfl_tpu_torch.adversary import AttackSpec as TAttack
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.core import aggregators as tagg
from p2pfl_tpu_torch.federation.scenario import Scenario
from p2pfl_tpu_torch.learning.learner import make_step_fns
from p2pfl_tpu_torch.models.base import get_model
from p2pfl_tpu_torch.parallel import federated as tfed
from p2pfl_tpu_torch.topology.topology import generate_topology as ttopo

ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
TRUST_ATOL = 1e-5
SCENARIO_REL_L2 = 1e-5

AGGREGATORS = {
    "fedavg": {},
    "fedmedian": {},
    "trimmedmean": {"beta": 1},
    "krum": {"f": 1, "m": 2},
}


def _leaves(tree):
    """{path: numpy leaf} of a JAX or port tree (the same paths)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(k.key for k in path)] = np.asarray(leaf)
    return out


def _close(tp, jp, **tol):
    tl, jl = _leaves(params_to_numpy(tp)), _leaves(jp)
    assert tl.keys() == jl.keys()
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], err_msg=str(k), **tol)


@pytest.mark.parametrize("agg,shared,federation", [
    *((a, False, "DFL") for a in AGGREGATORS),  # per row, ring
    *((a, True, "DFL") for a in AGGREGATORS if a != "fedavg"),  # fully
    ("fedavg", True, "CFL"),  # the leader's row (FedAvg has no shared form)
    ("trimmedmean", True, "CFL"),  # shared at the leader, adopt gathered
])
def test_round_fn_matches_jax(agg, shared, federation):
    n, s = 6, 12
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (n, s, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, s)).astype(np.int32)
    mask = np.ones((n, s), bool)
    nsamp = np.array([10, 20, 30, 40, 50, 60], np.int32)
    malicious = np.array([False, True, False, False, True, False])
    topology = "fully" if shared else "ring"
    roles = (["server"] + ["trainer"] * (n - 1) if federation == "CFL"
             else ["aggregator"] * n)
    ident = federation == "DFL"
    jplan = jfed.make_round_plan(jtopo(topology, n), roles, federation, 0)
    tplan = tfed.make_round_plan(ttopo(topology, n), roles, federation, 0)
    np.testing.assert_array_equal(tplan.mix, jplan.mix)

    jf = jfns(jmodel("mnist-mlp", dtype=jnp.float32), batch_size=s,
              learning_rate=0.05)
    jstate = jfed.init_federation(jf, jnp.asarray(x[0, :1]), n)
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], jstate.states.params)
    jround = jfed.build_round_fn(
        jf, aggregator=jagg.get_aggregator(agg, **AGGREGATORS[agg]),
        shared_aggregate=shared, identity_adopt=ident,
        attack=JAttack(kind="signflip", scale=10.0), malicious=malicious,
        update_stats=True)
    jout, jm = jax.jit(jround)(
        jstate, *(jnp.asarray(a) for a in (x, y, mask, nsamp)),
        jnp.asarray(jplan.mix), jnp.asarray(jplan.adopt),
        jnp.asarray(jplan.trains))

    tf = make_step_fns(get_model("mnist-mlp", dtype=torch.float32),
                       batch_size=s, learning_rate=0.05)
    tstate = tfed.init_federation(tf, torch.from_numpy(x[0, :1]), n)
    tstate = tfed.reseed_params(tstate, tf, params_from_jax(p0))
    tround = tfed.build_round_fn(
        tf, aggregator=tagg.get_aggregator(agg, **AGGREGATORS[agg]),
        shared_aggregate=shared, identity_adopt=ident,
        attack=TAttack(kind="signflip", scale=10.0), malicious=malicious,
        update_stats=True)
    with warnings.catch_warnings():
        # per-row Krum on a ring sees 3 rows (< f + 3): the port warns
        # where JAX, under vmap, cannot
        warnings.simplefilter("ignore", RuntimeWarning)
        tout, tm = tround(
            tstate, *(torch.from_numpy(a) for a in (x, y, mask, nsamp)),
            torch.from_numpy(tplan.mix),
            torch.from_numpy(tplan.adopt).long(),
            torch.from_numpy(tplan.trains))
    _close(tout.states.params, jout.states.params, **ROUND_TOL)
    _close(tout.states.opt_state, jout.states.opt_state[0].trace,
           **ROUND_TOL)
    np.testing.assert_allclose(tm["trust_obs"].numpy(),
                               np.asarray(jm["trust_obs"]), **ROUND_TOL)
    np.testing.assert_allclose(tm["train_loss"].numpy(),
                               np.asarray(jm["train_loss"]), **ROUND_TOL)
    assert tout.round == 1


def test_fedavg_fast_path_is_unchanged_without_an_attack():
    """No attack, no stats: the FedAvg round gives the same bits with and
    without the robust machinery's arguments at their defaults."""
    n, s = 4, 8
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (n, s, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (n, s)).astype(np.int32))
    mask = torch.ones((n, s), dtype=torch.bool)
    nsamp = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    tf = make_step_fns(get_model("mnist-mlp", dtype=torch.float32),
                       batch_size=s, learning_rate=0.05)
    plan = tfed.make_round_plan(ttopo("ring", n), ["aggregator"] * n)
    args = (x, y, mask, nsamp, torch.from_numpy(plan.mix),
            torch.from_numpy(plan.adopt).long(),
            torch.from_numpy(plan.trains))
    outs = []
    for kw in ({}, {"aggregator": tagg.FedAvg(), "attack": None,
                    "malicious": np.zeros(n, bool)}):
        st = tfed.init_federation(tf, x[0, :1], n, seed=2)
        out, _ = tfed.build_round_fn(tf, identity_adopt=True, **kw)(st, *args)
        outs.append(params_to_numpy(out.states.params))
    a, b = _leaves(outs[0]), _leaves(outs[1])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _raw(kind: str) -> dict:
    cfg = jschema.ScenarioConfig(
        name="robust-parity", federation="DFL", topology="fully", n_nodes=8,
        data=jschema.DataConfig(dataset="mnist", samples_per_node=20,
                                batch_size=18, synthetic_train=2000,
                                synthetic_test=96),
        model=jschema.ModelConfig(model="mnist-mlp"),
        training=jschema.TrainingConfig(rounds=2, epochs_per_round=2,
                                        learning_rate=0.05),
        aggregator="krum", aggregator_kwargs={"f": 2, "m": 6},
        adversary=jschema.AdversaryConfig(fraction=0.25, kind=kind,
                                          scale=10.0, reputation=True),
        transport="dense",
    )
    raw = json.loads(json.dumps(dataclasses.asdict(cfg)))
    raw["model"]["compute_dtype"] = "float32"
    return raw


@pytest.mark.parametrize("kind", ["signflip", "labelflip"])
def test_scenario_matches_jax(kind):
    raw = _raw(kind)
    js = JaxScenario(jschema.ScenarioConfig.from_dict(raw))
    ts = Scenario(ScenarioConfig.from_dict(raw), device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = tfed.reseed_params(ts.fed, ts.fns, params_from_jax(p0))

    assert np.array_equal(ts.malicious, js.malicious)
    assert ts.malicious.sum() == 2
    assert np.array_equal(ts._data_args[1].numpy(),
                          np.asarray(js._data_args[1]))
    for _ in range(2):
        js.run(rounds=1)
        tres = ts.run(rounds=1)
        np.testing.assert_allclose(ts.reputation.trust, js.reputation.trust,
                                   rtol=0, atol=TRUST_ATOL)
        np.testing.assert_allclose(tres.history[0]["trust"],
                                   js.reputation.trust, rtol=0,
                                   atol=TRUST_ATOL)
        tl = _leaves(params_to_numpy(ts.fed.states.params))
        jl = _leaves(js.fed.states.params)
        for k in jl:
            rel = np.linalg.norm(tl[k] - jl[k]) / np.linalg.norm(jl[k])
            assert rel < SCENARIO_REL_L2, (k, rel)
    if kind == "signflip":
        # the attackers' trust is cut off after the first round
        assert set(ts.reputation.suspects()) == set(
            np.flatnonzero(ts.malicious).tolist())
