"""The staged exchange (``exchange_overlap="staged"``), on the CPU.

The off-diagonal mix terms read the previous round's post-fit params at
their then weights, the diagonal this round's fit (one-round-stale
gossip, ``parallel/federated.py``). Held here:

- the JAX ``Scenario`` and the port's, staged, on one scenario JSON in
  the f32 tier of ``test_torch_federation.py`` (FEMNIST-CNN at hidden
  64, 4 nodes on a ring, f32 compute and wire, one batch an epoch, the
  port from the JAX initial weights), 3 rounds: losses and params within
  rtol 1e-5 every round, accuracies equal, the buffers' weights equal;
- round 0 is pure local training: the port's staged round gives the
  bits of the fit alone, rounded through the exchange dtype (f32 and
  bf16 wire), and the buffer holds the post-DP fit;
- from round 1 on the staged rounds differ from the eager ones, and the
  buffer carries weight;
- the refusals are the JAX package's: a robust aggregator ("FedAvg"),
  attack injection, trust scoring, an unknown mode, and a cross-device
  config.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu.adversary import AttackSpec as JaxAttackSpec
from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.core.aggregators import Krum as JaxKrum
from p2pfl_tpu.federation.scenario import Scenario as JaxScenario
from p2pfl_tpu.learning.learner import make_step_fns as jax_step_fns
from p2pfl_tpu.models import get_model as jax_get_model
from p2pfl_tpu.parallel.federated import build_round_fn as jax_round_fn
from p2pfl_tpu_torch.adversary import AttackSpec
from p2pfl_tpu_torch.config.schema import (
    DataConfig,
    ModelConfig,
    PrivacyConfig,
    ScenarioConfig,
    TrainingConfig,
)
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.core.aggregators import Krum
from p2pfl_tpu_torch.core.pytree import tree_leaves
from p2pfl_tpu_torch.federation.scenario import Scenario
from p2pfl_tpu_torch.learning.learner import make_step_fns
from p2pfl_tpu_torch.models.base import get_model
from p2pfl_tpu_torch.parallel.federated import (
    _clone_generator,
    _train_and_select,
    build_round_fn,
    reseed_params,
    with_staged_buffer,
)
from p2pfl_tpu_torch.privacy.dp import privatize_stacked

F32_RTOL = 1e-5
SHARD = 18  # 20 samples a node less the 10% validation split
N = 4


def _config(overlap: str = "staged") -> jschema.ScenarioConfig:
    return jschema.ScenarioConfig(
        name="staged", federation="DFL", topology="ring", n_nodes=N,
        data=jschema.DataConfig(dataset="femnist", samples_per_node=20,
                                batch_size=SHARD, synthetic_train=2000,
                                synthetic_test=128),
        model=jschema.ModelConfig(model="femnist-cnn", kwargs={"hidden": 64},
                                  compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=3, epochs_per_round=2,
                                        learning_rate=0.05),
        transport="dense", wire_dtype="f32", exchange_overlap=overlap)


def _by_path(tree) -> dict:
    return {tuple(k.key for k in p): np.asarray(leaf, np.float32)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_staged_scenario_matches_jax(tmp_path):
    jcfg = _config()
    jcfg.save(tmp_path / "s.json")
    js = JaxScenario(jcfg)
    ts = Scenario(ScenarioConfig.load(tmp_path / "s.json"), device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = with_staged_buffer(
        reseed_params(ts.fed, ts.fns, params_from_jax(p0)))
    for r in range(3):
        jres, tres = js.run(rounds=1), ts.run(rounds=1)
        jl = [x["Train/loss"] for x in jres.history
              if "Train/loss" in x and x["round"] == r]
        np.testing.assert_allclose(tres.history[0]["train_loss"], jl,
                                   rtol=F32_RTOL)
        jp = _by_path(js.fed.states.params)
        tp = params_to_numpy(ts.fed.states.params)
        for keys, j in jp.items():
            t = tp
            for k in keys:
                t = t[k]
            rel = np.linalg.norm(t - j) / np.linalg.norm(j)
            assert rel < F32_RTOL, (r, keys, rel)
        np.testing.assert_array_equal(ts.fed.stale[1].numpy(),
                                      np.asarray(js.fed.stale[1]))
        np.testing.assert_array_equal(tres.per_node_accuracy,
                                      jres.per_node_accuracy)


def _setup(wire=None, dp=None, seed=0):
    """A 4-node mnist-mlp ring (several steps an epoch), its data, and a
    staged round function."""
    from p2pfl_tpu_torch.datasets.data import FederatedDataset
    from p2pfl_tpu_torch.parallel.federated import (
        init_federation,
        make_round_plan,
    )
    from p2pfl_tpu_torch.topology.topology import generate_topology

    ds = FederatedDataset.make(DataConfig(dataset="mnist",
                                          samples_per_node=60, seed=seed), N)
    data = tuple(torch.from_numpy(a) for a in ds.stacked())
    fns = make_step_fns(get_model("mnist-mlp"), learning_rate=0.05,
                        batch_size=16)
    plan = make_round_plan(generate_topology("ring", N), ["aggregator"] * N,
                           "DFL")
    plan_args = (torch.from_numpy(plan.mix), torch.from_numpy(plan.adopt).long(),
                 torch.from_numpy(plan.trains))
    fed = init_federation(fns, data[0][0, :1], N, seed=seed)
    mask = np.ones(N, bool)
    kw = dict(epochs=1, exchange_dtype=wire, identity_adopt=True,
              dp=dp, dp_mask=mask if dp is not None else None)
    staged = build_round_fn(fns, exchange_overlap="staged", **kw)
    eager = build_round_fn(fns, **kw)
    return fns, fed, data, plan_args, staged, eager


@pytest.mark.parametrize("wire", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_staged_round_zero_is_the_fit_alone(wire):
    fns, fed, data, plan_args, staged, _ = _setup(wire)
    st = dataclasses.replace(fed.states,
                             rng=_clone_generator(fed.states.rng))
    every = torch.ones(N, dtype=torch.bool)
    fit, _ = _train_and_select(fns, st, every, every, *data[:3], 1)
    out, _ = staged(with_staged_buffer(fed), *data, *plan_args)
    for a, b in zip(tree_leaves(out.states.params),
                    tree_leaves(fit.params), strict=True):
        want = b if wire is None else b.to(wire).float()
        assert torch.equal(a, want)
    # the buffer now holds this round's fit at its sample weights
    for a, b in zip(tree_leaves(out.stale[0]), tree_leaves(fit.params)):
        assert torch.equal(a, b)
    assert torch.equal(out.stale[1], data[3].float())


def test_staged_buffer_holds_the_privatized_fit():
    from p2pfl_tpu_torch.privacy.dp import DPSpec

    dp = DPSpec(clip_norm=0.5, noise_multiplier=0.3, seed=1)
    fns, fed, data, plan_args, staged, _ = _setup(dp=dp)
    st = dataclasses.replace(fed.states,
                             rng=_clone_generator(fed.states.rng))
    every = torch.ones(N, dtype=torch.bool)
    fit, _ = _train_and_select(fns, st, every, every, *data[:3], 1)
    want = privatize_stacked(fit.params, fed.states.params,
                             np.ones(N, bool), fed.round, dp)
    out, _ = staged(with_staged_buffer(fed), *data, *plan_args)
    for a, b in zip(tree_leaves(out.stale[0]), tree_leaves(want)):
        assert torch.equal(a, b)


def test_staged_differs_from_eager_after_round_zero():
    fns, fed, data, plan_args, staged, eager = _setup()
    a, b = with_staged_buffer(fed), fed
    for _ in range(2):
        a, _ = staged(a, *data, *plan_args)
        b, _ = eager(b, *data, *plan_args)
    delta = max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(a.states.params), tree_leaves(b.states.params)))
    assert delta > 1e-4
    assert bool((a.stale[1] > 0).all()) and b.stale is None
    # with_staged_buffer copies: the buffer is not the live params
    c = with_staged_buffer(fed)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(
        tree_leaves(c.stale[0]), tree_leaves(fed.states.params)))
    assert torch.equal(c.stale[1], torch.zeros(N))


def _refusal_cases():
    mal = np.zeros(N, bool)
    mal[1] = True
    return {
        "robust": (dict(aggregator=Krum(f=1, m=2)),
                   dict(aggregator=JaxKrum(f=1, m=2)), "FedAvg"),
        "trust": (dict(update_stats=True), dict(update_stats=True),
                  "trust scoring"),
        "attack": (dict(attack=AttackSpec(kind="signflip", scale=10.0),
                        malicious=mal),
                   dict(attack=JaxAttackSpec(kind="signflip", scale=10.0),
                        malicious=mal), "attack"),
        "unknown": (dict(exchange_overlap="eager"),
                    dict(exchange_overlap="eager"), "exchange_overlap"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_staged_refusals_match_jax(case):
    port_kw, jax_kw, match = _refusal_cases()[case]
    port_kw = {"exchange_overlap": "staged", **port_kw}
    jax_kw = {"exchange_overlap": "staged", **jax_kw}
    fns = make_step_fns(get_model("mnist-mlp"))
    jfns = jax_step_fns(jax_get_model("mnist-mlp"))
    with pytest.raises(ValueError, match=match) as port:
        build_round_fn(fns, **port_kw)
    with pytest.raises(ValueError, match=match) as ref:
        jax_round_fn(jfns, **jax_kw)
    assert str(port.value) == str(ref.value)


def test_config_accepts_staged_and_refuses_it_with_cross_device():
    cfg = ScenarioConfig(n_nodes=4, exchange_overlap="staged")
    assert cfg.exchange_overlap == "staged"
    with pytest.raises(ValueError, match="exchange_overlap"):
        ScenarioConfig(n_nodes=4, exchange_overlap="eager")
    with pytest.raises(ValueError, match="exchange_overlap='off'"):
        ScenarioConfig.from_dict({
            "n_nodes": 4, "exchange_overlap": "staged",
            "cross_device": {"n_clients": 100, "clients_per_round": 16,
                             "cohort_size": 4}})
    # DP composes (the buffer holds the privatized fit)
    sc = Scenario(ScenarioConfig(
        n_nodes=4, exchange_overlap="staged",
        data=DataConfig(dataset="mnist", samples_per_node=40),
        model=ModelConfig(model="mnist-mlp"),
        training=TrainingConfig(rounds=2, epochs_per_round=1),
        privacy=PrivacyConfig(dp=True, clip_norm=1.0,
                              noise_multiplier=0.5)), device="cpu")
    sc.run()
    assert bool((sc.fed.stale[1] > 0).all())
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(sc.fed.states.params))
