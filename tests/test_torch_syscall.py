"""The tabular models (``syscall-mlp``, ``wadi-mlp``,
``syscall-autoencoder``, ``syscall-svm``) against the JAX package's
flax modules, and one federated round of each against the JAX
Scenario, on the CPU.

Parameters come from the flax modules' init, carried across by
``convert.params_from_jax`` (the SVM's top-level ``w`` and ``rho``
included). Tolerances:

- forward passes in f32 compute: rtol 1e-5, atol 1e-6 (f32 sums in
  other orders); in the models' default bf16 compute (the MLPs and the
  autoencoder): ``test_torch_model.py``'s bf16 logit tolerance, rtol
  and atol 2e-2 (each side rounds to bf16 at its own points);
- one round (4 nodes, ring DFL, FedAvg, SGD, the whole shard a batch so
  the JAX shuffle only reorders one batch) in f32 compute and f32 wire:
  train losses rtol 1e-5, parameters within relative L2 1e-5 a leaf
  (``test_torch_federation.py``'s f32 tier), test accuracy equal (0.0
  on both sides for the autoencoder and the SVM).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation.scenario import Scenario as JaxScenario
from p2pfl_tpu.models.base import get_model as jget_model
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.federation.scenario import Scenario
from p2pfl_tpu_torch.models.base import get_model as tget_model
from p2pfl_tpu_torch.parallel.federated import reseed_params

N, B = 3, 6
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_RTOL = 1e-5

# (model, dataset, objective, input width)
MODELS = [("syscall-mlp", "syscall", "classification", 17),
          ("wadi-mlp", "wadi", "classification", 123),
          ("syscall-autoencoder", "syscall", "autoencoder", 17),
          ("syscall-svm", "syscall", "ocsvm", 17)]


def _stacked_init(jmodel, x):
    trees = [jmodel.init(jax.random.PRNGKey(i), jnp.asarray(x[0]))
             for i in range(N)]
    stacked = jax.tree.map(
        lambda *a: np.stack([np.asarray(v) for v in a]), *trees)
    if "w" in stacked["params"]:
        # the SVM initializes to zero: move it so the scores are not
        rng = np.random.default_rng(0)
        stacked = jax.tree.map(
            lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
                a.dtype), stacked)
    return stacked


@pytest.mark.parametrize("compute", ["f32", "default"])
@pytest.mark.parametrize("name,dataset,objective,d", MODELS)
def test_forward_matches_flax(name, dataset, objective, d, compute):
    jkw = {"dtype": jnp.float32} if compute == "f32" else {}
    tkw = {"dtype": torch.float32} if compute == "f32" else {}
    jmodel, tmodel = jget_model(name, **jkw), tget_model(name, **tkw)
    x = np.random.default_rng(1).standard_normal((N, B, d)).astype(
        np.float32)
    jparams = _stacked_init(jmodel, x)
    tparams = params_from_jax(jparams)
    if name == "syscall-svm":
        assert set(tparams["params"]) == {"w", "rho"}
        assert tparams["params"]["rho"].shape == (N,)
    want = jax.vmap(jmodel.apply)(jparams, jnp.asarray(x))
    got = tmodel(tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = BF16_TOL if (compute == "default" and name != "syscall-svm") \
        else F32_TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_init_trees_match_flax():
    for name, _, _, d in MODELS:
        x = np.zeros((1, 2, d), np.float32)
        jtree = jget_model(name).init(jax.random.PRNGKey(0),
                                      jnp.asarray(x[0]))
        ttree = tget_model(name).init(torch.Generator().manual_seed(0),
                                      torch.from_numpy(x[0]))
        jshapes = jax.tree.map(lambda a: tuple(a.shape), jtree)
        tshapes = {k: ({n: tuple(t.shape) for n, t in v.items()}
                       if isinstance(v, dict) else tuple(v.shape))
                   for k, v in ttree["params"].items()}
        assert {"params": tshapes} == jshapes, name


def _jax_config(model, dataset, objective) -> jschema.ScenarioConfig:
    return jschema.ScenarioConfig(
        name=f"tabular-{model}", n_nodes=4, topology="ring",
        data=jschema.DataConfig(dataset=dataset, samples_per_node=20,
                                batch_size=18, synthetic_train=1000,
                                synthetic_test=64),
        model=jschema.ModelConfig(model=model, objective=objective,
                                  compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=1, epochs_per_round=2,
                                        learning_rate=0.05),
        transport="dense", wire_dtype="f32")


@pytest.mark.parametrize("name,dataset,objective,d", MODELS)
def test_one_round_matches_jax(tmp_path, name, dataset, objective, d):
    jcfg = _jax_config(name, dataset, objective)
    path = tmp_path / "scenario.json"
    jcfg.save(path)
    js = JaxScenario(jcfg)
    ts = Scenario(ScenarioConfig.load(path), device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    jres, tres = js.run(), ts.run()
    jl = np.array([[r["Train/loss"] for r in jres.history
                    if "Train/loss" in r and r["node"] == i]
                   for i in range(4)]).T
    tl = np.array([h["train_loss"] for h in tres.history])
    np.testing.assert_allclose(tl, jl, rtol=F32_RTOL)
    tp = params_to_numpy(ts.fed.states.params)
    for path_, leaf in jax.tree_util.tree_flatten_with_path(
            js.fed.states.params)[0]:
        t = tp
        for k in path_:
            t = t[k.key]
        j = np.asarray(leaf, np.float32)
        rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
        assert rel < F32_RTOL, (path_, rel)
    np.testing.assert_array_equal(np.array(tres.per_node_accuracy),
                                  np.array(jres.per_node_accuracy))
    if objective != "classification":
        assert tres.per_node_accuracy == [0.0] * 4
