"""The autoencoder and one-class-SVM objectives (the port's
``learning/objectives.py`` and the learner's use of them) against the
JAX package, on the CPU.

Inputs are numpy draws from a seed handed to both packages; the JAX
side vmaps its per-node functions over the node axis. Tolerances:

- ``mse_loss``, ``ocsvm_loss`` and ``ocsvm_penalty``: f32 sums in
  different orders, rtol 1e-6, atol 1e-7;
- the learner's per-node training loss and ``evaluate`` on the
  autoencoder and the one-class SVM (computed in f32) at the same
  params: rtol 1e-5; accuracy exactly 0.0 on both sides, as neither
  objective's output is a class logit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.learning import learner as jlearner
from p2pfl_tpu.learning import objectives as jobj
from p2pfl_tpu.models.base import get_model as jget_model
from p2pfl_tpu_torch.convert import params_from_jax
from p2pfl_tpu_torch.learning import learner as tlearner
from p2pfl_tpu_torch.learning import objectives as tobj
from p2pfl_tpu_torch.learning.learner import TrainState
from p2pfl_tpu_torch.models.base import get_model as tget_model

N, B, D = 3, 10, 17
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
LEARNER_TOL = dict(rtol=1e-5, atol=1e-7)


def _draws(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((N, B)) < 0.8
    mask[:, 0] = True
    return rng, mask


def test_objective_lists_match():
    assert tobj.NO_ACCURACY_OBJECTIVES == jobj.NO_ACCURACY_OBJECTIVES
    for name in ("classification", "autoencoder", "ocsvm"):
        tobj.get_objective(name)
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get_objective("regression")


@pytest.mark.parametrize("shape", [(D,), (4, 5), (2, 3, 2)])
def test_mse_loss_matches_jax(shape):
    rng, mask = _draws(1)
    pred = rng.standard_normal((N, B) + shape).astype(np.float32)
    x = rng.standard_normal((N, B) + shape).astype(np.float32)
    got = tobj.mse_loss(torch.from_numpy(pred), torch.from_numpy(x),
                        torch.from_numpy(mask))
    want = jax.vmap(jobj.mse_loss)(pred, x, mask)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_ocsvm_loss_and_penalty_match_jax():
    rng, mask = _draws(2)
    scores = rng.standard_normal((N, B)).astype(np.float32)
    y = np.zeros((N, B), np.int32)
    got = tobj.ocsvm_loss(torch.from_numpy(scores), torch.from_numpy(y),
                          torch.from_numpy(mask))
    want = jax.vmap(jobj.ocsvm_loss)(scores, y, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
    params = {"params": {"w": rng.standard_normal((N, D)).astype(np.float32),
                         "rho": rng.standard_normal(N).astype(np.float32)}}
    got = tobj.ocsvm_penalty(params_from_jax(params))
    want = jax.vmap(jobj.ocsvm_penalty)(params)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_ocsvm_hinge_gradient_at_a_tie_matches_jax():
    """The SVM starts at w = 0, rho = 0: every score is exactly 0, where
    ``jnp.maximum`` splits the gradient between its arguments."""
    rng, mask = _draws(5)
    scores = rng.standard_normal((N, B)).astype(np.float32)
    scores[:, ::2] = 0.0
    y = np.zeros((N, B), np.int32)
    want = jax.grad(lambda s: jax.vmap(jobj.ocsvm_loss)(s, y, mask).sum())(
        scores)
    st = torch.from_numpy(scores).requires_grad_(True)
    tobj.ocsvm_loss(st, torch.from_numpy(y), torch.from_numpy(mask)).sum(
    ).backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want), **LOSS_TOL)


def _models(name):
    kw = {"dtype": jnp.float32} if name == "syscall-autoencoder" else {}
    tkw = {"dtype": torch.float32} if name == "syscall-autoencoder" else {}
    return jget_model(name, **kw), tget_model(name, **tkw)


def _stacked_params(jmodel, x, seed):
    """N different nodes' params, as the JAX federation stacks them;
    the SVM's zero init is perturbed so its scores and penalty move."""
    trees = [jmodel.init(jax.random.PRNGKey(seed + i), jnp.asarray(x[0]))
             for i in range(N)]
    rng = np.random.default_rng(seed)
    stacked = jax.tree.map(
        lambda *a: np.stack([np.asarray(v) for v in a]), *trees)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        stacked)


@pytest.mark.parametrize("name,objective", [
    ("syscall-autoencoder", "autoencoder"), ("syscall-svm", "ocsvm")])
def test_learner_loss_and_evaluate_match_jax(name, objective):
    rng, mask = _draws(3)
    x = rng.standard_normal((N, B, D)).astype(np.float32)
    y = rng.integers(0, 9, (N, B)).astype(np.int32)
    jmodel, tmodel = _models(name)
    jparams = _stacked_params(jmodel, x, seed=4)
    kw = dict(objective=objective, optimizer="sgd", learning_rate=0.05,
              batch_size=B, eval_batch_size=4)
    jfns = jlearner.make_step_fns(jmodel, **kw)
    tfns = tlearner.make_step_fns(tmodel, **kw)
    tparams = params_from_jax(jparams)

    # the training loss of one batch (the objective the step descends)
    jloss, _ = jax.vmap(jfns.forward)(jparams, x, y, mask)
    state = TrainState(params=tparams, opt_state=tfns.init_opt_state(tparams),
                       rng=torch.Generator(),
                       step=torch.zeros(N, dtype=torch.int64))
    _, tloss = tfns.train_step(state, torch.from_numpy(x),
                               torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                               **LEARNER_TOL)

    # evaluate on one shared set, batches of 4 (a ragged last one)
    xs, ys = x[0], y[0]
    ms = np.ones(B, bool)
    jev = jax.vmap(jfns.evaluate, in_axes=(0, None, None, None))(
        jparams, xs, ys, ms)
    tev = tfns.evaluate(tparams, torch.from_numpy(xs), torch.from_numpy(ys),
                        torch.from_numpy(ms))
    np.testing.assert_allclose(tev["loss"].numpy(), np.asarray(jev["loss"]),
                               **LEARNER_TOL)
    assert np.all(np.asarray(jev["accuracy"]) == 0.0)
    assert torch.equal(tev["accuracy"], torch.zeros(N))
