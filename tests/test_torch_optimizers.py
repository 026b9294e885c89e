"""adam and adamw (the port's ``learning/learner.py``) against the JAX
package's ``make_optimizer`` and ``make_step_fns``, on the CPU.

Inputs are numpy draws from a seed handed to both packages; the JAX
side vmaps optax's ``tx.update`` over the node axis, as its federation
does. Tolerances:

- one step and five steps of ``adam_update`` against optax: params,
  ``mu`` and ``nu`` within 2 ulp of their own dtype per leaf (the port
  writes optax's arithmetic out op for op; the bias correction's
  ``b ** count`` is a libm ``pow`` on each side, which may differ by an
  ulp), ``count`` exact;
- the learner's ``apply_update`` (explicit decay, the gate, the
  optimizer) against the JAX learner's, per optimizer: the same 2-ulp
  bound on params and state, after the update's own magnitude (``lr``
  times the step) is taken into account for SGD, whose XLA path fuses
  ``p + m * -lr`` into one FMA (``tests/test_torch_sgd_accum.py``);
- a gated-off node: params bit for bit, ``mu`` and ``nu`` exactly the
  decayed state, ``count`` incremented, no NaN anywhere from a NaN
  gradient on that node;
- a 2-round FEMNIST-CNN Scenario with adam against the JAX Scenario in
  f32 compute and wire: train losses at ``test_torch_federation.py``'s
  f32 tier (rtol 1e-5) and accuracies equal; every leaf's parameters
  within relative L2 1e-5, that tier, except Dense_0's kernel, held to
  1e-4. Adam divides every gradient by its own running magnitude, so an
  element whose gradient is a nearly cancelling sum (a quarter of
  Dense_0's kernel has ``nu_hat`` under 1e-12 after the 6 steps) turns
  f32 summation-order noise (XLA's conv against PyTorch's) into a
  step-sized difference: measured 1.4e-5 on Dense_0's kernel, under
  3.1e-6 on every other leaf, where SGD's tier-1 run stays under 1e-5
  everywhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from p2pfl_tpu.learning import learner as jlearner
from p2pfl_tpu_torch.convert import adam_state_from_optax
from p2pfl_tpu_torch.learning import learner as tlearner
from p2pfl_tpu_torch.learning.learner import AdamState, TrainState

from test_torch_federation import F32_RTOL, _jax_config, _run_both

N = 3
SHAPES = {"Dense_0": {"kernel": (N, 7, 5), "bias": (N, 5)},
          "w": (N, 17), "rho": (N,)}
LR = 1e-3
ULPS = 2
# Dense_0's kernel under adam (the module docstring says why)
ADAM_DENSE0_KERNEL_REL_L2 = 1e-4


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _draw(rng, scale=1.0):
    return _tree(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32))


def _to_jax(tree, dtype=jnp.float32):
    return _tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree):
    return _tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                     tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_ulps(t, j, dtype, ulps=ULPS, extra=None):
    """Every leaf of ``t`` within ``ulps`` ulp (in ``dtype``) of ``j``'s,
    plus ``extra`` (a tree of absolute allowances) where given."""
    eps = float(jnp.finfo(dtype).eps)
    extras = _leaves(extra) if extra is not None else [0.0] * len(_leaves(j))
    for a, b, e in zip(_leaves(t), _leaves(j), extras):
        a, b = _np(a), _np(b)
        bound = ulps * eps * np.maximum(np.abs(b), np.finfo(np.float32).tiny)
        assert np.all(np.abs(a - b) <= bound + e), float(
            np.max(np.abs(a - b) - bound - e))


def _jax_state(tx, params):
    return jax.vmap(tx.init)(params)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adamw", 1e-2)])
def test_adam_steps_match_optax(name, wd, steps):
    rng = np.random.default_rng(steps)
    p0 = _draw(rng)
    tx = jlearner.make_optimizer(name, LR, weight_decay=wd)
    jp, js = _to_jax(p0), _jax_state(tx, _to_jax(p0))
    # both packages start from one optimizer state, carried across
    tp, ts = _to_torch(p0), adam_state_from_optax(
        jax.tree.map(np.asarray, js[0]))
    assert isinstance(ts, AdamState) and ts.count.shape == (N,)
    for _ in range(steps):
        # gradients over four decades, so mu and nu see every scale
        g = _draw(rng, scale=10.0 ** rng.uniform(-3, 1))
        u, js = jax.vmap(tx.update)(_to_jax(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = tlearner.adam_update(tp, _to_torch(g), ts, LR, wd)
    jstate = js[0]
    _assert_ulps(tp, jp, jnp.float32)
    _assert_ulps(ts.mu, jstate.mu, jnp.float32)
    _assert_ulps(ts.nu, jstate.nu, jnp.float32)
    assert ts.count.dtype == torch.int32
    np.testing.assert_array_equal(ts.count.numpy(), np.asarray(jstate.count))
    np.testing.assert_array_equal(ts.count.numpy(), np.full(N, steps))


def test_mu_is_stored_in_the_momentum_dtype():
    rng = np.random.default_rng(7)
    p0 = _draw(rng)
    tx = jlearner.make_optimizer("adam", LR, momentum_dtype="bf16")
    jp = _to_jax(p0)
    js = _jax_state(tx, jp)
    fns = tlearner.make_step_fns(None, optimizer="adam", learning_rate=LR,
                                 momentum_dtype="bf16")
    ts = fns.init_opt_state(_to_torch(p0))
    assert all(m.dtype == torch.bfloat16 for m in _leaves(ts.mu))
    assert all(v.dtype == torch.float32 for v in _leaves(ts.nu))
    tp = _to_torch(p0)
    for _ in range(3):
        g = _draw(rng)
        u, js = jax.vmap(tx.update)(_to_jax(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = tlearner.adam_update(tp, _to_torch(g), ts, LR)
    assert all(m.dtype == torch.bfloat16 for m in _leaves(ts.mu))
    assert all(np.asarray(m).dtype == jnp.bfloat16 for m in _leaves(js[0].mu))
    # mu in bf16: the stored moments within 2 bf16 ulp, params and nu
    # (updated from the uncast f32 mu) within 2 f32 ulp
    _assert_ulps(ts.mu, js[0].mu, jnp.bfloat16)
    _assert_ulps(ts.nu, js[0].nu, jnp.float32)
    _assert_ulps(tp, jp, jnp.float32)


def _both_learners(name, wd, p0, gate):
    """One apply_update of each package's learner from the same params
    and state, gradients drawn alike; returns (port state, JAX state)."""
    rng = np.random.default_rng(11)
    kw = dict(optimizer=name, learning_rate=0.05, momentum=0.9,
              weight_decay=wd)
    jfns = jlearner.make_step_fns(None, **kw)
    tfns = tlearner.make_step_fns(None, **kw)
    jp = _to_jax(p0)
    jst = jlearner.TrainState(params=jp, opt_state=_jax_state(jfns.tx, jp),
                              rng=jax.vmap(jax.random.PRNGKey)(
                                  jnp.arange(N)),
                              step=jnp.zeros(N, jnp.int32))
    tp = _to_torch(p0)
    tst = TrainState(params=tp, opt_state=tfns.init_opt_state(tp),
                     rng=torch.Generator(),
                     step=torch.zeros(N, dtype=torch.int64))
    for _ in range(2):
        g = _draw(rng)
        jst = jax.vmap(jfns.apply_update)(jst, _to_jax(g), jnp.asarray(gate))
        tst = tfns.apply_update(tst, _to_torch(g), torch.from_numpy(gate))
    return tst, jst


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_learner_update_with_decay_and_gate_matches_jax(name):
    """Explicit decay on the gradient (sgd, adam) or decoupled (adamw),
    the gate, the optimizer: the port's learner against the JAX one."""
    p0 = _draw(np.random.default_rng(3))
    gate = np.array([1.0, 0.0, 1.0], np.float32)
    tst, jst = _both_learners(name, 1e-2, p0, gate)
    if name == "sgd":
        # XLA fuses p + m * -lr into an FMA; allow the product's ulp
        extra = _tree_map(lambda m: 0.05 * np.spacing(np.abs(np.asarray(
            m, np.float32))) * 4, jst.opt_state[0].trace)
        _assert_ulps(tst.params, jst.params, jnp.float32, extra=extra)
        _assert_ulps(tst.opt_state, jst.opt_state[0].trace, jnp.float32)
    else:
        _assert_ulps(tst.params, jst.params, jnp.float32)
        _assert_ulps(tst.opt_state.mu, jst.opt_state[0].mu, jnp.float32)
        _assert_ulps(tst.opt_state.nu, jst.opt_state[0].nu, jnp.float32)
        np.testing.assert_array_equal(tst.opt_state.count.numpy(),
                                      np.asarray(jst.opt_state[0].count))
    # the gated-off node kept its params bit for bit
    for a, b in zip(_leaves(tst.params), _leaves(_to_torch(p0))):
        assert torch.equal(a[1], b[1])


def test_decay_rides_the_gradient_for_adam_and_the_update_for_adamw():
    """Zero gradients and weight decay 0.1: adam's decay enters mu (it
    is added to the gradient), adamw's does not (it is added to the adam
    direction after the moments)."""
    p0 = _draw(np.random.default_rng(5))
    zero = _tree_map(np.zeros_like, p0)
    for name, fed_in in [("adam", True), ("adamw", False)]:
        fns = tlearner.make_step_fns(None, optimizer=name, learning_rate=LR,
                                     weight_decay=0.1)
        tp = _to_torch(p0)
        st = TrainState(params=tp, opt_state=fns.init_opt_state(tp),
                        rng=torch.Generator(),
                        step=torch.zeros(N, dtype=torch.int64))
        st = fns.apply_update(st, _to_torch(zero))
        mu_moved = any(bool(m.abs().max() > 0)
                       for m in _leaves(st.opt_state.mu))
        assert mu_moved == fed_in, name
        # both move the params (the decay is applied either way)
        assert any(not torch.equal(a, b)
                   for a, b in zip(_leaves(st.params), _leaves(tp)))


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_gated_off_node_keeps_params_and_its_state_decays(name):
    rng = np.random.default_rng(9)
    p0 = _draw(rng)
    fns = tlearner.make_step_fns(None, optimizer=name, learning_rate=LR,
                                 weight_decay=1e-2)
    tp = _to_torch(p0)
    st = TrainState(params=tp, opt_state=fns.init_opt_state(tp),
                    rng=torch.Generator(),
                    step=torch.zeros(N, dtype=torch.int64))
    # one step on every node so the moments are non-zero
    st = fns.apply_update(st, _to_torch(_draw(rng)))
    before = st
    g = _to_torch(_draw(rng))
    for leaf in _leaves(g):
        leaf[1] = float("nan")  # node 1's shard gave a NaN gradient
    gate = torch.tensor([1.0, 0.0, 1.0])
    st = fns.apply_update(st, g, gate)
    for a, b in zip(_leaves(st.params), _leaves(before.params)):
        assert torch.equal(a[1], b[1])
        assert torch.isfinite(a).all()
    b1, b2 = tlearner.ADAM_B1, tlearner.ADAM_B2
    for key, decay in (("mu", b1), ("nu", b2)):
        new = _leaves(getattr(st.opt_state, key))
        old = _leaves(getattr(before.opt_state, key))
        for a, b in zip(new, old):
            assert torch.isfinite(a).all()
            # (1 - b) * 0 + b * m, as the vmapped optax update computes
            want = (1 - decay) * torch.zeros_like(b[1]) + decay * b[1]
            assert torch.equal(a[1], want)
    np.testing.assert_array_equal(st.opt_state.count.numpy(), [2, 2, 2])


def test_scenario_with_adam_matches_jax(tmp_path):
    """2 rounds of the 4-node FEMNIST-CNN ring with adam (lr 1e-3), f32
    compute and wire: losses within rtol 1e-5, accuracies equal, params
    within relative L2 1e-5 a leaf, Dense_0's kernel 1e-4 (the module
    docstring says why)."""
    jcfg = _jax_config("DFL", "ring")
    jcfg.model.compute_dtype = "float32"
    jcfg.wire_dtype = "f32"
    jcfg.training.optimizer = "adam"
    jcfg.training.learning_rate = 1e-3
    tl, jl, rel, tacc, jacc = _run_both(tmp_path, jcfg)
    np.testing.assert_allclose(tl, jl, rtol=F32_RTOL)
    for keys, r in rel.items():
        limit = (ADAM_DENSE0_KERNEL_REL_L2
                 if keys[-2:] == ("Dense_0", "kernel") else F32_RTOL)
        assert r < limit, (keys, r)
    np.testing.assert_array_equal(tacc, jacc)
