"""K6 on the CPU: the port's ``fused_mlp_train_epoch`` (its plain
version, which CPU tensors take) against the JAX package's Pallas
kernel in interpret mode, on the same numpy inputs from a seed.

Tolerances are the JAX test's own (``tests/test_fused_train.py``):
params and momentum rtol 2e-4, atol 2e-5; the loss rtol 1e-4, atol
1e-5. Both sides compute in f32 and sum in other orders (XLA's dot
against ``torch.bmm``); nothing else differs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.ops import fused_train as jfused
from p2pfl_tpu_torch.ops import fused_train as tfused

STATE_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(n, d_in, d1, d2, c, rows, seed):
    rng = np.random.default_rng(seed)
    shapes = [(n, d_in, d1), (n, 1, d1), (n, d1, d2), (n, 1, d2),
              (n, d2, c), (n, 1, c)]
    params = [(rng.standard_normal(s) * 0.05).astype(np.float32)
              for s in shapes]
    mom = [(rng.standard_normal(s) * 0.01).astype(np.float32)
           for s in shapes]
    bx = rng.standard_normal((n, rows, d_in)).astype(np.float32)
    by = rng.integers(0, c, (n, rows, 1)).astype(np.int32)
    return params, mom, bx, by


def _both(params, mom, bx, by, lr=0.05, beta=0.9, batch=32):
    j = jfused.fused_mlp_train_epoch(
        tuple(map(jnp.asarray, params)), tuple(map(jnp.asarray, mom)),
        jnp.asarray(bx), jnp.asarray(by), lr, beta, batch_size=batch,
        interpret=True)
    t = tfused.fused_mlp_train_epoch(
        tuple(map(torch.from_numpy, params)),
        tuple(map(torch.from_numpy, mom)),
        torch.from_numpy(bx), torch.from_numpy(by), lr, beta,
        batch_size=batch)
    return j, t


def _assert_close(j, t):
    (jp, jm, jl), (tp, tm, tl) = j, t
    for a, b in zip(jp + jm, tp + tm):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **STATE_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)


@pytest.mark.parametrize("n,d_in,d1,d2,c,rows,batch", [
    (3, 784, 256, 128, 10, 96, 32),  # the JAX test's shape
    (2, 40, 24, 12, 5, 48, 16),  # narrow widths, 3 steps
    (3, 33, 17, 9, 7, 40, 8),  # odd widths, 5 steps
])
def test_epoch_matches_jax(n, d_in, d1, d2, c, rows, batch):
    params, mom, bx, by = _inputs(n, d_in, d1, d2, c, rows, seed=rows)
    _assert_close(*_both(params, mom, bx, by, batch=batch))


def test_short_shard_is_one_step_of_all_rows():
    params, mom, bx, by = _inputs(2, 64, 32, 16, 10, 20, seed=1)
    j, t = _both(params, mom, bx, by, batch=32)
    _assert_close(j, t)
    one = tfused.fused_mlp_train_epoch(
        tuple(map(torch.from_numpy, params)),
        tuple(map(torch.from_numpy, mom)),
        torch.from_numpy(bx), torch.from_numpy(by), 0.05, 0.9,
        batch_size=20)
    for a, b in zip(t[0] + t[1] + (t[2],), one[0] + one[1] + (one[2],)):
        assert torch.equal(a, b)


def test_ragged_rows_raise_as_in_jax():
    params, mom, bx, by = _inputs(2, 16, 8, 8, 4, 40, seed=2)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        _both(params, mom, bx, by, batch=32)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        tfused.fused_mlp_train_epoch(
            tuple(map(torch.from_numpy, params)),
            tuple(map(torch.from_numpy, mom)), torch.from_numpy(bx),
            torch.from_numpy(by), 0.05, batch_size=32)


def test_loss_falls_over_five_epochs():
    """The JAX test's learning check on the port: mean loss after five
    epochs below 0.8 of the first epoch's."""
    params, mom, bx, by = _inputs(2, 784, 256, 128, 10, 96, seed=3)
    p = tuple(map(torch.from_numpy, params))
    m = tuple(torch.zeros_like(t) for t in p)
    x, y = torch.from_numpy(bx), torch.from_numpy(by)
    losses = []
    for _ in range(5):
        p, m, loss = tfused.fused_mlp_train_epoch(p, m, x, y, 0.05, 0.9)
        losses.append(float(loss.mean()))
    assert losses[-1] < losses[0] * 0.8, losses


def test_outputs_keep_the_input_dtype():
    params, mom, bx, by = _inputs(2, 16, 8, 8, 4, 16, seed=4)
    p = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in params)
    m = tuple(map(torch.from_numpy, mom))
    kp, km, kl = tfused.fused_mlp_train_epoch(
        p, m, torch.from_numpy(bx), torch.from_numpy(by).long(), 0.05,
        batch_size=8)
    assert all(t.dtype == torch.bfloat16 for t in kp)
    assert all(t.dtype == torch.float32 for t in km)
    assert kl.dtype == torch.float32 and kl.shape == (2,)


def test_param_bridge_round_trips_the_mnist_mlp_tree():
    from p2pfl_tpu.models import get_model as jget_model
    from p2pfl_tpu_torch.convert import params_from_jax
    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.models.base import get_model

    model = get_model("mnist-mlp")
    one = model.init(torch.Generator().manual_seed(0),
                     torch.zeros(1, 28, 28, 1))
    stacked = {"params": {k: {n: t.unsqueeze(0).repeat((2,) + (1,) * t.dim())
                              for n, t in v.items()}
                          for k, v in one["params"].items()}}
    t = tfused.mlp_params_to_tuple(stacked)
    assert [tuple(a.shape) for a in t] == [
        (2, 784, 256), (2, 1, 256), (2, 256, 128), (2, 1, 128), (2, 128, 10),
        (2, 1, 10)]
    back = tfused.tuple_to_mlp_params(t)
    for a, b in zip(tree_leaves(stacked), tree_leaves(back)):
        assert torch.equal(a, b)
    # the same bridge on the JAX package's tree, carried across
    jmodel = jget_model("mnist-mlp")
    jstacked = jax.vmap(lambda r: jmodel.init(r, jnp.zeros((1, 28, 28, 1))))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    jt = jfused.mlp_params_to_tuple(jstacked)
    pt = tfused.mlp_params_to_tuple(params_from_jax(
        jax.tree.map(np.asarray, jstacked)))
    for a, b in zip(jt, pt):
        assert np.array_equal(np.asarray(a), b.numpy())


def _sequential(vals, order):
    """The float32 values ``vals[k]`` for k in ``order`` added one f32
    add at a time, from zero."""
    out = np.float32(0.0)
    for k in order:
        out = np.float32(out + vals[k])
    return out


@pytest.mark.parametrize("batch", [8, 16, 32, 64])
@pytest.mark.parametrize("classes", [7, 10, 62])
def test_written_out_sums_follow_the_stated_orders(batch, classes):
    """The plain epoch's bias-gradient and softmax-denominator sums
    (``batch_sum``, ``class_sum``) give, bit for bit, one f32 add at a
    time in the order ``csrc/fused_train.cu`` states: over the batch,
    accumulator r takes b = r (mod 4) ascending and the four meet as
    ((a0 + a1) + a2) + a3; over the classes, lane l is the sum over
    k = l (mod 8) plus the sum over k = l + 4 (mod 8) and the lanes meet
    as (l0 + l2) + (l1 + l3)."""
    rng = np.random.default_rng(batch * 100 + classes)
    # values of mixed scale, so that another order changes the bits
    t = (rng.standard_normal((2, batch, classes))
         * np.exp(rng.uniform(-8, 8, (2, batch, classes)))).astype(
             np.float32)
    got_b = tfused.batch_sum(torch.from_numpy(t)).numpy()
    got_c = tfused.class_sum(torch.from_numpy(t)).numpy()
    assert got_b.shape == (2, 1, classes) and got_c.shape == (2, batch, 1)
    for i in range(2):
        for j in range(classes):
            col = t[i, :, j]
            a = [_sequential(col, range(r, batch, 4)) for r in range(4)]
            want = np.float32(np.float32(np.float32(a[0] + a[1]) + a[2])
                              + a[3])
            assert got_b[i, 0, j].view(np.int32) == want.view(np.int32)
        for j in range(batch):
            row = t[i, j]
            lane = [np.float32(_sequential(row, range(q, classes, 8))
                               + _sequential(row, range(q + 4, classes, 8)))
                    for q in range(4)]
            want = np.float32(np.float32(lane[0] + lane[2])
                              + np.float32(lane[1] + lane[3]))
            assert got_c[i, j, 0].view(np.int32) == want.view(np.int32)
    # one chain in ascending order gives other bits (the check has teeth)
    chain_b = [_sequential(t[i, :, j], range(batch))
               for i in range(2) for j in range(classes)]
    chain_c = [_sequential(t[i, j], range(classes))
               for i in range(2) for j in range(batch)]
    assert not np.array_equal(np.array(chain_b), got_b[:, 0].reshape(-1))
    assert not np.array_equal(np.array(chain_c), got_c[..., 0].reshape(-1))
