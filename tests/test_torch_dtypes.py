"""The port's dtype instantiations on the CPU (A19): f32 compute through
the kernel wrappers, bf16 parameters and traces through K4, bf16 state
through K6, and the config's dtype knobs.

Inputs are numpy draws from a seed handed to both packages; the JAX
side runs its Pallas kernels in interpret mode, per node as its
``vmap`` does. Tolerances:

- f32 ``patches_matmul``, ``conv2_matmul`` and ``dense_matmul``
  (forward, dx, dw): summation order only, rtol 1e-5, atol 1e-4 (the
  f32 tier of ``test_torch_ops.py``);
- one SGD step with bf16 params, gradient and trace against the JAX
  ``_sgd`` kernel: each side computes in f32 and rounds once to bf16, so
  params and trace within one bf16 ulp (of the larger of the two, as a
  rounding may cross a power of two); XLA:CPU contracts ``p + m' * -lr``
  into an FMA where the port rounds the product first, so params get
  one f32 ulp of that product more (it shows where the sum cancels to
  near zero); at gate 0 the params bit for bit;
- K6's plain version with bf16 params, trace and inputs against the JAX
  ``fused_mlp_train_epoch``: both widen to f32, train in f32 in their
  own summation orders and round once, so each state value within one
  bf16 ulp plus ``test_torch_fused_train.py``'s f32 allowance (rtol
  2e-4, atol 2e-5), the loss (f32) at its rtol 1e-4, atol 1e-5.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.ops import fused_train as jfused
from p2pfl_tpu.ops import pallas_gemm
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.ops import fused_train as tfused
from p2pfl_tpu_torch.ops import gemm

_N = 2
F32_SUM_TOL = dict(rtol=1e-5, atol=1e-4)
K6_STATE_TOL = dict(rtol=2e-4, atol=2e-5)
K6_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def _draw(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _bf16_ulp(a):
    """One bf16 ulp at each value of ``a`` (f32 array)."""
    a = np.abs(np.asarray(a, np.float32))
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7).astype(np.float32)


@pytest.mark.parametrize("fn,k,n", [("patches_matmul", 25, 32),
                                    ("conv2_matmul", 800, 64),
                                    ("dense_matmul", 300, 48)])
@pytest.mark.parametrize("m", [64, 129])
def test_f32_composites_match_pallas_forward_and_backward(fn, k, n, m):
    x, w = _draw(1, (_N, m, k)), _draw(2, (_N, k, n), 0.1)
    g = _draw(3, (_N, m, n))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = getattr(gemm, fn)(xt, wt)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    kw = {"block_d": 128} if fn == "dense_matmul" else {"block_m": 64}
    for i in range(_N):
        f = jax.tree_util.Partial(getattr(pallas_gemm, fn), interpret=True,
                                  **kw)
        jy, vjp = jax.vjp(f, jnp.asarray(x[i]), jnp.asarray(w[i]))
        jdx, jdw = vjp(jnp.asarray(g[i]))
        assert jy.dtype == jnp.float32
        np.testing.assert_allclose(_np(y[i]), _np(jy), **F32_SUM_TOL)
        np.testing.assert_allclose(_np(dx[i]), _np(jdx), **F32_SUM_TOL)
        np.testing.assert_allclose(_np(dw[i]), _np(jdw), **F32_SUM_TOL)


@pytest.mark.parametrize("shape", [(33, 64), (17,), (5, 5, 4, 8)])
def test_bf16_sgd_step_matches_pallas_sgd(shape):
    """K4's plain version with bf16 p, g and trace (the 64-node
    headline's state) against ``_sgd`` in interpret mode; node 1's gate
    is 0."""
    p, m, g = (_draw(s, (_N,) + shape) for s in (4, 5, 6))
    lr = np.array([0.05, 0.0], np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got_p, got_m = gemm.sgd_accum(bf(p), bf(m), bf(g), torch.from_numpy(lr),
                                  momentum=0.9)
    assert got_p.dtype == got_m.dtype == torch.bfloat16
    assert torch.equal(got_p[1], bf(p)[1])
    for i in range(_N):
        want_p, want_m = pallas_gemm.sgd_accum(
            jnp.asarray(p[i], jnp.bfloat16), jnp.asarray(m[i], jnp.bfloat16),
            jnp.asarray(g[i], jnp.bfloat16), jnp.float32(lr[i]),
            momentum=0.9, block_m=16, interpret=True)
        assert want_p.dtype == want_m.dtype == jnp.bfloat16
        fma = np.spacing(np.abs(_np(want_m) * lr[i]))  # the skipped rounding
        for got, want, extra in ((got_p[i], want_p, fma),
                                 (got_m[i], want_m, 0.0)):
            a, b = _np(got), _np(want)
            bound = _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + extra
            assert np.all(np.abs(a - b) <= bound), float(
                np.max(np.abs(a - b) - bound))


def _k6_inputs(n, d_in, d1, d2, c, rows, seed):
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


@pytest.mark.parametrize("n,d_in,d1,d2,c,rows,batch", [
    (2, 784, 256, 128, 10, 64, 32),  # mnist-mlp's widths, 2 steps
    (3, 40, 24, 12, 5, 48, 16),  # narrow widths, 3 steps
])
def test_k6_plain_with_bf16_state_matches_pallas(n, d_in, d1, d2, c, rows,
                                                 batch):
    params, mom, bx, by = _k6_inputs(n, d_in, d1, d2, c, rows, seed=rows)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jp, jm, jl = jfused.fused_mlp_train_epoch(
        tuple(map(jb, params)), tuple(map(jb, mom)), jb(bx),
        jnp.asarray(by), 0.05, 0.9, batch_size=batch, interpret=True)
    tp, tm, tl = tfused.fused_mlp_train_epoch(
        tuple(map(tb, params)), tuple(map(tb, mom)), tb(bx),
        torch.from_numpy(by), 0.05, 0.9, batch_size=batch)
    for a, b in zip(tp + tm, jp + jm):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        want = _np(b)
        d = np.abs(_np(a) - want)
        bound = (_bf16_ulp(want) + K6_STATE_TOL["rtol"] * np.abs(want)
                 + K6_STATE_TOL["atol"])
        assert np.all(d <= bound), float(np.max(d - bound))
    np.testing.assert_allclose(_np(tl), _np(jl), **K6_LOSS_TOL)


_DT = (None, "float32", "bfloat16")


def _raw(**model):
    raw = dataclasses.asdict(jschema.ScenarioConfig(n_nodes=2))
    raw["model"].update(model)
    return raw


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("objective", ["classification", "autoencoder",
                                       "ocsvm"])
def test_schema_accepts_every_lifted_combination(optimizer, objective):
    for compute, param in itertools.product(_DT + ("f32", "bf16"), _DT):
        raw = _raw(objective=objective, compute_dtype=compute,
                   param_dtype=param)
        raw["training"]["optimizer"] = optimizer
        cfg = ScenarioConfig.from_dict(raw)
        assert cfg.model.compute_dtype == compute
        assert cfg.training.optimizer == optimizer


@pytest.mark.parametrize("knob", ["compute_dtype", "param_dtype"])
@pytest.mark.parametrize("value", ["float16", "float64", "int8"])
def test_schema_still_refuses_other_dtypes_naming_a19(knob, value):
    with pytest.raises(NotImplementedError, match="A19"):
        ScenarioConfig.from_dict(_raw(**{knob: value}))
