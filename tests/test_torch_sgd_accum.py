"""K5 on the CPU: the port's ``sgd_accum(acc=, weight=)`` and
``fedavg_accum`` (their plain versions) against the JAX package's
Pallas ``_sgd_accum_kernel`` in interpret mode.

Inputs are drawn with numpy from a seed and handed to both packages;
the JAX side runs per slot, as its ``vmap`` does, the port takes the
slot axis directly. Leaves of rank 1, 2 and 4 a slot; p in f32 and in
bf16; the trace in f32 and in bf16.

Tolerance: XLA:CPU contracts each multiply-add of the interpreted
kernel into an FMA (``g + decay * m``, ``p + m' * -lr``, ``acc + w *
p'``), where the port rounds the product first, as its CUDA kernel
does. So each output is held within one ulp, in its own dtype, of the
largest term of its multiply-add (the rounding an FMA skips), plus the
allowance of the operand it carries from the step before: ``p'``
carries ``lr`` times ``m'``'s, ``acc'`` carries ``w`` times ``p'``'s.
In these cases p' and m' came out bit-exact wherever they are bf16, and
the null form within one f32 ulp. At lr 0 p comes back bit for bit on
both sides.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p2pfl_tpu.ops import pallas_gemm
from p2pfl_tpu_torch.ops import gemm

_N = 2  # slots
_SHAPES = [(62,), (33, 64), (5, 5, 4, 8)]
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
_LR = np.array([0.1, 0.0], np.float32)  # slot 1 gated off
_W = np.array([0.3, 0.7], np.float32)


def _draw(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(a, dt):
    jd, td = _DT[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _ulp(dt, *terms):
    """One ulp, in dtype ``dt``, of the largest of ``terms``."""
    big = np.max(np.abs(np.stack([np.asarray(t, np.float32)
                                  for t in terms])), axis=0)
    f32 = np.spacing(big.astype(np.float32))
    return f32 * 2.0 ** 16 if dt == "bf16" else f32


def _within(got, want, tol):
    d = np.abs(_np(got) - _np(want))
    assert np.all(d <= tol), float((d - tol).max())


@pytest.mark.parametrize("trace", ["f32", "bf16"])
@pytest.mark.parametrize("pdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_sgd_accum_with_acc_matches_pallas(shape, pdt, trace):
    pj, pt = _pair(_draw(0, (_N,) + shape), pdt)
    mj, mt = _pair(_draw(1, (_N,) + shape), trace)
    gj, gt = _pair(_draw(2, (_N,) + shape), pdt)
    aj, at = _pair(_draw(3, (_N,) + shape), "f32")
    got_p, got_m, got_a = gemm.sgd_accum(
        pt, mt, gt, torch.from_numpy(_LR), momentum=0.9, acc=at,
        weight=torch.from_numpy(_W))
    assert (got_p.dtype, got_m.dtype, got_a.dtype) == (
        pt.dtype, mt.dtype, torch.float32)
    assert got_p.shape == got_m.shape == got_a.shape == pt.shape
    decay = float(jnp.asarray(0.9, _DT[trace][0]))
    for i in range(_N):
        want_p, want_m, want_a = pallas_gemm.sgd_accum(
            pj[i], mj[i], gj[i], jnp.float32(_LR[i]), momentum=0.9,
            acc=aj[i], weight=jnp.float32(_W[i]), block_m=16,
            interpret=True)
        m_new = _np(want_m)
        tol_m = _ulp(trace, _np(gj[i]), decay * _np(mj[i]), m_new)
        _within(got_m[i], want_m, tol_m)
        tol_p = (_ulp(pdt, _np(pj[i]), m_new * _LR[i], _np(want_p))
                 + _LR[i] * tol_m)
        _within(got_p[i], want_p, tol_p)
        tol_a = (_ulp("f32", _np(aj[i]), _W[i] * _np(want_p), _np(want_a))
                 + _W[i] * tol_p)
        _within(got_a[i], want_a, tol_a)
    # lr 0: the params bit for bit, on both sides
    assert torch.equal(got_p[1], pt[1])
    assert np.array_equal(_np(want_p), _np(pt[1]))


@pytest.mark.parametrize("pdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_fedavg_accum_matches_pallas(shape, pdt):
    pj, pt = _pair(_draw(4, (_N,) + shape), pdt)
    aj, at = _pair(_draw(5, (_N,) + shape), "f32")
    got = gemm.fedavg_accum(pt, at, torch.from_numpy(_W))
    assert got.dtype == torch.float32 and got.shape == at.shape
    for i in range(_N):
        want = pallas_gemm.fedavg_accum(pj[i], aj[i], jnp.float32(_W[i]),
                                        block_m=16, interpret=True)
        _within(got[i], want,
                _ulp("f32", _np(aj[i]), _W[i] * _np(pj[i]), _np(want)))


@pytest.mark.parametrize("pdt", ["f32", "bf16"])
def test_fedavg_accum_is_the_null_sgd_accum_step(pdt):
    """The null form computes the general form's accumulate at g = 0,
    momentum 0 and lr 0, bit for bit: skipping the optimizer half
    changes nothing."""
    _, pt = _pair(_draw(6, (_N, 7, 9)), pdt)
    _, at = _pair(_draw(7, (_N, 7, 9)), "f32")
    w = torch.from_numpy(_W)
    z = torch.zeros_like(pt)
    _, _, acc = gemm.sgd_accum(pt, z, z, torch.zeros(_N), momentum=0.0,
                               acc=at, weight=w)
    assert torch.equal(gemm.fedavg_accum(pt, at, w), acc)


def test_k5_wrappers_refuse_bad_operands():
    p = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="go together"):
        gemm.sgd_accum(p, p, p, torch.ones(2), momentum=0.9, acc=p)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.fedavg_accum(p, torch.zeros(2, 3, device="meta"),
                          torch.ones(2))
    gemm.reset_launches()
    gemm.fedavg_accum(p, p, torch.ones(2))
    # the CPU takes the plain version: no kernel was launched
    assert gemm.launches["fedavg_accum"] == 0
