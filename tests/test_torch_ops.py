"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode.

Inputs are drawn with numpy from a seed and handed to both packages.
On the CPU each wrapper of ``p2pfl_tpu_torch.ops.gemm`` runs its plain
version, so these tests pin the arithmetic the CUDA kernels must match
(their on-card comparison is ``tests/test_torch_kernels_cuda.py``).
The JAX side runs per node, as its ``vmap`` does; the port takes the
node axis directly. Tolerances:

- bf16 outputs (K1, K3): both sides sum in f32 and round once, in
  different orders, so they agree to one bf16 ulp: rtol 2**-7, plus an
  atol of 1e-3 for sums that cancel to near zero.
- f32 sums (K2): summation order only: rtol 1e-5, atol 1e-4.
- the SGD step (K4): f32 values to a few ulp (XLA:CPU may contract a
  multiply-add into an FMA): rtol 1e-6, atol 1e-6; the bf16 trace to
  one bf16 ulp; at gate 0 the params bit-exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p2pfl_tpu.ops import pallas_gemm
from p2pfl_tpu_torch.ops import gemm

_BLOCK = 64
_MS = [64, 40, 200, 129]
_GEOMS = [(25, 32), (800, 64)]  # conv1, conv2 (K, N)
_N = 2  # nodes

BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
F32_SUM_TOL = dict(rtol=1e-5, atol=1e-4)
SGD_TOL = dict(rtol=1e-6, atol=1e-6)


def _draw(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(a, jdtype=jnp.bfloat16, tdtype=torch.bfloat16):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    return jnp.asarray(a, jdtype), torch.from_numpy(a).to(tdtype)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("k,n", _GEOMS)
@pytest.mark.parametrize("m", _MS)
def test_stream_gemm_plain_matches_pallas(m, k, n):
    xj, xt = _pair(_draw(0, (_N, m, k)))
    wj, wt = _pair(_draw(1, (_N, k, n)))
    got = gemm.stream_gemm(xt, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (_N, m, n)
    for i in range(_N):
        want = pallas_gemm.stream_gemm(xj[i], wj[i], block_m=_BLOCK,
                                       interpret=True)
        np.testing.assert_allclose(_np(got[i]), _np(want), **BF16_TOL)


@pytest.mark.parametrize("k,n", _GEOMS)
@pytest.mark.parametrize("m", _MS)
def test_stream_wgrad_plain_matches_pallas(m, k, n):
    xj, xt = _pair(_draw(2, (_N, m, k)))
    gj, gt = _pair(_draw(3, (_N, m, n)))
    got = gemm.stream_wgrad(xt, gt)
    assert got.dtype == torch.float32 and got.shape == (_N, k, n)
    for i in range(_N):
        want = pallas_gemm.stream_wgrad(xj[i], gj[i], block_m=_BLOCK,
                                        interpret=True)
        np.testing.assert_allclose(_np(got[i]), _np(want), **F32_SUM_TOL)


@pytest.mark.parametrize("d_in", [448, 300, 900])
def test_dense_bwd_plain_matches_pallas(d_in):
    b, h = 16, 32
    xj, xt = _pair(_draw(4, (_N, b, d_in)))
    wj, wt = _pair(_draw(5, (_N, d_in, h)))
    gj, gt = _pair(_draw(6, (_N, b, h)))
    dx, dw = gemm.dense_bwd(xt, wt, gt)
    assert dx.dtype == dw.dtype == torch.bfloat16
    for i in range(_N):
        wdx, wdw = pallas_gemm.dense_bwd(xj[i], wj[i], gj[i], block_d=128,
                                         interpret=True)
        np.testing.assert_allclose(_np(dx[i]), _np(wdx), **BF16_TOL)
        np.testing.assert_allclose(_np(dw[i]), _np(wdw), **BF16_TOL)


@pytest.mark.parametrize("trace", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 130), (7, 130), (62,),
                                   (5, 5, 4, 8)])
def test_sgd_accum_plain_matches_pallas(shape, trace):
    jt, tt = ((jnp.float32, torch.float32) if trace == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    pj, pt = _pair(_draw(7, (_N,) + shape), jnp.float32, torch.float32)
    mj, mt = _pair(_draw(8, (_N,) + shape), jt, tt)
    gj, gt = _pair(_draw(9, (_N,) + shape), jnp.float32, torch.float32)
    lr = np.array([0.1, 0.05], np.float32)
    got_p, got_m = gemm.sgd_accum(pt, mt, gt, torch.from_numpy(lr),
                                  momentum=0.9)
    assert got_p.dtype == torch.float32 and got_m.dtype == tt
    assert got_p.shape == pt.shape and got_m.shape == mt.shape
    for i in range(_N):
        want_p, want_m = pallas_gemm.sgd_accum(
            pj[i], mj[i], gj[i], jnp.float32(lr[i]), momentum=0.9,
            block_m=16, interpret=True)
        np.testing.assert_allclose(_np(got_p[i]), _np(want_p), **SGD_TOL)
        tol = SGD_TOL if trace == "f32" else BF16_TOL
        np.testing.assert_allclose(_np(got_m[i]), _np(want_m), **tol)


@pytest.mark.parametrize("trace", ["f32", "bf16"])
def test_sgd_accum_gate_zero_keeps_params_bit_exact(trace):
    """lr x gate = 0 for node 1: its params come back bit for bit while
    its momentum decays; node 0 (gate 1) moves. Asserted exactly."""
    jt, tt = ((jnp.float32, torch.float32) if trace == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    pj, pt = _pair(_draw(10, (_N, 33, 64)), jnp.float32, torch.float32)
    mj, mt = _pair(_draw(11, (_N, 33, 64)), jt, tt)
    gj, gt = _pair(_draw(12, (_N, 33, 64)), jnp.float32, torch.float32)
    lr = torch.tensor([0.1, 0.0])
    got_p, got_m = gemm.sgd_accum(pt, mt, gt, lr, momentum=0.9)
    assert torch.equal(got_p[1], pt[1])
    assert not torch.equal(got_p[0], pt[0])
    want_p, want_m = pallas_gemm.sgd_accum(pj[1], mj[1], gj[1],
                                           jnp.float32(0.0), momentum=0.9,
                                           block_m=16, interpret=True)
    assert np.array_equal(_np(want_p), _np(got_p[1]))
    tol = SGD_TOL if trace == "f32" else BF16_TOL
    np.testing.assert_allclose(_np(got_m[1]), _np(want_m), **tol)


def _bf16_leaf(seed, shape, grad=True):
    t = torch.from_numpy(_draw(seed, shape)).to(torch.bfloat16)
    return t.requires_grad_(grad)


def _sq_loss(y):
    return (y.float() ** 2).sum()


@pytest.mark.parametrize("fn", ["patches_matmul", "conv2_matmul",
                                "dense_matmul"])
@pytest.mark.parametrize("m", [64, 129])
def test_autograd_functions_match_plain_autograd(fn, m):
    """Each autograd Function's forward and gradients against autograd
    through the plain f32-accumulated matmul (one bf16 ulp)."""
    k, n = (25, 32) if fn == "patches_matmul" else (800, 64)
    x, w = _bf16_leaf(13, (_N, m, k)), _bf16_leaf(14, (_N, k, n))
    y = getattr(gemm, fn)(x, w)
    gx, gw = torch.autograd.grad(_sq_loss(y), (x, w))
    x2, w2 = x.detach().requires_grad_(), w.detach().requires_grad_()
    y2 = gemm.stream_gemm_plain(x2, w2)
    hx, hw = torch.autograd.grad(_sq_loss(y2), (x2, w2))
    np.testing.assert_allclose(_np(y), _np(y2), **BF16_TOL)
    assert gx.dtype == gw.dtype == torch.bfloat16
    for a, b in ((gx, hx), (gw, hw)):
        rel = np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b))
        assert rel < 2.0 ** -8, rel


def test_patches_matmul_skips_dgrad_of_an_input_without_grad():
    """conv1's patches come from the image: no dx is computed."""
    x = _bf16_leaf(15, (_N, 40, 25), grad=False)
    w = _bf16_leaf(16, (_N, 25, 32))
    gemm.reset_launches()
    (gw,) = torch.autograd.grad(_sq_loss(gemm.patches_matmul(x, w)), (w,))
    assert gw.shape == w.shape
    # the CPU takes the plain versions: no kernel was launched
    assert gemm.launches == {k: 0 for k in gemm.launches}


def test_rejects_non_3d_and_mixed_devices():
    with pytest.raises(ValueError, match="operands required"):
        gemm.patches_matmul(torch.zeros(3, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.stream_gemm(torch.zeros(1, 3, 4), torch.zeros(1, 4, 5,
                                                            device="meta"))
