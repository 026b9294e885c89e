"""The numeric design of the f32 K1 and K3 kernels, emulated on the CPU.

``p2pfl_tpu_torch/ops/csrc/gemm_f32_tc.cu`` computes an f32 product as
3xTF32 on ``wgmma``: each operand ``a`` is split into ``hi =
RN_tf32(a)`` (``cvt.rna``: 10 mantissa bits, ties away from zero) and
``lo = RN_tf32(a - hi)``, and the product is ``hi.hi + hi.lo + lo.hi``,
each 8-deep k-step of each pass one ``wgmma`` that adds its exact
products to an f32 accumulator. Here torch on the CPU emulates that
arithmetic at slices of the ring's shapes (conv2's forward, K = 800;
dense1's dx^T, K = 2048, and dw, K = 336), with the kernel's k order
inside each 32-deep box, and holds it to the f32 limits of
``chip_smoke.py`` and the card tests (relative L2 <= 4 u sqrt(L), every
element <= 8 u sqrt(L) sqrt(A**2 @ B**2), u = 2**-24) against the plain
f32 product:

- the split is exact where it must be: ``hi`` has its low 13 bits zero
  and ``|a - hi - lo| <= 2**-22 |a|``;
- with the accumulator rounding to nearest, the three passes pass;
- with the accumulator truncating (as the card's does) and each 32-deep
  box's sum added to an f32 total with round-to-nearest (the kernel's
  promotion), they pass;
- one TF32 pass (``hi.hi``) fails, so the limits can tell TF32 from f32;
- truncation without promotion drifts further and fails them: the
  reason each box's sum is added outside the tensor core.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

U = 2.0 ** -24
REL_C, ELEM_C = 4.0, 8.0


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def perm_kmajor(K: int) -> torch.Tensor:
    """The kernel's k order inside each 32-deep box (K-major A): k-step
    s of a box holds columns 8t + 2s and 8t + 2s + 1, t < 4."""
    q = np.arange(32)
    s, p = q >> 3, q & 7
    box = np.where(p < 4, 8 * p + 2 * s, 8 * (p - 4) + 2 * s + 1)
    order = (np.arange(K // 32)[:, None] * 32 + box[None, :]).reshape(-1)
    return torch.from_numpy(order)


def round_f32(s: torch.Tensor, truncate: bool) -> torch.Tensor:
    """An f64 tensor to f32, to nearest or toward zero."""
    r = s.float()
    if truncate:
        over = r.double().abs() > s.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def three_pass(a: torch.Tensor, b: torch.Tensor, *, truncate: bool,
               promote: bool, passes: int = 3) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` as the kernel sums it: per 8-deep k-step
    and pass, the exact products added to the accumulator and rounded
    to f32 (to nearest, or by truncation); with ``promote`` each 32-deep
    box starts from zero and its sum is added to an f32 total to
    nearest. ``passes`` 3: lo.hi, hi.lo, hi.hi; 1: hi.hi alone."""
    pad = -a.shape[1] % 32  # the kernel's boxes are zero past K
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    order = perm_kmajor(a.shape[1])
    (ah, al), (bh, bl) = split(a[:, order]), split(b[order])
    pairs = [(al, bh), (ah, bl), (ah, bh)][3 - passes:]
    acc = torch.zeros(a.shape[0], b.shape[1])
    total = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        if promote and k0 % 32 == 0:
            total = total + acc
            acc = torch.zeros_like(acc)
        for x, y in pairs:
            prod = x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
            acc = round_f32(acc.double() + prod, truncate)
    return total + acc if promote else acc


def reading(got, a, b) -> tuple[float, float]:
    """(relative L2 in u sqrt(L), largest element in u sqrt(L)
    sqrt(a**2 @ b**2)) of ``got`` against the plain f32 ``a @ b``."""
    want = a @ b
    scale = U * a.shape[1] ** 0.5
    d = (got - want).double()
    elem = scale * (a.double() ** 2 @ b.double() ** 2).sqrt()
    return (float(d.norm() / want.double().norm()) / scale,
            float((d.abs() / elem).max()))


def passes(r) -> bool:
    return r[0] <= REL_C and r[1] <= ELEM_C


# slices of the ring's shapes: conv2's forward (patches @ w), dense1's
# dx^T = w g^T (contraction H) and dw = x^T g (contraction B = 336)
SHAPES = {"conv2_fwd": (256, 800, 64), "dense1_dx": (192, 2048, 112),
          "dense1_dw": (128, 336, 128)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    m, k, n = SHAPES[request.param]
    rng = np.random.default_rng(sorted(SHAPES).index(request.param))
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return request.param, a, b


def test_split_is_exact_where_it_must_be(case):
    _, a, b = case
    for t in (a, b):
        hi, lo = split(t)
        assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
        assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
        rest = (t.double() - hi.double() - lo.double()).abs()
        assert bool((rest <= 2.0 ** -22 * t.double().abs()).all())
        # hi is the nearest TF32 value: within half its unit in the last
        # place (2**-11 relative)
        assert bool(((t - hi).abs() <= 2.0 ** -11 * t.abs()).all())


@pytest.mark.parametrize("truncate,promote", [(False, False), (False, True),
                                              (True, True)])
def test_three_passes_pass_the_f32_limits(case, truncate, promote):
    _, a, b = case
    got = three_pass(a, b, truncate=truncate, promote=promote)
    assert passes(reading(got, a, b)), reading(got, a, b)


def test_one_tf32_pass_fails_the_f32_limits(case):
    _, a, b = case
    got = three_pass(a, b, truncate=False, promote=True, passes=1)
    assert not passes(reading(got, a, b)), reading(got, a, b)


def test_truncation_without_promotion_fails_the_f32_limits(case):
    _, a, b = case
    kept = reading(three_pass(a, b, truncate=True, promote=True), a, b)
    drift = reading(three_pass(a, b, truncate=True, promote=False), a, b)
    assert drift[0] > kept[0] and not passes(drift), (drift, kept)
