"""K2's sum designs (``stream_wgrad``), emulated on the CPU.

The kernels run only on the card; their arithmetic is fixed by design,
so torch on the CPU reproduces it at slices of the path shapes and holds
it to the limits the card is held to (``chip_smoke.py``: relative L2
<= 4 u sqrt(L), every element <= 8 u sqrt(L) sqrt(A**2 @ B**2), u =
2**-24, L the summed length, against the plain f32 product):

- float32, K >= 33 (route ``f32_tc``, ``csrc/gemm_f32_tc.cu``): x^T g as
  3xTF32 on ``wgmma`` with x M-major as A, each 32-row box of a slice
  from a fresh accumulator whose sum is added to an f32 total to
  nearest, the slices' partials then added in slice order. At conv2's
  widths (K = 800, N = 64) over a few thousand rows it passes; one TF32
  pass fails; the tensor core's truncation without the promotion fails.
- float32, K <= 32 (route ``f32_narrow``): one fmaf chain a value in
  ascending row within a slice, slices added in order; at the ResNet9
  stem's K = 27 it passes, and the product in TF32 and the sum missing
  a slice fail.
- bf16, the wide route (``csrc/stream_wgrad.cu``, wgmma over 16-row
  k-steps): a truncating accumulator over a whole 4,128-row slice (the
  ring's conv2 plan, as the route first summed) lands farther from the
  f64 product than the same sum rounded to nearest; the repaired design,
  a fresh accumulator every ``WIDE_BOX_ROWS`` = 64 rows added to an f32
  total to nearest, is no farther (64 was the closest of 32 to 512).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

U = 2.0 ** -24
REL_C, ELEM_C = 4.0, 8.0
# the wide route's box (kWBoxRows in csrc/stream_wgrad.cu)
WIDE_BOX_ROWS = 64


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def round_f32(s: torch.Tensor, truncate: bool) -> torch.Tensor:
    """An f64 tensor to f32, to nearest or toward zero."""
    r = s.float()
    if truncate:
        over = r.double().abs() > s.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def perm_mmajor(L: int) -> torch.Tensor:
    """The f32_tc kernel's row order inside each 32-row box (M-major A):
    k-step s takes box rows 8s + ((p & 1) << 2) + (p >> 1), p < 8."""
    q = np.arange(32)
    s, p = q >> 3, q & 7
    box = 8 * s + ((p & 1) << 2) + (p >> 1)
    return torch.from_numpy(
        (np.arange(L // 32)[:, None] * 32 + box[None, :]).reshape(-1))


def tc_wgrad(x: torch.Tensor, g: torch.Tensor, slice_rows: int, *,
             truncate: bool, promote: bool, passes: int = 3) -> torch.Tensor:
    """``x [L, K]^T @ g [L, N]`` as the f32_tc route sums it: the rows
    cut into slices of ``slice_rows`` (a multiple of 32), each slice's
    8-row k-steps added per pass (lo.hi, hi.lo, hi.hi; or hi.hi alone)
    to an f32 accumulator (to nearest or by truncation); with
    ``promote`` each 32-row box starts from zero and its sum joins the
    slice's f32 total to nearest; the slices' partials are then added in
    slice order."""
    pad = -x.shape[0] % 32  # the kernel's boxes are zero past M
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    g = torch.nn.functional.pad(g, (0, 0, 0, pad))
    order = perm_mmajor(x.shape[0])
    (ah, al), (bh, bl) = split(x[order].T), split(g[order])
    pairs = [(al, bh), (ah, bl), (ah, bh)][3 - passes:]
    out = torch.zeros(x.shape[1], g.shape[1])
    for r0 in range(0, x.shape[0], slice_rows):
        acc = torch.zeros_like(out)
        total = torch.zeros_like(out)
        for k0 in range(r0, min(r0 + slice_rows, x.shape[0]), 8):
            if promote and k0 % 32 == 0:
                total = round_f32(total.double() + acc.double(), False)
                acc = torch.zeros_like(acc)
            for a, b in pairs:
                prod = a[:, k0:k0 + 8].double() @ b[k0:k0 + 8].double()
                acc = round_f32(acc.double() + prod, truncate)
        part = round_f32(total.double() + acc.double(), False) if promote \
            else acc
        out = round_f32(out.double() + part.double(), False)
    return out


def narrow_wgrad(x: torch.Tensor, g: torch.Tensor, slice_rows: int,
                 skip_slice: int | None = None) -> torch.Tensor:
    """``x [L, K]^T @ g [L, N]`` as the f32_narrow route sums it: one
    multiply-add chain a value in ascending row within each slice (each
    step rounded once to f32), slices added in order; ``skip_slice``
    leaves one slice out (a control)."""
    out = torch.zeros(x.shape[1], g.shape[1])
    for s, r0 in enumerate(range(0, x.shape[0], slice_rows)):
        acc = torch.zeros_like(out)
        for r in range(r0, min(r0 + slice_rows, x.shape[0])):
            prod = x[r].double()[:, None] * g[r].double()[None, :]
            acc = round_f32(acc.double() + prod, False)
        if s != skip_slice:
            out = round_f32(out.double() + acc.double(), False)
    return out


def wide_wgrad(gt: torch.Tensor, x: torch.Tensor, box: int | None, *,
               truncate: bool) -> torch.Tensor:
    """``gt [N, L] @ x [L, K]`` (the wide route's out^T = g^T x, bf16
    operands, exact products) as its wgmma sum it: each 16-row k-step's
    products added to an f32 accumulator, rounded to nearest or by
    truncation; with ``box`` a fresh accumulator every ``box`` rows, its
    sum added to an f32 total to nearest; ``box`` None: one accumulator
    for the whole slice."""
    acc = torch.zeros(gt.shape[0], x.shape[1])
    total = torch.zeros_like(acc)
    for r0 in range(0, gt.shape[1], 16):
        if box is not None and r0 and r0 % box == 0:
            total = round_f32(total.double() + acc.double(), False)
            acc = torch.zeros_like(acc)
        prod = gt[:, r0:r0 + 16].double() @ x[r0:r0 + 16].double()
        acc = round_f32(acc.double() + prod, truncate)
    if box is None:
        return acc
    return round_f32(total.double() + acc.double(), False)


def reading(got, a, b) -> tuple[float, float]:
    """(relative L2 in u sqrt(L), largest element in u sqrt(L)
    sqrt(a**2 @ b**2)) of ``got`` against the plain f32 ``a @ b``."""
    want = a @ b
    scale = U * a.shape[1] ** 0.5
    d = (got - want).double()
    elem = scale * (a.double() ** 2 @ b.double() ** 2).sqrt()
    return (float(d.norm() / want.double().norm()) / scale,
            float((d.abs() / elem).max()))


def rel_vs_f64(got, a, b) -> float:
    """Relative L2 of ``got`` against the f64 product, in u sqrt(L)."""
    exact = a.double() @ b.double()
    return float((got.double() - exact).norm() / exact.norm()) / (
        U * a.shape[1] ** 0.5)


def passes(r) -> bool:
    return r[0] <= REL_C and r[1] <= ELEM_C


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulations run thousands of small ops: one thread each,
    which keeps them quick beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _normal(seed: int, *shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# f32_tc at conv2's widths: 256 of the 800 output rows (two of the
# kernel's 128-row tiles), N = 64, 2,048 rows in two slices of 1,024
@pytest.fixture(scope="module")
def conv2():
    return _normal(0, 2048, 256), _normal(1, 2048, 64)


def test_f32_tc_boxes_promoted_to_nearest_pass(conv2):
    x, g = conv2
    got = tc_wgrad(x, g, 1024, truncate=True, promote=True)
    assert passes(reading(got, x.T, g)), reading(got, x.T, g)


def test_f32_tc_one_tf32_pass_fails(conv2):
    x, g = conv2
    got = tc_wgrad(x, g, 1024, truncate=True, promote=True, passes=1)
    assert not passes(reading(got, x.T, g)), reading(got, x.T, g)


def test_f32_tc_truncation_without_promotion_fails(conv2):
    x, g = conv2
    kept = reading(tc_wgrad(x, g, 1024, truncate=True, promote=True),
                   x.T, g)
    drift = reading(tc_wgrad(x, g, 1024, truncate=True, promote=False),
                    x.T, g)
    assert drift[0] > kept[0] and not passes(drift), (drift, kept)


def test_f32_tc_row_order_is_the_boxes_own():
    """The M-major permutation moves rows only inside their 8-row
    k-step, so each box sums the rows it holds."""
    order = perm_mmajor(64)
    assert sorted(order.tolist()) == list(range(64))
    assert bool((order // 8 == torch.arange(64) // 8).all())


# f32_narrow at the ResNet9 stem's widths (K = 27, N = 64), 1,536 rows
# in three slices of 512 (the plan's slice at 16 x 131,072 rows)
@pytest.fixture(scope="module")
def stem():
    return _normal(2, 1536, 27), _normal(3, 1536, 64)


def test_f32_narrow_chains_pass_and_the_controls_fail(stem):
    x, g = stem
    assert passes(reading(narrow_wgrad(x, g, 512), x.T, g))
    tf32 = tf32_rna(x).T @ tf32_rna(g)
    assert not passes(reading(tf32, x.T, g)), reading(tf32, x.T, g)
    dropped = narrow_wgrad(x, g, 512, skip_slice=0)
    assert not passes(reading(dropped, x.T, g))


# the wide route at the ring's conv2 slice: 4,128 rows (the plan's 16
# slices of 4,128 at 8 x 65,856), g's 64 columns, 128 of x's 800, bf16
@pytest.fixture(scope="module")
def wide():
    g = _normal(4, 4128, 64).bfloat16().float()
    x = _normal(5, 4128, 128).bfloat16().float()
    return g.T.contiguous(), x


def test_wide_one_truncating_accumulator_is_farther_from_f64(wide):
    gt, x = wide
    whole = rel_vs_f64(wide_wgrad(gt, x, None, truncate=True), gt, x)
    nearest = rel_vs_f64(wide_wgrad(gt, x, None, truncate=False), gt, x)
    assert whole > nearest, (whole, nearest)


def test_wide_fresh_box_is_no_farther_than_nearest(wide):
    gt, x = wide
    nearest = rel_vs_f64(wide_wgrad(gt, x, None, truncate=False), gt, x)
    boxed = rel_vs_f64(wide_wgrad(gt, x, WIDE_BOX_ROWS, truncate=True),
                       gt, x)
    assert boxed <= nearest, (boxed, nearest)
    # and it passes the f32 limits against the plain f32 product
    got = wide_wgrad(gt, x, WIDE_BOX_ROWS, truncate=True)
    assert passes(reading(got, gt, x)), reading(got, gt, x)


@pytest.mark.parametrize("box", [32, 128, 256])
def test_wide_box_of_64_is_the_closest(wide, box):
    """The kernel's box against the other whole-stage depths: none of
    them lands closer to f64 (the choice of kWBoxRows)."""
    gt, x = wide
    mine = rel_vs_f64(wide_wgrad(gt, x, WIDE_BOX_ROWS, truncate=True),
                      gt, x)
    other = rel_vs_f64(wide_wgrad(gt, x, box, truncate=True), gt, x)
    assert mine <= other, (mine, other)
