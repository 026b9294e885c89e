"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks, inside a fixture, whether a CUDA card
is present and skips without one (so on a CPU-only machine they skip
with a reason). On the card, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` where JAX, which the repo's conftest imports, is not
installed.)

Shapes are the FEMNIST CNN's widths at a reduced batch (ragged row
counts included), and K1 and K3 also at every shape their paths give
them, where two runs must give the same bits. Tolerances: bf16 outputs (K1, K3) one bf16 ulp of an
f32 sum, rtol 2**-7 and atol 1e-2; f32 sums (K2) rtol 1e-4 and atol
1e-2, and two runs bit-identical (no atomics); the SGD step (K4) and
the SGD step with the FedAvg accumulate and its null form (K5) the same
bits as their plain versions, and at gate 0 the params unchanged; over
lists of leaves (the FEMNIST CNN's, mnist-mlp's, ragged slot sizes, an
unaligned or non-contiguous operand, more leaves than one launch holds)
one launch a list of 48 leaves, the same bits as the per-leaf plain
versions, on two runs. The
fused MLP epoch (K6) is held to its plain version (``torch.bmm`` in
f32, TF32 off; the two sum in other orders) and gives the same bits on
two runs. From one state (one step, a short shard, narrow widths) every
element is within the JAX test's tolerance: params and trace rtol 2e-4,
atol 2e-5; loss rtol 1e-4, atol 1e-5. Over the headline's 19 steps a
ReLU whose pre-activation lies within the two versions' rounding
difference of zero can take the other gate in one of them, and that
unit's column trains on apart: there at most 1e-3 of a leaf's elements
may lie off the elementwise tolerance, none by more than 1e-2, each
leaf within relative L2 5e-3, and the loss within its tolerance. K6
with bf16 state gives the bits of the f32 kernel on the widened
inputs, rounded once, and is held to its plain version by the same
bounds plus one bf16 ulp (both round the f32 epoch's state once), over
the headline's 19 steps node by node: no node outside them (the kernel
sums in the plain version's orders).

The f32 instantiations of K1-K3 (K1 and K3 ``csrc/gemm_f32_tc.cu``, K2
``csrc/gemm_f32.cu``) are held to their plain versions
(``torch.matmul`` in f32, TF32 off) at relative L2 ``4 u sqrt(L)`` and
elementwise ``8 u sqrt(L) sqrt(A**2 @ B**2)`` (``u = 2**-24``, L the
contraction length), which the product on TF32-rounded inputs fails;
two runs give the same bits, and their launches count under their own
keys. The ``wgmma`` accumulation probe gives exact integer sums (its
TF32 fragment layout) and shows how the tensor core rounds its sums.
"""

from __future__ import annotations

import pytest
import torch

from p2pfl_tpu_torch.ops import fused_train, gemm

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)
F32_SUM_TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    return torch.device("cuda", 0)


def _rand(dev, seed, *shape, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("m,k,n", [(784 * 3, 25, 32), (129, 25, 32),
                                   (196 * 3 + 5, 800, 64), (40, 32, 25)])
def test_stream_gemm_matches_plain(dev, m, k, n):
    x, w = _rand(dev, 0, 3, m, k), _rand(dev, 1, 3, k, n)
    before = gemm.launches["stream_gemm"]
    got = gemm.stream_gemm(x, w)
    assert gemm.launches["stream_gemm"] == before + 1
    torch.testing.assert_close(got.float(),
                               gemm.stream_gemm_plain(x, w).float(),
                               **BF16_TOL)


# Every (K, N) the models give K1 (FEMNIST and MNIST CNN conv1 and conv2,
# the ResNet stem's K = 27 at 32 and 64 filters, conv1's dgrad
# (32, 25)), at row counts that are ragged against the kernels' 128-
# and 256-row tiles and not multiples of 8 (so a node's rows start off a
# 16-byte boundary and the copies' element-wise tails run), the
# evaluation's M = 512 * 784 and 512 * 196, and one shape neither
# Hopper branch takes (K = 48, N = 16: the guarded fallback).
@pytest.mark.parametrize("nodes,m,k,n", [
    (3, 2 * 784 + 13, 9, 32), (3, 2 * 784 + 13, 25, 32),
    (3, 2 * 784 + 13, 27, 32), (3, 2 * 784 + 13, 27, 64),
    (3, 3 * 196 + 7, 288, 64), (3, 3 * 196 + 7, 800, 64),
    (3, 2 * 784 + 13, 32, 25), (8, 512 * 784, 25, 32),
    (8, 512 * 196, 800, 64), (3, 3 * 196 + 7, 48, 16)])
def test_stream_gemm_widths_match_plain_bit_stable(dev, nodes, m, k, n):
    x, w = _rand(dev, 30, nodes, m, k), _rand(dev, 31, nodes, k, n)
    got = gemm.stream_gemm(x, w)
    assert got.shape == (nodes, m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               gemm.stream_gemm_plain(x, w).float(),
                               **BF16_TOL)
    assert torch.equal(got, gemm.stream_gemm(x, w))


# Two runs give the same bits, on every route: bf16 (conv1's widths on
# mma.sync, conv2's on wgmma) and f32 (conv1's on FFMA, conv2's on
# 3xTF32).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(784 * 3, 25, 32), (4096 * 2 + 7, 25, 32),
                                   (196 * 3 + 5, 800, 64)])
def test_stream_wgrad_matches_plain_and_is_deterministic(dev, m, k, n,
                                                         dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, g = _rand(dev, 2, 3, m, k, dtype=dtype), _rand(dev, 3, 3, m, n,
                                                      dtype=dtype)
    got = gemm.stream_wgrad(x, g)
    assert got.dtype == torch.float32
    assert torch.equal(got, gemm.stream_wgrad(x, g))
    torch.testing.assert_close(got, gemm.stream_wgrad_plain(x, g),
                               **F32_SUM_TOL)


def _wgrad_case(dev, seed, nodes, m, k, n, route=None, x_off=0, g_off=0):
    """K2 on one shape: one launch, f32 [nodes, k, n], within
    ``F32_SUM_TOL`` of the plain version, the same bits on a second run.
    ``x_off``, ``g_off``: the operand a view that many elements into a
    buffer; ``route``: the route the call must take."""
    x = _rand(dev, seed, nodes * m * k + x_off)[x_off:].view(nodes, m, k)
    g = _rand(dev, seed + 1, nodes * m * n + g_off)[g_off:].view(nodes, m, n)
    if route is not None:
        assert gemm.wgrad_call_plan(x, g).route == route
    before = gemm.launches["stream_wgrad"]
    got = gemm.stream_wgrad(x, g)
    assert gemm.launches["stream_wgrad"] == before + 1
    assert got.shape == (nodes, k, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, gemm.stream_wgrad_plain(x, g),
                               **F32_SUM_TOL)
    assert torch.equal(got, gemm.stream_wgrad(x, g))


def _one_row_past_a_slice(nodes, k, n, start, route=None):
    """The first M >= start whose plan on ``route`` (default: the
    shape's) has two or more slices, the last of them one row long."""
    m = start
    while True:
        plan = gemm.wgrad_plan(nodes, m, k, n, route)
        if plan.slices >= 2 and m % plan.rows == 1:
            return m
        m += 1


# K2's row counts on the shape's route (conv1's widths: the narrow
# route; conv2's: wide): one row, fewer rows than one slice or stage, and
# one row past a slice boundary of that route's plan.
@pytest.mark.parametrize("k,n", [(25, 32), (800, 64)])
@pytest.mark.parametrize("rows", ["one", "below_a_slice", "one_past_a_slice"])
def test_stream_wgrad_row_counts(dev, rows, k, n):
    m = {"one": 1, "below_a_slice": 200,
         "one_past_a_slice": _one_row_past_a_slice(2, k, n, 2000)}[rows]
    _wgrad_case(dev, 70, 2, m, k, n, gemm.wgrad_route(m, k, n))


# The same row counts on the general route at conv1's and the stem's
# widths, which it takes when g's base is off a 16-byte boundary (g a
# view one element into a buffer): its one-row last slice is cut by its
# own 256-row plan.
@pytest.mark.parametrize("k,n", [(25, 32), (27, 64)])
@pytest.mark.parametrize("rows", ["one", "below_a_slice", "one_past_a_slice"])
def test_stream_wgrad_general_row_counts(dev, rows, k, n):
    m = {"one": 1, "below_a_slice": 200,
         "one_past_a_slice": _one_row_past_a_slice(2, k, n, 2000,
                                                   "general")}[rows]
    _wgrad_case(dev, 71, 2, m, k, n, "general", g_off=1)


# Widths: conv1's and conv2's K, K whose rows are not 16-byte multiples
# (21, 300), and N = 32, 64 and 70 (70: the mma.sync route's ragged
# 32-column tiles).
@pytest.mark.parametrize("n", [32, 64, 70])
@pytest.mark.parametrize("k", [25, 800, 21, 300])
def test_stream_wgrad_widths(dev, k, n):
    _wgrad_case(dev, 72, 2, 3 * 784 + 5, k, n)


# The three paths' shapes at two nodes: the stacked ring (b = 336), the
# cross-device cohort step (20 samples a slot) and Byzantine DFL (b = 64).
@pytest.mark.parametrize("m,k,n", [
    (336 * 784, 25, 32), (336 * 196, 800, 64), (20 * 784, 25, 32),
    (20 * 196, 800, 64), (64 * 784, 25, 32), (64 * 196, 800, 64)])
def test_stream_wgrad_path_shapes(dev, m, k, n):
    _wgrad_case(dev, 74, 2, m, k, n)


# The ResNet9 stem (contraction 27, 64 filters; K = 27 is no multiple of
# 8, so the mma.sync route): at a ragged row count, and at the 16-node
# CIFAR10 step (128 images of 32 x 32 a node, the plan's 8 slices of
# 16,384 rows).
@pytest.mark.parametrize("nodes,m", [(3, 3 * 1024 + 77), (16, 128 * 1024)])
def test_stream_wgrad_resnet_stem(dev, nodes, m):
    _wgrad_case(dev, 76, nodes, m, 27, 64)


# The bf16 narrow route (K <= 32, N <= 64 a multiple of 8: a slice's
# whole output a work item, x's rows by 1-D bulk copy, g's by TMA,
# mma.sync): its row counts (one row; rows ragged against its 128-row
# stages; one row past a slice) at conv1's, the stem's and K = 32's
# widths (at odd K and odd M node 1's rows start off a 16-byte boundary),
# its widths (N = 32, 48, 64; K = 9, 25, 27, 32): one launch, within
# F32_SUM_TOL of the plain version, the same bits twice.
def _narrow_case(dev, seed, nodes, m, k, n, x_off=0):
    _wgrad_case(dev, seed, nodes, m, k, n, "narrow", x_off=x_off)


@pytest.mark.parametrize("k,n", [(25, 32), (27, 64), (32, 64)])
@pytest.mark.parametrize("rows", ["one", "ragged", "one_past_a_slice"])
def test_stream_wgrad_narrow_row_counts(dev, rows, k, n):
    m = {"one": 1, "ragged": 5 * 128 + 40,
         "one_past_a_slice": _one_row_past_a_slice(3, k, n, 2000,
                                                   "narrow")}[rows]
    _narrow_case(dev, 80, 3, m, k, n)


@pytest.mark.parametrize("n", [32, 48, 64])
@pytest.mark.parametrize("k", [9, 25, 27, 32])
def test_stream_wgrad_narrow_widths(dev, k, n):
    _narrow_case(dev, 82, 3, 3 * 784 + 8, k, n)


# The narrow route with node bases off a 16-byte boundary (M K odd) and
# with x's own base 2 bytes past one (a view one element into a buffer):
# each stage's x run lands at its address mod 16, its unaligned head and
# ragged tail copied by hand beside the bulk-copied middle, as in K1's
# narrow branch. Several stages, one partial stage, one row.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [5 * 128 + 3, 77, 1])
@pytest.mark.parametrize("k,n", [(27, 64), (25, 32), (9, 48)])
def test_stream_wgrad_narrow_unaligned_runs(dev, k, n, m, offset):
    _narrow_case(dev, 84, 3, m, k, n, x_off=offset)


# A node whose x or g is NaN on the narrow route: its sums are NaN, the
# other nodes' finite and equal to their plain sums (no stage reaches
# across nodes, and rows past a partial stage's valid ones add zero).
@pytest.mark.parametrize("operand", ["x", "g"])
@pytest.mark.parametrize("m,k,n", [(3 * 784 + 40, 25, 32),
                                   (3 * 1024 + 72, 27, 64)])
def test_stream_wgrad_narrow_nan_node_stays_in_its_node(dev, m, k, n,
                                                        operand):
    x, g = _rand(dev, 86, 3, m, k), _rand(dev, 87, 3, m, n)
    (x if operand == "x" else g)[1] = float("nan")
    assert gemm.wgrad_call_plan(x, g).route == "narrow"
    got = gemm.stream_wgrad(x, g)
    assert bool(got[1].isnan().all())
    keep = [0, 2]
    assert bool(got[keep].isfinite().all())
    torch.testing.assert_close(got[keep],
                               gemm.stream_wgrad_plain(x[keep], g[keep]),
                               **F32_SUM_TOL)


# Against the f64 product the narrow route is no farther than the plain
# version (torch.matmul in f32) in relative L2, at the ring's conv1 and
# the ResNet9 stem (two nodes).
@pytest.mark.parametrize("m,k,n", [(336 * 784, 25, 32), (128 * 1024, 27, 64)])
def test_stream_wgrad_narrow_no_farther_from_f64_than_plain(dev, m, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, g = _rand(dev, 88, 2, m, k), _rand(dev, 89, 2, m, n)
    assert gemm.wgrad_call_plan(x, g).route == "narrow"
    exact = torch.matmul(x.double().transpose(1, 2), g.double())

    def rel(t):
        return float((t.double() - exact).norm() / exact.norm())

    kernel, plain = rel(gemm.stream_wgrad(x, g)), rel(
        gemm.stream_wgrad_plain(x, g))
    assert kernel <= plain, (kernel, plain)


# K1's narrow branch with node bases off a 16-byte boundary (M K odd) and
# with x's own base 2 bytes past one (a view one element into a buffer):
# each run's unaligned head and ragged tail copied by hand beside its
# bulk-copied middle; N = 32 and 64 take the TMA-stored tiles, N = 48
# and 25 the staged copy-out. One tile, and one row.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [5 * 128 + 3, 77, 1])
@pytest.mark.parametrize("k,n", [(27, 64), (25, 64), (9, 64), (25, 32),
                                 (27, 48), (32, 25)])
def test_stream_gemm_narrow_unaligned_runs(dev, k, n, m, offset):
    nodes = 3
    buf = _rand(dev, 90, nodes * m * k + offset)
    x = buf[offset:].view(nodes, m, k)
    w = _rand(dev, 91, nodes, k, n)
    got = gemm.stream_gemm(x, w)
    assert got.shape == (nodes, m, n)
    torch.testing.assert_close(got.float(),
                               gemm.stream_gemm_plain(x, w).float(),
                               **BF16_TOL)
    assert torch.equal(got, gemm.stream_gemm(x, w))


# K1 at the stem's forward shape on the 16-node CIFAR10 step.
def test_stream_gemm_resnet_stem(dev):
    x, w = _rand(dev, 32, 16, 128 * 1024, 27), _rand(dev, 33, 16, 27, 64)
    before = gemm.launches["stream_gemm"]
    got = gemm.stream_gemm(x, w)
    assert gemm.launches["stream_gemm"] == before + 1
    torch.testing.assert_close(got.float(),
                               gemm.stream_gemm_plain(x, w).float(),
                               **BF16_TOL)
    assert torch.equal(got, gemm.stream_gemm(x, w))


# A node whose x or g is NaN: its own sums are NaN, the other nodes'
# stay finite and equal to their plain sums (no slice, tile, run or
# chunk reaches across nodes), in bf16 and in f32.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("operand", ["x", "g"])
@pytest.mark.parametrize("m,k,n", [(3 * 784 + 5, 25, 32),
                                   (3 * 196 + 7, 800, 64)])
def test_stream_wgrad_nan_node_stays_in_its_node(dev, m, k, n, operand,
                                                 dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rand(dev, 76, 3, m, k, dtype=dtype)
    g = _rand(dev, 77, 3, m, n, dtype=dtype)
    (x if operand == "x" else g)[1] = float("nan")
    got = gemm.stream_wgrad(x, g)
    assert bool(got[1].isnan().all())
    keep = [0, 2]
    assert bool(got[keep].isfinite().all())
    torch.testing.assert_close(got[keep],
                               gemm.stream_wgrad_plain(x[keep], g[keep]),
                               **F32_SUM_TOL)


# The wide route (TMA + wgmma) sums each 64-row box in a fresh
# accumulator and adds it to the total to nearest: against the f64
# product it is no farther than the plain version (torch.matmul in f32)
# in relative L2, at the three paths' conv2 shapes (two nodes).
@pytest.mark.parametrize("m", [336 * 196, 20 * 196, 64 * 196])
def test_stream_wgrad_wide_route_no_farther_from_f64_than_plain(dev, m):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, g = _rand(dev, 78, 2, m, 800), _rand(dev, 79, 2, m, 64)
    assert gemm.wgrad_plan(2, m, 800, 64).route == "wide"
    exact = torch.matmul(x.double().transpose(1, 2), g.double())

    def rel(t):
        return float((t.double() - exact).norm() / exact.norm())

    kernel, plain = rel(gemm.stream_wgrad(x, g)), rel(
        gemm.stream_wgrad_plain(x, g))
    assert kernel <= plain, (kernel, plain)


@pytest.mark.parametrize("b,d,h", [(48, 3136, 256), (21, 300, 70)])
def test_dense_bwd_matches_plain(dev, b, d, h):
    x, w, g = (_rand(dev, 4, 2, b, d), _rand(dev, 5, 2, d, h),
               _rand(dev, 6, 2, b, h))
    dx, dw = gemm.dense_bwd(x, w, g)
    pdx, pdw = gemm.dense_bwd_plain(x, w, g)
    torch.testing.assert_close(dx.float(), pdx.float(), **BF16_TOL)
    torch.testing.assert_close(dw.float(), pdw.float(), **BF16_TOL)


# K3 at the path's shapes: the ring step (8 x 336), the cross-device
# cohort step (8 slots x 20), the MNIST CNN's dense1 (H = 512) and the
# Byzantine step (16 nodes x 64); two runs give the same bits.
@pytest.mark.parametrize("nodes,b,d,h", [
    (8, 336, 3136, 2048), (8, 20, 3136, 2048), (2, 64, 3136, 512),
    (16, 64, 3136, 2048)])
def test_dense_bwd_path_shapes_match_plain_bit_stable(dev, nodes, b, d, h):
    x, w, g = (_rand(dev, 32, nodes, b, d), _rand(dev, 33, nodes, d, h),
               _rand(dev, 34, nodes, b, h))
    before = gemm.launches["dense_bwd"]
    dx, dw = gemm.dense_bwd(x, w, g)
    assert gemm.launches["dense_bwd"] == before + 1
    pdx, pdw = gemm.dense_bwd_plain(x, w, g)
    torch.testing.assert_close(dx.float(), pdx.float(), **BF16_TOL)
    torch.testing.assert_close(dw.float(), pdw.float(), **BF16_TOL)
    dx2, dw2 = gemm.dense_bwd(x, w, g)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("trace", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3136, 64), (62,), (5, 5, 32, 64)])
def test_sgd_accum_matches_plain_bits_and_gate_zero(dev, shape, trace):
    n = 4
    p = _rand(dev, 7, n, *shape, dtype=torch.float32)
    m = _rand(dev, 8, n, *shape, dtype=trace)
    g = _rand(dev, 9, n, *shape, dtype=torch.float32)
    lr = torch.tensor([0.05, 0.0, 0.1, 0.0], device=dev)
    kp, km = gemm.sgd_accum(p, m, g, lr, momentum=0.9)
    pp, pm = gemm.sgd_accum_plain(p, m, g, lr, momentum=0.9)
    assert torch.equal(kp, pp) and torch.equal(km, pm)
    off = lr == 0
    assert torch.equal(kp[off], p[off])
    assert not torch.equal(kp[~off], p[~off])


def test_autograd_functions_run_the_kernels(dev):
    x = _rand(dev, 10, 2, 300, 800).requires_grad_(True)
    w = _rand(dev, 11, 2, 800, 64).requires_grad_(True)
    gemm.reset_launches()
    y = gemm.conv2_matmul(x, w)
    gx, gw = torch.autograd.grad((y.float() ** 2).sum(), (x, w))
    assert gemm.launches["stream_gemm"] == 1
    assert gemm.launches["stream_wgrad"] == 1
    x2, w2 = x.detach().requires_grad_(), w.detach().requires_grad_()
    hx, hw = torch.autograd.grad(
        (gemm.stream_gemm_plain(x2, w2).float() ** 2).sum(), (x2, w2))
    for a, b in ((gx, hx), (gw, hw)):
        rel = (a.float() - b.float()).norm() / b.float().norm()
        assert rel < 2.0 ** -7


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3136, 2048), (62,), (5, 5, 32, 64)])
def test_fedavg_accum_matches_plain_bits(dev, shape, pdt):
    n = 8
    p = _rand(dev, 12, n, *shape, dtype=pdt)
    acc = _rand(dev, 13, n, *shape, dtype=torch.float32)
    w = torch.rand(n, device=dev) / n
    before = gemm.launches["fedavg_accum"]
    got = gemm.fedavg_accum(p, acc, w)
    assert gemm.launches["fedavg_accum"] == before + 1
    assert got.dtype == torch.float32 and got.shape == acc.shape
    assert torch.equal(got, gemm.fedavg_accum_plain(p, acc, w))


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trace", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3136, 64), (62,), (5, 5, 32, 64)])
def test_sgd_accum_acc_matches_plain_bits_and_gate_zero(dev, shape, trace,
                                                        pdt):
    n = 4
    p = _rand(dev, 14, n, *shape, dtype=pdt)
    m = _rand(dev, 15, n, *shape, dtype=trace)
    g = _rand(dev, 16, n, *shape, dtype=pdt)
    acc = _rand(dev, 17, n, *shape, dtype=torch.float32)
    lr = torch.tensor([0.05, 0.0, 0.1, 0.0], device=dev)
    w = torch.tensor([0.1, 0.2, 0.3, 0.4], device=dev)
    before = gemm.launches["sgd_accum_acc"]
    got = gemm.sgd_accum(p, m, g, lr, momentum=0.9, acc=acc, weight=w)
    assert gemm.launches["sgd_accum_acc"] == before + 1
    want = gemm.sgd_accum_plain(p, m, g, lr, momentum=0.9, acc=acc,
                                weight=w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    off = lr == 0
    assert torch.equal(got[0][off], p[off])


def test_k5_wrappers_raise_on_mixed_devices(dev):
    p = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.fedavg_accum(p, torch.zeros(2, 8), torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.sgd_accum(p, p, p, torch.ones(2, device=dev), momentum=0.9,
                       acc=p, weight=torch.ones(2))


# K4 and K5 over lists of leaves, one launch a list (48 leaves at most a
# launch): the FEMNIST CNN's and mnist-mlp's leaf sets, and leaves of 62,
# 10 and 1 values a slot, whose slot boundaries fall inside a 4-value
# vector. The same bits as the per-leaf plain versions, gate 0 (lr 0)
# leaves every leaf's params bit for bit, two runs give the same bits.
_LEAF_SETS = {
    "femnist_cnn": [(5, 5, 1, 32), (32,), (5, 5, 32, 64), (64,),
                    (3136, 2048), (2048,), (2048, 62), (62,)],
    "mnist_mlp": [(784, 256), (256,), (256, 128), (128,), (128, 10),
                  (10,)],
    "ragged": [(62,), (10,), (1,), (3, 7), (4097,)],
}
_SLOT_LR = [0.05, 0.0, 0.1, 0.0]
_SLOT_W = [0.1, 0.2, 0.3, 0.4]


def _leaves(dev, seed, shapes, dtype, n=4):
    return [_rand(dev, seed + i, n, *s, dtype=dtype)
            for i, s in enumerate(shapes)]


def _equal_lists(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trace", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaf_set", sorted(_LEAF_SETS))
def test_sgd_accum_many_one_launch_bits_gate_and_reruns(dev, leaf_set,
                                                        trace, pdt):
    shapes = _LEAF_SETS[leaf_set]
    ps, gs = _leaves(dev, 40, shapes, pdt), _leaves(dev, 60, shapes, pdt)
    ms = _leaves(dev, 80, shapes, trace)
    lr = torch.tensor(_SLOT_LR, device=dev)
    before = gemm.launches["sgd_accum"]
    before_bf16 = gemm.launches["sgd_accum_bf16"]
    got = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)
    assert gemm.launches["sgd_accum"] == before + 1
    assert gemm.launches["sgd_accum_bf16"] == before_bf16 + (
        pdt == torch.bfloat16)
    want = gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9)
    for g, w in zip(got, want):
        _equal_lists(g, w)
    off = lr == 0
    for p, kp in zip(ps, got[0]):
        assert torch.equal(kp[off], p[off])
    again = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)
    for g, w in zip(got, again):
        _equal_lists(g, w)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trace", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaf_set", sorted(_LEAF_SETS))
def test_sgd_accum_many_acc_one_launch_bits_gate_and_reruns(dev, leaf_set,
                                                            trace, pdt):
    shapes = _LEAF_SETS[leaf_set]
    ps, gs = _leaves(dev, 41, shapes, pdt), _leaves(dev, 61, shapes, pdt)
    ms = _leaves(dev, 81, shapes, trace)
    accs = _leaves(dev, 101, shapes, torch.float32)
    lr = torch.tensor(_SLOT_LR, device=dev)
    w = torch.tensor(_SLOT_W, device=dev)
    before = gemm.launches["sgd_accum_acc"]
    got = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9, accs=accs,
                              weight=w)
    assert gemm.launches["sgd_accum_acc"] == before + 1
    want = gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9,
                                     accs=accs, weight=w)
    for g, v in zip(got, want):
        _equal_lists(g, v)
    off = lr == 0
    for p, kp in zip(ps, got[0]):
        assert torch.equal(kp[off], p[off])
    again = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9, accs=accs,
                                weight=w)
    for g, v in zip(got, again):
        _equal_lists(g, v)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaf_set", sorted(_LEAF_SETS))
def test_fedavg_accum_many_one_launch_bits_and_reruns(dev, leaf_set, pdt):
    shapes = _LEAF_SETS[leaf_set]
    ps = _leaves(dev, 42, shapes, pdt)
    accs = _leaves(dev, 102, shapes, torch.float32)
    w = torch.tensor(_SLOT_W, device=dev)
    before = gemm.launches["fedavg_accum"]
    got = gemm.fedavg_accum_many(ps, accs, w)
    assert gemm.launches["fedavg_accum"] == before + 1
    _equal_lists(got, gemm.fedavg_accum_many_plain(ps, accs, w))
    _equal_lists(got, gemm.fedavg_accum_many(ps, accs, w))


def test_many_unaligned_leaf_takes_the_scalar_path(dev):
    # a view one value into its storage: its base is off the 16-byte
    # vector boundary, so that leaf takes the scalar path of the launch
    n, numel = 4, 4096 + 6
    base = _rand(dev, 43, n * numel + 1, dtype=torch.float32)
    p = base[1:].view(n, numel)
    assert p.data_ptr() % 16 != 0
    ps = [p, _rand(dev, 44, n, 62, dtype=torch.float32)]
    ms = [_rand(dev, 45, n, numel, dtype=torch.float32),
          _rand(dev, 46, n, 62, dtype=torch.float32)]
    gs = [_rand(dev, 47, n, numel, dtype=torch.float32),
          _rand(dev, 48, n, 62, dtype=torch.float32)]
    accs = [_rand(dev, 49, n, numel, dtype=torch.float32),
            _rand(dev, 50, n, 62, dtype=torch.float32)]
    lr = torch.tensor(_SLOT_LR, device=dev)
    w = torch.tensor(_SLOT_W, device=dev)
    for got, want in (
            (gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9),
             gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9)),
            (gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9, accs=accs,
                                 weight=w),
             gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9,
                                       accs=accs, weight=w)),
            ((gemm.fedavg_accum_many(ps, accs, w),),
             (gemm.fedavg_accum_many_plain(ps, accs, w),))):
        for g, v in zip(got, want):
            _equal_lists(g, v)
    # an unaligned accumulator, and a non-contiguous p (the binding
    # copies it)
    acc_u = _rand(dev, 51, n * numel + 2, dtype=torch.float32)[2:].view(
        n, numel)
    p_t = _rand(dev, 53, numel, n, dtype=torch.float32).t()
    got = gemm.fedavg_accum_many([ps[1], p_t], [accs[1], acc_u], w)
    _equal_lists(got, gemm.fedavg_accum_many_plain(
        [ps[1], p_t], [accs[1], acc_u], w))


def test_many_more_leaves_than_one_launch_holds(dev):
    k = 2 * 48 + 5  # three launches of 48, 48 and 5 leaves
    shapes = [((i * 37) % 300 + 1,) for i in range(k)]
    ps, gs = (_leaves(dev, 200, shapes, torch.float32),
              _leaves(dev, 400, shapes, torch.float32))
    ms = _leaves(dev, 600, shapes, torch.bfloat16)
    accs = _leaves(dev, 800, shapes, torch.float32)
    lr = torch.tensor(_SLOT_LR, device=dev)
    w = torch.tensor(_SLOT_W, device=dev)
    gemm.reset_launches()
    got = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)
    acc = gemm.fedavg_accum_many(ps, accs, w)
    assert gemm.launches["sgd_accum"] == 3
    assert gemm.launches["fedavg_accum"] == 3
    for g, v in zip(got, gemm.sgd_accum_many_plain(ps, ms, gs, lr,
                                                   momentum=0.9)):
        _equal_lists(g, v)
    _equal_lists(acc, gemm.fedavg_accum_many_plain(ps, accs, w))


def test_many_empty_lists_and_leaves_and_refusals(dev):
    lr = torch.tensor(_SLOT_LR, device=dev)
    w = torch.tensor(_SLOT_W, device=dev)
    gemm.reset_launches()
    assert gemm.sgd_accum_many([], [], [], lr, momentum=0.9) == ([], [])
    assert gemm.fedavg_accum_many([], [], w) == []
    empty = torch.zeros(4, 0, 3, device=dev)
    got = gemm.sgd_accum_many([empty], [empty], [empty], lr, momentum=0.9)
    assert got[0][0].shape == empty.shape and got[1][0].shape == empty.shape
    assert gemm.launches["sgd_accum"] == 0
    p = _rand(dev, 52, 4, 9, dtype=torch.float32)
    # one dtype combination a list
    with pytest.raises(ValueError, match="one dtype"):
        gemm.fedavg_accum_many([p, p.bfloat16()], [p, p], w)
    with pytest.raises(ValueError, match="slots first"):
        gemm.fedavg_accum_many([p[:3]], [p[:3]], w)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.sgd_accum_many([p], [p.cpu()], [p], lr, momentum=0.9)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        gemm.fedavg_accum_many([p], [p], w.cpu())


K6_STATE_TOL = dict(rtol=2e-4, atol=2e-5)
K6_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
K6_FLIP_FRACTION, K6_FLIP_ATOL, K6_FLIP_REL_L2 = 1e-3, 1e-2, 5e-3


def _mlp_epoch_inputs(dev, n, d_in, d1, d2, c, rows, seed=20):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(n, d_in, d1), (n, 1, d1), (n, d1, d2), (n, 1, d2),
              (n, d2, c), (n, 1, c)]
    params = tuple(torch.randn(s, generator=g, device=dev) * 0.05
                   for s in shapes)
    mom = tuple(torch.randn(s, generator=g, device=dev) * 0.01
                for s in shapes)
    bx = torch.randn((n, rows, d_in), generator=g, device=dev)
    by = torch.randint(0, c, (n, rows, 1), generator=g, device=dev,
                       dtype=torch.int32)
    return params, mom, bx, by


@pytest.mark.parametrize("n,d_in,d1,d2,c,rows,batch", [
    (64, 784, 256, 128, 10, 608, 32),  # the headline shape, 19 steps
    (64, 784, 256, 128, 10, 32, 32),  # its first step
    (3, 50, 20, 13, 7, 40, 8),  # ragged widths, empty column slices
    (2, 784, 256, 128, 10, 20, 32),  # a shard shorter than one batch
])
def test_fused_mlp_epoch_matches_plain_and_is_deterministic(
        dev, n, d_in, d1, d2, c, rows, batch):
    torch.backends.cuda.matmul.allow_tf32 = False
    params, mom, bx, by = _mlp_epoch_inputs(dev, n, d_in, d1, d2, c, rows)
    before_p = [t.clone() for t in params + mom]
    start = gemm.launches["fused_mlp_train_epoch"]
    kp, km, kl = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    assert gemm.launches["fused_mlp_train_epoch"] == start + 1
    assert all(torch.equal(a, b) for a, b in zip(params + mom, before_p))
    pp, pm, pl = fused_train.fused_mlp_train_epoch_plain(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    for a, b in zip(kp + km, pp + pm):
        assert a.shape == b.shape and a.dtype == torch.float32
        if rows <= batch or n < 64:  # from one state
            torch.testing.assert_close(a, b, **K6_STATE_TOL)
            continue
        d = (a - b).abs()
        off = d > K6_STATE_TOL["atol"] + K6_STATE_TOL["rtol"] * b.abs()
        assert int(off.sum()) <= K6_FLIP_FRACTION * a.numel()
        assert float(d.max()) <= K6_FLIP_ATOL
        assert float((a - b).norm() / b.norm()) <= K6_FLIP_REL_L2
    torch.testing.assert_close(kl, pl, **K6_LOSS_TOL)
    again = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by.long(), 0.05, 0.9, batch_size=batch)
    for a, b in zip(kp + km + (kl,), again[0] + again[1] + (again[2],)):
        assert torch.equal(a, b)


# K6 beyond the shapes above, each with the instantiation its widths
# take: node counts that are not a multiple of the clusters resident
# (1, 17), d1 and d2 that do not divide by the 8-block cluster (their
# column slices ragged, one of them empty; d1 = 90 also leaves w0's rows
# off 16-byte boundaries), and widths whose state does not fit on chip
# (d1 = 320: 40 columns a block; batch 64; d_in = 2000: a 256 KB slice
# of w0), which run the L2-resident kernel. One step from one state is
# held to the elementwise tolerance; more steps to the ReLU-flip bounds
# of the headline above.
@pytest.mark.parametrize("n,d_in,d1,d2,c,rows,batch,inst", [
    (1, 784, 256, 128, 10, 96, 32, "on_chip"),
    (17, 784, 256, 128, 10, 96, 32, "on_chip"),
    (17, 784, 256, 128, 10, 32, 32, "on_chip"),
    (4, 784, 100, 50, 10, 64, 32, "on_chip"),
    (4, 300, 90, 37, 7, 48, 16, "on_chip"),
    (2, 784, 320, 64, 10, 64, 32, "l2"),
    (2, 64, 32, 16, 10, 128, 64, "l2"),
    (2, 2000, 64, 32, 10, 32, 32, "l2"),
])
def test_fused_mlp_epoch_instantiations(dev, n, d_in, d1, d2, c, rows, batch,
                                        inst):
    torch.backends.cuda.matmul.allow_tf32 = False
    from p2pfl_tpu_torch.ops import _build

    assert _build.kernels().fused_mlp_epoch_plan(batch, d_in, d1, d2,
                                                 c)[0] == inst
    params, mom, bx, by = _mlp_epoch_inputs(dev, n, d_in, d1, d2, c, rows,
                                            seed=21)
    start = gemm.launches["fused_mlp_train_epoch"]
    kp, km, kl = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    assert gemm.launches["fused_mlp_train_epoch"] == start + 1
    pp, pm, pl = fused_train.fused_mlp_train_epoch_plain(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    for a, b in zip(kp + km, pp + pm):
        assert a.shape == b.shape and a.dtype == torch.float32
        if rows <= batch:
            torch.testing.assert_close(a, b, **K6_STATE_TOL)
            continue
        d = (a - b).abs()
        off = d > K6_STATE_TOL["atol"] + K6_STATE_TOL["rtol"] * b.abs()
        assert int(off.sum()) <= K6_FLIP_FRACTION * a.numel()
        assert float(d.max()) <= K6_FLIP_ATOL
        assert float((a - b).norm() / b.norm()) <= K6_FLIP_REL_L2
    torch.testing.assert_close(kl, pl, **K6_LOSS_TOL)
    again = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    for a, b in zip(kp + km + (kl,), again[0] + again[1] + (again[2],)):
        assert torch.equal(a, b)


# K6's sum orders at other shapes than the probe's (batch 32, 10
# classes): one step from a zero trace at 64 nodes, every param and
# trace against the plain version's bits. The plain version takes its
# forward products as ascending chains (``fused_train.chain_matmul``)
# and sums its bias gradients and softmax denominator in the orders the
# kernel states (``fused_train.batch_sum``, ``class_sum``), so at batch
# 8, 16 and 64 (the L2-resident kernel) with 7 classes and at 62 classes
# they agree: no leaf may differ (a leaf listed here would be held to
# the one-state tolerance instead). The loss is held to K6_LOSS_TOL
# (its sum is not the plain version's at any shape).
_P = ("params w0", "params b0", "params w1", "params b1", "params w2",
      "params b2")
_M = tuple("trace" + k[6:] for k in _P)
K6_ORDER_FAULTS = {
    (8, 7): (),
    (16, 7): (),
    (32, 10): (),
    (64, 7): (),
    (32, 62): (),
}


@pytest.mark.parametrize("batch,c", sorted(K6_ORDER_FAULTS))
def test_fused_mlp_epoch_sum_orders_bits(dev, batch, c):
    torch.backends.cuda.matmul.allow_tf32 = False
    params, _, bx, by = _mlp_epoch_inputs(dev, 64, 784, 256, 128, c, batch,
                                          seed=23)
    mom = tuple(torch.zeros_like(t) for t in params)
    kp, km, kl = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    pp, pm, pl = fused_train.fused_mlp_train_epoch_plain(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    off = []
    for name, a, b in zip(_P + _M, kp + km, pp + pm):
        if not torch.equal(a, b):
            off.append(name)
            torch.testing.assert_close(a, b, **K6_STATE_TOL)
    assert set(off) <= set(K6_ORDER_FAULTS[batch, c]), off
    torch.testing.assert_close(kl, pl, **K6_LOSS_TOL)


def test_fused_mlp_epoch_refusals(dev):
    params, mom, bx, by = _mlp_epoch_inputs(dev, 2, 16, 8, 8, 4, 24)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        fused_train.fused_mlp_train_epoch(params, mom, bx, by, 0.05,
                                          batch_size=16)
    # bf16 params beside an f32 trace run (each tensor keeps its dtype)
    half = tuple(t.to(torch.bfloat16) for t in params)
    start = gemm.launches["fused_mlp_train_epoch_bf16"]
    kp, km, _ = fused_train.fused_mlp_train_epoch(half, mom, bx, by, 0.05,
                                                  batch_size=8)
    assert gemm.launches["fused_mlp_train_epoch_bf16"] == start + 1
    assert all(t.dtype == torch.bfloat16 for t in kp)
    assert all(t.dtype == torch.float32 for t in km)
    # float16 is the rest of A19
    with pytest.raises(ValueError, match="A19"):
        fused_train.fused_mlp_train_epoch(
            tuple(t.to(torch.float16) for t in params), mom, bx, by, 0.05,
            batch_size=8)
    with pytest.raises(ValueError, match="int32 or int64"):
        fused_train.fused_mlp_train_epoch(params, mom, bx, by.float(), 0.05,
                                          batch_size=8)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        fused_train.fused_mlp_train_epoch(params, mom, bx.cpu(), by, 0.05,
                                          batch_size=8)


# The private and elastic federation on the card: K4 at the stacked
# round's shape with whole nodes gated off (dead rows, whose gradients
# the learner zeroes with ``where`` even where they are not finite), the
# same bits as its plain version and the dead rows' params unchanged;
# and DP's ``privatize_stacked`` on CUDA tensors (stock PyTorch, no
# kernel of its own): two calls give the same bits, at noise 0 every
# masked row's delta norm is at most clip * (1 + 1e-6), unmasked rows
# keep their bits.
_DEAD = [0, 3, 7]


def test_sgd_accum_many_turns_off_whole_nodes(dev):
    shapes = _LEAF_SETS["femnist_cnn"]
    n = 8
    ps = _leaves(dev, 140, shapes, torch.float32, n)
    gs = _leaves(dev, 160, shapes, torch.float32, n)
    ms = _leaves(dev, 180, shapes, torch.float32, n)
    gate = torch.ones(n, device=dev)
    gate[_DEAD] = 0.0
    on = gate > 0
    for g in gs:
        g[_DEAD] = float("nan")
    gs = [torch.where(on.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                      torch.zeros_like(g)) for g in gs]
    lr = torch.full((n,), 0.05, device=dev) * gate
    before = gemm.launches["sgd_accum"]
    got = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)
    assert gemm.launches["sgd_accum"] == before + 1
    want = gemm.sgd_accum_many_plain(ps, ms, gs, lr, momentum=0.9)
    for g, w in zip(got, want):
        _equal_lists(g, w)
    for p, kp, km in zip(ps, got[0], got[1]):
        assert torch.equal(kp[~on], p[~on])
        assert bool(torch.isfinite(kp).all() and torch.isfinite(km).all())


def _stacked_tree(dev, seed, n):
    from p2pfl_tpu_torch.models.base import get_model

    model = get_model("femnist-cnn", hidden=256)
    one = model.init(torch.Generator().manual_seed(seed),
                     torch.zeros(1, 28, 28, 1))
    return {"params": {
        k: {m: t.to(dev).unsqueeze(0).repeat((n,) + (1,) * t.dim())
            for m, t in v.items()}
        for k, v in one["params"].items()}}


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_privatize_stacked_on_the_card(dev, sigma):
    import numpy as np

    from p2pfl_tpu_torch.privacy import dp

    n = 8
    ref = _stacked_tree(dev, 0, n)
    g = torch.Generator(device=dev).manual_seed(5)
    upd = {"params": {k: {m: t + 0.05 * torch.randn(
        t.shape, generator=g, device=dev) for m, t in v.items()}
        for k, v in ref["params"].items()}}
    mask = np.ones(n, bool)
    mask[_DEAD] = False
    spec = dp.DPSpec(clip_norm=1.0, noise_multiplier=sigma, seed=3)
    a = dp.privatize_stacked(upd, ref, mask, 2, spec)
    b = dp.privatize_stacked(upd, ref, mask, 2, spec)
    for k, v in a["params"].items():
        for m, t in v.items():
            assert t.device == upd["params"][k][m].device
            assert torch.equal(t, b["params"][k][m])
            assert torch.equal(t[_DEAD], upd["params"][k][m][_DEAD])
    for i in np.flatnonzero(mask):
        row = {"params": {k: {m: t[i] for m, t in v.items()}
                          for k, v in a["params"].items()}}
        rref = {"params": {k: {m: t[i] for m, t in v.items()}
                           for k, v in ref["params"].items()}}
        norm = float(dp.update_norm(row, rref))
        if sigma == 0.0:
            assert norm <= spec.clip_norm * (1 + 1e-6)
        else:
            assert norm > spec.clip_norm  # the noise dominates


# The f32 instantiations of K1-K3 at the f32 arm's shapes (the 8-node
# FEMNIST-CNN ring, reduced to 3 nodes and 12 images a node; conv1's
# dgrad (32, 25); ragged rows) and K2's slice plan with several slices.
# Held as in chip_smoke.py: two f32 sums of the same L products in other
# orders differ by about u sqrt(L) relative (u = 2**-24), so relative L2
# <= 4 u sqrt(L) and every element <= 8 u sqrt(L) sqrt(A**2 @ B**2). The
# product in TF32 fails these limits at every shape here.
F32_U = 2.0 ** -24
F32_REL_C, F32_ELEM_C = 4.0, 8.0


def _tf32_round(t):
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _f32_units(got, want, a, b):
    scale = F32_U * a.shape[-1] ** 0.5
    d = got - want
    elem = scale * torch.matmul(a * a, b * b).sqrt()
    rel = float(d.norm() / want.norm().clamp(min=1e-30)) / scale
    return rel, float((d.abs() / elem.clamp(min=1e-30)).max())


def _assert_f32_close(got, a, b):
    """``got`` against ``a @ b`` (TF32 off) under the f32 limits, and the
    product on TF32-rounded inputs outside them."""
    want = torch.matmul(a, b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel, elem = _f32_units(got, want, a, b)
    assert rel <= F32_REL_C and elem <= F32_ELEM_C, (rel, elem)
    rel, elem = _f32_units(torch.matmul(_tf32_round(a), _tf32_round(b)),
                           want, a, b)
    assert rel > F32_REL_C or elem > F32_ELEM_C, (rel, elem)


def _f32_keys_only(before, used):
    for key in ("stream_gemm", "stream_wgrad", "dense_bwd"):
        want = before[key + "_f32"] + (1 if key in used else 0)
        assert gemm.launches[key + "_f32"] == want, key
        assert gemm.launches[key] == before[key], key


@pytest.mark.parametrize("nodes,m,k,n", [
    (3, 12 * 784, 25, 32), (3, 12 * 196, 800, 64), (3, 12 * 784, 32, 25),
    (3, 2 * 784 + 13, 9, 32), (2, 129, 48, 16),
    # the ring's full shapes (conv1 and conv2 forward at 8 x 336), and
    # rows that TMA cannot read (K = 45) with a ragged N
    (8, 336 * 784, 25, 32), (8, 336 * 196, 800, 64), (2, 300, 45, 70),
    # the ResNet9 stem: ragged rows, and the 16-node CIFAR10 step
    (3, 3 * 1024 + 77, 27, 64), (16, 128 * 1024, 27, 64)])
def test_stream_gemm_f32_matches_plain_bit_stable(dev, nodes, m, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rand(dev, 90, nodes, m, k, dtype=torch.float32)
    w = _rand(dev, 91, nodes, k, n, dtype=torch.float32) * 0.1
    before = dict(gemm.launches)
    got = gemm.stream_gemm(x, w)
    _f32_keys_only(before, {"stream_gemm"})
    torch.testing.assert_close(gemm.stream_gemm_plain(x, w), x @ w,
                               rtol=0, atol=0)
    _assert_f32_close(got, x, w)
    assert torch.equal(got, gemm.stream_gemm(x, w))


@pytest.mark.parametrize("nodes,m,k,n", [
    (3, 12 * 784, 25, 32), (3, 12 * 196, 800, 64), (3, 4096 * 3 + 7, 25, 32),
    (2, 1, 800, 64), (3, 2357, 21, 70),
    # the ResNet9 stem: ragged rows, and the 16-node CIFAR10 step
    (3, 3 * 1024 + 77, 27, 64), (16, 128 * 1024, 27, 64),
    # 3xTF32 on rows TMA cannot read (K = 45, N = 70: element-wise loads)
    (2, 300, 45, 70)])
def test_stream_wgrad_f32_matches_plain_bit_stable(dev, nodes, m, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rand(dev, 92, nodes, m, k, dtype=torch.float32)
    g = _rand(dev, 93, nodes, m, n, dtype=torch.float32)
    before = dict(gemm.launches)
    got = gemm.stream_wgrad(x, g)
    _f32_keys_only(before, {"stream_wgrad"})
    xt = x.transpose(1, 2)
    torch.testing.assert_close(gemm.stream_wgrad_plain(x, g), xt @ g,
                               rtol=0, atol=0)
    _assert_f32_close(got, xt, g)
    assert torch.equal(got, gemm.stream_wgrad(x, g))


@pytest.mark.parametrize("nodes,b,d,h", [(3, 48, 3136, 2048),
                                         (2, 21, 300, 70),
                                         (8, 336, 3136, 2048)])
def test_dense_bwd_f32_matches_plain_bit_stable(dev, nodes, b, d, h):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rand(dev, 94, nodes, b, d, dtype=torch.float32)
    w = _rand(dev, 95, nodes, d, h, dtype=torch.float32) * 0.02
    g = _rand(dev, 96, nodes, b, h, dtype=torch.float32)
    before = dict(gemm.launches)
    dx, dw = gemm.dense_bwd(x, w, g)
    _f32_keys_only(before, {"dense_bwd"})
    pdx, pdw = gemm.dense_bwd_plain(x, w, g)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    torch.testing.assert_close(pdx, g @ wt, rtol=0, atol=0)
    torch.testing.assert_close(pdw, xt @ g, rtol=0, atol=0)
    _assert_f32_close(dx, g, wt)
    _assert_f32_close(dw, xt, g)
    dx2, dw2 = gemm.dense_bwd(x, w, g)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def test_wgmma_acc_probe(dev):
    """The accumulation probe of gemm_f32_tc.cu: small-integer sums come
    out exact from wgmma and from the fmaf chains (the TF32 fragment
    layout), the chains round 1 + 0.75 ulp(1) to nearest, and the tensor
    core truncates it (why each 32-deep box's sum is added outside it)."""
    from p2pfl_tpu_torch.ops import _build

    probe = _build.kernels().wgmma_acc_probe
    gen = torch.Generator(device=dev).manual_seed(7)
    a = torch.randint(-3, 4, (64, 256), generator=gen, device=dev).float()
    bt = torch.randint(-3, 4, (64, 256), generator=gen, device=dev).float()
    tc, chain = probe(a, bt)
    exact = (a.double() @ bt.double().T).float()
    assert torch.equal(tc, exact) and torch.equal(chain, exact)
    a = torch.zeros(64, 32, device=dev)
    a[:, 0], a[:, 8] = 1.0, 1.5 * 2.0 ** -24
    tc, chain = probe(a, torch.ones(64, 32, device=dev))
    assert bool((chain == 1.0 + 2.0 ** -23).all())
    assert bool((tc == 1.0).all())


def test_f32_autograd_functions_run_only_the_f32_kernels(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _rand(dev, 97, 2, 300, 800, dtype=torch.float32).requires_grad_(True)
    w = _rand(dev, 98, 2, 800, 64, dtype=torch.float32).requires_grad_(True)
    gemm.reset_launches()
    y = gemm.conv2_matmul(x, w)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (x, w))
    v = _rand(dev, 99, 2, 64, 32, dtype=torch.float32).requires_grad_(True)
    h = gemm.dense_matmul(y.detach(), v)
    torch.autograd.grad(h.sum(), (v,))
    assert gemm.launches["stream_gemm_f32"] == 1
    assert gemm.launches["stream_wgrad_f32"] == 1
    assert gemm.launches["dense_bwd_f32"] == 1
    assert gemm.launches["stream_gemm"] == gemm.launches["stream_wgrad"] == 0
    assert gemm.launches["dense_bwd"] == 0
    assert gx.dtype == gw.dtype == torch.float32


def _bf16_ulp(t):
    """One bf16 ulp at each value of ``t`` (f32)."""
    e = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _k6_nodes_off(got, want):
    """The nodes whose state leaves the flip bounds (on the node's slice
    of each leaf, bf16 one ulp more) or whose loss leaves its
    tolerance."""
    (kp, km, kl), (pp, pm, pl) = got, want
    n = kl.shape[0]
    out = (kl - pl).abs() > K6_LOSS_TOL["atol"] + K6_LOSS_TOL["rtol"] * pl.abs()
    for a, b in zip(kp + km, pp + pm):
        a, b = a.float().reshape(n, -1), b.float().reshape(n, -1)
        d = ((a - b).abs()
             - _bf16_ulp(torch.maximum(a.abs(), b.abs()))).clamp(min=0.0)
        tol = K6_STATE_TOL["atol"] + K6_STATE_TOL["rtol"] * b.abs()
        rel = (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)
        out |= (((d > tol).sum(1) > K6_FLIP_FRACTION * a.shape[1])
                | (d.amax(1) > K6_FLIP_ATOL) | (rel > K6_FLIP_REL_L2))
    return out.nonzero().flatten().tolist()


@pytest.mark.parametrize("n,rows", [(64, 608), (64, 32), (3, 40)])
def test_fused_mlp_epoch_bf16_state_matches_plain(dev, n, rows):
    """K6 with bf16 params, trace and inputs: the headline shape (19
    steps), its first step, and a ragged node count (5 steps). Always
    the bits of the f32 kernel on the widened inputs, rounded once (the
    variant's own code), and against the plain version: from one state
    within the elementwise tolerance plus one bf16 ulp; over the ragged
    case's 5 steps within the flip bounds plus one ulp; over the
    headline's 19 steps node by node, no node outside the flip bounds
    plus one ulp (a gate taken the other way would move its node's whole
    state apart) and every value finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    d_in, d1, d2, c, batch = 784, 256, 128, 10, 32
    if n == 3:
        d_in, d1, d2, c, batch = 50, 20, 13, 7, 8
    params, mom, bx, by = _mlp_epoch_inputs(dev, n, d_in, d1, d2, c, rows)
    bf = lambda ts: tuple(t.to(torch.bfloat16) for t in ts)  # noqa: E731
    params, mom, bx = bf(params), bf(mom), bx.to(torch.bfloat16)
    start = dict(gemm.launches)
    kp, km, kl = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    assert gemm.launches["fused_mlp_train_epoch_bf16"] == (
        start["fused_mlp_train_epoch_bf16"] + 1)
    assert gemm.launches["fused_mlp_train_epoch"] == (
        start["fused_mlp_train_epoch"])
    f = lambda ts: tuple(t.float() for t in ts)  # noqa: E731
    wp, wm, wl = fused_train.fused_mlp_train_epoch(
        f(params), f(mom), bx.float(), by, 0.05, 0.9, batch_size=batch)
    for a, b in zip(kp + km, wp + wm):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
    assert torch.equal(kl, wl)
    pp, pm, pl = fused_train.fused_mlp_train_epoch_plain(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    if rows == 608:
        assert all(bool(torch.isfinite(t).all()) for t in kp + km + (kl,))
        assert _k6_nodes_off((kp, km, kl), (pp, pm, pl)) == []
    else:
        for a, b in zip(kp + km, pp + pm):
            assert b.dtype == torch.bfloat16
            a, b = a.float(), b.float()
            d = (a - b).abs() - _bf16_ulp(torch.maximum(a.abs(), b.abs()))
            tol = K6_STATE_TOL["atol"] + K6_STATE_TOL["rtol"] * b.abs()
            if rows <= batch:  # from one state
                assert bool((d <= tol).all()), float((d - tol).max())
                continue
            assert int((d > tol).sum()) <= K6_FLIP_FRACTION * a.numel()
            assert float(d.max()) <= K6_FLIP_ATOL
            assert float((a - b).norm() / b.norm()) <= K6_FLIP_REL_L2
        torch.testing.assert_close(kl, pl, **K6_LOSS_TOL)
    again = fused_train.fused_mlp_train_epoch(
        params, mom, bx, by, 0.05, 0.9, batch_size=batch)
    for a, b in zip(kp + km + (kl,), again[0] + again[1] + (again[2],)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
def test_sgd_accum_many_on_the_ocsvm_leaves(dev, pdt):
    """K4 on the one-class SVM's leaves: ``w [n, 17]`` and ``rho [n]``,
    one value a node; the same bits as the plain version, gate 0 keeps a
    node's params."""
    n = 8
    ps = [_rand(dev, 100, n, 17, dtype=pdt), _rand(dev, 101, n, dtype=pdt)]
    ms = [_rand(dev, 102, n, 17, dtype=pdt), _rand(dev, 103, n, dtype=pdt)]
    gs = [_rand(dev, 104, n, 17, dtype=pdt), _rand(dev, 105, n, dtype=pdt)]
    lr = torch.full((n,), 0.05, device=dev)
    lr[[2, 5]] = 0.0
    before = gemm.launches["sgd_accum"]
    got = gemm.sgd_accum_many(ps, ms, gs, lr, momentum=0.9)
    assert gemm.launches["sgd_accum"] == before + 1
    for g, w in zip(got, gemm.sgd_accum_many_plain(ps, ms, gs, lr,
                                                   momentum=0.9)):
        _equal_lists(g, w)
    for p, kp in zip(ps, got[0]):
        assert torch.equal(kp[[2, 5]], p[[2, 5]])


# Checkpoint and resume on the card: a 4-node FEMNIST-CNN ring (hidden
# 64, bf16 wire) through K1-K4, 4 rounds saving every 2, against a fresh
# Scenario resumed from round 2's file for 2 rounds: params, trace,
# step, alive, round, the evaluation and round 4's file the same bits.
def test_scenario_resume_is_bit_exact(dev, tmp_path):
    import dataclasses
    import shutil

    from p2pfl_tpu_torch.config.schema import (
        DataConfig,
        ModelConfig,
        ScenarioConfig,
        TrainingConfig,
    )
    from p2pfl_tpu_torch.core.pytree import tree_leaves
    from p2pfl_tpu_torch.federation import Scenario
    from p2pfl_tpu_torch.federation.checkpoint import checkpoint_path

    cfg = ScenarioConfig(
        name="resume", federation="DFL", topology="ring", n_nodes=4,
        data=DataConfig(dataset="femnist", samples_per_node=120,
                        batch_size=32, synthetic_train=2000,
                        synthetic_test=128),
        model=ModelConfig(model="femnist-cnn", kwargs={"hidden": 64}),
        training=TrainingConfig(rounds=4, epochs_per_round=1,
                                learning_rate=0.05),
        transport="dense", wire_dtype="bf16",
        checkpoint_dir=str(tmp_path / "a"), checkpoint_every=2)
    whole = Scenario(cfg, device=dev)
    res = whole.run()
    (tmp_path / "b").mkdir()
    shutil.copy(checkpoint_path(tmp_path / "a", 2), tmp_path / "b")
    resumed = Scenario(dataclasses.replace(
        cfg, checkpoint_dir=str(tmp_path / "b")), device=dev)
    assert resumed.fed.round == 2
    res2 = resumed.run(rounds=2)
    for a, b in zip(tree_leaves(whole.fed.states.params)
                    + tree_leaves(whole.fed.states.opt_state)
                    + [whole.fed.states.step, whole.fed.alive],
                    tree_leaves(resumed.fed.states.params)
                    + tree_leaves(resumed.fed.states.opt_state)
                    + [resumed.fed.states.step, resumed.fed.alive]):
        assert torch.equal(a, b)
    assert whole.fed.round == resumed.fed.round == 4
    assert res.per_node_accuracy == res2.per_node_accuracy
    assert (checkpoint_path(tmp_path / "a", 4).read_bytes()
            == checkpoint_path(tmp_path / "b", 4).read_bytes())
