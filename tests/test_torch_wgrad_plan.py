"""K2's slice plan (``ops/gemm.py::wgrad_plan``), on the CPU.

The plan fixes which rows each block sums and in which order the sums
are added, so it decides the kernel's bits: it must follow from the
shape alone, cover every row of a node exactly once in whole stages of
its route, and give every path's shape enough blocks to fill a card.
"""

from __future__ import annotations

import pytest
import torch

from p2pfl_tpu_torch.ops import gemm

# conv1 and conv2 at the stacked ring (b = 336), the cross-device cohort
# step (20 samples a slot) and Byzantine DFL (16 nodes x 64); the ResNet9
# stem (contraction 27, 64 filters) at the 16-node CIFAR10 step (b = 128)
PATH_SHAPES = [(8, 336 * 784, 25, 32), (8, 336 * 196, 800, 64),
               (8, 20 * 784, 25, 32), (8, 20 * 196, 800, 64),
               (16, 64 * 784, 25, 32), (16, 64 * 196, 800, 64),
               (16, 128 * 1024, 27, 64)]
EDGE_SHAPES = [(2, 1, 25, 32), (2, 1, 800, 64), (2, 200, 800, 64),
               (3, 2357, 21, 70), (3, 2357, 300, 32), (2, 3073, 25, 32),
               (2, 28769, 800, 64), (1, 0, 800, 64), (64, 5, 8, 8)]


def _bf16_route(k, c):
    """The bf16 route by shape: narrow at K <= 32 and N <= 64 a multiple
    of 8, else wide at K and N multiples of 8, else general."""
    if k <= 32 and c <= 64 and c % 8 == 0:
        return "narrow"
    return "wide" if k % 8 == 0 and c % 8 == 0 else "general"


@pytest.mark.parametrize("n,m,k,c", PATH_SHAPES + EDGE_SHAPES)
def test_plan_covers_every_row_once(n, m, k, c):
    plan = gemm.wgrad_plan(n, m, k, c)
    assert plan.route == _bf16_route(k, c)
    assert plan.rows % gemm.WGRAD_ROUTE_ROWS[plan.route] == 0
    assert gemm.WGRAD_ROUTE_ROWS[plan.route] == {
        "wide": 64, "general": 256, "narrow": 128}[plan.route]
    # every row in exactly one slice, and no slice empty
    assert plan.rows * plan.slices >= max(m, 1)
    assert plan.rows * (plan.slices - 1) < max(m, 1)


@pytest.mark.parametrize("n,m,k,c", PATH_SHAPES)
def test_plan_fills_the_card_at_path_shapes(n, m, k, c):
    plan = gemm.wgrad_plan(n, m, k, c)
    # at least one block per SM of a 132-SM card, and no more slices
    # than WGRAD_MIN_SLICE_ROWS allows (each adds K * N f32 sums a node)
    assert n * plan.slices * plan.tiles >= 128
    assert plan.slices <= -(-m // gemm.WGRAD_MIN_SLICE_ROWS)
    assert plan.rows >= min(m, gemm.WGRAD_MIN_SLICE_ROWS) - 256


def test_plan_is_a_function_of_the_shape():
    gemm.wgrad_plan.cache_clear()
    first = [gemm.wgrad_plan(*s) for s in PATH_SHAPES]
    gemm.wgrad_plan.cache_clear()
    assert [gemm.wgrad_plan(*s) for s in PATH_SHAPES] == first


def test_plan_routes_can_be_forced_and_unknown_ones_raise():
    assert gemm.wgrad_plan(2, 300, 800, 64, "general").route == "general"
    with pytest.raises(ValueError, match="unknown K2 route"):
        gemm.wgrad_plan(2, 300, 800, 64, "tiles")


def test_resnet9_stem_plan():
    """The ResNet9 stem's weight gradient at 16 nodes x 128 CIFAR10
    images: K = 27 <= 32 and N = 64, so the narrow route; the whole 27 x
    64 output a work item, 8 slices of 16,384 rows make its 128 items. In
    float32, K <= 32: the FFMA route, one 64-column tile, 256 slices of
    512 rows (4,096 items)."""
    plan = gemm.wgrad_plan(16, 128 * 32 * 32, 27, 64)
    assert plan == gemm.WgradPlan("narrow", 1, 16384, 8)
    f32 = gemm.wgrad_plan(16, 128 * 32 * 32, 27, 64,
                          gemm.wgrad_route(128 * 32 * 32, 27, 64, f32=True))
    assert f32 == gemm.WgradPlan("f32_narrow", 1, 512, 256)


# The float32 routes: 3xTF32 on wgmma at K >= 33 (128 x 64 tiles, 32-row
# boxes), exact FFMA over 64-row chunks (32 x 64 tiles) at K <= 32 and at
# contractions of one box or less
@pytest.mark.parametrize("n,m,k,c", PATH_SHAPES + EDGE_SHAPES)
def test_f32_plan_covers_every_row_once(n, m, k, c):
    route = gemm.wgrad_route(m, k, c, f32=True)
    assert route == ("f32_tc" if k > 32 and m > 32 else "f32_narrow")
    plan = gemm.wgrad_plan(n, m, k, c, route)
    assert plan.route == route
    assert plan.rows % gemm.WGRAD_ROUTE_ROWS[route] == 0
    assert plan.rows * plan.slices >= max(m, 1)
    assert plan.rows * (plan.slices - 1) < max(m, 1)
    tiles = (-(-k // 128) * -(-c // 64) if route == "f32_tc"
             else -(-k // 32) * -(-c // 64))
    assert plan.tiles == tiles


@pytest.mark.parametrize("n,m,k,c", PATH_SHAPES)
def test_f32_plan_gives_many_items_at_path_shapes(n, m, k, c):
    """The f32 routes run persistent grids of one block an SM (f32_tc)
    or a few (f32_narrow): enough (tile, slice) items that the last
    round of a 132-SM card is a small part of the call, and no slice
    shorter than the route's least rows where M allows."""
    route = gemm.wgrad_route(m, k, c, f32=True)
    plan = gemm.wgrad_plan(n, m, k, c, route)
    least = (gemm.WGRAD_NARROW_MIN_SLICE_ROWS if route == "f32_narrow"
             else gemm.WGRAD_MIN_SLICE_ROWS)
    assert plan.slices <= max(1, -(-m // least))
    items = n * plan.tiles * plan.slices
    assert items >= min(4 * 132, n * plan.tiles * -(-m // least))


def test_f32_plans_of_the_paths_are_pinned():
    """The f32 ring's conv1 and conv2 weight gradients (8 x 336 FEMNIST-
    CNN samples) and the ResNet9 stem's: the plan fixes each output's
    sum order, so a change to it changes the kernel's bits."""
    def plan(*shape):
        return gemm.wgrad_plan(*shape, gemm.wgrad_route(*shape[1:], True))
    assert plan(8, 336 * 784, 25, 32) == gemm.WgradPlan(
        "f32_narrow", 1, 576, 458)
    assert plan(8, 336 * 196, 800, 64) == gemm.WgradPlan(
        "f32_tc", 7, 1792, 37)
    assert plan(16, 128 * 1024, 27, 64) == gemm.WgradPlan(
        "f32_narrow", 1, 512, 256)


def test_f32_routes_follow_the_shape_and_refuse_what_they_cannot_run():
    gemm.wgrad_plan.cache_clear()
    first = [gemm.wgrad_plan(*s, gemm.wgrad_route(*s[1:], True))
             for s in PATH_SHAPES]
    gemm.wgrad_plan.cache_clear()
    assert [gemm.wgrad_plan(*s, gemm.wgrad_route(*s[1:], True))
            for s in PATH_SHAPES] == first
    assert gemm.wgrad_route(300, 32, 64, True) == "f32_narrow"
    assert gemm.wgrad_route(300, 33, 64, True) == "f32_tc"
    # a contraction of one 32-row box or less: the exact route at any K
    assert gemm.wgrad_route(32, 800, 64, True) == "f32_narrow"
    assert gemm.wgrad_route(33, 800, 64, True) == "f32_tc"
    assert gemm.wgrad_plan(2, 1, 800, 64, "f32_narrow") == gemm.WgradPlan(
        "f32_narrow", 25, 64, 1)
    assert gemm.wgrad_route(300, 800, 64) == "wide"
    assert gemm.wgrad_route(300, 27, 64) == "narrow"
    # the SIMT route "f32" is gone
    with pytest.raises(ValueError, match="unknown K2 route"):
        gemm.wgrad_plan(2, 300, 25, 32, "f32")
    assert gemm.WGRAD_ROUTES == ("general", "wide", "f32_tc", "f32_narrow",
                                 "narrow")


# The bf16 narrow route (K <= 32, N <= 64 a multiple of 8): a work item
# is (node, slice) and covers the whole K x N output, so x is read once;
# its slices are whole 128-row stages.
NARROW_SHAPES = [(8, 336 * 784, 25, 32), (8, 20 * 784, 25, 32),
                 (16, 64 * 784, 25, 32), (16, 128 * 1024, 27, 64),
                 (3, 3 * 1024 + 77, 27, 64), (2, 1, 9, 48), (2, 129, 32, 64),
                 (2, 2000, 25, 32), (5, 7, 8, 8)]


@pytest.mark.parametrize("n,m,k,c", NARROW_SHAPES)
def test_narrow_plan_covers_every_row_once_in_whole_stages(n, m, k, c):
    plan = gemm.wgrad_plan(n, m, k, c)
    assert plan.route == "narrow" and plan.tiles == 1
    assert gemm.WGRAD_ROUTE_ROWS["narrow"] == 128
    assert plan.rows % 128 == 0
    assert plan.rows * plan.slices >= m
    assert plan.rows * (plan.slices - 1) < m
    assert plan.slices <= max(1, -(-m // gemm.WGRAD_MIN_SLICE_ROWS))


@pytest.mark.parametrize("k,c,route", [
    (25, 32, "narrow"), (27, 64, "narrow"), (9, 48, "narrow"),
    (32, 64, "narrow"), (8, 8, "narrow"), (40, 64, "wide"),
    (33, 64, "general"), (27, 72, "general"), (25, 25, "general"),
    (800, 64, "wide")])
def test_narrow_route_by_shape(k, c, route):
    assert gemm.wgrad_route(4096, k, c) == route
    # the codes are indices into WGRAD_ROUTES: narrow was appended
    assert gemm.WGRAD_ROUTES.index("narrow") == 4


@pytest.mark.parametrize("n,m,k,c,slices", [
    (16, 128 * 1024, 27, 64, 8), (8, 336 * 784, 25, 32, 16),
    (8, 20 * 784, 25, 32, 16), (16, 64 * 784, 25, 32, 8)])
def test_narrow_plan_fills_the_card_at_path_shapes(n, m, k, c, slices):
    """The narrow route's persistent grid (one block an SM) gets 128
    items at the stem and at conv1's three path shapes: one a block of a
    128-132-SM card, each a whole stage multiple. More items a block
    cost a reduction each and the slice sum one more slice, more than
    the balance they buy (measured at conv1 and the stem)."""
    plan = gemm.wgrad_plan(n, m, k, c)
    assert plan.route == "narrow" and plan.slices == slices
    assert n * plan.slices * plan.tiles == 128
    assert plan.rows % 128 == 0 and plan.rows * (plan.slices - 1) < m


def _view(n, m, k, off, dtype=torch.bfloat16):
    """An ``[n, m, k]`` operand ``off`` elements into a buffer."""
    return torch.zeros(n * m * k + off, dtype=dtype)[off:].view(n, m, k)


# The plan a call takes (``wgrad_call_plan``): the shape's, except where
# a TMA map cannot start at an operand's base (16 bytes): x's or g's on
# the wide route, g's on the narrow one. The narrow route takes x at any
# base and node bases off 16 bytes (M K odd): its rows go by 1-D bulk
# copies whose unaligned edges are copied by hand.
@pytest.mark.parametrize("m,k,c,x_off,g_off,route", [
    (3 * 784 + 8, 25, 32, 0, 0, "narrow"),
    (2 * 784 + 13, 25, 32, 0, 0, "narrow"),
    (2 * 784 + 13, 27, 64, 1, 0, "narrow"),
    (3 * 1024, 27, 64, 0, 1, "general"),
    (3 * 784, 25, 32, 1, 1, "general"),
    (3 * 196, 800, 64, 0, 0, "wide"),
    (3 * 196, 800, 64, 1, 0, "general"),
    (3 * 196, 800, 64, 0, 1, "general"),
    (3 * 196, 21, 70, 0, 0, "general")])
def test_call_plan_follows_the_operands_bases(m, k, c, x_off, g_off, route):
    x, g = _view(3, m, k, x_off), _view(3, m, c, g_off)
    assert (x.data_ptr() % 16, g.data_ptr() % 16) == (2 * x_off, 2 * g_off)
    assert gemm.wgrad_call_plan(x, g) == gemm.wgrad_plan(3, m, k, c, route)


@pytest.mark.parametrize("k,c", [(25, 32), (800, 64)])
def test_call_plan_f32_takes_any_base(k, c):
    """The f32 routes copy by cp.async row spans: their plan is the
    shape's at any base."""
    m = 2 * 784 + 13
    x, g = (_view(2, m, k, 1, torch.float32),
            _view(2, m, c, 1, torch.float32))
    assert gemm.wgrad_call_plan(x, g) == gemm.wgrad_plan(
        2, m, k, c, gemm.wgrad_route(m, k, c, f32=True))
