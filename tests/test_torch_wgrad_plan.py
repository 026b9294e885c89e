"""K2's slice plan (``ops/gemm.py::wgrad_plan``), on the CPU.

The plan fixes which rows each block sums and in which order the sums
are added, so it decides the kernel's bits: it must follow from the
shape alone, cover every row of a node exactly once in whole stages of
its route, and give every path's shape enough blocks to fill a card.
"""

from __future__ import annotations

import pytest

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


@pytest.mark.parametrize("n,m,k,c", PATH_SHAPES + EDGE_SHAPES)
def test_plan_covers_every_row_once(n, m, k, c):
    plan = gemm.wgrad_plan(n, m, k, c)
    assert plan.route == ("wide" if k % 8 == 0 and c % 8 == 0
                          else "general")
    assert plan.rows % gemm.WGRAD_ROUTE_ROWS[plan.route] == 0
    assert gemm.WGRAD_ROUTE_ROWS[plan.route] == (64 if plan.route == "wide"
                                                 else 256)
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
    images: K = 27 is no multiple of 8, so the mma.sync route; 2 tiles
    a slice, so 8 slices of 16,384 rows make the route's 256 blocks. In
    float32, K <= 32: the FFMA route, one 64-column tile, 256 slices of
    512 rows (4,096 items)."""
    plan = gemm.wgrad_plan(16, 128 * 32 * 32, 27, 64)
    assert plan == gemm.WgradPlan("general", 2, 16384, 8)
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
    assert gemm.wgrad_route(300, 27, 64) == "general"
    # the SIMT route "f32" is gone
    with pytest.raises(ValueError, match="unknown K2 route"):
        gemm.wgrad_plan(2, 300, 25, 32, "f32")
    assert gemm.WGRAD_ROUTES == ("general", "wide", "f32_tc", "f32_narrow")
