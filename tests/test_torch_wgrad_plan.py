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
    assert plan.rows % (32 if plan.route == "wide" else 256) == 0
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
    a slice, so 8 slices of 16,384 rows make the route's 256 blocks."""
    plan = gemm.wgrad_plan(16, 128 * 32 * 32, 27, 64)
    assert plan == gemm.WgradPlan("general", 2, 16384, 8)
    assert gemm.wgrad_plan(16, 128 * 32 * 32, 27, 64, "f32").route == "f32"
