"""The port's aggregation session against the JAX package's, on the CPU.

The same adds, in the same order, go into both packages' sessions;
what each add returns, the covered sets, every partial aggregate asked
for and the final aggregate must be equal, at tolerance 0 (FedAvg is
the host numpy weighted mean in both). Also: overlap rejection and
supersede eviction, the timeout close, waiting-mode adoption, a robust
aggregator over stacked entries and bf16 leaves. The async close,
stale folds and reputation are held in
``tests/test_torch_socket_elastic.py`` and
``tests/test_torch_socket_adversary.py``.
"""

from __future__ import annotations

import asyncio
import time

import jax
import numpy as np
import pytest

from p2pfl_tpu.core.aggregators import FedMedian as JFedMedian
from p2pfl_tpu.p2p.aggd import fuse_numpy as j_fuse
from p2pfl_tpu.p2p.session import AggregationSession as JSession
from p2pfl_tpu_torch.core.aggregators import FedMedian
from p2pfl_tpu_torch.core.serialize import to_bf16, tree_leaves_sorted
from p2pfl_tpu_torch.p2p.session import (
    AggregationSession,
    fuse_numpy,
)


def _tree(rng) -> dict:
    return {"params": {
        "Dense_0": {"kernel": rng.standard_normal((20, 8)).astype(np.float32),
                    "bias": rng.standard_normal(8).astype(np.float32)},
        "Dense_1": {"kernel": rng.standard_normal((8, 3)).astype(np.float32),
                    "bias": rng.standard_normal(3).astype(np.float32)}}}


def _equal(a, b) -> None:
    la, lb = jax.tree.leaves(a), tree_leaves_sorted(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# (contributors, weight) of each add, in order: own model, a superseding
# partial, an overlapping non-superseding one (rejected), a covered one
# (rejected), then the rest of the train set
ADDS = [((0,), 60), ((1,), 55), ((1, 2), 110), ((2, 3), 90), ((1,), 5),
        ((3,), 61), ((4, 5), 130)]


def test_session_matches_jax_add_by_add():
    rng = np.random.default_rng(0)
    trees = [_tree(rng) for _ in ADDS]

    async def main():
        js, ts = JSession(), AggregationSession()
        for s in (js, ts):
            s.set_nodes_to_aggregate(range(6))
        for (contrib, w), tree in zip(ADDS, trees):
            got_j = js.add_model(tree, contrib, w)
            got_t = ts.add_model(tree, contrib, w)
            assert got_t == got_j
            assert ts.covered == js.covered
            for peer in ((), (0,), (1, 2), (0, 3), (5,)):
                pj = js.get_partial_aggregation(peer)
                pt = ts.get_partial_aggregation(peer)
                assert (pj is None) == (pt is None)
                if pj is not None:
                    _equal(pj[0], pt[0])
                    assert pt[1:] == pj[1:]
        assert ts.done.is_set() and js.done.is_set()
        _equal(js.result[0], ts.result[0])
        assert ts.result[1] == js.result[1] == (0, 1, 2, 3, 4, 5)

    asyncio.run(main())


def test_timeout_close_and_waiting_adoption_match_jax():
    rng = np.random.default_rng(1)
    a, b = _tree(rng), _tree(rng)

    async def main():
        js = JSession(timeout_s=0.05)
        ts = AggregationSession(timeout_s=0.05)
        for s in (js, ts):
            s.set_nodes_to_aggregate({0, 1, 2})
            s.add_model(a, (0,), 3)
            s.add_model(b, (2,), 1)
            assert not s.check_and_run()
        time.sleep(0.1)
        assert js.check_and_run() and ts.check_and_run()
        _equal(js.result[0], ts.result[0])
        assert ts.result[1] == js.result[1] == (0, 2)
        ts.clear()
        ts.set_waiting_aggregated_model()
        assert ts.add_model(b, (0, 1, 2), 1) == (0, 1, 2)
        assert ts.done.is_set()
        _equal(b, ts.result[0])

    asyncio.run(main())


@pytest.mark.parametrize("weights", [[1.0, 2.0, 5.0], [0.0, 0.0, 0.0]])
def test_fuse_numpy_matches_jax(weights):
    rng = np.random.default_rng(2)
    trees = [_tree(rng) for _ in weights]
    jt, jw = j_fuse(trees, weights)
    tt, tw = fuse_numpy(trees, weights)
    assert tw == jw
    _equal(jt, tt)


def test_fuse_numpy_bf16_leaves_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    trees = [_tree(rng) for _ in range(3)]
    jtrees = [jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), t)
              for t in trees]
    ttrees = [jax.tree.map(to_bf16, t) for t in trees]
    jt, _ = j_fuse(jtrees, [1.0, 2.0, 3.0])
    tt, _ = fuse_numpy(ttrees, [1.0, 2.0, 3.0])
    for x, y in zip(jax.tree.leaves(jt), tree_leaves_sorted(tt)):
        np.testing.assert_array_equal(np.asarray(x).view(np.uint16),
                                      np.asarray(y).view(np.uint16))


def test_robust_aggregator_over_stacked_entries():
    rng = np.random.default_rng(4)
    trees = [_tree(rng) for _ in range(3)]

    async def main():
        js, ts = JSession(JFedMedian()), AggregationSession(FedMedian())
        for s in (js, ts):
            s.set_nodes_to_aggregate({0, 1, 2})
            for i, t in enumerate(trees):
                s.add_model(t, (i,), 10)
        # the median is an element of the entries: exact in both
        _equal(js.result[0], ts.result[0])

    asyncio.run(main())
