"""The robust aggregators against the JAX package's, on the CPU.

The same numpy tree (f32, a leading node axis) and weights go through
``p2pfl_tpu.core.aggregators`` and ``p2pfl_tpu_torch.core.aggregators``.
Tolerance rtol 1e-6, atol 1e-7: the masked-mean fill and the means sum
over the node axis in another order on each side; the sorts and the
median's midpoint are the same arithmetic. Krum's selection is held
exactly (the weighted mean of the selected rows is compared with the
same tolerance).
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.core import aggregators as jagg
from p2pfl_tpu_torch.convert import params_from_jax
from p2pfl_tpu_torch.core import aggregators as tagg

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(n, seed, outliers=()):
    rng = np.random.default_rng(seed)
    tree = {"Conv_0": {"bias": rng.standard_normal((n, 4)),
                       "kernel": rng.standard_normal((n, 3, 3, 1, 4))},
            "Dense_0": {"bias": rng.standard_normal((n, 6)),
                        "kernel": rng.standard_normal((n, 7, 6))}}
    for leaf in (tree["Conv_0"]["kernel"], tree["Dense_0"]["kernel"]):
        for i in outliers:
            leaf[i] = 40.0 + 5.0 * leaf[i]
    return jax.tree.map(lambda a: a.astype(np.float32), tree)


def _run(jaggregator, taggregator, tree, weights, mask):
    want = jaggregator.aggregate(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(weights),
        None if mask is None else jnp.asarray(mask))
    got = taggregator.aggregate(
        params_from_jax(tree), torch.from_numpy(weights),
        None if mask is None else torch.from_numpy(np.asarray(mask)))
    for layer in tree:
        for name in tree[layer]:
            np.testing.assert_allclose(got[layer][name].numpy(),
                                       np.asarray(want[layer][name]), **TOL)
    return got


MASKS = {
    5: [None, [True, True, False, True, True], [True, False, True, False,
                                                 True]],
    6: [None, [True, True, True, False, True, True],
        [False, True, True, True, True, False]],
}


@pytest.mark.parametrize("n,mask_i", [(5, 0), (5, 1), (5, 2), (6, 0), (6, 1),
                                      (6, 2)])
def test_fed_median_matches_jax(n, mask_i):
    """Odd and even row counts (the even one averages the middle pair),
    with 5, 4, 3 and 6 present rows."""
    w = np.arange(1, n + 1, dtype=np.float32)
    _run(jagg.FedMedian(), tagg.FedMedian(), _tree(n, n + mask_i), w,
         MASKS[n][mask_i])


def test_fed_median_of_an_even_count_is_the_midpoint():
    tree = {"a": np.array([[1.0], [4.0], [2.0], [10.0]], np.float32)}
    got = tagg.FedMedian().aggregate(params_from_jax(tree), torch.ones(4))
    assert float(got["a"][0]) == 3.0  # (2 + 4) / 2, not torch's lower 2


@pytest.mark.parametrize("beta", [0, 1, 2, 7])
@pytest.mark.parametrize("n,mask_i", [(5, 1), (6, 0), (6, 2)])
def test_trimmed_mean_matches_jax(beta, n, mask_i):
    """beta 7 is clipped to (n - 1) // 2 on both sides."""
    w = np.full(n, 3.0, np.float32)
    _run(jagg.TrimmedMean(beta), tagg.TrimmedMean(beta), _tree(n, 11 + n), w,
         MASKS[n][mask_i])


def test_trimmed_mean_refuses_a_negative_beta():
    with pytest.raises(ValueError, match="beta"):
        tagg.TrimmedMean(-1)


def _krum_selection(tree, n, weights, mask, f, m):
    """The rows Krum averaged, read off a one-hot probe leaf."""
    probe = dict(tree, probe={"eye": np.eye(n, dtype=np.float32) * 1e-6})
    jout = jagg.Krum(f, m).aggregate(
        jax.tree.map(jnp.asarray, probe), jnp.asarray(weights),
        None if mask is None else jnp.asarray(mask))
    tout = tagg.Krum(f, m).aggregate(
        params_from_jax(probe), torch.from_numpy(weights),
        None if mask is None else torch.from_numpy(np.asarray(mask)))
    return (np.flatnonzero(np.asarray(jout["probe"]["eye"])),
            np.flatnonzero(tout["probe"]["eye"].numpy()))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("mask", [None, [True, True, True, False, True, True,
                                         True, False]])
def test_krum_matches_jax(m, mask):
    n = 8
    tree = _tree(n, 21, outliers=(1, 6))
    w = np.ones(n, np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = _run(jagg.Krum(f=2, m=m), tagg.Krum(f=2, m=m), tree, w, mask)
        jsel, tsel = _krum_selection(tree, n, w, mask, 2, m)
    assert np.array_equal(jsel, tsel) and len(tsel) == m
    assert not set(tsel.tolist()) & {1, 6}  # the outliers are never picked
    if mask is not None:
        assert not set(tsel.tolist()) & {3, 7}  # absent rows never either
    assert got["Dense_0"]["kernel"].dtype == torch.float32


def test_krum_breaks_tied_scores_toward_the_lower_index():
    """Rows 2 and 5 are the same vector, the mean of the others, so they
    score lowest and tie; JAX's top_k and the port's stable sort both
    pick the lower index."""
    n = 7
    tree = _tree(n, 31)
    for layer in tree.values():
        for leaf in layer.values():
            leaf[2] = leaf[5] = leaf[[0, 1, 3, 4, 6]].mean(0)
    w = np.ones(n, np.float32)
    jsel, tsel = _krum_selection(tree, n, w, None, 1, 1)
    assert jsel.tolist() == tsel.tolist() == [2]


def test_krum_refuses_too_few_rows_and_warns_once_on_few_present():
    tree = params_from_jax(_tree(4, 41))
    with pytest.raises(ValueError, match="at least f\\+3"):
        tagg.Krum(f=2).aggregate(tree, torch.ones(4))
    with pytest.raises(ValueError, match="at least f\\+3"):
        jagg.Krum(f=2).aggregate(jax.tree.map(jnp.asarray, _tree(4, 41)),
                                 jnp.ones(4))
    krum = tagg.Krum(f=1)
    mask = torch.tensor([True, True, True, False])
    with pytest.warns(RuntimeWarning, match="NOT Byzantine-robust"):
        krum.aggregate(tree, torch.ones(4), mask)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        krum.aggregate(tree, torch.ones(4), mask)  # once per instance


@pytest.mark.parametrize("name,kw", [
    ("fedavg", {}), ("FedAvg", {}), ("fed_median", {}), ("median", {}),
    ("trimmed-mean", {"beta": 2}), ("TrimmedMean", {}),
    ("krum", {"f": 1, "m": 2}),
])
def test_get_aggregator_names_as_in_jax(name, kw):
    j, t = jagg.get_aggregator(name, **kw), tagg.get_aggregator(name, **kw)
    assert type(t).__name__ == type(j).__name__ and t.name == j.name
    assert vars(t) == vars(j)


def test_get_aggregator_refuses_unknown_names():
    with pytest.raises(ValueError) as want:
        jagg.get_aggregator("bulyan")
    with pytest.raises(ValueError) as got:
        tagg.get_aggregator("bulyan")
    assert str(got.value) == str(want.value)
