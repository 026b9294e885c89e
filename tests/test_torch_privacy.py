"""DP-FedAvg against the JAX package's, on the CPU.

- ``clip_factor``: the JAX package's f32 bits (tolerance 0), the numpy
  form against numpy and the tensor form against ``jnp``, at norms 0,
  1e-30, 1, the clip and 1e30.
- ``update_norm``: rtol 1e-6 (f32 sums of a leaf in another order; the
  leaves are summed in the JAX package's flatten order on both sides).
- ``privatize_update`` at noise 0 against ``privatize_update_jit`` on a
  narrow FEMNIST-CNN tree (hidden 64). XLA contracts ``r + s * d`` into
  one fused multiply-add under jit, PyTorch's ``addcmul`` may round
  ``s * d`` first, and the two clip scales may differ by the norm's
  summation order, so
  each element is held to ``|ds| |d| + ulp(s d) / 2 + ulp(out)``, with
  ``|ds|`` at most 4 ulps of ``s``. A binding clip leaves the delta's
  norm at most ``clip (1 + 1e-6)``; a clip that does not bind leaves
  every element within 1 ulp of the update (of the largest of the
  element's update, reference and delta).
- The noise cannot be ``jax.random``'s bits: it is held by determinism
  (same seed, node, round and leaf: same bits; a change of any of them:
  other seeds and other draws, and no DP seed equals a noise-attack
  seed) and its moments (mean within 5 standard errors of 0, standard
  deviation within 5 standard errors of ``clip * sigma``).
- ``privatize_stacked``: unmasked rows keep their bits, masked rows are
  the per-row ``privatize_update``'s bits.
- ``epsilon_at`` and ``PrivacyAccountant``: equal to the JAX package's
  (tolerance 0) on sigma in {0.3, 0.6, 1, 2} x T in {0, 1, 10, 100},
  the 0 and inf edges and the same ``ValueError``; ``DPSpec`` and
  ``PrivacyConfig`` refuse what the JAX package refuses, with its
  message.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.privacy import dp as jdp
from p2pfl_tpu_torch.adversary.attacks import attack_seed
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.core.pytree import tree_leaves
from p2pfl_tpu_torch.privacy import dp as tdp

NORM_RTOL = 1e-6
CLIP_BOUND = 1e-6  # delta norm <= clip * (1 + CLIP_BOUND)
SCALE_ULPS = 4
SE = 5.0  # moment bounds in standard errors


def _cnn_tree(rng, scale=1.0):
    """A narrow FEMNIST-CNN tree (hidden 64), the port's key order."""
    shapes = {"Conv_0": ((5, 5, 1, 32), (32,)),
              "Conv_1": ((5, 5, 32, 64), (64,)),
              "Dense_0": ((3136, 64), (64,)),
              "Dense_1": ((64, 62), (62,))}
    return {"params": {
        name: {"kernel": (scale * rng.standard_normal(k)).astype(np.float32),
               "bias": (scale * rng.standard_normal(b)).astype(np.float32)}
        for name, (k, b) in shapes.items()}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _pair(seed=0, delta=1e-2):
    rng = np.random.default_rng(seed)
    ref = _cnn_tree(rng, 0.1)
    upd = jax.tree.map(lambda r, d: (r + d).astype(np.float32), ref,
                       _cnn_tree(rng, delta))
    return upd, ref


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], pre + (k,))
    else:
        yield pre, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("clip", [1.0, 0.05, 3.7])
def test_clip_factor_gives_the_jax_bits(clip):
    norms = np.array([0.0, 1e-30, 1.0, clip, 1e30], np.float32)
    want_np = jdp.clip_factor(norms, clip, xp=np)
    got_np = tdp.clip_factor(norms, clip)
    assert got_np.dtype == np.float32
    assert np.array_equal(got_np.view(np.uint32), want_np.view(np.uint32))
    want = np.asarray(jdp.clip_factor(jnp.asarray(norms), clip, xp=jnp))
    got = tdp.clip_factor(torch.from_numpy(norms), clip).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    for v in norms:  # the scalar forms too
        w = np.asarray(jdp.clip_factor(jnp.float32(v), clip, xp=jnp))
        g = tdp.clip_factor(torch.tensor(v), clip).numpy()
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


def test_update_norm_matches_jax():
    upd, ref = _pair(1)
    want = float(jdp.update_norm(upd, ref, xp=jnp))
    got = float(tdp.update_norm(_torch(upd), _torch(ref)))
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL)
    assert float(tdp.update_norm(_torch(ref), _torch(ref))) == 0.0


@pytest.mark.parametrize("clip", [0.05, 1e6])
def test_privatize_update_at_zero_noise_matches_jax(clip):
    upd, ref = _pair(2)
    key = jdp.dp_key(0, 1, 2)
    want = jax.tree.map(np.asarray,
                        jdp.privatize_update_jit(upd, ref, clip, 0.0, key))
    tu, tr = _torch(upd), _torch(ref)
    got = tdp.privatize_update(tu, tr, clip, 0.0, (0, 1, 2))
    s_t = float(tdp.clip_factor(tdp.update_norm(tu, tr), clip))
    s_j = float(jdp.clip_factor(jdp.update_norm(upd, ref, xp=jnp), clip,
                                xp=jnp))
    ds = abs(s_t - s_j)
    assert ds <= SCALE_ULPS * np.spacing(np.float32(s_j))
    for path, g in _paths(got):
        g = g.numpy()
        w = _get(want, path)
        r = _get(ref, path)
        d = _get(upd, path) - r
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        bound = (ds * np.abs(d) + 0.5 * np.spacing(np.abs(s_t * d))
                 + np.spacing(np.maximum(np.abs(g), np.abs(w))))
        assert np.all(np.abs(g - w) <= bound), path
    out_norm = float(tdp.update_norm(got, tr))
    if clip < 1.0:
        assert s_t < 1.0
        assert out_norm <= clip * (1 + CLIP_BOUND)
    else:
        assert s_t == 1.0
        for path, g in _paths(got):
            p, r = _get(upd, path), _get(ref, path)
            ulp = np.spacing(np.maximum.reduce(
                [np.abs(p), np.abs(r), np.abs(p - r)]))
            assert np.all(np.abs(g.numpy() - p) <= ulp), path


def _noise(seed, node, rnd, sigma=1.0, clip=1.0, n=65536):
    """The noise a zero delta gets: (out - ref) / (clip * sigma)."""
    ref = {"a": torch.zeros(n), "b": torch.zeros(n // 4)}
    out = tdp.privatize_update(ref, ref, clip, sigma,
                               (seed, node, rnd))
    return [t / float(tdp.noise_sigma(clip, sigma)) for t in tree_leaves(out)]


def test_noise_is_deterministic_and_distinct():
    a = _noise(0, 1, 2)
    b = _noise(0, 1, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (_noise(1, 1, 2), _noise(0, 2, 2), _noise(0, 1, 3)):
        assert not any(torch.equal(x[: y.numel()], y[: x.numel()])
                       for x, y in zip(a, other))
    # the two leaves draw from distinct streams
    assert not torch.equal(a[0][: a[1].numel()], a[1])
    seeds = {tdp.dp_seed(s, i, r, leaf) for s in range(3) for i in range(4)
             for r in range(4) for leaf in range(8)}
    assert len(seeds) == 3 * 4 * 4 * 8
    attack = {attack_seed(s, i, r, leaf) for s in range(3)
              for i in range(4) for r in range(4) for leaf in range(8)}
    assert not seeds & attack


@pytest.mark.parametrize("sigma,clip", [(1.0, 1.0), (0.3, 2.5)])
def test_noise_has_its_moments(sigma, clip):
    ref = {"a": torch.full((200_000,), 0.25)}
    out = tdp.privatize_update(ref, ref, clip, sigma, (3, 0, 0))
    noise = (out["a"] - ref["a"]).double()
    std = float(tdp.noise_sigma(clip, sigma))
    n = noise.numel()
    assert abs(float(noise.mean())) <= SE * std / np.sqrt(n)
    assert abs(float(noise.std()) - std) <= SE * std / np.sqrt(2 * n)


@pytest.mark.parametrize("sigma", [0.0, 0.7])
def test_privatize_stacked_touches_only_the_masked_rows(sigma):
    rng = np.random.default_rng(4)
    n = 4
    ref = jax.tree.map(lambda a: np.stack([a] * n), _cnn_tree(rng, 0.1))
    upd = jax.tree.map(
        lambda r: (r + 0.01 * rng.standard_normal(r.shape)).astype(
            np.float32), ref)
    tu, tr = _torch(upd), _torch(ref)
    mask = np.array([True, False, True, False])
    spec = tdp.DPSpec(clip_norm=0.05, noise_multiplier=sigma, seed=9)
    out = tdp.privatize_stacked(tu, tr, mask, 5, spec)
    for i in range(n):
        row = {k: {m: t[i] for m, t in v.items()}
               for k, v in tu["params"].items()}
        rref = {k: {m: t[i] for m, t in v.items()}
                for k, v in tr["params"].items()}
        want = ({"params": row} if not mask[i] else tdp.privatize_update(
            {"params": row}, {"params": rref}, spec.clip_norm,
            spec.noise_multiplier, (spec.seed, i, 5)))
        for path, w in _paths(want):
            g = _get(out, path)[i]
            assert torch.equal(g, w), (i, path)
    # the input tree is not written
    assert all(torch.equal(a, torch.from_numpy(b))
               for (_, a), (_, b) in zip(_paths(tu), _paths(upd)))


@pytest.mark.parametrize("sigma", [0.3, 0.6, 1.0, 2.0])
@pytest.mark.parametrize("steps", [0, 1, 10, 100])
def test_epsilon_and_accountant_match_jax(sigma, steps):
    assert tdp.epsilon_at(sigma, steps, 1e-5) == jdp.epsilon_at(
        sigma, steps, 1e-5)
    ta = tdp.PrivacyAccountant(sigma, delta=1e-5)
    ja = jdp.PrivacyAccountant(sigma, delta=1e-5)
    ta.step(steps)
    ja.step(steps)
    assert ta.epsilon == ja.epsilon
    for budget in (0.0, float("inf"), 8.0):
        assert ta.spent_fraction(budget) == ja.spent_fraction(budget)


def test_epsilon_edges_and_errors_match_jax():
    assert tdp.epsilon_at(0.0, 10, 1e-5) == jdp.epsilon_at(0.0, 10, 1e-5)
    assert tdp.epsilon_at(0.0, 10, 1e-5) == float("inf")
    assert tdp.epsilon_at(1.0, 0, 1e-5) == 0.0
    assert tdp.epsilon_at(1.0, -3, 2.0) == jdp.epsilon_at(1.0, -3, 2.0)
    for delta in (0.0, 1.0, -1e-5):
        with pytest.raises(ValueError) as want:
            jdp.epsilon_at(1.0, 10, delta)
        with pytest.raises(ValueError) as got:
            tdp.epsilon_at(1.0, 10, delta)
        assert str(got.value) == str(want.value)
    assert tdp.noise_sigma(1.3, 0.7) == jdp.noise_sigma(1.3, 0.7)


@pytest.mark.parametrize("kw", [
    dict(clip_norm=0.0), dict(clip_norm=-1.0),
    dict(noise_multiplier=-0.1),
])
def test_dpspec_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        jdp.DPSpec(**kw)
    with pytest.raises(ValueError) as got:
        tdp.DPSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(dp=True, clip_norm=0.0), dict(dp=True, noise_multiplier=-1.0),
    dict(dp=True, delta=0.0), dict(dp=True, delta=1.0),
    dict(epsilon_budget=-1.0), dict(secagg_bits=7), dict(secagg_bits=41),
])
def test_privacy_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        jschema.PrivacyConfig(**kw)
    with pytest.raises(ValueError) as got:
        tschema.PrivacyConfig(**kw)
    assert str(got.value) == str(want.value)
    # off, the DP knobs are not checked, as in the JAX package
    ok = dict(kw, dp=False) if "dp" in kw else None
    if ok is not None:
        assert tschema.PrivacyConfig(**ok).active is False
