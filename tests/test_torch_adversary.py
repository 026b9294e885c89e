"""The adversary subsystem against the JAX package's, on the CPU.

- ``poison_update`` / ``poison_stacked``: signflip, scale, freerider,
  none and labelflip give the JAX package's bits (f32 and bf16 leaves;
  XLA:CPU does not contract ``r - s * (p - r)`` into an FMA here, so the
  two agree bit for bit). ``noise`` cannot give ``jax.random``'s bits:
  it is held by its determinism (same seed, node, round, leaf: same
  bits; another of them: other bits) and its moments (the added noise
  has mean 0 and standard deviation ``scale * std(delta)`` to 3%).
- ``flip_labels`` and ``malicious_indices``: ``array_equal``.
- ``cohort_scores`` / ``spmd_trust_obs``: rtol 1e-5, atol 1e-6 (f32
  sums over the flattened delta in another order), with odd and even
  present counts, a NaN row and absent rows.
- ``ReputationMonitor``: the same trust, weights and suspects after the
  same observations (both are numpy).
- ``AdversaryConfig``: the same validation and JSON round trip.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu import adversary as jadv
from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu_torch import adversary as tadv
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.convert import params_from_jax

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _node_tree(seed):
    rng = np.random.default_rng(seed)
    return {"Dense_0": {"bias": rng.standard_normal(16),
                        "kernel": rng.standard_normal((24, 16))},
            "Dense_1": {"bias": rng.standard_normal(5),
                        "kernel": rng.standard_normal((16, 5))}}


def _cast(tree, jdt, tdt):
    """The same numpy tree as JAX arrays and as tensors of one dtype."""
    j = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    t = params_from_jax(jax.tree.map(lambda a: a.astype(np.float32), tree))
    return j, {k: {n: v.to(tdt) for n, v in layer.items()}
               for k, layer in t.items()}


def _bits_equal(j, t):
    a = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
    b = t.float().numpy()
    return np.array_equal(a.view(np.uint32), b.view(np.uint32))


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["signflip", "scale", "freerider", "none",
                                  "labelflip"])
def test_poison_update_gives_the_jax_bits(kind, dt):
    jp, tp = _cast(_node_tree(0), *DTYPES[dt])
    jr, tr = _cast(_node_tree(1), *DTYPES[dt])
    jspec = jadv.AttackSpec(kind=kind, scale=7.5, seed=3)
    tspec = tadv.AttackSpec(kind=kind, scale=7.5, seed=3)
    want = jadv.poison_update(jp, jr, 2, 4, jspec)
    got = tadv.poison_update(tp, tr, 2, 4, tspec)
    for layer in want:
        for name in want[layer]:
            assert got[layer][name].dtype == tp[layer][name].dtype
            assert _bits_equal(want[layer][name], got[layer][name])


def test_noise_is_deterministic_and_has_its_moments():
    rng = np.random.default_rng(5)
    p = {"w": torch.from_numpy(rng.standard_normal((300, 200)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(50).astype(
            np.float32))}
    r = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator()
                                  .manual_seed(1)) for k, v in p.items()}
    spec = tadv.AttackSpec(kind="noise", scale=2.0, seed=11)
    a = tadv.poison_update(p, r, 3, 7, spec)
    b = tadv.poison_update(p, r, 3, 7, spec)
    assert all(torch.equal(a[k], b[k]) for k in p)
    for node, rnd, seed in ((4, 7, 11), (3, 8, 11), (3, 7, 12)):
        other = tadv.poison_update(
            p, r, node, rnd, tadv.AttackSpec(kind="noise", scale=2.0,
                                             seed=seed))
        assert not torch.equal(other["w"], a["w"])
    # leaves draw from distinct streams
    assert tadv.attack_seed(11, 3, 7, 0) != tadv.attack_seed(11, 3, 7, 1)
    d = p["w"] - r["w"]
    want_std = 2.0 * float(torch.sqrt((d * d).mean() + 1e-12))
    added = (a["w"] - p["w"]).double()
    assert abs(float(added.mean())) < 3 * want_std / np.sqrt(added.numel())
    assert abs(float(added.std()) / want_std - 1.0) < 0.03


@pytest.mark.parametrize("kind", ["signflip", "scale", "freerider", "noise"])
def test_poison_stacked_poisons_only_the_malicious_rows(kind):
    n = 5
    rng = np.random.default_rng(7)
    stack = {"a": {"kernel": rng.standard_normal((n, 6, 4)).astype(
        np.float32), "bias": rng.standard_normal((n, 4)).astype(np.float32)}}
    ref = jax.tree.map(lambda x: (x * 0.9).astype(np.float32), stack)
    mal = tadv.malicious_indices(n, 0.4, seed=2)
    spec = tadv.AttackSpec(kind=kind, scale=10.0, seed=1)
    tstack, tref = params_from_jax(stack), params_from_jax(ref)
    got = tadv.poison_stacked(tstack, tref, mal, 3, spec)
    for i in range(n):
        row = {"a": {k: v[i] for k, v in tstack["a"].items()}}
        rref = {"a": {k: v[i] for k, v in tref["a"].items()}}
        want = (tadv.poison_update(row, rref, i, 3, spec) if mal[i]
                else row)
        for k in ("kernel", "bias"):
            assert torch.equal(got["a"][k][i], want["a"][k])
    assert all(torch.equal(params_from_jax(stack)["a"][k], tstack["a"][k])
               for k in ("kernel", "bias"))  # the input is not modified
    if kind != "noise":
        jgot = jadv.poison_stacked(jax.tree.map(jnp.asarray, stack),
                                   jax.tree.map(jnp.asarray, ref), mal, 3,
                                   jadv.AttackSpec(kind=kind, scale=10.0,
                                                   seed=1))
        for k in ("kernel", "bias"):
            assert _bits_equal(jgot["a"][k], got["a"][k])


@pytest.mark.parametrize("n,fraction,seed,nodes", [
    (16, 0.25, 0, ()), (8, 0.25, 3, ()), (10, 0.0, 0, ()), (7, 0.5, 9, ()),
    (6, 0.9, 1, (1, 4)),
])
def test_malicious_indices_and_flip_labels_match_jax(n, fraction, seed, nodes):
    assert np.array_equal(tadv.malicious_indices(n, fraction, seed, nodes),
                          jadv.malicious_indices(n, fraction, seed, nodes))
    y = np.random.default_rng(seed).integers(0, 62, (n, 30)).astype(np.int32)
    got = tadv.flip_labels(y, 62)
    assert got.dtype == y.dtype
    assert np.array_equal(got, jadv.flip_labels(y, 62))


def _deltas(k, d, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32)
    deltas = (base + 0.5 * rng.standard_normal((k, d))).astype(np.float32)
    deltas[1] *= -10.0  # a sign-flipper
    deltas[2] *= 0.001  # a free-rider
    return deltas


@pytest.mark.parametrize("present", [
    None,
    [True, True, True, True, True, False, True],  # 6 present: even
    [True, True, True, False, True, False, True],  # 5 present: odd
    [False] * 7,
])
@pytest.mark.parametrize("nan_row", [False, True])
def test_cohort_scores_match_jax(present, nan_row):
    deltas = _deltas(7, 300, 3)
    if nan_row:
        deltas[4, 17] = np.nan
    pm = None if present is None else np.array(present)
    want = jadv.cohort_scores(jnp.asarray(deltas),
                              None if pm is None else jnp.asarray(pm),
                              xp=jnp)
    got = tadv.cohort_scores(torch.from_numpy(deltas),
                             None if pm is None else torch.from_numpy(pm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    if nan_row:
        assert float(got[4]) == 0.0


def test_spmd_trust_obs_matches_jax():
    n = 6
    rng = np.random.default_rng(9)
    ref = {"a": {"bias": rng.standard_normal((n, 8)),
                 "kernel": rng.standard_normal((n, 12, 8))},
           "b": {"bias": rng.standard_normal((n, 3)),
                 "kernel": rng.standard_normal((n, 8, 3))}}
    ref = jax.tree.map(lambda a: a.astype(np.float32), ref)
    # a shared step plus per-node noise; node 2 sends it flipped x10
    step = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape[1:]) * 0.1).astype(np.float32),
        ref)
    params = jax.tree.map(lambda r, s: (r + s + 0.02 * rng.standard_normal(
        r.shape)).astype(np.float32), ref, step)
    for p, r in zip(jax.tree.leaves(params), jax.tree.leaves(ref)):
        p[2] = r[2] - 10.0 * (p[2] - r[2])
    present = np.array([True, True, True, True, False, True])
    want = jadv.spmd_trust_obs(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, ref),
                               jnp.asarray(present))
    got = tadv.spmd_trust_obs(params_from_jax(params), params_from_jax(ref),
                              torch.from_numpy(present))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    assert float(got[2]) < 0.15 < float(got[0]) and float(got[4]) == 0.0


def test_reputation_monitor_matches_jax():
    n = 6
    rng = np.random.default_rng(4)
    j = jadv.ReputationMonitor(n, alpha=0.6, cutoff=0.2)
    t = tadv.ReputationMonitor(n, alpha=0.6, cutoff=0.2)
    for r in range(6):
        scores = rng.uniform(0, 1, n)
        scores[1] = 0.05
        if r == 2:
            scores[3] = np.nan
        mask = None if r % 2 == 0 else rng.uniform(0, 1, n) > 0.3
        j.observe(scores, mask)
        t.observe(scores, mask)
        assert np.array_equal(t.trust, j.trust)
        assert np.array_equal(t.weights_vector(), j.weights_vector())
        assert t.suspects() == j.suspects()
    assert t.history == j.history and 1 in t.suspects()
    with pytest.raises(ValueError, match="alpha"):
        tadv.ReputationMonitor(3, alpha=0.0)


@pytest.mark.parametrize("kw", [dict(kind="trojan"), dict(fraction=1.5),
                                dict(fraction=-0.1)])
def test_adversary_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        jschema.AdversaryConfig(**kw)
    with pytest.raises(ValueError) as got:
        tschema.AdversaryConfig(**kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tadv.AttackSpec(kind="trojan")


def test_scenario_config_reads_the_jax_adversary_block(tmp_path):
    jcfg = jschema.ScenarioConfig(
        n_nodes=8, aggregator="krum", aggregator_kwargs={"f": 2, "m": 3},
        adversary=jschema.AdversaryConfig(fraction=0.25, kind="noise",
                                          scale=3.0, reputation=True,
                                          reputation_cutoff=0.2))
    path = tmp_path / "s.json"
    jcfg.save(path)
    tcfg = tschema.ScenarioConfig.load(path)
    assert dataclasses.asdict(tcfg.adversary) == dataclasses.asdict(
        jcfg.adversary)
    assert tcfg.adversary.active and tcfg.aggregator_kwargs == {"f": 2, "m": 3}
    again = tschema.ScenarioConfig.from_dict(json.loads(tcfg.to_json()))
    assert again.adversary == tcfg.adversary
    for kind in jadv.ATTACKS:
        tschema.ScenarioConfig(n_nodes=4, adversary=tschema.AdversaryConfig(
            fraction=0.25, kind=kind))
