"""The port's adapter-only federation (``learning/lora.py``) against the
JAX package's.

The ViT at small widths (patch 4, dim 48, 3 heads, depth 2) and the
mnist MLP; the two packages draw different adapter values (a
``torch.Generator`` against ``jax.random.fold_in``), so every parity
test carries the JAX base and adapters across with
``convert.params_from_jax``.

Tolerances: the sites, their shapes, the merged model at init, Krum's
winner, the schema's refusals and the checkpoint bytes are exact;
``adapter_deltas`` (an f32 product of ``rank`` terms) rtol 1e-6 / atol
1e-7; a LoRA forward in f32 against JAX's, relative L2 1e-5 over the
logits; a 2-round LoRA ``Scenario`` in f32, train losses rtol 1e-5
and every adapter leaf relative L2 1e-5 (as ``test_torch_vit.py``'s
full-weight federation).
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import flax.serialization as fser
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.core.aggregators import Krum as JKrum
from p2pfl_tpu.federation import checkpoint as jck
from p2pfl_tpu.learning import lora as jlora
from p2pfl_tpu.models import get_model as jax_get_model
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.core.aggregators import get_aggregator
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map
from p2pfl_tpu_torch.federation import checkpoint as ck
from p2pfl_tpu_torch.federation import scenario as torch_scenario
from p2pfl_tpu_torch.learning import lora
from p2pfl_tpu_torch.models.base import get_model
from p2pfl_tpu_torch.parallel.federated import reseed_params

from test_torch_vit import SMALL, assert_runs_agree, run_both, vit_config

LORA_F32_REL_L2 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several pytest-xdist processes at once, and torch's default of a
    thread a core oversubscribes the CPU several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _vit_pair(scan: bool, remat: bool = True, dtype: str = "f32"):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return (jax_get_model("vit-tiny", dtype=jdt, remat=remat,
                          scan_layers=scan, **SMALL),
            get_model("vit-tiny", dtype=tdt, remat=remat, scan_layers=scan,
                      **SMALL))


def _site_tuple(s) -> tuple:
    return (s.key, tuple(s.shape), tuple(s.lead), s.d_in, s.d_out)


# ---------------------------------------------------------------------------
# sites, init, deltas, the merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
@pytest.mark.parametrize("targets", [(), ("query", "key", "value", "out",
                                          "Dense", "patch_embed")],
                         ids=["defaults", "every-kernel"])
def test_sites_match_jax(scan, targets):
    """``find_adapter_sites`` over the ViT's registered specs gives JAX's
    sites: the same keys in the same order, shapes, broadcast axes and
    d_in / d_out (a scanned q kernel ``[depth, 48, 3, 16]`` is one 48 ->
    48 projection a layer), and the same adapter count."""
    jm, tm = _vit_pair(scan)
    x = np.zeros((1, 32, 32, 3), np.float32)
    jw = jlora.wrap_model(jm, "vit-tiny", 4, targets=targets, sample_x=x,
                          seed=0)
    tw = lora.wrap_model(tm, "vit-tiny", 4, targets=targets,
                         sample_x=torch.from_numpy(x), seed=0)
    assert [_site_tuple(s) for s in tw.sites] == [
        _site_tuple(s) for s in jw.sites]
    assert tw.adapter_param_count() == jw.adapter_param_count()
    if scan and not targets:
        assert [s.lead for s in tw.sites] == [(2,), (2,)]
        assert all(s.d_in == s.d_out == 48 for s in tw.sites)


def test_full_size_qv_adapters_are_a_seventy_third_of_the_model():
    """ViT-Tiny at full size, scanned, rank 8 on q/v: 73,728 adapter
    parameters a node, 4 leaves (one K4 launch), against 5,362,378."""
    tm = get_model("vit-tiny", remat=True, scan_layers=True)
    w = lora.wrap_model(tm, "vit-tiny", 8,
                        sample_x=torch.zeros(1, 32, 32, 3), seed=4)
    assert w.adapter_param_count() == 73_728
    ad = w.init(torch.Generator().manual_seed(0), None)
    assert len(tree_leaves(ad)) == 4
    base = sum(t.numel() for t in tree_leaves(w.base))
    assert base == 5_362_378 and base // w.adapter_param_count() == 72


def test_unmatched_target_raises_naming_kernels():
    tm = get_model("mlp")
    base = lora.base_params_for(tm, 0, torch.zeros(1, 28, 28, 1))
    with pytest.raises(ValueError, match="no_such_layer.*kernel"):
        lora.find_adapter_sites(base, ("no_such_layer",))
    with pytest.raises(ValueError, match="must not be empty"):
        lora.find_adapter_sites(base, ())
    with pytest.raises(ValueError, match="no default lora targets"):
        lora.wrap_model(tm, "mlp", 4, sample_x=torch.zeros(1, 28, 28, 1))
    with pytest.raises(ValueError, match="rank must be >= 1"):
        lora.LoraModel(tm, base, 0, ("Dense",))


def test_init_draws_a_normal_and_a_zero_b():
    """``A ~ N(0, 1/d_in)`` from the generator (the same generator seed
    gives the same bits), ``B = 0``, f32, on the CPU."""
    tm = get_model("vit-tiny", scan_layers=True)
    w = lora.wrap_model(tm, "vit-tiny", 8,
                        sample_x=torch.zeros(1, 32, 32, 3))
    a1 = w.init(torch.Generator().manual_seed(3), None)
    a2 = w.init(torch.Generator().manual_seed(3), None)
    for k, ab in a1.items():
        assert torch.equal(ab["A"], a2[k]["A"])
        assert ab["A"].shape == (12, 192, 8) and ab["B"].shape == (12, 8, 192)
        assert not ab["B"].any() and ab["A"].dtype == torch.float32
        assert abs(float(ab["A"].std()) * np.sqrt(192) - 1.0) < 0.05


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_merged_equals_base_bitwise_at_init(scan):
    """B = 0: every node's materialized tree is the base bit for bit,
    and the wrapped model's logits are the base model's."""
    _, tm = _vit_pair(scan)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 2, 32, 32, 3)).astype(np.float32))
    w = lora.wrap_model(tm, "vit-tiny", 4, sample_x=x[0], seed=5)
    base = lora.base_params_for(tm, 5, x[0])
    ad = w.init(torch.Generator().manual_seed(1), None)
    stacked = tree_map(lambda t: t.unsqueeze(0).repeat(
        (3,) + (1,) * t.dim()), ad)
    merged = w.materialize(stacked)
    for got, want in zip(tree_leaves(merged), tree_leaves(base),
                         strict=True):
        assert got.shape == (3,) + tuple(want.shape)
        assert all(torch.equal(got[i], want) for i in range(3))
    full = tree_map(lambda t: t.unsqueeze(0).repeat((3,) + (1,) * t.dim()),
                    base)
    assert torch.equal(w(stacked, x), tm(full, x))


def test_materialize_shares_the_base():
    """Leaves off the sites are the base's own storage, expanded over
    the nodes (no copy); the base takes no gradient."""
    _, tm = _vit_pair(True)
    w = lora.wrap_model(tm, "vit-tiny", 4,
                        sample_x=torch.zeros(1, 32, 32, 3))
    ad = tree_map(lambda t: t.unsqueeze(0).repeat((5,) + (1,) * t.dim()),
                  w.init(torch.Generator().manual_seed(0), None))
    merged = w.materialize(ad)["params"]
    pe = merged["patch_embed"]["kernel"]
    assert pe.shape[0] == 5 and pe.stride(0) == 0
    assert pe.data_ptr() == w.base["params"]["patch_embed"][
        "kernel"].data_ptr()
    assert not any(t.requires_grad for t in tree_leaves(w.base))


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_adapter_deltas_match_jax(scan):
    """Given the same A and a nonzero B (and alpha 16 at rank 4), the
    deltas are JAX's (rtol 1e-6, atol 1e-7), shaped as the kernels, a
    node axis in front for a stacked tree."""
    jm, tm = _vit_pair(scan)
    x = np.zeros((1, 32, 32, 3), np.float32)
    jw = jlora.wrap_model(jm, "vit-tiny", 4, sample_x=x, alpha=16.0)
    tw = lora.wrap_model(tm, "vit-tiny", 4, sample_x=torch.from_numpy(x),
                         alpha=16.0)
    rng = np.random.default_rng(2)
    ad = {s.key: {"A": rng.standard_normal(s.lead + (s.d_in, 4)).astype(
                      np.float32),
                  "B": rng.standard_normal(s.lead + (4, s.d_out)).astype(
                      np.float32)}
          for s in jw.sites}
    want = jlora.adapter_deltas(ad, jw.sites, 4, 16.0)
    got = lora.adapter_deltas(params_from_jax(ad), tw.sites, 4, 16.0)
    stacked = lora.adapter_deltas(params_from_jax(ad, n_nodes=2), tw.sites,
                                  4, 16.0)
    for s in jw.sites:
        np.testing.assert_allclose(got[s.key].numpy(), np.asarray(want[s.key]),
                                   rtol=1e-6, atol=1e-7)
        assert got[s.key].shape == s.shape
        assert stacked[s.key].shape == (2,) + s.shape
        assert torch.equal(stacked[s.key][1], got[s.key])


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_lora_forward_matches_jax(scan):
    """The JAX base and nonzero adapters carried across: the port's
    wrapped forward over 2 nodes against JAX's ``LoraModel.apply``
    node by node, f32 logits within relative L2 1e-5."""
    jm, tm = _vit_pair(scan)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 32, 32, 3)).astype(np.float32)
    jw = jlora.wrap_model(jm, "vit-tiny", 4, sample_x=x[0], seed=2)
    tw = lora.wrap_model(tm, "vit-tiny", 4,
                         base=params_from_jax(_np(jw.base)))
    ads = [jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), _np(jw.init(jax.random.PRNGKey(i), x)))
        for i in range(2)]
    got = tw(params_from_jax(jax.tree.map(lambda *a: np.stack(a), *ads)),
             torch.from_numpy(x)).detach().numpy()
    for i in range(2):
        want = np.asarray(jax.jit(jw.apply)(ads[i], jnp.asarray(x[i])))
        assert _rel(got[i], want) < LORA_F32_REL_L2, i


def test_split_merge_roundtrip_through_a_model_blob():
    """The combined lora tree through ``pack_model`` / ``unpack_model``
    (the checkpoint's msgpack) and split back out, bit for bit; the
    blob is the JAX package's bytes for the same tree."""
    tm = get_model("mlp")
    base = lora.base_params_for(tm, 1, torch.zeros(1, 28, 28, 1))
    tree = lora.lora_init(base, 4, ("Dense",),
                          generator=torch.Generator().manual_seed(9))
    b, a = lora.split_adapters(tree)
    assert lora.merge_adapters(b, a) == tree
    blob = ck.pack_model(tree, 5)
    back, rnd = ck.unpack_model(blob, tree)
    assert rnd == 5
    for x, y in zip(tree_leaves(tree), tree_leaves(back), strict=True):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    rb, ra = lora.split_adapters(back)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(ra), tree_leaves(a), strict=True))
    assert jck.pack_model(params_to_numpy(tree), 5) == blob
    with pytest.raises(ValueError, match="not a lora tree"):
        lora.split_adapters({"params": {}})
    with pytest.raises(ValueError, match="not a lora tree"):
        lora.split_adapters([1, 2])


def test_krum_picks_jaxs_winner_on_adapters():
    """25% sign-flippers (scale 10) among 8 nodes' adapter trees: the
    port's Krum(f=2, m=1) over the adapter stack returns JAX's winner
    row bit for bit, and over the materialized full-weight stack (the
    base's leaves expanded, not copied) JAX's full-weight winner."""
    jm, tm = _vit_pair(True)
    x = np.zeros((1, 32, 32, 3), np.float32)
    jw = jlora.wrap_model(jm, "vit-tiny", 2, sample_x=x)
    tw = lora.wrap_model(tm, "vit-tiny", 2, base=params_from_jax(_np(jw.base)))
    n, rng = 8, np.random.default_rng(7)
    one = _np(jw.init(jax.random.PRNGKey(0), x))
    rows = [jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(np.float32), one) for _ in range(n)]
    for i in (2, 5):
        rows[i] = jax.tree.map(lambda a: a * np.float32(-10.0), rows[i])
    stacked = jax.tree.map(lambda *a: np.stack(a), *rows)
    krum = get_aggregator("krum", f=2, m=1)
    for jtree, ttree in (
            (stacked, params_from_jax(stacked)),
            (jax.tree.map(lambda *a: jnp.stack(a),
                          *[jw.materialize(r) for r in rows]),
             tw.materialize(params_from_jax(stacked)))):
        want = _np(JKrum(f=2, m=1).aggregate(jtree, jnp.ones(n)))
        got = krum.aggregate(ttree, torch.ones(n))
        for g, w in zip(tree_leaves(params_to_numpy(got)),
                        jax.tree.leaves(want), strict=True):
            assert np.array_equal(g, w)
    winner = [i for i in range(n) if all(
        np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(_np(JKrum(f=2, m=1).aggregate(
                stacked, jnp.ones(n)))), jax.tree.leaves(rows[i])))]
    assert len(winner) == 1 and winner[0] not in (2, 5)


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    ({"rank": -1}, "rank"), ({"rank": 4, "alpha": 0.0}, "alpha"),
    ({"rank": 4, "targets": [""]}, "targets")])
def test_lora_config_validation_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jschema.LoraConfig(**kw)
    with pytest.raises(ValueError, match=match):
        tschema.LoraConfig(**kw)
    assert not tschema.LoraConfig().active
    assert tschema.LoraConfig(rank=8).active


@pytest.mark.parametrize("override,match", [
    ({"aggregation_plane": "sidecar"}, "sidecar"),
    ({"cross_device": {"n_clients": 100}}, "cross_device")])
def test_lora_refusals_as_in_jax(override, match):
    """lora with the sidecar plane and with cross_device raise JAX's
    ``ValueError`` (before the port's own refusal of the socket plane)."""
    raw = {"name": "x", "n_nodes": 2,
           "lora": {"rank": 4, "targets": ["Dense"]}, **override}
    with pytest.raises(ValueError, match=match):
        jschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))
    with pytest.raises(ValueError, match=match):
        tschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))


def test_lora_validates_and_composes_with_staged_overlap():
    """A JAX scenario file with a lora block loads (it raised naming A8
    before the port ran lora), with the staged exchange."""
    raw = {"name": "ok", "n_nodes": 2, "exchange_overlap": "staged",
           "lora": {"rank": 8, "targets": ["query", "value"],
                    "alpha": 16.0}}
    cfg = tschema.ScenarioConfig.from_dict(raw)
    assert cfg.lora.active and cfg.lora.rank == 8 and cfg.lora.alpha == 16.0
    assert cfg.lora.targets == ["query", "value"]
    j = jschema.ScenarioConfig.from_dict(raw)
    again = tschema.ScenarioConfig.from_dict(json.loads(j.to_json()))
    assert again.lora == cfg.lora


# ---------------------------------------------------------------------------
# the federation
# ---------------------------------------------------------------------------


def lora_config(**overrides) -> jschema.ScenarioConfig:
    """``test_torch_vit.vit_config`` (SGD, f32) with rank-4 q/v adapters
    (the registered defaults) and Krum(f=1, m=2). Krum scores each of
    the 4 rows by its distance to its one nearest neighbour, so two
    rows that are each other's nearest tie; with m=3 the third row is
    picked between a tied pair by the last bits of the distances, which
    on this run's adapters the packages break differently."""
    kw = dict(name="lora-parity", lora=jschema.LoraConfig(rank=4),
              aggregator_kwargs={"f": 1, "m": 2})
    kw.update(overrides)
    return vit_config(**kw)


def _carry_base_and_adapters(js, tcfg):
    """The port's Scenario over the JAX base, its adapters set to the
    JAX federation's initial adapters."""
    ts = torch_scenario.Scenario(tcfg, device="cpu",
                                 lora_base=params_from_jax(_np(js.model.base)))
    row0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(row0))
    return ts


def test_lora_federation_matches_jax_in_f32(tmp_path, monkeypatch):
    """2 rounds of the adapter federation from the JAX base and
    adapters: train losses and every adapter leaf within 1e-5 of JAX's
    1-device run, accuracies equal; the state holds adapters only (4
    leaves) and the merged round-0 model is the base."""
    js, ts, jres, tres = run_both(tmp_path, monkeypatch, lora_config(),
                                  carry=_carry_base_and_adapters)
    assert isinstance(ts.model, lora.LoraModel)
    assert len(tree_leaves(ts.fed.states.params)) == 4
    assert len(tree_leaves(ts.fed.states.opt_state)) == 4
    assert_runs_agree(js, ts, jres, tres, rounds=2, tol=LORA_F32_REL_L2)


def test_lora_round_zero_merges_to_the_base_and_the_full_arm(tmp_path):
    """The port's own lora Scenario: its base is the full-weight
    Scenario's round-0 params at the same seed (both drawn by the
    model's init from the seed's generator), so at init the merged
    model equals the full federation's every row bit for bit."""
    cfg = ScenarioConfig.from_dict(json.loads(lora_config().to_json()))
    ts = torch_scenario.Scenario(cfg, device="cpu")
    full = torch_scenario.Scenario(dataclasses.replace(
        cfg, lora=tschema.LoraConfig()), device="cpu")
    merged = ts.model.materialize(ts.fed.states.params)
    for got, want in zip(tree_leaves(merged),
                         tree_leaves(full.fed.states.params), strict=True):
        assert torch.equal(got, want)


def _lora_ckpt_config(directory, rounds=4) -> ScenarioConfig:
    raw = json.loads(lora_config(
        training=jschema.TrainingConfig(rounds=rounds, epochs_per_round=1,
                                        learning_rate=0.05),
        checkpoint_dir=str(directory), checkpoint_every=2).to_json())
    return ScenarioConfig.from_dict(raw)


def test_lora_resume_is_bit_exact(tmp_path):
    """A lora run saving every 2 of 4 rounds, and a fresh Scenario on a
    copy of round 2's file: the adapters, their traces, steps and the
    round-4 file's bytes equal the uninterrupted run's; the file holds
    the adapter tree only."""
    whole = torch_scenario.Scenario(_lora_ckpt_config(tmp_path / "a"),
                                    device="cpu")
    res = whole.run()
    (tmp_path / "b").mkdir()
    shutil.copy(ck.checkpoint_path(tmp_path / "a", 2), tmp_path / "b")
    resumed = torch_scenario.Scenario(_lora_ckpt_config(tmp_path / "b"),
                                      device="cpu")
    assert resumed.fed.round == 2
    res2 = resumed.run(rounds=2)
    for a, b in zip(tree_leaves(whole.fed.states.params)
                    + tree_leaves(whole.fed.states.opt_state),
                    tree_leaves(resumed.fed.states.params)
                    + tree_leaves(resumed.fed.states.opt_state), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(whole.fed.states.step, resumed.fed.states.step)
    assert [h["train_loss"] for h in res.history[2:]] == [
        h["train_loss"] for h in res2.history]
    blob = ck.checkpoint_path(tmp_path / "a", 4).read_bytes()
    assert blob == ck.checkpoint_path(tmp_path / "b", 4).read_bytes()
    params = fser.msgpack_restore(blob)["states"]["params"]
    assert sorted(params) == sorted(whole.model.sites[i].key
                                    for i in range(2))


def test_each_package_loads_the_others_lora_checkpoint(tmp_path, monkeypatch):
    """A JAX lora run's round-2 file (adapters, their traces, rng, step,
    alive, round) loads into the port's lora federation, which saves it
    again to the JAX file's bytes; that port file loads into the JAX
    federation with the bits of JAX's own load of its file."""
    from p2pfl_tpu.federation import scenario as jax_scenario
    from p2pfl_tpu.parallel.transport import MeshTransport

    monkeypatch.setattr(jax_scenario, "MeshTransport",
                        lambda n: MeshTransport(n, n_devices=1))
    jcfg = lora_config(checkpoint_dir=str(tmp_path / "jax"),
                       checkpoint_every=2)
    js = jax_scenario.Scenario(jcfg)
    js.run()
    path = jck.checkpoint_path(tmp_path / "jax", 2)
    ts = torch_scenario.Scenario(
        ScenarioConfig.from_dict(json.loads(lora_config().to_json())),
        device="cpu")
    got = ck.load_checkpoint(path, ts.fed, "sgd")
    assert got.round == 2
    assert sorted(got.states.params) == sorted(s.key for s in ts.model.sites)
    out = ck.save_checkpoint(tmp_path / "port", got, "sgd")
    assert out.read_bytes() == path.read_bytes()
    mine, theirs = (jck.load_checkpoint(p, js.fed) for p in (out, path))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs),
                    strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))
