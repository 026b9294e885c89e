"""The cross-device slice on the CPU: the port against the JAX package
on the same numpy inputs, and against itself.

- Config, sampling, partition and cohort batches are copies of pure
  numpy code: ``array_equal`` with the JAX package's, and the same
  exception type on every refusal (for the config and the sampler, a
  message naming the same field; the sampler's word for word).
- ``build_round_fn_cross_device`` against the JAX package's on
  mnist-mlp and femnist-cnn (hidden 64): heterogeneous client sizes,
  one dead client, batch equal to the shard (so the JAX package's
  threefry permutation only reorders rows inside the one batch). The
  port runs its fused layout (K5's plain version on the CPU); the JAX
  package its ``fused_accumulate=False`` reference. Two tiers, as in
  ``test_torch_federation.py``:
  - f32 compute and f32 wire, after one round: params and momentum
    within rtol 1e-5 / atol 1e-6 (the JAX package's own bound for its
    K5-routed round, whose accumulate is re-associated the same way);
  - bf16 compute and bf16 wire: each side rounds to bf16 at its own
    points, so train loss within rtol 5e-3 and params within relative
    L2 2e-2 per kernel, 1e-1 per bias.
  The chunked arm (``cohort_shards=2``) is held against the JAX
  package's single-device chunked arm, f32 tier.
- The port against itself: fused vs unfused within rtol 1e-5 / atol
  1e-6; ``cohort_size=1`` with every client sampled vs the dense
  fully-connected round within the same; streamed vs materialized bit
  for bit; a dead client carries zero weight bit for bit; an all-dead
  round keeps the params bit for bit.
- ``CrossDeviceScenario`` against the JAX package's on one scenario
  JSON, from the same initial weights, over two rounds: the same draws;
  in f32 (as ``test_torch_federation.py``'s f32 tier) train losses
  within rtol 1e-5, params within relative L2 1e-5 per leaf after round
  1 and 1e-3 after round 2 (one max-pool window flips, see the test),
  equal accuracies; in bf16 the bf16 tier above, round-2 loss within
  rtol 8e-2.

The round-level inputs are image-like, uniform in [0, 1) as the
datasets' normalized pixels are. (With standard-normal inputs the CNN's
f32 gradients reach 30 and cancel, and the two frameworks' conv
summation orders alone put the momentum of single elements 1e-4 apart,
above the f32 bound; the mlp, which has no conv, holds the bound on
standard-normal inputs too.)
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.datasets import data as jdata
from p2pfl_tpu.datasets import partition as jpart
from p2pfl_tpu.federation import sampling as jsampling
from p2pfl_tpu.learning.learner import make_step_fns as jmake_fns
from p2pfl_tpu.models.base import get_model as jget_model
from p2pfl_tpu.parallel import federated as jfed
from p2pfl_tpu_torch.config import schema as tschema
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.datasets import data as tdata
from p2pfl_tpu_torch.datasets import partition as tpart
from p2pfl_tpu_torch.federation import CrossDeviceScenario, Scenario
from p2pfl_tpu_torch.federation import sampling as tsampling
from p2pfl_tpu_torch.learning.learner import make_step_fns as tmake_fns
from p2pfl_tpu_torch.models.base import get_model as tget_model
from p2pfl_tpu_torch.parallel import federated as tfed

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_LOSS_RTOL = (5e-3, 8e-2)  # round 1, round 2
BF16_PARAM_REL_L2 = {"kernel": 2e-2, "bias": 1e-1}
N_SLOTS, SHARD = 4, 8


# ---------------------------------------------------------------------------
# config, sampling, partitions, cohort batches: copies of numpy code
# ---------------------------------------------------------------------------


def _cd(**kw):
    return dict(n_clients=100, clients_per_round=16, cohort_size=4, **kw)


@pytest.mark.parametrize("kw", [
    _cd(), _cd(sampling="weighted", accumulate="unfused", seed=3),
    _cd(cohort_shards=2), _cd(prefetch="stream"), {},
])
def test_cross_device_config_round_trips_the_jax_json(tmp_path, kw):
    jcfg = jschema.ScenarioConfig(
        n_nodes=4, cross_device=jschema.CrossDeviceConfig(**kw))
    path = tmp_path / "s.json"
    jcfg.save(path)
    tcfg = tschema.ScenarioConfig.load(path)
    assert dataclasses.asdict(tcfg.cross_device) == dataclasses.asdict(
        jcfg.cross_device)
    assert tcfg.cross_device.active == jcfg.cross_device.active
    if jcfg.cross_device.active:
        assert tcfg.cross_device.n_slots == jcfg.cross_device.n_slots
    tcfg.save(tmp_path / "t.json")
    again = tschema.ScenarioConfig.load(tmp_path / "t.json")
    assert again.cross_device == tcfg.cross_device


@pytest.mark.parametrize("kw", [
    dict(n_clients=100, clients_per_round=10, cohort_size=3),
    dict(n_clients=100, clients_per_round=10, cohort_size=5,
         sampling="magic"),
    dict(n_clients=10, clients_per_round=20, cohort_size=2),
    dict(n_clients=100, clients_per_round=10, cohort_size=5,
         cohort_shards=3),
    dict(n_clients=100, clients_per_round=10, cohort_size=5,
         prefetch="magic"),
    dict(n_clients=100, clients_per_round=16, cohort_size=4,
         cohort_shards=2, prefetch="stream"),
    dict(n_clients=100, clients_per_round=16, cohort_size=4,
         accumulate="magic"),
    dict(n_clients=-1), dict(n_clients=10, clients_per_round=0),
    dict(cohort_shards=0),
])
def test_cross_device_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        jschema.CrossDeviceConfig(**kw)
    with pytest.raises(ValueError) as got:
        tschema.CrossDeviceConfig(**kw)
    # the same check fired: both messages open with the field they name
    assert str(got.value).split()[0] == str(want.value).split()[0]


@pytest.mark.parametrize("override", [
    {"adversary": {"kind": "signflip", "fraction": 0.25}},
    {"adversary": {"reputation": True}},
    {"exchange_overlap": "staged"},
    {"transport": "sparse"},
    {"aggregation_plane": "sidecar"},
    {"lora": {"rank": 4, "targets": ["Dense"]}},
    {"privacy": {"dp": True}},
])
def test_cross_device_compositions_refused_as_in_jax(override):
    """Combinations the JAX schema refuses with cross-device raise the
    same ``ValueError`` before the port's own unported-section checks."""
    raw = {"n_nodes": 4, "cross_device": _cd(), **override}
    with pytest.raises(ValueError):
        jschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))
    with pytest.raises(ValueError):
        tschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))


def test_faults_stay_refused_with_cross_device():
    """Cross-device faults are accepted (the name is kept from when they
    were refused) and the membership over every virtual client matches
    the JAX package's: the same alive mask over four rounds of a crash
    at round 0 and a join at round 2, at the stacked scenario's
    default heartbeat clock."""
    from p2pfl_tpu.federation.membership import Membership as JMembership
    from p2pfl_tpu_torch.federation.membership import Membership

    faults = ([{"node": i, "round": 0, "kind": "crash"} for i in range(5)]
              + [{"node": i, "round": 2, "kind": "join"} for i in (1, 3)])
    raw = {"n_nodes": 4, "cross_device": _cd(), "faults": faults,
           "protocol": {"heartbeat_period_s": 4.0, "node_timeout_s": 3.0}}
    tcfg = tschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))
    jcfg = jschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))
    for key in ("faults", "protocol", "cross_device"):
        assert (dataclasses.asdict(tcfg)[key]
                == dataclasses.asdict(jcfg)[key]), key
    n = tcfg.cross_device.n_clients
    tm, jm = Membership(n, tcfg.protocol), JMembership(n, jcfg.protocol)
    for r in range(4):
        for tf, jf in zip(tcfg.faults, jcfg.faults):
            if tf.round == r:
                tm.apply_fault(tf)
                jm.apply_fault(jf)
        t = (r + 1) * tcfg.protocol.heartbeat_period_s
        np.testing.assert_array_equal(tm.advance_to(t), jm.advance_to(t))
    assert tm.get_nodes() == jm.get_nodes()
    assert not tm.alive[[0, 2, 4]].any() and tm.alive[[1, 3, 5]].all()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("weighted", [False, True])
def test_sampling_matches_jax(seed, weighted):
    n = 500
    w = (np.random.default_rng(seed).integers(0, 5, n).astype(np.float64)
         if weighted else None)
    for r in (0, 1, 9):
        assert np.array_equal(
            tsampling.sample_clients(n, 40, r, seed=seed, weights=w),
            jsampling.sample_clients(n, 40, r, seed=seed, weights=w))
        ts, tc = tsampling.sample_cohorts(n, 40, 8, r, seed=seed, weights=w)
        js, jc = jsampling.sample_cohorts(n, 40, 8, r, seed=seed, weights=w)
        assert np.array_equal(ts, js) and np.array_equal(tc, jc)
        assert tc.shape == (8, 5) and len(set(ts.tolist())) == 40


@pytest.mark.parametrize("args,kw", [
    ((10, 0, 0), {}), ((10, 11, 0), {}),
    ((10, 3, 0), {"weights": np.ones(9)}),
    ((10, 3, 0), {"weights": -np.ones(10)}),
    ((10, 3, 0), {"weights": np.zeros(10)}),
    ((10, 3, 0), {"weights": np.r_[np.ones(2), np.zeros(8)]}),
    ((10, 3, 0), {"weights": np.r_[np.nan, np.ones(9)]}),
])
def test_sampling_fails_loud_like_jax(args, kw):
    with pytest.raises(ValueError) as want:
        jsampling.sample_clients(*args, **kw)
    with pytest.raises(ValueError) as got:
        tsampling.sample_clients(*args, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="multiple of cohort_size"):
        tsampling.sample_cohorts(10, 6, 4, 0)


@pytest.mark.parametrize("scheme,n_samples,n_clients", [
    ("iid", 3000, 700), ("sorted", 3000, 700), ("dirichlet", 3000, 40),
    ("dirichlet", 3000, 700),  # >= 512: the vectorized draw
    ("dirichlet", 1500, 1000),  # sparse: the deterministic repair
])
def test_lazy_partition_matches_jax(scheme, n_samples, n_clients):
    labels = np.random.default_rng(1).integers(0, 10, n_samples)
    want = jpart.lazy_partition_indices(labels, n_clients, scheme, seed=2)
    got = tpart.lazy_partition_indices(labels, n_clients, scheme, seed=2)
    assert np.array_equal(got.order, want.order)
    assert np.array_equal(got.offsets, want.offsets)
    assert got.n_clients == n_clients and got.sizes().min() >= 1
    ids = np.array([[0, 5], [n_clients - 1, 3]])
    assert np.array_equal(got.take_sizes(ids), want.take_sizes(ids))
    assert np.array_equal(got.client_indices(3), want.client_indices(3))


def test_lazy_partition_fails_loud_like_jax():
    labels = np.zeros(100, np.int64)
    for scheme, n in (("iid", 200), ("dirichlet", 101), ("magic", 10)):
        with pytest.raises((ValueError, RuntimeError)) as want:
            jpart.lazy_partition_indices(labels, n, scheme)
        with pytest.raises(type(want.value)) as got:
            tpart.lazy_partition_indices(labels, n, scheme)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("partition", ["iid", "dirichlet"])
def test_cross_device_data_matches_jax(partition):
    kw = dict(dataset="mnist", partition=partition, synthetic_train=1200,
              synthetic_test=64, samples_per_node=6, seed=4)
    want = jdata.CrossDeviceData.make(jschema.DataConfig(**kw), 150)
    got = tdata.CrossDeviceData.make(tschema.DataConfig(**kw), 150)
    assert got.shard_size == want.shard_size
    assert np.array_equal(got.client_sizes, want.client_sizes)
    ids = np.array([3, 149, 0, 77, 12])
    assert np.array_equal(got.cohort_sizes(ids), want.cohort_sizes(ids))
    fresh = got.cohort_batch(ids)
    bufs = got.cohort_buffers(len(ids))
    bufs[0][:] = 7.0  # stale contents must not leak through
    reused = got.cohort_batch(ids, out=bufs)
    for a, b, c in zip(fresh, reused, want.cohort_batch(ids)):
        assert np.array_equal(a, c) and np.array_equal(b, c)


# ---------------------------------------------------------------------------
# the round function against the JAX package's
# ---------------------------------------------------------------------------


def _models(name: str, compute: str):
    kw = {"hidden": 64} if name == "femnist-cnn" else {}
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return (jget_model(name, dtype=jdt, **kw),
            tget_model(name, dtype=tdt, **kw))


def _cohort_data(seed: int, c: int, classes: int = 10):
    rng = np.random.default_rng(seed)
    x = rng.random((c, N_SLOTS, SHARD, 28, 28, 1), np.float32)
    y = rng.integers(0, classes, (c, N_SLOTS, SHARD)).astype(np.int32)
    sizes = rng.integers(3, SHARD + 1, (c, N_SLOTS)).astype(np.int32)
    mask = np.arange(SHARD)[None, None, :] < sizes[..., None]
    alive = np.ones((c, N_SLOTS), bool)
    alive[c // 2, 2] = False  # a sampled-but-dead client
    return x, y, mask, sizes, alive


def _by_path(tree) -> dict:
    """{dict-key path: numpy leaf}: JAX trees (optax state included) and
    the port's nested dicts alike."""
    if isinstance(tree, dict):
        return {(k,) + p: v for k, sub in tree.items()
                for p, v in _by_path(sub).items()}
    if isinstance(tree, torch.Tensor):
        return {(): tree.detach().float().numpy()}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(k.key for k in path
                     if isinstance(k, jax.tree_util.DictKey))
        out[keys] = np.asarray(leaf, np.float32)
    return out


def _rounds(name, compute, c, cohort_shards=1, wire=None, seed=0):
    """One round of the JAX reference (unfused) and of the port (fused,
    K5's plain version) from the same initial params; returns the
    trained states as {path: array} pairs and the loss pairs."""
    jm, tm = _models(name, compute)
    classes = 62 if name == "femnist-cnn" else 10
    x, y, mask, sizes, alive = _cohort_data(seed, c, classes)
    jf = jmake_fns(jm, batch_size=SHARD, learning_rate=0.05)
    jstate = jfed.init_federation(jf, jnp.asarray(x[0, 0, :1]), N_SLOTS)
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], jstate.states.params)
    jround = jax.jit(jfed.build_round_fn_cross_device(
        jf, epochs=2, exchange_dtype=jnp.bfloat16 if wire else None,
        fused_accumulate=False, cohort_shards=cohort_shards))
    jout, jm_ = jround(jstate, x, y, mask, sizes, alive)

    tf = tmake_fns(tm, batch_size=SHARD, learning_rate=0.05)
    tstate = tfed.init_federation(tf, torch.from_numpy(x[0, 0, :1]),
                                  N_SLOTS)
    tstate = tfed.reseed_params(tstate, tf, params_from_jax(p0))
    tround = tfed.build_round_fn_cross_device(
        tf, epochs=2, exchange_dtype=torch.bfloat16 if wire else None,
        fused_accumulate=True, cohort_shards=cohort_shards)
    tout, tm_ = tround(tstate, *(torch.from_numpy(a)
                                 for a in (x, y, mask, sizes, alive)))
    assert tout.round == 1 and tuple(tm_["train_loss"].shape) == (c, N_SLOTS)
    return ((_by_path(jout.states.params), _by_path(tout.states.params)),
            (_by_path(jout.states.opt_state),
             _by_path(tout.states.opt_state)),
            (np.asarray(jm_["train_loss"]), tm_["train_loss"].numpy()))


def _assert_tree_close(pair, **tol):
    want, got = pair
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


@pytest.mark.parametrize("name,c,shards", [("mnist-mlp", 2, 1),
                                           ("femnist-cnn", 2, 1),
                                           ("mnist-mlp", 4, 2)])
def test_round_fn_matches_jax_in_f32(name, c, shards):
    params, momentum, losses = _rounds(name, "f32", c, shards)
    _assert_tree_close(params, **F32_TOL)
    _assert_tree_close(momentum, **F32_TOL)
    np.testing.assert_allclose(losses[1], losses[0], **F32_TOL)


def test_round_fn_matches_jax_in_bf16():
    """The card's arithmetic: bf16 compute, bf16 wire (bf16 p into K5)."""
    (jp, tp), _, (jl, tl) = _rounds("femnist-cnn", "bf16", 2, wire=True)
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL[0])
    for k in jp:
        rel = np.linalg.norm(tp[k] - jp[k]) / np.linalg.norm(jp[k])
        assert rel < BF16_PARAM_REL_L2[k[-1]], (k, rel)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


def _port_round(c, seed=0, **kw):
    x, y, mask, sizes, alive = (torch.from_numpy(a)
                                for a in _cohort_data(seed, c))
    _, tm = _models("mnist-mlp", "f32")
    tf = tmake_fns(tm, batch_size=SHARD, learning_rate=0.05)
    state = tfed.init_federation(tf, x[0, 0, :1], N_SLOTS, seed=3)
    return tf, state, (x, y, mask, sizes, alive), kw


def test_fused_matches_unfused():
    tf, state, data, _ = _port_round(3)
    out = {}
    for fused in (True, False):
        fed = dataclasses.replace(state, states=dataclasses.replace(
            state.states, rng=torch.Generator().manual_seed(9)))
        rf = tfed.build_round_fn_cross_device(tf, fused_accumulate=fused)
        out[fused], _ = rf(fed, *data)
    for a, b in ((out[True].states.params, out[False].states.params),
                 (out[True].states.opt_state, out[False].states.opt_state)):
        _assert_tree_close((_by_path(b), _by_path(a)), **F32_TOL)


def test_one_cohort_all_sampled_matches_the_dense_round():
    """cohort_size 1, every client sampled: the cross-device round is the
    dense fully-connected FedAvg round."""
    tf, state, (x, y, mask, sizes, _), _ = _port_round(1)
    alive = torch.ones(1, N_SLOTS, dtype=torch.bool)
    dense = tfed.build_round_fn(tf, epochs=2, identity_adopt=True)
    fed_d = dataclasses.replace(state, states=dataclasses.replace(
        state.states, rng=torch.Generator().manual_seed(1)))
    fed_d, _ = dense(fed_d, x[0], y[0], mask[0], sizes[0],
                     torch.ones(N_SLOTS, N_SLOTS),
                     torch.arange(N_SLOTS), torch.ones(N_SLOTS, dtype=bool))
    for fused in (True, False):
        fed_c = dataclasses.replace(state, states=dataclasses.replace(
            state.states, rng=torch.Generator().manual_seed(1)))
        cross = tfed.build_round_fn_cross_device(tf, epochs=2,
                                                 fused_accumulate=fused)
        fed_c, _ = cross(fed_c, x, y, mask, sizes, alive)
        _assert_tree_close((_by_path(fed_d.states.params),
                            _by_path(fed_c.states.params)), **F32_TOL)
        _assert_tree_close((_by_path(fed_d.states.opt_state),
                            _by_path(fed_c.states.opt_state)), **F32_TOL)


def test_dead_client_carries_zero_weight():
    """The round with client (1, 2) dead equals the round where its size
    is 0 and its shard garbage, bit for bit; its weight is 0."""
    tf, state, (x, y, mask, sizes, alive), _ = _port_round(2)
    wn, got_any = tfed.cross_device_wn(sizes, alive)
    assert wn[1, 2] == 0 and bool(got_any)
    torch.testing.assert_close(wn.sum(), torch.tensor(1.0))
    rf = tfed.build_round_fn_cross_device(tf, epochs=1)

    def run(xx, ss):
        fed = dataclasses.replace(state, states=dataclasses.replace(
            state.states, rng=torch.Generator().manual_seed(2)))
        return rf(fed, xx, y, mask, ss, alive)[0]

    x_b, sizes_b = x.clone(), sizes.clone()
    x_b[1, 2] = 999.0
    sizes_b[1, 2] = 0
    a, b = run(x, sizes), run(x_b, sizes_b)
    for k, v in _by_path(a.states.params).items():
        assert np.array_equal(v, _by_path(b.states.params)[k]), k


def test_all_dead_round_keeps_the_global_model():
    tf, state, (x, y, mask, sizes, _), _ = _port_round(2)
    dead = torch.zeros(2, N_SLOTS, dtype=torch.bool)
    for fused in (True, False):
        rf = tfed.build_round_fn_cross_device(tf, fused_accumulate=fused)
        out, _ = rf(state, x, y, mask, sizes, dead)
        for k, v in _by_path(state.states.params).items():
            assert np.array_equal(_by_path(out.states.params)[k], v), k
        assert torch.equal(out.states.step, state.states.step)


def _scenario_raw(compute_f32: bool, **cd) -> dict:
    jcfg = jschema.ScenarioConfig(
        name="crossdev-parity", n_nodes=4,
        data=jschema.DataConfig(dataset="femnist", synthetic_train=2000,
                                synthetic_test=96, samples_per_node=SHARD,
                                batch_size=SHARD),
        model=jschema.ModelConfig(
            model="femnist-cnn", kwargs={"hidden": 64},
            compute_dtype="float32" if compute_f32 else None),
        training=jschema.TrainingConfig(rounds=2, epochs_per_round=2,
                                        learning_rate=0.05, eval_every=0),
        cross_device=jschema.CrossDeviceConfig(
            n_clients=64, clients_per_round=4 * N_SLOTS, cohort_size=4,
            seed=1, **cd),
        wire_dtype="f32" if compute_f32 else "bf16",
    )
    return json.loads(jcfg.to_json())


def _port_config(raw: dict) -> tschema.ScenarioConfig:
    return tschema.ScenarioConfig.from_dict(json.loads(json.dumps(raw)))


def test_streamed_round_equals_materialized_bit_for_bit():
    raw = _scenario_raw(True)
    raw["model"] = {"model": "mlp"}
    raw["data"]["dataset"] = "mnist"
    cfg_off = tschema.ScenarioConfig.from_dict(raw)
    raw["cross_device"]["prefetch"] = "stream"
    cfg_on = tschema.ScenarioConfig.from_dict(raw)
    off = CrossDeviceScenario(cfg_off, device="cpu")
    on = CrossDeviceScenario(cfg_on, dataset=off.data, device="cpu")
    for _ in range(2):
        a, b = off.run(rounds=1), on.run(rounds=1)
        assert a.history[0]["train_loss"] == b.history[0]["train_loss"]
        for tree in ("params", "opt_state"):
            pa = _by_path(getattr(off.fed.states, tree))
            pb = _by_path(getattr(on.fed.states, tree))
            for k in pa:
                assert np.array_equal(pa[k], pb[k]), (tree, k)
        assert np.array_equal(off.last_cohorts, on.last_cohorts)
    assert on.crossdev_last["crossdev_prefetch_mb"] > 0
    assert on.crossdev_last["crossdev_prefetch_stall_s"] >= 0


def test_scenario_classes_refuse_the_wrong_regime():
    cd_cfg = tschema.ScenarioConfig.from_dict(
        {"n_nodes": 4, "cross_device": _cd()})
    with pytest.raises(ValueError, match="CrossDeviceScenario"):
        Scenario(cd_cfg, device="cpu")
    with pytest.raises(ValueError, match="n_clients"):
        CrossDeviceScenario(tschema.ScenarioConfig(n_nodes=4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CrossDeviceScenario(cd_cfg)


# ---------------------------------------------------------------------------
# the slice as a whole: CrossDeviceScenario against the JAX package's
# ---------------------------------------------------------------------------


def _rel_l2(js, ts) -> dict:
    jp = _by_path(js.fed.states.params)
    tp = _by_path(params_to_numpy(ts.fed.states.params))
    return {k: np.linalg.norm(tp[k] - jp[k]) / np.linalg.norm(jp[k])
            for k in jp}


@pytest.mark.parametrize("compute_f32", [True, False])
def test_scenario_matches_jax(tmp_path, compute_f32):
    from p2pfl_tpu.federation.scenario import (
        CrossDeviceScenario as JaxCrossDeviceScenario,
    )

    raw = _scenario_raw(compute_f32)
    js = JaxCrossDeviceScenario(jschema.ScenarioConfig.from_dict(raw))
    ts = CrossDeviceScenario(_port_config(raw), device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = tfed.reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    jl, tl, rel = [], [], []
    for _ in range(2):
        jres, tres = js.run(rounds=1), ts.run(rounds=1)
        assert np.array_equal(ts.last_sampled, js.last_sampled)
        assert np.array_equal(ts.last_cohorts, js.last_cohorts)
        # the JAX logger's history spans every run so far
        jl.append([r["Train/loss"] for r in jres.history
                   if "Train/loss" in r][-1])
        tl.append(tres.history[0]["Train/loss"])
        rel.append(_rel_l2(js, ts))
    if compute_f32:
        np.testing.assert_allclose(tl, jl, rtol=F32_TOL["rtol"])
        assert max(rel[0].values()) < F32_TOL["rtol"], rel[0]
        # round 2 trains one client (cohort step 2, slot 3) whose conv2
        # outputs have a 2x2 pooling window with its top two within
        # 3.5e-7; the two frameworks' f32 conv sums differ by up to
        # 1.9e-6, so the max flips and that pooling gradient goes to the
        # neighbouring pixel: the params move 1.9e-4 apart (relative L2)
        assert max(rel[1].values()) < 1e-3, rel[1]
        # the same count of the 96 test images right (the two sides
        # divide in different precisions)
        assert abs(tres.final_accuracy - jres.final_accuracy) < 0.5 / 96
    else:
        np.testing.assert_allclose(tl[0], jl[0], rtol=BF16_LOSS_RTOL[0])
        np.testing.assert_allclose(tl[1], jl[1], rtol=BF16_LOSS_RTOL[1])
        for k, r in rel[1].items():
            assert r < BF16_PARAM_REL_L2[k[-1]], (k, r)


def _jax_adam_state(opt_state):
    """The ``ScaleByAdamState`` inside a JAX optax chain's state."""
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda t: hasattr(t, "mu")) if hasattr(s, "mu"))


def test_scenario_with_adam_matches_jax():
    """Two cross-device rounds with adam (lr 1e-3), f32 compute and wire,
    from the same weights: the cohort carry holds adam's ``(count, mu,
    nu)`` across cohort steps and slots as the JAX package's does. Each
    round: the loss, and each leaf of the params, ``mu`` and ``nu`` (as
    relative L2), at the f32 tier; ``count`` exact."""
    from p2pfl_tpu.federation.scenario import (
        CrossDeviceScenario as JaxCrossDeviceScenario,
    )
    from p2pfl_tpu_torch.convert import adam_state_from_optax

    raw = _scenario_raw(True)
    raw["training"].update(optimizer="adam", learning_rate=1e-3)
    js = JaxCrossDeviceScenario(jschema.ScenarioConfig.from_dict(raw))
    ts = CrossDeviceScenario(_port_config(raw), device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = tfed.reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    for _ in range(2):
        jres, tres = js.run(rounds=1), ts.run(rounds=1)
        assert np.array_equal(ts.last_cohorts, js.last_cohorts)
        jl = [r["Train/loss"] for r in jres.history if "Train/loss" in r][-1]
        np.testing.assert_allclose(tres.history[0]["Train/loss"], jl,
                                   rtol=F32_TOL["rtol"])
        rel = _rel_l2(js, ts)
        assert max(rel.values()) < F32_TOL["rtol"], rel
        jadam = adam_state_from_optax(jax.tree.map(
            np.asarray, _jax_adam_state(js.fed.states.opt_state)))
        tadam = ts.fed.states.opt_state
        assert torch.equal(tadam.count, jadam.count)
        for name in ("mu", "nu"):
            jt = _by_path(getattr(jadam, name))
            tt = _by_path(getattr(tadam, name))
            assert set(jt) == set(tt)
            for k in jt:
                r = np.linalg.norm(tt[k] - jt[k]) / np.linalg.norm(jt[k])
                assert r < F32_TOL["rtol"], (name, k, r)
