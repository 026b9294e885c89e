"""Checkpoint and resume across both packages, on the CPU.

- The port's msgpack codec (``utils/msgpack_codec.py``) against
  ``msgpack.packb`` / ``unpackb`` and ``flax.serialization``, byte for
  byte: every int width and sign, the str / bin / array / map length
  classes, nil, bools, floats, the ndarray ext for each dtype a
  checkpoint holds (bfloat16 as raw words), numpy scalars, and the
  chunked form with ``MAX_CHUNK_SIZE`` lowered on both sides.
- Files across packages, for sgd, sgd with weight decay, adam, adamw and
  a bf16 trace, the staged buffer on and off: a JAX-written file loads
  into the port with every leaf bit-exact (the rng slot included), a
  port-written file loads through JAX's ``load_checkpoint`` bit-exactly,
  and a state carried over with ``convert.federated_state_from_jax``
  saves to the JAX file's bytes, a chunked leaf included.
- Resume across packages: JAX runs 2 rounds and the port resumes for 1,
  and the other way round, each held to the other package's
  uninterrupted round 3 in the f32 tier of ``test_torch_federation.py``
  (one batch an epoch, so the two packages' shuffles only reorder a
  batch's rows): losses and params within rtol 1e-5, accuracies equal.
- The port's own resume: bit-exact (params, trace, step, alive, round,
  the next file's bytes) with several steps an epoch, so the shuffle
  generator must be restored; SDFL with faults (leaders and alive
  masks); a dead node stays dead; a truncated newest file is passed
  over; a shape mismatch raises ValueError naming the leaf.
"""

from __future__ import annotations

import dataclasses
import shutil

import flax.serialization as fser
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation import checkpoint as jck
from p2pfl_tpu.federation.scenario import Scenario as JaxScenario
from p2pfl_tpu.learning.learner import make_step_fns as jax_step_fns
from p2pfl_tpu.models.base import build_model as jax_build_model
from p2pfl_tpu.parallel import federated as jfed
from p2pfl_tpu_torch import convert
from p2pfl_tpu_torch.config.schema import (
    DataConfig,
    FaultEvent,
    ModelConfig,
    ProtocolConfig,
    ScenarioConfig,
    TrainingConfig,
)
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map
from p2pfl_tpu_torch.federation import checkpoint as ck
from p2pfl_tpu_torch.federation.scenario import Scenario
from p2pfl_tpu_torch.learning.learner import AdamState, make_step_fns
from p2pfl_tpu_torch.models.base import build_model
from p2pfl_tpu_torch.parallel.federated import (
    init_federation,
    with_staged_buffer,
)
from p2pfl_tpu_torch.utils import msgpack_codec as mc

F32_RTOL = 1e-5
N = 3

# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
         2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
         -2**31, -2**31 - 1, -2**63]
_OTHERS = {
    "nil": None, "true": True, "false": False, "float": 0.1,
    "float_neg": -1.5e300, "fixstr": "a" * 31, "str8": "b" * 32,
    "str8_max": "c" * 255, "str16": "d" * 256, "str32": "e" * 65536,
    "utf8": "é✓", "bin_empty": b"", "bin8": b"x" * 255, "bin16": b"y" * 256,
    "bin32": b"z" * 65536, "fixarray": list(range(15)),
    "array16": list(range(16)), "array32": list(range(65536)),
    "fixmap": {str(i): i for i in range(15)},
    "map16": {str(i): i for i in range(16)},
    "map32": {str(i): None for i in range(65536)},
    "nested": {"b": [1, {"c": None}], "a": (2.5, "x")},
}


@pytest.mark.parametrize("value", _INTS + list(_OTHERS.values()),
                         ids=[f"int{v}" for v in _INTS] + list(_OTHERS))
def test_codec_packs_like_msgpack(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert mc.packb(value) == want
    assert mc.unpackb(want) == msgpack.unpackb(want, raw=False)


_ARRAYS = {
    "float32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "float64": np.linspace(-3, 3, 5),
    "int32": np.arange(-4, 5, dtype=np.int32),
    "int64": np.arange(5, dtype=np.int64) * 2**40,
    "uint32": np.array([0, 1, 2**32 - 1], np.uint32),
    "bool": np.array([[True, False, True]]),
    "bfloat16": np.linspace(-2, 2, 7).astype(ml_dtypes.bfloat16),
    "zero_d": np.array(7, np.int32),
    "empty": np.zeros((0, 3), np.float32),
    "ext32_payload": np.arange(20000, dtype=np.float32),
}


@pytest.mark.parametrize("name", sorted(_ARRAYS))
def test_codec_arrays_like_flax(name):
    """The ndarray ext (and a numpy scalar's) in a tree: the bytes of
    ``msgpack_serialize``, and ``msgpack_restore``'s values back."""
    a = _ARRAYS[name]
    tree = {"z": a, "a": {"k": a, "s": np.int32(3)}, "r": np.float32(2.5)}
    want = fser.msgpack_serialize(tree)
    assert mc.serialize(tree) == want
    got = mc.restore(want)
    if name == "bfloat16":
        assert isinstance(got["z"], mc.BF16Array)
        np.testing.assert_array_equal(np.asarray(got["a"]["k"]),
                                      a.view(np.uint16))
        words = a.view(np.uint16).view(mc.BF16Array)
        assert mc.serialize({**tree, "z": words,
                             "a": {"k": words, "s": np.int32(3)}}) == want
    else:
        assert got["z"].dtype == a.dtype
        np.testing.assert_array_equal(got["a"]["k"], a)
    assert got["a"]["s"] == 3 and isinstance(got["a"]["s"], np.int32)
    assert got["r"] == np.float32(2.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bool"])
def test_codec_chunks_like_flax(monkeypatch, dtype):
    """Leaves over ``MAX_CHUNK_SIZE`` (lowered to 64 bytes on both
    sides) as flax cuts them, in a map, at the top and not in a list;
    restored whole."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(mc, "MAX_CHUNK_SIZE", 64)
    a = np.arange(150).reshape(10, 15) % 7 > 2 if dtype == "bool" else (
        np.arange(150, dtype=np.float32).reshape(10, 15).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32))
    tree = {"w": a, "n": {"x": a, "small": a[0, :3], "y": [a]}}
    want = fser.msgpack_serialize(tree)
    assert mc.serialize(tree) == want
    assert mc.serialize(a) == fser.msgpack_serialize(a)
    got = mc.restore(want)
    words = np.asarray(got["n"]["x"])
    np.testing.assert_array_equal(
        words, a.view(np.uint16) if dtype == "bfloat16" else a)
    assert words.shape == a.shape


def test_codec_refuses_truncated_and_trailing_bytes():
    blob = mc.serialize({"a": np.arange(10, dtype=np.float32)})
    with pytest.raises(ValueError, match="ends early"):
        mc.restore(blob[:-3])
    with pytest.raises(ValueError, match="extra data"):
        mc.restore(blob + b"\x00")


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------

# (optimizer, weight decay, momentum dtype)
OPTIMIZERS = {"sgd": ("sgd", 0.0, None), "sgd_wd": ("sgd", 1e-4, None),
              "adam": ("adam", 0.0, None), "adamw": ("adamw", 1e-2, None),
              "sgd_bf16_trace": ("sgd", 0.0, "bf16")}
CASES = [(k, s) for k in OPTIMIZERS for s in (False, True)]
CASE_IDS = [f"{k}-{'staged' if s else 'eager'}" for k, s in CASES]


def _jax_fed(opt: str, staged: bool, seed: int):
    """A JAX FederatedState of N mnist-mlp nodes, every leaf replaced by
    seeded values of its dtype and shape."""
    name, wd, mdt = OPTIMIZERS[opt]
    fns = jax_step_fns(jax_build_model(jschema.ModelConfig(model="mnist-mlp")),
                       optimizer=name, weight_decay=wd, momentum_dtype=mdt)
    fed = jfed.init_federation(fns, jnp.zeros((1, 28, 28, 1)), N)
    if staged:
        fed = jfed.with_staged_buffer(fed)
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == bool:
            v = rng.random(a.shape) < 0.7
        elif a.dtype.kind in "iu":
            v = rng.integers(0, 2**31 if a.dtype.kind == "i" else 2**32,
                             a.shape)
        else:
            v = rng.standard_normal(a.shape)
        return jnp.asarray(np.asarray(v).astype(a.dtype))

    return jax.tree.map(leaf, fed)


def _template(opt: str, staged: bool) -> tuple:
    name, wd, mdt = OPTIMIZERS[opt]
    fns = make_step_fns(build_model(ModelConfig(model="mnist-mlp")),
                        optimizer=name, weight_decay=wd, momentum_dtype=mdt)
    fed = init_federation(fns, torch.zeros(1, 28, 28, 1), N, seed=5)
    return (with_staged_buffer(fed) if staged else fed), name


def _port_fed(opt: str, staged: bool, seed: int):
    """The port's template with every tensor replaced by seeded values,
    and a fresh seeded generator."""
    fed, name = _template(opt, staged)
    rng = np.random.default_rng(seed)

    def leaf(t):
        if t.dtype == torch.bool:
            return torch.from_numpy(rng.random(tuple(t.shape)) < 0.7)
        if not t.is_floating_point():
            return torch.from_numpy(
                rng.integers(0, 2**31, tuple(t.shape))).to(t.dtype)
        return torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(t.dtype)

    st = fed.states
    opt_state = (tree_map(leaf, st.opt_state) if name == "sgd"
                 else AdamState(count=leaf(st.opt_state.count),
                                mu=tree_map(leaf, st.opt_state.mu),
                                nu=tree_map(leaf, st.opt_state.nu)))
    states = dataclasses.replace(
        st, params=tree_map(leaf, st.params), opt_state=opt_state,
        rng=torch.Generator().manual_seed(seed), step=leaf(st.step))
    stale = (None if fed.stale is None
             else (tree_map(leaf, fed.stale[0]), leaf(fed.stale[1])))
    return dataclasses.replace(fed, states=states, alive=leaf(fed.alive),
                               round=int(rng.integers(0, 1000)),
                               stale=stale), name


def _bits(x) -> tuple:
    """A leaf's shape, its dtype's kind and bytes (bf16 as words)."""
    if isinstance(x, torch.Tensor):
        x = ck._host(x)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.uint16)
    return x.shape, x.tobytes()


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        assert _bits(a) == _bits(b), path


def _jax_sd(fed) -> dict:
    return fser.to_state_dict(jax.tree.map(np.asarray, fed))


@pytest.mark.parametrize("opt,staged", CASES, ids=CASE_IDS)
def test_jax_file_loads_into_the_port(tmp_path, opt, staged):
    jf = _jax_fed(opt, staged, seed=1)
    path = jck.save_checkpoint(tmp_path, jf)
    template, name = _template(opt, staged)
    got = ck.load_checkpoint(path, template, name)
    assert got.states.step.dtype == torch.int64
    # the generator, seeded from the file's keys, gives the slot back
    _assert_same_tree(ck.to_state_dict(got, name), _jax_sd(jf))
    assert got.round == int(jf.round)


@pytest.mark.parametrize("opt,staged", CASES, ids=CASE_IDS)
def test_port_file_loads_into_jax(tmp_path, opt, staged):
    pf, name = _port_fed(opt, staged, seed=2)
    path = ck.save_checkpoint(tmp_path, pf, name)
    assert path.name == f"round_{pf.round:05d}.ckpt.msgpack"
    assert list(tmp_path.iterdir()) == [path]  # no tmp file left
    template = _jax_fed(opt, staged, seed=3)
    got = jck.load_checkpoint(path, template)
    _assert_same_tree(_jax_sd(got), ck.to_state_dict(pf, name))


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("opt,staged", CASES, ids=CASE_IDS)
def test_carried_state_writes_the_jax_bytes(tmp_path, monkeypatch, opt,
                                            staged, chunked):
    """A JAX state carried over with ``convert.federated_state_from_jax``
    saves to the bytes JAX's ``save_checkpoint`` writes; ``chunked``
    lowers ``MAX_CHUNK_SIZE`` on both sides to 64 KiB, under the first
    dense kernel (3 x 784 x 256 values)."""
    if chunked:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 2**16)
        monkeypatch.setattr(mc, "MAX_CHUNK_SIZE", 2**16)
    jf = _jax_fed(opt, staged, seed=4)
    template, name = _template(opt, staged)
    pf = convert.federated_state_from_jax(_jax_sd(jf), template, name)
    jpath = jck.save_checkpoint(tmp_path / "jax", jf)
    ppath = ck.save_checkpoint(tmp_path / "port", pf, name)
    blob = jpath.read_bytes()
    assert (b"__msgpack_chunked_array__" in blob) == chunked
    assert ppath.read_bytes() == blob
    # and the saved state saves to the same bytes again
    assert ck.save_checkpoint(tmp_path / "again", pf, name).read_bytes() == blob


def test_model_blobs_match_jax():
    """``pack_model`` (the join handshake's payload) writes JAX's bytes
    for f32 and bf16 trees; each package unpacks the other's."""
    rng = np.random.default_rng(6)
    tree = {"params": {"Dense_0": {
        "kernel": rng.standard_normal((4, 3)).astype(np.float32),
        "bias": rng.standard_normal(3).astype(ml_dtypes.bfloat16)}}}
    port_tree = convert.params_from_jax(tree)
    blob = ck.pack_model(port_tree, 7)
    assert blob == jck.pack_model(tree, 7)
    got, r = ck.unpack_model(blob, port_tree)
    assert r == 7
    _assert_same_tree(got, port_tree)
    jgot, jr = jck.unpack_model(blob, tree)
    assert jr == 7
    _assert_same_tree(port_tree, jgot)


# ---------------------------------------------------------------------------
# resume across packages (the f32 tier)
# ---------------------------------------------------------------------------

SHARD = 18  # 20 samples a node less the 10% validation split


def _f32_config(directory) -> jschema.ScenarioConfig:
    """The f32 tier's ring at seed 1. The two packages shuffle a batch's
    rows differently, so its sums differ in order; at seed 0 one of node
    0's ReLU or max-pool decisions in round 3 lies within that rounding
    of its tie and the port-to-JAX resume takes it the other way (node
    0's loss 1.1e-3 apart, its ring neighbours' params 1e-4, the fourth
    node's 1.7e-7): the flip of any two sum orders that ROADMAP's f32
    notes describe, not a file fault (the files load bit for bit,
    above)."""
    return jschema.ScenarioConfig(
        name="resume-f32", federation="DFL", topology="ring", n_nodes=4,
        seed=1,
        data=jschema.DataConfig(dataset="femnist", samples_per_node=20,
                                batch_size=SHARD, synthetic_train=2000,
                                synthetic_test=128, seed=1),
        model=jschema.ModelConfig(model="femnist-cnn",
                                  kwargs={"hidden": 64},
                                  compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=3, epochs_per_round=3,
                                        learning_rate=0.05),
        transport="dense", wire_dtype="f32",
        checkpoint_dir=str(directory), checkpoint_every=2)


def _jax_round3(js) -> tuple:
    loss = [r["Train/loss"] for r in js.logger.history
            if "Train/loss" in r and r["round"] == 2]
    params = {tuple(k.key for k in p): np.asarray(leaf, np.float32)
              for p, leaf in jax.tree_util.tree_flatten_with_path(
                  js.fed.states.params)[0]}
    return np.array(loss), params


def _port_round3(ts, history) -> tuple:
    params = {}

    def walk(t, keys=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, keys + (k,))
        else:
            params[keys] = t.float().numpy()

    walk(ts.fed.states.params)
    return np.array(history[-1]["train_loss"]), params


def _assert_round3_close(a, b):
    (la, pa), (lb, pb) = a, b
    np.testing.assert_allclose(la, lb, rtol=F32_RTOL)
    assert set(pa) == set(pb)
    for k in pa:
        rel = np.linalg.norm(pa[k] - pb[k]) / np.linalg.norm(pb[k])
        assert rel < F32_RTOL, (k, rel)


def test_port_resumes_a_jax_run(tmp_path):
    cfg = _f32_config(tmp_path / "jax")
    js = JaxScenario(cfg)
    jres = js.run()
    (tmp_path / "port").mkdir()
    shutil.copy(jck.checkpoint_path(tmp_path / "jax", 2), tmp_path / "port")
    cfg.save(tmp_path / "scenario.json")
    tcfg = dataclasses.replace(ScenarioConfig.load(tmp_path / "scenario.json"),
                               checkpoint_dir=str(tmp_path / "port"))
    ts = Scenario(tcfg, device="cpu")
    assert ts.fed.round == 2 and ts.global_step == 2 * 3
    tres = ts.run(rounds=1)
    _assert_round3_close(_port_round3(ts, tres.history), _jax_round3(js))
    np.testing.assert_array_equal(tres.per_node_accuracy,
                                  jres.per_node_accuracy)


def test_jax_resumes_a_port_run(tmp_path):
    cfg = _f32_config(tmp_path / "port")
    cfg.save(tmp_path / "scenario.json")
    ts = Scenario(ScenarioConfig.load(tmp_path / "scenario.json"),
                  device="cpu")
    tres = ts.run()
    (tmp_path / "jax").mkdir()
    shutil.copy(ck.checkpoint_path(tmp_path / "port", 2), tmp_path / "jax")
    js = JaxScenario(dataclasses.replace(
        cfg, checkpoint_dir=str(tmp_path / "jax")))
    assert int(js.fed.round) == 2
    jres = js.run(rounds=1)
    _assert_round3_close(_jax_round3(js), _port_round3(ts, tres.history))
    np.testing.assert_array_equal(jres.per_node_accuracy,
                                  tres.per_node_accuracy)


# ---------------------------------------------------------------------------
# the port's own resume
# ---------------------------------------------------------------------------


def _ring(directory, federation="DFL", rounds=4, optimizer="sgd",
          overlap="off", faults=(), protocol=None, n=4) -> ScenarioConfig:
    """mnist-mlp on a ring, 4 steps an epoch (the shuffle matters)."""
    return ScenarioConfig(
        name="resume", federation=federation, topology="ring", n_nodes=n,
        data=DataConfig(dataset="mnist", samples_per_node=72, batch_size=16,
                        seed=0),
        model=ModelConfig(model="mnist-mlp"),
        training=TrainingConfig(rounds=rounds, epochs_per_round=1,
                                learning_rate=0.05 if optimizer == "sgd"
                                else 1e-3, optimizer=optimizer,
                                weight_decay=1e-4),
        exchange_overlap=overlap, faults=list(faults),
        protocol=protocol or ProtocolConfig(),
        checkpoint_dir=str(directory), checkpoint_every=2, seed=0)


def _state_leaves(fed) -> list[torch.Tensor]:
    stale = [] if fed.stale is None else (tree_leaves(fed.stale[0])
                                         + [fed.stale[1]])
    return (tree_leaves(fed.states.params)
            + tree_leaves(dataclasses.asdict(fed.states.opt_state)
                          if isinstance(fed.states.opt_state, AdamState)
                          else fed.states.opt_state)
            + [fed.states.step, fed.alive] + stale)


def _whole_and_resumed(tmp_path, resume_round=2, **kw):
    """The uninterrupted run and a fresh Scenario on a copy of its
    ``resume_round`` file, run to the same round."""
    whole = Scenario(_ring(tmp_path / "a", **kw), device="cpu")
    res = whole.run()
    (tmp_path / "b").mkdir()
    shutil.copy(ck.checkpoint_path(tmp_path / "a", resume_round),
                tmp_path / "b")
    resumed = Scenario(_ring(tmp_path / "b", **kw), device="cpu")
    assert resumed.fed.round == resume_round
    res2 = resumed.run(rounds=whole.fed.round - resume_round)
    return whole, res, resumed, res2


@pytest.mark.parametrize("optimizer,overlap", [
    ("sgd", "off"), ("adamw", "off"), ("sgd", "staged")])
def test_port_resume_is_bit_exact(tmp_path, optimizer, overlap):
    whole, res, resumed, res2 = _whole_and_resumed(
        tmp_path, optimizer=optimizer, overlap=overlap)
    for a, b in zip(_state_leaves(whole.fed), _state_leaves(resumed.fed),
                    strict=True):
        assert torch.equal(a, b)
    assert whole.fed.round == resumed.fed.round == 4
    assert [h["train_loss"] for h in res.history[2:]] == [
        h["train_loss"] for h in res2.history]
    assert res.per_node_accuracy == res2.per_node_accuracy
    assert (ck.checkpoint_path(tmp_path / "a", 4).read_bytes()
            == ck.checkpoint_path(tmp_path / "b", 4).read_bytes())


FAST_CLOCK = ProtocolConfig(heartbeat_period_s=4.0, node_timeout_s=3.0)


@pytest.mark.parametrize("federation,resume_round", [
    ("SDFL", 2), ("SDFL", 4), ("DFL", 4)])
def test_resume_with_faults_replays_leaders_and_membership(
        tmp_path, federation, resume_round):
    """Node 3 crashing at round 1 and joining at round 3, resumed at
    round 2 (the join still to come) or 4 (the join replayed, which
    copies no row: on the DFL ring a copy would overwrite node 3's own
    row): the replay draws the same SDFL leaders and evicts the same
    node, so leaders, alive masks and state match the uninterrupted
    run."""
    faults = (FaultEvent(node=3, round=1, kind="crash"),
              FaultEvent(node=3, round=3, kind="join"))
    whole, res, resumed, res2 = _whole_and_resumed(
        tmp_path, resume_round, federation=federation, rounds=6,
        faults=faults, protocol=FAST_CLOCK, n=6)
    tail = res.history[resume_round:]
    assert [h["leader"] for h in tail] == [h["leader"] for h in res2.history]
    assert [h["alive"] for h in tail] == [h["alive"] for h in res2.history]
    assert [h["alive"][3] for h in res.history] == [True] + [False] * 2 + [
        True] * 3
    if federation == "SDFL":
        assert len({h["leader"] for h in res.history}) > 1
    for a, b in zip(_state_leaves(whole.fed), _state_leaves(resumed.fed),
                    strict=True):
        assert torch.equal(a, b)


def test_a_dead_node_stays_dead_after_resume(tmp_path):
    faults = (FaultEvent(node=1, round=0, kind="crash"),)
    whole, res, resumed, res2 = _whole_and_resumed(
        tmp_path, faults=faults, protocol=FAST_CLOCK)
    assert all(not h["alive"][1] for h in res2.history)
    assert not bool(resumed.fed.alive[1])
    for a, b in zip(tree_leaves(whole.fed.states.params),
                    tree_leaves(resumed.fed.states.params)):
        assert torch.equal(a[1], b[1])
        assert torch.equal(a, b)


def test_resume_passes_over_a_truncated_newest_file(tmp_path):
    whole = Scenario(_ring(tmp_path / "a"), device="cpu")
    whole.run()
    newest = ck.latest_checkpoint(tmp_path / "a")
    assert newest == ck.checkpoint_path(tmp_path / "a", 4)
    blob = newest.read_bytes()
    newest.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match=newest.name):
        ck.load_checkpoint(newest, whole.fed)
    resumed = Scenario(_ring(tmp_path / "a"), device="cpu")
    assert resumed.fed.round == 2


def test_a_shape_mismatch_raises_naming_the_leaf(tmp_path):
    """A 4-node file against a 3-node template: ValueError naming the
    leaf; a Scenario of 3 nodes passes over the file and starts anew."""
    Scenario(_ring(tmp_path / "a", rounds=2), device="cpu").run()
    path = ck.checkpoint_path(tmp_path / "a", 2)
    small = Scenario(_ring(tmp_path / "none", n=3), device="cpu")
    with pytest.raises(ValueError, match="shape .* != expected"):
        ck.load_checkpoint(path, small.fed)
    fresh = Scenario(_ring(tmp_path / "a", n=3), device="cpu")
    assert fresh.fed.round == 0
    with pytest.raises(ValueError, match="optimizer"):
        ck.save_checkpoint(tmp_path / "x", Scenario(
            _ring(tmp_path / "y", optimizer="adam"), device="cpu").fed)
