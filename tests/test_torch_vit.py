"""The port's ViT-Tiny and the device-local attention against the JAX
package's.

Small sizes throughout (patch 4 on 32 x 32 images, dim 48, 3 heads,
depth 2, 2-4 nodes), the same seeded numpy inputs to both packages and
the weights carried across by ``convert.params_from_jax``, in all four
``remat`` x ``scan_layers`` layouts.

Tolerances, relative L2 over the logits or a gradient leaf (a leaf
held to 1% of its node's whole gradient where its own norm is smaller:
the key projection's bias has a true gradient of zero, since adding a
constant to every key's logit leaves the softmax unchanged):

- f32 compute: logits 1e-5, gradients 2e-5 (readings 2e-7 to 2.6e-7
  and up to 1e-6; the ViT has no ReLU or max-pool tie to flip).
- bf16 compute, one block from the same bf16 input: 1e-4 (readings
  0 to 2e-5: the port rounds where XLA rounds, so at most 0.1% of the
  elements take the other bf16 neighbour, by sum order); the control,
  the port's f32 block on that input, lies 3.6e-3 from flax's bf16
  block and must fail it.
- bf16 compute, a whole model: logits 3e-3 (readings 1.0e-3 to
  2.1e-3), the control (the port in f32) 4.4e-3 to 5.2e-3 away;
  gradients 5e-2 (readings 1.4e-2 to 2.5e-2). Each block's rare flips
  pass on and grow through the next; the per-block test above is what
  holds the bf16 arithmetic.

``reference_attention`` and ``_block_attn`` are held at f32 rtol 1e-5
(atol 1e-6) and, in bf16, the attention output within one bf16 ulp.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation import scenario as jax_scenario
from p2pfl_tpu.learning.objectives import cross_entropy_loss
from p2pfl_tpu.models import vit as jax_vit
from p2pfl_tpu.ops import ring_attention as jax_ra
from p2pfl_tpu.parallel.transport import MeshTransport
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from p2pfl_tpu_torch.federation import scenario as torch_scenario
from p2pfl_tpu_torch.learning.objectives import cross_entropy_loss as torch_ce
from p2pfl_tpu_torch.models import vit
from p2pfl_tpu_torch.models.base import get_model
from p2pfl_tpu_torch.ops import gemm
from p2pfl_tpu_torch.ops import ring_attention as ra
from p2pfl_tpu_torch.parallel.federated import reseed_params

F32_LOGIT_REL_L2 = 1e-5
F32_GRAD_REL_L2 = 2e-5
BF16_BLOCK_REL_L2 = 1e-4
BF16_LOGIT_REL_L2 = 3e-3
BF16_GRAD_REL_L2 = 5e-2
SMALL = dict(dim=48, depth=2, heads=3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
LAYOUT_IDS = ["plain", "remat", "scan", "remat-scan"]


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


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]),
                        *trees)


def _paths(tree) -> dict:
    return {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _images(n: int, b: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, b)).astype(np.int32)
    return x, y


@functools.cache
def _jax_fns(dtype: str, remat: bool, scan: bool):
    jm = jax_vit.ViT(dtype=DTYPES[dtype][0], remat=remat, scan_layers=scan,
                     **SMALL)
    grad = jax.jit(jax.grad(
        lambda p, x, y: cross_entropy_loss(jm.apply(p, x), y)))
    return jm, jax.jit(jm.apply), grad


def _port(dtype: str, remat: bool, scan: bool) -> vit.ViT:
    return get_model("vit-tiny", dtype=DTYPES[dtype][1], remat=remat,
                     scan_layers=scan, **SMALL)


def _jax_params(jm, x, n: int, seed: int = 0):
    return [jm.init(jax.random.PRNGKey(seed + i), jnp.asarray(x[i]))
            for i in range(n)]


def _port_grads(tm, tparams, x, y):
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    n, b = y.shape
    loss = torch_ce(tm(tparams, torch.from_numpy(x)), torch.from_numpy(y),
                    torch.ones(n, b, dtype=torch.bool))
    return params_to_numpy(tree_unflatten(
        tparams, list(torch.autograd.grad(loss.sum(), leaves))))


def _grad_readings(tgrads, jgrad, i: int) -> float:
    """The largest leaf reading of node ``i`` (each leaf relative to
    its own norm, or to 1% of the node's whole gradient)."""
    flat = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    floor = 1e-2 * float(np.sqrt(sum(
        np.sum(np.square(np.asarray(w, np.float64))) for _, w in flat)))
    worst = 0.0
    for path, want in flat:
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(_leaf(tgrads, [k.key for k in path])[i] - want)
        worst = max(worst, err / max(np.linalg.norm(want), floor))
    return worst


# ---------------------------------------------------------------------------
# the registry, the trees and the layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat,scan", LAYOUTS, ids=LAYOUT_IDS)
def test_init_tree_has_flax_paths_and_shapes(remat, scan):
    """The port's own init has the flax init's key paths and leaf
    shapes, f32 and finite; ``params_from_jax`` carries the JAX tree of
    the layout across with the same paths and a node axis."""
    x, _ = _images(2)
    jm = jax_vit.ViT(remat=remat, scan_layers=scan, **SMALL)
    jtree = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    got = _port("bf16", remat, scan).init(torch.Generator().manual_seed(0),
                                          torch.from_numpy(x[0]))
    assert _paths(params_to_numpy(got)) == _paths(jtree)
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in tree_leaves(got))
    carried = params_from_jax(_stack([jtree, jtree]))
    assert {k: v[1:] for k, v in _paths(params_to_numpy(
        carried)).items()} == _paths(jtree)
    leaves = 23 if scan else 39
    assert len(tree_leaves(got)) == leaves


def test_full_size_has_the_jax_parameter_count():
    """ViT-Tiny at full size: 5,362,378 parameters a node, 199 leaves
    unscanned and 23 scanned, as flax's ``model.init``; bf16
    ``param_dtype`` honoured."""
    x = torch.zeros(1, 32, 32, 3)
    want = jax.eval_shape(jax_vit.ViT().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    for scan in (False, True):
        tree = get_model("vit-tiny", scan_layers=scan,
                         param_dtype=torch.bfloat16).init(
            torch.Generator().manual_seed(0), x)
        leaves = tree_leaves(tree)
        assert sum(t.numel() for t in leaves) == 5_362_378
        assert len(leaves) == (23 if scan else 199)
        assert all(t.dtype == torch.bfloat16 for t in leaves)
        if not scan:
            assert _paths(params_to_numpy(tree)) == _paths(want)


def test_init_scales_like_flax():
    """lecun-normal kernels (std about sqrt(1 / fan_in): the q/k/v and
    out projections' fan-in is dim, the patch conv's 4 * 4 * 3),
    pos_embed normal(0.02), LayerNorm scale 1 and bias 0."""
    tree = get_model("vit-tiny").init(torch.Generator().manual_seed(2),
                                      torch.zeros(1, 32, 32, 3))["params"]
    blk = tree["TransformerBlock_3"]
    q = blk["MultiHeadDotProductAttention_0"]["query"]["kernel"]
    out = blk["MultiHeadDotProductAttention_0"]["out"]["kernel"]
    assert q.shape == (192, 3, 64) and out.shape == (3, 64, 192)
    assert abs(float(q.std()) * math.sqrt(192) - 1.0) < 0.05
    assert abs(float(out.std()) * math.sqrt(192) - 1.0) < 0.05
    assert abs(float(tree["patch_embed"]["kernel"].std()) * math.sqrt(48)
               - 1.0) < 0.05
    assert abs(float(tree["pos_embed"].std()) / 0.02 - 1.0) < 0.05
    assert bool((blk["LayerNorm_1"]["scale"] == 1).all())
    assert bool((blk["LayerNorm_1"]["bias"] == 0).all())


def test_vit_builds_by_both_names_and_from_a_model_config():
    from p2pfl_tpu_torch.config.schema import ModelConfig
    from p2pfl_tpu_torch.models import ViT
    from p2pfl_tpu_torch.models.base import build_model

    for name in ("vit-tiny", "vit"):
        assert isinstance(get_model(name), ViT)
    m = build_model(ModelConfig(model="vit-tiny", compute_dtype="float32",
                                kwargs={"remat": True, "scan_layers": True}))
    assert m.dtype == torch.float32 and m.remat and m.scan_layers
    assert m.block_name == "CheckpointTransformerBlock"


def test_seq_axis_names_a24():
    with pytest.raises(NotImplementedError, match="A24"):
        vit.ViT(seq_axis="sp")


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat,scan", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_grads_match_flax(dtype, remat, scan):
    """Logits and every leaf of ``jax.grad`` of the cross-entropy, two
    nodes of three images, at the tolerances of the module docstring;
    in bf16 the control (the port in f32 on the same weights) must
    miss the logits tolerance."""
    n = 2
    x, y = _images(n, seed=1)
    jm, fwd, grad = _jax_fns(dtype, remat, scan)
    jparams = _jax_params(jm, x, n)
    tm = _port(dtype, remat, scan)
    tparams = params_from_jax(_stack(jparams))
    got = tm(tparams, torch.from_numpy(x))
    assert got.shape == (n, 3, 10) and got.dtype == torch.float32
    tgrads = _port_grads(tm, tparams, x, y)
    f32 = _port("f32", remat, scan)(params_from_jax(_stack(jparams)),
                                    torch.from_numpy(x)).detach().numpy()
    tol = (F32_LOGIT_REL_L2, F32_GRAD_REL_L2) if dtype == "f32" else (
        BF16_LOGIT_REL_L2, BF16_GRAD_REL_L2)
    for i in range(n):
        want = np.asarray(fwd(jparams[i], jnp.asarray(x[i])))
        rel = _rel(got[i].detach().numpy(), want)
        assert rel < tol[0], (dtype, i, rel)
        if dtype == "bf16":
            assert _rel(f32[i], want) > tol[0], i
        jg = grad(jparams[i], jnp.asarray(x[i]), jnp.asarray(y[i]))
        worst = _grad_readings(tgrads, jg, i)
        assert worst < tol[1], (dtype, i, worst)


def test_block_matches_flax_in_bf16():
    """One ``TransformerBlock`` in bf16 compute, a stack of 2 nodes of 3
    token sets, from the same bf16 input: the port's output (rounded)
    within ``BF16_BLOCK_REL_L2`` of flax's jitted block, and the port's
    f32 block on that input (the control) outside it."""
    x = np.random.default_rng(11).standard_normal((2, 3, 64, 48))
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jblock = jax_vit.TransformerBlock(dim=48, heads=3, dtype=jnp.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jparams = [jblock.init(jax.random.PRNGKey(30 + i), xj[i])
               for i in range(2)]
    tparams = params_from_jax(_stack(jparams))["params"]
    got = vit.TransformerBlock(48, 3, dtype=torch.bfloat16)(
        tparams, x.float()).to(torch.bfloat16).float().numpy()
    f32 = vit.TransformerBlock(48, 3, dtype=torch.float32)(
        tparams, x.float()).detach().numpy()
    apply = jax.jit(jblock.apply)
    for i in range(2):
        want = np.asarray(apply(jparams[i], xj[i]).astype(jnp.float32))
        assert _rel(got[i], want) < BF16_BLOCK_REL_L2, i
        assert np.mean(got[i] != want) < 1e-3, i
        assert _rel(f32[i], want) > 10 * BF16_BLOCK_REL_L2, i


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_remat_gives_the_same_bits(scan):
    """``remat`` recomputes each block in the backward: the logits and
    every gradient leaf equal the layout without it bit for bit (the
    trees differ only in the block names)."""
    x, y = _images(3, b=2, seed=4)
    plain, remat = _port("bf16", False, scan), _port("bf16", True, scan)
    one = remat.init(torch.Generator().manual_seed(7), torch.from_numpy(x[0]))
    stacked = {"params": tree_map(lambda t: t.unsqueeze(0).repeat(
        (3,) + (1,) * t.dim()) + 0.01 * torch.randn(
            (3,) + tuple(t.shape), generator=torch.Generator().manual_seed(
                t.numel())), one["params"])}

    def renamed(tree):
        if isinstance(tree, dict):
            return {k.replace("CheckpointTransformerBlock",
                              "TransformerBlock"): renamed(v)
                    for k, v in tree.items()}
        return tree.clone()

    out_r = remat(stacked, torch.from_numpy(x))
    out_p = plain(renamed(stacked), torch.from_numpy(x))
    assert torch.equal(out_r, out_p)
    g_r = tree_leaves(_port_grads(remat, stacked, x, y))
    g_p = tree_leaves(_port_grads(plain, renamed(stacked), x, y))
    assert len(g_r) == len(g_p)
    assert all(np.array_equal(a, b) for a, b in zip(g_r, g_p))


def test_layer_norm_and_gelu_take_flax_rounding_points():
    """In bf16: ``layer_norm`` on a bf16 input and ``gelu`` give flax's
    jitted bits; ``F.gelu(approximate="tanh")`` (f32 inside, rounded
    once) does not, and ``F.layer_norm``'s epsilon (1e-5) is not
    flax's (1e-6)."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 64, 48)).astype(
        np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)[0]
    ln = fnn.LayerNorm(dtype=jnp.bfloat16)
    p = ln.init(jax.random.PRNGKey(0), xj)
    p = jax.tree.map(lambda a: a + 0.2 * jax.random.normal(
        jax.random.PRNGKey(1), a.shape), p)
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a)[None], p))
    want = np.asarray(jax.jit(ln.apply)(p, xj).astype(jnp.float32))
    got = vit.layer_norm(x, tp["params"], torch.bfloat16).float().numpy()[0]
    np.testing.assert_array_equal(got, want)
    assert vit.LAYER_NORM_EPS == 1e-6
    want = np.asarray(jax.jit(jax.nn.gelu)(xj).astype(jnp.float32))
    np.testing.assert_array_equal(vit.gelu(x).float().numpy()[0], want)
    other = torch.nn.functional.gelu(x, approximate="tanh").float().numpy()
    assert np.mean(other[0] != want) > 0.1


def test_softmax_takes_xlas_rounding_points_and_jaxs_gradient():
    """The attention softmax in bf16 gives jitted ``jax.nn.softmax``'s
    bits, and ``torch.softmax`` (one rounding) does not; in f32 the
    value and the vjp match JAX's within rtol 1e-6."""
    rng = np.random.default_rng(5)
    s = (2.0 * rng.standard_normal((12, 64, 64))).astype(np.float32)
    sb = torch.from_numpy(s).to(torch.bfloat16)
    sj = jnp.asarray(sb.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.softmax)(sj).astype(jnp.float32))
    np.testing.assert_array_equal(vit.softmax(sb).float().numpy(), want)
    assert np.mean(torch.softmax(sb, -1).float().numpy() != want) > 0.1
    g = rng.standard_normal(s.shape).astype(np.float32)
    _, vjp = jax.vjp(jax.nn.softmax, jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    y = vit.softmax(st)
    (gt,) = torch.autograd.grad(y, st, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax.nn.softmax(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# ops/ring_attention.py's device-local half
# ---------------------------------------------------------------------------


def _qkv(dtype, seed=0, b=2, s=16, h=3, d=8):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, s, h, d)).astype(np.float32)
           for _ in range(3)]
    tdt = DTYPES[dtype][1]
    ts = [torch.from_numpy(a).to(tdt) for a in qkv]
    js = [jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0])
          for t in ts]
    return ts, js


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_attention_matches_jax(dtype):
    ts, js = _qkv(dtype)
    got = ra.reference_attention(*ts).float().numpy()
    want = np.asarray(jax_ra.reference_attention(*js).astype(jnp.float32))
    assert got.shape == want.shape == (2, 16, 3, 8)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_attn_accumulates_like_jax(dtype):
    """Two blocks of keys through ``_block_attn`` from the empty state
    (m = -inf, l = 0, o = 0), against JAX's, f32 state within rtol 1e-5;
    the normalized result equals ``reference_attention`` over both
    blocks (f32: rtol 1e-5)."""
    ts, js = _qkv(dtype, seed=1, s=16)
    q, k, v = ts
    jq, jk, jv = js
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, s), -math.inf)
    l, o = torch.zeros(b, h, s), torch.zeros(b, h, s, d)
    jm_, jl, jo = jnp.asarray(m.numpy()), jnp.zeros((b, h, s)), jnp.zeros(
        (b, h, s, d))
    for half in (slice(0, 8), slice(8, 16)):
        m, l, o = ra._block_attn(q, k[:, half], v[:, half], m, l, o, scale)
        jm_, jl, jo = jax_ra._block_attn(jq, jk[:, half], jv[:, half], jm_,
                                         jl, jo, scale)
    for got, want in ((m, jm_), (l, jl), (o, jo)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    if dtype == "f32":
        out = (o / l[..., None]).transpose(1, 2).numpy()
        np.testing.assert_allclose(out, ra.reference_attention(q, k, v),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the federation
# ---------------------------------------------------------------------------


def vit_config(**overrides) -> jschema.ScenarioConfig:
    """``bench.py``'s ``_vit32_inprocess`` shape cut to the CPU: the
    scanned, rematted ViT at SMALL widths, 4 nodes fully connected, DFL,
    Krum(f=1, m=3) (one shared aggregate), iid shards of the easy
    CIFAR10 surrogate, SGD momentum 0.9, f32 compute and wire, 2
    rounds of 2 epochs. A shard is one batch, so that the two packages'
    shuffles (threefry against ``torch.Generator``) take the same
    images a step."""
    kw = dict(
        name="vit-parity", federation="DFL", topology="fully", n_nodes=4,
        aggregator="krum", aggregator_kwargs={"f": 1, "m": 3},
        data=jschema.DataConfig(dataset="cifar10", partition="iid",
                                samples_per_node=4, batch_size=4,
                                synthetic_train=200, synthetic_test=32,
                                surrogate_profile="easy", seed=4),
        model=jschema.ModelConfig(
            model="vit-tiny", compute_dtype="float32",
            kwargs=dict(SMALL, remat=True, scan_layers=True)),
        training=jschema.TrainingConfig(rounds=2, epochs_per_round=2,
                                        learning_rate=0.05),
        transport="dense", wire_dtype="f32", seed=4)
    kw.update(overrides)
    return jschema.ScenarioConfig(**kw)


def run_both(tmp_path, monkeypatch, jcfg, carry=None):
    """The JAX ``Scenario`` on one device and the port's from the same
    scenario file; ``carry(js, ts)`` puts the JAX initial state into
    the port (default: node 0's params, as ``reseed_params``)."""
    path = tmp_path / "scenario.json"
    jcfg.save(path)
    monkeypatch.setattr(jax_scenario, "MeshTransport",
                        lambda n: MeshTransport(n, n_devices=1))
    js = jax_scenario.Scenario(jcfg)
    ts = (carry or _carry_row0)(js, ScenarioConfig.load(path))
    gemm.reset_launches()
    jres, tres = js.run(), ts.run()
    return js, ts, jres, tres


def _carry_row0(js, tcfg):
    ts = torch_scenario.Scenario(tcfg, device="cpu")
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    return ts


def assert_runs_agree(js, ts, jres, tres, rounds: int, tol: float):
    n = ts.config.n_nodes
    jl = np.zeros((rounds, n))
    for r in jres.history:
        if "Train/loss" in r:
            jl[r["round"], r["node"]] = r["Train/loss"]
    tl = np.array([h["train_loss"] for h in tres.history])
    np.testing.assert_allclose(tl, jl, rtol=tol)
    # each leaf relative to its own norm, or to 1e-4 of the whole tree's
    # where its own is smaller: the key bias's gradient is zero, so it
    # holds only rounding noise (about 1e-9) on both sides
    tp = params_to_numpy(ts.fed.states.params)
    flat = jax.tree_util.tree_flatten_with_path(js.fed.states.params)[0]
    floor = 1e-4 * float(np.sqrt(sum(
        np.sum(np.square(np.asarray(w, np.float64))) for _, w in flat)))
    for path_, leaf in flat:
        keys = [k.key for k in path_]
        want = np.asarray(leaf, np.float64)
        err = np.linalg.norm(_leaf(tp, keys) - want)
        rel = err / max(np.linalg.norm(want), floor)
        assert rel < tol, (keys, rel)
    np.testing.assert_array_equal(tres.per_node_accuracy,
                                  jres.per_node_accuracy)


def test_vit_federation_matches_jax_in_f32(tmp_path, monkeypatch):
    """``vit_config``'s 2 rounds from the JAX initial weights: train
    losses and every parameter leaf within relative 1e-5 of JAX's
    1-device run, accuracies equal, K4 (its plain version on the CPU)
    once a training step over the 23 scanned leaves."""
    js, ts, jres, tres = run_both(tmp_path, monkeypatch, vit_config())
    assert gemm.launches["sgd_accum"] == 0  # the CPU runs the plain version
    assert int(ts.fed.states.step[0]) == 2 * 2
    assert len(tree_leaves(ts.fed.states.params)) == 23
    assert_runs_agree(js, ts, jres, tres, rounds=2, tol=1e-5)
