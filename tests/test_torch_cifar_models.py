"""The port's CIFAR10 ResNets and MobileNets against the flax models.

Each test feeds the same seeded numpy inputs to the JAX module and to
its port, the weights carried across by ``params_from_jax``. The JAX
side runs one node at a time, the port a stack. ResNet9's stem is the
JAX package's ``PatchConv`` (contraction 27): its forward runs with the
JAX gate forced on (the Pallas kernel in interpret mode) and off (XLA),
as ``tests/test_torch_model.py`` runs conv1, since the port's kernel
path must match both.

Tolerances, relative L2 over the logits or over one leaf:

- f32 compute: 1e-5 for logits and 2e-5 for gradients. Both sides sum
  in f32 in other orders (XLA:CPU's convs and reductions against
  oneDNN's and PyTorch's); the readings are 3e-7 to 2e-6 for logits
  and at most 2.5e-6 for a gradient leaf.
- bf16 compute, one block: 1e-3 for its output, from the same
  bf16 input. Every conv and GroupNorm output is rounded to bf16 on
  both sides, at points where the two frameworks' f32 values differ in
  the last bits, so now and then an element rounds the other way (a
  bf16 ulp, 2**-8 relative); the readings are 0 (the same bits) on the
  test's inputs and at most 2e-4 on other draws. The control: the
  port's block in f32 on the same input lies 2.7e-3 to 5.0e-3 from
  JAX's bf16 block (bf16's own rounding), so a block that skipped a
  bf16 rounding would fail.
- bf16 compute, a whole model: 3e-2 for logits. Each block passes its
  rare flips on, and the next block's roundings amplify them (ResNet9:
  3e-5 after the stem, 4e-3 after the last block, while each block from
  the same input stays within 2e-4); the readings are 0.5-1.2% over up
  to 17 layers, as far as JAX's own bf16 logits lie from its f32
  logits, so the per-block test above is what holds the bf16 arithmetic.

GroupNorm is held against ``flax.linen.GroupNorm`` element by element
(f32 rtol 1e-5; bf16 within one bf16 ulp), with an input whose large
mean makes flax's fast variance ``E[x²] - E[x]²`` differ from a
two-pass variance: the port must take the fast one. The stride-2 SAME
tests pin XLA's asymmetric (0, 1) padding: the same blocks with
PyTorch's symmetric ``padding=1`` miss them by tens of percent (the
tests run that control too).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from p2pfl_tpu.config import schema as jschema
from p2pfl_tpu.federation import scenario as jax_scenario
from p2pfl_tpu.learning.objectives import cross_entropy_loss
from p2pfl_tpu.models import get_model as jax_get_model
from p2pfl_tpu.models import mobilenet as jax_mobilenet
from p2pfl_tpu.models import resnet as jax_resnet
from p2pfl_tpu.models.base import _REGISTRY as JAX_REGISTRY
from p2pfl_tpu.ops import pallas_gemm
from p2pfl_tpu.parallel.transport import MeshTransport
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_unflatten
from p2pfl_tpu_torch.federation import scenario as torch_scenario
from p2pfl_tpu_torch.learning.objectives import cross_entropy_loss as torch_ce
from p2pfl_tpu_torch.models import base, mobilenet, resnet
from p2pfl_tpu_torch.models.base import get_model
from p2pfl_tpu_torch.parallel.federated import reseed_params

F32_LOGIT_REL_L2 = 1e-5
F32_GRAD_REL_L2 = 2e-5
BF16_BLOCK_REL_L2 = 1e-3
BF16_LOGIT_REL_L2 = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CIFAR_NAMES = sorted(k for k in JAX_REGISTRY
                     if "resnet" in k or "mobilenet" in k)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _models(name: str, dtype: str):
    """(flax module, port module) of one model at one compute dtype;
    "bottleneck" is ResNet(stage_sizes=(1, 1, 1, 1), bottleneck=True),
    resnet50's block at the least depth."""
    jdt, tdt = DTYPES[dtype]
    if name == "bottleneck":
        kw = dict(stage_sizes=(1, 1, 1, 1), bottleneck=True)
        return (jax_resnet.ResNet(dtype=jdt, **kw),
                resnet.ResNet(dtype=tdt, **kw))
    return jax_get_model(name, dtype=jdt), get_model(name, dtype=tdt)


@functools.cache
def _jax_fns(name: str, dtype: str, knob: str):
    """Jitted flax forward and cross-entropy gradient (cached per gate
    setting: the gate decides while tracing)."""
    fm, _ = _models(name, dtype)
    fwd = jax.jit(fm.apply)
    grad = jax.jit(jax.grad(
        lambda p, x, y: cross_entropy_loss(fm.apply(p, x), y)))
    return fm, fwd, grad


@pytest.fixture
def jax_kernels(monkeypatch, request):
    """Force the JAX package's gate on or off for one test."""
    monkeypatch.setenv(pallas_gemm.ENV_KNOB, request.param)
    pallas_gemm.clear_cache()
    yield request.param
    pallas_gemm.clear_cache()


def _images(n: int, b: int = 2, hw: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, b, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, b)).astype(np.int32)
    return x, y


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]),
                        *trees)


def _jax_params(fm, x, n: int):
    return [fm.init(jax.random.PRNGKey(10 + i), jnp.asarray(x[i]))
            for i in range(n)]


def _paths(tree) -> dict:
    return {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the registry and the trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CIFAR_NAMES)
def test_init_tree_has_flax_paths_and_shapes(name):
    """Every registered name of the family builds, and its own init has
    the flax init's key paths and leaf shapes (2 x 16 x 16 x 3 inputs):
    ``convert.params_from_jax`` carries weights by those names."""
    x, _ = _images(1)
    want = _paths(jax.eval_shape(jax_get_model(name).init,
                                 jax.random.PRNGKey(0), jnp.asarray(x[0])))
    model = get_model(name)
    got = model.init(torch.Generator().manual_seed(0), torch.from_numpy(x[0]))
    assert _paths(jax.tree.map(np.asarray, got)) == want
    leaves = tree_leaves(got)
    assert all(t.dtype == torch.float32 for t in leaves)
    assert all(bool(torch.isfinite(t).all()) for t in leaves)


def test_init_scales_like_flax():
    """lecun-normal kernels (std about sqrt(1 / fan_in); a depthwise
    kernel's fan-in is its 9 taps), GroupNorm scale 1 and bias 0, param
    dtype honoured."""
    x, _ = _images(1, b=1, hw=32)
    tree = get_model("simplemobilenet", param_dtype=torch.bfloat16).init(
        torch.Generator().manual_seed(1), torch.from_numpy(x[0]))["params"]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tree))
    dw = tree["DepthwiseSeparable_5"]["Conv_0"]["kernel"].float()
    pw = tree["DepthwiseSeparable_5"]["Conv_1"]["kernel"].float()
    assert dw.shape == (3, 3, 1, 256) and pw.shape == (1, 1, 256, 512)
    assert abs(float(dw.std()) * 3.0 - 1.0) < 0.1
    assert abs(float(pw.std()) * 16.0 - 1.0) < 0.1
    gn = tree["GroupNorm_0"]
    assert bool((gn["scale"] == 1).all()) and bool((gn["bias"] == 0).all())


def test_factories_and_exports():
    from p2pfl_tpu_torch import models

    assert isinstance(models.CIFAR10ModelResNet(9), resnet.ResNet9)
    deep = {d: models.CIFAR10ModelResNet(d) for d in (18, 34, 50)}
    assert [len(m.blocks) for m in deep.values()] == [8, 16, 16]
    assert deep[50].bottleneck and not deep[34].bottleneck
    assert len(models.SimpleMobileNet().blocks) == 8
    assert len(models.FasterMobileNet().blocks) == 4
    assert isinstance(get_model("simplemobilenetv1"), mobilenet.MobileNet)
    with pytest.raises(KeyError):
        models.CIFAR10ModelResNet(101)


# ---------------------------------------------------------------------------
# forward: one node and a stack of three, f32 and bf16
# ---------------------------------------------------------------------------


def _forward_case(name: str, dtype: str, n: int, knob: str):
    x, _ = _images(n, seed=n)
    fm, fwd, _ = _jax_fns(name, dtype, knob)
    jparams = _jax_params(fm, x, n)
    _, tm = _models(name, dtype)
    got = tm(params_from_jax(_stack(jparams)), torch.from_numpy(x))
    assert got.shape == (n, 2, 10) and got.dtype == torch.float32
    tol = F32_LOGIT_REL_L2 if dtype == "f32" else BF16_LOGIT_REL_L2
    for i in range(n):
        want = np.asarray(fwd(jparams[i], jnp.asarray(x[i])), np.float32)
        rel = _rel(got[i].detach().numpy(), want)
        assert rel < tol, (name, dtype, i, rel)


@pytest.mark.parametrize("jax_kernels", ["on", "off"], indirect=True)
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet9_forward_matches_flax(jax_kernels, dtype, n):
    _forward_case("resnet9", dtype, n, jax_kernels)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["resnet18", "bottleneck",
                                  "fastermobilenet", "simplemobilenet"])
def test_forward_matches_flax(name, dtype, n):
    _forward_case(name, dtype, n, "auto")


# every block kind of the family: (flax block, port block, input
# channels) at a compute dtype
BLOCKS = {
    "stem": (lambda d: jax_resnet.ConvBlock(64, dtype=d),
             lambda d: resnet.ConvBlock(64, dtype=d), 3),
    "conv_pool": (lambda d: jax_resnet.ConvBlock(128, pool=True, dtype=d),
                  lambda d: resnet.ConvBlock(128, pool=True, dtype=d), 64),
    "residual": (lambda d: jax_resnet.Residual(64, dtype=d),
                 lambda d: resnet.Residual(64, dtype=d), 64),
    "basic_s2": (lambda d: jax_resnet.BasicBlock(32, strides=2, dtype=d),
                 lambda d: resnet.BasicBlock(32, strides=2, dtype=d), 16),
    "bottleneck_s2": (
        lambda d: jax_resnet.Bottleneck(16, strides=2, dtype=d),
        lambda d: resnet.Bottleneck(16, strides=2, dtype=d), 32),
    "depthwise_s2": (
        lambda d: jax_mobilenet.DepthwiseSeparable(32, strides=2, dtype=d),
        lambda d: mobilenet.DepthwiseSeparable(32, strides=2, dtype=d), 16),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_blocks_match_flax_in_bf16(block):
    """Each block kind in bf16 compute, a stack of 2 nodes of 3 images
    of 8 x 8, from the same bf16-valued input: the port's output within
    ``BF16_BLOCK_REL_L2`` of flax's per node, and the port's f32 block
    on that input (the control) farther than that from flax's bf16
    block."""
    jb, tb, c = BLOCKS[block]
    x = np.random.default_rng(11).standard_normal((2, 3, 8, 8, c))
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jblock = jb(jnp.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jparams = [jblock.init(jax.random.PRNGKey(30 + i), xj[i])
               for i in range(2)]
    tparams = params_from_jax(_stack(jparams))
    got = tb(torch.bfloat16)(tparams, x).float().detach().numpy()
    f32 = tb(torch.float32)(tparams, x.float()).detach().numpy()
    for i in range(2):
        want = np.asarray(jblock.apply(jparams[i], xj[i]).astype(jnp.float32))
        assert _rel(got[i], want) < BF16_BLOCK_REL_L2, (block, i)
        assert _rel(f32[i], want) > BF16_BLOCK_REL_L2, (block, i)


# ---------------------------------------------------------------------------
# gradients, f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["resnet9", "bottleneck",
                                  "fastermobilenet"])
def test_grads_match_flax_in_f32(name):
    """Every leaf of ``jax.grad`` of the cross-entropy against the
    port's autograd, two nodes of two 8 x 8 images: ResNet9 (the
    PatchConv stem through K2's plain version, the Residual adds, the
    global max), the Bottleneck block (1x1, strided 3x3, shortcut) and
    the depthwise blocks.

    The images are small because a ReLU whose pre-activation lies
    within f32 rounding of zero (1e-7 of the activations' scale) takes
    its side by the last bits of the sums, and a flip moves every
    gradient above it by about 0.2%: at 16 x 16 and 4 images a node
    the Bottleneck ResNet meets one such ReLU in a few seeds, for the
    port and for JAX against the f64 gradient alike (``ROADMAP.md``,
    near-ties).

    A leaf is held relative to its own norm, or to 1% of the node's
    whole gradient where its own is smaller: MobileNet's stem GroupNorm
    scale has a true gradient of about 1e-7 (at init every bias is 0,
    ReLU commutes with a positive scale and the next depthwise conv's
    per-channel GroupNorm divides it out), so both f32 gradients of it
    are rounding noise, 6% of that 1e-7 from the f64 one."""
    n = 2
    x, y = _images(n, b=2, hw=8, seed=7)
    fm, _, grad = _jax_fns(name, "f32", "auto")
    jparams = _jax_params(fm, x, n)
    tparams = params_from_jax(_stack(jparams))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    _, tm = _models(name, "f32")
    loss = torch_ce(tm(tparams, torch.from_numpy(x)), torch.from_numpy(y),
                    torch.ones(n, 2, dtype=torch.bool))
    tgrads = params_to_numpy(tree_unflatten(
        tparams, list(torch.autograd.grad(loss.sum(), leaves))))
    for i in range(n):
        jg = grad(jparams[i], jnp.asarray(x[i]), jnp.asarray(y[i]))
        flat = jax.tree_util.tree_flatten_with_path(jg)[0]
        floor = 1e-2 * float(np.sqrt(sum(
            np.sum(np.square(np.asarray(w, np.float64))) for _, w in flat)))
        for path, want in flat:
            keys = [k.key for k in path]
            want = np.asarray(want, np.float64)
            err = np.linalg.norm(_leaf(tgrads, keys)[i] - want)
            rel = err / max(np.linalg.norm(want), floor)
            assert rel < F32_GRAD_REL_L2, (name, i, keys, rel)


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------


def _flax_gn(x, scale, bias, dtype):
    """flax.linen.GroupNorm(min(32, C)) on one node's ``x [b, H, W, C]``."""
    c = x.shape[-1]
    gn = fnn.GroupNorm(num_groups=min(32, c), dtype=dtype)
    return np.asarray(gn.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x).astype(dtype)).astype(jnp.float32))


def _port_gn(x, scale, bias, dtype):
    """The port's group_norm over node-packed activations of the stack."""
    n = x.shape[0]
    packed = base.pack_nodes(torch.from_numpy(x).to(dtype))
    out = base.group_norm(packed, {"scale": torch.from_numpy(scale),
                                   "bias": torch.from_numpy(bias)}, n, dtype)
    return base.unpack_nodes(out, n).float().numpy()


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _gn_inputs(c: int, seed: int, large_mean: bool):
    rng = np.random.default_rng(seed)
    n = 2
    if large_mean:
        # integers 199..201: exact in bf16 and f32, and with 16 x 16 x 1
        # values a group (C = 32) every sum over a group is exact in f32
        # in any order, so both frameworks get the same E[x] and E[x²];
        # the fast variance then differs from a two-pass one by the
        # rounding of E[x]² (an ulp of 4e4 against a variance of 0.7)
        x = 200.0 + rng.integers(-1, 2, size=(n, 2, 16, 16, c))
    else:
        x = 3.0 * rng.standard_normal((n, 2, 6, 6, c)) + 0.5
    scale = (1.0 + 0.5 * rng.standard_normal((n, c))).astype(np.float32)
    bias = (0.3 * rng.standard_normal((n, c))).astype(np.float32)
    return x.astype(np.float32), scale, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,large_mean", [(32, False), (64, False),
                                          (512, False), (32, True)])
def test_group_norm_matches_flax(c, large_mean, dtype):
    """Each node's slice of the stacked GroupNorm against
    ``flax.linen.GroupNorm`` with that node's scale and bias: f32 within
    rtol 1e-5 (atol 1e-6); bf16 within one bf16 ulp of flax's output."""
    jdt, tdt = DTYPES[dtype]
    x, scale, bias = _gn_inputs(c, seed=c, large_mean=large_mean)
    got = _port_gn(x, scale, bias, tdt)
    for i in range(x.shape[0]):
        want = _flax_gn(x[i], scale[i], bias[i], jdt)
        if dtype == "f32":
            np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)
        else:
            assert np.all(np.abs(got[i] - want) <= _bf16_ulp(want)), i


def test_group_norm_takes_the_fast_variance():
    """At the large-mean input a two-pass variance (``E[(x - E[x])²]``)
    misses flax by hundreds of times the f32 tolerance above (E[x]² is
    rounded at 4e4, the variance is 0.7), and the port does not."""
    x, scale, bias = _gn_inputs(32, seed=32, large_mean=True)
    got = _port_gn(x, scale, bias, torch.float32)
    groups = x[0].reshape(2, 16 * 16, 32)
    centred = groups - groups.mean(1, keepdims=True, dtype=np.float32)
    var = np.square(centred).mean(1, keepdims=True, dtype=np.float32)
    two_pass = (centred / np.sqrt(var + base.GROUP_NORM_EPS) * scale[0]
                + bias[0]).reshape(x[0].shape)
    want = _flax_gn(x[0], scale[0], bias[0], jnp.float32)
    off = np.abs(two_pass - want) / (1e-6 + 1e-5 * np.abs(want))
    assert off.max() > 100.0, off.max()
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# stride-2 SAME padding
# ---------------------------------------------------------------------------


def _block_case(jblock, tblock, x):
    """The stacked port block against the flax block per node, f32:
    the largest relative L2 over the nodes."""
    n = x.shape[0]
    jparams = [jblock.init(jax.random.PRNGKey(30 + i), jnp.asarray(x[i]))
               for i in range(n)]
    got = tblock(params_from_jax(_stack(jparams)), torch.from_numpy(x))
    worst = 0.0
    for i in range(n):
        want = jblock.apply(jparams[i], jnp.asarray(x[i]))
        assert got.shape[1:] == want.shape
        worst = max(worst, _rel(got[i].detach().numpy(), want))
    return worst


@pytest.mark.parametrize("block", ["basic", "depthwise"])
def test_stride_two_same_padding_is_xla_asymmetric(block, monkeypatch):
    """A ``BasicBlock(strides=2)`` (3x3 strided conv and 1x1 strided
    shortcut) and a stride-2 depthwise block on an even 8 x 8 input:
    XLA pads (0, 1), and the port matches within the f32 tolerance.
    The control: the same port block with PyTorch's symmetric
    ``padding=1`` misses by more than 10%."""
    f32 = dict(dtype=jnp.float32)
    if block == "basic":
        jb, tb = (jax_resnet.BasicBlock(16, strides=2, **f32),
                  resnet.BasicBlock(16, strides=2, dtype=torch.float32))
        c = 16
    else:
        jb, tb = (jax_mobilenet.DepthwiseSeparable(16, strides=2, **f32),
                  mobilenet.DepthwiseSeparable(16, strides=2,
                                               dtype=torch.float32))
        c = 8
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 8, 8, c)).astype(np.float32)
    assert base.same_pads(8, 3, 2) == (0, 1)
    assert _block_case(jb, tb, x) < F32_LOGIT_REL_L2
    monkeypatch.setattr(base, "same_pads", lambda size, k, stride: (
        (k // 2, k // 2)))
    assert _block_case(jb, tb, x) > 0.1


# ---------------------------------------------------------------------------
# the refusals and the registry around the new names
# ---------------------------------------------------------------------------


def test_vit_builds_by_both_names():
    from p2pfl_tpu_torch.models.vit import ViT

    for name in ("vit-tiny", "vit"):
        assert isinstance(get_model(name), ViT)


def test_build_model_passes_the_dtypes():
    from p2pfl_tpu_torch.config.schema import ModelConfig

    m = base.build_model(ModelConfig(model="resnet9",
                                     compute_dtype="float32",
                                     param_dtype="bf16"))
    assert m.dtype == torch.float32 and m.param_dtype == torch.bfloat16
    assert all(blk.dtype == torch.float32 for _, blk in m.layers)


# ---------------------------------------------------------------------------
# the federation
# ---------------------------------------------------------------------------


def test_resnet9_federation_matches_jax_in_f32(tmp_path, monkeypatch):
    """``BASELINE.json`` configs[2]'s shape cut to the CPU: ResNet9, 4
    nodes, the random topology (seed 3), Dirichlet(0.5) shards of the
    easy CIFAR10 surrogate, DFL FedAvg, f32 compute and f32 wire, 2
    rounds of one step, from the JAX initial weights: train losses,
    every parameter leaf (relative L2) within 1e-5, accuracies equal.

    One image a node, the smallest shard that is a batch, so the JAX
    threefry permutation reorders nothing. Larger shards put a ReLU or
    a max-pool decision within f32 rounding of its tie, which the two
    frameworks then take apart: at 4 images a node one GroupNorm bias
    ends 0.6% apart, and at 18 both f32 gradients lie 0.1-0.4% from the
    f64 gradient (``ROADMAP.md``, near-ties).

    The JAX federation is placed on one device, as the port runs it:
    on the suite's 8-device CPU mesh (``conftest.py``) the JAX ResNet9
    round with its 4 nodes sharded over 4 devices leaves the 1-device
    result after round 1 (parameters 46% apart at round 2, on either
    topology seed), while the 1-device JAX run and the port agree to
    2.4e-6 (``ROADMAP.md``, reference caveats)."""
    jcfg = jschema.ScenarioConfig(
        name="cifar-resnet9-parity", federation="DFL", topology="random",
        topology_kwargs={"seed": 3}, n_nodes=4,
        data=jschema.DataConfig(dataset="cifar10", partition="dirichlet",
                                dirichlet_alpha=0.5, samples_per_node=1,
                                batch_size=128, synthetic_train=400,
                                synthetic_test=32, surrogate_profile="easy",
                                seed=3),
        model=jschema.ModelConfig(model="resnet9", compute_dtype="float32"),
        training=jschema.TrainingConfig(rounds=2, epochs_per_round=1,
                                        learning_rate=0.1),
        transport="dense", wire_dtype="f32", seed=3)
    path = tmp_path / "scenario.json"
    jcfg.save(path)
    monkeypatch.setattr(jax_scenario, "MeshTransport",
                        lambda n: MeshTransport(n, n_devices=1))
    js = jax_scenario.Scenario(jcfg)
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], js.fed.states.params)
    ts = torch_scenario.Scenario(ScenarioConfig.load(path), device="cpu")
    ts.fed = reseed_params(ts.fed, ts.fns, params_from_jax(p0))
    jres, tres = js.run(), ts.run()
    jl = np.zeros((2, 4))
    for r in jres.history:
        if "Train/loss" in r:
            jl[r["round"], r["node"]] = r["Train/loss"]
    tl = np.array([h["train_loss"] for h in tres.history])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tp = params_to_numpy(ts.fed.states.params)
    for path_, leaf in jax.tree_util.tree_flatten_with_path(
            js.fed.states.params)[0]:
        keys = [k.key for k in path_]
        rel = _rel(_leaf(tp, keys), leaf)
        assert rel < 1e-5, (keys, rel)
    np.testing.assert_array_equal(tres.per_node_accuracy,
                                  jres.per_node_accuracy)


def test_resolve_turns_tf32_off_for_cudnn_and_asks_determinism(monkeypatch):
    """On the card ``Scenario`` resolves the device with full-f32
    matmuls and convs (cuDNN takes TF32 by default) and deterministic
    cuDNN algorithms. The CPU stands in for the card here: only the
    flags are read."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (
        torch.backends.cudnn, "allow_tf32"), (
        torch.backends.cudnn, "deterministic")
    saved = [getattr(obj, k) for obj, k in flags]
    monkeypatch.setattr(torch_scenario, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        assert torch_scenario._resolve("cuda").type == "cuda"
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.deterministic is True
    finally:
        for (obj, k), v in zip(flags, saved):
            setattr(obj, k, v)
