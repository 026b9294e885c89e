"""The port's SmallCNN against the flax SmallCNN on carried-over weights.

Two nodes with different weights and different images: the port takes
them stacked, the JAX side one node at a time. The JAX model runs twice,
with its Pallas kernels forced on (interpret mode on the CPU) and forced
off (XLA), because the port's kernel path must match both. Tolerances:
the logits and the loss come out of a bf16 network, where one bf16
rounding that falls the other way moves a logit by about 2**-8 of its
size, so they are compared with rtol and atol 2e-2. Gradients are held
by relative L2 error per leaf: 1e-2 for kernels (bf16 activations and
bf16-rounded weight gradients on both sides); 5e-2 for biases, whose
gradient is a bf16 sum over every output position (2352 for Conv_0)
that XLA:CPU and PyTorch round at different points.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p2pfl_tpu.learning.objectives import cross_entropy_loss
from p2pfl_tpu.models.cnn import SmallCNN as FlaxSmallCNN
from p2pfl_tpu.ops import pallas_gemm
from p2pfl_tpu_torch.convert import params_from_jax, params_to_numpy
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_unflatten
from p2pfl_tpu_torch.learning.objectives import (
    cross_entropy_loss as torch_ce,
)
from p2pfl_tpu_torch.models.base import get_model
from p2pfl_tpu_torch.models.cnn import SmallCNN, patches

CFG = dict(channels=(4, 8), kernel=5, hidden=32, num_classes=10)
N, B = 2, 3
LOGIT_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_REL_L2 = {"kernel": 1e-2, "bias": 5e-2}


@pytest.fixture
def jax_kernels(monkeypatch, request):
    """Force the JAX package's gate on or off for one test."""
    monkeypatch.setenv(pallas_gemm.ENV_KNOB, request.param)
    pallas_gemm.clear_cache()
    yield request.param
    pallas_gemm.clear_cache()


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(N, B)).astype(np.int32)
    return x, y


def _jax_node(model, params, x, y):
    def loss(p):
        return cross_entropy_loss(model.apply(p, x), y)

    logits = model.apply(params, x)
    value, grads = jax.value_and_grad(loss)(params)
    return np.asarray(logits), float(value), grads


@pytest.mark.parametrize("jax_kernels", ["on", "off"], indirect=True)
def test_small_cnn_forward_loss_grads_match_flax(jax_kernels):
    x, y = _data()
    fm = FlaxSmallCNN(**CFG)
    jparams = [fm.init(jax.random.PRNGKey(i), jnp.asarray(x[i]))
               for i in range(N)]
    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]),
                           *jparams)
    tparams = params_from_jax(stacked)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]

    model = SmallCNN(**CFG)
    logits = model(tparams, torch.from_numpy(x))
    loss = torch_ce(logits, torch.from_numpy(y),
                    torch.ones(N, B, dtype=torch.bool))
    grads = torch.autograd.grad(loss.sum(), leaves)
    tgrads = params_to_numpy(tree_unflatten(tparams, list(grads)))

    for i in range(N):
        jlogits, jloss, jgrads = _jax_node(fm, jparams[i], jnp.asarray(x[i]),
                                           jnp.asarray(y[i]))
        np.testing.assert_allclose(logits[i].detach().numpy(), jlogits,
                                   **LOGIT_TOL)
        np.testing.assert_allclose(float(loss[i].detach()), jloss, **LOGIT_TOL)
        flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
        for path, jg in flat:
            keys = [p.key for p in path]
            tg = tgrads
            for k in keys:
                tg = tg[k]
            jg = np.asarray(jg, np.float32)
            rel = np.linalg.norm(tg[i] - jg) / max(np.linalg.norm(jg), 1e-12)
            assert rel < GRAD_REL_L2[keys[-1]], (keys, rel)
    if jax_kernels == "on":
        assert any(rec["impl"] == "pallas"
                   for rec in pallas_gemm.decisions().values())


def test_init_tree_matches_flax_shapes_and_scale():
    """The port's own init: the flax tree's names and shapes, zero
    biases, lecun-normal kernels (std about sqrt(1/fan_in))."""
    x, _ = _data()
    fm = FlaxSmallCNN(**CFG)
    jtree = fm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    ttree = SmallCNN(**CFG).init(torch.Generator().manual_seed(0),
                                 torch.from_numpy(x[0]))

    def shapes(tree):
        return {k: {n: tuple(a.shape) for n, a in v.items()}
                for k, v in tree["params"].items()}

    assert shapes(jtree) == shapes(ttree)
    d0 = ttree["params"]["Dense_0"]["kernel"]
    assert abs(float(d0.std()) * np.sqrt(d0.shape[0]) - 1.0) < 0.1
    assert float(ttree["params"]["Conv_1"]["bias"].abs().sum()) == 0.0


@pytest.mark.parametrize("name", ["femnist-cnn", "mnist-cnn", "mnist-mlp"])
def test_registered_models_run_over_the_node_axis(name):
    model = get_model(name, **({"hidden": 16} if "cnn" in name else {}))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 28, 28, 1)).astype(np.float32))
    one = model.init(torch.Generator().manual_seed(0), x)
    stacked = {"params": {k: {n: t.unsqueeze(0).repeat(
        (3,) + (1,) * t.dim()) for n, t in v.items()}
        for k, v in one["params"].items()}}
    out = model(stacked, x.unsqueeze(0).expand(3, -1, -1, -1, -1))
    assert out.shape == (3, 2, model.num_classes) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    # identical nodes on identical inputs give identical logits
    assert torch.equal(out[0], out[2])


def test_vit_seq_axis_names_its_roadmap_item():
    """The ViT builds; its sequence-parallel attention (``seq_axis``)
    is not ported and raises naming ROADMAP item A24."""
    assert get_model("vit-tiny").depth == 12
    with pytest.raises(NotImplementedError, match="A24"):
        get_model("vit-tiny", seq_axis="sp")


def test_convert_carries_one_node_to_a_stack_and_back():
    x, _ = _data()
    jtree = FlaxSmallCNN(**CFG).init(jax.random.PRNGKey(3), jnp.asarray(x[0]))
    one = jax.tree.map(np.asarray, jtree)
    stacked = params_from_jax(one, n_nodes=3)
    back = params_to_numpy(stacked)
    for path, leaf in jax.tree_util.tree_flatten_with_path(one)[0]:
        t = back
        for k in path:
            t = t[k.key]
        assert t.shape == (3,) + leaf.shape
        for i in range(3):
            np.testing.assert_array_equal(t[i], leaf)  # exact copy


@pytest.mark.parametrize("k,c", [(5, 1), (5, 4), (3, 8)])
def test_patches_match_conv_general_dilated_patches(k, c):
    """The port's patch rows are JAX's SAME patches, value for value
    (pure copies: compared exactly), channel-major features."""
    x = np.random.default_rng(k * c).standard_normal(
        (2, 3, 14, 14, c)).astype(np.float32)
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x.reshape(6, 14, 14, c)), (k, k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = patches(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).reshape(2, 3 * 14 * 14, c * k * k))
