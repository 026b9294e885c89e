"""ViT-Tiny for CIFAR-scale images: the counterpart of
``p2pfl_tpu/models/vit.py`` (``BASELINE.json``'s "ViT-Tiny federated
fine-tune, 32 nodes, Krum/trimmed-mean").

Patch 4, dim 192, 12 blocks, 3 heads and 10 classes by default, bf16
compute over f32 parameters, every node of a federation in one call:
parameters carry a leading ``[n]`` node axis and inputs are ``[n, b,
H, W, C]``. Each product is one ``torch.matmul`` batched over the nodes
(the JAX package's vmapped ``nn.Dense`` / ``DenseGeneral``, which it
computes outside Pallas too); the patch embedding, flax's biased HWIO
``nn.Conv`` at stride ``patch``, is the same product over patches
flattened in (kh, kw, cin) order. The tree carries flax's names and
shapes: ``patch_embed``, ``pos_embed [1, tokens, dim]``, the blocks
(``LayerNorm_0``, ``MultiHeadDotProductAttention_0`` with ``query``,
``key``, ``value`` kernels ``[dim, heads, head_dim]`` and ``out``
``[heads, head_dim, dim]``, ``LayerNorm_1``, ``Dense_0``, ``Dense_1``),
``LayerNorm_0`` and the ``Dense_0`` head.

Four layouts, as flax names them: ``TransformerBlock_i`` (plain),
``CheckpointTransformerBlock_i`` (``remat``: each block runs under
``torch.utils.checkpoint`` and is recomputed in the backward), and under
``scan_layers`` one ``blocks/TransformerBlock_0`` (or
``blocks/CheckpointTransformerBlock_0``) whose leaves gain a ``[depth]``
axis after the node axis; ``scan_layers`` changes only the layout.

The arithmetic is flax 0.12's at its rounding points:

- LayerNorm (epsilon 1e-6): statistics in f32 with the fast variance
  ``max(0, E[x²] - E[x]²)``, ``(x - mean) * (rsqrt(var + eps) * scale)
  + bias`` in f32, cast once to the compute dtype;
- attention (``dot_product_attention``): q divided by ``sqrt(head_dim)``
  in the compute dtype before the logits, the logits and the softmax in
  the compute dtype (``force_fp32_for_softmax`` is off), the softmax
  rounded where XLA rounds it (``softmax``); two batched products
  around it, with the node axis folded into the batch;
- GELU: flax's ``nn.gelu`` is the tanh form, evaluated op by op in the
  compute dtype with its constants rounded to that dtype (JAX's weak
  typing), which gives XLA's bits in bf16;
- the token mean in f32, rounded once (``jnp.mean`` of bf16);
- a residual add ``x + y`` is rounded to the compute dtype where the
  stream goes on, but the LayerNorm after it reads the f32 sum before
  that rounding: XLA drops the round trip bf16 -> f32 between the add
  and LayerNorm's f32 statistics (read from the compiled HLO of
  ``jax.jit``; with it a bf16 block from the same input gives flax's
  bits but for sum order, at most 0.1% of the elements one bf16 ulp
  apart). Blocks therefore pass the stream on as that f32 sum
  (``residual``); under ``scan_layers`` the scan's carry between blocks
  is the rounded stream, as in XLA's loop.

Each of ``linear``, ``attention``, ``layer_norm`` and ``gelu`` runs
under a ``torch.profiler.record_function`` scope of its name
(``vit.linear``, ...), so that a profiled round's device time can be
split by them (``chip_smoke.py`` phase 11); outside a profiler a scope
costs about a microsecond.

Neither ``torch.nn.functional.scaled_dot_product_attention`` nor
``F.gelu`` / ``F.layer_norm`` is used: SDPA's fused kernels keep the
logits and softmax in f32 and their backward may sum by atomics (a step
must repeat bit for bit), ``F.gelu`` rounds once where XLA rounds each
op, and a stacked ``[n, dim]`` scale does not fit ``F.layer_norm``.
``seq_axis`` (the JAX package's ring attention over a mesh axis) raises
naming ROADMAP item A24.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from p2pfl_tpu_torch.core.pytree import tree_map
from p2pfl_tpu_torch.models.base import (
    lecun_normal,
    node_bias,
    register_lora_targets,
    register_model,
    same_pads,
)

#: flax ``nn.LayerNorm``'s epsilon (PyTorch's ``F.layer_norm`` takes 1e-5)
LAYER_NORM_EPS = 1e-6


def _const(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as JAX's weak typing rounds
    a Python constant to the dtype of the array it meets."""
    return float(torch.tensor(value, dtype=like.dtype))


def linear(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` of every node: ``x [n, ..., d_in]`` times the
    stacked kernel ``[n, d_in, d_out]``, both in ``dtype`` (f32 sums,
    rounded once), plus the bias ``[n, d_out]`` in ``dtype``."""
    n, d_in = x.shape[0], x.shape[-1]
    with record_function("vit.linear"):
        y = torch.matmul(x.reshape(n, -1, d_in).to(dtype), kernel.to(dtype))
        y = y.reshape(x.shape[:-1] + (kernel.shape[-1],))
        return y + node_bias(bias, dtype, y.dim())


def layer_norm(x: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis of ``x [n, ..., d]`` with
    stacked ``scale`` and ``bias [n, d]`` (see the module docstring)."""
    with record_function("vit.layer_norm"):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * p["scale"].float().reshape(
            shape)
        y = (xf - mean) * mul + p["bias"].float().reshape(shape)
        return y.to(dtype)


def residual(s: torch.Tensor, y: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The residual add ``x + y`` in ``dtype``, with the stream ``x``
    given as the f32 sum ``s`` that rounds to it: returns the new f32
    sum, unrounded (its rounding is the new stream)."""
    return s.to(dtype).float() + y.float()


def _gelu_ops(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, op by op in x's dtype."""
    inner = _const(math.sqrt(2.0 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (1.0 + torch.tanh(inner)))


class _TanhGelu(torch.autograd.Function):
    """:func:`_gelu_ops` keeping only its input for the backward, which
    recomputes the ops (the same gradient as autograd through them, at
    one tensor saved instead of six)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_ops(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with record_function("vit.gelu"), torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            y = _gelu_ops(xg)
            return torch.autograd.grad(y, xg, g)[0]


def gelu(x: torch.Tensor) -> torch.Tensor:
    with record_function("vit.gelu"):
        return _TanhGelu.apply(x)


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last axis as XLA evaluates it in a
    narrow dtype: ``exp`` of the rounded ``s - max`` in f32, the sum of
    those f32 exponentials rounded once, the exponentials rounded, and
    their quotient rounded (the same bits as jitted JAX in bf16, and
    plain f32 softmax in f32). The backward is JAX's, ``y * (g - sum(y
    * g))``, from the saved output."""

    @staticmethod
    def forward(ctx, s):
        e = torch.exp((s - s.amax(-1, keepdim=True)).float())
        y = e.to(s.dtype) / e.sum(-1, keepdim=True).to(s.dtype)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        with record_function("vit.attention"):
            dot = (y * g).float().sum(-1, keepdim=True).to(y.dtype)
            return y * (g - dot)


def softmax(s: torch.Tensor) -> torch.Tensor:
    return _Softmax.apply(s)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """flax ``dot_product_attention`` of every node and image at once:
    q, k, v ``[n, b, s, heads * head_dim]`` in the compute dtype (the
    head axes flattened), the node, image and head axes folded into one
    batch of ``[s, s]`` logits. Returns ``[n, b, s, heads * head_dim]``."""
    n, b, s, d = q.shape
    dh = d // heads

    def split(t):  # [n, b, s, h*dh] -> [n*b*h, s, dh]
        return t.reshape(n * b, s, heads, dh).transpose(1, 2).reshape(
            n * b * heads, s, dh)

    with record_function("vit.attention"):
        q = q / _const(math.sqrt(dh), q)
        p = softmax(torch.bmm(split(q), split(k).transpose(1, 2)))
        o = torch.bmm(p, split(v))
        return o.reshape(n * b, heads, s, dh).transpose(1, 2).reshape(
            n, b, s, d)


def _dense_general_init(d_in: int, out: tuple[int, ...],
                        generator: torch.Generator) -> dict:
    """flax ``DenseGeneral``: a lecun-normal kernel drawn over the
    flattened ``[d_in, prod(out)]`` and reshaped, a zero bias."""
    width = math.prod(out)
    return {"kernel": lecun_normal((d_in, width), d_in,
                                   generator).reshape((d_in,) + out),
            "bias": torch.zeros(out)}


class TransformerBlock(nn.Module):
    """Pre-norm block: ``x + attn(LN(x))``, then ``x + MLP(LN(x))`` (the
    MLP ``Dense(dim * mlp_ratio)`` -> tanh GELU -> ``Dense(dim)``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.mlp_ratio = dim, heads, mlp_ratio
        self.dtype = dtype

    def tree(self, generator: torch.Generator) -> dict:
        d, h = self.dim, self.heads
        hidden = d * self.mlp_ratio
        attn = {name: _dense_general_init(d, (h, d // h), generator)
                for name in ("query", "key", "value")}
        attn["out"] = {
            "kernel": lecun_normal((d, d), d, generator).reshape(
                h, d // h, d),
            "bias": torch.zeros(d)}
        return {
            "LayerNorm_0": {"scale": torch.ones(d), "bias": torch.zeros(d)},
            "MultiHeadDotProductAttention_0": attn,
            "LayerNorm_1": {"scale": torch.ones(d), "bias": torch.zeros(d)},
            "Dense_0": {"kernel": lecun_normal((d, hidden), d, generator),
                        "bias": torch.zeros(hidden)},
            "Dense_1": {"kernel": lecun_normal((hidden, d), hidden,
                                               generator),
                        "bias": torch.zeros(d)},
        }

    def forward(self, p: dict, s: torch.Tensor) -> torch.Tensor:
        """``s [n, b, tokens, dim]``: the residual stream as the f32 sum
        that made it (see :class:`ViT`); returns the block's output the
        same way."""
        n, d, dt = s.shape[0], self.dim, self.dtype
        a = p["MultiHeadDotProductAttention_0"]
        y = layer_norm(s, p["LayerNorm_0"], dt)
        q, k, v = (linear(y, a[name]["kernel"].reshape(n, d, d),
                          a[name]["bias"].reshape(n, d), dt)
                   for name in ("query", "key", "value"))
        o = linear(attention(q, k, v, self.heads),
                   a["out"]["kernel"].reshape(n, d, d), a["out"]["bias"], dt)
        s = residual(s, o, dt)
        y = layer_norm(s, p["LayerNorm_1"], dt)
        y = gelu(linear(y, p["Dense_0"]["kernel"], p["Dense_0"]["bias"], dt))
        return residual(s, linear(y, p["Dense_1"]["kernel"],
                                  p["Dense_1"]["bias"], dt), dt)


class ViT(nn.Module):
    """ViT-Tiny by default: patch 4 (CIFAR-scale), dim 192, 12 blocks.
    ``init(generator, sample_x [b, H, W, C])`` returns one node's
    ``{"params": ...}``; ``forward(params, x [n, b, H, W, C])`` returns
    f32 logits ``[n, b, num_classes]``."""

    def __init__(self, patch: int = 4, dim: int = 192, depth: int = 12,
                 heads: int = 3, num_classes: int = 10,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 seq_axis: str | None = None, remat: bool = False,
                 scan_layers: bool = False):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(
                f"ViT(seq_axis={seq_axis!r}): ring and Ulysses attention "
                "over a sequence axis of several devices are not ported "
                "to p2pfl_tpu_torch yet (ROADMAP.md queue A, item A24)")
        self.patch, self.dim, self.depth = patch, dim, depth
        self.heads, self.num_classes = heads, num_classes
        self.dtype, self.param_dtype = dtype, param_dtype
        self.remat, self.scan_layers = remat, scan_layers
        self.block = TransformerBlock(dim, heads, dtype=dtype)
        self.block_name = ("CheckpointTransformerBlock" if remat
                           else "TransformerBlock")

    def _grid(self, h: int, w: int) -> tuple:
        """SAME padding of the patch conv and the token grid."""
        pads = same_pads(h, self.patch, self.patch), same_pads(
            w, self.patch, self.patch)
        return pads, -(-h // self.patch), -(-w // self.patch)

    def init(self, generator: torch.Generator,
             sample_x: torch.Tensor) -> dict:
        x = sample_x if sample_x.dim() == 4 else sample_x[..., None]
        _, gh, gw = self._grid(x.shape[1], x.shape[2])
        cin, d, k = x.shape[-1], self.dim, self.patch
        tree = {
            "patch_embed": {
                "kernel": lecun_normal((k, k, cin, d), k * k * cin,
                                       generator),
                "bias": torch.zeros(d)},
            "pos_embed": torch.randn((1, gh * gw, d),
                                     generator=generator) * 0.02,
        }
        blocks = [self.block.tree(generator) for _ in range(self.depth)]
        if self.scan_layers:
            tree["blocks"] = {f"{self.block_name}_0": tree_map(
                lambda *ts: torch.stack(ts), *blocks)}
        else:
            for i, blk in enumerate(blocks):
                tree[f"{self.block_name}_{i}"] = blk
        tree["LayerNorm_0"] = {"scale": torch.ones(d), "bias": torch.zeros(d)}
        tree["Dense_0"] = {"kernel": lecun_normal((d, self.num_classes), d,
                                                  generator),
                           "bias": torch.zeros(self.num_classes)}
        return {"params": tree_map(lambda t: t.to(self.param_dtype), tree)}

    def block_params(self, p: dict) -> list[dict]:
        """Each block's stacked tree ``[n, ...]``: the scanned layout's
        leaves unbound along their depth axis (views; the backward
        stacks their gradients in one op)."""
        if not self.scan_layers:
            return [p[f"{self.block_name}_{i}"] for i in range(self.depth)]
        stacked = p["blocks"][f"{self.block_name}_0"]
        per_leaf = tree_map(lambda t: t.unbind(1), stacked)
        return [tree_map(lambda t, i=i: t[i], per_leaf)
                for i in range(self.depth)]

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params["params"]
        if x.dim() == 4:
            x = x[..., None]
        n, b, h, w, c = x.shape
        k, dt = self.patch, self.dtype
        ((top, bottom), (left, right)), gh, gw = self._grid(h, w)
        x = x.to(dt)
        if top or bottom or left or right:
            x = F.pad(x, (0, 0, left, right, top, bottom))
        # [n, b, gh, k, gw, k, c] -> patches in (kh, kw, cin) order
        patches = x.reshape(n, b, gh, k, gw, k, c).permute(
            0, 1, 2, 4, 3, 5, 6).reshape(n, b, gh * gw, k * k * c)
        pe = p["patch_embed"]
        x = linear(patches, pe["kernel"].reshape(n, k * k * c, self.dim),
                   pe["bias"], dt)
        s = residual(x, p["pos_embed"].to(dt), dt)
        for bp in self.block_params(p):
            if self.scan_layers:  # the scan's carry is the rounded stream
                s = s.to(dt).float()
            if self.remat and torch.is_grad_enabled():
                s = checkpoint(self.block, bp, s, use_reentrant=False)
            else:
                s = self.block(bp, s)
        if self.scan_layers:
            s = s.to(dt).float()
        x = layer_norm(s, p["LayerNorm_0"], dt)
        x = x.float().mean(2).to(dt)
        return linear(x, p["Dense_0"]["kernel"], p["Dense_0"]["bias"],
                      dt).float()


@register_model("vit-tiny", "vit")
def _vit_tiny(num_classes: int = 10, **kw) -> ViT:
    return ViT(num_classes=num_classes, **kw)


# Adapter targets (learning/lora.py), as the JAX package registers them:
# the q/v pair by default; each pattern's (out_axes, base_ndim) kernel
# view: q/k/v kernels [dim, heads, head_dim] (two output axes), out
# [heads, head_dim, dim], the MLP's Dense [d_in, d_out], patch_embed
# [kh, kw, cin, cout]. Under scan_layers a block kernel's leading
# [depth] axis broadcasts: per-layer adapters in one product.
register_lora_targets(
    "vit-tiny", "vit",
    default=("query", "value"),
    specs={"query": (2, 3), "key": (2, 3), "value": (2, 3),
           "out": (1, 3), "Dense": (1, 2), "patch_embed": (1, 4)},
)
