"""Local training over the node axis: ``TrainState`` and ``make_step_fns``.

The counterpart of ``p2pfl_tpu/learning/learner.py::make_step_fns``.
Every tensor carries a leading ``[n]`` node axis, so one call trains
every node of a federation; the JAX package's ``vmap`` over nodes is
that axis written out, and its ``lax.scan`` over steps and epochs is a
Python loop. An epoch is the JAX package's: a fresh permutation of each
node's shard, drop-remainder batches, a masked-mean loss. The shuffle
is an index gather (the JAX package's one-hot matmul works around a TPU
gather and computes the same permutation).

The optimizer is ``optax.sgd`` with momentum written out through the K4
kernel (``ops.gemm.sgd_accum_many``, one launch a step for every leaf),
not ``torch.optim``. The per-node
update gate keeps the JAX contract (``learner.py`` ``apply_update``): a
gated-off node's gradients are zeroed with ``where`` (so a non-finite
gradient cannot leak in), its learning rate is multiplied by 0, its
parameters stay bit-exact and its momentum decays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from p2pfl_tpu_torch.core.pytree import (
    Params,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from p2pfl_tpu_torch.learning.objectives import get_objective, masked_accuracy
from p2pfl_tpu_torch.ops import gemm


@dataclasses.dataclass
class TrainState:
    """The federation's training carry, every tensor stacked over nodes."""

    params: Params  # parameter tree, leaves [n, ...]
    opt_state: Params  # the momentum trace, same tree, trace dtype
    rng: torch.Generator  # shuffle stream (one for all nodes)
    step: torch.Tensor  # [n] int64


@dataclasses.dataclass(frozen=True)
class StepFns:
    """The learner's pure-function core over the node axis."""

    init: Callable  # (generator, sample_x) -> one node's params (CPU)
    init_opt_state: Callable  # (params) -> zero momentum trace
    train_step: Callable  # (state, bx, by, bm, gate) -> (state, loss [n])
    train_epochs: Callable  # (state, x, y, mask, epochs, gate=None)
    # -> (state, {"loss": [n], "loss_per_epoch": [epochs, n]})
    evaluate: Callable  # (params, x, y, mask) -> {"loss", "accuracy"} [n]


def trace_dtype(momentum_dtype: str | None) -> torch.dtype:
    if momentum_dtype in (None, "f32", "float32"):
        return torch.float32
    if momentum_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(
        f"momentum_dtype must be None/'f32'/'bf16', got {momentum_dtype!r}")


def _per_node(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def make_step_fns(
    model,
    objective: str = "classification",
    optimizer: str = "sgd",
    learning_rate: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    momentum_dtype: str | None = None,
    batch_size: int = 32,
    eval_batch_size: int = 512,
) -> StepFns:
    """Build init / train / eval for a model of ``p2pfl_tpu_torch.models``."""
    loss_fn = get_objective(objective)
    if optimizer.lower() != "sgd":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported to p2pfl_tpu_torch yet "
            "(ROADMAP.md queue A, item A15)")
    tdt = trace_dtype(momentum_dtype)

    def init(generator: torch.Generator, sample_x: torch.Tensor) -> Params:
        return model.init(generator, sample_x)

    def init_opt_state(params: Params) -> Params:
        return tree_map(lambda p: torch.zeros_like(p, dtype=tdt), params)

    def apply_update(state: TrainState, grads: Params,
                     gate: torch.Tensor | None) -> TrainState:
        """Explicit weight decay, the update gate, one K4 launch over
        every leaf."""
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             state.params)
        first = tree_leaves(state.params)[0]
        lr = torch.full((first.shape[0],), learning_rate,
                        dtype=torch.float32, device=first.device)
        if gate is not None:
            on = gate > 0
            grads = tree_map(
                lambda g: torch.where(_per_node(on, g), g,
                                      torch.zeros_like(g)), grads)
            lr = lr * gate
        # one K4 launch for every leaf (opt_state and grads are built
        # from params, so their leaves come in the same order)
        ps, ms = gemm.sgd_accum_many(
            tree_leaves(state.params), tree_leaves(state.opt_state),
            tree_leaves(grads), lr, momentum=momentum)
        return dataclasses.replace(
            state, params=tree_unflatten(state.params, ps),
            opt_state=tree_unflatten(state.opt_state, ms),
            step=state.step + 1)

    def train_step(state: TrainState, bx, by, bm,
                   gate: torch.Tensor | None = None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
            loss = loss_fn(model(params, bx), by, bm)  # [n]
            grads = torch.autograd.grad(loss.sum(), leaves)
        state = apply_update(state, tree_unflatten(state.params, list(grads)),
                             gate)
        return state, loss.detach()

    def train_one_epoch(state: TrainState, x, y, mask, gate):
        n, s = x.shape[0], x.shape[1]
        bsz = min(batch_size, s)  # shards smaller than a batch still train
        steps = s // bsz
        used = steps * bsz
        perm = torch.argsort(
            torch.rand((n, s), generator=state.rng, device=x.device),
            dim=1)[:, :used]
        rows = torch.arange(n, device=x.device)[:, None]
        bx = x[rows, perm].reshape((n, steps, bsz) + x.shape[2:])
        by = y[rows, perm].reshape(n, steps, bsz)
        bm = mask[rows, perm].reshape(n, steps, bsz)
        loss_sum = torch.zeros(n, device=x.device)
        for i in range(steps):
            state, loss = train_step(state, bx[:, i], by[:, i], bm[:, i],
                                     gate)
            loss_sum = loss_sum + loss
        return state, loss_sum / steps

    def train_epochs(state: TrainState, x, y, mask, epochs: int,
                     gate: torch.Tensor | None = None):
        """``gate`` (optional ``[n]`` f32 of 1.0/0.0) scales every update:
        gated-off nodes keep their params exactly while their momentum
        decays."""
        losses = []
        for _ in range(epochs):
            state, loss = train_one_epoch(state, x, y, mask, gate)
            losses.append(loss)
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "loss_per_epoch": losses}

    @torch.no_grad()
    def evaluate(params: Params, x, y, mask):
        """Every node's model on one shared set ``x [S, ...]``, in
        batches of ``eval_batch_size``; per-node loss and accuracy."""
        n = tree_leaves(params)[0].shape[0]
        dev = x.device
        loss_sum = torch.zeros(n, device=dev)
        correct_sum = torch.zeros(n, device=dev)
        count = torch.zeros((), device=dev)
        for start in range(0, x.shape[0], eval_batch_size):
            xb = x[start:start + eval_batch_size]
            b = xb.shape[0]
            xb = xb.unsqueeze(0).expand((n,) + xb.shape)
            yb = y[start:start + b].unsqueeze(0).expand(n, b)
            mb = mask[start:start + b].unsqueeze(0).expand(n, b)
            out = model(params, xb)
            cnt = mb[0].float().sum()
            loss_sum += loss_fn(out, yb, mb) * cnt
            correct_sum += masked_accuracy(out, yb, mb) * cnt
            count += cnt
        count = count.clamp(min=1.0)
        return {"loss": loss_sum / count, "accuracy": correct_sum / count}

    return StepFns(init=init, init_opt_state=init_opt_state,
                   train_step=train_step, train_epochs=train_epochs,
                   evaluate=evaluate)

