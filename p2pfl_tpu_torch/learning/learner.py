"""Local training over the node axis: ``TrainState`` and ``make_step_fns``.

The counterpart of ``p2pfl_tpu/learning/learner.py::make_step_fns``.
Every tensor carries a leading ``[n]`` node axis, so one call trains
every node of a federation; the JAX package's ``vmap`` over nodes is
that axis written out, and its ``lax.scan`` over steps and epochs is a
Python loop. An epoch is the JAX package's: a fresh permutation of each
node's shard, drop-remainder batches, a masked-mean loss. The shuffle
is an index gather (the JAX package's one-hot matmul works around a TPU
gather and computes the same permutation).

The optimizers are optax's, written out (``make_optimizer`` of the JAX
package), not ``torch.optim``:

- ``sgd``: ``optax.sgd`` with momentum through the K4 kernel
  (``ops.gemm.sgd_accum_many``, one launch a step for every leaf); the
  state is the trace tree.
- ``adam`` and ``adamw``: ``optax.scale_by_adam`` (b1 0.9, b2 0.999,
  eps 1e-8, eps_root 0) in stock PyTorch ops (no TPU kernel exists for
  it); the state is an :class:`AdamState` ``(count [n] int32, mu,
  nu)``. ``mu`` is updated and bias-corrected in the gradient's dtype
  and only then cast to ``momentum_dtype`` for storage; adamw adds
  ``weight_decay * p`` to the adam direction before the ``-lr`` scale
  (decoupled decay). ``torch.optim.Adam`` is not used: its eps and
  bias-correction arithmetic is not optax's.

``sgd`` and ``adam`` apply ``weight_decay`` to the gradient explicitly,
before the gate. The per-node update gate keeps the JAX contract
(``learner.py`` ``apply_update``): a gated-off node's gradients are
zeroed with ``where`` (so a non-finite gradient cannot leak in) and
its parameters stay bit-exact. Under SGD its learning rate is
multiplied by 0 and its momentum decays; under adam the update still
runs on every node (``mu`` and ``nu`` decay, ``count`` increments, as
the vmapped ``tx.update`` does) and the updates are ``where``-zeroed.
Objectives: ``autoencoder`` takes its loss against the input, ``ocsvm``
adds ``ocsvm_penalty`` over the node's params; both report accuracy
0.0.
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
from p2pfl_tpu_torch.learning.objectives import (
    NO_ACCURACY_OBJECTIVES,
    get_objective,
    masked_accuracy,
    ocsvm_penalty,
)
from p2pfl_tpu_torch.ops import gemm

OPTIMIZERS = ("sgd", "adam", "adamw")
#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class AdamState:
    """``optax.ScaleByAdamState`` stacked over nodes."""

    count: torch.Tensor  # [n] int32, steps taken (saturating)
    mu: Params  # first moment, momentum_dtype (else the params' dtype)
    nu: Params  # second moment, the params' dtype


@dataclasses.dataclass
class TrainState:
    """The federation's training carry, every tensor stacked over nodes."""

    params: Params  # parameter tree, leaves [n, ...]
    opt_state: Params | AdamState  # sgd: the momentum trace tree
    rng: torch.Generator  # shuffle stream (one for all nodes)
    step: torch.Tensor  # [n] int64


@dataclasses.dataclass(frozen=True)
class StepFns:
    """The learner's pure-function core over the node axis."""

    init: Callable  # (generator, sample_x) -> one node's params (CPU)
    init_opt_state: Callable  # (params) -> zero optimizer state
    train_step: Callable  # (state, bx, by, bm, gate) -> (state, loss [n])
    train_epochs: Callable  # (state, x, y, mask, epochs, gate=None)
    # -> (state, {"loss": [n], "loss_per_epoch": [epochs, n]})
    evaluate: Callable  # (params, x, y, mask) -> {"loss", "accuracy"} [n]
    apply_update: Callable  # (state, grads, gate=None) -> state


def trace_dtype(momentum_dtype: str | None) -> torch.dtype | None:
    """The stored trace (sgd) or first moment (adam) dtype. None, like
    "f32" in the JAX package's ``make_optimizer``, keeps each leaf's own
    dtype (optax's ``accumulator_dtype=None``)."""
    if momentum_dtype in (None, "f32", "float32"):
        return None
    if momentum_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(
        f"momentum_dtype must be None/'f32'/'bf16', got {momentum_dtype!r}")


def _per_node(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _c(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype (a Python float is weakly
    typed in JAX: it takes the dtype of the array it meets)."""
    return float(torch.tensor(value, dtype=like.dtype))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` in f32 per node (optax's
    ``tree_bias_correction``, computed before any cast)."""
    base = torch.tensor(decay, dtype=torch.float32, device=count.device)
    return 1.0 - torch.pow(base, count.to(torch.float32))


def adam_update(params: Params, grads: Params, state: AdamState,
                learning_rate: float, weight_decay: float = 0.0,
                on: torch.Tensor | None = None) -> tuple[Params, AdamState]:
    """One ``optax.adam`` step (``adamw`` with ``weight_decay``) over
    stacked leaves, written out term by term:

    - ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 + b2 nu``, each
      product in its operand's dtype (a bf16 ``mu`` is multiplied in
      bf16, then the add promotes), ``count`` + 1 saturating at int32's
      maximum;
    - ``u = mu_hat / (sqrt(nu_hat) + eps)`` with ``mu_hat = mu / (1 -
      b1^count)`` from the uncast ``mu`` (the correction cast to the
      moment's dtype), ``nu_hat`` likewise;
    - adamw: ``u + weight_decay * p``; then ``u * -lr``, ``where``-zeroed
      on nodes whose ``on`` is False, and ``p + u`` rounded to p's dtype;
    - ``mu`` stored in its state dtype, ``nu`` in the params' dtype.

    Every node's moments and count advance, gated or not (the vmapped
    ``tx.update``). Returns ``(params', state')``."""
    count = torch.where(state.count < _INT32_MAX, state.count + 1,
                        state.count)
    bc1 = _bias_correction(ADAM_B1, count)
    bc2 = _bias_correction(ADAM_B2, count)

    def leaf(p, g, mu, nu):
        # each Python constant takes the dtype of the tensor it meets, as
        # JAX's weak typing casts it (bf16(0.9) is 0.8984375)
        mu_new = _c(1 - ADAM_B1, g) * g + _c(ADAM_B1, mu) * mu
        nu_new = _c(1 - ADAM_B2, g) * (g * g) + _c(ADAM_B2, nu) * nu
        mu_hat = mu_new / _per_node(bc1, p).to(mu_new.dtype)
        nu_hat = nu_new / _per_node(bc2, p).to(nu_new.dtype)
        u = mu_hat / (torch.sqrt(nu_hat) + _c(ADAM_EPS, nu_hat))
        if weight_decay:
            u = u + _c(weight_decay, p) * p
        u = _c(-learning_rate, u) * u
        if on is not None:
            u = torch.where(_per_node(on, u), u, torch.zeros_like(u))
        return (p + u).to(p.dtype), mu_new.to(mu.dtype), nu_new.to(nu.dtype)

    # paired by key, so a state in another key order (optax's sorted
    # dicts, through convert.py) meets the right leaves
    out = tree_map(leaf, params, grads, state.mu, state.nu)
    return (tree_map(lambda o: o[0], out),
            AdamState(count=count, mu=tree_map(lambda o: o[1], out),
                      nu=tree_map(lambda o: o[2], out)))


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
    optimizer = optimizer.lower()
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    tdt = trace_dtype(momentum_dtype)
    # decay on the explicit gradient for sgd and adam, decoupled (on the
    # updates, which the gate also zeroes) for adamw
    explicit_decay = weight_decay if optimizer != "adamw" else 0.0

    def init(generator: torch.Generator, sample_x: torch.Tensor) -> Params:
        return model.init(generator, sample_x)

    def init_opt_state(params: Params) -> Params | AdamState:
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=tdt or p.dtype),
                      params)
        if optimizer == "sgd":
            return mu
        n = tree_leaves(params)[0].shape[0]
        return AdamState(
            count=torch.zeros(n, dtype=torch.int32,
                              device=tree_leaves(params)[0].device),
            mu=mu, nu=tree_map(torch.zeros_like, params))

    def apply_update(state: TrainState, grads: Params,
                     gate: torch.Tensor | None = None) -> TrainState:
        """Explicit weight decay, the update gate, then the optimizer:
        one K4 launch over every leaf (sgd) or the adam step."""
        if explicit_decay:
            grads = tree_map(lambda g, p: g + explicit_decay * p, grads,
                             state.params)
        on = None
        if gate is not None:
            on = gate > 0
            grads = tree_map(
                lambda g: torch.where(_per_node(on, g), g,
                                      torch.zeros_like(g)), grads)
        if optimizer != "sgd":
            params, opt_state = adam_update(
                state.params, grads, state.opt_state, learning_rate,
                weight_decay if optimizer == "adamw" else 0.0, on)
            return dataclasses.replace(state, params=params,
                                       opt_state=opt_state,
                                       step=state.step + 1)
        first = tree_leaves(state.params)[0]
        lr = torch.full((first.shape[0],), learning_rate,
                        dtype=torch.float32, device=first.device)
        if gate is not None:
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

    def objective_of(out, params: Params, bx, by, bm) -> torch.Tensor:
        """The objective per node ``[n]`` of the model's output ``out``:
        against the labels, against the input (autoencoder), or plus the
        params' penalty (ocsvm)."""
        if objective == "autoencoder":
            return loss_fn(out, bx, bm)
        if objective == "ocsvm":
            return loss_fn(out, by, bm) + ocsvm_penalty(params)
        return loss_fn(out, by, bm)

    def train_step(state: TrainState, bx, by, bm,
                   gate: torch.Tensor | None = None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
            loss = objective_of(model(params, bx), params, bx, by, bm)
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
        gated-off nodes keep their params exactly while their optimizer
        state decays."""
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
            loss_sum += objective_of(out, params, xb, yb, mb) * cnt
            if objective not in NO_ACCURACY_OBJECTIVES:
                # the other objectives' outputs are not class logits:
                # their accuracy stays 0.0
                correct_sum += masked_accuracy(out, yb, mb) * cnt
            count += cnt
        count = count.clamp(min=1.0)
        return {"loss": loss_sum / count, "accuracy": correct_sum / count}

    return StepFns(init=init, init_opt_state=init_opt_state,
                   train_step=train_step, train_epochs=train_epochs,
                   evaluate=evaluate, apply_update=apply_update)

