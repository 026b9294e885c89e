"""Local training over the node axis: ``TrainState`` and ``make_step_fns``;
and one node's learner for the socket plane, ``TorchLearner``.

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

``SharedTrainer`` and ``TorchLearner`` are the JAX package's
``SharedTrainer`` and ``JaxLearner`` for the socket plane
(``p2p/node.py``); the JAX package's ``NodeLearner`` contract is
``TorchLearner``'s public methods. A ``TorchLearner`` is the stacked
step at n = 1 on its device, so a node's fit takes the stacked
federation's kernels. Its fit, evaluation, parameter loads and warm-up
hold one lock per device. Its fit and evaluation record the
``learner.fit`` and ``learner.evaluate`` spans (obs.trace) once the lock
is held, and under ``P2PFL_DEVPROF`` the fit leaves its gauges in
``devprof_last`` (obs.devprof; ``step`` runs the step's phases apart).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import (
    Params,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from p2pfl_tpu_torch.core.serialize import (
    check_parameters,
    decode_parameters,
    encode_parameters,
    to_host,
)
from p2pfl_tpu_torch.learning.objectives import (
    NO_ACCURACY_OBJECTIVES,
    get_objective,
    masked_accuracy,
    ocsvm_penalty,
)
from p2pfl_tpu_torch.obs import devprof
from p2pfl_tpu_torch.obs.trace import get_tracer
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
    # the step's phases (obs.devprof's step mode times each apart);
    # train_step and train_epochs are built from them
    prepare_epoch: Callable  # (state, x, y, mask) -> (bx, by, bm), each
    # [n, steps, bsz, ...]
    forward: Callable  # (params, bx, by, bm) -> (loss [n], grad leaves)
    backward: Callable  # (params, grad leaves, loss) -> grads tree


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

    def forward(params: Params, bx, by, bm):
        """The forward pass and the loss ``[n]``, with the autograd
        graph over fresh leaves of ``params`` (returned for
        :func:`backward`)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss = objective_of(model(tree, bx), tree, bx, by, bm)
        return loss, leaves

    def backward(params: Params, leaves: list, loss: torch.Tensor) -> Params:
        """The gradient of ``loss.sum()`` with respect to the leaves
        :func:`forward` returned, as a tree shaped like ``params``."""
        with torch.enable_grad():
            grads = torch.autograd.grad(loss.sum(), leaves)
        return tree_unflatten(params, list(grads))

    def train_step(state: TrainState, bx, by, bm,
                   gate: torch.Tensor | None = None):
        loss, leaves = forward(state.params, bx, by, bm)
        state = apply_update(state, backward(state.params, leaves, loss),
                             gate)
        return state, loss.detach()

    def prepare_epoch(state: TrainState, x, y, mask):
        """The epoch's shuffle (a fresh permutation of each node's shard
        from ``state.rng``) laid out as drop-remainder batches ``[n,
        steps, bsz, ...]``."""
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
        return bx, by, bm

    def train_one_epoch(state: TrainState, x, y, mask, gate):
        n = x.shape[0]
        bx, by, bm = prepare_epoch(state, x, y, mask)
        steps = bx.shape[1]
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
                   evaluate=evaluate, apply_update=apply_update,
                   prepare_epoch=prepare_epoch, forward=forward,
                   backward=backward)



# ---- one node: the socket plane's learner ---------------------------------

#: one lock per device around a learner's fit, evaluate and warm-up: the
#: socket plane runs every node's fit from the event loop's executor,
#: and the kernels' launch counts and the extension's first load are
#: process-wide state. The lock changes no result; it serializes the
#: host side of the fits that one card would run one after another.
_DEVICE_LOCKS: dict[tuple[str, int | None], threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def device_lock(device: torch.device | str) -> threading.Lock:
    """``device``'s lock, keyed by the device it resolves to: ``cuda``
    and ``cuda:0`` name one card and share one lock."""
    dev = torch.device(device)
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    with _LOCKS_LOCK:
        return _DEVICE_LOCKS.setdefault((dev.type, index), threading.Lock())


def _onto_device(new, like: torch.Tensor) -> torch.Tensor:
    """The host leaf ``new`` (of ``like``'s dtype and shape without the
    node axis) as ``like``'s ``[1, ...]`` tensor on ``like``'s device:
    one host copy, into pinned memory on the card's side, then one
    host-to-device copy."""
    buf = torch.empty(like.shape[1:], dtype=like.dtype,
                      pin_memory=like.is_cuda)
    src = np.asarray(new)
    if like.dtype == torch.bfloat16:  # the leaf's words
        buf, src = buf.view(torch.int16), src.view(np.int16)
    np.copyto(buf.numpy(), src.reshape(buf.shape))
    if like.dtype == torch.bfloat16:
        buf = buf.view(torch.bfloat16)
    if like.is_cuda:
        buf = buf.to(like.device, non_blocking=True)
    return buf.unsqueeze(0)


class SharedTrainer:
    """One model and one set of step functions for many same-config
    learners (the JAX package's ``SharedTrainer``: there, one compile)."""

    def __init__(self, model, objective="classification", optimizer="sgd",
                 learning_rate=0.1, momentum=0.9, weight_decay=0.0,
                 momentum_dtype=None, batch_size=32):
        self.model = model
        self.fns = make_step_fns(
            model, objective=objective, optimizer=optimizer,
            learning_rate=learning_rate, momentum=momentum,
            weight_decay=weight_decay, momentum_dtype=momentum_dtype,
            batch_size=batch_size)


class TorchLearner:
    """One node's learner: the stacked step at n = 1 on ``device``, so a
    node's fit takes the stacked federation's route (K1-K3 in the FEMNIST
    CNN, K4 for every SGD step).

    ``get_parameters`` returns the flax-named tree without the node axis
    as host numpy (the envelope's input), copied off the device at the
    end of ``fit`` (in the caller's thread: the socket plane's executor)
    and kept until the params change. ``set_parameters`` checks the tree
    against the model's, keeps its host leaves as ``get_parameters``'
    answer and copies them onto the device once each (the socket plane
    calls it from its executor, as it does ``fit``); the optimizer
    state carries over, as in the JAX package. ``fit`` runs epoch by
    epoch and honours ``interrupt_fit`` at epoch boundaries. The shuffle
    stream is the learner's own ``torch.Generator`` on ``device``, seeded
    with ``seed + 1``; the weights are drawn on the CPU from ``seed``.
    """

    def __init__(self, model=None, data=None, objective="classification",
                 optimizer="sgd", learning_rate=0.1, momentum=0.9,
                 weight_decay=0.0, momentum_dtype=None, batch_size=32,
                 seed=0, trainer: SharedTrainer | None = None,
                 device: torch.device | str = "cuda"):
        from p2pfl_tpu_torch.device import card_numerics, resolve_device

        self.device = resolve_device(device)
        card_numerics(self.device)
        self.model = model if trainer is None else trainer.model
        self.data = data
        self._config = dict(objective=objective, optimizer=optimizer,
                            learning_rate=learning_rate, momentum=momentum,
                            weight_decay=weight_decay,
                            momentum_dtype=momentum_dtype,
                            batch_size=batch_size)
        self.batch_size = batch_size
        self.seed = seed
        self.epochs = 1
        self.state: TrainState | None = None
        self.fns: StepFns | None = None
        self._shared = trainer
        self._host = None  # get_parameters' tree, None when stale
        self._xy = None  # the shard on the device
        self.global_step = 0
        self.local_step = 0
        self.round = 0
        self._interrupted = False
        #: the train loss of each fit's last epoch
        self.train_losses: list[float] = []
        #: the last fit's devprof_* gauges (MFU, TFLOPs, memory) for the
        #: status publisher; empty until a fit completes with devprof on
        self.devprof_last: dict = {}
        self._devprof_wall = 0.0
        self._devprof_epochs = 0
        self._lock = device_lock(self.device)

    # -- wiring ----------------------------------------------------------
    def set_model(self, model) -> None:
        self.model = model
        self.fns = None

    def set_data(self, data) -> None:
        self.data = data
        self._xy = None

    def create_trainer(self) -> None:
        self.fns = (self._shared.fns if self._shared is not None
                    else make_step_fns(self.model, **self._config))

    def init(self) -> None:
        if self.fns is None:
            self.create_trainer()
        sample = torch.from_numpy(np.ascontiguousarray(self.data.x[:1]))
        one = self.fns.init(torch.Generator().manual_seed(self.seed), sample)
        params = tree_map(lambda p: p.to(self.device).unsqueeze(0), one)
        self.state = TrainState(
            params=params, opt_state=self.fns.init_opt_state(params),
            rng=torch.Generator(device=self.device).manual_seed(self.seed + 1),
            step=torch.zeros(1, dtype=torch.int64, device=self.device))
        self._host = None

    # -- parameters ------------------------------------------------------
    def get_parameters(self):
        if self._host is None:
            # on the CPU, a copy: the host tree outlives the state
            cpu = self.device.type == "cpu"
            self._host = tree_map(
                lambda p: to_host(p[0]).copy() if cpu else to_host(p[0]),
                self.state.params)
        return self._host

    def set_parameters(self, params) -> None:
        check_parameters(params, self.get_parameters())
        # the incoming host leaves answer get_parameters from now on
        host = tree_map(lambda old, new: to_host(new), self.state.params,
                        params)
        # under the device lock, as every copy onto the card: a step-mode
        # fit's synchronize then waits for its own node's work only
        with self._lock:
            self._host = host
            self.state = dataclasses.replace(self.state, params=tree_map(
                _onto_device, host, self.state.params))

    def device_parameters(self):
        """A copy of the params on the device, without the node axis (an
        update's reference: the round's starting params)."""
        with self._lock:
            return tree_map(lambda p: p[0].clone(), self.state.params)

    def transform_parameters(self, fn) -> None:
        """Replace the params by ``fn(params)`` on the device, ``params``
        being the node's row without the node axis (a socket node's
        attack and DP, with the stacked rows' arithmetic); the host copy
        ``get_parameters`` answers with is taken here."""
        with self._lock:
            new = fn(tree_map(lambda p: p[0], self.state.params))
            self.state = dataclasses.replace(self.state, params=tree_map(
                lambda n, p: n.to(p.dtype).reshape(p.shape).contiguous(),
                new, self.state.params))
            self._host = None
            self.get_parameters()

    def check_parameters(self, params) -> bool:
        try:
            check_parameters(params, self.get_parameters())
            return True
        except Exception:
            return False

    def encode_parameters(self, params=None, contributors=None,
                          weight=1) -> bytes:
        if params is None:
            params = self.get_parameters()
        return encode_parameters(params, tuple(contributors or ()), weight)

    def decode_parameters(self, data: bytes):
        return decode_parameters(data)

    # -- training --------------------------------------------------------
    def set_epochs(self, epochs: int) -> None:
        self.epochs = epochs

    def _train_args(self):
        if self._xy is None:
            d, dev = self.data, self.device
            x = torch.from_numpy(np.ascontiguousarray(d.x)).to(dev)
            y = torch.from_numpy(np.ascontiguousarray(d.y)).to(dev)
            self._xy = (x.unsqueeze(0), y.unsqueeze(0),
                        torch.ones((1, len(d.x)), dtype=torch.bool,
                                   device=dev))
        return self._xy

    def fit(self) -> None:
        if self.epochs <= 0:
            return
        if self._interrupted:  # honour a pending interrupt_fit()
            self._interrupted = False
            return
        # the span opens once the device is this node's: a wait for
        # another node's fit is not this fit's time
        with self._lock, get_tracer().span(
                "learner.fit", args={"round": self.round,
                                     "epochs": self.epochs}):
            epochs_run = self._fit_locked()
        # gauges AFTER the span closes: the once-per-shape FLOP count
        # must not bill itself to learner.fit
        if devprof.enabled() and self._devprof_wall:
            self.devprof_last = devprof.fit_gauges(
                self, self._devprof_wall, self._devprof_epochs)
        self.local_step = (max(len(self.data.x) // self.batch_size, 1)
                           * epochs_run)

    def _fit_locked(self) -> int:
        x, y, mask = self._train_args()
        t0 = time.monotonic()
        self._devprof_wall = 0.0  # stays 0 on an interrupted fit
        # step-level devprof runs the step functions' phases apart, each
        # closed by a synchronize inside its span; otherwise the fused
        # epoch runs untouched
        step_prof = devprof.step_enabled()
        epochs_run = 0
        for _ in range(self.epochs):
            if self._interrupted:
                self._interrupted = False
                break
            if step_prof:
                self.state, metrics = devprof.profiled_epoch(
                    self, x, y, mask)
            else:
                self.state, metrics = self.fns.train_epochs(
                    self.state, x, y, mask, epochs=1)
            epochs_run += 1
        self._host = None
        # the device-to-host copy, here; it also ends the fit's device
        # work, so the wall below needs no synchronize of its own
        with (get_tracer().span("devprof.accum") if step_prof
              else contextlib.nullcontext()):
            self.get_parameters()
        if epochs_run:
            self.train_losses.append(float(metrics["loss"][0]))
            self._devprof_wall = time.monotonic() - t0
            self._devprof_epochs = epochs_run
        return epochs_run

    def warm_up(self) -> None:
        """Build (or load) the kernels, and so the device's context,
        before the round clock starts; the state is not changed (the JAX
        package compiles fit's programs here)."""
        if self.fns is None:
            self.create_trainer()
        if self.state is None:
            self.init()
        if self.device.type == "cuda":
            from p2pfl_tpu_torch.ops import _build

            with self._lock:
                _build.kernels()

    def interrupt_fit(self) -> None:
        """Stop at the next epoch boundary (or skip the next fit)."""
        self._interrupted = True

    def evaluate(self):
        d = self.data
        x, y = (d.x_val, d.y_val) if len(d.x_val) else (d.x, d.y)
        with self._lock, get_tracer().span("learner.evaluate",
                                           args={"round": self.round}):
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            yt = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
            mask = torch.ones(len(x), dtype=torch.bool, device=self.device)
            metrics = self.fns.evaluate(self.state.params, xt, yt, mask)
            return {k: float(v[0]) for k, v in metrics.items()}

    def get_num_samples(self) -> tuple[int, int]:
        return (self.data.n_samples, len(self.data.x_val))

    # -- lifecycle -------------------------------------------------------
    def finalize_round(self) -> None:
        self.global_step += self.local_step
        self.local_step = 0
        self.round += 1

    def close(self) -> None:
        self.state = None
        self._host = None
        self._xy = None
