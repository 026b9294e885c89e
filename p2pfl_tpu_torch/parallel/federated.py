"""The federated round over the node axis, on one device.

The counterpart of ``p2pfl_tpu/parallel/federated.py`` for the dense
FedAvg path: every node trains its local epochs (one ``train_epochs``
call over the stacked ``[n, ...]`` state), then each node's aggregate
is row ``i`` of ``W @ params`` with ``W`` the row-normalised product of
the round plan's mixing matrix, the sample counts and the alive and
training masks — one ``[n, n] @ [n, d]`` matmul per leaf, a plain
PyTorch op as it was an XLA dot. Round plans are the JAX package's:
DFL mixes over adjacency plus self loops and adopts its own row;
CFL/SDFL mix everything at the leader and adopt the leader's row.

The mix runs in f32 with TF32 off: callers on CUDA keep
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default,
which ``Scenario`` sets explicitly). With ``exchange_dtype=bf16`` the
weights and parameters are rounded to bf16 and the products summed in
f32, as the JAX package's ``preferred_element_type=f32`` dot does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from p2pfl_tpu_torch.core.aggregators import FedAvg
from p2pfl_tpu_torch.core.pytree import Params, tree_map
from p2pfl_tpu_torch.learning.learner import StepFns, TrainState
from p2pfl_tpu_torch.topology.topology import Topology


@dataclasses.dataclass
class FederatedState:
    """Whole-federation state: every tensor has a leading ``[n]`` axis."""

    states: TrainState
    alive: torch.Tensor  # [n] bool
    round: int = 0


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Host-computed per-round schedule (see the JAX package)."""

    mix: np.ndarray  # [n, n] f32
    adopt: np.ndarray  # [n] int32
    trains: np.ndarray  # [n] bool


def make_round_plan(topology: Topology, roles: list[str],
                    federation: str = "DFL", leader: int = 0) -> RoundPlan:
    n = topology.n
    trains = np.array([r in ("trainer", "aggregator", "server") for r in roles])
    if federation == "DFL":
        mix = topology.adjacency.astype(np.float32) + np.eye(n, dtype=np.float32)
        adopt = np.arange(n, dtype=np.int32)
    elif federation in ("CFL", "SDFL"):
        mix = np.zeros((n, n), np.float32)
        mix[leader] = 1.0  # leader aggregates everyone (incl. itself)
        adopt = np.full((n,), leader, np.int32)
    else:
        raise ValueError(f"unknown federation {federation!r}")
    return RoundPlan(mix=mix, adopt=adopt.astype(np.int32), trains=trains)


def _where_node(cond: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _train_and_select(fns: StepFns, states: TrainState, alive, trains,
                      x, y, smask, epochs: int):
    """Local epochs on every node with the update gate ``trains &
    alive``: gated-off nodes keep their params bit-exact (the gate rides
    into the SGD step); their step count is kept explicitly."""
    sel = torch.logical_and(trains, alive)
    new_states, metrics = fns.train_epochs(states, x, y, smask, epochs,
                                           sel.float())
    new_states = dataclasses.replace(
        new_states, step=torch.where(sel, new_states.step, states.step))
    return new_states, metrics


def init_federation(fns: StepFns, sample_x: torch.Tensor, n_nodes: int,
                    seed: int = 0,
                    device: torch.device | str = "cpu") -> FederatedState:
    """Stacked init: every node starts from one draw (the reference's
    initial-model diffusion). Parameters are drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, so every device gets the
    same numbers; the shuffle stream is a generator on ``device``."""
    one = fns.init(torch.Generator().manual_seed(seed), sample_x.cpu())
    params = tree_map(lambda p: p.to(device).unsqueeze(0).repeat(
        (n_nodes,) + (1,) * p.dim()), one)
    rng = torch.Generator(device=device).manual_seed(seed + 1)
    states = TrainState(
        params=params,
        opt_state=fns.init_opt_state(params),
        rng=rng,
        step=torch.zeros(n_nodes, dtype=torch.int64, device=device),
    )
    return FederatedState(
        states=states,
        alive=torch.ones(n_nodes, dtype=torch.bool, device=device),
    )


def reseed_params(fed: FederatedState, fns: StepFns,
                  params: Params) -> FederatedState:
    """Restart a federation from ONE parameter tree: every node adopts
    ``params`` with a fresh (zero) optimizer state; rng, step, alive and
    round are kept."""
    n = fed.alive.shape[0]
    dev = fed.alive.device
    stack = tree_map(
        lambda p: p.to(dev).unsqueeze(0).repeat((n,) + (1,) * p.dim()),
        params)
    states = dataclasses.replace(fed.states, params=stack,
                                 opt_state=fns.init_opt_state(stack))
    return dataclasses.replace(fed, states=states)


def build_round_fn(
    fns: StepFns,
    aggregator: FedAvg | None = None,
    epochs: int = 1,
    exchange_dtype: torch.dtype | None = None,
    identity_adopt: bool = False,
) -> Callable:
    """Build ``round_fn(fed, x, y, mask, n_samples, mix, adopt, trains)
    -> (fed, metrics)``: the FedAvg fast path of the JAX package.

    ``exchange_dtype`` (bf16) rounds the weights and the parameters
    entering the mix; the sums stay f32. ``identity_adopt=True`` is the
    caller's promise that every plan adopts its own row (DFL): the adopt
    gather is skipped and the keep-select folds into the mix.
    """
    if aggregator is not None and type(aggregator) is not FedAvg:
        raise NotImplementedError(
            "only FedAvg is ported (ROADMAP.md queue A, item A14)")

    def mixed(wn: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        flat = p.reshape(p.shape[0], -1)
        if exchange_dtype is not None:
            wn = wn.to(exchange_dtype)
            flat = flat.to(exchange_dtype)
        out = torch.matmul(wn.float(), flat.float())  # [n,n]@[n,d], f32
        return out.reshape(p.shape).to(p.dtype)

    def round_fn(fed: FederatedState, x, y, smask, n_samples, mix, adopt,
                 trains):
        alive = fed.alive
        states, train_metrics = _train_and_select(
            fns, fed.states, alive, trains, x, y, smask, epochs)
        contrib = torch.logical_and(trains, alive)
        w = mix * (n_samples.float() * contrib.float())[None, :]
        denom = w.sum(1, keepdim=True).clamp(min=1e-9)
        wn = w / denom
        got_any = w.sum(1) > 0
        if identity_adopt:
            keep = torch.logical_and(alive, got_any)
            params = tree_map(lambda p: _where_node(keep, mixed(wn, p), p),
                              states.params)
        else:
            keep = torch.logical_and(alive, got_any[adopt])
            params = tree_map(
                lambda p: _where_node(keep, mixed(wn, p)[adopt], p),
                states.params)
        fed = FederatedState(
            states=dataclasses.replace(states, params=params),
            alive=alive,
            round=fed.round + 1,
        )
        return fed, {"train_loss": train_metrics["loss"], "alive": alive}

    return round_fn


def build_eval_fn(fns: StepFns) -> Callable:
    """Evaluate every node's model on the shared test set: per-node
    ``{loss: [n], accuracy: [n]}``."""

    def eval_fn(fed: FederatedState, x_test, y_test):
        mask = torch.ones(x_test.shape[0], dtype=torch.bool,
                          device=x_test.device)
        return fns.evaluate(fed.states.params, x_test, y_test, mask)

    return eval_fn
