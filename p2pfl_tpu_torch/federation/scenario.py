"""Scenario: build and run a whole federation on one device.

The counterpart of ``p2pfl_tpu/federation/scenario.py::Scenario`` for
what this port runs: the dense FedAvg round over stacked nodes, DFL,
CFL and SDFL plans, the train-set vote cap, periodic evaluation, and
``transport`` ``auto``/``dense`` (both mean the one dense mix here).
``ScenarioConfig`` rejects everything else before a run starts. There is
no membership clock (no faults are accepted, so every node stays
alive), no status publishing and no metrics logger yet.

    scenario = Scenario(ScenarioConfig(...))   # device "cuda" by default
    result = scenario.run()
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.core.aggregators import FedAvg
from p2pfl_tpu_torch.datasets.data import FederatedDataset
from p2pfl_tpu_torch.device import resolve_device
from p2pfl_tpu_torch.learning.learner import make_step_fns
from p2pfl_tpu_torch.models.base import build_model
from p2pfl_tpu_torch.parallel.federated import (
    build_eval_fn,
    build_round_fn,
    init_federation,
    make_round_plan,
)
from p2pfl_tpu_torch.topology.topology import generate_topology


@dataclasses.dataclass
class ScenarioResult:
    final_accuracy: float  # mean over alive nodes, central test set
    per_node_accuracy: list[float]
    rounds_run: int
    round_times_s: list[float]
    history: list[dict]  # one record per round
    rounds_to_target: int | None = None
    min_accuracy: float = 0.0


class Scenario:
    """Build and drive a federation from a ScenarioConfig."""

    def __init__(self, config: ScenarioConfig,
                 dataset: FederatedDataset | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the f32 FedAvg mix and dense layers run in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        n = config.n_nodes
        self.dataset = dataset or FederatedDataset.make(config.data, n)
        self.model = build_model(config.model)
        self.fns = make_step_fns(
            self.model,
            objective=config.model.objective,
            optimizer=config.training.optimizer,
            learning_rate=config.training.learning_rate,
            momentum=config.training.momentum,
            weight_decay=config.training.weight_decay,
            momentum_dtype=config.training.momentum_dtype,
            batch_size=config.data.batch_size,
        )
        self.topology = generate_topology(config.topology, n,
                                          **config.topology_kwargs)
        self.roles = [nc.role for nc in config.nodes]
        self.leader = next(
            (i for i, nc in enumerate(config.nodes)
             if nc.role in ("aggregator", "server")), 0)
        self._rng = np.random.default_rng(config.seed)

        dev = self.device
        x, y, smask, nsamp = self.dataset.stacked()
        self._data_args = (
            torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(smask).to(dev), torch.from_numpy(nsamp).to(dev),
        )
        self._x_test = torch.from_numpy(self.dataset.x_test).to(dev)
        self._y_test = torch.from_numpy(self.dataset.y_test).to(dev)
        exchange_dtype = (torch.bfloat16
                          if config.wire_dtype in ("bf16", "int8") else None)
        self._round_fn = build_round_fn(
            self.fns, aggregator=FedAvg(),
            epochs=config.training.epochs_per_round,
            exchange_dtype=exchange_dtype,
            # DFL plans adopt their own row: the adopt gather is elided
            identity_adopt=config.federation == "DFL",
        )
        self._eval_fn = build_eval_fn(self.fns)
        self.fed = init_federation(self.fns, torch.from_numpy(x[0, :1]), n,
                                   seed=config.seed, device=dev)

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rotate_leader(self, alive: np.ndarray) -> None:
        if self.config.federation == "SDFL":
            candidates = [i for i in np.flatnonzero(alive)
                          if self.roles[i] in ("aggregator", "trainer")]
            if candidates:
                self.leader = int(self._rng.choice(candidates))

    def _voted_trains(self, alive: np.ndarray,
                      round_num: int) -> np.ndarray | None:
        """The train-set vote at its deterministic fixed point (the JAX
        package's ``Scenario._voted_trains``): None when the
        ``train_set_size`` cap does not bind."""
        k = self.config.protocol.get("train_set_size", 10)
        n = self.config.n_nodes
        eligible = [i for i in np.flatnonzero(alive)
                    if self.roles[i] in ("trainer", "aggregator", "server")]
        if k <= 0 or k >= len(eligible):
            return None
        adj = self.topology.adjacency
        score = {j: 1 + int(np.sum(adj[np.flatnonzero(alive), j]))
                 for j in eligible}
        winners = sorted(score,
                         key=lambda j: (-score[j], (j - round_num) % n))[:k]
        win = set(winners)
        if self.config.federation in ("CFL", "SDFL") and alive[self.leader]:
            if self.leader not in win:
                win.discard(winners[-1])
                win.add(self.leader)
        trains = np.zeros(n, bool)
        trains[sorted(win)] = True
        return trains

    def _plan_args(self, trains_override: np.ndarray | None):
        plan = make_round_plan(self.topology, self.roles,
                               self.config.federation, self.leader)
        trains = plan.trains if trains_override is None else trains_override
        dev = self.device
        return (torch.from_numpy(plan.mix).to(dev),
                torch.from_numpy(plan.adopt).long().to(dev),
                torch.from_numpy(trains).to(dev))

    def evaluate(self) -> dict[str, Any]:
        metrics = self._eval_fn(self.fed, self._x_test, self._y_test)
        acc = metrics["accuracy"].double().cpu().numpy()
        loss = metrics["loss"].double().cpu().numpy()
        alive = self.fed.alive.cpu().numpy()
        return {
            "per_node_accuracy": [float(a) for a in acc],
            "per_node_loss": [float(v) for v in loss],
            "mean_accuracy": float(acc[alive].mean()) if alive.any() else 0.0,
            "min_accuracy": float(acc[alive].min()) if alive.any() else 0.0,
        }

    def run(self, rounds: int | None = None,
            target_accuracy: float | None = None) -> ScenarioResult:
        cfg = self.config
        rounds = rounds if rounds is not None else cfg.training.rounds
        round_times: list[float] = []
        history: list[dict] = []
        rounds_to_target = None
        ev = None
        ev_round = -1
        start_round = self.fed.round
        alive = self.fed.alive.cpu().numpy()
        for r in range(start_round, start_round + rounds):
            self._sync()
            t0 = time.monotonic()
            self._rotate_leader(alive)
            trains_vote = self._voted_trains(alive, r)
            self.fed, metrics = self._round_fn(
                self.fed, *self._data_args, *self._plan_args(trains_vote))
            self._sync()
            dt = time.monotonic() - t0
            round_times.append(dt)
            rec = {"round": r, "round_time_s": dt,
                   "train_loss": metrics["train_loss"].double().cpu().tolist()}
            if cfg.training.eval_every and (r + 1) % cfg.training.eval_every == 0:
                ev = self.evaluate()
                ev_round = r
                rec["eval"] = ev
                if (target_accuracy is not None and rounds_to_target is None
                        and ev["mean_accuracy"] >= target_accuracy):
                    rounds_to_target = r + 1
            history.append(rec)
        last_round = start_round + rounds - 1
        if ev is None or ev_round != last_round:
            ev = self.evaluate()
            if (target_accuracy is not None and rounds_to_target is None
                    and ev["mean_accuracy"] >= target_accuracy):
                rounds_to_target = last_round + 1
        return ScenarioResult(
            final_accuracy=ev["mean_accuracy"],
            per_node_accuracy=ev["per_node_accuracy"],
            rounds_run=rounds,
            round_times_s=round_times,
            history=history,
            rounds_to_target=rounds_to_target,
            min_accuracy=ev["min_accuracy"],
        )
