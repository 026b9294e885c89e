"""Scenarios: build and run a whole federation on one device.

The counterpart of ``p2pfl_tpu/federation/scenario.py`` for what this
port runs:

- ``Scenario``: the dense round over stacked nodes, DFL, CFL and SDFL
  plans, every registered aggregator (one shared robust aggregate for
  CFL/SDFL and fully connected DFL), attack injection and label flips
  on the malicious rows, reputation-weighted mixing, DP-FedAvg on every
  training row, the async staleness scale, the train-set vote cap,
  periodic evaluation, adapter-only federation (``lora``: the model is
  wrapped by ``learning.lora.maybe_wrap_lora`` over a frozen base, and
  every row trains and ships adapters), and ``transport``
  ``auto``/``dense`` (both mean the one dense mix here);
- ``CrossDeviceScenario``: the sampled K-of-N cross-device regime, a
  cohort scan through ``n_slots`` slots, materialized or streamed.

Each round first applies the round's scripted faults and advances the
membership clock (``federation/membership.py``: one heartbeat period a
round, eviction after ``node_timeout_s`` of silence), over the nodes or
over every virtual client; a ``join`` copies the leader's params into
the joiner's row; SDFL rotates its leader among the alive nodes and
CFL fails over to the lowest alive index. Both scenarios are
``Observable`` and fire the JAX package's round events; the membership
fires the node events. ``ScenarioConfig`` rejects everything else
before a run starts.

Round-boundary services, as in the JAX package: with ``log_dir`` a
``MetricsLogger`` (``<log_dir>/<name>/metrics.jsonl``, per-node CSVs,
optional TensorBoard and wandb), per-node status records
(``<log_dir>/<name>/status/``) and the flight recorder's dumps
(``<log_dir>/<name>/flight/``); under ``P2PFL_TRACE`` a
``scenario.round`` span a round, exported when the run ends
(``obs/trace.py``; ``1`` exports to ``<log_dir>/<name>/trace/``); under
``P2PFL_DEVPROF`` the round's ``devprof_*`` gauges in every status
record, from one FLOP count of the round (every node's fit through the
plain versions, and the mix; ``obs/cost_model.py``); with
``profile_dir`` one steady-state round (the run's second) traced by
``torch.profiler`` into a Chrome trace there; with ``checkpoint_dir`` a
``Scenario`` resumes from the newest file that loads (replaying the
membership clock and the leader through the restored rounds) and saves
every ``checkpoint_every`` rounds (``federation/checkpoint.py``).
``exchange_overlap="staged"`` seeds the staged exchange's buffer before
the resume.

    scenario = Scenario(ScenarioConfig(...))   # device "cuda" by default
    result = scenario.run()
    result = CrossDeviceScenario(cfg, device="cpu").run()
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any

import numpy as np
import torch

from p2pfl_tpu_torch.adversary import (
    AttackSpec,
    ReputationMonitor,
    flip_labels,
    malicious_indices,
)
from p2pfl_tpu_torch.config.schema import ScenarioConfig
from p2pfl_tpu_torch.core.aggregators import get_aggregator
from p2pfl_tpu_torch.datasets.data import CrossDeviceData, FederatedDataset
from p2pfl_tpu_torch.core.pytree import tree_leaves, tree_map
from p2pfl_tpu_torch.device import card_numerics, resolve_device
from p2pfl_tpu_torch.federation.checkpoint import (
    all_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from p2pfl_tpu_torch.federation.events import Events, Observable
from p2pfl_tpu_torch.federation.membership import Membership
from p2pfl_tpu_torch.federation.sampling import sample_cohorts
from p2pfl_tpu_torch.learning.learner import make_step_fns
from p2pfl_tpu_torch.learning.lora import maybe_wrap_lora
from p2pfl_tpu_torch.models.base import build_model
from p2pfl_tpu_torch.obs import cost_model, devprof, flight
from p2pfl_tpu_torch.obs import trace as obs_trace
from p2pfl_tpu_torch.parallel.federated import (
    build_cross_device_stream_fns,
    build_eval_fn,
    build_round_fn,
    build_round_fn_cross_device,
    cross_device_wn,
    init_federation,
    make_round_plan,
    staleness_scale,
    with_staged_buffer,
)
from p2pfl_tpu_torch.privacy.dp import DPSpec, PrivacyAccountant
from p2pfl_tpu_torch.topology.topology import generate_topology
from p2pfl_tpu_torch.utils.metrics import MetricsLogger
from p2pfl_tpu_torch.utils.monitor import publish_status
from p2pfl_tpu_torch.utils.telemetry import resource_snapshot


@dataclasses.dataclass
class ScenarioResult:
    final_accuracy: float  # mean over alive nodes, central test set
    per_node_accuracy: list[float]
    rounds_run: int
    round_times_s: list[float]
    history: list[dict]  # one record per round
    rounds_to_target: int | None = None
    min_accuracy: float = 0.0


def _resolve(device: torch.device | str) -> torch.device:
    # the f32 FedAvg mix, dense layers and convs run in full f32, as in
    # the JAX package; K2's slice plan fixes its sum order for the same
    # bit-for-bit repeatability as cuDNN's deterministic algorithms
    dev = resolve_device(device)
    card_numerics(dev)
    return dev


def _step_fns(model, config: ScenarioConfig):
    return make_step_fns(
        model,
        objective=config.model.objective,
        optimizer=config.training.optimizer,
        learning_rate=config.training.learning_rate,
        momentum=config.training.momentum,
        weight_decay=config.training.weight_decay,
        momentum_dtype=config.training.momentum_dtype,
        batch_size=config.data.batch_size,
    )


def _exchange_dtype(config: ScenarioConfig) -> torch.dtype | None:
    return torch.bfloat16 if config.wire_dtype in ("bf16", "int8") else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _faults_by_round(config: ScenarioConfig) -> dict[int, list]:
    by_round: dict[int, list] = {}
    for f in config.faults:
        by_round.setdefault(f.round, []).append(f)
    return by_round


def _configure_obs(logger: MetricsLogger):
    """The run's tracer from ``P2PFL_TRACE`` (exporting to
    ``<log_dir>/<name>/trace`` under ``1``) and, with a log dir, the
    flight recorder's dump directory ``<log_dir>/<name>/flight``."""
    tracer = obs_trace.configure_from_env(
        default_dir=(logger.dir / "trace") if logger.dir else None)
    if logger.dir is not None:
        flight.configure(dump_dir=logger.dir / "flight")
    return tracer


def _round_flops(fns, params, x_shape: tuple, x_dtype, y_dtype,
                 n_samples: int, batch_size: int, epochs: int, n_fits: int,
                 n_mix: int = 0) -> float | None:
    """One round's FLOP count: ``n_fits`` fits of ``epochs`` epochs over a
    shard of ``n_samples`` (obs.cost_model's count through the plain
    versions), plus the ``[n_mix, n_mix]`` mix over every parameter;
    None when the count fails."""
    try:
        fit = cost_model.fit_flops(fns, params, x_shape, x_dtype, y_dtype,
                                   n_samples, batch_size)
    except Exception:
        return None
    per_node = sum(int(np.prod(p.shape[1:])) for p in tree_leaves(params))
    return (n_fits * epochs * fit
            + (cost_model.mix_flops(n_mix, per_node) if n_mix else 0.0))


def _logger(config: ScenarioConfig) -> MetricsLogger:
    return MetricsLogger(config.log_dir, config.name,
                         tensorboard=config.tensorboard, wandb=config.wandb)


class _RoundProfiler:
    """``torch.profiler`` over one round (CUDA activity on the card, CPU
    activity on the CPU), exported as a Chrome trace into ``directory``;
    :meth:`close` stops a trace that a failed round left running."""

    def __init__(self, directory: str, name: str, device: torch.device):
        self.dir = pathlib.Path(directory)
        self.name = name
        self._activity = (torch.profiler.ProfilerActivity.CUDA
                          if device.type == "cuda"
                          else torch.profiler.ProfilerActivity.CPU)
        self._prof = None

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=[self._activity])
        self._prof.start()

    def stop(self, round_num: int) -> pathlib.Path:
        prof, self._prof = self._prof, None
        prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"{self.name}_round{round_num:05d}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        return path

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class Scenario(Observable):
    """Build and drive a federation from a ScenarioConfig."""

    def __init__(self, config: ScenarioConfig,
                 dataset: FederatedDataset | None = None,
                 device: torch.device | str = "cuda",
                 lora_base: Any = None):
        """``lora_base`` (one node's params tree) replaces the frozen
        base a lora scenario derives from its seed: two runs, or the
        two packages, then fine-tune one base."""
        super().__init__()
        if config.cross_device.active:
            raise ValueError(
                "config.cross_device is active — Scenario drives one "
                "live row per node; use CrossDeviceScenario for the "
                "sampled K-of-N regime"
            )
        if config.privacy.secagg:
            # the stacked round has no per-pair wire to mask
            raise ValueError(
                "privacy.secagg is a socket-plane feature (pairwise "
                "masks ride the PARAMS wire); the SPMD Scenario shares "
                "one device array and has nothing to mask — run the "
                "socket plane (p2p.launch) instead"
            )
        self.device = _resolve(device)
        self.config = config
        n = config.n_nodes
        self.dataset = dataset or FederatedDataset.make(config.data, n)
        self.model = build_model(config.model)
        if config.lora.active:
            # adapter-only federation: the federation trains and ships
            # the adapter tree over one frozen base on the device
            self.model = maybe_wrap_lora(
                self.model, config,
                torch.from_numpy(self.dataset.nodes[0].x[:1]),
                base=lora_base, device=self.device)
        self.fns = _step_fns(self.model, config)
        self.topology = generate_topology(config.topology, n,
                                          **config.topology_kwargs)
        self.aggregator = get_aggregator(config.aggregator,
                                         **config.aggregator_kwargs)
        self.roles = [nc.role for nc in config.nodes]
        self.membership = Membership(n, config.protocol)
        self.logger = _logger(config)
        if self.logger.dir is not None:
            self._write_topology()
        self.leader = next(
            (i for i, nc in enumerate(config.nodes)
             if nc.role in ("aggregator", "server")), 0)
        self._rng = np.random.default_rng(config.seed)
        self._faults_by_round = _faults_by_round(config)
        self._base_trains = np.array(
            [r in ("trainer", "aggregator", "server") for r in self.roles])

        # the malicious cohort, the attack and the trust monitor, from
        # the config alone
        adv = config.adversary
        self.malicious = (
            malicious_indices(n, adv.fraction, adv.seed, tuple(adv.nodes))
            if adv.active else np.zeros(n, bool))
        self.attack = (AttackSpec(kind=adv.kind, scale=adv.scale,
                                  seed=adv.seed) if adv.active else None)
        self.reputation = (
            ReputationMonitor(n, alpha=adv.reputation_alpha,
                              cutoff=adv.reputation_cutoff)
            if adv.reputation else None)

        # DP-FedAvg on every training row, keyed by (seed, node, round);
        # the spend is a pure function of the rounds completed
        priv = config.privacy
        self.dp_spec = None
        self.accountant = None
        if priv.dp:
            self.dp_spec = DPSpec(clip_norm=priv.clip_norm,
                                  noise_multiplier=priv.noise_multiplier,
                                  seed=config.seed)
            self.accountant = PrivacyAccountant(priv.noise_multiplier,
                                                delta=priv.delta)
        self.dp_mask = (self._base_trains.copy() if priv.dp
                        else np.zeros(n, bool))

        # async aggregation: a straggler of compute class k lands k - 1
        # rounds stale, and its column of the mix is scaled by the
        # staleness discount (static across rounds)
        el = config.elastic
        self._stale_scale: np.ndarray | None = None
        if el.async_aggregation and el.staleness_beta > 0.0:
            stale_rounds = np.asarray(
                [nc.fit_slowdown - 1.0 for nc in config.nodes], np.float32)
            if np.any(stale_rounds > 0.0):
                self._stale_scale = staleness_scale(stale_rounds,
                                                    el.staleness_beta)

        dev = self.device
        x, y, smask, nsamp = self.dataset.stacked()
        if self.attack is not None and self.attack.kind == "labelflip":
            # data poisoning: the malicious rows' train labels flip
            y = np.array(y, copy=True)
            for i in np.flatnonzero(self.malicious):
                y[i] = flip_labels(y[i], self.dataset.num_classes)
        self._data_args = (
            torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(smask).to(dev), torch.from_numpy(nsamp).to(dev),
        )
        self._x_test = torch.from_numpy(self.dataset.x_test).to(dev)
        self._y_test = torch.from_numpy(self.dataset.y_test).to(dev)
        # one shared robust aggregate where every aggregating row is the
        # same: CFL/SDFL (the leader's row) and fully connected DFL
        fully = bool(np.all(self.topology.adjacency | np.eye(n, dtype=bool)))
        self._round_fn = build_round_fn(
            self.fns, aggregator=self.aggregator,
            epochs=config.training.epochs_per_round,
            exchange_dtype=_exchange_dtype(config),
            shared_aggregate=(config.federation in ("CFL", "SDFL")
                              or (config.federation == "DFL" and fully)),
            # DFL plans adopt their own row: the adopt gather is elided
            identity_adopt=config.federation == "DFL",
            attack=self.attack,
            malicious=self.malicious,
            update_stats=self.reputation is not None,
            exchange_overlap=config.exchange_overlap,
            dp=self.dp_spec,
            dp_mask=self.dp_mask,
        )
        self._eval_fn = build_eval_fn(self.fns)
        self.fed = init_federation(self.fns, torch.from_numpy(x[0, :1]), n,
                                   seed=config.seed, device=dev)
        if config.exchange_overlap == "staged":
            # the buffer at zero weight: staged round 0 is pure local
            # training; seeded before the resume so the template has it
            self.fed = with_staged_buffer(self.fed)
        self._maybe_resume()
        self._steps_per_round = (max(x.shape[1] // config.data.batch_size, 1)
                                 * config.training.epochs_per_round)
        # a resumed run continues the FL-aware global step
        self.global_step = self.fed.round * self._steps_per_round
        self.round_times_s: list[float] = []
        self.profile_path: pathlib.Path | None = None  # the last trace
        # devprof round gauges (MFU, TFLOPs, memory), refreshed a round;
        # the count is taken once (False: not yet)
        self.devprof_last: dict[str, Any] = {}
        self._devprof_flops: float | None | bool = False

    # ------------------------------------------------------------------
    def _write_topology(self) -> None:
        """``topology.png`` and ``topology_3d.json`` beside the metrics,
        best effort: an optional picture never stops a run."""
        try:
            from p2pfl_tpu_torch.utils.draw import draw_topology

            draw_topology(self.topology, self.logger.dir / "topology.png",
                          roles=self.roles)
        except Exception:
            pass
        try:
            from p2pfl_tpu_torch.utils.fsio import atomic_write_text

            atomic_write_text(
                self.logger.dir / "topology_3d.json",
                json.dumps(self.topology.to_3d(seed=self.config.seed)))
        except Exception:
            pass

    def _maybe_resume(self) -> None:
        """Restore the newest checkpoint that loads (falling back past a
        truncated or corrupt one), then replay the host's trajectory
        through the restored rounds: the same faults, clock and leader
        draws as the run that saved, so eviction, the leader and every
        later mix weight match it."""
        if not self.config.checkpoint_dir:
            return
        restored = None
        for path in reversed(all_checkpoints(self.config.checkpoint_dir)):
            try:
                restored = load_checkpoint(
                    path, self.fed, self.config.training.optimizer)
                break
            except ValueError:
                continue
        if restored is None:
            return
        self.fed = restored
        for r in range(self.fed.round):
            alive = self._advance_membership(r, replay=True)
            self._rotate_leader(alive, replay=True)

    # ------------------------------------------------------------------
    def _sync_join_row(self, node: int, round_num: int) -> None:
        """A joining node's row adopts the current leader's params (not
        its momentum), so it re-enters from the federation's model
        instead of what its row held while it was dead."""
        src = self.leader
        if src == node:
            src = next(
                (i for i in self.membership.get_nodes() if i != node), None)
            if src is None:
                return

        def copy_row(x):
            x = x.clone()
            x[node] = x[src]
            return x

        params = tree_map(copy_row, self.fed.states.params)
        self.fed = dataclasses.replace(
            self.fed, states=dataclasses.replace(self.fed.states,
                                                 params=params))
        self.notify(Events.NODE_JOINED, {"node": node, "round": round_num})

    def _advance_membership(self, round_num: int,
                            replay: bool = False) -> np.ndarray:
        """The round's faults (a join's row sync included), then one
        heartbeat period of the clock; returns the alive mask. A replayed
        round (resume) copies no row: the restored state holds the
        post-join params already."""
        for fault in self._faults_by_round.get(round_num, []):
            self.membership.apply_fault(fault)
            if fault.kind == "join" and not replay:
                self._sync_join_row(fault.node, round_num)
        t = self.membership.clock + self.membership.protocol.heartbeat_period_s
        return self.membership.advance_to(t)

    def _rotate_leader(self, alive: np.ndarray, replay: bool = False) -> None:
        """SDFL draws its leader among the alive nodes (a replayed round
        draws too, to keep the stream in step, but fires no event); CFL
        fails over from a dead server."""
        if self.config.federation == "SDFL":
            candidates = [i for i in np.flatnonzero(alive)
                          if self.roles[i] in ("aggregator", "trainer")]
            if candidates:
                new = int(self._rng.choice(candidates))
                if new != self.leader and not replay:
                    self.notify(Events.LEADERSHIP_TRANSFERRED,
                                {"from": self.leader, "to": new})
                self.leader = new
        elif not alive[self.leader] and self.config.federation == "CFL":
            # a dead server fails over to the lowest alive index
            alive_idx = np.flatnonzero(alive)
            if len(alive_idx):
                self.leader = int(alive_idx[0])

    def _voted_trains(self, alive: np.ndarray,
                      round_num: int) -> np.ndarray | None:
        """The train-set vote at its deterministic fixed point (the JAX
        package's ``Scenario._voted_trains``): None when the
        ``train_set_size`` cap does not bind."""
        k = self.config.protocol.train_set_size
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
        mix = plan.mix
        if self.reputation is not None:
            # w = mix * n_samples: scaling column j by node j's trust
            # reweights its contribution everywhere; a zeroed column is
            # a masked row for the robust aggregators
            mix = (mix.astype(np.float32)
                   * self.reputation.weights_vector()[None, :])
        if self._stale_scale is not None:
            mix = mix.astype(np.float32) * self._stale_scale[None, :]
        dev = self.device
        return (torch.from_numpy(mix).to(dev),
                torch.from_numpy(plan.adopt).long().to(dev),
                torch.from_numpy(trains).to(dev))

    def _publish_statuses(self, r: int, alive: np.ndarray,
                          train_loss: np.ndarray, ev: dict | None) -> None:
        """Each alive node's status record (dead nodes go silent, like a
        crashed process), in the JAX package's keys. ``recompiles`` is 0:
        eager PyTorch compiles no round program."""
        if self.logger.dir is None:
            return
        times = sorted(self.round_times_s)
        p95 = (round(times[min(len(times) - 1, int(0.95 * len(times)))], 4)
               if times else None)
        acct = self.accountant
        for i in range(self.config.n_nodes):
            if not alive[i]:
                continue
            publish_status(self.logger.dir / "status", i, {
                "role": self.roles[i],
                "round": r + 1,
                "round_p95_s": p95,
                "loss": float(train_loss[i]),
                "accuracy": (float(ev["per_node_accuracy"][i]) if ev
                             else None),
                "peers": int(alive.sum()) - 1,
                "leader": self.leader,
                "trust": (round(float(self.reputation.trust[i]), 4)
                          if self.reputation is not None else None),
                "dp_epsilon": (round(acct.epsilon, 4) if acct is not None
                               else None),
                "dp_epsilon_budget": (self.config.privacy.epsilon_budget
                                      if acct is not None else None),
                "recompiles": 0,
                # one stacked round serves every node, so the devprof
                # gauges (utilization, memory) are shared
                **self.devprof_last,
            })

    def round_flops(self) -> float | None:
        """One round's FLOP count: every node's fit (the stacked step
        runs every row, gated or not) and the mix."""
        x, y = self._data_args[0], self._data_args[1]
        cfg = self.config
        return _round_flops(self.fns, self.fed.states.params,
                            tuple(x.shape[2:]), x.dtype, y.dtype,
                            x.shape[1], cfg.data.batch_size,
                            cfg.training.epochs_per_round, cfg.n_nodes,
                            n_mix=cfg.n_nodes)

    def _log_round(self, r: int, dt: float, train_loss: np.ndarray) -> None:
        """The round's per-node training records (the JAX run loop's)."""
        for i in range(self.config.n_nodes):
            rec = {"Train/loss": float(train_loss[i]),
                   "Train/round_time_s": dt}
            if self.reputation is not None:
                rec["Trust/score"] = float(self.reputation.trust[i])
            self.logger.log_metrics(rec, step=self.global_step, round=r,
                                    node=i)

    def _log_eval(self, r: int, ev: dict) -> None:
        for i, (a, l) in enumerate(zip(ev["per_node_accuracy"],
                                       ev["per_node_loss"])):
            self.logger.log_metrics({"Test/accuracy": a, "Test/loss": l},
                                    step=self.global_step, round=r, node=i)
        self.logger.log_metrics(
            {"Test/mean_accuracy": ev["mean_accuracy"],
             "Test/min_accuracy": ev["min_accuracy"]},
            step=self.global_step, round=r)

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
        self.round_times_s = round_times  # _publish_statuses reads p95
        history: list[dict] = []
        rounds_to_target = None
        ev = None
        ev_round = -1
        start_round = self.fed.round
        # profile one steady-state round: the second of the run where
        # there is one (the first carries the kernels' first calls)
        profiler = profile_round = None
        if cfg.profile_dir:
            profiler = _RoundProfiler(cfg.profile_dir, cfg.name, self.device)
            profile_round = start_round + (1 if rounds > 1 else 0)
        tracer = _configure_obs(self.logger)
        try:
            for r in range(start_round, start_round + rounds):
                _sync(self.device)
                t0 = time.monotonic()
                if r == profile_round:
                    profiler.start()
                self.notify(Events.ROUND_STARTED, {"round": r})
                alive = self._advance_membership(r)
                self._rotate_leader(alive)
                self.fed = dataclasses.replace(
                    self.fed, alive=torch.from_numpy(alive).to(self.device))
                trains_vote = self._voted_trains(alive, r)
                with tracer.span("scenario.round", args={"round": r}):
                    self.fed, metrics = self._round_fn(
                        self.fed, *self._data_args,
                        *self._plan_args(trains_vote))
                    _sync(self.device)
                if r == profile_round:
                    self.profile_path = profiler.stop(r)
                self.notify(Events.AGGREGATION_FINISHED, {"round": r})
                dt = time.monotonic() - t0
                round_times.append(dt)
                if devprof.enabled():
                    # counted once a run, AFTER dt is read, so the count
                    # never bills itself to a round time
                    if self._devprof_flops is False:
                        self._devprof_flops = self.round_flops()
                    self.devprof_last = devprof.round_gauges(
                        self._devprof_flops, dt, 1, device=self.device)
                self.global_step += self._steps_per_round
                train_loss = metrics["train_loss"].double().cpu().numpy()
                rec = {"round": r, "round_time_s": dt,
                       "train_loss": train_loss.tolist(),
                       "alive": alive.tolist(), "leader": self.leader}
                if self.accountant is not None:
                    self.accountant.steps = r + 1
                if self.reputation is not None:
                    # round r ran on the trust of round r-1; fold in this
                    # round's scores for the next. Nodes that did not
                    # contribute keep their trust.
                    contrib = np.logical_and(
                        self._base_trains if trains_vote is None
                        else trains_vote, alive)
                    self.reputation.observe(
                        metrics["trust_obs"].double().cpu().numpy(), contrib)
                    rec["trust"] = [float(t) for t in self.reputation.trust]
                self._log_round(r, dt, train_loss)
                self._publish_statuses(r, alive, train_loss, ev)
                if (cfg.training.eval_every
                        and (r + 1) % cfg.training.eval_every == 0):
                    ev = self.evaluate()
                    ev_round = r
                    rec["eval"] = ev
                    self._log_eval(r, ev)
                    if (target_accuracy is not None
                            and rounds_to_target is None
                            and ev["mean_accuracy"] >= target_accuracy):
                        rounds_to_target = r + 1
                self.logger.log_metrics(resource_snapshot(),
                                        step=self.global_step, round=r)
                self.logger.round_marker(r, self.global_step)
                if (cfg.checkpoint_dir and cfg.checkpoint_every
                        and (r + 1) % cfg.checkpoint_every == 0):
                    path = save_checkpoint(cfg.checkpoint_dir, self.fed,
                                           cfg.training.optimizer)
                    self.notify(Events.CHECKPOINT_SAVED, {"path": str(path)})
                history.append(rec)
                self.notify(Events.ROUND_FINISHED, {"round": r, "time_s": dt})
        finally:
            if profiler is not None:
                profiler.close()
            if tracer.enabled:
                tracer.export(process_name=f"scenario[{cfg.name}]")
        last_round = start_round + rounds - 1
        if ev is None or ev_round != last_round:
            ev = self.evaluate()
            if (target_accuracy is not None and rounds_to_target is None
                    and ev["mean_accuracy"] >= target_accuracy):
                rounds_to_target = last_round + 1
        self.notify(Events.LEARNING_FINISHED, {})
        return ScenarioResult(
            final_accuracy=ev["mean_accuracy"],
            per_node_accuracy=ev["per_node_accuracy"],
            rounds_run=rounds,
            round_times_s=round_times,
            history=history,
            rounds_to_target=rounds_to_target,
            min_accuracy=ev["min_accuracy"],
        )

    def close(self) -> None:
        self.logger.close()


class CrossDeviceScenario(Observable):
    """The sampled K-of-N cross-device scenario.

    A client is an index into a lazy ``ClientPartition``, not a live
    row. Each round the host draws ``clients_per_round`` of
    ``n_clients`` (seeded by ``(cross_device.seed, round)``, without
    replacement, optionally weighted by data size), reshapes them into
    ``cohort_size`` cohorts of ``n_slots`` and materializes their shards
    at the fixed shard size; the round (``build_round_fn_cross_device``)
    trains the cohorts one after another through the ``n_slots`` slots
    and FedAvg-sums all of them. With ``prefetch="stream"`` the round
    is driven one cohort at a time through two reused pinned host
    buffers: the host fills cohort t+1 while the card trains cohort t.

    The membership clock spans every virtual client: the round's faults
    are applied (a join is a recover, since a client holds no row to
    sync) and the clock advances one heartbeat period before the draw.
    A sampled client that is dead trains nothing and carries no weight.
    """

    def __init__(self, config: ScenarioConfig,
                 dataset: CrossDeviceData | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        cd = config.cross_device
        if not cd.active:
            raise ValueError(
                "CrossDeviceScenario needs config.cross_device.n_clients"
                " > 0; use Scenario for the stacked federation"
            )
        self.device = _resolve(device)
        self.config = config
        self.cd = cd
        self.data = dataset or CrossDeviceData.make(config.data,
                                                    cd.n_clients)
        self.model = build_model(config.model)
        self.fns = _step_fns(self.model, config)
        self.membership = Membership(cd.n_clients, config.protocol)
        self._faults_by_round = _faults_by_round(config)
        self.logger = _logger(config)
        self._sample_weights = (
            self.data.client_sizes.astype(np.float64)
            if cd.sampling == "weighted" else None
        )
        epochs = config.training.epochs_per_round
        fused = cd.accumulate == "fused"
        self._stream = cd.prefetch == "stream"
        if self._stream:
            self._stream_fns = build_cross_device_stream_fns(
                self.fns, epochs=epochs,
                exchange_dtype=_exchange_dtype(config),
                fused_accumulate=fused)
            self._stream_bufs = None  # two pinned cohort buffers
            self._stream_events: list = [None, None]
            self._round_fn = None
        else:
            self._round_fn = build_round_fn_cross_device(
                self.fns, epochs=epochs,
                exchange_dtype=_exchange_dtype(config),
                fused_accumulate=fused, cohort_shards=cd.cohort_shards)
        self._eval_fn = build_eval_fn(self.fns)
        dev = self.device
        sample_x = torch.zeros((1,) + tuple(self.data.input_shape))
        self.fed = init_federation(self.fns, sample_x, cd.n_slots,
                                   seed=config.seed, device=dev)
        self._x_test = torch.from_numpy(self.data.x_test).to(dev)
        self._y_test = torch.from_numpy(self.data.y_test).to(dev)
        # throughput and prefetch gauges of the last round
        self.crossdev_last: dict[str, Any] = {}
        self.devprof_last: dict[str, Any] = {}
        self._devprof_flops: float | None | bool = False
        # the last round's draw and its liveness
        self.last_sampled: np.ndarray | None = None
        self.last_cohorts: np.ndarray | None = None
        self.last_cohort_alive: np.ndarray | None = None

    def _buffers(self):
        """Two host buffers for one cohort each: pinned tensors on the
        card's host (so the copies can run asynchronously) and the numpy
        views ``cohort_batch(out=)`` fills."""
        if self._stream_bufs is None:
            pin = self.device.type == "cuda"
            bufs = []
            for _ in range(2):
                x, y, m, sizes = self.data.cohort_buffers(self.cd.n_slots)
                host = tuple(torch.from_numpy(a) for a in (x, y, m))
                if pin:
                    host = tuple(t.pin_memory() for t in host)
                bufs.append((host, tuple(t.numpy() for t in host) + (sizes,)))
            self._stream_bufs = bufs
        return self._stream_bufs

    def _advance_membership(self, round_num: int) -> np.ndarray:
        for fault in self._faults_by_round.get(round_num, []):
            self.membership.apply_fault(fault)
        t = self.membership.clock + self.membership.protocol.heartbeat_period_s
        return self.membership.advance_to(t)

    def _run_streamed_round(self, cohorts: np.ndarray,
                            c_alive: np.ndarray) -> dict[str, Any]:
        """One round, one cohort at a time. While the card trains step
        t, the host gathers cohort t+1 into the other of two buffers and
        queues its copy. Before the host rewrites a buffer it waits on
        the event recorded after that buffer's last copy (two steps
        earlier). The steps are the materialized round's body in the
        same order with the same weights, so the result is the same bit
        for bit.

        Gauges in ``crossdev_last``: ``crossdev_prefetch_mb``, the
        host-to-device bytes this round; ``crossdev_prefetch_stall_s``,
        the host time spent gathering and waiting for a free buffer."""
        cd = self.cd
        dev = self.device
        bufs = self._buffers()
        sizes = self.data.cohort_sizes(cohorts)
        wn, got_any = cross_device_wn(torch.from_numpy(sizes).to(dev),
                                      torch.from_numpy(c_alive).to(dev))
        alive_dev = torch.from_numpy(c_alive).to(dev)
        stall_s = 0.0

        def gather_put(t: int):
            nonlocal stall_s
            t0 = time.monotonic()
            host, views = bufs[t % 2]
            if self._stream_events[t % 2] is not None:
                # the copy out of this buffer two steps ago must be done
                self._stream_events[t % 2].synchronize()
            self.data.cohort_batch(cohorts[t], out=views)
            out = tuple(h.to(dev, non_blocking=True) for h in host)
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                self._stream_events[t % 2] = ev
            stall_s += time.monotonic() - t0
            return out

        init_carry, step, finalize = self._stream_fns
        buf = gather_put(0)
        prefetch_bytes = sum(a.nbytes for a in buf) * cd.cohort_size
        params0 = self.fed.states.params
        carry = init_carry(self.fed)
        losses = []
        for t in range(cd.cohort_size):
            # the step is queued on the card; the gather below overlaps it
            carry, loss = step(params0, carry, *buf, alive_dev[t], wn[t])
            if t + 1 < cd.cohort_size:
                buf = gather_put(t + 1)
            losses.append(loss)
        self.fed = finalize(self.fed, carry, got_any)
        self.crossdev_last["crossdev_prefetch_mb"] = prefetch_bytes / 1e6
        self.crossdev_last["crossdev_prefetch_stall_s"] = stall_s
        return {"train_loss": torch.stack(losses), "alive": self.fed.alive}

    def _run_materialized_round(self, sampled: np.ndarray,
                                c_alive: np.ndarray) -> dict[str, Any]:
        cd = self.cd
        x, y, mask, sizes = self.data.cohort_batch(sampled)
        shape2 = (cd.cohort_size, cd.n_slots)
        args = tuple(
            torch.from_numpy(a.reshape(shape2 + a.shape[1:])).to(
                self.device)
            for a in (x, y, mask, sizes))
        self.fed, metrics = self._round_fn(
            self.fed, *args, torch.from_numpy(c_alive).to(self.device))
        return metrics

    def _publish_crossdev_status(self, r: int, mean_loss: float) -> None:
        """One status record for the whole cross-device scenario (no
        per-client process speaks for itself), with the throughput
        gauges."""
        if self.logger.dir is None:
            return
        publish_status(self.logger.dir / "status", 0, {
            "role": "crossdev",
            "round": r + 1,
            "loss": mean_loss,
            "peers": self.cd.n_slots - 1,
            "recompiles": 0,
            **self.crossdev_last,
            **self.devprof_last,
        })

    def round_flops(self) -> float | None:
        """One round's FLOP count: every sampled client's fit over a
        client's shard (the per-step accumulate is elementwise and counts
        0)."""
        cd, cfg = self.cd, self.config
        x, y, _, _ = self.data.cohort_buffers(1)
        return _round_flops(self.fns, self.fed.states.params,
                            tuple(x.shape[2:]),
                            cost_model._torch_dtype(x.dtype),
                            cost_model._torch_dtype(y.dtype), x.shape[1],
                            cfg.data.batch_size,
                            cfg.training.epochs_per_round,
                            cd.clients_per_round)

    def evaluate(self) -> dict[str, Any]:
        """The global model on the shared test set. Every slot holds the
        same aggregate after a round, so the slots agree; the mean is
        reported as ``Scenario.evaluate`` does."""
        metrics = self._eval_fn(self.fed, self._x_test, self._y_test)
        acc = metrics["accuracy"].double().cpu().numpy()
        loss = metrics["loss"].double().cpu().numpy()
        return {
            "per_node_accuracy": [float(a) for a in acc],
            "per_node_loss": [float(v) for v in loss],
            "mean_accuracy": float(acc.mean()),
            "min_accuracy": float(acc.min()),
        }

    def run(self, rounds: int | None = None,
            target_accuracy: float | None = None) -> ScenarioResult:
        cfg = self.config
        rounds = rounds if rounds is not None else cfg.training.rounds
        start_round = self.fed.round
        tracer = _configure_obs(self.logger)
        try:
            result = self._run(rounds, target_accuracy, start_round, tracer)
        finally:
            if tracer.enabled:
                tracer.export(process_name=f"crossdev[{cfg.name}]")
        return result

    def _run(self, rounds: int, target_accuracy: float | None,
             start_round: int, tracer) -> ScenarioResult:
        cfg = self.config
        cd = self.cd
        round_times: list[float] = []
        history: list[dict] = []
        rounds_to_target = None
        ev = None
        ev_round = -1
        for r in range(start_round, start_round + rounds):
            _sync(self.device)
            t0 = time.monotonic()
            self.notify(Events.ROUND_STARTED, {"round": r})
            alive = self._advance_membership(r)
            # cohort step t runs clients sampled[t*n_slots:(t+1)*n_slots]
            sampled, cohorts = sample_cohorts(
                cd.n_clients, cd.clients_per_round, cd.cohort_size, r,
                seed=cd.seed, weights=self._sample_weights,
            )
            c_alive = alive[cohorts]
            with tracer.span("scenario.round", args={"round": r}):
                if self._stream:
                    metrics = self._run_streamed_round(cohorts, c_alive)
                else:
                    metrics = self._run_materialized_round(sampled, c_alive)
                _sync(self.device)
            dt = time.monotonic() - t0
            round_times.append(dt)
            if devprof.enabled():
                if self._devprof_flops is False:
                    self._devprof_flops = self.round_flops()
                self.devprof_last = devprof.round_gauges(
                    self._devprof_flops, dt, 1, device=self.device)
            self.last_sampled = sampled
            self.last_cohorts = cohorts
            self.last_cohort_alive = c_alive
            self.notify(Events.AGGREGATION_FINISHED, {"round": r})

            losses = metrics["train_loss"].double().cpu().numpy()
            live = c_alive.astype(bool)
            mean_loss = float(losses[live].mean()) if live.any() else 0.0
            self.crossdev_last["crossdev_clients_per_s"] = (
                len(sampled) / dt if dt > 0 else None)
            rec = {"round": r, "round_time_s": dt,
                   "train_loss": losses.tolist(),  # [C, n_slots]
                   "Train/loss": mean_loss,
                   "CrossDev/clients_sampled": int(len(sampled)),
                   "CrossDev/clients_alive": int(live.sum())}
            self._publish_crossdev_status(r, mean_loss)
            self.logger.log_metrics(
                {"Train/loss": mean_loss, "Train/round_time_s": dt,
                 "CrossDev/clients_sampled": int(len(sampled)),
                 "CrossDev/clients_alive": int(live.sum())},
                step=r, round=r)
            if cfg.training.eval_every and (r + 1) % cfg.training.eval_every == 0:
                ev = self.evaluate()
                ev_round = r
                rec["eval"] = ev
                self.logger.log_metrics(
                    {"Test/mean_accuracy": ev["mean_accuracy"]},
                    step=r, round=r)
                if (target_accuracy is not None and rounds_to_target is None
                        and ev["mean_accuracy"] >= target_accuracy):
                    rounds_to_target = r + 1
            history.append(rec)
            self.notify(Events.ROUND_FINISHED, {"round": r, "time_s": dt})
        last_round = start_round + rounds - 1
        if ev is None or ev_round != last_round:
            ev = self.evaluate()
            if (target_accuracy is not None and rounds_to_target is None
                    and ev["mean_accuracy"] >= target_accuracy):
                rounds_to_target = last_round + 1
        self.notify(Events.LEARNING_FINISHED, {})
        return ScenarioResult(
            final_accuracy=ev["mean_accuracy"],
            per_node_accuracy=ev["per_node_accuracy"],
            rounds_run=rounds,
            round_times_s=round_times,
            history=history,
            rounds_to_target=rounds_to_target,
            min_accuracy=ev["min_accuracy"],
        )

    def close(self) -> None:
        self.logger.close()
