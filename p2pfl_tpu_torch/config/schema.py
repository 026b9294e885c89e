"""Scenario configuration, read from the same JSON as the JAX package.

The counterpart of ``p2pfl_tpu/config/schema.py``. ``DataConfig``,
``ModelConfig``, ``TrainingConfig``, ``ProtocolConfig``, ``NodeConfig``,
``FaultEvent``, ``ElasticConfig``, ``PrivacyConfig``,
``CrossDeviceConfig``, ``AdversaryConfig`` and ``LoraConfig`` are
copies of the JAX package's dataclasses (they import nothing but the
standard library) with all their validation, and
``ScenarioConfig.materialize_elastic``
is a copy of the JAX package's churn and straggler expansion, seeded
the same way. ``ScenarioConfig`` has the same fields, so
``ScenarioConfig.load`` reads a scenario file that ``p2pfl_tpu`` wrote.
The combinations the JAX package refuses with the cross-device regime
raise the same ``ValueError`` here, before anything else is checked.
The JAX package's refusals of lora with the sidecar plane and with
``cross_device`` raise its ``ValueError`` too. The sections this port
does not run yet (secure aggregation, the sparse transport, the socket
plane, and a ``param_dtype`` or ``compute_dtype`` other than float32
and bfloat16) are rejected in ``__post_init__`` with a
``NotImplementedError`` that names the ``ROADMAP.md`` item that ports
them (``network`` stays a plain dict): a scenario the port would
silently run differently never starts. The elastic section's
socket-plane knobs (``min_received``, the heartbeat retry limit and
backoff) are carried and ignored, as the JAX package's stacked
``Scenario`` ignores them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import random
from typing import Any

FEDERATIONS = ("DFL", "CFL", "SDFL")
ROLES = ("trainer", "aggregator", "server", "proxy", "idle")


@dataclasses.dataclass
class DataConfig:
    dataset: str = "mnist"
    partition: str = "iid"  # iid | sorted | dirichlet | writer
    dirichlet_alpha: float = 0.5
    samples_per_node: int | None = None
    batch_size: int = 32
    val_percent: float = 0.1
    seed: int = 0
    synthetic_train: int | None = None
    synthetic_test: int | None = None
    surrogate_profile: str = "hard"


@dataclasses.dataclass
class ModelConfig:
    model: str = "mlp"
    objective: str = "classification"
    param_dtype: str | None = None
    compute_dtype: str | None = None
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainingConfig:
    rounds: int = 3
    epochs_per_round: int = 3
    optimizer: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    momentum_dtype: str | None = None
    eval_every: int = 1


@dataclasses.dataclass
class ProtocolConfig:
    """The wire-protocol tunables. On the stacked federation
    ``train_set_size`` (the train-set vote cap, <=0 off) and the
    heartbeat clock (``heartbeat_period_s``, ``node_timeout_s``: one
    round advances the membership clock by one period) act; the others
    pace the socket plane and are carried unchanged."""

    aggregation_timeout_s: float = 60.0
    vote_timeout_s: float = 60.0
    heartbeat_period_s: float = 4.0
    node_timeout_s: float = 20.0
    gossip_models_per_round: int = 2
    gossip_exit_on_equal_rounds: int = 20
    train_set_size: int = 10
    gossip_period_s: float = 0.05
    gossip_fanout: int = 0
    send_queue_depth: int = 64


@dataclasses.dataclass
class NodeConfig:
    """Per-node overrides: ``fit_slowdown`` >= 1 is the node's compute
    class (a 4x straggler is 4.0; on the stacked plane its update lands
    ``fit_slowdown - 1`` rounds stale under async aggregation)."""

    idx: int = 0
    role: str = "trainer"
    start: bool = False
    epochs: int | None = None
    fit_slowdown: float = 1.0

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown role {self.role!r}; have {ROLES}")
        if self.fit_slowdown < 1.0:
            raise ValueError(
                f"fit_slowdown must be >= 1, got {self.fit_slowdown}"
            )


@dataclasses.dataclass
class FaultEvent:
    """A scripted fault: node ``node`` changes state at round ``round``.
    ``crash`` stops its heartbeats; ``recover``, ``join`` and
    ``restart`` resume them (``join`` also copies the leader's params
    into the joiner's row); ``partition`` (with disjoint ``groups``) and
    ``heal`` are recorded on the membership clock, ``heal`` clearing
    sticky evictions (the cut itself is transport work)."""

    node: int = 0
    round: int = 0
    kind: str = "crash"  # crash | recover | join | partition | heal | restart
    groups: list[list[int]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        known = ("crash", "recover", "join", "partition", "heal",
                 "restart")
        if self.kind not in known:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {known}"
            )
        if self.kind == "partition" and len(self.groups) < 2:
            raise ValueError("a partition fault needs >= 2 groups")


@dataclasses.dataclass
class ElasticConfig:
    """Elasticity: staleness-weighted async aggregation (a straggler's
    column of the mix is scaled by ``1 / (1 + staleness)^beta``) and
    declarative churn and straggler scripting, expanded by
    :meth:`ScenarioConfig.materialize_elastic`. ``min_received`` and the
    heartbeat retry and backoff knobs pace the socket plane."""

    async_aggregation: bool = False
    min_received: float = 0.5
    staleness_beta: float = 0.5
    heartbeat_retry_limit: int = 3
    heartbeat_backoff_base_s: float = 0.5
    heartbeat_backoff_max_s: float = 8.0
    straggler_fraction: float = 0.0
    straggler_factor: float = 1.0
    churn_fraction: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.min_received <= 1.0:
            raise ValueError(
                f"min_received must be in (0, 1], got {self.min_received}"
            )
        if self.staleness_beta < 0.0:
            raise ValueError(
                f"staleness_beta must be >= 0, got {self.staleness_beta}"
            )
        if self.straggler_factor < 1.0:
            raise ValueError(
                f"straggler_factor must be >= 1, got {self.straggler_factor}"
            )
        for name in ("straggler_fraction", "churn_fraction"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.heartbeat_retry_limit < 1:
            raise ValueError("heartbeat_retry_limit must be >= 1")

    @property
    def active(self) -> bool:
        return (self.async_aggregation or self.straggler_fraction > 0.0
                or self.churn_fraction > 0.0)


@dataclasses.dataclass
class PrivacyConfig:
    """DP-FedAvg: with ``dp=True`` every training node's outgoing update
    is clipped to L2 norm ``clip_norm`` (over the whole flattened tree)
    and noised with Gaussian std ``clip_norm * noise_multiplier``; the
    (epsilon, ``delta``) spend is tracked by the closed-form RDP
    accountant. ``secagg`` (pairwise-mask secure aggregation) is a
    socket-plane feature."""

    dp: bool = False
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0
    delta: float = 1e-5
    epsilon_budget: float = 0.0  # 0 = no budget rule
    secagg: bool = False
    secagg_bits: int = 24

    def __post_init__(self):
        if self.dp:
            if not self.clip_norm > 0.0:
                raise ValueError(
                    f"privacy.clip_norm must be > 0, got {self.clip_norm}"
                )
            if self.noise_multiplier < 0.0:
                raise ValueError(
                    f"privacy.noise_multiplier must be >= 0, "
                    f"got {self.noise_multiplier}"
                )
            if not 0.0 < self.delta < 1.0:
                raise ValueError(
                    f"privacy.delta must be in (0, 1), got {self.delta}"
                )
        if self.epsilon_budget < 0.0:
            raise ValueError(
                f"privacy.epsilon_budget must be >= 0, "
                f"got {self.epsilon_budget}"
            )
        if not 8 <= self.secagg_bits <= 40:
            raise ValueError(
                f"privacy.secagg_bits must be in [8, 40], "
                f"got {self.secagg_bits}"
            )

    @property
    def active(self) -> bool:
        return self.dp or self.secagg


@dataclasses.dataclass
class CrossDeviceConfig:
    """Cross-device regime: N virtual clients, K sampled per round,
    simulated by scanning ``cohort_size`` cohorts of ``n_slots`` clients
    through one fixed slot width (a copy of the JAX package's class).

    ``n_clients == 0`` (default) keeps cross-device off. When active,
    ``n_slots = clients_per_round / cohort_size`` is the stacked axis
    the round trains at once, and the round runs ``cohort_size`` steps.
    """

    n_clients: int = 0  # total virtual clients; 0 = off
    clients_per_round: int = 0  # K sampled per round
    cohort_size: int = 1  # clients per simulation slot (steps a round)
    sampling: str = "uniform"  # uniform | weighted (by client data size)
    # "fused": per-slot K5 accumulators summed once at round end;
    # "unfused": the [n_slots, n_slots] @ [n_slots, d] reference product
    accumulate: str = "fused"
    # split the C cohort steps into this many contiguous chunks, each
    # trained from the round-start carry (part of the round's semantics)
    cohort_shards: int = 1
    # "stream": feed the round one cohort at a time through two reused
    # host buffers instead of materializing all C cohorts up front
    prefetch: str = "off"
    seed: int = 0

    def __post_init__(self):
        if self.sampling not in ("uniform", "weighted"):
            raise ValueError(
                f"unknown sampling {self.sampling!r}; "
                "have ('uniform', 'weighted')"
            )
        if self.accumulate not in ("fused", "unfused"):
            raise ValueError(
                f"unknown accumulate {self.accumulate!r}; "
                "have ('fused', 'unfused')"
            )
        if self.prefetch not in ("off", "stream"):
            raise ValueError(
                f"unknown prefetch {self.prefetch!r}; "
                "have ('off', 'stream')"
            )
        if self.cohort_shards < 1:
            raise ValueError(
                f"cohort_shards must be >= 1, got {self.cohort_shards}"
            )
        if self.n_clients < 0:
            raise ValueError(f"n_clients must be >= 0, got {self.n_clients}")
        if not self.active:
            return
        if self.prefetch == "stream" and self.cohort_shards > 1:
            raise ValueError(
                "cross_device prefetch='stream' does not compose with "
                "cohort_shards > 1: the streamed round feeds one "
                "cohort step at a time, the sharded scan wants all "
                "chunks resident — pick one axis"
            )
        if self.clients_per_round < 1:
            raise ValueError(
                "cross_device needs clients_per_round >= 1 "
                f"(got {self.clients_per_round})"
            )
        if self.clients_per_round > self.n_clients:
            raise ValueError(
                f"clients_per_round={self.clients_per_round} > "
                f"n_clients={self.n_clients}"
            )
        if self.cohort_size < 1:
            raise ValueError(
                f"cohort_size must be >= 1, got {self.cohort_size}"
            )
        if self.clients_per_round % self.cohort_size:
            raise ValueError(
                f"clients_per_round={self.clients_per_round} must be a "
                f"multiple of cohort_size={self.cohort_size} (the round "
                "scans cohort_size waves of equal width)"
            )
        if self.cohort_size % self.cohort_shards:
            raise ValueError(
                f"cohort_size={self.cohort_size} must be a multiple of "
                f"cohort_shards={self.cohort_shards} (each device scans "
                "an equal contiguous chunk of the cohort axis)"
            )

    @property
    def active(self) -> bool:
        return self.n_clients > 0

    @property
    def n_slots(self) -> int:
        """Simulation width: clients trained in parallel per step."""
        return self.clients_per_round // self.cohort_size


@dataclasses.dataclass
class AdversaryConfig:
    """Attack injection and the reputation defense (a copy of the JAX
    package's class): ``fraction`` of the nodes (drawn from ``seed``;
    ``nodes`` lists explicit indices instead) apply attack ``kind`` at
    strength ``scale``; ``reputation`` turns on trust-weighted
    aggregation with EWMA ``reputation_alpha`` and hard cutoff
    ``reputation_cutoff``."""

    fraction: float = 0.0
    kind: str = "none"  # none|signflip|scale|noise|freerider|labelflip
    scale: float = 10.0
    seed: int = 0
    nodes: list[int] = dataclasses.field(default_factory=list)
    reputation: bool = False
    reputation_alpha: float = 0.7
    reputation_cutoff: float = 0.15

    def __post_init__(self):
        known = ("none", "signflip", "scale", "noise", "freerider",
                 "labelflip")
        if self.kind not in known:
            raise ValueError(
                f"unknown attack kind {self.kind!r}; have {known}"
            )
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"adversary fraction must be in [0, 1], got {self.fraction}"
            )

    @property
    def active(self) -> bool:
        return self.kind != "none" and (
            self.fraction > 0.0 or bool(self.nodes)
        )


@dataclasses.dataclass
class LoraConfig:
    """Adapter-only federation (``learning/lora.py``): the unit of
    federation becomes the LoRA adapter tree instead of the full
    parameter tree.

    ``rank == 0`` (the default) keeps full-weight federation. When
    active, every node trains only the adapters over a frozen base
    derived from ``(model config, scenario seed)``. ``targets`` are
    substring patterns matched against kernel paths; empty means the
    model's registered defaults (the ViT's ``query``/``value``).
    ``alpha`` is the LoRA scale's numerator (``None`` = ``rank``, scale
    1.0)."""

    rank: int = 0  # 0 = off (full-weight federation)
    targets: list[str] = dataclasses.field(default_factory=list)
    alpha: float | None = None

    def __post_init__(self):
        if self.rank < 0:
            raise ValueError(f"lora rank must be >= 0, got {self.rank}")
        if self.alpha is not None and self.alpha <= 0:
            raise ValueError(f"lora alpha must be > 0, got {self.alpha}")
        if self.targets and not all(
                isinstance(t, str) and t for t in self.targets):
            raise ValueError(
                f"lora targets must be non-empty strings, got "
                f"{self.targets!r}")

    @property
    def active(self) -> bool:
        return self.rank > 0


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to p2pfl_tpu_torch yet "
        f"(ROADMAP.md queue A, item {item}); run it with p2pfl_tpu"
    )


#: the model dtypes the port runs (None keeps each model's own)
_DTYPES = (None, "f32", "float32", "bf16", "bfloat16")


@dataclasses.dataclass
class ScenarioConfig:
    """A whole federation scenario (the JAX package's field set)."""

    name: str = "scenario"
    federation: str = "DFL"
    topology: str = "fully"
    topology_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    n_nodes: int = 2
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    protocol: ProtocolConfig = dataclasses.field(
        default_factory=ProtocolConfig)
    aggregator: str = "fedavg"
    aggregator_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    adversary: AdversaryConfig = dataclasses.field(
        default_factory=AdversaryConfig)
    # a section this port does not run: a plain dict, checked below
    network: dict[str, Any] = dataclasses.field(default_factory=dict)
    elastic: ElasticConfig = dataclasses.field(default_factory=ElasticConfig)
    cross_device: CrossDeviceConfig = dataclasses.field(
        default_factory=CrossDeviceConfig)
    lora: LoraConfig = dataclasses.field(default_factory=LoraConfig)
    privacy: PrivacyConfig = dataclasses.field(default_factory=PrivacyConfig)
    transport: str = "auto"
    wire_dtype: str = "f32"
    exchange_overlap: str = "off"
    aggregation_plane: str = "inline"
    encrypt: bool = False
    nodes: list[NodeConfig] = dataclasses.field(default_factory=list)
    faults: list[FaultEvent] = dataclasses.field(default_factory=list)
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    log_dir: str | None = None
    tensorboard: bool = False
    wandb: bool = False
    profile_dir: str | None = None

    def __post_init__(self):
        if self.federation not in FEDERATIONS:
            raise ValueError(
                f"unknown federation {self.federation!r}; have {FEDERATIONS}"
            )
        if self.transport not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown transport {self.transport!r}")
        if self.wire_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        if self.exchange_overlap not in ("off", "staged"):
            raise ValueError(
                f"unknown exchange_overlap {self.exchange_overlap!r}")
        if self.n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        self._refuse_cross_device_compositions()
        self._reject_unported()
        if not self.nodes:
            self.nodes = self._default_nodes()
        if len(self.nodes) != self.n_nodes:
            raise ValueError(
                f"{len(self.nodes)} node configs for n_nodes={self.n_nodes}"
            )
        self.materialize_elastic()

    def _refuse_cross_device_compositions(self) -> None:
        """The JAX schema's refusals of what the cohort-scan round has
        no hook for, with the same type (``ValueError``), raised before
        the port's own ``NotImplementedError`` checks so that a
        combination the JAX package refuses is refused the same way."""
        if not self.cross_device.active:
            return
        if self.adversary.active or self.adversary.reputation:
            raise ValueError(
                "cross_device composes with no adversary/reputation "
                "config yet: sampled clients are stateless rows, so "
                "there is no per-node trust or poisoning hook"
            )
        if self.exchange_overlap != "off":
            raise ValueError(
                "cross_device requires exchange_overlap='off': a "
                "sampled cohort has no previous-round buffer to ship"
            )
        if self.transport == "sparse":
            raise ValueError(
                "cross_device uses the cohort-scan round, not the "
                "ppermute transport; leave transport 'auto'/'dense'"
            )
        if self.aggregation_plane == "sidecar":
            raise ValueError(
                "aggregation_plane='sidecar' is a socket-plane "
                "feature; cross_device runs the cohort-scan round"
            )
        if self.lora.active:
            raise ValueError(
                "lora is not wired into the cross_device "
                "cohort-scan round yet: it would silently train "
                "full weights while the scenario says adapters"
            )
        if self.privacy.active:
            raise ValueError(
                "privacy is not wired into the cross_device cohort-"
                "scan round yet: sampled clients are stateless rows "
                "with no per-node (seed, round, idx) noise stream or "
                "pairwise mask identity"
            )

    def _reject_unported(self) -> None:
        if self.lora.active and self.aggregation_plane == "sidecar":
            # the JAX schema's refusal, raised as there, before the
            # port's own refusal of the socket plane below
            raise ValueError(
                "lora composes with aggregation_plane='inline' "
                "only for now: the sidecar fuses raw slot bytes "
                "against full-weight expectations and would "
                "silently aggregate adapter envelopes as if they "
                "were full models")
        if self.privacy.secagg:
            # the JAX package's stacked Scenario refuses it too: the
            # pairwise masks ride the socket plane's PARAMS wire
            raise _unported("privacy.secagg (a socket-plane feature)",
                            "A22")
        if self.transport == "sparse":
            raise _unported("transport='sparse'", "A12")
        net = self.network
        if (self.aggregation_plane != "inline" or self.encrypt
                or any(net.get(k) for k in ("delay_ms", "jitter_ms",
                                            "loss_pct", "rate_mbps",
                                            "partitions"))):
            raise _unported("the socket plane (network, sidecar, TLS)",
                            "A22")
        # the kernels take f32 and bf16 (float16 is the rest of A19)
        for knob in ("param_dtype", "compute_dtype"):
            value = getattr(self.model, knob)
            if value not in _DTYPES:
                raise _unported(f"{knob} {value!r}", "A19")

    def _default_nodes(self) -> list[NodeConfig]:
        nodes = []
        for i in range(self.n_nodes):
            if self.federation == "CFL":
                role = "server" if i == 0 else "trainer"
            elif self.federation == "SDFL":
                role = "aggregator" if i == 0 else "trainer"
            else:
                role = "aggregator"
            nodes.append(NodeConfig(idx=i, role=role, start=(i == 0)))
        return nodes

    def materialize_elastic(self) -> None:
        """Expand the churn and straggler knobs into per-node profiles
        and FaultEvents (the JAX package's derivation, seeded the same
        way, so the same nodes churn and straggle; idempotent).

        Stragglers: the first ``ceil(straggler_fraction * n)`` nodes of
        a seeded shuffle (starter excluded) get ``fit_slowdown =
        straggler_factor``. Churn: the next ``ceil(churn_fraction * n)``
        crash at ~1/3 of the rounds and join at ~2/3."""
        el = self.elastic
        if el.straggler_fraction <= 0.0 and el.churn_fraction <= 0.0:
            return
        rng = random.Random((el.seed, "elastic", self.n_nodes).__repr__())
        order = list(range(self.n_nodes))
        rng.shuffle(order)
        # the starter neither churns nor straggles
        starters = {nc.idx for nc in self.nodes if nc.start} or {0}
        order = [i for i in order if i not in starters]
        n_strag = math.ceil(el.straggler_fraction * self.n_nodes)
        n_churn = math.ceil(el.churn_fraction * self.n_nodes)
        stragglers = set(order[:n_strag])
        churners = set(order[n_strag:n_strag + n_churn])
        by_idx = {nc.idx: nc for nc in self.nodes}
        for i in stragglers:
            by_idx[i].fit_slowdown = el.straggler_factor
        rounds = self.training.rounds
        crash_r = max(rounds // 3, 1)
        join_r = max((2 * rounds) // 3, crash_r + 1)
        planned = [
            FaultEvent(node=i, round=r, kind=k)
            for i in sorted(churners)
            for r, k in ((crash_r, "crash"), (join_r, "join"))
        ]
        have = {(f.node, f.round, f.kind) for f in self.faults}
        self.faults.extend(
            f for f in planned if (f.node, f.round, f.kind) not in have
        )

    # ---- JSON round-trip -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @staticmethod
    def from_dict(d: dict) -> "ScenarioConfig":
        d = dict(d)
        for field, cls in [
            ("data", DataConfig),
            ("model", ModelConfig),
            ("training", TrainingConfig),
            ("protocol", ProtocolConfig),
            ("adversary", AdversaryConfig),
            ("elastic", ElasticConfig),
            ("cross_device", CrossDeviceConfig),
            ("privacy", PrivacyConfig),
            ("lora", LoraConfig),
        ]:
            if field in d and isinstance(d[field], dict):
                d[field] = cls(**d[field])
        if "nodes" in d:
            d["nodes"] = [
                NodeConfig(**n) if isinstance(n, dict) else n
                for n in d["nodes"]
            ]
        if "faults" in d:
            d["faults"] = [
                FaultEvent(**f) if isinstance(f, dict) else f
                for f in d["faults"]
            ]
        return ScenarioConfig(**d)

    @staticmethod
    def load(path: str | pathlib.Path) -> "ScenarioConfig":
        return ScenarioConfig.from_dict(
            json.loads(pathlib.Path(path).read_text()))
