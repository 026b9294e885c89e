"""Scenario configuration, read from the same JSON as the JAX package.

The counterpart of ``p2pfl_tpu/config/schema.py``. ``DataConfig``,
``ModelConfig``, ``TrainingConfig`` and ``NodeConfig`` are copies of the
JAX package's dataclasses (they import nothing but the standard
library), and so are ``CrossDeviceConfig`` and ``AdversaryConfig``
with all their validation. ``ScenarioConfig`` has the same fields, so
``ScenarioConfig.load`` reads a scenario file that ``p2pfl_tpu`` wrote.
The combinations the JAX package refuses with the cross-device regime
raise the same ``ValueError`` here, before anything else is checked.
The sections this port does not run yet (privacy, lora, elastic,
faults, the sparse transport, the staged exchange, other optimizers
and objectives, checkpoints, metric logging and the socket plane) are
kept as plain dicts and rejected in ``__post_init__`` with a
``NotImplementedError`` that names the ``ROADMAP.md`` item that ports
them: a scenario the port would silently run differently never starts.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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
class NodeConfig:
    idx: int = 0
    role: str = "trainer"
    start: bool = False
    epochs: int | None = None
    fit_slowdown: float = 1.0

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown role {self.role!r}; have {ROLES}")


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


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to p2pfl_tpu_torch yet "
        f"(ROADMAP.md queue A, item {item}); run it with p2pfl_tpu"
    )


_F32 = (None, "f32", "float32")
_BF16 = (None, "bf16", "bfloat16")


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
    # the JAX package's ProtocolConfig: only "train_set_size" (the
    # train-set vote cap, default 10, <=0 off) acts on the stacked
    # federation; the other keys pace the socket plane
    protocol: dict[str, Any] = dataclasses.field(default_factory=dict)
    aggregator: str = "fedavg"
    aggregator_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    adversary: AdversaryConfig = dataclasses.field(
        default_factory=AdversaryConfig)
    # sections this port does not run: plain dicts, checked below
    network: dict[str, Any] = dataclasses.field(default_factory=dict)
    elastic: dict[str, Any] = dataclasses.field(default_factory=dict)
    cross_device: CrossDeviceConfig = dataclasses.field(
        default_factory=CrossDeviceConfig)
    lora: dict[str, Any] = dataclasses.field(default_factory=dict)
    privacy: dict[str, Any] = dataclasses.field(default_factory=dict)
    transport: str = "auto"
    wire_dtype: str = "f32"
    exchange_overlap: str = "off"
    aggregation_plane: str = "inline"
    encrypt: bool = False
    nodes: list[NodeConfig] = dataclasses.field(default_factory=list)
    faults: list[dict[str, Any]] = dataclasses.field(default_factory=list)
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
        if self.lora.get("rank", 0) > 0:
            raise ValueError(
                "lora is not wired into the cross_device "
                "cohort-scan round yet: it would silently train "
                "full weights while the scenario says adapters"
            )
        if self.privacy.get("dp", False) or self.privacy.get("secagg",
                                                            False):
            raise ValueError(
                "privacy is not wired into the cross_device cohort-"
                "scan round yet: sampled clients are stateless rows "
                "with no per-node (seed, round, idx) noise stream or "
                "pairwise mask identity"
            )

    def _reject_unported(self) -> None:
        if self.privacy.get("dp", False):
            raise _unported("privacy.dp (DP-FedAvg)", "A7")
        if self.privacy.get("secagg", False):
            raise _unported("privacy.secagg", "A7")
        if self.lora.get("rank", 0) > 0:
            raise _unported("lora", "A8")
        el = self.elastic
        if (el.get("async_aggregation", False)
                or el.get("straggler_fraction", 0.0) > 0.0
                or el.get("churn_fraction", 0.0) > 0.0):
            raise _unported("elastic (async aggregation, churn)", "A9")
        if self.faults:
            raise _unported("faults (membership clock)", "A11")
        if self.transport == "sparse":
            raise _unported("transport='sparse'", "A12")
        if self.exchange_overlap == "staged":
            raise _unported("exchange_overlap='staged'", "A13")
        if self.training.optimizer.lower() != "sgd":
            raise _unported(f"optimizer {self.training.optimizer!r}", "A15")
        if self.model.objective != "classification":
            raise _unported(f"objective {self.model.objective!r}", "A16")
        if self.checkpoint_dir or self.checkpoint_every:
            raise _unported("checkpointing", "A17")
        if (self.log_dir or self.tensorboard or self.wandb
                or self.profile_dir):
            raise _unported("metric logging and profiling", "A18")
        net = self.network
        if (self.aggregation_plane != "inline" or self.encrypt
                or any(net.get(k) for k in ("delay_ms", "jitter_ms",
                                            "loss_pct", "rate_mbps",
                                            "partitions"))):
            raise _unported("the socket plane (network, sidecar, TLS)",
                            "A22")
        # the kernels take bf16 activations and f32 parameters
        if self.model.param_dtype not in _F32:
            raise _unported(f"param_dtype {self.model.param_dtype!r}",
                            "A19")
        if self.model.compute_dtype not in _BF16:
            raise _unported(f"compute_dtype {self.model.compute_dtype!r}",
                            "A19")

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
            ("adversary", AdversaryConfig),
            ("cross_device", CrossDeviceConfig),
        ]:
            if field in d and isinstance(d[field], dict):
                d[field] = cls(**d[field])
        if "nodes" in d:
            d["nodes"] = [
                NodeConfig(**n) if isinstance(n, dict) else n
                for n in d["nodes"]
            ]
        return ScenarioConfig(**d)

    @staticmethod
    def load(path: str | pathlib.Path) -> "ScenarioConfig":
        return ScenarioConfig.from_dict(
            json.loads(pathlib.Path(path).read_text()))
