"""Declarative health rules over the federation's passive telemetry.

The counterpart of ``p2pfl_tpu/obs/health.py``: the same rules, names,
thresholds and alert shape, over status directories written by either
package.

The monitor (utils.monitor) and the webapp *render* the status records
every node publishes; nothing in the stack *judges* them — a stalled
round, a silently evicted node, or a trust collapse is only visible to
a human staring at the table. This module is the judging half: a small
rule engine evaluated over the same two streams the dashboards already
tail (``node_<i>.status.json`` records and the ``metrics.jsonl``
event stream), with **firing/clear semantics** — an alert is a stateful
object that fires once when its condition appears, updates while it
holds, and clears when it goes away, so a watcher (the monitor's
alerts pane, the healthcheck CLI's exit code, the bench's detection-
latency probe) sees transitions, not a re-printed condition.

Built-in rules (severity in parentheses; all thresholds live on
``HealthConfig``):

- ``round-stall`` (warn): a live node's round lags the cohort's max
  round by ``stall_rounds``+, or — with engine state across
  evaluations — a live node's round hasn't advanced in ``stall_s``.
- ``node-dead`` (warn → crit): a node's status record is older than
  ``liveness_s``. Escalates to crit — dead *beyond quorum* — when the
  remaining live cohort falls below ``quorum_frac`` of the published
  federation, with an extra federation-level finding.
- ``trust-collapse`` (crit): a published trust score fell below
  ``trust_floor`` (reputation-weighted runs only).
- ``byte-rate`` (warn): a node's cumulative wire traffic exceeds
  ``byte_ratio`` x the cohort median by at least ``byte_floor`` bytes
  — the signature of a relay storm or a gossip loop.
- ``recompile-storm`` (warn): a node reports more than
  ``recompile_storm`` post-warm-up XLA backend compiles (a JAX node's
  recompile storm as a live alert; a port node publishes 0).
- ``accuracy-divergence`` (warn): a node's accuracy sits
  ``divergence`` below the cohort median (statuses first, newest
  ``metrics.jsonl`` Test/accuracy rows as fallback).
- ``epsilon-budget`` (warn → crit): a node's published DP spend
  (``dp_epsilon`` in the status record, from the privacy accountant)
  reached ``eps_warn_frac`` (warn) or 100% (crit) of the configured
  ``dp_epsilon_budget``. A crit here means the formal (ε, δ)
  guarantee the run was provisioned for is EXHAUSTED — every further
  round leaks beyond the stated budget, which is an operator-stop
  condition, not a performance smell.
- ``mfu-collapse`` (warn): a node's live MFU gauge (``devprof_mfu``,
  obs.devprof) fell below ``mfu_collapse_frac`` of the best it has
  published this run — compute throughput collapsed while the node
  still looks alive (input starvation, thermal/SMC throttle, a
  recompile loop eating the round). Delta-state rule: the engine
  remembers each node's best-seen MFU, and a run that never exceeded
  ``mfu_floor`` (CPU smoke runs) can't fire it.
- ``hbm-watermark`` (warn → crit): device peak-memory high-water
  (``devprof_hbm_peak_mb``) reached ``hbm_warn_frac`` (warn) /
  ``hbm_crit_frac`` (crit) of the published device-memory limit (the
  card's total memory): the next shape bump or retained buffer OOMs the
  round. Inert when no limit is published (CPU hosts).
- ``partition-suspected`` (crit): the live cohort's per-peer byte
  counters (``peer_bytes_in``/``peer_bytes_out`` in the status
  records) split into 2+ disjoint reachability components — traffic
  keeps flowing INSIDE each side of a cut while every cross-cut
  counter goes one-sided, which is exactly what the plain per-node
  totals cannot show. Needs engine state across evaluations (counter
  deltas); a single snapshot never fires it.

The engine is deliberately read-only and dependency-light: it never
talks to nodes, only to the filesystem artifacts they already publish,
so it runs identically against a live run, a finished run's corpse, or
a synthetic directory in a test.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Callable

from p2pfl_tpu_torch.obs import flight
from p2pfl_tpu_torch.utils.monitor import DEFAULT_LIVENESS_S, read_statuses

SEVERITY_ORDER = ("ok", "warn", "crit")


def worse(a: str, b: str) -> str:
    return a if SEVERITY_ORDER.index(a) >= SEVERITY_ORDER.index(b) else b


@dataclasses.dataclass(frozen=True)
class Alert:
    """One firing rule instance. ``node`` None = federation-level."""

    rule: str
    severity: str
    node: int | None
    message: str
    since: float

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HealthConfig:
    """Thresholds for the built-in rules (see module doc)."""

    liveness_s: float = DEFAULT_LIVENESS_S
    stall_rounds: int = 2
    stall_s: float = 30.0
    quorum_frac: float = 0.5
    trust_floor: float = 0.15
    byte_ratio: float = 8.0
    byte_floor: float = 1e6
    recompile_storm: int = 32
    divergence: float = 0.15
    min_cohort: int = 3  # cohort-relative rules need a real median
    # epsilon-budget: warn when dp_epsilon reaches this fraction of
    # dp_epsilon_budget; crit at/over the full budget
    eps_warn_frac: float = 0.8
    # sidecar-stalled: descriptor-queue depth at/above this while slot
    # releases sit flat across two evaluations reads as a wedged aggd
    sidecar_backlog: int = 4
    # mfu-collapse: fire when live MFU drops below this fraction of the
    # node's best-seen; peaks below mfu_floor never arm the rule (CPU
    # runs report achieved-TFLOPs only, or single-digit-permille MFU)
    mfu_collapse_frac: float = 0.5
    mfu_floor: float = 0.02
    # hbm-watermark: peak bytes vs published device limit
    hbm_warn_frac: float = 0.85
    hbm_crit_frac: float = 0.97


@dataclasses.dataclass
class Snapshot:
    """One evaluation's inputs: the status records, a metrics tail,
    and the clock they are judged against."""

    statuses: list[dict[str, Any]]
    metrics: list[dict[str, Any]]
    now: float
    cfg: HealthConfig

    def age(self, rec: dict[str, Any]) -> float:
        return max(self.now - float(rec.get("ts", 0.0)), 0.0)

    def alive(self) -> list[dict[str, Any]]:
        return [r for r in self.statuses
                if self.age(r) <= self.cfg.liveness_s]

    def node_accuracy(self) -> dict[int, float]:
        """Latest accuracy per node: status field first, newest
        Test/accuracy metrics row as fallback."""
        out: dict[int, float] = {}
        for rec in self.metrics:  # oldest→newest; later rows win
            if rec.get("node") is not None and "Test/accuracy" in rec:
                out[int(rec["node"])] = float(rec["Test/accuracy"])
        for rec in self.statuses:
            if rec.get("accuracy") is not None:
                out[int(rec.get("node", -1))] = float(rec["accuracy"])
        return out


# ---------------------------------------------------------------------
# built-in rules: (Snapshot, HealthEngine) -> [finding dict]
# a finding is {"node": int|None, "message": str, "severity"?: str}
# ---------------------------------------------------------------------

def rule_round_stall(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    out = []
    alive = [r for r in snap.alive() if r.get("round") is not None]
    rounds = [int(r["round"]) for r in alive]
    front = max(rounds) if rounds else 0
    for rec in alive:
        node, rnd = int(rec.get("node", -1)), int(rec["round"])
        lag = front - rnd
        seen = eng.round_progress.get(node)
        stuck_s = (snap.now - seen[1]) if seen and seen[0] == rnd else 0.0
        if len(alive) >= 2 and lag >= snap.cfg.stall_rounds:
            out.append({"node": node,
                        "message": f"round {rnd} lags cohort front "
                                   f"{front} by {lag}"})
        elif stuck_s > snap.cfg.stall_s:
            out.append({"node": node,
                        "message": f"round {rnd} unchanged for "
                                   f"{stuck_s:.0f}s"})
    return out


def rule_node_dead(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    dead = [r for r in snap.statuses
            if snap.age(r) > snap.cfg.liveness_s]
    if not dead:
        return []
    n = len(snap.statuses)
    n_alive = n - len(dead)
    quorum = max(1, int(snap.cfg.quorum_frac * n + 0.9999))
    broken = n_alive < quorum
    sev = "crit" if broken else "warn"
    out = [
        {"node": int(r.get("node", -1)), "severity": sev,
         "message": f"silent for {snap.age(r):.0f}s "
                    f"(liveness {snap.cfg.liveness_s:.0f}s)"}
        for r in dead
    ]
    if broken:
        out.append({"node": None, "severity": "crit",
                    "message": f"quorum lost: {n_alive}/{n} alive "
                               f"(need {quorum})"})
    return out


def rule_trust_collapse(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    return [
        {"node": int(r.get("node", -1)),
         "message": f"trust {float(r['trust']):.3f} < floor "
                    f"{snap.cfg.trust_floor}"}
        for r in snap.alive()
        if r.get("trust") is not None
        and float(r["trust"]) < snap.cfg.trust_floor
    ]


def rule_byte_rate(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    recs = [r for r in snap.alive() if r.get("bytes_out") is not None]
    if len(recs) < snap.cfg.min_cohort:
        return []
    vals = sorted(float(r["bytes_out"]) for r in recs)
    med = vals[len(vals) // 2]
    out = []
    for r in recs:
        b = float(r["bytes_out"])
        if b > med * snap.cfg.byte_ratio and b - med > snap.cfg.byte_floor:
            out.append({"node": int(r.get("node", -1)),
                        "message": f"bytes_out {b / 1e6:.1f}MB vs cohort "
                                   f"median {med / 1e6:.1f}MB"})
    return out


def rule_recompile_storm(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    return [
        {"node": int(r.get("node", -1)),
         "message": f"{int(r['recompiles'])} post-warm-up XLA compiles "
                    f"(> {snap.cfg.recompile_storm})"}
        for r in snap.alive()
        if r.get("recompiles") is not None
        and int(r["recompiles"]) > snap.cfg.recompile_storm
    ]


def rule_accuracy_divergence(snap: Snapshot,
                             eng: "HealthEngine") -> list[dict]:
    acc = snap.node_accuracy()
    if len(acc) < snap.cfg.min_cohort:
        return []
    vals = sorted(acc.values())
    med = vals[len(vals) // 2]
    return [
        {"node": node,
         "message": f"accuracy {a:.4f} is {med - a:.4f} below cohort "
                    f"median {med:.4f}"}
        for node, a in sorted(acc.items())
        if med - a > snap.cfg.divergence
    ]


def rule_epsilon_budget(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    """DP spend vs budget, judged per node from the status records the
    accountant already publishes. Fires warn at ``eps_warn_frac`` of
    the budget and crit at/over 100% — past that point the federation
    is spending privacy it never provisioned. Inert unless a record
    carries BOTH a spend and a positive budget, so non-DP runs (and DP
    runs that opted out of a budget) never see it."""
    out = []
    for rec in snap.alive():
        eps, budget = rec.get("dp_epsilon"), rec.get("dp_epsilon_budget")
        if eps is None or not budget:
            continue
        eps, budget = float(eps), float(budget)
        frac = eps / budget
        if frac >= 1.0:
            out.append({"node": int(rec.get("node", -1)), "severity": "crit",
                        "message": f"DP budget exhausted: eps {eps:.3f} >= "
                                   f"budget {budget:.3f}"})
        elif frac >= snap.cfg.eps_warn_frac:
            out.append({"node": int(rec.get("node", -1)), "severity": "warn",
                        "message": f"DP spend eps {eps:.3f} at "
                                   f"{100 * frac:.0f}% of budget "
                                   f"{budget:.3f}"})
    return out


def _peer_totals(rec: dict) -> dict[int, int] | None:
    """Combined per-peer wire totals from one status record; None when
    the record predates the per-link counters. JSON stringifies the
    peer-index keys — normalize back to ints here."""
    pin, pout = rec.get("peer_bytes_in"), rec.get("peer_bytes_out")
    if pin is None and pout is None:
        return None
    tot: dict[int, int] = {}
    for d in (pin or {}, pout or {}):
        for k, v in d.items():
            tot[int(k)] = tot.get(int(k), 0) + int(v)
    return tot


def rule_partition_suspected(snap: Snapshot,
                             eng: "HealthEngine") -> list[dict]:
    """Disjoint reachability from per-link counter deltas: a link
    (a, b) is UP when either side moved bytes toward the other since
    the previous evaluation; a partition is the live cohort splitting
    into 2+ connected components of that graph. One federation-level
    finding (node=None) naming the cohorts — the cut is a property of
    the federation, not of any single node."""
    cur: dict[int, dict[int, int]] = {}
    for rec in snap.alive():
        tot = _peer_totals(rec)
        if tot is not None:
            cur[int(rec.get("node", -1))] = tot
    prev = eng.peer_bytes
    # only nodes seen in BOTH evaluations can be judged: a first-ever
    # snapshot has no delta, and a brand-new node's silence toward
    # everyone would read as an instant (false) singleton cohort
    nodes = sorted(set(cur) & set(prev))
    if len(nodes) < snap.cfg.min_cohort:
        return []

    def grew(a: int, b: int) -> bool:
        return cur[a].get(b, 0) > prev[a].get(b, 0)

    up: dict[int, set[int]] = {a: set() for a in nodes}
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            if grew(a, b) or grew(b, a):
                up[a].add(b)
                up[b].add(a)
    if not any(up.values()):
        # NOTHING moved anywhere — a fully quiescent cohort (finished
        # run corpse, global stall) is round-stall/node-dead territory,
        # not a partition: a real cut keeps each side gossiping inside
        # itself while only the cross-cut counters go one-sided
        return []
    comps, seen = [], set()
    for a in nodes:
        if a in seen:
            continue
        stack, comp = [a], []
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            comp.append(x)
            stack.extend(up[x] - seen)
        comps.append(sorted(comp))
    if len(comps) < 2:
        return []
    comps.sort(key=lambda c: (-len(c), c))
    desc = " | ".join("{" + ",".join(map(str, c)) + "}" for c in comps)
    return [{"node": None,
             "message": f"per-peer traffic one-sided across a cohort "
                        f"cut: {desc}"}]


def rule_sidecar_stalled(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    """A healthy aggd drains its descriptor queue and releases payload
    slots every round; a wedged one (worker stuck in a decode, arena
    exhausted by leaked slots) shows the queue DEEPENING while the
    release counter sits flat. Delta-state rule like
    partition-suspected: judged against the previous evaluation's
    (depth, releases) baseline, so a single busy snapshot can't fire."""
    out = []
    for rec in snap.alive():
        depth, rel = rec.get("aggd_desc_q_depth"), rec.get("aggd_slot_releases")
        if depth is None or rel is None:
            continue
        node = int(rec.get("node", -1))
        prev = eng.aggd_state.get(node)
        if prev is None:
            continue  # first sighting — no delta to judge
        depth, rel = int(depth), int(rel)
        if (depth > prev[0] and depth >= snap.cfg.sidecar_backlog
                and rel == prev[1]):
            out.append({
                "node": node,
                "message": f"aggregation sidecar stalled: descriptor "
                           f"queue {prev[0]}->{depth} deep with slot "
                           f"releases flat at {rel}",
            })
    return out


def rule_mfu_collapse(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    """Live MFU vs the node's own best: utilization is workload- and
    chip-relative, so an absolute floor would be wrong on every part at
    once — but HALVING against your own run's best while still alive is
    a regression wherever it happens. Judged against the engine's
    previous-evaluation peak (``_note_progress`` folds the current
    gauge in afterward), so the collapse is measured, not self-reset."""
    out = []
    for rec in snap.alive():
        v = rec.get("devprof_mfu")
        if v is None:
            continue
        node = int(rec.get("node", -1))
        peak = eng.mfu_peak.get(node, 0.0)
        if peak < snap.cfg.mfu_floor:
            continue  # never armed — nothing meaningful to halve from
        v = float(v)
        if v < snap.cfg.mfu_collapse_frac * peak:
            out.append({
                "node": node,
                "message": f"MFU collapsed to {100 * v:.1f}% from "
                           f"best-seen {100 * peak:.1f}% "
                           f"(< {snap.cfg.mfu_collapse_frac:.0%})",
            })
    return out


def rule_hbm_watermark(snap: Snapshot, eng: "HealthEngine") -> list[dict]:
    """Device peak-memory high-water against the backend's published
    limit. Warn means the headroom is one retained buffer from gone;
    crit means the next allocation of any size may OOM the round.
    Inert without a limit gauge — CPU hosts publish RSS only, and a
    host watermark has no hard ceiling to judge against."""
    out = []
    for rec in snap.alive():
        peak, limit = (rec.get("devprof_hbm_peak_mb"),
                       rec.get("devprof_hbm_limit_mb"))
        if peak is None or not limit:
            continue
        frac = float(peak) / float(limit)
        if frac < snap.cfg.hbm_warn_frac:
            continue
        sev = "crit" if frac >= snap.cfg.hbm_crit_frac else "warn"
        out.append({
            "node": int(rec.get("node", -1)), "severity": sev,
            "message": f"HBM high-water {float(peak):.0f}MB is "
                       f"{100 * frac:.0f}% of the "
                       f"{float(limit):.0f}MB limit",
        })
    return out


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    severity: str  # default severity; a finding may override
    check: Callable[[Snapshot, "HealthEngine"], list[dict]]


def default_rules() -> list[Rule]:
    return [
        Rule("round-stall", "warn", rule_round_stall),
        Rule("node-dead", "warn", rule_node_dead),
        Rule("trust-collapse", "crit", rule_trust_collapse),
        Rule("byte-rate", "warn", rule_byte_rate),
        Rule("recompile-storm", "warn", rule_recompile_storm),
        Rule("accuracy-divergence", "warn", rule_accuracy_divergence),
        Rule("epsilon-budget", "warn", rule_epsilon_budget),
        Rule("partition-suspected", "crit", rule_partition_suspected),
        Rule("sidecar-stalled", "warn", rule_sidecar_stalled),
        Rule("mfu-collapse", "warn", rule_mfu_collapse),
        Rule("hbm-watermark", "warn", rule_hbm_watermark),
    ]


class HealthEngine:
    """Stateful evaluator: tracks which (rule, node) pairs are firing,
    records fire/clear transitions (also into the flight recorder —
    alerts are themselves control events worth a postmortem), and
    remembers per-node round progress so the stall rule can see time,
    not just a single snapshot."""

    def __init__(self, rules: list[Rule] | None = None,
                 config: HealthConfig | None = None):
        self.rules = list(rules) if rules is not None else default_rules()
        self.config = config or HealthConfig()
        self.active: dict[tuple[str, int | None], Alert] = {}
        self.transitions: list[dict[str, Any]] = []
        # node -> (round, ts first seen at that round)
        self.round_progress: dict[int, tuple[int, float]] = {}
        # node -> per-peer combined wire totals at the previous
        # evaluation (partition-suspected's delta baseline)
        self.peer_bytes: dict[int, dict[int, int]] = {}
        # node -> (desc-queue depth, slot releases) at the previous
        # evaluation (sidecar-stalled's delta baseline)
        self.aggd_state: dict[int, tuple[int, int]] = {}
        # node -> best devprof_mfu seen (mfu-collapse's baseline)
        self.mfu_peak: dict[int, float] = {}

    # -- evaluation -----------------------------------------------------
    def _note_progress(self, snap: Snapshot) -> None:
        for rec in snap.statuses:
            if rec.get("round") is None:
                continue
            node, rnd = int(rec.get("node", -1)), int(rec["round"])
            seen = self.round_progress.get(node)
            if seen is None or seen[0] != rnd:
                self.round_progress[node] = (rnd, snap.now)
        for rec in snap.statuses:
            tot = _peer_totals(rec)
            if tot is not None:
                self.peer_bytes[int(rec.get("node", -1))] = tot
        for rec in snap.statuses:
            depth = rec.get("aggd_desc_q_depth")
            rel = rec.get("aggd_slot_releases")
            if depth is not None and rel is not None:
                self.aggd_state[int(rec.get("node", -1))] = (
                    int(depth), int(rel))
        for rec in snap.statuses:
            v = rec.get("devprof_mfu")
            if v is not None:
                node = int(rec.get("node", -1))
                self.mfu_peak[node] = max(self.mfu_peak.get(node, 0.0),
                                          float(v))

    def evaluate(self, statuses: list[dict[str, Any]],
                 metrics: list[dict[str, Any]] | None = None,
                 now: float | None = None) -> list[Alert]:
        now = time.time() if now is None else now
        snap = Snapshot(statuses, list(metrics or ()), now, self.config)
        found: dict[tuple[str, int | None], tuple[str, str]] = {}
        for rule in self.rules:
            for f in rule.check(snap, self):
                key = (rule.name, f.get("node"))
                found[key] = (f.get("severity", rule.severity),
                              f["message"])
        # progress bookkeeping AFTER the rules: a round advance must be
        # judged against the PREVIOUS evaluation's state, or a stalled
        # node would reset its own stall clock every tick
        self._note_progress(snap)
        for key, (sev, msg) in found.items():
            cur = self.active.get(key)
            if cur is None:
                self.active[key] = Alert(key[0], sev, key[1], msg, now)
                self.transitions.append(
                    {"event": "fire", "rule": key[0], "node": key[1],
                     "severity": sev, "message": msg, "ts": now})
                flight.record("health.fire", rule=key[0], node=key[1],
                              severity=sev, message=msg)
            else:  # still firing: refresh message/severity, keep since
                self.active[key] = dataclasses.replace(
                    cur, severity=sev, message=msg)
        for key in [k for k in self.active if k not in found]:
            gone = self.active.pop(key)
            self.transitions.append(
                {"event": "clear", "rule": gone.rule, "node": gone.node,
                 "severity": gone.severity, "ts": now})
            flight.record("health.clear", rule=gone.rule, node=gone.node)
        return self.alerts()

    # -- reading --------------------------------------------------------
    def alerts(self) -> list[Alert]:
        """Active alerts, most severe first, then by rule/node."""
        return sorted(
            self.active.values(),
            key=lambda a: (-SEVERITY_ORDER.index(a.severity), a.rule,
                           -1 if a.node is None else a.node),
        )

    def worst(self) -> str:
        sev = "ok"
        for a in self.active.values():
            sev = worse(sev, a.severity)
        return sev


# ---------------------------------------------------------------------
# filesystem plumbing: evaluate a scenario directory
# ---------------------------------------------------------------------

def tail_jsonl(path: str | pathlib.Path, max_bytes: int = 256 * 1024
               ) -> list[dict[str, Any]]:
    """Tolerant JSONL tail: O(window) read, first line dropped when the
    window is clipped mid-line, and any torn row (a writer's partial
    trailing line observed live) skipped instead of raised."""
    path = pathlib.Path(path)
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            data = f.read()
    except OSError:
        return []
    text = data.decode("utf-8", errors="replace")
    lines = text.splitlines()
    if size > max_bytes and lines:
        lines = lines[1:]
    out = []
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn or foreign row — skip, never raise
        if isinstance(rec, dict):
            out.append(rec)
    return out


def resolve_dirs(directory: str | pathlib.Path
                 ) -> tuple[pathlib.Path, list[pathlib.Path]]:
    """(status dir, metrics.jsonl candidates) for a target that may be
    the status dir itself or the scenario dir containing it."""
    d = pathlib.Path(directory)
    status = d / "status" if (d / "status").is_dir() else d
    metrics = [
        p for p in (status / "metrics.jsonl",
                    status.parent / "metrics.jsonl",
                    d / "metrics.jsonl")
        if p.is_file()
    ]
    seen: set[pathlib.Path] = set()
    uniq = [p for p in metrics
            if p.resolve() not in seen and not seen.add(p.resolve())]
    return status, uniq


def evaluate_dir(directory: str | pathlib.Path,
                 engine: HealthEngine | None = None,
                 now: float | None = None) -> tuple[list[Alert], HealthEngine]:
    """One evaluation over a scenario/status directory. Pass the same
    engine across calls to get firing/clear transitions and the
    stateful stall clock; a fresh engine gives a one-shot view."""
    engine = engine or HealthEngine()
    status_dir, metric_files = resolve_dirs(directory)
    metrics: list[dict[str, Any]] = []
    for p in metric_files:
        metrics.extend(tail_jsonl(p))
    alerts = engine.evaluate(read_statuses(status_dir), metrics, now=now)
    return alerts, engine
