"""Automated perf attribution: *where did the round go*, as a report.

The counterpart of ``p2pfl_tpu/obs/perf_report.py``. It mechanizes the
hand loop (merge the traces, read the critpath table, divide FLOPs by
walls, cross-reference the BENCH trajectory) over the artifacts the
stack already writes:

1. **critical-path components** (obs.critpath): per-round
   fit/wire/wait/agg/other over every ``node.round`` span, averaged
   across nodes and rounds into one ranked "where the round went"
   table;
2. **device-level step phases** (obs.devprof): when the trace carries
   ``devprof.*`` spans, the fit bucket is subdivided into
   data/forward/backward/update/accum so the verdict reaches *inside*
   the fit;
3. **recompile counters**: the per-process ``xla/backend_compiles``
   totals the tracer exports. A port-written trace carries none (eager
   PyTorch compiles no round program), so they read 0 there; a JAX
   process in a mixed fleet still contributes its own;
4. **the BENCH trajectory** (``--bench BENCH_*.json ...``): each
   HEADLINE key of the LAST file given (the candidate) is compared
   against the best-ever value across all given files with matching
   provenance (the baseline discipline of
   ``scripts/check_bench_regress.py``, whose few functions this module
   keeps a copy of, so the package reads nothing outside itself), and
   the component furthest over its floor is named.

Usage::

    python -m p2pfl_tpu_torch.obs.perf_report <trace-dir> [--round N]
        [--bench BENCH_a.json BENCH_b.json ...] [--json]

Exit code 1 when there is nothing to attribute (no readable trace
files, or no ``node.round`` spans — tracing was off).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Any

from p2pfl_tpu_torch.obs import critpath
from p2pfl_tpu_torch.obs.devprof import PHASE_SPANS

_COMPONENTS = ("fit", "wire", "wait", "agg", "other")
_RECOMPILE_KEY = "xla/backend_compiles"


def devprof_phases(doc: dict) -> dict[str, dict[str, float]]:
    """Per-phase totals of the ``devprof.*`` spans across the whole
    merged trace: ``{phase: {total_s, count}}``. Empty when the run was
    not step-profiled (P2PFL_DEVPROF=step)."""
    out: dict[str, dict[str, float]] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X" or ev.get("name") not in PHASE_SPANS:
            continue
        rec = out.setdefault(ev["name"], {"total_s": 0.0, "count": 0})
        rec["total_s"] += float(ev.get("dur", 0.0)) / 1e6
        rec["count"] += 1
    for rec in out.values():
        rec["total_s"] = round(rec["total_s"], 6)
    return out


def recompile_total(doc: dict) -> int:
    """Summed post-warm-up backend-compile count across every traced
    process (the tracer's exported counters)."""
    total = 0
    by_pid = doc.get("metadata", {}).get("counters_by_pid", {}) or {}
    for counters in by_pid.values():
        total += int((counters or {}).get(_RECOMPILE_KEY, 0))
    return total


def attribute(doc: dict, round_no: int | None = None) -> dict[str, Any]:
    """The full attribution over one merged trace document.

    Components are the per-round means of the per-node critpath
    decomposition, then averaged across the analyzed rounds — the
    steady-state shape of a round, not one outlier's. The devprof fit
    split reports both the raw phase seconds and each phase's share of
    the fit bucket (phases are proportions: the step-profiled pipeline
    is not the fused production program, so its absolute seconds only
    bound, never equal, the production fit)."""
    result = critpath.analyze(doc, round_no=round_no)
    per_round: list[dict[str, float]] = []
    rounds_used: list[int] = []
    for rn, rec in sorted(result["rounds"].items()):
        nodes = rec["nodes"]
        if not nodes:
            continue
        rounds_used.append(rn)
        mean = {c: sum(n[f"{c}_s"] for n in nodes.values()) / len(nodes)
                for c in _COMPONENTS}
        mean["round"] = sum(n["round_s"] for n in nodes.values()) / len(nodes)
        per_round.append(mean)
    if not per_round:
        return {"rounds": [], "components": {}, "top": None}
    comps = {
        c: round(sum(r[c] for r in per_round) / len(per_round), 6)
        for c in _COMPONENTS
    }
    round_s = sum(r["round"] for r in per_round) / len(per_round)
    top = max(comps, key=comps.get)
    out: dict[str, Any] = {
        "rounds": rounds_used,
        "round_s": round(round_s, 6),
        "components": comps,
        "top": top,
        "recompiles": recompile_total(doc),
    }
    phases = devprof_phases(doc)
    if phases:
        phase_sum = sum(p["total_s"] for p in phases.values())
        split = {}
        for name, p in sorted(phases.items()):
            share = p["total_s"] / phase_sum if phase_sum else 0.0
            split[name] = {
                "total_s": p["total_s"], "count": p["count"],
                "share_of_fit": round(share, 4),
                "fit_s_est": round(share * comps["fit"], 6),
            }
        out["fit_phases"] = split
        if top == "fit" and split:
            top_phase = max(split, key=lambda k: split[k]["total_s"])
            out["top"] = f"fit.{top_phase.split('.', 1)[1]}"
    return out


# ---------------------------------------------------------------------
# BENCH trajectory join
# ---------------------------------------------------------------------

# the baseline discipline of scripts/check_bench_regress.py (HEADLINE,
# _provenance, load_parsed, baseline_over), kept here verbatim
# key -> "lower" (time-like: smaller is better) | "higher" (rate-like)
HEADLINE: dict[str, str] = {
    "value": "lower",  # headline s/round (metric-string matched)
    "mfu": "higher",
    # round 22: device-slope MFU (pacing sleeps subtracted) — the
    # utilization number the live devprof gauge is validated against
    "mfu_device": "higher",
    "round_s_8node": "lower",
    "socket_round_s_24node": "lower",
    "vit32_krum_round_s": "lower",
    "cifar16_dirichlet_round_s": "lower",
    "cpu8_ring_dense_round_s": "lower",
    "crossdev_round_s_10k": "lower",
    "crossdev_clients_per_s": "higher",
    # round 20: the sharded-scan mechanism gate — even where sharding
    # is an honest negative (fake host devices), a regression here
    # means the shard_map path itself got slower
    "crossdev_sharded_round_s": "lower",
    "chaos_recovery_s": "lower",
    "chaos_final_accuracy": "higher",
    "aggd_round_s_24node_uncapped": "lower",
    "lora_payload_reduction": "higher",
    # round 21: the secagg masking/quantization tax on socket round
    # wall time — the privacy plane's only perf headline
    "private_secagg_overhead_pct": "lower",
}
def _provenance(parsed: dict) -> tuple[str, int]:
    """``(backend, device_count)`` of one parsed envelope. Rows
    predating the round-20 stamps default to ``("cpu", 1)`` — every
    checked-in trajectory row before the stamps existed was a 1-device
    CPU dev-box run, so the default matches reality instead of
    vacuuming legacy history out of the baseline."""
    meta = parsed.get("meta")
    meta = meta if isinstance(meta, dict) else {}
    backend = meta.get("backend") or "cpu"
    try:
        devices = int(meta.get("device_count") or 1)
    except (TypeError, ValueError):
        devices = 1
    return (str(backend), devices)


def load_parsed(path: pathlib.Path) -> dict | None:
    """The parsed key dict of one BENCH envelope (or a bare key dict —
    what a synthetic test candidate looks like); None when the round
    didn't complete (rc != 0 / empty parsed) and must not anchor
    baselines."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return None
    if not isinstance(doc, dict):
        return None
    if "parsed" in doc or "rc" in doc:
        if doc.get("rc") not in (0, None):
            return None
        parsed = doc.get("parsed")
        return parsed if isinstance(parsed, dict) and parsed else None
    return doc or None


def baseline_over(history: list[tuple[str, dict]], key: str,
                  direction: str, metric: str | None,
                  provenance: tuple[str, int] | None = None
                  ) -> tuple[float, str] | None:
    """(best value, which file it came from) for one headline key.

    ``provenance``: the candidate's ``(backend, device_count)`` — rows
    measured on different hardware are skipped (a 1-device history must
    not gate an 8-device run, or vice versa), the same matched-rows
    discipline the ``value`` key applies via ``metric``."""
    best: tuple[float, str] | None = None
    for name, parsed in history:
        v = parsed.get(key)
        if not isinstance(v, (int, float)):
            continue
        if key == "value" and metric is not None \
                and parsed.get("metric") != metric:
            continue
        if provenance is not None and _provenance(parsed) != provenance:
            continue
        v = float(v)
        if (best is None
                or (direction == "lower" and v < best[0])
                or (direction == "higher" and v > best[0])):
            best = (v, name)
    return best


def bench_attribution(bench_paths: list[str]) -> dict[str, Any]:
    """HEADLINE keys of the last envelope given vs the best-ever
    provenance-matched values over all of them; the top over-floor key
    is the component the next perf PR should attack. over_floor_pct is
    always worse-is-positive regardless of the key's direction."""
    history: list[tuple[str, dict]] = []
    for p in bench_paths:
        parsed = load_parsed(pathlib.Path(p))
        if parsed is not None:
            history.append((pathlib.Path(p).name, parsed))
    if not history:
        return {"rows": [], "top": None, "error": "no parseable envelopes"}
    cand_name, cand = history[-1]
    prov = _provenance(cand)
    rows = []
    for key, direction in sorted(HEADLINE.items()):
        v = cand.get(key)
        if not isinstance(v, (int, float)):
            continue
        best = baseline_over(history, key, direction,
                                 cand.get("metric"), provenance=prov)
        if best is None or best[0] == 0:
            continue
        v = float(v)
        over = ((v - best[0]) if direction == "lower" else (best[0] - v))
        rows.append({
            "key": key, "value": v, "best": best[0], "best_from": best[1],
            "over_floor_pct": round(100.0 * over / abs(best[0]), 2),
        })
    rows.sort(key=lambda r: -r["over_floor_pct"])
    over_floor = [r for r in rows if r["over_floor_pct"] > 0]
    return {
        "candidate": cand_name,
        "rows": rows,
        "top": over_floor[0]["key"] if over_floor else None,
    }


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

def _fmt_report(attr: dict, bench: dict | None) -> str:
    lines = []
    rounds = attr["rounds"]
    span = (f"round {rounds[0]}" if len(rounds) == 1
            else f"rounds {rounds[0]}-{rounds[-1]}")
    lines.append(f"where the round went (mean over {span}, "
                 f"{attr['round_s']:.3f}s/round)")
    lines.append(f"  {'COMPONENT':<12}{'S/ROUND':>10}{'SHARE':>8}")
    total = sum(attr["components"].values()) or 1.0
    ranked = sorted(attr["components"].items(), key=lambda kv: -kv[1])
    for name, v in ranked:
        lines.append(f"  {name:<12}{v:>10.3f}{100 * v / total:>7.1f}%")
    phases = attr.get("fit_phases")
    if phases:
        lines.append("  fit phases (devprof step profile):")
        lines.append(f"    {'PHASE':<12}{'SPAN_S':>10}{'OF FIT':>8}"
                     f"{'EST S/ROUND':>13}")
        for name, p in sorted(phases.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            short = name.split(".", 1)[1]
            lines.append(
                f"    {short:<12}{p['total_s']:>10.3f}"
                f"{100 * p['share_of_fit']:>7.1f}%"
                f"{p['fit_s_est']:>13.3f}")
    lines.append(f"recompiles: {attr['recompiles']} post-warm-up backend "
                 "compiles across traced processes")
    lines.append(f"top component: {attr['top']}")
    if bench is not None:
        lines.append("")
        if bench.get("error"):
            lines.append(f"bench trajectory: {bench['error']}")
        else:
            lines.append(f"bench trajectory (candidate {bench['candidate']} "
                         "vs best-ever, provenance-matched)")
            lines.append(f"  {'KEY':<32}{'VALUE':>12}{'BEST':>12}"
                         f"{'OVER-FLOOR':>12}")
            for r in bench["rows"]:
                lines.append(
                    f"  {r['key']:<32}{r['value']:>12.4g}"
                    f"{r['best']:>12.4g}{r['over_floor_pct']:>+11.1f}%")
            if bench["top"]:
                top = bench["rows"][0]
                lines.append(
                    f"top over-floor: {top['key']} "
                    f"{top['over_floor_pct']:+.1f}% vs {top['best_from']}")
            else:
                lines.append("top over-floor: none — every headline key "
                             "is at its historical floor")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="p2pfl_tpu_torch.obs.perf_report")
    ap.add_argument("inputs", nargs="+",
                    help="trace directory (searched recursively for "
                         "*.trace.json) or individual trace files")
    ap.add_argument("--round", type=int, default=None,
                    help="restrict attribution to one round")
    ap.add_argument("--bench", nargs="+", default=None, metavar="BENCH",
                    help="BENCH_*.json envelopes, oldest first; the "
                         "last is the candidate judged against the "
                         "best-ever of the rest")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON instead of the report")
    args = ap.parse_args(argv)
    doc = critpath.load_merged(args.inputs)
    if doc["metadata"]["files"] == 0:
        print(f"no readable trace files under {args.inputs}",
              file=sys.stderr)
        return 1
    attr = attribute(doc, round_no=args.round)
    if not attr["rounds"]:
        print("no node.round spans found (was tracing enabled?)",
              file=sys.stderr)
        return 1
    bench = bench_attribution(args.bench) if args.bench else None
    if args.json:
        out = dict(attr)
        if bench is not None:
            out["bench"] = bench
        print(json.dumps(out, sort_keys=True))
    else:
        print(_fmt_report(attr, bench))
    return 0


if __name__ == "__main__":
    sys.exit(main())
