"""Per-round critical-path attribution over a merged federation trace.

The counterpart of ``p2pfl_tpu/obs/critpath.py``: the same components
from the same span names, so it decomposes rounds traced by either
package, or by a fleet that mixes them.

The tracer (obs.trace) records spans; traceview merges the per-process
files onto one wall-anchored timeline; this module turns that timeline
into the answer operators actually need: *where does the round wall go*.
For every ``node.round`` span it decomposes the round into five
components —

``fit``
    learner compute on this node's lane (``node.fit`` / ``learner.fit``
    interval union, so nesting never double-counts).
``wire``
    network transit attributed from the causal trace context each PARAMS
    frame carries: ``p2p.rx`` spans record the sender's ``tx_ns`` stamp
    and the receiver's ``rx_ns``, and the one-way deltas are corrected
    for clock skew pairwise (see :func:`estimate_skew`) before being
    carved out of the wait bucket they overlap.
``wait``
    quorum / barrier / adoption blocking (``node.wait`` spans) minus the
    aggregation and wire time that elapsed inside those loops.
``aggregate``
    ``session.aggregate`` + ``session.fuse`` device/host reduce time.
``other``
    the residual (voting, serialization, scheduling) clamped >= 0.

plus the federation-wide **longest chain**: a backward walk from the
round's last-closing ``node.round`` span through the causal parent
edges (rx -> tx flow ids) hopping lanes until the round start — the
sequence of lane segments no amount of parallelism can hide.

Clock-skew caveat: ``tx_ns``/``rx_ns`` are ``time.time_ns()`` stamps
from two different hosts. The pairwise estimate assumes the *minimum*
observed one-way delta in each direction rides the same symmetric
network floor; a federation with asymmetric routes will fold half the
asymmetry into ``wire``. Within one host (the simulators, the
multi-process launcher) skew is negligible and the estimate converges
to ~0.

Usage::

    python -m p2pfl_tpu_torch.obs.critpath <trace-dir> [--round N] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from p2pfl_tpu_torch.obs import traceview

_FIT_SPANS = ("node.fit", "learner.fit")
_WAIT_SPANS = ("node.wait",)
_AGG_SPANS = ("session.aggregate", "session.fuse")
_MAX_CHAIN_HOPS = 64  # backward-walk bound; rounds never chain deeper


# ---------------------------------------------------------------------
# trace model
# ---------------------------------------------------------------------
def load_merged(inputs: list[str]) -> dict:
    """Merged Chrome trace doc from a trace dir / file list (reuses
    traceview's torn-file-tolerant merge)."""
    paths: list = []
    for inp in inputs:
        paths.extend(traceview.find_trace_files(inp))
    return traceview.merge(paths)


def _lane_names(events: list[dict]) -> dict[tuple, str]:
    """(pid, tid) -> lane name from the thread_name metadata events."""
    lanes: dict[tuple, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            lanes[(ev.get("pid"), ev.get("tid"))] = ev["args"]["name"]
    return lanes


def _union_s(ivals: list[tuple[float, float]]) -> float:
    """Total seconds covered by a set of [t0, t1) µs intervals —
    interval union, so nested/overlapping spans count once."""
    total = 0.0
    end = float("-inf")
    for t0, t1 in sorted(ivals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total / 1e6


def _overlap_s(inner: list[tuple[float, float]],
               outer: list[tuple[float, float]]) -> float:
    """Seconds of ``inner`` intervals that fall inside ``outer``."""
    total = 0.0
    for a0, a1 in inner:
        for b0, b1 in outer:
            lo, hi = max(a0, b0), min(a1, b1)
            if hi > lo:
                total += hi - lo
    return total / 1e6


def estimate_skew(rx_spans: list[dict]) -> dict[tuple, float]:
    """Pairwise clock-offset estimates in seconds.

    For each directed pair ``(sender, receiver)`` the minimum observed
    one-way delta ``d = rx_ns - tx_ns`` is ``floor_latency + offset``
    where ``offset = clock_recv - clock_send``. With both directions
    observed, ``offset(r-s) ~= (min_d_sr - min_d_rs) / 2`` (the shared
    floor cancels). Returns ``{(sender, receiver): offset_s}``; pairs
    seen in only one direction fall back to offset 0 (skew folded into
    wire — the documented caveat).
    """
    min_d: dict[tuple, float] = {}
    for ev in rx_spans:
        args = ev.get("args") or {}
        s, r = str(args.get("from")), ev["_lane"]
        d = (args["rx_ns"] - args["tx_ns"]) / 1e9
        key = (s, r)
        if key not in min_d or d < min_d[key]:
            min_d[key] = d
    skew: dict[tuple, float] = {}
    for (s, r), d_sr in min_d.items():
        d_rs = min_d.get((r, s))
        skew[(s, r)] = 0.0 if d_rs is None else (d_sr - d_rs) / 2.0
    return skew


# ---------------------------------------------------------------------
# per-round decomposition
# ---------------------------------------------------------------------
def analyze(doc: dict, round_no: int | None = None) -> dict[str, Any]:
    """Per-round critical-path breakdown of a merged trace document.

    Returns ``{"rounds": {N: {"nodes": {name: {...}}, "chain": {...}}}}``
    with per-node ``fit_s/wire_s/wait_s/agg_s/other_s/round_s`` and the
    federation-wide longest chain for each round.
    """
    events = doc.get("traceEvents", [])
    lanes = _lane_names(events)
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ev = dict(ev)
        key = (ev.get("pid"), ev.get("tid"))
        ev["_lane"] = lanes.get(key, f"{key[0]}/{key[1]}")
        ev["_t0"] = float(ev.get("ts", 0.0))
        ev["_t1"] = ev["_t0"] + float(ev.get("dur", 0.0))
        spans.append(ev)

    # node.round spans indexed by round number
    rounds: dict[int, list[dict]] = {}
    for ev in spans:
        if ev["name"] == "node.round":
            rn = int((ev.get("args") or {}).get("round", -1))
            rounds.setdefault(rn, []).append(ev)
    if round_no is not None:
        rounds = {round_no: rounds.get(round_no, [])}

    all_rx = [ev for ev in spans
              if ev["name"] == "p2p.rx" and (ev.get("args") or {})]
    skew = estimate_skew(all_rx)
    by_sid = {(ev.get("args") or {}).get("sid"): ev for ev in spans
              if ev["name"] == "p2p.tx" and (ev.get("args") or {}).get("sid")}

    out: dict[str, Any] = {"rounds": {}}
    for rn, round_spans in sorted(rounds.items()):
        nodes: dict[str, dict] = {}
        for rspan in round_spans:
            lane, lo, hi = rspan["_lane"], rspan["_t0"], rspan["_t1"]
            in_win = [ev for ev in spans
                      if ev["_lane"] == lane and ev["_t0"] >= lo
                      and ev["_t1"] <= hi]
            fit_iv = [(e["_t0"], e["_t1"]) for e in in_win
                      if e["name"] in _FIT_SPANS]
            wait_iv = [(e["_t0"], e["_t1"]) for e in in_win
                       if e["name"] in _WAIT_SPANS]
            agg_iv = [(e["_t0"], e["_t1"]) for e in in_win
                      if e["name"] in _AGG_SPANS]
            wall = (hi - lo) / 1e6
            fit = _union_s(fit_iv)
            agg = _union_s(agg_iv)
            # wait excludes the aggregation that ran inside its loops
            wait_raw = _union_s(wait_iv) - _overlap_s(agg_iv, wait_iv)
            # wire: skew-corrected one-way latencies of the PARAMS this
            # node received during the round, carved OUT of wait (a
            # node blocks on quorum while frames are in flight)
            wire_raw = 0.0
            for ev in in_win:
                if ev["name"] != "p2p.rx":
                    continue
                args = ev.get("args") or {}
                if int(args.get("round", rn)) != rn:
                    continue
                d = (args["rx_ns"] - args["tx_ns"]) / 1e9
                d -= skew.get((str(args.get("from")), lane), 0.0)
                if 0.0 < d < 60.0:
                    wire_raw += d
            wire = min(wire_raw, max(0.0, wait_raw))
            wait = max(0.0, wait_raw - wire)
            other = max(0.0, wall - fit - wire - wait - agg)
            nodes[lane] = {
                "round_s": round(wall, 6), "fit_s": round(fit, 6),
                "wire_s": round(wire, 6), "wait_s": round(wait, 6),
                "agg_s": round(agg, 6), "other_s": round(other, 6),
            }
        chain = _longest_chain(round_spans, spans, by_sid)
        out["rounds"][rn] = {"nodes": nodes, "chain": chain}
    return out


def _longest_chain(round_spans: list[dict], spans: list[dict],
                   by_sid: dict) -> dict[str, Any]:
    """Backward walk from the round's last-closing ``node.round`` span
    through causal rx->tx edges, hopping lanes. Each chain segment is
    the time spent on one lane between causal hop points — the sequence
    nothing can overlap away."""
    if not round_spans:
        return {"segments": [], "total_s": 0.0}
    tail = max(round_spans, key=lambda e: e["_t1"])
    start = min(e["_t0"] for e in round_spans)
    segments: list[dict] = []
    lane, cursor = tail["_lane"], tail["_t1"]
    for _ in range(_MAX_CHAIN_HOPS):
        # latest causally-parented rx on this lane before the cursor
        rx = None
        for ev in spans:
            if (ev["name"] == "p2p.rx" and ev["_lane"] == lane
                    and start <= ev["_t1"] <= cursor
                    and (ev.get("args") or {}).get("parent") in by_sid):
                if rx is None or ev["_t1"] > rx["_t1"]:
                    rx = ev
        if rx is None:
            segments.append({"node": lane,
                             "span_s": round((cursor - start) / 1e6, 6),
                             "via": "round-start"})
            break
        segments.append({"node": lane,
                         "span_s": round((cursor - rx["_t1"]) / 1e6, 6),
                         "via": "rx from %s" % (rx["args"].get("from"),)})
        tx = by_sid[rx["args"]["parent"]]
        lane, cursor = tx["_lane"], tx["_t0"]
        if cursor <= start:
            break
    segments.reverse()
    total = sum(s["span_s"] for s in segments)
    return {"segments": segments, "total_s": round(total, 6),
            "tail_node": tail["_lane"]}


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------
def _fmt_table(result: dict) -> str:
    lines = []
    for rn, rec in sorted(result["rounds"].items()):
        lines.append(f"round {rn}")
        hdr = (f"  {'NODE':<10}{'ROUND_S':>9}{'FIT':>8}{'WIRE':>8}"
               f"{'WAIT':>8}{'AGG':>8}{'OTHER':>8}")
        lines.append(hdr)
        for name, c in sorted(rec["nodes"].items()):
            lines.append(
                f"  {name:<10}{c['round_s']:>9.3f}{c['fit_s']:>8.3f}"
                f"{c['wire_s']:>8.3f}{c['wait_s']:>8.3f}"
                f"{c['agg_s']:>8.3f}{c['other_s']:>8.3f}")
        chain = rec["chain"]
        if chain["segments"]:
            hops = " -> ".join(f"{s['node']}({s['span_s']:.3f}s)"
                               for s in chain["segments"])
            lines.append(f"  longest chain [{chain['total_s']:.3f}s]: "
                         f"{hops}")
        lines.append("")
    return "\n".join(lines).rstrip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="p2pfl_tpu_torch.obs.critpath")
    ap.add_argument("inputs", nargs="+",
                    help="trace directory (searched recursively for "
                         "*.trace.json) or individual trace files")
    ap.add_argument("--round", type=int, default=None,
                    help="restrict the report to one round")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of a table")
    args = ap.parse_args(argv)
    doc = load_merged(args.inputs)
    if doc["metadata"]["files"] == 0:
        print(f"no readable trace files under {args.inputs}",
              file=sys.stderr)
        return 1
    result = analyze(doc, round_no=args.round)
    if not any(rec["nodes"] for rec in result["rounds"].values()):
        print("no node.round spans found (was tracing enabled?)",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result, sort_keys=True))
    else:
        print(_fmt_table(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
