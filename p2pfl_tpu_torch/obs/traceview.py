"""Merge per-process federation trace files onto one timeline.

The counterpart of ``p2pfl_tpu/obs/traceview.py``; the file format is
the same in both packages, so one merge takes files written by either.
Each process of a multi-process federation (p2p/launch.py) exports one
``proc<pid>.trace.json`` into the scenario's trace directory
(``<log_dir>/<name>/trace`` — wired the same way as the status dir).
Span timestamps inside each file are perf_counter-relative (monotonic
within the process, meaningless across processes); the file's metadata
carries the wall-clock/perf anchor recorded at tracer reset. The merge
shifts every file onto a shared axis anchored at the EARLIEST process's
wall_t0, so cross-process causality (node 0's send span ending before
node 2's recv span starts) reads directly off the merged view.

Usage::

    python -m p2pfl_tpu_torch.obs.traceview <trace-dir-or-files> [-o merged.json]

The output is one valid Chrome trace-event JSON (object form) —
loadable in chrome://tracing or https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def find_trace_files(root: str | pathlib.Path) -> list[pathlib.Path]:
    """All per-process trace files under ``root`` (recursively — a
    scenario log dir works as well as the trace dir itself)."""
    root = pathlib.Path(root)
    if root.is_file():
        return [root]
    return sorted(root.rglob("*.trace.json"))


def merge(paths: list[pathlib.Path | str]) -> dict:
    """One Chrome trace-event document from many per-process files.

    Every event's ``ts`` becomes µs since the earliest file's wall
    anchor: within a file the (monotonic) perf_counter spacing is kept
    exactly; across files only the anchors' wall-clock delta shifts —
    NTP steps mid-run cannot reorder spans within a process.
    """
    docs = []
    for p in paths:
        # A crashed or still-writing process leaves a zero-byte or torn
        # file; skip it with a warning (like status tail_jsonl) so one
        # bad exporter cannot take down the whole postmortem merge.
        try:
            doc = json.loads(pathlib.Path(p).read_text())
        except (OSError, ValueError) as exc:
            print(f"traceview: skipping unreadable trace file {p}: {exc}",
                  file=sys.stderr)
            continue
        if not isinstance(doc, dict):
            print(f"traceview: skipping non-object trace file {p}",
                  file=sys.stderr)
            continue
        meta = doc.get("metadata", {})
        docs.append((float(meta.get("wall_t0", 0.0)), doc))
    if not docs:
        return {"traceEvents": [], "metadata": {"files": 0}}
    base = min(w for w, _ in docs)
    events: list[dict] = []
    counters: dict[str, dict] = {}
    for wall_t0, doc in docs:
        shift_us = (wall_t0 - base) * 1e6
        pid = doc.get("metadata", {}).get("pid")
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            events.append(ev)
        if pid is not None:
            counters[str(pid)] = doc.get("metadata", {}).get("counters", {})
    # metadata ("M") events must precede use of their pid/tid for some
    # viewers; a stable sort keeps them first at equal ts (they carry
    # no ts and sort as -inf here)
    events.sort(key=lambda e: e.get("ts", float("-inf")))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "base_wall_t0": base,
            "files": len(docs),
            "counters_by_pid": counters,
        },
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="p2pfl_tpu_torch.obs.traceview")
    ap.add_argument("inputs", nargs="+",
                    help="trace directory (searched recursively for "
                         "*.trace.json) or individual trace files")
    ap.add_argument("-o", "--output", default="merged.trace.json",
                    help="merged Chrome trace-event JSON path")
    args = ap.parse_args(argv)
    paths: list[pathlib.Path] = []
    for inp in args.inputs:
        paths.extend(find_trace_files(inp))
    if not paths:
        print(f"no *.trace.json files under {args.inputs}", file=sys.stderr)
        return 1
    merged = merge(paths)
    if merged["metadata"]["files"] == 0:
        print(f"no readable trace files under {args.inputs}", file=sys.stderr)
        return 1
    out = pathlib.Path(args.output)
    out.write_text(json.dumps(merged))
    n_spans = sum(1 for e in merged["traceEvents"] if e.get("ph") == "X")
    print(f"merged {len(paths)} file(s), {n_spans} spans -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
