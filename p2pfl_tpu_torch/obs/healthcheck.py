"""``python -m p2pfl_tpu_torch.obs.healthcheck <dir>`` — health as an exit code.

The counterpart of ``p2pfl_tpu/obs/healthcheck.py``, with its exit codes.

One-shot mode evaluates a scenario/status directory once and exits
0 (healthy) / 1 (warnings) / 2 (critical), so shell scripts and CI can
gate on federation health the same way they gate on a test run:

    python -m p2pfl_tpu_torch.obs.healthcheck fl_logs/mnist_8 || exit 1

``--watch`` keeps a persistent engine polling the directory, printing
fire/clear *transitions* as they happen (and alert lines on ``--json``
as JSONL); the exit code then reflects the worst severity seen, which
is what a detection-latency probe consumes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from p2pfl_tpu_torch.obs.health import HealthConfig, HealthEngine, evaluate_dir

_EXIT = {"ok": 0, "warn": 1, "crit": 2}


def _fmt(alert) -> str:
    who = "federation" if alert.node is None else f"node {alert.node}"
    return f"[{alert.severity.upper():4s}] {alert.rule:20s} {who}: " \
           f"{alert.message}"


def build_engine(args: argparse.Namespace) -> HealthEngine:
    cfg = HealthConfig()
    if args.liveness_s is not None:
        cfg.liveness_s = args.liveness_s
    if args.stall_rounds is not None:
        cfg.stall_rounds = args.stall_rounds
    if args.stall_s is not None:
        cfg.stall_s = args.stall_s
    return HealthEngine(config=cfg)


def run_once(directory: str, engine: HealthEngine,
             as_json: bool) -> int:
    alerts, _ = evaluate_dir(directory, engine=engine)
    if as_json:
        print(json.dumps({
            "severity": engine.worst(),
            "alerts": [a.to_dict() for a in alerts],
        }))
    else:
        if not alerts:
            print("healthy: no alerts")
        for a in alerts:
            print(_fmt(a))
    return _EXIT[engine.worst()]


def run_watch(directory: str, engine: HealthEngine, interval_s: float,
              as_json: bool, max_s: float | None) -> int:
    worst_seen = "ok"
    t0 = time.monotonic()
    n_transitions = 0
    while True:
        evaluate_dir(directory, engine=engine)
        for tr in engine.transitions[n_transitions:]:
            if as_json:
                print(json.dumps(tr), flush=True)
            else:
                node = "federation" if tr["node"] is None \
                    else f"node {tr['node']}"
                if tr["event"] == "fire":
                    print(f"FIRE  {tr['rule']} {node}: {tr['message']}",
                          flush=True)
                else:
                    print(f"CLEAR {tr['rule']} {node}", flush=True)
        n_transitions = len(engine.transitions)
        w = engine.worst()
        if _EXIT[w] > _EXIT[worst_seen]:
            worst_seen = w
        if max_s is not None and time.monotonic() - t0 >= max_s:
            return _EXIT[worst_seen]
        time.sleep(interval_s)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m p2pfl_tpu_torch.obs.healthcheck",
        description="Evaluate federation health rules over a scenario "
                    "or status directory; exit 0 healthy / 1 warn / "
                    "2 crit.")
    ap.add_argument("directory",
                    help="scenario dir (containing status/) or the "
                         "status dir itself")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON doc, or "
                         "JSONL transitions under --watch)")
    ap.add_argument("--watch", action="store_true",
                    help="poll continuously, print fire/clear "
                         "transitions")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="watch poll period seconds (default 1.0)")
    ap.add_argument("--max-s", type=float, default=None,
                    help="watch: stop after this many seconds and exit "
                         "with the worst severity seen")
    ap.add_argument("--liveness-s", type=float, default=None,
                    help="override node-dead liveness threshold")
    ap.add_argument("--stall-rounds", type=int, default=None,
                    help="override round-stall cohort-lag threshold")
    ap.add_argument("--stall-s", type=float, default=None,
                    help="override round-stall no-advance threshold")
    args = ap.parse_args(argv)

    engine = build_engine(args)
    if args.watch:
        try:
            return run_watch(args.directory, engine, args.interval,
                             args.json, args.max_s)
        except KeyboardInterrupt:
            return _EXIT[engine.worst()]
    return run_once(args.directory, engine, args.json)


if __name__ == "__main__":
    sys.exit(main())
