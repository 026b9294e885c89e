"""``chaos16``'s accuracy gap on the CPU, in either package.

    python scripts/chaos16_gap.py --package p2pfl_tpu_torch [--seeds 0 1 2 3 4]
    python scripts/chaos16_gap.py --package p2pfl_tpu [--seeds 0 1 2 3 4]

Runs ``bench.py``'s ``chaos16`` socket federation (16 mnist-mlp nodes
fully connected, 60 samples, 6 rounds, lr 0.05; aggregation 12 s, vote
5 s, node 3 s; async at 0.4, beta 0.5; a checkpoint a round; halves cut
at round 2, node 11 crashed at 2, heal and restart at 4) and its
fault-free twin through the named package's ``run_simulation`` on the
CPU, once per seed (the scenario's and the data's seed), and prints one
JSON line per seed: both arms' mean accuracy, the gap (twin minus
chaos; ``bench.py``'s acceptance is 0.05), the chaos arm's
``recovery_s`` and both walls, or the error that ended the seed's run.
The same settings as ``chip_smoke.py``'s phase 14b. One process imports
one package: the port's run never imports JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
HALVES = [list(range(8)), list(range(8, 16))]
FAULTS = [{"kind": "partition", "node": 0, "round": 2, "groups": HALVES},
          {"kind": "crash", "node": 11, "round": 2},
          {"kind": "heal", "node": 0, "round": 4},
          {"kind": "restart", "node": 11, "round": 4}]


def chaos16(seed: int, faults: list, ckpt_dir: str) -> dict:
    return {
        "name": "chaos16", "n_nodes": 16, "topology": "fully", "seed": seed,
        "data": {"dataset": "mnist", "samples_per_node": 60, "seed": seed},
        "training": {"rounds": 6, "epochs_per_round": 1,
                     "learning_rate": 0.05},
        "protocol": {"heartbeat_period_s": 0.5, "aggregation_timeout_s": 12.0,
                     "vote_timeout_s": 5.0, "node_timeout_s": 3.0,
                     "train_set_size": 16, "gossip_fanout": 8},
        "elastic": {"async_aggregation": True, "min_received": 0.4,
                    "staleness_beta": 0.5, "heartbeat_backoff_base_s": 0.25},
        "faults": faults, "checkpoint_dir": ckpt_dir, "checkpoint_every": 1,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="chaos16_gap.py")
    ap.add_argument("--package", required=True,
                    choices=("p2pfl_tpu_torch", "p2pfl_tpu"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--timeout", type=float, default=300)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    kwargs = {}
    if args.package == "p2pfl_tpu":
        os.environ["XLA_FLAGS"] = ""
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import torch

        torch.set_num_threads(2)
        kwargs["device"] = "cpu"
    schema = importlib.import_module(f"{args.package}.config.schema")
    launch = importlib.import_module(f"{args.package}.p2p.launch")
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as d:
            try:
                clean = launch.run_simulation(
                    schema.ScenarioConfig.from_dict(
                        chaos16(seed, [], d + "/clean")),
                    timeout=args.timeout, **kwargs)
                chaos = launch.run_simulation(
                    schema.ScenarioConfig.from_dict(
                        chaos16(seed, FAULTS, d + "/chaos")),
                    timeout=args.timeout, **kwargs)
            except Exception as e:  # a run that failed is reported as such
                print(json.dumps({"package": args.package, "seed": seed,
                                  "error": repr(e)[:300]}), flush=True)
                continue
        ca, fa = clean["mean_accuracy"], chaos["mean_accuracy"]
        churn = chaos.get("churn") or {}
        print(json.dumps({
            "package": args.package, "seed": seed,
            "clean_accuracy": ca, "chaos_accuracy": fa,
            "gap": None if None in (ca, fa) else round(ca - fa, 4),
            "recovery_s": churn.get("recovery_s"),
            "restarted": churn.get("restarted"),
            "rounds": chaos["rounds"], "clean_wall_s": clean["wall_s"],
            "chaos_wall_s": chaos["wall_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
