"""Phase 4 of ``chip_smoke.py`` (the cross-device round) from several
checkouts in turn, on one card, to compare their round wall times.

    python scripts/torch_crossdev_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for an A/B,
the parent and the change in turns: parent, change, change, parent).
For each, in its own process with the TREE first on ``sys.path``, it
builds that tree's kernels and runs its ``chip_smoke.cross_device``:
3 materialized rounds, a streamed and a 2-chunk round, and one
profiled round. Then ``ROUNDS`` rounds of two fresh scenarios, each
round timed: that phase's FEMNIST-CNN configuration and the mnist-mlp
headline shape (10,000 clients, 256 a round in cohorts of 32). The
lines the runs print are passed through; the last line is one JSON
object with each run's round wall times, the profiled round's wall and
device-busy milliseconds, and the median of the timed rounds after the
first.
"""

from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys

# timed rounds a tree and scenario: the host's spread between rounds is
# 20-40%, so a median needs about ten
ROUNDS = 10

_RUN = """
import sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke
from p2pfl_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.kernels()
dev = torch.device("cuda", 0)
chip_smoke.cross_device(dev, None)
import json
from p2pfl_tpu_torch.config.schema import (
    CrossDeviceConfig, DataConfig, ScenarioConfig, TrainingConfig)
from p2pfl_tpu_torch.federation import CrossDeviceScenario
headline = ScenarioConfig(
    name="crossdev-headline",
    data=DataConfig(dataset="mnist", synthetic_train=50_000,
                    synthetic_test=2000, batch_size=32),
    training=TrainingConfig(rounds=2, epochs_per_round=1, learning_rate=0.1,
                            eval_every=0),
    cross_device=CrossDeviceConfig(n_clients=10_000, clients_per_round=256,
                                   cohort_size=32, seed=0),
    seed=0)
for name, cfg in (("femnist", chip_smoke.crossdev_config()),
                  ("mnist_headline", headline)):
    res = CrossDeviceScenario(cfg, device=dev).run(rounds={rounds})
    print("timed " + name + " rounds: " + json.dumps(res.round_times_s),
          flush=True)
"""


def run(tree: pathlib.Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(tree=str(tree), rounds=ROUNDS)],
        cwd=tree, capture_output=True, text=True, check=False)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stdout.write(proc.stderr[-4000:])
        raise SystemExit(f"cross-device phase failed in {tree}")
    rounds = [float(s) for s in re.findall(
        r"round \d+: ([0-9.]+) s wall", proc.stdout)]
    prof = re.search(r"profiled cross-device round \(no evaluation\): "
                     r"([0-9.]+) ms wall, device busy ([0-9.]+) ms",
                     proc.stdout)
    timed = {name: json.loads(times) for name, times in re.findall(
        r"timed (\w+) rounds: (\[.*\])", proc.stdout)}
    # the first timed round of a fresh scenario warms up: left out
    medians = {name: statistics.median(times[1:])
               for name, times in timed.items()}
    return {"tree": str(tree), "round_s": rounds,
            "profiled_wall_ms": float(prof.group(1)) if prof else None,
            "profiled_busy_ms": float(prof.group(2)) if prof else None,
            "timed_round_s": timed, "median_round_s": medians}


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_crossdev_ab: no CUDA device", file=sys.stderr)
        return 1
    results = []
    for tree in argv:
        root = pathlib.Path(tree).resolve()
        print(f"== {root}", flush=True)
        results.append(run(root))
    print(json.dumps({"runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
