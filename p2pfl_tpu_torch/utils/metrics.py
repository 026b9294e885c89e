"""FL-aware metrics logging (the counterpart of ``p2pfl_tpu/utils/metrics.py``).

Backends: JSONL (one line a write, the machine-readable stream), a
per-node long-format CSV, TensorBoard (``tensorboard=True``, through
``torch.utils.tensorboard``: one event-file run per node and one for the
federation) and Weights & Biases (``wandb=True``). Every record carries
``step``, the FL-aware global step (local steps accumulated across
rounds, continued by a resumed run), and ``round``. TensorBoard and
wandb need packages the card's machine lacks: both fail at construction
without them, not in the middle of a run.
"""

from __future__ import annotations

import csv
import json
import pathlib
from typing import Any

from p2pfl_tpu_torch.obs.records import make_record


class MetricsLogger:
    """Writes scenario-level JSONL and per-node CSV metric streams.
    ``node=None`` marks a federation-level metric (e.g. mean accuracy)."""

    def __init__(self, log_dir: str | pathlib.Path | None,
                 name: str = "scenario", tensorboard: bool = False,
                 wandb: bool = False):
        self.enabled = log_dir is not None
        self.name = name
        self._csv_files: dict[int, Any] = {}
        self._csv_writers: dict[int, Any] = {}
        self._tb_writers: dict[Any, Any] = {}
        self._tensorboard = tensorboard and self.enabled
        self._wandb_run = None
        if self._tensorboard:
            # fail at construction, not mid-run after training compute
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        if wandb:
            import wandb as _wandb

            self._wandb_run = _wandb.init(project="p2pfl_tpu", name=name)
        self.history: list[dict] = []  # the records, in memory
        if self.enabled:
            self.dir = pathlib.Path(log_dir) / name
            self.dir.mkdir(parents=True, exist_ok=True)
            # line-buffered and one complete line a write() (log_metrics):
            # O_APPEND is atomic per write, so rows of several appenders
            # never interleave, and a live tailer sees at worst a torn
            # trailing line
            self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        else:
            self.dir = None
            self._jsonl = None

    def log_metrics(self, metrics: dict[str, float], step: int = 0,
                    round: int = 0, node: int | None = None) -> None:
        rec = make_record(node, step=int(step), round=int(round),
                          **{k: float(v) for k, v in metrics.items()})
        self.history.append(rec)
        if self._wandb_run is not None:
            # independent of log_dir: one run a scenario, node metrics
            # prefixed by the node
            prefix = "" if node is None else f"node_{node}/"
            self._wandb_run.log(
                {f"{prefix}{k}": float(v) for k, v in metrics.items()},
                step=int(step))
        if not self.enabled:
            return
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if node is not None:
            self._node_csv(node, rec)
        if self._tensorboard:
            self._tb(node, metrics, step)

    def _tb(self, node: int | None, metrics: dict, step: int) -> None:
        """One scalar a metric against the FL-aware global step, so each
        node's per-round curves join into one line."""
        key = "federation" if node is None else f"node_{node}"
        if key not in self._tb_writers:
            from torch.utils.tensorboard import SummaryWriter

            self._tb_writers[key] = SummaryWriter(str(self.dir / "tb" / key))
        w = self._tb_writers[key]
        for name, value in metrics.items():
            w.add_scalar(name, float(value), int(step))

    def _node_csv(self, node: int, rec: dict) -> None:
        # long format (ts, step, round, metric, value): train and eval
        # records carry different metrics, and a wide CSV would freeze its
        # columns at the first row
        if node not in self._csv_writers:
            f = open(self.dir / f"node_{node}.csv", "a", newline="",
                     buffering=1)
            w = csv.writer(f)
            if f.tell() == 0:
                w.writerow(["ts", "step", "round", "metric", "value"])
            self._csv_files[node] = f
            self._csv_writers[node] = w
        w = self._csv_writers[node]
        for key, val in rec.items():
            if key in ("ts", "step", "round", "node"):
                continue
            w.writerow([rec["ts"], rec["step"], rec["round"], key, val])

    def round_marker(self, round: int, step: int) -> None:
        """A round-boundary record."""
        self.log_metrics({"round_boundary": 1.0}, step=step, round=round)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        for f in self._csv_files.values():
            f.close()
        for w in self._tb_writers.values():
            w.close()
        if self._wandb_run is not None:
            self._wandb_run.finish()
