"""Per-node status records on the filesystem.

The publishing half of ``p2pfl_tpu/utils/monitor.py``: each participant
atomically publishes ``node_<idx>.status.json`` into a status directory,
in the record shape and with the keys the JAX package's ``python -m
p2pfl_tpu.monitor <dir>`` reads; ``read_statuses`` reads them back for
the health rules (``obs/health.py``). The renderer itself is ROADMAP
item A25.
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Any

from p2pfl_tpu_torch.obs.records import make_record
from p2pfl_tpu_torch.utils.fsio import atomic_write_text

#: seconds of silence after which a node's record reads as dead (the JAX
#: package's monitor and health rules use the same cutoff)
DEFAULT_LIVENESS_S = 20.0

# per-(directory, node) monotonic publish sequence: ``ts`` comes from each
# host's wall clock, and ``seq`` orders one node's records without skew
_seq_lock = threading.Lock()
_seq: dict[tuple[str, int], int] = {}


def _next_seq(directory: pathlib.Path, node: int) -> int:
    key = (str(directory), int(node))
    with _seq_lock:
        _seq[key] = _seq.get(key, 0) + 1
        return _seq[key]


def publish_status(directory: str | pathlib.Path, node: int,
                   record: dict[str, Any]) -> pathlib.Path:
    """Atomically publish one node's current status record (node + ts +
    the fields, plus the monotonic ``seq``)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rec = make_record(int(node), **record)
    rec.setdefault("seq", _next_seq(directory, node))
    path = directory / f"node_{node}.status.json"
    atomic_write_text(path, json.dumps(rec))
    return path


def read_statuses(directory: str | pathlib.Path) -> list[dict[str, Any]]:
    """All published node records, sorted by node index; files that
    cannot be read (mid-replace on exotic filesystems) are skipped."""
    directory = pathlib.Path(directory)
    out = []
    for path in sorted(directory.glob("node_*.status.json")):
        try:
            out.append(json.loads(path.read_text()))
        except (ValueError, OSError):
            continue
    return sorted(out, key=lambda r: r.get("node", 0))


# The status-record keys a publisher may emit and a reader may read (the
# JAX package's registry, in its order). node/ts/seq come from
# publish_status itself.
STATUS_KEYS = (
    # record envelope (make_record + publish_status)
    "node", "ts", "seq",
    # federation identity / progress
    "role", "round", "peers", "leader", "loss", "accuracy", "trust",
    # round timing + wire traffic
    "round_p95_s", "bytes_in", "bytes_out",
    "peer_bytes_in", "peer_bytes_out", "recompiles",
    # privacy plane
    "dp_epsilon", "dp_epsilon_budget",
    # critical-path components
    "critpath_round", "critpath_round_s", "critpath_fit_s",
    "critpath_wire_s", "critpath_wait_s", "critpath_agg_s",
    "critpath_other_s",
    # cross-device throughput
    "crossdev_clients_per_s", "crossdev_prefetch_mb",
    "crossdev_prefetch_stall_s",
    # aggregation sidecar
    "aggd_desc_q_depth", "aggd_slot_releases", "aggd_bytes_ingested",
    # device profiling
    "devprof_fit_s", "devprof_tflops", "devprof_mfu",
    "devprof_hbm_peak_mb", "devprof_hbm_limit_mb", "devprof_rss_peak_mb",
)
