"""Always-on bounded flight recorder for federation control events.

The counterpart of ``p2pfl_tpu/obs/flight.py``, in its event kinds and
its ``flight_<pid>.json`` format. The span tracer (obs.trace) is opt-in
because it meters *hot* paths; this recorder is the opposite trade: it
captures only *rare* control transitions (membership suspect, probe and
evict, session open/quorum/close, reputation exclusions, attack
injections, checkpoint ops, wire-dtype negotiations) so it can stay on
in every run, traced or not. When a node crashes, is evicted, or a child
process dies to an unhandled exception, the ring is dumped as
``flight_<pid>.json`` and the churn becomes explainable after the fact
instead of requiring a re-run with tracing enabled.

Design discipline (mirrors obs.trace, priority order):

1. **Recording is one deque.append.** ``record()`` builds one tuple and
   appends to a bounded ``collections.deque``, atomic under CPython, so
   the event loop and executor threads share the ring without a lock.
   No per-event I/O, no serialization until dump time.
2. **Disabled is one attribute read.** ``P2PFL_FLIGHT=0``
   short-circuits before any allocation.
3. **Dump is atomic and re-entrant.** ``dump()`` rewrites the same
   ``flight_<pid>.json`` via tmp+rename; repeated dumps (crash then
   eviction) keep the latest, fullest picture with every trigger reason
   accumulated.

Like the tracer, the process recorder is a singleton configured IN
PLACE (call sites cache the reference). The launcher and the stacked
scenario point ``dump_dir`` at ``<log_dir>/<name>/flight``; without a
configured directory postmortems land in the system temp dir so an
unconfigured crash still leaves evidence somewhere predictable.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
import time
from collections import deque
from typing import Any

from p2pfl_tpu_torch.obs import trace as _trace

ENV_VAR = "P2PFL_FLIGHT"
_RING_MAX = 1 << 12  # control-plane events are rare; 4096 spans hours


class FlightRecorder:
    """Bounded ring of (ts, kind, fields) control events + postmortem
    dump. One per process; nodes sharing an event loop share it (the
    ``node`` field attributes events, like the tracer's lanes)."""

    def __init__(self, ring_max: int = _RING_MAX):
        self.enabled = os.environ.get(ENV_VAR, "") != "0"
        self.dump_dir: pathlib.Path | None = None
        self._ring_max = ring_max
        self._events: deque = deque(maxlen=ring_max)
        self._lock = threading.Lock()  # dump/configure only, never record
        self._dump_reasons: list[str] = []
        self.wall_t0 = time.time()

    # -- configuration --------------------------------------------------
    def configure(self, enabled: bool | None = None,
                  dump_dir: str | pathlib.Path | None = None,
                  ring_max: int | None = None) -> "FlightRecorder":
        """Mutate IN PLACE (call sites cache the singleton)."""
        with self._lock:
            if ring_max is not None and ring_max != self._ring_max:
                self._ring_max = ring_max
                self._events = deque(self._events, maxlen=ring_max)
            if dump_dir is not None:
                self.dump_dir = pathlib.Path(dump_dir)
            if enabled is not None:
                self.enabled = bool(enabled)
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dump_reasons = []
            self.wall_t0 = time.time()

    # -- recording ------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        """Append one control event. Cheap enough for every call site
        to run unconditionally: one enabled check, one tuple, one
        atomic deque.append."""
        if not self.enabled:
            return
        # Stamp the active trace identity so a postmortem's control
        # events can be joined against the span timeline. One attribute
        # read when tracing is off — the recorder stays always-on cheap.
        tr = _trace.get_tracer()
        if tr.enabled and "trace" not in fields:
            fields["trace"] = tr.trace_id
        self._events.append((time.time(), kind, fields))

    # -- reading --------------------------------------------------------
    def events(self, kind: str | None = None) -> list[dict[str, Any]]:
        """Snapshot of the ring as dicts, oldest first; ``kind``
        filters by event kind."""
        return [
            {"ts": ts, "kind": k, **f}
            for ts, k, f in list(self._events)
            if kind is None or k == kind
        ]

    def __len__(self) -> int:
        return len(self._events)

    # -- postmortem -----------------------------------------------------
    def dump(self, reason: str,
             path: str | pathlib.Path | None = None) -> pathlib.Path | None:
        """Write ``flight_<pid>.json`` (atomic tmp+rename). Returns the
        path, or None when recording is disabled. Repeated dumps from
        one process overwrite the same file — every trigger reason is
        kept in ``reasons`` so the last dump tells the whole story."""
        if not self.enabled:
            return None
        with self._lock:
            self._dump_reasons.append(str(reason))
            reasons = list(self._dump_reasons)
        if path is None:
            base = self.dump_dir or pathlib.Path(tempfile.gettempdir())
            path = pathlib.Path(base) / f"flight_{os.getpid()}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        doc = {
            "pid": os.getpid(),
            "wall_t0": self.wall_t0,
            "dumped_at": time.time(),
            "reasons": reasons,
            "events": self.events(),
        }
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(doc))
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------
# process singleton
# ---------------------------------------------------------------------
_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process flight recorder. Cache-safe: configure() mutates in
    place."""
    return _RECORDER


def record(kind: str, **fields: Any) -> None:
    """Module-level shorthand — the one-liner every call site uses."""
    _RECORDER.record(kind, **fields)


def dump(reason: str,
         path: str | pathlib.Path | None = None) -> pathlib.Path | None:
    return _RECORDER.dump(reason, path=path)


def configure(enabled: bool | None = None,
              dump_dir: str | pathlib.Path | None = None,
              ring_max: int | None = None) -> FlightRecorder:
    return _RECORDER.configure(enabled=enabled, dump_dir=dump_dir,
                               ring_max=ring_max)
