"""Near-zero-overhead span/event tracer for federation hot paths.

The counterpart of ``p2pfl_tpu/obs/trace.py``, with its span, counter and
file formats, so either package's tools read the other's traces and one
``P2PFL_TRACE`` setting drives a mixed fleet. Design constraints (in
priority order):

1. **Disabled means free.** The socket plane's loop handles up to
   ~450k frames a round; instrumentation that allocated per frame while
   off would show up in the very numbers it exists to explain. Every hot
   call site gates on one attribute read (``tracer.enabled``); ``span()``
   while disabled returns one shared ``NULL_SPAN`` singleton (no
   allocation), and ``count()`` returns before touching any state.
2. **Enabled means cheap.** A closed span is one tuple appended to a
   bounded ``collections.deque``, an atomic operation under CPython, so
   the event loop and the executor threads (a ``TorchLearner`` fit runs
   in one) record into the same ring without a lock on the span path.
   Counters take a small lock; they fire at per-message rate only when
   tracing is on.
3. **Mergeable across processes.** Each tracer records a wall-clock /
   perf_counter anchor pair at reset; exported span timestamps are
   perf_counter-relative (monotonic, immune to NTP steps mid-run) and
   the anchor lets ``p2pfl_tpu_torch.obs.traceview`` shift every process
   onto one wall-clock timeline.

The process tracer is a singleton that is **configured in place**
(never replaced): call sites may cache the reference, so ``configure()``
mutates the one object everyone holds.

Enablement comes from ``P2PFL_TRACE``: unset/``0`` = off, ``1`` = on
(the launcher decides the export dir), any other value = on with that
value as the export directory.

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}``
object form), loadable in ``chrome://tracing`` / Perfetto directly, or
merged first via ``python -m p2pfl_tpu_torch.obs.traceview``.

The JAX package also counts XLA backend compiles here (a listener on
``jax.monitoring``). Eager PyTorch compiles no round program, so the
port has no listener: :func:`xla_recompiles` reads 0, the status
records' ``recompiles`` is 0, and no tracer counter is kept under the
JAX package's ``xla/backend_compiles`` key, so ``perf_report``'s
``recompile_total`` and the ``recompile-storm`` health rule read 0 on a
port-written trace. No PyTorch counter stands in under that name.
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import threading
import time
from collections import deque
from typing import Any

from p2pfl_tpu_torch.obs.records import make_record

ENV_VAR = "P2PFL_TRACE"
_RING_MAX = 1 << 16  # spans kept per process; oldest evicted first


class _NullSpan:
    """The disabled-path span: one shared, stateless instance. Usable
    as a context manager; records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span. Closing appends (name, lane, t0, dur, args) to
    the owning tracer's ring — a single deque.append, no lock."""

    __slots__ = ("_tracer", "name", "lane", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, lane: str | None,
                 args: dict | None):
        self._tracer = tracer
        self.name = name
        self.lane = lane
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._events.append(
            (self.name, self.lane, self.t0,
             time.perf_counter() - self.t0, self.args)
        )
        return False


class Tracer:
    """Span ring + counters + high-water gauges for one process.

    ``lane`` names a timeline row in the merged view — nodes sharing a
    process (k-nodes-per-proc launch layouts) each trace into their own
    lane (``node<idx>``) of the same tracer.
    """

    def __init__(self, ring_max: int = _RING_MAX):
        self.enabled = False
        self.export_dir: pathlib.Path | None = None
        self._ring_max = ring_max
        self._lock = threading.Lock()
        self._reset_locked()

    # -- configuration --------------------------------------------------
    def _reset_locked(self) -> None:
        self._events: deque = deque(maxlen=self._ring_max)
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        # wall/perf anchor pair: spans are perf_counter-relative; the
        # anchor maps them back onto the wall clock for cross-process
        # merging (traceview shifts by wall_t0 deltas)
        self.wall_t0 = time.time()
        self.perf_t0 = time.perf_counter()
        # per-process trace identity: span ids minted by next_span_id()
        # are prefixed with this, so they stay unique in a merged
        # multi-process trace and a wire-propagated parent id resolves
        # without pid coordination
        self.trace_id = os.urandom(4).hex()
        self._span_ids = itertools.count(1)

    def configure(self, enabled: bool | None = None,
                  export_dir: str | pathlib.Path | None = None,
                  ring_max: int | None = None) -> "Tracer":
        """Mutate IN PLACE (call sites cache the singleton)."""
        with self._lock:
            if ring_max is not None and ring_max != self._ring_max:
                self._ring_max = ring_max
                self._events = deque(self._events, maxlen=ring_max)
            if export_dir is not None:
                self.export_dir = pathlib.Path(export_dir)
            if enabled is not None:
                self.enabled = bool(enabled)
        return self

    def reset(self) -> None:
        """Drop all recorded state and re-anchor the clocks."""
        with self._lock:
            self._reset_locked()

    # -- recording ------------------------------------------------------
    def span(self, name: str, lane: str | None = None,
             args: dict | None = None):
        """Context manager timing one operation. Disabled: returns the
        shared NULL_SPAN — no allocation. Hot per-frame sites should
        additionally gate on ``tracer.enabled`` so even the call's
        argument construction is skipped."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, lane, args)

    def next_span_id(self) -> str:
        """Mint a globally-unique span id (``<trace_id>.<n>``) for a
        span whose identity must cross the wire (the ``tc`` header).
        Only meaningful while enabled: callers gate on ``enabled``
        first, so the disabled path never reaches the allocation.
        ``itertools.count`` is GIL-atomic, no lock."""
        return f"{self.trace_id}.{next(self._span_ids)}"

    def count(self, key: str, n: float = 1) -> None:
        """Accumulate a counter (message and byte totals)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def high_water(self, key: str, value: float) -> None:
        """Record a max-seen gauge (egress-lane queue depths)."""
        if not self.enabled:
            return
        with self._lock:
            if value > self._gauges.get(key, float("-inf")):
                self._gauges[key] = value

    # -- reading --------------------------------------------------------
    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def spans(self) -> list[tuple]:
        """Snapshot of the ring: (name, lane, t0, dur_s, args) tuples."""
        return list(self._events)

    def summarize(self) -> dict[str, Any]:
        """Per-span-name totals + counters + gauges, in the shared
        record shape (obs.records.make_record)."""
        agg: dict[str, list[float]] = {}
        for name, _lane, _t0, dur, _args in list(self._events):
            agg.setdefault(name, [0, 0.0, 0.0])
            s = agg[name]
            s[0] += 1
            s[1] += dur
            s[2] = max(s[2], dur)
        return make_record(
            None,
            spans={
                k: {"count": int(c), "total_s": round(t, 6),
                    "max_s": round(m, 6)}
                for k, (c, t, m) in sorted(agg.items())
            },
            counters=self.counters(),
            gauges=self.gauges(),
        )

    # -- export ---------------------------------------------------------
    def chrome_events(self, pid: int | None = None,
                      process_name: str | None = None) -> list[dict]:
        """The ring + counters as Chrome trace-event dicts. Span
        timestamps are µs relative to this tracer's perf anchor; lanes
        map to small tids with thread_name metadata."""
        pid = os.getpid() if pid is None else pid
        lanes: dict[str | None, int] = {None: 0}
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name or f"p2pfl[{pid}]"},
        }]
        out: list[dict] = []
        last_ts = 0.0
        for name, lane, t0, dur, args in list(self._events):
            if lane not in lanes:
                lanes[lane] = len(lanes)
            ts = (t0 - self.perf_t0) * 1e6
            last_ts = max(last_ts, ts + dur * 1e6)
            ev = {"name": name, "ph": "X", "pid": pid,
                  "tid": lanes[lane], "ts": ts, "dur": dur * 1e6}
            if args:
                ev["args"] = args
                # cross-process causal edges render as Perfetto flow
                # arrows: a span that minted a wire-propagated id is a
                # flow source; one recorded with a parent id is a sink
                sid = args.get("sid")
                if sid is not None:
                    out.append({"name": "tc", "cat": "tc", "ph": "s",
                                "id": sid, "pid": pid,
                                "tid": lanes[lane], "ts": ts})
                parent = args.get("parent")
                if parent is not None:
                    out.append({"name": "tc", "cat": "tc", "ph": "f",
                                "bp": "e", "id": parent, "pid": pid,
                                "tid": lanes[lane], "ts": ts})
            out.append(ev)
        for lane, tid in lanes.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": lane or "main"},
            })
        events.extend(out)
        for key, val in sorted(self.counters().items()):
            events.append({
                "name": key, "ph": "C", "pid": pid, "tid": 0,
                "ts": last_ts, "args": {"value": val},
            })
        return events

    def export(self, path: str | pathlib.Path | None = None,
               process_name: str | None = None) -> pathlib.Path | None:
        """Write this process's trace file. Default target is
        ``<export_dir>/proc<pid>.trace.json``; returns None when no
        path is known (tracer enabled ad hoc without a directory)."""
        if path is None:
            if self.export_dir is None:
                return None
            path = self.export_dir / f"proc{os.getpid()}.trace.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        doc = {
            "traceEvents": self.chrome_events(process_name=process_name),
            "displayTimeUnit": "ms",
            "metadata": {
                "wall_t0": self.wall_t0,
                "perf_t0": self.perf_t0,
                "pid": os.getpid(),
                "counters": self.counters(),
                "gauges": self.gauges(),
            },
        }
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(doc))
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------
# process singleton
# ---------------------------------------------------------------------
_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process tracer. Cache-safe: configure() mutates in place."""
    return _TRACER


def configure(enabled: bool | None = None,
              export_dir: str | pathlib.Path | None = None,
              ring_max: int | None = None) -> Tracer:
    return _TRACER.configure(enabled=enabled, export_dir=export_dir,
                             ring_max=ring_max)


def configure_from_env(
    default_dir: str | pathlib.Path | None = None,
    env: dict | None = None,
) -> Tracer:
    """Apply the ``P2PFL_TRACE`` convention: unset/empty/``0`` →
    disabled; ``1`` → enabled, exporting to ``default_dir`` (the
    launcher wires it next to the status dir); any other value →
    enabled, exporting to that path."""
    raw = (env if env is not None else os.environ).get(ENV_VAR, "")
    if raw in ("", "0"):
        return _TRACER.configure(enabled=False)
    if raw == "1":
        return _TRACER.configure(enabled=True, export_dir=default_dir)
    return _TRACER.configure(enabled=True, export_dir=raw)


# ---------------------------------------------------------------------
# the JAX package's XLA recompile counter: nothing compiles here
# ---------------------------------------------------------------------
def install_xla_listener() -> bool:
    """False: there is no compile event to listen to (the JAX package
    returns False too where ``jax.monitoring`` is missing, and callers
    treat the counter as absent)."""
    return False


def xla_recompiles() -> int:
    """Backend compiles since the last reset: always 0 (eager PyTorch
    compiles no round program; see the module docstring)."""
    return 0


def xla_compile_seconds() -> float:
    return 0.0


def reset_xla_counters() -> None:
    """Nothing to zero; kept so callers of either package read alike."""
