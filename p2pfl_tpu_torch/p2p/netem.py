"""Seeded link shaping and partition windows for the socket plane.

The counterpart of ``p2pfl_tpu/p2p/netem.py`` (the stand-in for the
reference's ``tcset --rate/--delay/--loss``): for one seed and one
sequence of messages the port drops the same messages and schedules the
same windows as the JAX package. Per (source -> destination) link:

- delay and jitter: a message is due at ``now + delay + U(0, jitter)``,
  never before the link's previous message (one FIFO worker a link: the
  link never reorders, as TCP does not);
- loss: the message is dropped before the socket write;
- rate: the message's transmission time (payload bytes / rate) is added
  to the link's occupancy;
- backpressure: a link's queue is bounded, so a sender that outruns the
  link blocks on ``send``;
- partitions (``config.schema.PartitionSpec``): while a window is open
  every message across its cut is dropped. The windows, their seeded
  jitter included, are drawn from ``(seed, "partition", k)``, the same
  on every node, so the whole federation severs and heals one cut.

The drops and delays come from one ``random.Random`` a source node,
seeded from ``(seed, "netem", src)``. The flight events of the edges
(``netem.partition``, ``netem.heal``) are A23 and are not recorded; the
``on_transition`` callback runs.
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable

from p2pfl_tpu_torch.p2p.protocol import Message, write_message


class LinkShaper:
    """Per-source shaping of outbound messages (delay/jitter/loss)."""

    #: bounded link queue — the "TCP send buffer". A sender that
    #: outpaces the link blocks on send() when this fills.
    QUEUE_DEPTH = 32

    def __init__(
        self,
        src: int,
        delay_ms: float = 0.0,
        jitter_ms: float = 0.0,
        loss_pct: float = 0.0,
        rate_mbps: float = 0.0,
        seed: int = 0,
        on_error: Callable[[object], None] | None = None,
        partitions=(),
        on_transition: Callable[[str, list], None] | None = None,
        on_sent: Callable[[object, Message], None] | None = None,
    ):
        self.src = src
        self.delay_s = max(delay_ms, 0.0) / 1000.0
        self.jitter_s = max(jitter_ms, 0.0) / 1000.0
        self.loss = min(max(loss_pct, 0.0), 100.0) / 100.0
        self.rate_bps = max(rate_mbps, 0.0) * 1e6 / 8.0  # bytes/s
        self._rng = random.Random((seed, "netem", src).__repr__())
        self._on_error = on_error
        # partition plan: (start, end, groups, node -> group index).
        # Boundary jitter is seeded per WINDOW, not per source — the
        # whole federation must agree on when the cut exists
        self._windows: list[tuple[float, float, list, dict[int, int]]] = []
        for k, spec in enumerate(partitions or ()):
            wrng = random.Random((seed, "partition", k).__repr__())
            j = float(getattr(spec, "jitter_s", 0.0))
            start = max(spec.start_s + wrng.uniform(-j, j), 0.0)
            end = max(start + spec.duration_s + wrng.uniform(-j, j), start)
            group_of = {int(n): gi for gi, g in enumerate(spec.groups)
                        for n in g}
            self._windows.append((start, end, spec.groups, group_of))
        self._part_active: set[int] = set()
        self._epoch: float | None = None
        self._on_transition = on_transition
        # the node's byte counters, told of every frame a worker writes
        self._on_sent = on_sent
        # per-destination FIFO: (peer, msg, due) consumed by one worker
        self._queues: dict[int, asyncio.Queue] = {}
        self._workers: dict[int, asyncio.Task] = {}
        self._busy_until: dict[int, float] = {}
        self._last_due: dict[int, float] = {}
        self.sent = 0
        self.dropped = 0
        self.part_dropped = 0

    @property
    def active(self) -> bool:
        return (self.delay_s > 0 or self.jitter_s > 0 or self.loss > 0
                or self.rate_bps > 0 or bool(self._windows))

    # -- partition plan ----------------------------------------------------
    def start_clock(self) -> None:
        """Pin plan time 0 to now (idempotent). Called from node start
        so every node's windows are measured from federation start;
        otherwise the epoch pins lazily at the first send."""
        if self._epoch is None:
            self._epoch = asyncio.get_event_loop().time()

    def _plan_time(self, now: float) -> float:
        if self._epoch is None:
            self._epoch = now
        return now - self._epoch

    def severed(self, dst: int, t: float) -> bool:
        """True when plan time ``t`` falls inside a window whose cut
        separates this source from ``dst``. Nodes outside every group
        of a window are unaffected by it."""
        for start, end, _groups, group_of in self._windows:
            if start <= t < end:
                gs, gd = group_of.get(self.src), group_of.get(int(dst))
                if gs is not None and gd is not None and gs != gd:
                    return True
        return False

    def severed_now(self, dst: int) -> bool:
        """``severed`` against the live plan clock — the node's probe
        machinery asks this before trusting a TCP dial across the cut."""
        if not self._windows:
            return False
        return self.severed(dst,
                            self._plan_time(asyncio.get_event_loop().time()))

    def _note_transitions(self, t: float) -> None:
        """Report sever/heal edges (the callback) as plan time
        crosses window boundaries. Piggybacked on send(), so detection
        latency is one outbound message — at most a heartbeat period."""
        now_active = {k for k, (s, e, _g, _m) in enumerate(self._windows)
                      if s <= t < e}
        for k in sorted(now_active - self._part_active):
            groups = self._windows[k][2]
            if self._on_transition is not None:
                self._on_transition("partition", groups)
        for k in sorted(self._part_active - now_active):
            groups = self._windows[k][2]
            if self._on_transition is not None:
                self._on_transition("heal", groups)
        self._part_active = now_active

    def _size(self, msg: Message) -> int:
        return len(msg.payload or b"") + 256  # header/body estimate

    async def send(self, peer, msg: Message) -> None:
        """Queue ``msg`` for ``peer`` under the link schedule. Blocks
        only when the link's bounded queue is full (backpressure);
        delivery happens on the link worker."""
        loop = asyncio.get_event_loop()
        if self._windows:
            t = self._plan_time(loop.time())
            self._note_transitions(t)
            if self.severed(peer.idx, t):
                self.part_dropped += 1
                return
        if self.loss and self._rng.random() < self.loss:
            self.dropped += 1
            return
        now = loop.time()
        # link occupancy: serialization time at the configured rate,
        # FIFO behind whatever is already scheduled on this link
        start = max(now, self._busy_until.get(peer.idx, 0.0))
        tx = self._size(msg) / self.rate_bps if self.rate_bps else 0.0
        self._busy_until[peer.idx] = start + tx
        # one-way latency on top of serialization
        due = start + tx + self.delay_s
        if self.jitter_s:
            due += self._rng.uniform(0.0, self.jitter_s)
        # jitter must not reorder the link (TCP semantics)
        due = max(due, self._last_due.get(peer.idx, 0.0))
        self._last_due[peer.idx] = due
        q = self._queues.get(peer.idx)
        if q is None:
            q = self._queues[peer.idx] = asyncio.Queue(self.QUEUE_DEPTH)
            self._workers[peer.idx] = asyncio.create_task(self._drain(q))
        await q.put((peer, msg, due))

    async def _drain(self, q: asyncio.Queue) -> None:
        loop = asyncio.get_event_loop()
        while True:
            peer, msg, due = await q.get()
            wait = due - loop.time()
            if wait > 0:
                await asyncio.sleep(wait)
            try:
                if peer.writer.is_closing():
                    # asyncio's writelines does not check for a lost
                    # connection itself (it raises another error there)
                    raise ConnectionError("the link's connection is closed")
                await write_message(peer.writer, msg)
                self.sent += 1
                if self._on_sent is not None:
                    self._on_sent(peer, msg)
            except (ConnectionError, RuntimeError, OSError):
                if self._on_error is not None:
                    self._on_error(peer)

    def close(self) -> None:
        for t in self._workers.values():
            t.cancel()
        self._workers.clear()
        self._queues.clear()


def shaper_from_config(src: int, net, on_error=None, on_transition=None,
                       on_sent=None) -> LinkShaper | None:
    """Build a shaper from a ``NetworkConfig`` (None or all-zero →
    no shaping, zero-overhead direct writes). A partition plan alone
    activates the shaper even with all rate/delay/loss knobs at zero."""
    if net is None:
        return None
    s = LinkShaper(
        src,
        delay_ms=net.delay_ms,
        jitter_ms=net.jitter_ms,
        loss_pct=net.loss_pct,
        rate_mbps=getattr(net, "rate_mbps", 0.0),
        seed=net.seed,
        on_error=on_error,
        partitions=getattr(net, "partitions", ()),
        on_transition=on_transition,
        on_sent=on_sent,
    )
    return s if s.active else None
