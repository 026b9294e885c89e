"""The aggregation sidecar: payload decode and FedAvg in another process.

The counterpart of ``p2pfl_tpu/p2p/aggd.py``. A node's event loop
receives, decodes and sums every PARAMS payload on the inline plane.
With the sidecar, one worker process a host owns a
``multiprocessing.shared_memory`` arena of payload slots: the protocol
reader lands a payload's bytes straight in a leased slot
(``protocol.read_message``'s ``slot_sink``), the loop forwards a small
descriptor, and the worker decodes and fuses the entries
(``session.fuse_numpy``, the inline plane's own function) and writes the
fused envelope into a result slot.

The worker is started in a spawn context (never a fork of a process
that holds a CUDA context or a running loop). It imports numpy and the
port's envelope code and hides the card from itself before anything can
touch it, so it never opens a CUDA context.

Lifetime: the client creates the arena under a ``p2pfl_torch_aggd_``
name (not the JAX package's ``p2pfl_aggd_``, so an audit of one
package's residue never sees the other's), the worker attaches by name,
and the moment it confirms, the client unlinks the name while both keep
their mappings: the kernel frees the memory with the last mapping, so
even a killed process leaves nothing in ``/dev/shm``. Both unlink again
at exit for the window before the handshake.

Slots are accounted in the client alone (the loop and the reply
thread, one lock). A fuse whose reply never comes (a killed worker)
falls back to an in-process fuse of the same entries, and is counted in
``fallbacks``; an error reply is kept in ``errors``. The flight events
(``aggd.spawn``, ``aggd.error``, ``aggd.close``, the session's
``aggd.fallback``) and the trace counter are A23.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import itertools
import multiprocessing
import os
import secrets
import threading
from contextlib import suppress
from multiprocessing import shared_memory
from typing import Any


#: arena names carry this prefix, so a test (or an operator) can audit
#: /dev/shm for this package's residue alone
SHM_PREFIX = "p2pfl_torch_aggd_"
#: slot-size floor — the arena is sized lazily from the first leased
#: payload, and a tiny first frame must not wedge later full models
_MIN_SLOT_BYTES = 1 << 16
#: worker-side queue poll period; each timeout re-checks for orphaning
_WORKER_POLL_S = 5.0


@dataclasses.dataclass(frozen=True)
class SlotEntry:
    """Marker a SidecarSession stores in place of a decoded tree: the
    payload lives undecoded in the shared arena at ``slot``."""

    slot: int
    length: int


def _sidecar_main(shm_name: str, n_slots: int, slot_bytes: int,
                  desc_q, done_q) -> None:
    """The worker's entry (a spawn context: no state of the parent's
    loop or device). Attaches to the client's arena, confirms (the
    client then unlinks its name), then serves fuse requests until a
    stop, the queue's end, or the parent's death."""
    # the card stays invisible to this process: CUDA initializes lazily,
    # and nothing here asks for it
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from p2pfl_tpu_torch.core.serialize import (
        decode_parameters,
        encode_parameters,
    )
    from p2pfl_tpu_torch.p2p.session import fuse_numpy

    parent = os.getppid()
    try:
        shm = shared_memory.SharedMemory(name=shm_name)
    except FileNotFoundError:
        return  # client died before we attached; nothing to serve
    done_q.put(("attached",))

    def view(slot: int, length: int) -> memoryview:
        off = slot * slot_bytes
        return shm.buf[off: off + length]

    try:
        while True:
            try:
                item = desc_q.get(timeout=_WORKER_POLL_S)
            except Exception:  # Empty on timeout; EOF/OSError on close
                if os.getppid() != parent:
                    break  # orphaned: client is gone, exit
                continue
            if item is None or item[0] == "stop":
                break
            if item[0] != "fuse":
                continue
            _, req_id, entries, result_slot = item
            try:
                bytes_in = 0
                if len(entries) == 1 and entries[0][0] == "s":
                    # single-entry short-circuit mirrors _aggregate's
                    # n==1 return-as-is: the envelope IS the result
                    _, slot, length, _w = entries[0]
                    view(result_slot, length)[:] = view(slot, length)
                    done_q.put(("done", req_id, length,
                                {"entries": 1, "bytes_in": length}))
                    continue
                trees, weights = [], []
                for e in entries:
                    if e[0] == "s":
                        _, slot, length, w = e
                        blob: Any = view(slot, length)
                    else:
                        _, blob, w = e
                    bytes_in += len(blob)
                    trees.append(decode_parameters(blob).params)
                    weights.append(float(w))
                fused, total = fuse_numpy(trees, weights)
                out = encode_parameters(fused, (), max(1, int(total)))
                if len(out) > slot_bytes:
                    raise ValueError(
                        f"fused blob {len(out)} B > slot {slot_bytes} B")
                view(result_slot, len(out))[:] = out
                done_q.put(("done", req_id, len(out),
                            {"entries": len(entries), "bytes_in": bytes_in}))
            except Exception as e:  # reply, never die — the client
                # treats a missing reply as a crash and falls back
                done_q.put(("err", req_id, f"{type(e).__name__}: {e}"[:300]))
    finally:
        with suppress(BufferError):
            shm.close()
        with suppress(FileNotFoundError):
            shm.unlink()  # no-op normally: client unlinked on attach


class SidecarClient:
    """Per-host handle to one aggd worker + its shared-memory arena.

    One client serves every node packed into the host process; slots
    are leased/released on the event-loop thread and reclaimed from the
    done-queue drain thread, so all free-list state sits behind one
    lock. The arena is sized lazily from the first lease (2x the first
    payload, floored) — callers must treat a ``None`` lease as "stay on
    the inline path" (arena exhausted, payload oversized, or /dev/shm
    unavailable), never as an error.
    """

    def __init__(self, n_slots: int = 16):
        self.n_slots = max(2, int(n_slots))
        self.slot_bytes = 0
        self._shm: shared_memory.SharedMemory | None = None
        self._proc = None
        self._desc_q = None
        self._done_q = None
        self._drain: threading.Thread | None = None
        self._lock = threading.Lock()
        self._free: list[int] = []
        self._leased: set[int] = set()
        # req_id -> (loop, event, reply box) for in-flight fuses, and
        # req_id -> result slot so an abandoned (timed-out) request's
        # slot is reclaimed only once the worker stops writing to it
        self._waiters: dict[int, tuple] = {}
        self._pending_result: dict[int, int] = {}
        self._req_ids = itertools.count(1)
        self._closed = False
        self._unlinked = False
        #: the arena's name (kept after close, for residue audits)
        self.name: str | None = None
        #: payload bytes landed into leased slots (event-loop bypass)
        self.bytes_ingested = 0
        #: slots returned to the free list over the client's lifetime
        self.slot_releases = 0
        #: fuses answered by the worker / fallen back to in-process
        self.fused_rounds = 0
        self.fallbacks = 0
        #: the worker's error replies (each fell back in process)
        self.errors: list[str] = []

    # -- lifecycle ------------------------------------------------------
    def _ensure(self, nbytes: int) -> bool:
        if self._closed:
            return False
        if self._shm is not None:
            return True
        self.slot_bytes = max(_MIN_SLOT_BYTES, 2 * int(nbytes))
        name = self.name = SHM_PREFIX + secrets.token_hex(6)
        try:
            self._shm = shared_memory.SharedMemory(
                name=name, create=True,
                size=self.n_slots * self.slot_bytes)
        except OSError:
            self._closed = True  # no /dev/shm: permanent inline path
            return False
        self._free = list(range(self.n_slots - 1, -1, -1))
        ctx = multiprocessing.get_context("spawn")
        self._desc_q = ctx.Queue()
        self._done_q = ctx.Queue()
        proc = ctx.Process(
            target=_sidecar_main,
            args=(name, self.n_slots, self.slot_bytes,
                  self._desc_q, self._done_q),
            daemon=True, name="p2pfl-aggd")
        try:
            proc.start()
        except BaseException:
            # no worker will ever attach: the arena goes at once
            self._closed = True
            self._unlink()
            self._shm.close()
            self._shm = None
            raise
        self._proc = proc
        self._drain = threading.Thread(
            target=self._drain_loop, daemon=True, name="aggd-drain")
        self._drain.start()
        return True

    def alive(self) -> bool:
        return (not self._closed and self._proc is not None
                and self._proc.is_alive())

    def queue_depth(self) -> int:
        """Outstanding descriptor-queue entries (health plane)."""
        if self._desc_q is None:
            return 0
        with suppress(NotImplementedError, OSError):
            return int(self._desc_q.qsize())
        return 0

    def close(self) -> None:
        """Stop the worker, reap the drain thread, drop the mapping.
        Idempotent; safe even if the worker was already killed. The
        arena name was unlinked at attach time, so this only closes
        our mapping — the kernel frees the memory with the last map."""
        self._closed = True
        if self._desc_q is not None:
            with suppress(Exception):
                self._desc_q.put(("stop",))
        if self._proc is not None:
            self._proc.join(timeout=3.0)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=3.0)
        if self._done_q is not None:
            with suppress(Exception):
                self._done_q.put(None)  # wake + retire the drain thread
        if self._drain is not None:
            self._drain.join(timeout=3.0)
            self._drain = None
        if self._shm is not None:
            self._unlink()
            # dangling slot views (exported memoryview slices a caller
            # dropped without releasing) keep the mmap pinned; collect
            # them now so neither close() nor the eventual __del__
            # trips BufferError on exported pointers
            gc.collect()
            with suppress(BufferError):
                self._shm.close()
            self._shm = None

    def _unlink(self) -> None:
        if not self._unlinked and self._shm is not None:
            self._unlinked = True
            with suppress(FileNotFoundError):
                self._shm.unlink()

    # -- slots ----------------------------------------------------------
    def lease(self, nbytes: int):
        """Lease one slot for an ``nbytes`` payload. Returns
        ``(slot, memoryview)`` sized to the payload, or None when the
        caller must stay inline (no arena, exhausted, or oversized)."""
        if nbytes <= 0 or not self._ensure(nbytes):
            return None
        if nbytes > self.slot_bytes:
            return None
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._leased.add(slot)
        self.bytes_ingested += int(nbytes)
        return slot, self.view(slot, nbytes)

    def view(self, slot: int, length: int) -> memoryview:
        off = slot * self.slot_bytes
        return self._shm.buf[off: off + length]

    def release(self, slot: int) -> None:
        """Return a slot to the free list. No-op for slots not
        currently leased, so teardown paths can release defensively."""
        with self._lock:
            if slot not in self._leased:
                return
            self._leased.discard(slot)
            self._free.append(slot)
        self.slot_releases += 1

    # -- fuse -----------------------------------------------------------
    async def fuse(self, entries, timeout_s: float = 60.0):
        """Ship one fuse request: ``entries`` is a list of
        ``("s", slot, length, weight)`` / ``("b", blob, weight)``
        tuples (weights are the session's EFFECTIVE weights — staleness
        and reputation already folded in). Returns
        ``(result_slot, length, stats)`` — the caller decodes the
        result slot and releases it — or None, meaning fall back to
        in-process aggregation (worker dead/stalled/errored)."""
        if self._closed or self._shm is None or not self.alive():
            return None
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._leased.add(slot)
        req_id = next(self._req_ids)
        loop = asyncio.get_running_loop()
        ev = asyncio.Event()
        box: list = []
        with self._lock:
            self._waiters[req_id] = (loop, ev, box)
            self._pending_result[req_id] = slot
        try:
            self._desc_q.put(("fuse", req_id, list(entries), slot))
        except Exception:
            with self._lock:
                self._waiters.pop(req_id, None)
                self._pending_result.pop(req_id, None)
            self.release(slot)
            return None
        deadline = loop.time() + max(1.0, float(timeout_s))
        while True:
            with suppress(asyncio.TimeoutError):
                await asyncio.wait_for(ev.wait(), timeout=0.25)
            if ev.is_set():
                break
            if loop.time() > deadline or not self.alive():
                worker_dead = not self.alive()
                with self._lock:
                    self._waiters.pop(req_id, None)
                    if worker_dead:
                        # nobody will ever write the result slot again
                        self._pending_result.pop(req_id, None)
                    # else: leave it pending — the drain thread
                    # reclaims the slot when the late reply lands
                if worker_dead:
                    self.release(slot)
                return None
        with self._lock:
            self._pending_result.pop(req_id, None)
        item = box[0]
        if item[0] == "err":
            self.errors.append(item[2])
            self.release(slot)
            return None
        _, _, length, stats = item
        self.fused_rounds += 1
        return slot, int(length), stats

    def _drain_loop(self) -> None:
        """Done-queue pump (plain thread, not a task: the reply arrives
        from another process and must not depend on loop liveness).
        Resolves fuse waiters via call_soon_threadsafe."""
        while True:
            try:
                item = self._done_q.get()
            except Exception:
                break
            if item is None:
                break
            if item[0] == "attached":
                # both mappings exist from here on: unlink the name so
                # /dev/shm is clean even under SIGKILL
                self._unlink()
                continue
            req_id = item[1]
            with self._lock:
                waiter = self._waiters.pop(req_id, None)
                abandoned = (self._pending_result.pop(req_id, None)
                             if waiter is None else None)
            if waiter is None:
                # timed-out request: the worker is done writing, so its
                # result slot is finally safe to reuse
                if abandoned is not None:
                    self.release(abandoned)
                continue
            loop, ev, box = waiter
            box.append(item)
            with suppress(RuntimeError):  # loop closed at teardown
                loop.call_soon_threadsafe(ev.set)
