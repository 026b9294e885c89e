"""P2PNode: a federated node over TCP, on one asyncio event loop.

The counterpart of ``p2pfl_tpu/p2p/node.py``, on the same wire (P2W2
frames, P2TP envelopes), so a fleet may mix the two packages' nodes:

- the listener, ``connect_to`` and the CONNECT hello, which carries the
  dial-back port and the wire precisions this node decodes ("wd"): a
  PARAMS send ships bf16 or int8 only when every target advertised it,
  else f32;
- heartbeats (BEAT, a ROLE refresh every second beat) into the port's
  ``federation/membership.py`` on the wall clock, reconnect probes of
  suspects under backoff, and eviction when they fail;
- gossip floods deduped by message id, with the periodic floods' relay
  damped on a declared full mesh; STOP evicts its sender everywhere;
- the round: the train-set vote, initial diffusion from the starter,
  then per role (aggregator, server, trainer, proxy, idle) train,
  aggregate and gossip partial aggregates until the train set is
  covered, or adopt the aggregate, then the MODELS_READY barrier; DFL,
  CFL and SDFL with the leadership token's transfer; int8's error
  feedback on the node's own update; the final METRICS flood.

The transport and privacy layers, each off unless asked for:

- ``tls`` (``p2p/tls.py``): mutual TLS on the listener and every dial,
  the hello's index bound to the connection's certificate, every frame
  this node originates signed and every frame received verified against
  its origin (a forged or unverifiable frame is neither handled nor
  relayed, nor marked seen);
- ``netem`` (a ``NetworkConfig``, ``p2p/netem.py``): every send goes
  through the link shaper (delay, jitter, loss, rate, partition windows,
  whose edges reach membership as partition and heal faults);
  ``apply_partition`` / ``heal_partition`` cut and heal links by hand;
- ``sidecar`` (``p2p/aggd.py``): PARAMS payloads land in the sidecar's
  shared-memory arena and the session (``SidecarSession``) has the
  worker fuse them, so the round path decodes no payload on the loop
  (``loop_payload_touch_bytes`` stays 0);
- ``masker`` (``privacy/secagg.py``): this node's update is quantized
  and pairwise-masked before it enters its session or the wire, and an
  evicted member's pair seed is revealed (SECAGG_SHARE) so the quorum
  can unmask without it.

The adversarial and elastic layers, each off unless asked for:

- ``attack`` (an ``AttackSpec``) and ``dp`` (a ``DPSpec``): this node's
  trained update is poisoned, then privatized, once, on its device,
  against the round's starting params and keyed by (seed, node, round),
  so it has the bits of the stacked plane's row for this node
  (``poison_stacked``, ``privatize_stacked``); the transformed params
  back both the node's own session entry and every send;
- ``reputation`` (a ``ReputationMonitor``, one a node): the session
  scores its entries at finish and weighs them by trust;
- ``elastic.async_aggregation``: the session closes at its quorum, the
  gossip and the round barrier stop at that quorum too, and an update
  for an earlier round folds into the current session with its weight
  discounted by its staleness (``self.round - msg_round``), on the
  inline and the sidecar plane alike;
- ``crash()``: an abrupt teardown without STOP, found by the peers'
  heartbeat silence and probes;
- ``joiner``: the CONNECT hello declares a live join ("jr"); an
  established node answers with STATE_SYNC (the model in the checkpoint
  blob's format, the round and the run's parameters, also after its run
  ended), and the joiner adopts it and fast-forwards, never rewinding
  (a STATE_SYNC landing while the joiner votes ends that round at once;
  one landing later waits for the round's boundary);
- ``checkpoint_dir`` / ``checkpoint_every``: the node's params and round
  saved atomically every ``checkpoint_every`` rounds; ``resume`` adopts
  that file before any peer contact, and the first STATE_SYNC decides
  once whether the peer's newer round wins.

Fit and evaluate run in the loop's executor, so heartbeats keep flowing
while a node trains; a fit or an evaluation that raises fails the node
(``error`` set, ``finished`` set) and the launcher raises. Trace spans
and flight events are A23 and are left out.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import logging
import math
import random
import secrets
import time
from typing import Any

import numpy as np

from p2pfl_tpu_torch.adversary.attacks import poison_update
from p2pfl_tpu_torch.config.schema import (
    ElasticConfig,
    FaultEvent,
    ProtocolConfig,
)
from p2pfl_tpu_torch.core.aggregators import Aggregator
from p2pfl_tpu_torch.core.serialize import (
    WIRE_DTYPES,
    as_f32,
    decode_parameters,
    dequantize_int8,
    encode_parameters,
    quantize_int8,
    to_host,
    tree_leaves_sorted,
    tree_unflatten_sorted,
)
from p2pfl_tpu_torch.federation.checkpoint import (
    load_node_checkpoint,
    pack_model,
    save_node_checkpoint,
    unpack_model,
)
from p2pfl_tpu_torch.federation.membership import Membership
from p2pfl_tpu_torch.p2p.protocol import (
    GOSSIPED,
    PERIODIC_FLOODS,
    DedupRing,
    Message,
    MsgType,
    read_message,
    write_message,
)
from p2pfl_tpu_torch.p2p.netem import shaper_from_config
from p2pfl_tpu_torch.p2p.session import AggregationSession, SidecarSession
from p2pfl_tpu_torch.privacy.dp import privatize_update

log = logging.getLogger("p2pfl_tpu_torch.p2p")

#: transport-buffer ceiling of the idle-lane fast write (asyncio's
#: default 64 KiB high-water mark)
_FAST_LANE_MAX = 1 << 16



def _abort_unsent(writer: asyncio.StreamWriter) -> None:
    """Close a closing connection at once, dropping what it has not sent.
    With nothing unsent its close is under way or done (aborting a
    transport whose close already finished would fail)."""
    if writer.transport.get_write_buffer_size():
        writer.transport.abort()


@dataclasses.dataclass
class PeerState:
    """One live connection: its writer, reader task, and the egress lane
    (a bounded send queue drained by one task, so frames never
    interleave and a slow peer backs up only its own lane). Frames
    written on an idle lane gather in ``outbox`` and leave in one write
    at the end of the event loop's pass: a relay writes a frame to each
    of its peers, and a batch of frames read from one peer sends many to
    each, so this saves a system call a frame."""

    idx: int
    writer: asyncio.StreamWriter
    reader_task: asyncio.Task | None = None
    send_q: asyncio.Queue | None = None
    send_task: asyncio.Task | None = None
    draining: bool = False
    outbox: list = dataclasses.field(default_factory=list)
    outbox_bytes: int = 0
    flush_due: bool = False
    #: floods a read loop could not put on the full lane, in order; one
    #: task puts them as room comes (see ``P2PNode._write``)
    overflow: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    #: the peer's hello declared a live join ("jr"): its model comes in
    #: the STATE_SYNC answer, not in the catch-up's initial weights
    joiner: bool = False


@dataclasses.dataclass
class NodeProgress:
    """A node's round progress as this node knows it (the progress
    messages flood, so it is known for every member)."""

    models_aggregated: set[int] = dataclasses.field(default_factory=set)
    agg_round: int = -1
    initialized: bool = False
    ready_round: int = -1


class P2PNode:
    """One federated node. Wire up a learner, start, connect, learn."""

    def __init__(
        self,
        idx: int,
        learner,
        host: str = "127.0.0.1",
        port: int = 0,
        role: str = "aggregator",
        n_nodes: int = 2,
        aggregator: Aggregator | None = None,
        protocol: ProtocolConfig | None = None,
        gossip_period_s: float | None = None,
        federation: str = "DFL",
        seed: int = 0,
        tls=None,
        netem=None,
        full_mesh: bool = False,
        attack=None,
        reputation=None,
        wire_dtype: str = "f32",
        elastic: ElasticConfig | None = None,
        fit_slowdown: float = 1.0,
        local_epochs: int | None = None,
        joiner: bool = False,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        sidecar=None,
        dp=None,
        masker=None,
    ):
        el = elastic if elastic is not None else ElasticConfig()
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {wire_dtype!r}; have {WIRE_DTYPES}")
        if sidecar is not None and masker is not None:
            # the schema refuses it; a direct caller too: the sidecar
            # float-averages slot bytes, not the masks' modular sum
            raise ValueError(
                "secagg masking needs the inline session: the sidecar "
                "fuses raw slot bytes as floats, not the modular sum"
            )
        self.idx = idx
        self.learner = learner
        self.host = host
        self.port = port
        self.role = role
        self.n_nodes = n_nodes
        self.protocol = protocol or ProtocolConfig()
        self.gossip_period_s = (gossip_period_s if gossip_period_s is not None
                                else self.protocol.gossip_period_s)
        self.federation = federation
        # declared (never inferred) full mesh: the periodic floods'
        # relays are damped, the origin's broadcast reached everyone
        self.full_mesh = full_mesh
        self._rng = random.Random(seed * 7919 + idx)
        # mutual TLS: this node signs what it originates and verifies
        # every origin (``cryptography`` is imported here only)
        self.tls = tls
        self._signer = self._verifier = None
        if tls is not None:
            from p2pfl_tpu_torch.p2p.tls import MessageSigner, MessageVerifier

            self._signer = MessageSigner(tls)
            self._verifier = MessageVerifier(tls.ca_cert)
        # the link shaper (None unshaped: sends are direct writes)
        self.shaper = shaper_from_config(
            idx, netem, on_error=self._drop_conn,
            on_transition=self._on_netem_transition, on_sent=self._count_tx)
        # peers behind a cut applied by hand: frames to them are dropped
        # at the write (every node applies the same cut: symmetric)
        self._severed: set[int] = set()
        self.masker = masker
        #: the ``AttackSpec`` this node applies to its own update (None:
        #: honest), the ``DPSpec`` it privatizes it with, and its own
        #: ``ReputationMonitor``, shared with its session
        self.attack = attack
        self.dp = dp
        self.reputation = reputation
        self.elastic = el
        #: entering a running federation: the hello declares it ("jr")
        self.joiner = bool(joiner)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.resume = bool(resume)
        # the round of the checkpoint a resume adopted, until the first
        # STATE_SYNC decides which is newer
        self._resume_round: int | None = None
        # a STATE_SYNC round that landed mid-round: the learning loop
        # fast-forwards at the next round boundary
        self._join_round_target: int | None = None
        #: the models this node adopted, in order: "initial" (weights a
        #: peer pushed), "checkpoint" (its own file), "state_sync"
        self.adopted: list[str] = []
        self._crashed = False
        self.wire_dtype = wire_dtype
        self._peer_wire: dict[int, tuple[str, ...]] = {}
        # int8 error feedback: the quantization error of this node's
        # own shipped update, carried into its next send
        self._ef_residual: list[Any] | None = None
        self.params_bytes_out = 0
        #: beats and roles a read loop dropped on a full lane (see
        #: ``_write``)
        self.floods_dropped = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.peer_bytes_in: dict[int, int] = {}
        self.peer_bytes_out: dict[int, int] = {}
        self.round_wall_s: list[float] = []
        self.fit_slowdown = float(fit_slowdown)
        self.local_epochs = local_epochs
        self._peer_addrs: dict[int, tuple[str, int]] = {}
        #: payload bytes the round path decoded on the loop (0 with the
        #: sidecar: its payloads stay in the arena)
        self.loop_payload_touch_bytes = 0
        #: the host's ``aggd.SidecarClient``, shared by the process's nodes
        self.sidecar = sidecar
        quorum = dict(
            min_received=el.min_received if el.async_aggregation else 1.0,
            staleness_beta=el.staleness_beta if el.async_aggregation
            else 0.0)
        if sidecar is not None:
            self.session: AggregationSession = SidecarSession(
                aggregator, timeout_s=self.protocol.aggregation_timeout_s,
                reputation=reputation, client=sidecar,
                spawn=self._track_task, **quorum)
        else:
            self.session = AggregationSession(
                aggregator, timeout_s=self.protocol.aggregation_timeout_s,
                reputation=reputation, masker=masker, **quorum)
        self.membership = Membership(
            n_nodes, self.protocol, virtual=False,
            retry_limit=el.heartbeat_retry_limit,
            backoff_base_s=el.heartbeat_backoff_base_s,
            backoff_max_s=el.heartbeat_backoff_max_s,
        )
        self.peers: dict[int, PeerState] = {}
        # every connection registered, also those a redial replaced:
        # stop and crash end their tasks too
        self._conns: list[PeerState] = []
        self.progress: dict[int, NodeProgress] = {}
        self.peer_roles: dict[int, str] = {}
        self.peer_metrics: dict[int, dict[str, Any]] = {}
        self.dedup = DedupRing(capacity=max(100, 20 * n_nodes))
        self.round = 0
        self.total_rounds = 0
        self._votes: dict[int, dict[int, tuple[int, ...]]] = {}
        self.epochs = 1
        self.initialized = False
        self._adopting_initial = False  # the starter's weights, being set
        self.learning = False
        self.leader: int | None = None
        self.leader_history: list[int] = []
        # weights for a future round, or that arrived outside a round
        # body: replayed when the round body reaches them
        self._pending_params: list[tuple[PeerState, Message]] = []
        self._beat_seen: dict[int, int] = {}
        # the START_LEARNING frame this node started from, and the nodes
        # seen in a round (a vote, progress or an aggregate): direct peers
        # not seen get the frame again (``_resend_start``)
        self._start_msg: Message | None = None
        self._peers_learning: set[int] = set()
        self._round_active = False
        self.learn_t0: float | None = None
        self.learn_t1: float | None = None
        self._server: asyncio.Server | None = None
        self._tasks: list[asyncio.Task] = []
        self._learn_task: asyncio.Task | None = None
        #: the exception that failed this node's learning loop, if any
        self.error: BaseException | None = None
        self.finished = asyncio.Event()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _track_task(self, coro, what: str) -> asyncio.Task:
        """Spawn ``coro`` as a task this node keeps (and ``stop()``
        cancels); a failure is logged, not dropped."""
        task = asyncio.create_task(coro)
        self._tasks.append(task)

        def _done(t: asyncio.Task) -> None:
            if t in self._tasks:
                self._tasks.remove(t)
            if not t.cancelled() and t.exception() is not None:
                log.error("node %d background task %r failed: %r",
                          self.idx, what, t.exception())

        task.add_done_callback(_done)
        return task

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port,
            ssl=self.tls.server_context() if self.tls else None)
        self.port = self._server.sockets[0].getsockname()[1]
        self.membership.beat(self.idx, 0.0)
        if self.shaper is not None:
            # the partition plan's time 0 is the node's start
            self.shaper.start_clock()
        if self.resume and self.checkpoint_dir:
            await self._try_resume()
        self._track_task(self._heartbeat_loop(), "heartbeat_loop")

    async def _try_resume(self) -> None:
        """A relaunch adopts its own checkpoint before any peer contact;
        a later STATE_SYNC replaces it only with a newer round. A torn
        file is logged naming it, and the node joins as a fresh
        joiner."""
        ln = self.learner
        if getattr(ln, "state", True) is None or getattr(ln, "fns", True) is None:
            ln.init()
        try:
            got = load_node_checkpoint(self.checkpoint_dir, self.idx,
                                       ln.get_parameters())
        except ValueError as e:
            log.warning("node %d resume failed, joining fresh: %s",
                        self.idx, e)
            return
        if got is None:
            return
        params, rnd = got
        await self._set_parameters(params)
        self.initialized = True
        self.round = rnd
        self._resume_round = rnd
        self.adopted.append("checkpoint")

    async def crash(self) -> None:
        """An abrupt teardown without the STOP announcement: the peers
        find the death by heartbeat silence and failed probes, as for a
        killed process. A fit in flight in the executor cannot be
        cancelled: it is asked to stop at its next epoch and writes only
        into this node's own learner. ``stop()`` after a crash does
        nothing."""
        if self._crashed:
            return
        self._crashed = True
        self.learning = False
        interrupt = getattr(self.learner, "interrupt_fit", None)
        if interrupt is not None:
            interrupt()
        await self._cancel_all()
        for peer in {id(p): p for p in (*self._conns,
                                        *self.peers.values())}.values():
            _abort_unsent(peer.writer)  # unsent bytes die with it
        self.peers.clear()
        if self._server:
            self._server.close()
        self._release_slot_refs()
        self.finished.set()

    async def _cancel_all(self) -> None:
        for t in [self._learn_task, *list(self._tasks)]:
            if t is not None:
                t.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await t
        if self.shaper is not None:
            self.shaper.close()  # shaped frames in flight are lost
        for peer in {id(p): p for p in (*self._conns,
                                        *self.peers.values())}.values():
            self._flush(peer)
            for t in (peer.send_task, peer.reader_task):
                if t is not None:
                    t.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await t
            peer.writer.close()

    def _release_slot_refs(self) -> None:
        """Return every arena slot this node still holds (buffered
        messages of a later round, the session's entries) to the
        sidecar: a stopped node must not strand the shared arena's
        slots."""
        if self.sidecar is None:
            return
        for _peer, msg in self._pending_params:
            if msg._slot is not None:
                self.sidecar.release(msg._slot)
                msg._slot = None
        self.session.release_entries()

    # ------------------------------------------------------------------
    # partitions
    # ------------------------------------------------------------------
    def apply_partition(self, groups: list) -> None:
        """Sever every link across the ``groups`` cut, as seen from this
        node: frames to peers of other groups are dropped at the write.
        Applied on every node, the cut is symmetric; a node in no group
        is unaffected. Membership sees a partition fault (the launcher's
        fault driver applies scripted cuts here)."""
        mine = next((g for g in groups if self.idx in g), None)
        if mine is None:
            return
        others = {int(n) for g in groups if g is not mine for n in g}
        self._severed |= others - {self.idx}
        self.membership.apply_fault(
            FaultEvent(node=self.idx, kind="partition", groups=groups))

    def heal_partition(self) -> None:
        """Reconnect every cut applied by hand and grant the evicted an
        amnesty: membership re-arms a probe of each, the probes redial
        and the first beat brings the peer back."""
        if not self._severed:
            return
        self._severed.clear()
        self.membership.apply_fault(FaultEvent(node=self.idx, kind="heal"))

    def _on_netem_transition(self, kind: str, groups: list) -> None:
        """A shaper window's edge: the shaper drops the frames, so only
        membership hears of a partition; a heal also clears the cuts
        applied by hand and grants the amnesty."""
        if kind == "partition":
            self.membership.apply_fault(
                FaultEvent(node=self.idx, kind="partition", groups=groups))
        else:
            self._severed.clear()
            self.membership.apply_fault(
                FaultEvent(node=self.idx, kind="heal"))

    def _link_severed(self, node: int) -> bool:
        """True while a cut (by hand or a shaper window) separates this
        node from ``node``."""
        if node in self._severed:
            return True
        return self.shaper is not None and self.shaper.severed_now(node)

    async def stop(self) -> None:
        if self._crashed:
            return
        # announce the departure (per peer, bounded, concurrently) so
        # peers drop this node at once instead of timing it out
        stop_msg = self._sign(Message(MsgType.STOP, self.idx))
        self.dedup.check_and_add(stop_msg.msg_id)

        async def announce(peer: PeerState) -> None:
            with contextlib.suppress(Exception):
                await asyncio.wait_for(self._write(peer, stop_msg),
                                       timeout=1.0)
                if peer.send_q is not None:
                    await asyncio.wait_for(peer.send_q.join(), timeout=1.0)

        await asyncio.gather(*(announce(p) for p in list(self.peers.values())))
        await self._cancel_all()
        peers = list(self.peers.values())
        # one second for every lane to flush, together; what a peer that
        # stopped reading left unsent is dropped
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.gather(
                *(p.writer.wait_closed() for p in peers),
                return_exceptions=True), timeout=1.0)
        for peer in peers:
            _abort_unsent(peer.writer)
        self.peers.clear()
        if self._server:
            self._server.close()
        self._release_slot_refs()

    # ------------------------------------------------------------------
    # connections
    # ------------------------------------------------------------------
    def _hello_body(self) -> dict:
        """The CONNECT hello: the dial-back port, the wire dtypes this
        node decodes and, entering a running federation, the live-join
        declaration "jr" (the last round it knows)."""
        body = {"port": self.port, "wd": list(WIRE_DTYPES)}
        if self.joiner:
            body["jr"] = self.round
        return body

    def _hello_ok(self, hello: Message, writer) -> bool:
        """Under TLS the index a hello claims must be the connection
        certificate's (else member A could register a connection as
        B), and the hello's own signature must verify."""
        if self.tls is None:
            return True
        from p2pfl_tpu_torch.p2p.tls import peer_index

        cert_idx = peer_index(writer.get_extra_info("peercert"))
        if (cert_idx is not None and cert_idx == int(hello.sender)
                and self._verify_origin(hello)):
            return True
        log.warning("node %d rejecting CONNECT: hello claims %s but "
                    "certificate CN says %s", self.idx, hello.sender,
                    cert_idx)
        return False

    async def connect_to(self, host: str, port: int) -> None:
        """Dial a neighbour."""
        reader, writer = await asyncio.open_connection(
            host, port, ssl=self.tls.client_context() if self.tls else None)
        try:
            await write_message(writer, self._sign(
                Message(MsgType.CONNECT, self.idx, self._hello_body())))
            hello = await read_message(reader)
        except BaseException:
            writer.close()  # a refused handshake leaves no open socket
            raise
        if not self._hello_ok(hello, writer):
            writer.close()
            raise ConnectionError("peer hello does not match its certificate")
        self._record_peer_wire(hello)
        peer = self._register_peer(int(hello.sender), reader, writer)
        self._on_hello_extras(peer, hello, host=host)

    async def _on_connection(self, reader, writer) -> None:
        try:
            hello = await read_message(reader)
        except (asyncio.IncompleteReadError, ValueError):
            writer.close()
            return
        if hello.type is not MsgType.CONNECT or not self._hello_ok(
                hello, writer):
            writer.close()
            return
        await write_message(writer, self._sign(
            Message(MsgType.CONNECT, self.idx, self._hello_body())))
        self._record_peer_wire(hello)
        peer = self._register_peer(int(hello.sender), reader, writer)
        self._on_hello_extras(peer, hello)

    def _on_hello_extras(self, peer: PeerState, hello: Message,
                         host: str | None = None) -> None:
        """Remember the peer's dial-back address (reconnect probes redial
        it). A joiner's hello ("jr") re-admits it to membership and is
        answered with STATE_SYNC, during learning and after the run
        ended (a finished node sends its final model and round, so a
        late joiner adopts it and finishes at once)."""
        port = hello.body.get("port")
        if host is None:
            peername = peer.writer.get_extra_info("peername")
            host = peername[0] if peername else None
        if host is not None and port is not None:
            self._peer_addrs[peer.idx] = (host, int(port))
        if hello.body.get("jr") is None:
            return
        peer.joiner = True
        self.membership.apply_fault(
            FaultEvent(node=peer.idx, round=self.round, kind="join"))
        if self.initialized and (self.learning or self.finished.is_set()):
            self._track_task(self._send_state_sync(peer), "state_sync")

    async def _send_state_sync(self, peer: PeerState) -> None:
        """The current model as a checkpoint-format blob (``pack_model``,
        the node checkpoint's bytes), with the round, rounds, epochs and
        leader a joiner needs to fast-forward. MODEL_INITIALIZED goes
        first: a node whose run ended floods it no more, and a joiner
        would wait out its initial diffusion for it."""
        init = self._sign(Message(MsgType.MODEL_INITIALIZED, self.idx))
        self.dedup.check_and_add(init.msg_id)
        msg = self._sign(Message(
            MsgType.STATE_SYNC, self.idx,
            {"round": self.round, "rounds": self.total_rounds,
             "epochs": self.epochs, "leader": self.leader},
            payload=pack_model(self.learner.get_parameters(), self.round)))
        try:
            await self._write(peer, init)
            await self._write(peer, msg)
        except (ConnectionError, RuntimeError):
            self._drop_conn(peer)

    def _record_peer_wire(self, hello: Message) -> None:
        """The wire precisions the peer's hello advertised (none from a
        peer that predates them: it gets f32)."""
        self._peer_wire[int(hello.sender)] = tuple(
            str(d) for d in hello.body.get("wd", ()))

    def _register_peer(self, idx: int, reader, writer) -> PeerState:
        peer = PeerState(idx=idx, writer=writer)
        peer.send_q = asyncio.Queue(
            maxsize=max(self.protocol.send_queue_depth, 1))
        peer.send_task = asyncio.create_task(self._drain_send_q(peer))
        peer.reader_task = asyncio.create_task(self._read_loop(peer, reader))
        self.peers[idx] = peer
        self._conns = [c for c in self._conns
                       if c.reader_task is not None
                       and not c.reader_task.done()]
        self._conns.append(peer)
        self.membership.beat(idx)
        self._track_task(self._sync_peer(peer), "sync_peer")
        return peer

    async def _sync_peer(self, peer: PeerState) -> None:
        """Bring a new connection up to date with the one-shot floods it
        may have missed: our role, that learning runs, our progress and,
        if we have it, the model."""

        async def send(msg: Message) -> None:
            self._sign(msg)
            self.dedup.check_and_add(msg.msg_id)
            await self._write(peer, msg)

        try:
            await send(Message(MsgType.ROLE, self.idx, {"role": self.role}))
            if self.learning:
                await send(Message(
                    MsgType.START_LEARNING, self.idx,
                    {"rounds": self.total_rounds, "epochs": self.epochs,
                     "leader": self.leader}))
                if self.initialized:
                    await send(Message(MsgType.MODEL_INITIALIZED, self.idx))
                    if not peer.joiner:  # a joiner's comes in STATE_SYNC
                        await self._send_params(
                            peer, self.learner.get_parameters(), (), 1,
                            init=True)
                await send(Message(MsgType.MODELS_READY, self.idx,
                                   {"round": self.round}))
        except (ConnectionError, RuntimeError):
            self._drop_conn(peer)

    def _drop_conn(self, peer: PeerState) -> None:
        """Remove a dead connection if it is still the registered one,
        and discard its queued frames."""
        if self.peers.get(peer.idx) is peer:
            self.peers.pop(peer.idx, None)
        if peer.send_task is not None and not peer.send_task.done():
            peer.send_task.cancel()
        peer.overflow.clear()
        if peer.send_q is not None:
            while True:
                try:
                    peer.send_q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                with contextlib.suppress(ValueError):
                    peer.send_q.task_done()

    def _teardown_conn(self, conn: PeerState) -> None:
        self._drop_conn(conn)
        if conn.reader_task:
            conn.reader_task.cancel()
        conn.writer.close()

    def _evict(self, node: int) -> None:
        """``node`` left (STOP) or failed its probes: out of membership,
        progress and roles, and its connection closed."""
        self.membership.evict(node)
        self.progress.pop(node, None)
        self.peer_roles.pop(node, None)
        conn = self.peers.pop(node, None)
        if conn is not None:
            self._teardown_conn(conn)
        self._secagg_on_evict(node)

    def _secagg_on_evict(self, node: int) -> None:
        """Dropout recovery: note the eviction, and flood this node's
        round seed against the evicted member, so every aggregator can
        rebuild the dead pairs' mask streams (it unmasks nothing of a
        survivor)."""
        if (self.masker is None
                or self.masker.round_num is None
                or node not in self.masker.members
                or node in self.masker.evicted):
            return
        self.masker.note_evicted(node)
        seed = self.masker.reveal_share(node)
        self._track_task(
            self.broadcast(Message(
                MsgType.SECAGG_SHARE, self.idx,
                {"dead": int(node), "round": int(self.masker.round_num),
                 "seed": int(seed)})),
            "secagg_share")

    async def _drain_send_q(self, peer: PeerState) -> None:
        """The lane's writer under congestion: FIFO; after a write
        failure it drops the connection and keeps discarding, so blocked
        producers wake."""
        dead = False
        while True:
            msg = await peer.send_q.get()
            try:
                if not dead and peer.writer.is_closing():
                    # the peer closed the connection: asyncio's writelines
                    # does not check for a lost connection itself
                    dead = True
                    self._drop_conn(peer)
                if not dead:
                    peer.draining = True
                    try:
                        self._flush(peer)  # the idle lane's frames go first
                        await write_message(peer.writer, msg)
                        self._count_tx(peer, msg)
                    except (ConnectionError, RuntimeError, OSError):
                        dead = True
                        self._drop_conn(peer)
                    finally:
                        peer.draining = False
            finally:
                with contextlib.suppress(ValueError):
                    peer.send_q.task_done()

    def _count_rx(self, peer: PeerState, msg: Message) -> None:
        self.bytes_in += msg._wire_bytes
        pb = self.peer_bytes_in
        pb[peer.idx] = pb.get(peer.idx, 0) + msg._wire_bytes

    def _count_tx(self, peer: PeerState, msg: Message) -> None:
        n = msg.wire_size()
        self.bytes_out += n
        pb = self.peer_bytes_out
        pb[peer.idx] = pb.get(peer.idx, 0) + n

    async def _read_loop(self, peer: PeerState, reader) -> None:
        # with the sidecar a round's PARAMS payload lands in the arena:
        # the loop reads the header and a slot number
        sink = self._slot_sink if self.sidecar is not None else None
        try:
            while True:
                msg = await read_message(reader, slot_sink=sink)
                self._count_rx(peer, msg)
                await self._dispatch(peer, msg)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            self._drop_conn(peer)
            peer.writer.close()  # the peer is gone (a crash closes no lane)

    def _slot_sink(self, obj: dict, pl: int):
        """``read_message``'s divert: a leased arena slot for this
        payload, or None for the heap path. Diverted: an unsigned round
        PARAMS whose header carries its contributors and weight ("c",
        "w"), not the initial diffusion, not on a proxy (it relays the
        bytes), and not an aggregate a waiting session adopts (that
        one is decoded)."""
        if obj.get("t") != MsgType.PARAMS.value or obj.get("g"):
            return None
        body = obj.get("b") or {}
        if body.get("init") or body.get("c") is None or body.get("w") is None:
            return None
        if self.role == "proxy":
            return None
        if self.session.waiting and body.get("aggregated"):
            return None
        lease = self.sidecar.lease(pl)
        if lease is None:
            return None  # arena full or payload too large: the heap
        slot, mv = lease
        return slot, mv, self.sidecar.release

    def _release_msg_slot(self, msg: Message) -> None:
        if msg._slot is not None:
            self.sidecar.release(msg._slot)
            msg._slot = None

    # ------------------------------------------------------------------
    # receive path
    # ------------------------------------------------------------------
    async def _dispatch(self, peer: PeerState, msg: Message) -> None:
        if not (0 <= msg.sender < self.n_nodes):
            self._release_msg_slot(msg)
            return  # garbage index: neither handled nor forwarded
        if msg.type in GOSSIPED:
            # peek, verify, and only then mark seen: marking a forgery
            # seen would let a relay censor the genuine frame's id
            if self.dedup.seen(msg.msg_id):
                return  # at most once
            if not self._verify_origin(msg):
                return  # forged: not handled, not relayed, not seen
            self.dedup.check_and_add(msg.msg_id)
            # on a declared full mesh the periodic floods' relay runs with
            # probability 1/(n-2): about one repair relay a beat at any n
            relay_p = min(1.0, 1.0 / max(self.n_nodes - 2, 1))
            damped = (self.full_mesh
                      and msg.type in PERIODIC_FLOODS
                      and len(self.peers) >= self.n_nodes - 1
                      and self._rng.random() >= relay_p)
            if not damped:
                await self._forward(msg, exclude=peer.idx,
                                    limit=self.protocol.gossip_fanout,
                                    nowait=True)
        elif (msg.type in (MsgType.PARAMS, MsgType.STATE_SYNC)
              and not self._verify_origin(msg)):
            self._release_msg_slot(msg)
            return
        t = msg.type
        if t is MsgType.BEAT:
            # only strictly newer beats count (a replay cannot keep a dead
            # node alive)
            seq = int(msg.body.get("n", 0))
            if seq > self._beat_seen.get(msg.sender, -1):
                self._beat_seen[msg.sender] = seq
                self.membership.beat(msg.sender)
        elif t is MsgType.ROLE:
            self.peer_roles[msg.sender] = msg.body["role"]
        elif t is MsgType.START_LEARNING:
            if not self.learning and not self.finished.is_set():
                self._start_msg = msg
                self._start_learning(msg.body["rounds"], msg.body["epochs"],
                                     leader=msg.body.get("leader"))
        elif t is MsgType.STOP_LEARNING:
            self._stop_learning()
        elif t is MsgType.METRICS:
            self.peer_metrics[msg.sender] = dict(msg.body)
        elif t is MsgType.STOP:
            self._evict(int(msg.sender))
        elif t is MsgType.PARAMS:
            await self._on_params(peer, msg)
        elif t is MsgType.STATE_SYNC:
            await self._on_state_sync(msg)
        elif t is MsgType.MODELS_AGGREGATED:
            # within a round coverage only grows: older rounds are
            # ignored, the same round's sets union
            self._peers_learning.add(msg.sender)
            pr = self._progress(msg.sender)
            r = int(msg.body.get("round", 0))
            if r > pr.agg_round:
                pr.models_aggregated = set(msg.body["contributors"])
                pr.agg_round = r
            elif r == pr.agg_round:
                pr.models_aggregated |= set(msg.body["contributors"])
        elif t is MsgType.MODEL_INITIALIZED:
            self._progress(msg.sender).initialized = True
        elif t is MsgType.MODELS_READY:
            self._peers_learning.add(msg.sender)
            pr = self._progress(msg.sender)
            pr.ready_round = max(pr.ready_round, int(msg.body["round"]))
        elif t is MsgType.VOTE_TRAIN_SET:
            self._peers_learning.add(msg.sender)
            r = int(msg.body["round"])
            if r >= self.round:
                self._votes.setdefault(r, {})[msg.sender] = tuple(
                    int(c) for c in msg.body["candidates"])
        elif t is MsgType.TRANSFER_LEADERSHIP:
            # a token for a past round is stale
            if int(msg.body.get("round", self.round)) >= self.round:
                self.leader = int(msg.body["to"])
                self.leader_history.append(self.leader)
        elif t is MsgType.SECAGG_SHARE:
            # a survivor's reveal against an evicted member: filed with
            # the masker, and the eviction mirrored here (which reveals
            # this node's seed too, once)
            if self.masker is not None:
                self.masker.add_share(
                    int(msg.sender), int(msg.body["dead"]),
                    int(msg.body["round"]), int(msg.body["seed"]))
                if int(msg.body["round"]) == self.masker.round_num:
                    self._secagg_on_evict(int(msg.body["dead"]))

    async def _on_params(self, peer: PeerState, msg: Message) -> None:
        if msg.body.get("init"):
            # whoever pushes the initial weights has the model
            self._progress(msg.sender).initialized = True
            if not (self.initialized or self._adopting_initial):
                self._adopting_initial = True
                try:
                    payload = decode_parameters(msg.payload)
                    await self._set_parameters(payload.params)
                finally:
                    self._adopting_initial = False
                self.initialized = True
                self.adopted.append("initial")
                await self.broadcast(
                    Message(MsgType.MODEL_INITIALIZED, self.idx),
                    nowait=True)
                # relay the initial weights onward (multi-hop overlays)
                self._track_task(self._diffuse_initial(), "diffuse_initial")
            return
        if self.role == "proxy" and msg.msg_id:
            # a proxy relays weight traffic at once, deduped by msg_id
            if self.dedup.check_and_add(msg.msg_id):
                await self._forward(msg, exclude=peer.idx)
        # round fence: a future round's model, or this round's before the
        # round body is ready, waits for that round's start; a past
        # round's model folds (async) or is dropped
        msg_round = int(msg.body.get("round", self.round))
        if msg_round > self.round or (
            msg_round == self.round and not self._round_active
        ):
            self._pending_params.append((peer, msg))
            return
        staleness = self.round - msg_round
        if staleness > 0 and not self._folds(msg):
            self._release_msg_slot(msg)
            return
        if self.session.waiting and not msg.body.get("aggregated"):
            self._release_msg_slot(msg)
            return  # waiting nodes adopt only a finished aggregate
        if msg._slot is not None and self.session.waiting:
            # a buffered aggregate meeting a session that turned waiting:
            # adoption decodes (counted; the sink never diverts an
            # adoption on the live path)
            n = msg._slot_len
            self.loop_payload_touch_bytes += n
            blob = bytes(self.sidecar.view(msg._slot, n))
            self._release_msg_slot(msg)
            payload = decode_parameters(blob)
            covered = self.session.add_model(
                payload.params, payload.contributors, payload.weight)
        else:
            covered = self._session_add(msg, staleness)
        if covered:
            await self.broadcast(Message(
                MsgType.MODELS_AGGREGATED, self.idx,
                {"contributors": sorted(covered), "round": self.round}),
                nowait=True)

    def _folds(self, msg: Message) -> bool:
        """An update for an earlier round folds into the open session in
        async mode (FedBuff's late inclusion) when it is a raw
        contribution: a stale aggregate is last round's result, and it
        would cover the fresh session at once."""
        return (self.session.async_mode and self._round_active
                and not self.session.waiting
                and not msg.body.get("aggregated"))

    def _session_add(self, msg: Message, staleness: int = 0):
        """``msg``'s contribution into the session, its weight discounted
        by ``staleness`` rounds: a slot stays undecoded, and so do bytes
        the arena had no room for (the header's "c" and "w" carry what
        the session needs); other payloads are decoded. A stale entry
        naming nobody, or the whole train set, is dropped."""
        undecoded = msg._slot is not None or (
            self.sidecar is not None and not self.session.waiting
            and "c" in msg.body and "w" in msg.body)
        if undecoded:
            contribs = tuple(int(c) for c in msg.body.get("c") or ())
            weight = int(msg.body.get("w", 1))
        else:
            self.loop_payload_touch_bytes += len(msg.payload)
            payload = decode_parameters(msg.payload)
            contribs, weight = payload.contributors, payload.weight
        ts = self.session.train_set
        if staleness > 0 and (not contribs or (ts and set(contribs) >= ts)):
            self._release_msg_slot(msg)
            return ()
        if msg._slot is not None:
            covered = self.session.add_slot(msg._slot, msg._slot_len,
                                            contribs, weight,
                                            staleness=staleness)
            msg._slot = None  # the session owns it now
            return covered
        if undecoded:
            return self.session.add_blob(msg.payload, contribs, weight,
                                         staleness=staleness)
        return self.session.add_model(payload.params, contribs, weight,
                                      staleness=staleness)

    async def _on_state_sync(self, msg: Message) -> None:
        """The joiner's side of the live join: adopt the established
        node's model (once: the first answer wins, or the init catch-up
        of ``_sync_peer`` if it landed first), fast-forward to its round
        (never back), and enter the federation. A resumed node compares
        the first answer's round with its checkpoint's, once, and adopts
        the peer's model only when it is strictly newer."""
        if not self.joiner:
            return
        # the sender has the model, as a pusher of initial weights has
        self._progress(msg.sender).initialized = True
        rnd = int(msg.body.get("round", 0))
        while self._adopting_initial:  # an adoption in flight decides
            await asyncio.sleep(self.gossip_period_s)
        adopt_over_resume = (self.initialized
                             and self._resume_round is not None
                             and rnd > self._resume_round)
        # the first answer decides, also when a START_LEARNING came first
        # (the JAX package decides again at every answer then, and a
        # resumed node adopts every peer's model in turn)
        self._resume_round = None
        if rnd > self.round:
            if self.learning:
                # a round body is running (or voting): jump at the next
                # boundary, where no session names the old round
                self._join_round_target = max(self._join_round_target or 0,
                                              rnd)
            else:
                self.round = rnd
        if not self.initialized or adopt_over_resume:
            ln = self.learner
            if (getattr(ln, "state", True) is None
                    or getattr(ln, "fns", True) is None):
                ln.init()
            try:
                params, _ = unpack_model(msg.payload, ln.get_parameters())
            except ValueError:
                log.warning("node %d: STATE_SYNC blob from %d does not "
                            "match the local model", self.idx, msg.sender)
                return
            self._adopting_initial = True
            try:
                await self._set_parameters(params)
            finally:
                self._adopting_initial = False
            self.initialized = True
            self.adopted.append("state_sync")
            await self.broadcast(Message(MsgType.MODEL_INITIALIZED, self.idx),
                                 nowait=True)
        if not self.learning and not self.finished.is_set():
            body = {"rounds": int(msg.body.get("rounds", 0)),
                    "epochs": int(msg.body.get("epochs", 1)),
                    "leader": msg.body.get("leader")}
            # the frame ``_resend_start`` sends peers not seen in a round
            self._start_msg = self._sign(
                Message(MsgType.START_LEARNING, self.idx, body))
            self._start_learning(body["rounds"], body["epochs"],
                                 leader=body["leader"])

    # ------------------------------------------------------------------
    # send path
    # ------------------------------------------------------------------
    def _sign(self, msg: Message) -> Message:
        """Origin-sign a message this node creates (no-op without TLS);
        a relayed message keeps its origin's signature."""
        if self._signer is not None and not msg.sig:
            msg.sig = self._signer.sign(msg.signing_bytes())
            msg.cert = self._signer.cert_pem
            msg._head = None  # the signature changes the header
        return msg

    def _verify_origin(self, msg: Message) -> bool:
        """True when the message's origin signature holds for its claimed
        sender (always without TLS)."""
        if self._verifier is None:
            return True
        if self._verifier.verify(msg.cert, msg.sig, msg.signing_bytes(),
                                 msg.sender):
            return True
        log.warning("node %d dropping %s with unverifiable origin claim "
                    "sender=%d", self.idx, msg.type.value, msg.sender)
        return False

    async def broadcast(self, msg: Message, exclude: int | None = None,
                        nowait: bool = False) -> None:
        self._sign(msg)
        if msg.type in GOSSIPED:
            self.dedup.check_and_add(msg.msg_id)
        await self._forward(msg, exclude, nowait=nowait)

    def _try_fast_write(self, peer: PeerState, msg: Message) -> bool:
        """Put the frame in the idle lane's outbox when the transport and
        the outbox together hold less than the high-water mark; False
        when the caller must queue. A frame to a peer behind a cut
        applied by hand dies here (True)."""
        if peer.idx in self._severed:
            return True
        q = peer.send_q
        if (q is None or not q.empty() or peer.draining or peer.overflow
                or self.peers.get(peer.idx) is not peer):
            return False
        tr = peer.writer.transport
        if (tr.is_closing() or tr.get_write_buffer_size() + peer.outbox_bytes
                >= _FAST_LANE_MAX):
            return False
        peer.outbox.extend(msg.wire_segments())
        peer.outbox_bytes += msg.wire_size()
        self._count_tx(peer, msg)
        if not peer.flush_due:
            peer.flush_due = True
            asyncio.get_running_loop().call_soon(self._flush, peer)
        return True

    def _flush(self, peer: PeerState) -> None:
        """Write the lane's outbox in one call."""
        peer.flush_due = False
        if not peer.outbox:
            return
        segments, peer.outbox, peer.outbox_bytes = peer.outbox, [], 0
        if peer.writer.is_closing():
            self._drop_conn(peer)
            return
        try:
            peer.writer.writelines(segments)
        except (ConnectionError, RuntimeError, OSError):
            self._drop_conn(peer)

    async def _write(self, peer: PeerState, msg: Message,
                     nowait: bool = False) -> None:
        """The one egress point: the link shaper's schedule when links
        are shaped, else the outbox, else the peer's bounded lane
        (blocking only when that lane is full).

        ``nowait`` is a read loop's send (a relay, a coverage or
        initialized announcement): it never waits on a full lane. A read
        loop that waited would stop draining its own socket; on a full
        mesh of large models every lane fills, and the readers, each
        waiting on a lane to a peer whose reader waits on one back,
        deadlocked the federation. Such a flood goes to the lane's
        ``overflow`` instead, which one task puts on the lane in order,
        so no vote, share, readiness or coverage frame is lost. Only a
        beat or a role (``PERIODIC_FLOODS``) is dropped there, counted in
        ``floods_dropped``: the next one replaces it."""
        if peer.idx in self._severed:
            return  # a cut applied by hand: dropped on the cut
        if self.shaper is not None:
            await self.shaper.send(peer, msg)
            return
        if self._try_fast_write(peer, msg):
            return
        if peer.send_q is not None and self.peers.get(peer.idx) is peer:
            if nowait and msg.type in GOSSIPED and (
                    peer.overflow or peer.send_q.full()):
                if msg.type in PERIODIC_FLOODS:
                    self.floods_dropped += 1
                    return
                peer.overflow.append(msg)
                if len(peer.overflow) == 1:
                    self._track_task(self._put_overflow(peer), "overflow")
                return
            await peer.send_q.put(msg)
        elif not peer.writer.is_closing():
            self._flush(peer)
            await write_message(peer.writer, msg)

    async def _put_overflow(self, peer: PeerState) -> None:
        """Put a lane's overflow on the lane, oldest first, while the
        connection is the registered one (``_drop_conn`` empties it)."""
        while peer.overflow and self.peers.get(peer.idx) is peer:
            await peer.send_q.put(peer.overflow[0])
            if peer.overflow:
                peer.overflow.popleft()

    async def _forward(self, msg: Message, exclude: int | None = None,
                       limit: int = 0, nowait: bool = False) -> None:
        """Send to the peers (a random ``limit`` of them when > 0): idle
        lanes written inline, congested ones enqueued concurrently."""
        targets = [p for p in self.peers.values() if p.idx != exclude]
        if limit > 0 and len(targets) > limit:
            targets = self._rng.sample(targets, limit)
        await self._ship(targets, msg, nowait=nowait)

    async def _ship(self, peers: list[PeerState], msg: Message,
                    nowait: bool = False) -> None:
        congested = [p for p in peers if self.shaper is not None
                     or not self._try_fast_write(p, msg)]
        if not congested:
            return

        async def enqueue(peer: PeerState) -> None:
            try:
                await self._write(peer, msg, nowait=nowait)
            except (ConnectionError, RuntimeError):
                self._drop_conn(peer)

        await asyncio.gather(*(enqueue(p) for p in congested))

    def _wire_dtype_for(self, peers, *, init: bool = False) -> str | None:
        """The wire precision of one PARAMS send: reduced only when every
        target advertised it; the initial diffusion always ships f32."""
        if init or self.wire_dtype == "f32":
            return None
        if all(self.wire_dtype in self._peer_wire.get(p.idx, ())
               for p in peers):
            return self.wire_dtype
        return None

    def _apply_error_feedback(self, params):
        """Add the residual of the previous int8 send to the floating
        leaves, and keep the new residual (the carried input minus its
        dequantized image); reset when the leaves change shape."""
        leaves = [to_host(leaf) for leaf in tree_leaves_sorted(params)]
        res = self._ef_residual
        if res is None or len(res) != len(leaves) or any(
            r is not None and r.shape != np.shape(leaf)
            for r, leaf in zip(res, leaves)
        ):
            res = [np.zeros(np.shape(leaf), np.float32)
                   if np.issubdtype(leaf.dtype, np.floating) else None
                   for leaf in leaves]
        carried = [leaf.astype(np.float32) + r if r is not None else leaf
                   for leaf, r in zip(leaves, res)]
        tree = tree_unflatten_sorted(params, carried)
        deq = tree_leaves_sorted(dequantize_int8(*quantize_int8(tree)))
        self._ef_residual = [
            as_f32(c) - as_f32(d) if r is not None else None
            for c, d, r in zip(carried, deq, res)]
        return tree

    async def _send_params(self, peers, params, contributors, weight,
                           _ef: bool = False, **body) -> None:
        """Ship a weights payload to one peer or a list of peers: one
        encode and one framed header for the whole list. ``_ef`` marks
        this node's own update, which int8 sends with error feedback."""
        if isinstance(peers, PeerState):
            peers = [peers]
        if not peers:
            return
        body.setdefault("round", self.round)
        body["c"] = [int(c) for c in contributors]
        body["w"] = int(weight)
        wd = self._wire_dtype_for(peers, init=bool(body.get("init")))
        if wd == "int8" and _ef:
            params = self._apply_error_feedback(params)
        blob = encode_parameters(params, tuple(contributors), int(weight),
                                 wire_dtype=wd)
        self.params_bytes_out += len(blob) * len(peers)
        # explicit id: PARAMS is direct, but proxies relay and dedup it
        await self._ship(peers, self._sign(Message(
            MsgType.PARAMS, self.idx, body, payload=blob,
            msg_id=secrets.token_hex(8))))

    # ------------------------------------------------------------------
    # control plane loops
    # ------------------------------------------------------------------
    async def _heartbeat_loop(self) -> None:
        period = self.protocol.heartbeat_period_s
        beats = 0
        while True:
            self.membership.beat(self.idx)
            # a wall-clock sequence: monotonic across a restart
            await self.broadcast(Message(MsgType.BEAT, self.idx,
                                         {"n": int(time.time() * 1000)}))
            beats += 1
            if beats % 2 == 0:
                await self.broadcast(
                    Message(MsgType.ROLE, self.idx, {"role": self.role}))
                await self._resend_start()
            self.membership.advance_to(self.membership.clock + period)
            await self._probe_suspects()
            await asyncio.sleep(period)

    async def _resend_start(self) -> None:
        """A flood can lose every copy a node would get (lossy links on a
        ring), and a node that never hears START_LEARNING never trains
        and never finishes. So a learning node sends the frame it started
        from again, its id unchanged, to each direct peer not yet seen in
        a round; a peer that has the id drops it unread."""
        if not self.learning or self._start_msg is None:
            return
        for idx, peer in list(self.peers.items()):
            if idx not in self._peers_learning:
                try:
                    await self._write(peer, self._start_msg)
                except (ConnectionError, RuntimeError):
                    self._drop_conn(peer)

    async def _probe_suspects(self) -> None:
        """Probe each suspect whose backoff elapsed: a closed lane is
        redialled; an open one only burns a retry (its silence is more
        often a busy loop than a death). A spent budget evicts."""
        for node in self.membership.probes_due():
            if self._link_severed(node):
                # the emulated cut drops frames but not sockets: a dial
                # across it would succeed, so the probe fails here
                if self.membership.probe_failed(node):
                    self._evict(node)
                continue
            conn = self.peers.get(node)
            if conn is not None and not conn.writer.is_closing():
                if self.membership.probe_failed(node):
                    self._evict(node)
                continue
            addr = self._peer_addrs.get(node)
            ok = False
            if addr is not None:
                if conn is not None:
                    self._teardown_conn(conn)
                try:
                    await asyncio.wait_for(
                        self.connect_to(*addr),
                        timeout=self.protocol.heartbeat_period_s)
                    ok = True
                except Exception:
                    ok = False
            if not ok and self.membership.probe_failed(node):
                self._evict(node)

    # ------------------------------------------------------------------
    # learning
    # ------------------------------------------------------------------
    def set_start_learning(self, rounds: int, epochs: int = 1) -> None:
        """The initiator's entry point."""
        self._track_task(self._kickoff(rounds, epochs), "kickoff")

    async def _kickoff(self, rounds: int, epochs: int) -> None:
        self._start_msg = Message(
            MsgType.START_LEARNING, self.idx,
            {"rounds": rounds, "epochs": epochs,
             "leader": self.idx if self.role in ("server", "aggregator")
             else None})
        await self.broadcast(self._start_msg)
        # the starter floods its own MODEL_INITIALIZED too: adopters
        # re-diffuse until every peer, the starter included, says so
        self.initialized = True
        await self.broadcast(Message(MsgType.MODEL_INITIALIZED, self.idx))
        self._start_learning(rounds, epochs, leader=self.idx)

    def _start_learning(self, rounds, epochs, leader=None) -> None:
        self.learning = True
        self.total_rounds = rounds
        self.epochs = epochs
        if leader is not None:
            self.leader = leader
            self.leader_history.append(leader)
        self._track_task(
            self.broadcast(Message(MsgType.ROLE, self.idx, {"role": self.role})),
            "role_announce")
        self._learn_task = asyncio.create_task(self._learning_loop())
        self._learn_task.add_done_callback(self._learning_done)

    def _learning_done(self, task: asyncio.Task) -> None:
        """A learning loop that raised fails the node loudly: ``error``
        holds the exception and ``finished`` is set for the launcher."""
        if task.cancelled() or task.exception() is None:
            return
        self.error = task.exception()
        log.error("node %d learning loop failed: %r", self.idx, self.error)
        self.learning = False
        self.finished.set()

    def _stop_learning(self) -> None:
        self.learning = False
        if self._learn_task:
            self._learn_task.cancel()
        self.finished.set()

    def _progress(self, idx: int) -> NodeProgress:
        if idx not in self.progress:
            self.progress[idx] = NodeProgress()
        return self.progress[idx]

    def _aggregated_by(self, idx: int) -> set[int]:
        """What node ``idx`` has aggregated this round (a stale round
        reads as empty)."""
        pr = self.progress.get(idx)
        if pr is None or pr.agg_round != self.round:
            return set()
        return pr.models_aggregated

    def _trainable(self, nodes: set[int]) -> set[int]:
        """Proxies and idles are never train-set candidates."""
        out = set()
        for i in nodes:
            role = self.peer_roles.get(i) if i != self.idx else self.role
            if role not in ("proxy", "idle"):
                out.add(i)
        return out

    async def _vote_train_set(self) -> set[int]:
        """Elect the round's train set: each ballot is the trainable part
        of the voter's live neighbourhood; the ``train_set_size``
        best-vouched candidates win, ties broken by an index that rotates
        with the round. If the ballots do not all arrive by
        ``vote_timeout_s`` the election is the ballot-free one over the
        alive membership, which every node with the same view agrees on.
        The leader is always seated."""
        loop = asyncio.get_event_loop()
        alive = set(self.membership.get_nodes())
        ballot = sorted(self._trainable(alive & (set(self.peers) | {self.idx})))
        votes = self._votes.setdefault(self.round, {})
        votes[self.idx] = tuple(ballot)
        await self.broadcast(Message(MsgType.VOTE_TRAIN_SET, self.idx,
                                     {"round": self.round,
                                      "candidates": ballot}))
        deadline = loop.time() + self.protocol.vote_timeout_s
        complete = False
        while loop.time() < deadline and not self._behind_a_join():
            alive = set(self.membership.get_nodes())
            if alive <= set(votes):
                complete = True
                break
            await asyncio.sleep(self.gossip_period_s)
        if not complete:
            alive = set(self.membership.get_nodes())
            tally = {c: 1 for c in self._trainable(alive)}
        else:
            tally = {}
            for voter, cands in votes.items():
                if voter in alive:  # dead voters are dropped
                    for c in cands:
                        tally[c] = tally.get(c, 0) + 1
        k = self.protocol.train_set_size
        if k <= 0 or k > len(tally):
            k = len(tally)
        winners = sorted(
            tally, key=lambda c: (-tally[c], (c - self.round) % self.n_nodes),
        )[:k]
        win = set(winners) or {self.idx}
        if (self.leader is not None and self.leader in alive
                and self.leader not in win):
            if winners and len(win) >= k:
                win.discard(winners[-1])
            win.add(self.leader)
        self._votes = {r: v for r, v in self._votes.items() if r > self.round}
        return win

    async def _learning_loop(self) -> None:
        ln = self.learner
        ln.set_epochs(self.local_epochs if self.local_epochs is not None
                      else self.epochs)
        if getattr(ln, "state", True) is None or getattr(ln, "fns", True) is None:
            ln.init()
        if self.initialized:
            await self._diffuse_initial()
        else:
            while not self.initialized:  # the starter's weights
                await asyncio.sleep(self.gossip_period_s)
        self.learn_t0 = time.monotonic()
        while self.round < self.total_rounds:
            if self._join_round_target is not None:
                # a STATE_SYNC that landed mid-round: jump here, where no
                # session names the old round
                self.round = max(self.round, self._join_round_target)
                self._join_round_target = None
                if self.round >= self.total_rounds:
                    break
            t0 = time.monotonic()
            if await self._train_round():
                self.round_wall_s.append(time.monotonic() - t0)
                self._maybe_checkpoint()
        self.learn_t1 = time.monotonic()
        # the final evaluation, flooded to the federation
        metrics = await asyncio.get_running_loop().run_in_executor(
            None, self.learner.evaluate)
        self.peer_metrics[self.idx] = {"round": self.round, **metrics}
        await self.broadcast(Message(MsgType.METRICS, self.idx,
                                     {"round": self.round, **metrics}))
        self.learning = False
        self.finished.set()

    def _maybe_checkpoint(self) -> None:
        """Every ``checkpoint_every`` rounds, this node's params and round
        to its own file (atomically). A failed save is logged, not
        raised: a full disk must not end a healthy round loop."""
        if (not self.checkpoint_dir or self.checkpoint_every <= 0
                or self.round % self.checkpoint_every != 0):
            return
        try:
            save_node_checkpoint(self.checkpoint_dir, self.idx,
                                 self.learner.get_parameters(), self.round)
        except Exception as e:
            log.warning("node %d checkpoint failed at round %d: %s",
                        self.idx, self.round, e)

    async def _diffuse_initial(self) -> None:
        """Push the initial weights, paced, until every peer reports
        initialized (or the aggregation timeout)."""
        params = self.learner.get_parameters()
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.protocol.aggregation_timeout_s
        retry_s = max(self.gossip_period_s * 4, 0.5)
        last_sent: dict[int, float] = {}
        while (any(not self._progress(i).initialized for i in self.peers)
               and loop.time() < deadline):
            now = loop.time()
            due = []
            for idx, peer in list(self.peers.items()):
                if (not self._progress(idx).initialized
                        and now - last_sent.get(idx, -1e9) >= retry_s):
                    last_sent[idx] = now
                    due.append(peer)
            if due:
                await self._send_params(due, params, (), 1, init=True)
            await asyncio.sleep(self.gossip_period_s)

    def _effective_role(self) -> str:
        """SDFL: the aggregator role follows the leadership token."""
        if self.federation == "SDFL":
            return "aggregator" if self.leader == self.idx else "trainer"
        return self.role

    async def _fit(self) -> None:
        """Local training in the loop's executor. ``fit_slowdown`` k > 1
        sleeps (k - 1) times the fit's own time after it."""
        t0 = time.monotonic()
        await asyncio.get_running_loop().run_in_executor(None, self.learner.fit)
        if self.fit_slowdown > 1.0:
            await asyncio.sleep((time.monotonic() - t0)
                                * (self.fit_slowdown - 1.0))

    async def _set_parameters(self, params) -> None:
        """The learner's ``set_parameters`` in the loop's executor: its
        host-to-device copies wait behind the fits already queued on the
        card, and the loop keeps serving heartbeats meanwhile."""
        await asyncio.get_running_loop().run_in_executor(
            None, self.learner.set_parameters, params)

    def round_p95_s(self) -> float | None:
        """p95 of the completed rounds' wall times (None before one)."""
        if not self.round_wall_s:
            return None
        xs = sorted(self.round_wall_s)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def _behind_a_join(self) -> bool:
        """A STATE_SYNC named a later round than the one being voted."""
        return (self._join_round_target is not None
                and self._join_round_target > self.round)

    async def _train_round(self) -> bool:
        """One round; False when a STATE_SYNC that landed during the vote
        moved the node past it (the loop fast-forwards; the JAX node runs
        the stale round's body to its timeouts first)."""
        train_set = await self._vote_train_set()
        if self._behind_a_join():
            return False
        self.session.clear()
        if self.masker is not None:
            # fresh pair streams for this round's members
            self.masker.begin_round(self.round, train_set)
        # the round's role and token position, fixed for the whole round
        role = self._effective_role()
        leader_at_start = self.leader
        if self.idx not in train_set and role in ("aggregator", "trainer"):
            role = "idle"  # voted out: adopt only
        # the session's mode is set before the fit and the replay, so an
        # aggregate arriving meanwhile is adopted by a waiting node
        if role in ("aggregator", "server"):
            self.session.set_nodes_to_aggregate(train_set)
            if self.reputation is not None or self.masker is not None:
                # the reputation scores' delta reference, and the template
                # the masked sum dequantizes against (set before the
                # replay: a replayed model may close the round)
                self.session.set_reference(self.learner.get_parameters())
        else:
            self.session.set_waiting_aggregated_model()
        self._round_active = True
        pending, self._pending_params = self._pending_params, []
        for peer, msg in pending:
            if peer.idx in self.peers:
                await self._on_params(peer, msg)
            else:  # the sender is gone: its buffered slot goes back
                self._release_msg_slot(msg)
        if role in ("aggregator", "server"):
            ref = await self._update_reference()
            await self._fit()
            await self._transform_own_update(ref)
            n_samples = self.learner.get_num_samples()[0]
            covered = self.session.add_model(self._own_update(n_samples),
                                             (self.idx,), n_samples)
            await self.broadcast(Message(
                MsgType.MODELS_AGGREGATED, self.idx,
                {"contributors": sorted(covered), "round": self.round}))
            await self._gossip_until_done(train_set, role, leader_at_start)
        elif role == "trainer":
            ref = await self._update_reference()
            await self._fit()
            await self._transform_own_update(ref)
            n_samples = self.learner.get_num_samples()[0]
            target = leader_at_start if leader_at_start in self.peers else None
            sent_to = ([self.peers[target]] if target is not None
                       else list(self.peers.values()))
            await self._send_params(sent_to, self._own_update(n_samples),
                                    (self.idx,), n_samples, _ef=True)
            await self._wait_done()
        else:  # idle / proxy: adopt whatever aggregate arrives
            await self._wait_done()

        if self.session.result is not None:
            params, _ = self.session.result
            await self._set_parameters(params)
        self._round_active = False  # the barrier window buffers
        self.round += 1
        self.learner.finalize_round()
        if self.federation == "SDFL" and role == "aggregator":
            # rotate the token, broadcast before MODELS_READY: a peer's
            # ordered stream shows the new token before our completion
            candidates = sorted(
                (train_set & set(self.membership.get_nodes())) - {self.idx})
            if candidates:
                new_leader = self._rng.choice(candidates)
                self.leader = new_leader
                self.leader_history.append(new_leader)
                await self.broadcast(Message(
                    MsgType.TRANSFER_LEADERSHIP, self.idx,
                    {"to": new_leader, "round": self.round}))
        await self.broadcast(Message(MsgType.MODELS_READY, self.idx,
                                     {"round": self.round}))
        await self._wait_neighbors_ready()
        return True

    def _poisons_updates(self) -> bool:
        return self.attack is not None and self.attack.poisons_updates

    async def _update_reference(self):
        """The round's starting params on the device (a copy), when this
        node transforms its update (an attack or DP); else None."""
        if not (self._poisons_updates() or self.dp is not None):
            return None
        return await asyncio.get_running_loop().run_in_executor(
            None, self.learner.device_parameters)

    async def _transform_own_update(self, ref) -> None:
        """Poison, then privatize, the trained params once, on the device,
        against ``ref``, keyed by (seed, this node, this round) as the
        stacked rows are: the result backs the session entry and every
        send, and the clip bounds what an attack injects."""
        if ref is None:
            return
        idx, rnd, attack, dp = self.idx, self.round, self.attack, self.dp
        poisons = self._poisons_updates()

        def transform(params):
            if poisons:
                params = poison_update(params, ref, idx, rnd, attack)
            if dp is not None:
                params = privatize_update(params, ref, dp.clip_norm,
                                          dp.noise_multiplier,
                                          (dp.seed, idx, rnd))
            return params

        await asyncio.get_running_loop().run_in_executor(
            None, self.learner.transform_parameters, transform)

    def _own_update(self, n_samples: int):
        """This round's trained params as they leave the learner: under
        secure aggregation quantized, weighted and pairwise-masked (the
        raw update never enters the session or the wire)."""
        own = self.learner.get_parameters()
        if self.masker is not None:
            own = self.masker.mask_update(own, n_samples)
        return own

    async def _gossip_until_done(self, train_set: set[int], role: str,
                                 leader_at_start: int | None) -> None:
        """Partial-aggregation gossip: send each aggregating node that has
        not covered the train set the aggregate of the models it lacks,
        paced per target, until the session completes (coverage or
        timeout) and no target is left; then offer the full aggregate to
        waiting peers (CFL server, SDFL leader)."""
        fanout = max(self.protocol.gossip_models_per_round, 1)
        loop = asyncio.get_event_loop()
        last_status = None
        last_change_t = loop.time()
        deadline = loop.time() + self.session.timeout_s
        gossip_sent: dict[int, tuple[frozenset, float]] = {}
        # CFL/SDFL: only the round's leader fuses; DFL: every train-set
        # node with an aggregating role
        if self.federation in ("CFL", "SDFL"):
            aggregators = ({leader_at_start} if leader_at_start is not None
                           else set())
        else:
            aggregators = {
                i for i in train_set
                if self.peer_roles.get(i, "aggregator")
                in ("aggregator", "server")}
        while True:
            done = self.session.check_and_run()
            proxies = [p for i, p in self.peers.items()
                       if self.peer_roles.get(i) == "proxy"]
            live = set(self.membership.get_nodes())
            # async: a peer whose coverage meets the quorum its session
            # closes on is no target (full coverage is out of reach once
            # a voted member crashed mid-round)
            quorum = (self.session.quorum() if self.session.async_mode
                      else None)

            def stale(has: set[int]) -> bool:
                if train_set <= has:
                    return False
                return quorum is None or len(has & train_set) < quorum

            targets = [
                (i, self._aggregated_by(i))
                for i in sorted((aggregators - {self.idx}) & live)
                if stale(self._aggregated_by(i))
                and (i in self.peers or proxies)
            ]
            if (done and not targets) or loop.time() > deadline:
                break
            random.shuffle(targets)
            for i, has in targets[:fanout]:
                now = loop.time()
                key = frozenset(has)
                prev = gossip_sent.get(i)
                if (prev is not None and prev[0] == key
                        and now - prev[1] < max(self.gossip_period_s * 4, 0.5)):
                    continue
                partial = self.session.get_partial_aggregation(has)
                if partial is None:
                    continue
                gossip_sent[i] = (key, now)
                params, contribs, weight = partial
                # no direct link: the proxies relay it
                await self._send_params(
                    self.peers[i] if i in self.peers else proxies,
                    params, contribs, weight)
            # convergence exit: after gossip_exit_on_equal_rounds quiet
            # seconds stop sending; the session still completes by
            # coverage or timeout
            status = (self.session.covered,
                      tuple((i, tuple(sorted(h))) for i, h in sorted(targets)))
            now = loop.time()
            if status != last_status:
                last_status, last_change_t = status, now
            if (self.protocol.gossip_exit_on_equal_rounds > 0
                    and now - last_change_t
                    >= self.protocol.gossip_exit_on_equal_rounds):
                while not self.session.check_and_run():
                    await asyncio.sleep(self.gossip_period_s)
                break
            await asyncio.sleep(self.gossip_period_s)
        if self.session.result is not None and (
            role == "server"
            or (leader_at_start == self.idx and role == "aggregator")
        ):
            params, contribs = self.session.result
            await self._send_params(list(self.peers.values()), params,
                                    contribs or tuple(sorted(train_set)), 1,
                                    aggregated=True)

    async def _wait_done(self) -> None:
        """Wait for the adopted aggregate, bounded by the timeout (then
        the local params stand)."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.session.timeout_s
        while not self.session.done.is_set() and loop.time() <= deadline:
            await asyncio.sleep(self.gossip_period_s)

    async def _wait_neighbors_ready(self) -> None:
        """The round barrier: every alive node heard of reports this
        round (MODELS_READY floods), bounded by the timeout. In async
        mode the barrier waits for the session's quorum share of them
        only; the stragglers catch up through the stale fold."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.session.timeout_s
        frac = self.session.min_received
        while loop.time() < deadline:
            alive = set(self.membership.get_nodes())
            known = set(self.peers) | set(self.progress)
            others = [i for i in alive & known if i != self.idx]
            behind = [i for i in others
                      if self._progress(i).ready_round < self.round]
            if not behind:
                return
            if self.session.async_mode and others:
                need = max(1, math.ceil(frac * len(others)))
                if len(others) - len(behind) >= need:
                    return
            await asyncio.sleep(self.gossip_period_s)

