"""The socket plane's wire protocol: P2W2 frames.

The counterpart of ``p2pfl_tpu/p2p/protocol.py``, byte for byte::

    magic "P2W2" | >I header length | msgpack header | payload bytes

The header is the map ``{"v", "t", "s", "b", "i", "g", "c", "pl",
"ph"}`` (wire version, message type, sender, body, message id, origin
signature, certificate, payload length and digest), packed as
``msgpack.packb(..., use_bin_type=True)`` packs it, through the port's
own codec. The payload (a PARAMS envelope from ``core/serialize.py``)
rides after the header as its own segment, never copied on the send
path. A frame of another wire version, an oversized header or payload,
and garbage raise ``ValueError``.

Gossiped types carry a random ``msg_id``; a receiver keeps a bounded
ring of the ids it has seen (``DedupRing``).

Under TLS a node signs the frames it originates (``p2p/tls.py``): the
signature covers ``Message.signing_bytes()``, which holds the payload
through its SHA-256 (``payload_digest``, computed once a message), and
relays keep the origin's signature and certificate. A verifier always
hashes the payload it received: the header's digest seeds the cache of
unsigned frames only. ``read_message(reader, slot_sink)`` can land a
PARAMS payload straight in a shared-memory slot of the aggregation
sidecar (``p2p/aggd.py``) instead of a heap ``bytes``. The causal trace
context (the header's ``tc``) is A23: it is never written, and a frame
that carries one is read without it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import hashlib
import secrets
import struct
from collections import OrderedDict
from typing import Any

from p2pfl_tpu_torch.utils.msgpack_codec import packb, unpackb

_LEN = struct.Struct(">I")
WIRE_MAGIC = b"P2W2"
WIRE_VERSION = 2
MAX_FRAME = 1 << 30  # a payload is at most one model blob
MAX_HEADER = 1 << 24


class MsgType(enum.Enum):
    # gossiped control messages (flooded, deduped by msg_id)
    BEAT = "beat"
    ROLE = "role"
    START_LEARNING = "start_learning"
    STOP_LEARNING = "stop_learning"
    VOTE_TRAIN_SET = "vote_train_set"
    METRICS = "metrics"
    TRANSFER_LEADERSHIP = "transfer_leadership"
    MODELS_READY = "models_ready"
    MODELS_AGGREGATED = "models_aggregated"
    MODEL_INITIALIZED = "model_initialized"
    STOP = "stop"
    # a survivor's reveal of its round seed against an evicted member
    SECAGG_SHARE = "secagg_share"
    # direct messages
    CONNECT = "connect"
    PARAMS = "params"
    STATE_SYNC = "state_sync"  # the live join: a joiner adopts the model


GOSSIPED = frozenset({
    MsgType.BEAT, MsgType.ROLE, MsgType.START_LEARNING,
    MsgType.STOP_LEARNING, MsgType.VOTE_TRAIN_SET, MsgType.METRICS,
    MsgType.TRANSFER_LEADERSHIP, MsgType.MODELS_READY,
    MsgType.MODELS_AGGREGATED, MsgType.MODEL_INITIALIZED, MsgType.STOP,
    MsgType.SECAGG_SHARE,
})

#: floods re-sent periodically: on a declared full mesh their relay may
#: be damped (a lost copy is replaced by the next beat)
PERIODIC_FLOODS = frozenset({MsgType.BEAT, MsgType.ROLE})


@dataclasses.dataclass
class Message:
    """One frame: ``sender`` is the originating node's index, ``body``
    msgpack-able metadata, ``payload`` a binary blob (PARAMS)."""

    type: MsgType
    sender: int
    body: dict[str, Any] = dataclasses.field(default_factory=dict)
    payload: bytes = b""
    msg_id: str = ""
    sig: bytes = b""
    cert: bytes = b""
    # the framed header, built once for every peer a frame goes to (a
    # received frame keeps the bytes it arrived with)
    _head: bytes | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # the payload's SHA-256, computed at most once a message (the signer
    # fills it; a verifier recomputes it from the bytes it received)
    _payload_digest: bytes | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # the frame's size on the wire, stamped by read_message
    _wire_bytes: int = dataclasses.field(default=0, repr=False, compare=False)
    # a payload read_message's slot sink diverted into a shared-memory
    # slot: ``payload`` is empty and these name the leased slot and the
    # payload's length in it (the receiver owns the lease)
    _slot: int | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _slot_len: int = dataclasses.field(default=0, repr=False, compare=False)

    def __post_init__(self):
        if not self.msg_id and self.type in GOSSIPED:
            self.msg_id = secrets.token_hex(8)

    def payload_digest(self) -> bytes:
        """The payload's SHA-256, computed once (empty without a
        payload)."""
        if not self.payload:
            return b""
        if self._payload_digest is None:
            self._payload_digest = hashlib.sha256(self.payload).digest()
        return self._payload_digest

    def signing_bytes(self) -> bytes:
        """The bytes an origin signature covers: the msgpack map of
        type, sender, body, payload digest and message id, in that order
        (the JAX package's bytes). A verifier calls it only with a digest
        of the payload it received."""
        return packb({
            "t": self.type.value,
            "s": self.sender,
            "b": self.body,
            "ph": self.payload_digest(),
            "i": self.msg_id,
        })

    def wire_segments(self) -> list:
        """The frame as writev-ready segments: the framed header, and a
        view of the payload object itself when there is one."""
        if self._head is None:
            ph = self._payload_digest
            if ph is None and self.sig:
                ph = self.payload_digest()  # a signed frame's digest
            header = packb({
                "v": WIRE_VERSION,
                "t": self.type.value,
                "s": self.sender,
                "b": self.body,
                "i": self.msg_id,
                "g": self.sig,
                "c": self.cert,
                "pl": len(self.payload),
                "ph": ph or b"",
            })
            if len(header) > MAX_HEADER:
                raise ValueError(f"header too large: {len(header)} bytes")
            if len(self.payload) > MAX_FRAME:
                raise ValueError(
                    f"payload too large: {len(self.payload)} bytes")
            self._head = WIRE_MAGIC + _LEN.pack(len(header)) + header
        if not self.payload:
            return [self._head]
        return [self._head, memoryview(self.payload)]

    def encode(self) -> bytes:
        """The whole frame as one bytes object (tests and diagnostics;
        the send path writes ``wire_segments()``)."""
        return b"".join(self.wire_segments())

    def wire_size(self) -> int:
        if self._head is None:
            self.wire_segments()
        return len(self._head) + len(self.payload)

    @staticmethod
    def _from_header(obj: dict, payload: bytes) -> "Message":
        if obj.get("v") != WIRE_VERSION:
            raise ValueError(
                f"unsupported wire version {obj.get('v')!r} "
                f"(this node speaks v{WIRE_VERSION})")
        try:
            msg = Message(
                type=MsgType(obj["t"]),
                sender=int(obj["s"]),
                body=obj.get("b", {}),
                payload=payload,
                msg_id=obj.get("i", ""),
                sig=obj.get("g", b""),
                cert=obj.get("c", b""),
            )
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed frame header: {e!r}") from e
        # the header's digest seeds the cache of an unsigned frame only:
        # a signed frame's digest is recomputed from the payload, or a
        # relay could swap the payload under a valid signature
        ph = obj.get("ph", b"")
        if ph and payload and not msg.sig:
            msg._payload_digest = ph
        return msg

    @staticmethod
    def decode(frame: bytes) -> "Message":
        """Parse one whole frame (as ``encode`` gives it)."""
        mv = memoryview(frame)
        if bytes(mv[:len(WIRE_MAGIC)]) != WIRE_MAGIC:
            raise ValueError(
                "unrecognized wire preamble (legacy v1 or foreign frame)")
        off = len(WIRE_MAGIC)
        (hlen,) = _LEN.unpack_from(mv, off)
        off += _LEN.size
        if hlen > MAX_HEADER:
            raise ValueError(f"oversized header: {hlen}")
        obj = _header(mv[off:off + hlen])
        off += hlen
        pl = int(obj.get("pl", 0))
        if pl < 0 or pl > MAX_FRAME or off + pl > len(frame):
            raise ValueError(f"bad payload length: {pl}")
        payload = bytes(mv[off:off + pl]) if pl else b""
        msg = Message._from_header(obj, payload)
        msg._head = bytes(mv[:off])
        return msg


#: decoded control headers by their bytes: a flooded frame reaches a node
#: from up to ``gossip_fanout`` relays, and every node of an in-process
#: federation decodes it, always to the same map. Decoded headers are
#: read, never changed.
_HEADERS: OrderedDict[bytes, dict] = OrderedDict()
_HEADERS_MAX = 1 << 13
_HEADER_CACHED_BYTES = 1 << 12


def _header(data) -> dict:
    if type(data) is bytes:
        hit = _HEADERS.get(data)
        if hit is not None:
            return hit
    obj = _decode_header(data)
    if type(data) is bytes and len(data) <= _HEADER_CACHED_BYTES:
        _HEADERS[data] = obj
        if len(_HEADERS) > _HEADERS_MAX:
            _HEADERS.popitem(last=False)
    return obj


def _decode_header(data) -> dict:
    try:
        obj = unpackb(data)
    except ValueError:
        raise
    except Exception as e:  # a malformed header never escapes as another type
        raise ValueError(f"malformed frame header: {e!r}") from e
    if not isinstance(obj, dict):
        raise ValueError(f"frame header is not a map: {type(obj).__name__}")
    return obj


async def write_message(writer: asyncio.StreamWriter, msg: Message) -> None:
    """Frame ``msg`` onto the stream (the payload is not copied)."""
    writer.writelines(msg.wire_segments())
    await writer.drain()


#: ``_read_into``'s chunk when the reader's buffer is empty: bounds the
#: transient copies the public StreamReader API makes
_INTO_CHUNK = 1 << 18


async def _read_into(reader: asyncio.StreamReader, mv: memoryview,
                     n: int) -> None:
    """Land exactly ``n`` stream bytes in ``mv`` without an n-byte heap
    object: the reader's internal buffer is copied out directly while it
    holds data (``_buffer``, a bytearray in CPython; another reader takes
    the fallback), else bounded ``read()`` chunks."""
    buf = getattr(reader, "_buffer", None)
    resume = getattr(reader, "_maybe_resume_transport", None)
    got = 0
    while got < n:
        if isinstance(buf, bytearray) and len(buf):
            take = min(len(buf), n - got)
            with memoryview(buf) as bmv:
                mv[got:got + take] = bmv[:take]
            del buf[:take]
            if resume is not None:
                resume()
            got += take
            continue
        chunk = await reader.read(min(n - got, _INTO_CHUNK))
        if not chunk:
            raise asyncio.IncompleteReadError(bytes(mv[:got]), n)
        mv[got:got + len(chunk)] = chunk
        got += len(chunk)


async def read_message(reader: asyncio.StreamReader,
                       slot_sink=None) -> Message:
    """Read one frame; ``IncompleteReadError`` at EOF, ``ValueError`` on
    another wire version or a bogus length.

    ``slot_sink(header, payload_len)``, when given, is asked once the
    header is read: a ``(slot, memoryview, release)`` answer diverts the
    payload into that view, and the message carries ``_slot`` and
    ``_slot_len`` with an empty ``payload`` (a failed read calls
    ``release(slot)`` before it raises); None keeps the heap path."""
    pre = await reader.readexactly(len(WIRE_MAGIC) + _LEN.size)
    if pre[:len(WIRE_MAGIC)] != WIRE_MAGIC:
        raise ValueError(
            f"unrecognized wire preamble {pre[:4]!r}: peer speaks a "
            f"different wire version (v1 frames are refused, not parsed)")
    (hlen,) = _LEN.unpack_from(pre, len(WIRE_MAGIC))
    if hlen > MAX_HEADER:
        raise ValueError(f"peer announced oversized header: {hlen}")
    header = await reader.readexactly(hlen)
    obj = _header(header)
    pl = int(obj.get("pl", 0))
    if pl < 0 or pl > MAX_FRAME:
        raise ValueError(f"peer announced bad payload length: {pl}")
    if pl and slot_sink is not None:
        lease = slot_sink(obj, pl)
        if lease is not None:
            slot, dst, on_error = lease
            try:
                await _read_into(reader, dst, pl)
            except BaseException:
                on_error(slot)
                raise
            msg = Message._from_header(obj, b"")
            msg._slot = slot
            msg._slot_len = pl
            msg._wire_bytes = len(pre) + hlen + pl
            return msg
    # the one host-side copy of the payload on the receive path
    payload = await reader.readexactly(pl) if pl else b""
    msg = Message._from_header(obj, payload)
    # a relay sends the frame's own header bytes on (packing the decoded
    # map again gives the same bytes)
    msg._head = pre + header
    msg._wire_bytes = len(pre) + hlen + pl
    return msg


class DedupRing:
    """Bounded set of seen gossip msg_ids."""

    def __init__(self, capacity: int = 100):
        self.capacity = capacity
        self._seen: OrderedDict[str, None] = OrderedDict()

    def seen(self, msg_id: str) -> bool:
        return not msg_id or msg_id in self._seen

    def check_and_add(self, msg_id: str) -> bool:
        """True if the id is new (the message should be processed)."""
        if self.seen(msg_id):
            return False
        self._seen[msg_id] = None
        while len(self._seen) > self.capacity:
            self._seen.popitem(last=False)
        return True
