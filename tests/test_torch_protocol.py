"""The port's P2W2 frames against the JAX package's, on the CPU.

- A frame of every ``MsgType``, with bodies of every value kind (maps,
  strings, ints of every width, negative ints, float64, bool, nil,
  bin, nested arrays), with and without a payload, equals the JAX
  package's bytes exactly; each side decodes the other's frame, and the
  stream reader reads it;
- the port's ``msgpack_codec.packb`` equals ``msgpack.packb(...,
  use_bin_type=True)`` (the smallest int form included) and ``unpackb``
  inverts it;
- a v1 frame, a foreign preamble, an oversized header or payload, a
  truncated stream and a non-map header raise ``ValueError`` (or
  ``IncompleteReadError`` at EOF), as in ``tests/test_p2p.py``;
- the dedup ring keeps at most its capacity.
"""

from __future__ import annotations

import asyncio
import struct

import msgpack
import pytest

from p2pfl_tpu.p2p import protocol as J
from p2pfl_tpu_torch.p2p import protocol as T
from p2pfl_tpu_torch.utils import msgpack_codec

BODY = {
    "round": 3, "contributors": [0, 5, 255, 256, 65535, 65536, 2**32],
    "neg": [-1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1],
    "loss": 0.1234567890123, "accuracy": 1.0, "ok": True, "no": False,
    "nil": None, "bin": b"\x00\x01\xff" * 40, "name": "x" * 40,
    "nested": {"a": [1, [2, {"b": "c"}]], "big": 2**63 - 1},
}


def _frames(module, payload: bytes):
    for t in module.MsgType:
        body = dict(BODY) if t is not module.MsgType.BEAT else {"n": 123456}
        yield t.value, module.Message(module.MsgType(t.value), 7, body,
                                      payload=payload, msg_id="ab" * 8)


@pytest.mark.parametrize("payload", [b"", b"\x00P2TP" * 1000])
def test_every_frame_byte_identical_and_cross_decodes(payload):
    jframes = dict(_frames(J, payload))
    tframes = dict(_frames(T, payload))
    assert set(jframes) == set(tframes)
    for name, jm in jframes.items():
        wire = jm.encode()
        assert tframes[name].encode() == wire, name
        assert tframes[name].wire_size() == len(wire)
        got = T.Message.decode(wire)
        back = J.Message.decode(tframes[name].encode())
        for m in (got, back):
            assert m.type.value == name and m.sender == 7
            assert m.body == jm.body and m.payload == payload
            assert m.msg_id == "ab" * 8


def test_gossiped_types_and_msg_ids_match():
    assert {t.value for t in T.GOSSIPED} == {t.value for t in J.GOSSIPED}
    assert ({t.value for t in T.PERIODIC_FLOODS}
            == {t.value for t in J.PERIODIC_FLOODS})
    assert T.Message(T.MsgType.BEAT, 0).msg_id
    assert not T.Message(T.MsgType.PARAMS, 0).msg_id


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.5, -1e300, True, False, None, "", "a" * 31, "a" * 32, "é" * 200,
    "z" * 70000, b"", b"b" * 255, b"b" * 256, b"b" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"v": 2, "t": "params", "s": 1, "b": {"c": [1, 2], "w": 60}},
])
def test_codec_packb_equals_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_codec.packb(obj) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want, raw=False)


def _reader(data: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    return r


def test_stream_reads_the_jax_frames():
    async def main():
        frames = [m for _, m in _frames(J, b"\x07" * 4096)]
        r = _reader(b"".join(m.encode() for m in frames))
        for m in frames:
            got = await T.read_message(r)
            assert got.type.value == m.type.value and got.body == m.body
            assert got.payload == m.payload
            assert got._wire_bytes == len(m.encode())
        with pytest.raises(asyncio.IncompleteReadError):
            await T.read_message(r)

    asyncio.run(main())


def test_bad_frames_refused_loudly():
    async def read(data: bytes):
        return await T.read_message(_reader(data))

    good = T.Message(T.MsgType.PARAMS, 1, {"round": 0}, payload=b"xy").encode()
    v1 = msgpack.packb({"t": "params", "s": 1}, use_bin_type=True)
    cases = [
        struct.pack(">I", len(v1)) + v1,  # a v1 frame: a length prefix
        b"JUNK" + good[4:],
        T.WIRE_MAGIC + struct.pack(">I", T.MAX_HEADER + 1),
    ]
    for data in cases:
        with pytest.raises(ValueError):
            asyncio.run(read(data))
        with pytest.raises(ValueError):
            T.Message.decode(data)
    huge = msgpack.packb({"v": 2, "t": "params", "s": 1,
                          "pl": T.MAX_FRAME + 1}, use_bin_type=True)
    frame = T.WIRE_MAGIC + struct.pack(">I", len(huge)) + huge
    with pytest.raises(ValueError, match="payload length"):
        asyncio.run(read(frame))
    future = msgpack.packb({"v": 3, "t": "params", "s": 1},
                           use_bin_type=True)
    with pytest.raises(ValueError, match="wire version"):
        T.Message.decode(T.WIRE_MAGIC + struct.pack(">I", len(future))
                         + future)
    not_map = msgpack.packb([1, 2], use_bin_type=True)
    with pytest.raises(ValueError):
        T.Message.decode(T.WIRE_MAGIC + struct.pack(">I", len(not_map))
                         + not_map)
    with pytest.raises(asyncio.IncompleteReadError):
        asyncio.run(read(good[:-1]))
    # the JAX reader refuses what the port refuses
    with pytest.raises(ValueError):
        J.Message.decode(cases[0])


def test_write_message_sends_the_segments():
    class Writer:
        def __init__(self):
            self.parts = []

        def writelines(self, parts):
            self.parts.extend(parts)

        async def drain(self):
            pass

    payload = b"p" * 100
    m = T.Message(T.MsgType.PARAMS, 2, {"round": 1}, payload=payload)
    w = Writer()
    asyncio.run(T.write_message(w, m))
    assert b"".join(bytes(p) for p in w.parts) == m.encode()
    assert w.parts[-1].obj is payload  # the payload itself, not a copy


def test_dedup_ring_is_bounded():
    ring = T.DedupRing(capacity=3)
    assert ring.seen("")  # an id-less message counts as seen
    assert [ring.check_and_add(i) for i in "abcab"] == [True, True, True,
                                                        False, False]
    assert ring.check_and_add("d")  # evicts "a"
    assert ring.check_and_add("a")
    assert not ring.check_and_add("d")
