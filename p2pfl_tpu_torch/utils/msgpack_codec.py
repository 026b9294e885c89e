"""The msgpack subset that the JAX package's checkpoints are written in.

``flax.serialization.msgpack_serialize`` writes a tree of dicts with
array leaves through ``msgpack-python``; this module reads and writes
the same bytes with neither package (the card's machine has neither):

- maps, arrays (lists and tuples), strings, bin, ints of every width,
  floats (written as float64), nil and bools, each in the smallest form
  ``msgpack.packb(..., use_bin_type=True)`` picks;
- ext 1, an ndarray: its payload is the packed ``(shape, dtype name,
  C-order bytes)``; ext 3, a numpy scalar, the same payload of a 0-d
  array. bfloat16 travels as dtype name ``"bfloat16"`` on raw 16-bit
  words: numpy has no bfloat16 of its own, so such a leaf decodes to a
  :class:`BF16Array` (a uint16 array of the words), and a
  :class:`BF16Array` or an ``ml_dtypes`` bfloat16 array encodes to it;
- :func:`serialize` / :func:`restore`: ``msgpack_serialize`` /
  ``msgpack_restore``. Dict keys are written sorted (the serializer
  copies the tree with ``jax.tree_util``, which sorts them), and an
  array leaf over ``MAX_CHUNK_SIZE`` bytes is cut into chunks of that
  many bytes as ``flax.serialization._chunk`` does
  (``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``)
  and joined again on restore.

:func:`serialize_to` streams to a file: small items are buffered,
array payloads go out as views of the arrays, and a ``default`` hook
turns other leaves (a device tensor) into arrays one at a time, so a
large tree is never held as one ``bytes`` object. Decoded arrays are
views of the input buffer: copy them before the buffer goes away.
"""

from __future__ import annotations

import io
import struct
from typing import Any, Callable

import numpy as np

#: flax's limit: an array leaf over this many bytes is chunked
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class BF16Array(np.ndarray):
    """The raw uint16 words of a bfloat16 array (``arr.view(BF16Array)``
    marks a uint16 array as such)."""


def _payload_bytes(arr: np.ndarray) -> np.ndarray:
    """``arr``'s C-order bytes as a flat uint8 view (a copy only where
    ``arr`` is not C-contiguous)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if isinstance(arr, BF16Array) else arr.dtype.name


class _Packer:
    """One msgpack stream into ``write``; large payloads bypass the
    buffer."""

    _FLUSH = 1 << 16

    def __init__(self, write: Callable[[Any], Any],
                 default: Callable[[Any], Any] | None = None,
                 tree: bool = False):
        self._write = write
        self._default = default
        self._tree = tree  # sort dict keys and chunk big leaves
        self._buf = bytearray()

    def flush(self) -> None:
        if self._buf:
            self._write(bytes(self._buf))
            self._buf.clear()

    def _raw(self, data) -> None:
        if len(data) >= self._FLUSH:
            self.flush()
            self._write(data)
        else:
            self._buf += data
            if len(self._buf) >= self._FLUSH:
                self.flush()

    def _head(self, fix: int, fix_max: int, codes: tuple[int, int, int],
              n: int) -> None:
        """A length header: the fix form below ``fix_max``, else the
        8-bit (where the kind has one), 16- or 32-bit form."""
        c8, c16, c32 = codes
        if n < fix_max:
            self._buf.append(fix | n)
        elif c8 is not None and n < 256:
            self._buf += struct.pack(">BB", c8, n)
        elif n < 65536:
            self._buf += struct.pack(">BH", c16, n)
        else:
            self._buf += struct.pack(">BI", c32, n)

    def _int(self, x: int) -> None:
        if x < -(1 << 5):
            if x < -(1 << 15):
                fmt, code = (">Bq", 0xD3) if x < -(1 << 31) else (">Bi", 0xD2)
            else:
                fmt, code = (">Bh", 0xD1) if x < -(1 << 7) else (">Bb", 0xD0)
            self._buf += struct.pack(fmt, code, x)
        elif x < (1 << 7):
            self._buf += struct.pack(">b", x)
        elif x < (1 << 16):
            fmt, code = (">BB", 0xCC) if x < (1 << 8) else (">BH", 0xCD)
            self._buf += struct.pack(fmt, code, x)
        elif x < (1 << 32):
            self._buf += struct.pack(">BI", 0xCE, x)
        elif x < (1 << 64):
            self._buf += struct.pack(">BQ", 0xCF, x)
        else:
            raise OverflowError(f"int {x} does not fit in 64 bits")

    def _str(self, s: str) -> None:
        data = s.encode("utf-8")
        self._head(0xA0, 32, (0xD9, 0xDA, 0xDB), len(data))
        self._raw(data)

    def _bin(self, data) -> None:
        data = memoryview(data).cast("B")
        self._head(0, 0, (0xC4, 0xC5, 0xC6), len(data))
        self._raw(data)

    def _ext(self, code: int, length: int) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if length in fixed:
            self._buf += struct.pack(">Bb", fixed[length], code)
        elif length < 256:
            self._buf += struct.pack(">BBb", 0xC7, length, code)
        elif length < 65536:
            self._buf += struct.pack(">BHb", 0xC8, length, code)
        else:
            self._buf += struct.pack(">BIb", 0xC9, length, code)

    def _ndarray(self, arr: np.ndarray, code: int) -> None:
        """ext ``code``: ``packb((shape, name, bytes))``, the payload
        written from the array itself."""
        data = _payload_bytes(arr)
        head = _Packer(None)
        head._head(0x90, 16, (None, 0xDC, 0xDD), 3)
        head._array(list(arr.shape))
        head._str(_dtype_name(arr))
        head._head(0, 0, (0xC4, 0xC5, 0xC6), data.nbytes)
        self._ext(code, len(head._buf) + data.nbytes)
        self._buf += head._buf
        self._raw(memoryview(data))

    def _array(self, items) -> None:
        self._head(0x90, 16, (None, 0xDC, 0xDD), len(items))
        for item in items:
            self.pack(item)

    def _map(self, d: dict) -> None:
        self._head(0x80, 16, (None, 0xDE, 0xDF), len(d))
        for k in (sorted(d) if self._tree else d):
            self.pack(k)
            self.pack(d[k], in_map=True)

    def _chunked(self, arr: np.ndarray) -> None:
        """flax's ``_chunk``: the flat array in pieces of
        ``MAX_CHUNK_SIZE`` bytes, in insertion order."""
        size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
        flat = arr.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        self._head(0x80, 16, (None, 0xDE, 0xDF), 3)
        self._str(_CHUNKED)
        self.pack(True)
        self._str("shape")
        self._head(0x80, 16, (None, 0xDE, 0xDF), arr.ndim)
        for i, d in enumerate(arr.shape):
            self._str(str(i))
            self._int(int(d))
        self._str("chunks")
        self._head(0x80, 16, (None, 0xDE, 0xDF), len(chunks))
        for i, c in enumerate(chunks):
            self._str(str(i))
            self._ndarray(c, _EXT_NDARRAY)

    def pack(self, obj: Any, in_map: bool = False) -> None:
        """Write ``obj``; ``in_map``: a map's value or the top of a tree,
        where flax chunks an array leaf."""
        if obj is None:
            self._buf.append(0xC0)
        elif obj is True or obj is False:
            self._buf.append(0xC3 if obj else 0xC2)
        elif type(obj) is int:
            self._int(obj)
        elif type(obj) is float:
            self._buf += struct.pack(">Bd", 0xCB, obj)
        elif type(obj) is str:
            self._str(obj)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            self._bin(obj)
        elif type(obj) is dict:
            self._map(obj)
        elif type(obj) in (list, tuple):
            self._array(obj)
        elif isinstance(obj, np.ndarray):
            if (self._tree and in_map
                    and obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE):
                self._chunked(obj)
            else:
                self._ndarray(obj, _EXT_NDARRAY)
        elif isinstance(obj, np.generic):
            self._ndarray(np.asarray(obj), _EXT_NPSCALAR)
        elif self._default is not None:
            self.pack(self._default(obj), in_map)
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__!r}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` with flax's ext types
    for ndarrays and numpy scalars; dict keys in their own order."""
    out = io.BytesIO()
    p = _Packer(out.write)
    p.pack(obj, in_map=False)
    p.flush()
    return out.getvalue()


def serialize_to(tree: Any, write: Callable[[Any], Any],
                 default: Callable[[Any], Any] | None = None) -> None:
    """:func:`serialize` into ``write`` (a file's ``write``), leaf by
    leaf; ``default(leaf)`` turns a leaf of another type into one this
    module writes (an ndarray), as msgpack's ``default`` does."""
    p = _Packer(write, default, tree=True)
    p.pack(tree, in_map=True)  # flax chunks a top-level array too
    p.flush()


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out = io.BytesIO()
    serialize_to(tree, out.write)
    return out.getvalue()


class _Unpacker:
    """A msgpack reader over one buffer; ``views`` returns bin as views
    of the buffer (ext payloads) instead of ``bytes``."""

    def __init__(self, data, views: bool = False):
        self._mv = memoryview(data).cast("B")
        self._pos = 0
        self._views = views

    def _take(self, n: int) -> memoryview:
        start = self._pos
        self._pos += n
        if self._pos > len(self._mv):
            raise ValueError(
                f"msgpack data ends early: needs {self._pos} bytes, has "
                f"{len(self._mv)}")
        return self._mv[start:self._pos]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _bytes(self, n: int):
        mv = self._take(n)
        return mv if self._views else mv.tobytes()

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, name, data = _Unpacker(payload, views=True).unpack()
        if name == "bfloat16":
            arr = np.frombuffer(data, np.uint16).view(BF16Array)
        else:
            arr = np.frombuffer(data, np.dtype(name))
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def unpack(self):
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).tobytes().decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self._bytes(self._unpack((">B", ">H", ">I")[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack((">B", ">H", ">I")[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self._unpack(
                (">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self._unpack((">B", ">H", ">I")[b - 0xD9])
            return self._take(n).tobytes().decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.unpack() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out

    def unpack_all(self):
        obj = self.unpack()
        if self._pos != len(self._mv):
            raise ValueError(
                f"{len(self._mv) - self._pos} bytes of extra data after "
                "the msgpack object")
        return obj


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)`` with flax's ext hook:
    ndarrays (views of ``data``) and numpy scalars."""
    return _Unpacker(data).unpack_all()


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    flat = np.concatenate([np.asarray(c) for c in chunks])
    if isinstance(chunks[0], BF16Array):
        flat = flat.view(BF16Array)
    return flat.reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place`` (dicts only)."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_tree(v)
    return d


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore(data)``: chunked leaves
    joined, other arrays views of ``data``."""
    return _unchunk_tree(unpackb(data))
