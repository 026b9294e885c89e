"""The safe wire envelope for model parameters (P2TP).

The counterpart of ``p2pfl_tpu/core/serialize.py``, byte for byte:

    header ">4sHII" (magic "P2TP", version, contributor count, CRC32)
    | contributors (">I" each) | flax msgpack body

The body is ``{"p": params, "w": int64 weight}`` in flax's msgpack
(v1, f32 and every other leaf as it is), or v2 with a reduced wire
precision: ``"d"`` names it (``"bf16"`` or ``"int8"``), ``"dt"`` lists
each leaf's own dtype in flatten order, and int8 adds the per-leaf
scales under ``"s"``. The CRC covers the contributors and the body.
Flatten order is JAX's: dict keys sorted.

The port writes flax's bytes through its own codec
(``utils/msgpack_codec.py``); a bfloat16 leaf travels as its 16-bit
words (``BF16Array``). Host trees are nested dicts of numpy arrays; a
torch tensor leaf is copied to the host first. Decoding never executes
code, and a decoded leaf views the received buffer until
``ParamsPayload.release`` or ``own_params`` copies it.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Any, Callable

import numpy as np
import torch

from p2pfl_tpu_torch.utils.msgpack_codec import BF16Array, restore, serialize

_MAGIC = b"P2TP"
_VERSION = 1  # the full-precision envelope
_VERSION_QUANT = 2  # a reduced wire precision ("d", "dt", int8's "s")
_HEADER = struct.Struct(">4sHII")

#: wire precisions ``encode_parameters`` can ship (config.wire_dtype)
WIRE_DTYPES = ("f32", "bf16", "int8")


class DecodingParamsError(Exception):
    """Raised when a payload cannot be decoded."""


class ModelNotMatchingError(Exception):
    """Raised when decoded params don't match the local model template."""


# ---- trees of host arrays ------------------------------------------------

def tree_leaves_sorted(tree: Any) -> list:
    """Leaves in JAX's flatten order (dict keys sorted, None empty)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves_sorted(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves_sorted(item)]
    if tree is None:
        return []
    return [tree]


def tree_map_sorted(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map`` over nested dicts, lists and tuples: the result's
    dicts have sorted keys; ``rest`` is looked up by key."""
    if isinstance(tree, dict):
        return {k: tree_map_sorted(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_sorted(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten_sorted(like: Any, leaves: list) -> Any:
    """Inverse of :func:`tree_leaves_sorted` with ``like``'s structure."""
    it = iter(leaves)
    return tree_map_sorted(lambda _: next(it), like)


def _structure(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` without the ``PyTreeDef``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _leaves_with_path(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """``tree_flatten_with_path`` with ``keystr`` paths."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in _leaves_with_path(t, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def to_host(leaf: Any) -> np.ndarray:
    """A leaf as a host array: a tensor is copied off its device (bf16 as
    a ``BF16Array`` of its words); an array passes through."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16Array)
        return t.numpy()
    return leaf if isinstance(leaf, np.ndarray) else np.asarray(leaf)


def from_host(a: Any) -> torch.Tensor:
    """A host array as a CPU tensor owning its memory (a bf16 leaf as
    ``torch.bfloat16``)."""
    arr = np.asarray(a)
    if _is_bf16(a if isinstance(a, np.ndarray) else arr):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _is_bf16(a: np.ndarray) -> bool:
    return isinstance(a, BF16Array) or a.dtype.name == "bfloat16"


def _is_float(a: np.ndarray) -> bool:
    return _is_bf16(a) or np.issubdtype(a.dtype, np.floating)


def dtype_name(a: np.ndarray) -> str:
    """``str(a.dtype)`` as the JAX package writes it ("bfloat16" for a
    bf16 leaf)."""
    return "bfloat16" if _is_bf16(a) else str(a.dtype)


def _bf16_words(a: np.ndarray) -> np.ndarray:
    """The uint16 words of a bf16 leaf (a ``BF16Array`` or an
    ``ml_dtypes`` array)."""
    return np.asarray(a).view(np.uint16)


def to_bf16(a: np.ndarray) -> BF16Array:
    """``a`` rounded to bfloat16 (to nearest even), as its words."""
    if _is_bf16(a):
        return _bf16_words(a).view(BF16Array)
    f = np.ascontiguousarray(a, np.float32)
    if not f.flags.writeable:  # a view of a received buffer
        f = f.copy()
    return (torch.from_numpy(f).to(torch.bfloat16).view(torch.int16).numpy()
            .view(np.uint16).view(BF16Array))


def widen_bf16(a: np.ndarray) -> np.ndarray:
    """A bf16 leaf's exact float32 values."""
    words = _bf16_words(a).astype(np.uint32) << 16
    return words.view(np.float32)


def astype(a: np.ndarray, name: str) -> np.ndarray:
    """``np.asarray(a).astype(np.dtype(name))`` with bfloat16 on either
    side."""
    if name == "bfloat16":
        return to_bf16(a).copy().view(BF16Array)
    if _is_bf16(a):
        return widen_bf16(a).astype(np.dtype(name))
    return np.asarray(a).astype(np.dtype(name))


def as_f32(a: np.ndarray) -> np.ndarray:
    """A leaf's values in float32 (bf16 words widened exactly)."""
    return widen_bf16(a) if _is_bf16(a) else np.asarray(a).astype(np.float32)


# ---- int8 ----------------------------------------------------------------

def quantize_int8(params: Any) -> tuple[Any, list[float]]:
    """Symmetric per-leaf int8 quantization of the floating leaves; one
    scale per leaf in flatten order, 0.0 for a non-float leaf (passed
    through)."""
    q, scales = [], []
    for leaf in tree_leaves_sorted(params):
        a = to_host(leaf)
        if _is_float(a):
            f = as_f32(a)
            scale = float(np.max(np.abs(f)) / 127.0) if f.size else 0.0
            if scale == 0.0:
                scale = 1.0
            q.append(np.clip(np.rint(f / scale), -127, 127).astype(np.int8))
            scales.append(scale)
        else:
            q.append(a)
            scales.append(0.0)
    return tree_unflatten_sorted(params, q), scales


def dequantize_int8(params: Any, scales: list[float]) -> Any:
    """Inverse of :func:`quantize_int8`: int8 leaves back to float32."""
    out = [np.asarray(leaf).astype(np.float32) * np.float32(s) if s else leaf
           for leaf, s in zip(tree_leaves_sorted(params), scales)]
    return tree_unflatten_sorted(params, out)


# ---- the envelope ----------------------------------------------------------

@dataclasses.dataclass
class ParamsPayload:
    """What moves between federated nodes: the params, the node indices
    folded into them and the sample count behind them. ``_source`` is
    the wire blob the leaves view; ``release()`` copies them off it."""

    params: Any
    contributors: tuple[int, ...] = ()
    weight: int = 1
    _source: Any = dataclasses.field(default=None, repr=False, compare=False)

    def release(self) -> "ParamsPayload":
        """Replace every leaf that views the wire blob by an owning copy
        and drop the blob; returns self."""
        self.params = own_params(self.params)
        self._source = None
        return self


def own_params(params: Any) -> Any:
    """``params`` with every non-owning leaf copied; owning leaves pass
    through."""

    def leaf(a):
        arr = a if isinstance(a, np.ndarray) else np.asarray(a)
        if arr.flags.owndata and arr.base is None:
            return a
        return arr.copy()

    return tree_map_sorted(leaf, params)


def encode_parameters(params: Any, contributors: tuple[int, ...] = (),
                      weight: int = 1,
                      wire_dtype: str | None = None) -> bytes:
    """The envelope of ``params``: v1 for ``wire_dtype`` None or "f32",
    v2 for "bf16" (floating leaves rounded to bfloat16) and "int8"
    (quantized with per-leaf scales)."""
    host = tree_map_sorted(to_host, params)
    if wire_dtype in (None, "f32"):
        version = _VERSION
        body = serialize({"p": host, "w": np.int64(weight)})
    elif wire_dtype == "bf16":
        version = _VERSION_QUANT
        dts = [dtype_name(a) for a in tree_leaves_sorted(host)]
        wire = tree_map_sorted(lambda a: to_bf16(a) if _is_float(a) else a,
                               host)
        body = serialize({"p": wire, "w": np.int64(weight), "d": "bf16",
                          "dt": dts})
    elif wire_dtype == "int8":
        version = _VERSION_QUANT
        dts = [dtype_name(a) for a in tree_leaves_sorted(host)]
        wire, scales = quantize_int8(host)
        body = serialize({"p": wire, "w": np.int64(weight), "d": "int8",
                          "dt": dts, "s": np.asarray(scales, np.float32)})
    else:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; have {WIRE_DTYPES}")
    contrib = struct.pack(f">{len(contributors)}I", *contributors)
    crc = zlib.crc32(contrib + body)
    return _HEADER.pack(_MAGIC, version, len(contributors), crc) + contrib + body


def decode_parameters(blob) -> ParamsPayload:
    """Decode an envelope (any bytes-like object, never copied); raises
    ``DecodingParamsError`` on any malformation."""
    try:
        mv = memoryview(blob)
        magic, version, n_contrib, crc = _HEADER.unpack_from(mv, 0)
        if magic != _MAGIC or version not in (_VERSION, _VERSION_QUANT):
            raise ValueError(f"bad magic/version {magic!r}/{version}")
        if zlib.crc32(mv[_HEADER.size:]) != crc:
            raise ValueError("payload CRC mismatch (corrupt or tampered)")
        off = _HEADER.size
        contributors = struct.unpack_from(f">{n_contrib}I", mv, off)
        off += 4 * n_contrib
        obj = restore(mv[off:])
        p = obj["p"]
        if version == _VERSION_QUANT:
            wd = obj.get("d")
            if wd == "int8":
                p = dequantize_int8(p, [float(s) for s in np.asarray(obj["s"])])
            elif wd != "bf16":
                raise ValueError(f"unknown wire dtype {wd!r} in v2 envelope")
            dts = obj["dt"]
            leaves = tree_leaves_sorted(p)
            if len(dts) != len(leaves):
                raise ValueError("wire-dtype leaf table length mismatch")
            p = tree_unflatten_sorted(
                p, [astype(leaf, dt) for leaf, dt in zip(leaves, dts)])
        return ParamsPayload(params=p, contributors=tuple(contributors),
                             weight=int(obj["w"]), _source=blob)
    except DecodingParamsError:
        raise
    except Exception as e:  # malformed struct/msgpack: never execute code
        raise DecodingParamsError(f"could not decode params payload: {e}") from e


#: JAX's dtype canonicalization with 64-bit types off
_CANONICAL = {"float64": "float32", "int64": "int32", "uint64": "uint32",
              "complex128": "complex64"}


def _leaf_dtype(a: Any) -> str:
    name = dtype_name(to_host(a))
    return _CANONICAL.get(name, name)


def check_parameters(params: Any, template: Any) -> None:
    """Validate the tree structure and each leaf's shape and dtype
    against ``template``, with the JAX package's messages."""
    got_s, want_s = _structure(params), _structure(template)
    if got_s != want_s:
        raise ModelNotMatchingError(
            f"pytree structure mismatch: got PyTreeDef({got_s}), "
            f"want PyTreeDef({want_s})")
    for (where, got), want in zip(_leaves_with_path(params),
                                  tree_leaves_sorted(template)):
        got_shape, want_shape = tuple(np.shape(got)), tuple(np.shape(want))
        if got_shape != want_shape:
            raise ModelNotMatchingError(
                f"leaf {where} shape mismatch: "
                f"got {got_shape}, want {want_shape}")
        got_dtype, want_dtype = _leaf_dtype(got), _leaf_dtype(want)
        if got_dtype != want_dtype:
            raise ModelNotMatchingError(
                f"leaf {where} dtype mismatch: "
                f"got {got_dtype}, want {want_dtype}")
