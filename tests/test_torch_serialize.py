"""The port's P2TP envelope against the JAX package's, on the CPU.

- f32 (v1), bf16 and int8 (v2) envelopes of the mnist-mlp and
  FEMNIST-CNN trees, with contributors and a weight, equal the JAX
  package's bytes exactly, and each side decodes the other's bytes to
  the same bits (tolerance 0), dtypes restored;
- bf16 params (the JAX package's ml_dtypes leaves, the port's
  ``BF16Array`` words) give the same bytes on every wire;
- garbage, a pickle, a truncated body, a bit flip and a future version
  raise ``DecodingParamsError`` as in ``tests/test_serialize.py``;
- ``check_parameters`` raises ``ModelNotMatchingError`` with the JAX
  package's messages, and ``own_params`` / ``release`` copy views of
  the received buffer.
"""

from __future__ import annotations

import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from p2pfl_tpu.core import serialize as J
from p2pfl_tpu.models import get_model
from p2pfl_tpu_torch.core import serialize as T
from p2pfl_tpu_torch.utils.msgpack_codec import BF16Array

WIRES = (None, "f32", "bf16", "int8")


def _jax_tree(name: str, seed: int = 0) -> dict:
    x = np.zeros((1, 28, 28, 1), np.float32)
    params = get_model(name).init(jax.random.PRNGKey(seed), x)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def trees() -> dict:
    return {name: _jax_tree(name) for name in ("mnist-mlp", "femnist-cnn")}


def _same_leaves(a, b) -> None:
    la, lb = jax.tree.leaves(a), T.tree_leaves_sorted(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = np.asarray(x)
        assert T.dtype_name(x) == T.dtype_name(y)
        if T.dtype_name(x) == "bfloat16":
            x, y = x.view(np.uint16), np.asarray(y).view(np.uint16)
        np.testing.assert_array_equal(x, y)  # tolerance 0


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("name", ["mnist-mlp", "femnist-cnn"])
def test_envelopes_byte_identical_and_cross_decode(trees, name, wire):
    params = trees[name]
    contributors, weight = (5, 0, 3), 1234
    blob_j = J.encode_parameters(params, contributors, weight, wire_dtype=wire)
    blob_t = T.encode_parameters(params, contributors, weight, wire_dtype=wire)
    assert blob_t == blob_j
    from_j = T.decode_parameters(blob_j)
    from_t = J.decode_parameters(blob_t)
    assert from_j.contributors == from_t.contributors == contributors
    assert from_j.weight == from_t.weight == weight
    _same_leaves(from_t.params, from_j.params)
    if wire in (None, "f32"):
        _same_leaves(params, from_j.params)


def test_torch_tensor_leaves_encode_like_arrays(trees):
    import torch

    params = trees["mnist-mlp"]
    tensors = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    for wire in WIRES:
        assert (T.encode_parameters(tensors, (1,), 7, wire_dtype=wire)
                == J.encode_parameters(params, (1,), 7, wire_dtype=wire))


@pytest.mark.parametrize("wire", WIRES)
def test_bf16_params_byte_identical(trees, wire):
    jparams = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                           trees["mnist-mlp"])
    tparams = jax.tree.map(lambda a: a.view(np.uint16).view(BF16Array),
                           jparams)
    blob_j = J.encode_parameters(jparams, (), 3, wire_dtype=wire)
    assert T.encode_parameters(tparams, (), 3, wire_dtype=wire) == blob_j
    got = T.decode_parameters(blob_j).params
    assert all(isinstance(x, BF16Array) for x in T.tree_leaves_sorted(got))
    _same_leaves(J.decode_parameters(blob_j).params, got)


def test_int8_keeps_non_float_leaves():
    tree = {"dense": {"kernel": np.arange(12.0, dtype=np.float32).reshape(4, 3),
                      "bias": np.ones(3, np.float32)},
            "step": np.asarray(7, np.int32)}
    blob = T.encode_parameters(tree, wire_dtype="int8")
    assert blob == J.encode_parameters(tree, wire_dtype="int8")
    out = T.decode_parameters(blob).params
    assert out["step"].dtype == np.int32 and int(out["step"]) == 7
    q, scales = T.quantize_int8(tree)
    jq, jscales = J.quantize_int8(tree)
    assert scales == jscales
    _same_leaves(jq, q)


def test_malformed_payloads_rejected():
    tree = {"dense": {"kernel": np.arange(12.0, dtype=np.float32).reshape(4, 3)}}
    with pytest.raises(T.DecodingParamsError):
        T.decode_parameters(pickle.dumps(([np.zeros(3)], None, 1)))
    with pytest.raises(T.DecodingParamsError):
        T.decode_parameters(b"short")
    blob = T.encode_parameters(tree, (1,), 7)
    with pytest.raises(T.DecodingParamsError):
        T.decode_parameters(blob[:-10])
    flipped = bytearray(blob)
    flipped[14] ^= 0xFF
    with pytest.raises(T.DecodingParamsError, match="CRC"):
        T.decode_parameters(bytes(flipped))
    future = bytearray(blob)
    struct.pack_into(">H", future, 4, 99)
    with pytest.raises(T.DecodingParamsError, match="version"):
        T.decode_parameters(bytes(future))
    with pytest.raises(ValueError, match="wire_dtype"):
        T.encode_parameters(tree, wire_dtype="fp4")


def _message(module, params, template) -> str:
    with pytest.raises(module.ModelNotMatchingError) as e:
        module.check_parameters(params, template)
    return str(e.value)


@pytest.mark.parametrize("case", ["structure", "shape", "dtype", "scalar"])
def test_check_parameters_messages_match_jax(case):
    f32 = np.float32
    template = {"params": {"b": {"kernel": np.zeros((2, 3), f32),
                                 "bias": np.zeros(3, f32)},
                           "a": np.zeros(1, f32)}}
    bad = {
        "structure": {"params": {"b": {"kernel": np.zeros((2, 3), f32)},
                                 "a": np.zeros(1, f32)}},
        "shape": {"params": {"b": {"kernel": np.zeros((2, 4), f32),
                                   "bias": np.zeros(3, f32)},
                             "a": np.zeros(1, f32)}},
        "dtype": {"params": {"b": {"kernel": np.zeros((2, 3), np.float64),
                                   "bias": np.zeros(3, np.int32)},
                             "a": np.zeros(1, f32)}},
        "scalar": {"params": {"b": {"kernel": np.zeros((2, 3), f32),
                                    "bias": np.zeros(3, f32)},
                              "a": f32(0)}},
    }[case]
    assert _message(T, bad, template) == _message(J, bad, template)
    T.check_parameters(template, template)


def test_decoded_leaves_view_the_blob_until_released():
    tree = {"w": np.arange(6.0, dtype=np.float32)}
    blob = T.encode_parameters(tree, (2,), 9)
    payload = T.decode_parameters(blob)
    assert payload._source is blob
    assert not payload.params["w"].flags.owndata
    payload.release()
    assert payload._source is None
    assert payload.params["w"].flags.owndata
    np.testing.assert_array_equal(payload.params["w"], tree["w"])
    owned = {"w": np.ones(2, np.float32)}
    assert T.own_params(owned)["w"] is owned["w"]
