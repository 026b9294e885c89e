"""Round-boundary checkpoint and resume, in the JAX package's file.

The counterpart of ``p2pfl_tpu/federation/checkpoint.py``. The whole
federation state goes to one msgpack file at a round boundary, in the
bytes the JAX package writes (``utils/msgpack_codec.py`` stands in for
flax and msgpack), so each package resumes from the other's files. The
file holds flax's ``to_state_dict`` of the JAX ``FederatedState``:

- ``states.params``: the flax tree, leaves ``[n, ...]``;
- ``states.opt_state``: optax's state for the optimizer: sgd ``{"0":
  {"trace": tree}, "1": {}}``; adam ``{"0": {"count", "mu", "nu"},
  "1": {}}``, adamw the same with a third empty state (weight decay on
  sgd and adam is applied to the gradient, not by an optax state);
- ``states.rng`` ``[n, 2]`` uint32, ``states.step`` ``[n]`` int32,
  ``alive`` ``[n]`` bool, ``round`` 0-d int32, ``stale`` the staged
  exchange's ``{"0": tree, "1": weights}`` or nil.

The port's shuffle stream is one ``torch.Generator`` where JAX has a
threefry key a node, and the file keeps JAX's slot: a save draws a
64-bit seed from the generator, reseeds the generator with it and
writes it as row 0 (row i adds i to the low word, so that JAX gets
distinct keys); a load seeds a new generator from row 0, a JAX key
included. A resumed run therefore takes the batches of the run that
saved. The state remembers the slot (``FederatedState.rng_slot``), and
while its generator has drawn nothing since it was seeded from it, a
save writes that slot unchanged: a saved state saves to the same bytes
again, and a state carried over from the JAX package
(``convert.federated_state_from_jax``) writes the JAX file's bytes.

Every save and load is recorded in the flight recorder
(``checkpoint.save``, ``.load``, ``.node_save``, ``.node_load``).

Single process only: the multi-host save waits on ROADMAP item A24.
"""

from __future__ import annotations

import os
import pathlib
from typing import Any, Callable

import numpy as np
import torch

from p2pfl_tpu_torch.core.pytree import Params, tree_map
from p2pfl_tpu_torch.core.serialize import (
    from_host,
    to_host,
    tree_leaves_sorted,
    tree_map_sorted,
)
from p2pfl_tpu_torch.learning.learner import AdamState, TrainState
from p2pfl_tpu_torch.obs import flight
from p2pfl_tpu_torch.parallel.federated import FederatedState
from p2pfl_tpu_torch.utils import msgpack_codec

_SUFFIX = ".ckpt.msgpack"


def checkpoint_path(directory: str | pathlib.Path,
                    round_num: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"round_{round_num:05d}{_SUFFIX}"


def node_checkpoint_path(directory: str | pathlib.Path,
                         node_idx: int) -> pathlib.Path:
    """A socket node's private checkpoint: one file a node, replaced at
    each save, so the newest state wins and the directory never grows."""
    return pathlib.Path(directory) / f"node_{node_idx:03d}{_SUFFIX}"


def _atomic_write(path: pathlib.Path,
                  write: Callable[[Callable], None]) -> None:
    """Crash-consistent publish: ``write(f.write)`` into a tmp sibling,
    flush, fsync, ``os.replace``, then fsync the directory so the
    rename survives a power cut. A reader sees the old file or the new
    one, never a torn one."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        write(f.write)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dir_fd = os.open(path.parent, os.O_RDONLY)
    except OSError:
        return  # no directory fds here: the rename is best-effort
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _restore_blob(path: str | pathlib.Path) -> Any:
    """The file's tree (arrays are views of one buffer read from it); a
    truncated or corrupt file raises ValueError naming the file."""
    path = pathlib.Path(path)
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        got = f.readinto(buf)
    try:
        return msgpack_codec.restore(memoryview(buf)[:got])
    except Exception as e:
        raise ValueError(
            f"checkpoint {path} is truncated or corrupt ({got} bytes): "
            f"{e!r}") from e


def _host(leaf: Any) -> np.ndarray:
    """A leaf as the array the file holds (bf16 as its words); a host
    array passes through."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(msgpack_codec.BF16Array)
    return t.numpy()


def _tensor(a: Any, like: torch.Tensor, path: str) -> torch.Tensor:
    """A file leaf as a tensor owning its memory, in ``like``'s dtype and
    on its device; the shape must be ``like``'s."""
    arr = a if isinstance(a, np.ndarray) else np.asarray(a)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {path} shape {tuple(arr.shape)} "
                         f"!= expected {tuple(like.shape)}")
    bf16 = (isinstance(arr, msgpack_codec.BF16Array)
            or arr.dtype.name == "bfloat16")
    arr = np.ascontiguousarray(np.asarray(arr).view(np.int16) if bf16
                               else np.asarray(arr))
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype, copy=True)


def _conform(template: Any, obj: Any, path: str) -> Any:
    """``obj`` in the structure of ``template``: the same keys, tensor
    leaves conformed by :func:`_tensor`, array leaves (the rng slot)
    copied with their shape checked."""
    if isinstance(template, dict):
        if not isinstance(obj, dict) or set(obj) != set(template):
            have = sorted(obj) if isinstance(obj, dict) else type(obj).__name__
            raise ValueError(f"checkpoint {path or 'root'} holds {have}, "
                             f"expected {sorted(template)}")
        return {k: _conform(template[k], obj[k], f"{path}/{k}")
                for k in template}
    if template is None:
        if obj is not None:
            raise ValueError(f"checkpoint {path} holds a value where the "
                             "federation has none")
        return None
    if isinstance(template, torch.Tensor):
        return _tensor(obj, template, path)
    arr = np.array(obj, dtype=template.dtype, copy=True)
    if arr.shape != template.shape:
        raise ValueError(f"checkpoint leaf {path} shape {arr.shape} != "
                         f"expected {template.shape}")
    return arr


def _optimizer(opt_state: Any, optimizer: str | None) -> str:
    if optimizer is None:
        if isinstance(opt_state, AdamState):
            raise ValueError("an adam state's file layout depends on the "
                             "optimizer: pass optimizer='adam' or 'adamw'")
        return "sgd"
    if optimizer not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return optimizer


def _state_dict(fed: FederatedState, optimizer: str,
                rng: np.ndarray) -> dict:
    st = fed.states
    if optimizer == "sgd":
        opt = {"0": {"trace": st.opt_state}, "1": {}}
    else:
        opt = {"0": {"count": st.opt_state.count, "mu": st.opt_state.mu,
                     "nu": st.opt_state.nu}, "1": {}}
        if optimizer == "adamw":
            opt["2"] = {}
    return {
        "states": {"params": st.params, "opt_state": opt, "rng": rng,
                   "step": st.step.to(torch.int32)},
        "alive": fed.alive,
        "round": np.array(fed.round, np.int32),
        "stale": (None if fed.stale is None
                  else {"0": fed.stale[0], "1": fed.stale[1]}),
    }


def _seed(slot: np.ndarray) -> int:
    """Row 0's two words as one 64-bit seed."""
    return (int(slot[0, 0]) << 32) | int(slot[0, 1])


def generator_from_slot(slot: np.ndarray,
                        device: torch.device | str) -> torch.Generator:
    """The port's shuffle generator for an rng slot ``[n, 2]`` uint32."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(slot))
    return g


def _fresh(g: torch.Generator, seed: int) -> bool:
    """``g`` was seeded with ``seed`` and has drawn nothing since."""
    ref = torch.Generator(device=g.device)
    ref.manual_seed(seed)
    return (g.initial_seed() == seed
            and torch.equal(g.get_state(), ref.get_state()))


def rng_slot(fed: FederatedState) -> np.ndarray:
    """The rng words to save for ``fed``: ``fed.rng_slot`` while its
    generator has drawn nothing since it was seeded from it; else a
    64-bit seed drawn from the generator, which is reseeded with it and
    recorded in ``fed.rng_slot``."""
    g, n = fed.states.rng, fed.alive.shape[0]
    slot = fed.rng_slot
    if slot is not None and slot.shape[0] == n and _fresh(g, _seed(slot)):
        return slot
    hi, lo = torch.randint(0, 2**32, (2,), generator=g, device=g.device,
                           dtype=torch.int64).tolist()
    slot = np.empty((n, 2), np.uint32)
    slot[:, 0] = hi
    slot[:, 1] = (lo + np.arange(n)) % 2**32
    g.manual_seed(_seed(slot))
    fed.rng_slot = slot
    return slot


def to_state_dict(fed: FederatedState,
                  optimizer: str | None = None) -> dict:
    """The JAX package's state dict of ``fed``, tensor leaves as they
    are (on their device); the rng words from :func:`rng_slot`, which
    may reseed the generator."""
    optimizer = _optimizer(fed.states.opt_state, optimizer)
    return _state_dict(fed, optimizer, rng_slot(fed))


def from_state_dict(template: FederatedState, obj: dict,
                    optimizer: str | None = None) -> FederatedState:
    """A state dict in the JAX package's layout (a file's, or flax's
    ``to_state_dict`` of a JAX state with numpy leaves) in the structure,
    dtypes and devices of ``template``; every tensor owns its memory."""
    optimizer = _optimizer(template.states.opt_state, optimizer)
    n = template.alive.shape[0]
    layout = _state_dict(template, optimizer, np.zeros((n, 2), np.uint32))
    sd = _conform(layout, obj, "")
    st, opt = sd["states"], sd["states"]["opt_state"]["0"]
    opt_state = (opt["trace"] if optimizer == "sgd" else
                 AdamState(count=opt["count"], mu=opt["mu"], nu=opt["nu"]))
    rng = generator_from_slot(st["rng"], template.states.rng.device)
    return FederatedState(
        states=TrainState(params=st["params"], opt_state=opt_state, rng=rng,
                          step=st["step"].to(template.states.step.dtype)),
        alive=sd["alive"],
        round=int(sd["round"]),
        stale=None if sd["stale"] is None else (sd["stale"]["0"],
                                                sd["stale"]["1"]),
        rng_slot=st["rng"],
    )


def _write_tree(tree: Any) -> Callable[[Callable], None]:
    def write(out):
        msgpack_codec.serialize_to(tree, out, default=_host)
    return write


def save_checkpoint(directory: str | pathlib.Path, fed: FederatedState,
                    optimizer: str | None = None) -> pathlib.Path:
    """Write the federation state (atomically) and return the path. The
    leaves go to the file one at a time, each copied to the host on its
    own. ``optimizer`` ("sgd" by default, required for an adam state)
    picks optax's state layout."""
    path = checkpoint_path(directory, int(fed.round))
    _atomic_write(path, _write_tree(to_state_dict(fed, optimizer)))
    flight.record("checkpoint.save", round=int(fed.round), path=str(path))
    return path


def all_checkpoints(directory: str | pathlib.Path) -> list[pathlib.Path]:
    """Checkpoint files, oldest first."""
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return []
    return sorted(directory.glob(f"round_*{_SUFFIX}"))


def latest_checkpoint(directory: str | pathlib.Path) -> pathlib.Path | None:
    ckpts = all_checkpoints(directory)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str | pathlib.Path, template: FederatedState,
                    optimizer: str | None = None) -> FederatedState:
    """Restore a file into the structure of ``template``: keys and
    shapes checked, leaves cast to the template's dtypes (``step`` is
    int64 in the port) and copied to its device."""
    obj = _restore_blob(path)
    flight.record("checkpoint.load", path=str(path))
    try:
        return from_state_dict(template, obj, optimizer)
    except ValueError as e:
        raise ValueError(f"checkpoint {path} does not match the "
                         f"federation: {e}") from e


# ---- one model and its round (the join handshake's payload) -----------

def pack_model(params: Params, round_num: int) -> bytes:
    """One params tree (tensors or host arrays) and its round as a
    checkpoint-format blob: the STATE_SYNC payload and a node's own
    checkpoint file."""
    return msgpack_codec.serialize(
        {"round": int(round_num), "params": tree_map(_host, params)})


def _model_from_obj(obj: Any, template: Params) -> tuple[Params, int]:
    """``obj["params"]`` in the structure of ``template``; a template of
    host arrays gets host arrays back (bf16 as ``BF16Array``)."""
    host = any(isinstance(leaf, np.ndarray)
               for leaf in tree_leaves_sorted(template))
    like = tree_map_sorted(from_host, template) if host else template
    try:
        params = _conform(like, obj["params"], "params")
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"state blob does not match model: {e}") from e
    if host:
        params = tree_map_sorted(to_host, params)
    return params, int(obj.get("round", 0))


def unpack_model(blob: bytes, template: Params) -> tuple[Params, int]:
    """A :func:`pack_model` blob in the structure of ``template``:
    ``(params, round)``, leaves copied and conformed to its dtypes."""
    return _model_from_obj(msgpack_codec.restore(blob), template)


def save_node_checkpoint(directory: str | pathlib.Path, node_idx: int,
                         params: Params, round_num: int) -> pathlib.Path:
    """A socket node's params and round, atomically, in the STATE_SYNC
    blob's format (:func:`pack_model`): a relaunched node adopts the
    newer of its own file and a peer's sync with one decoder."""
    path = node_checkpoint_path(directory, node_idx)
    blob = pack_model(params, round_num)
    _atomic_write(path, lambda write: write(blob))
    flight.record("checkpoint.node_save", node=int(node_idx),
                  round=int(round_num), path=str(path))
    return path


def load_node_checkpoint(directory: str | pathlib.Path, node_idx: int,
                         template: Params) -> tuple[Params, int] | None:
    """A node's own checkpoint as ``(params, round)`` in the structure of
    ``template``; None when the node never saved one. A torn or corrupt
    file raises ValueError naming it."""
    path = node_checkpoint_path(directory, node_idx)
    if not path.is_file():
        return None
    obj = _restore_blob(path)
    flight.record("checkpoint.node_load", node=int(node_idx), path=str(path))
    try:
        return _model_from_obj(obj, template)
    except ValueError as e:
        raise ValueError(f"checkpoint {path}: {e}") from e
