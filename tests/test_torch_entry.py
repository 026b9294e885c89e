"""The port's entry points and its import boundary, on the CPU.

- ``p2pfl_tpu_torch.run --platform cpu`` prints the JAX runner's JSON
  result keys;
- without ``--platform cpu`` and without a card it exits non-zero with
  a message, and runs nothing on the CPU;
- importing every module of the port (the adversary package, the
  fused epoch and the socket plane included), and what ``chip_smoke.py``
  imports, in a fresh interpreter loads none of ``jax``, ``flax``,
  ``optax``, ``msgpack`` or ``p2pfl_tpu`` (top-level names compared
  exactly: the port's own name starts with ``p2pfl_tpu``; the port's
  checkpoints go through its own msgpack codec);
- the socket plane with TLS off (its modules, the shaper, the sidecar's
  client and a masked node on seeded secrets) never imports
  ``cryptography``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

from p2pfl_tpu import run as jax_run
from p2pfl_tpu_torch import run as torch_run

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--nodes", "2", "--rounds", "1", "--epochs", "1",
        "--samples-per-node", "64", "--batch-size", "16"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "p2pfl_tpu"}


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_prints_the_jax_result_keys(capsys):
    assert torch_run.main(TINY + ["--platform", "cpu"]) == 0
    port = _last_json(capsys.readouterr().out)
    assert jax_run.main(TINY + ["--platform", "cpu"]) == 0
    ref = _last_json(capsys.readouterr().out)
    assert list(port) == list(ref)
    assert port["n_nodes"] == 2 and port["rounds"] == 1
    assert 0.0 <= port["final_accuracy"] <= 1.0


def test_cli_without_a_card_exits_with_a_message(capsys):
    if torch.cuda.is_available():
        return  # a card is present: the default run is legitimate there
    assert torch_run.main(TINY) != 0
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--platform cpu" in err


def test_port_never_imports_jax_or_the_jax_package():
    modules = sorted(
        "p2pfl_tpu_torch." + ".".join(p.relative_to(
            ROOT / "p2pfl_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "p2pfl_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    # the adversary package, the fused epoch, the checkpoint and
    # logging modules and the socket plane are among them
    assert {"p2pfl_tpu_torch.adversary.attacks",
            "p2pfl_tpu_torch.adversary.reputation",
            "p2pfl_tpu_torch.ops.fused_train",
            "p2pfl_tpu_torch.federation.checkpoint",
            "p2pfl_tpu_torch.utils.msgpack_codec",
            "p2pfl_tpu_torch.utils.metrics",
            "p2pfl_tpu_torch.core.serialize",
            "p2pfl_tpu_torch.p2p.protocol",
            "p2pfl_tpu_torch.p2p.session",
            "p2pfl_tpu_torch.p2p.node",
            "p2pfl_tpu_torch.p2p.launch"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "p2pfl_tpu_torch" in top
    assert not (top & FORBIDDEN), top & FORBIDDEN


def test_the_socket_plane_without_tls_never_imports_cryptography():
    code = (
        "import sys\n"
        "import p2pfl_tpu_torch.p2p, p2pfl_tpu_torch.p2p.launch\n"
        "import p2pfl_tpu_torch.p2p.aggd, p2pfl_tpu_torch.p2p.netem\n"
        "import p2pfl_tpu_torch.privacy\n"
        "from p2pfl_tpu_torch.config.schema import NetworkConfig\n"
        "from p2pfl_tpu_torch.p2p import P2PNode\n"
        "from p2pfl_tpu_torch.p2p.aggd import SidecarClient\n"
        "from p2pfl_tpu_torch.privacy import PairwiseMasker\n"
        "P2PNode(0, None, n_nodes=2, netem=NetworkConfig(delay_ms=1),\n"
        "        masker=PairwiseMasker(0))\n"
        "P2PNode(1, None, n_nodes=2, sidecar=SidecarClient())\n"
        "print(sorted(m for m in sys.modules if m.startswith('crypto')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
