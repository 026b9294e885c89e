"""The port's mutual TLS and origin signatures (``p2p/tls.py``) on the
CPU, against the JAX package's.

- Credentials minted by either package load in the other, and their
  contexts pin the CA.
- ``Message.signing_bytes()`` is the JAX package's for one message
  (body, payload digest, id); a frame signed by a port node verifies
  under the JAX package's ``MessageVerifier`` after a JAX decode, and
  the reverse; a tampered payload fails both.
- A 4-node port fleet converges under TLS (nodes 0 and 2 within rtol
  1e-4, atol 1e-5, as ``tests/test_tls.py`` holds the JAX fleet).
- Plaintext and foreign-CA peers are refused at the handshake, a forged
  sender is dropped (not handled, not relayed), a hello must match its
  certificate, and a corrupted relay cannot censor the genuine flood.
- A mixed fleet under TLS: JAX nodes 0 and 1, port nodes 2 and 3, 2
  rounds, every node finishing and agreeing within rtol 1e-4, atol 1e-5.
- ``launch`` with ``encrypt`` and secure aggregation: the CA and the
  certificates minted beside the config, 3 nodes in a child under TLS,
  pair secrets by ECDH; ``run_simulation`` with ``encrypt``.
"""

from __future__ import annotations

import asyncio
import ssl

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography")

from p2pfl_tpu.p2p import protocol as jproto
from p2pfl_tpu.p2p import tls as jtls
from p2pfl_tpu_torch.core.serialize import encode_parameters
from p2pfl_tpu_torch.p2p import P2PNode
from p2pfl_tpu_torch.p2p import tls as ttls
from p2pfl_tpu_torch.p2p.protocol import Message, MsgType, write_message
from test_torch_socket import (
    J_PROTO,
    PROTO,
    _data,
    _fleet,
    _params,
    _port_learner,
    _port_shared,
)

pytestmark = [
    pytest.mark.filterwarnings("error::ResourceWarning"),
    pytest.mark.filterwarnings("error:.*was never awaited:RuntimeWarning"),
]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch's intra-op threads pinned for this module (the suite runs
    six workers), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tls_nodes(creds, n=None, **kw):
    n = n or len(creds)
    data = _data(n)
    shared = _port_shared()
    return [P2PNode(i, _port_learner(data.nodes[i], shared), n_nodes=n,
                    protocol=PROTO, gossip_period_s=0.02, tls=creds[i], **kw)
            for i in range(n)]


async def _linked(nodes):
    for nd in nodes:
        await nd.start()
    for i in range(len(nodes)):
        for j in range(i + 1, len(nodes)):
            await nodes[i].connect_to(nodes[j].host, nodes[j].port)
    await asyncio.sleep(0.3)


# ---- credentials and signatures across the packages ------------------------

@pytest.mark.parametrize("mint, load", [(jtls, ttls), (ttls, jtls)])
def test_credentials_minted_by_one_package_load_in_the_other(tmp_path,
                                                            mint, load):
    creds = mint.make_scenario_credentials(tmp_path, 3, name="t")
    got = load.load_node_credentials(tmp_path, 1)
    assert got.cert.read_bytes() == creds[1].cert.read_bytes()
    assert got.server_context().verify_mode == ssl.CERT_REQUIRED
    assert got.client_context().verify_mode == ssl.CERT_REQUIRED
    signer = load.MessageSigner(got)
    verifier = mint.MessageVerifier(creds[0].ca_cert)
    assert verifier.verify(signer.cert_pem, signer.sign(b"x"), b"x", 1)
    assert not verifier.verify(signer.cert_pem, signer.sign(b"x"), b"x", 2)
    with pytest.raises(FileNotFoundError):
        load.load_node_credentials(tmp_path, 9)


def _pair(body, payload=b""):
    kw = dict(body=body, payload=payload, msg_id="00ff00ff00ff00ff")
    return (Message(MsgType.PARAMS, 3, **kw),
            jproto.Message(jproto.MsgType.PARAMS, 3, **kw))


def test_signing_bytes_equal_jax():
    blob = encode_parameters({"w": np.arange(6, dtype=np.float32)}, (3,), 5)
    for body, payload in (({}, b""), ({"round": 2, "c": [3], "w": 5}, blob),
                          ({"nested": {"a": [1, 2.5, "x"]}}, b"abc")):
        t, j = _pair(body, payload)
        assert t.signing_bytes() == j.signing_bytes()
        assert t.payload_digest() == j.payload_digest()
    # an unsigned frame is unchanged by the digest it never computes
    t, j = _pair({"round": 1}, blob)
    assert t.encode() == j.encode()


@pytest.mark.parametrize("signer_pkg", ["port", "jax"])
def test_a_signed_frame_verifies_in_the_other_package(tmp_path, signer_pkg):
    creds = ttls.make_scenario_credentials(tmp_path, 2, name="x")
    blob = encode_parameters({"w": np.ones(4, np.float32)}, (1,), 2)
    t, j = _pair({"round": 0, "c": [1], "w": 2}, blob)
    t.sender = j.sender = 1
    if signer_pkg == "port":
        s = ttls.MessageSigner(creds[1])
        t.sig, t.cert = s.sign(t.signing_bytes()), s.cert_pem
        got = jproto.Message.decode(t.encode())
        verifier = jtls.MessageVerifier(creds[0].ca_cert)
    else:
        s = jtls.MessageSigner(creds[1])
        j.sig, j.cert = s.sign(j.signing_bytes()), s.cert_pem
        got = Message.decode(j.encode())
        verifier = ttls.MessageVerifier(creds[0].ca_cert)
    assert got.payload == blob and got.sig
    assert verifier.verify(got.cert, got.sig, got.signing_bytes(), 1)
    # a signed frame's digest comes from the payload received, never
    # the header: a swapped payload fails
    got.payload = blob[:-1] + bytes([blob[-1] ^ 1])
    got._payload_digest = None
    assert not verifier.verify(got.cert, got.sig, got.signing_bytes(), 1)


# ---- the port's fleet under TLS ------------------------------------------

def test_encrypted_port_fleet_converges(tmp_path):
    creds = ttls.make_scenario_credentials(tmp_path, 4, name="enc")
    nodes = asyncio.run(_fleet(_tls_nodes(creds)))
    assert all(nd.round == 2 for nd in nodes)
    assert all(nd._signer is not None for nd in nodes)
    for a, b in zip(_params(nodes[0]), _params(nodes[2])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_plaintext_and_foreign_ca_peers_are_refused(tmp_path):
    async def main():
        creds = ttls.make_scenario_credentials(tmp_path / "a", 2, name="a")
        foreign = ttls.make_scenario_credentials(tmp_path / "b", 2, name="b")
        server = _tls_nodes(creds, n=2)[0]
        await server.start()
        try:
            plain = P2PNode(1, None, n_nodes=2, protocol=PROTO)
            with pytest.raises((ssl.SSLError, ConnectionError, ValueError,
                                asyncio.IncompleteReadError, OSError,
                                asyncio.TimeoutError)):
                await asyncio.wait_for(
                    plain.connect_to(server.host, server.port), timeout=5)
            assert not server.peers
            alien = P2PNode(1, None, n_nodes=2, protocol=PROTO,
                            tls=foreign[1])
            with pytest.raises((ssl.SSLError, ConnectionError, OSError,
                                asyncio.IncompleteReadError,
                                asyncio.TimeoutError)):
                await asyncio.wait_for(
                    alien.connect_to(server.host, server.port), timeout=5)
            assert not server.peers
        finally:
            await server.stop()

    asyncio.run(main())


def test_a_forged_sender_is_dropped(tmp_path):
    async def main():
        creds = ttls.make_scenario_credentials(tmp_path, 3, name="forge")
        nodes = _tls_nodes(creds)
        await _linked(nodes)
        try:
            assert 2 in nodes[0].membership.get_nodes()
            evil = nodes[1]
            # a STOP "from node 2" signed with node 1's key, then unsigned
            forged = Message(MsgType.STOP, 2)
            forged.sig = evil._signer.sign(forged.signing_bytes())
            forged.cert = evil._signer.cert_pem
            await write_message(evil.peers[0].writer, forged)
            await write_message(evil.peers[0].writer, Message(MsgType.STOP, 2))
            await asyncio.sleep(0.5)
            assert 2 in nodes[0].membership.get_nodes()
            assert 2 in nodes[0].peers
            grab = Message(MsgType.TRANSFER_LEADERSHIP, 2, {"to": 1})
            grab.sig = evil._signer.sign(grab.signing_bytes())
            grab.cert = evil._signer.cert_pem
            await write_message(evil.peers[0].writer, grab)
            await asyncio.sleep(0.3)
            assert nodes[0].leader is None
        finally:
            for nd in nodes:
                await nd.stop()

    asyncio.run(main())


def test_a_hello_must_match_its_certificate(tmp_path):
    async def main():
        creds = ttls.make_scenario_credentials(tmp_path, 3, name="cn")
        server = P2PNode(0, None, n_nodes=3, protocol=PROTO, tls=creds[0])
        await server.start()
        try:
            # node 1's certificate, claiming to be node 2
            liar = P2PNode(2, None, n_nodes=3, protocol=PROTO, tls=creds[1])
            with pytest.raises((ConnectionError, asyncio.TimeoutError,
                                asyncio.IncompleteReadError, OSError)):
                await asyncio.wait_for(
                    liar.connect_to(server.host, server.port), timeout=5)
            await asyncio.sleep(0.2)
            assert not server.peers
            honest = P2PNode(1, None, n_nodes=3, protocol=PROTO, tls=creds[1])
            await honest.start()
            await honest.connect_to(server.host, server.port)
            await asyncio.sleep(0.2)
            assert 1 in server.peers
            await honest.stop()
        finally:
            await server.stop()

    asyncio.run(main())


def test_a_corrupted_relay_cannot_censor_the_genuine_flood(tmp_path):
    async def main():
        creds = ttls.make_scenario_credentials(tmp_path, 3, name="poison")
        nodes = _tls_nodes(creds)
        await _linked(nodes)
        try:
            signer2 = ttls.MessageSigner(creds[2])
            genuine = Message(MsgType.TRANSFER_LEADERSHIP, 2,
                              {"to": 2, "round": 0})
            genuine.sig = signer2.sign(genuine.signing_bytes())
            genuine.cert = signer2.cert_pem
            corrupted = Message(MsgType.TRANSFER_LEADERSHIP, 2,
                                {"to": 2, "round": 0}, msg_id=genuine.msg_id)
            corrupted.sig = b"\x00" * len(genuine.sig)
            corrupted.cert = genuine.cert
            await write_message(nodes[1].peers[0].writer, corrupted)
            await asyncio.sleep(0.2)
            assert nodes[0].leader is None
            await write_message(nodes[1].peers[0].writer, genuine)
            await asyncio.sleep(0.3)
            assert nodes[0].leader == 2
        finally:
            for nd in nodes:
                await nd.stop()

    asyncio.run(main())


def test_a_mixed_fleet_federates_under_tls(tmp_path):
    from p2pfl_tpu.learning import JaxLearner
    from p2pfl_tpu.learning.learner import SharedTrainer as JShared
    from p2pfl_tpu.models import get_model as j_get_model
    from p2pfl_tpu.p2p import P2PNode as JNode

    n = 4
    creds = jtls.make_scenario_credentials(tmp_path, n, name="mixed")
    data = _data(n)
    jshared = JShared(j_get_model("mnist-mlp"), learning_rate=0.05,
                      batch_size=32)
    tshared = _port_shared()
    nodes = []
    for i in range(n):
        if i < 2:
            ln = JaxLearner(model=None, data=data.nodes[i],
                            learning_rate=0.05, batch_size=32, seed=0,
                            trainer=jshared)
            nodes.append(JNode(i, ln, n_nodes=n, protocol=J_PROTO,
                               gossip_period_s=0.02, tls=creds[i]))
        else:
            nodes.append(P2PNode(
                i, _port_learner(data.nodes[i], tshared), n_nodes=n,
                protocol=PROTO, gossip_period_s=0.02,
                tls=ttls.load_node_credentials(tmp_path, i)))
    nodes = asyncio.run(_fleet(nodes))
    assert all(nd.round == 2 for nd in nodes)
    for nd in nodes[1:]:
        for a, b in zip(_params(nodes[0]), _params(nd)):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_launch_mints_the_scenario_ca_and_the_child_runs_tls(
        tmp_path, monkeypatch):
    """``encrypt`` with ``privacy.secagg``: ``launch`` mints the CA and
    the node certificates beside the config, and the child runs mutual
    TLS from ``--tls-dir`` and derives its pair secrets by ECDH."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the child's torch threads
    from p2pfl_tpu_torch.config.schema import PrivacyConfig
    from p2pfl_tpu_torch.p2p.launch import _node_layers, launch
    from test_torch_socket import LIMIT, _sim_config

    cfg = _sim_config(encrypt=True, privacy=PrivacyConfig(secagg=True))
    path = tmp_path / "socket.json"
    cfg.save(path)
    res = launch(cfg, path, platform="cpu", nodes_per_proc=3, timeout=LIMIT)
    assert sorted(r["node"] for r in res) == [0, 1, 2]
    assert all(r["round"] == 2 for r in res)
    tls_dir = tmp_path / "tls"
    assert (tls_dir / "ca.crt").exists() and (tls_dir / "node2.key").exists()
    layers = _node_layers(cfg, 1, str(tls_dir))
    assert layers["tls"].cert == tls_dir / "node1.crt"
    assert set(layers["masker"].pair_secrets) == {0, 2}


def test_run_simulation_mints_a_ca_and_runs_tls():
    """``encrypt`` through ``run_simulation``: a CA in a temporary
    directory, every node under TLS."""
    from p2pfl_tpu_torch.p2p.launch import run_simulation
    from test_torch_socket import LIMIT, _sim_config

    nodes: list = []
    res = run_simulation(_sim_config(encrypt=True), timeout=LIMIT,
                         device="cpu", nodes_out=nodes)
    assert res["rounds"] == 2
    assert all(nd.tls is not None and nd._signer is not None
               for nd in nodes)
