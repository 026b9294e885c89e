"""Transport security for the socket plane: mutual TLS and origin
signatures.

The counterpart of ``p2pfl_tpu/p2p/tls.py``; certificates and keys
minted by either package load in the other. One self-signed scenario
CA issues an ECDSA P-256 certificate per node (CN ``node<idx>``); both
ends of every connection require a peer certificate chained to that CA,
so a plaintext peer, or a node of another scenario, cannot join.

TLS authenticates a connection, not the origin of a gossiped message:
floods are relayed, so a frame's sender is often not the connection's
peer. ``MessageSigner`` and ``MessageVerifier`` sign and check each
originated frame's ``signing_bytes()`` with the node's key, the
certificate riding in the frame: a receiver chains it to the pinned CA,
requires CN ``node<sender>`` and verifies the signature. The payload
enters the signed bytes as its SHA-256 (``protocol.Message``).

This module needs the optional ``cryptography`` package and is imported
only where TLS is asked for: a fleet without TLS never imports it.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import pathlib
import ssl

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

_ONE_DAY = datetime.timedelta(days=1)
_VALIDITY = datetime.timedelta(days=365)


def _name(common_name: str) -> x509.Name:
    return x509.Name(
        [
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, "p2pfl_tpu"),
            x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        ]
    )


def _write_key(path: pathlib.Path, key) -> None:
    path.write_bytes(
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )
    )


def _write_cert(path: pathlib.Path, cert: x509.Certificate) -> None:
    path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))


@dataclasses.dataclass(frozen=True)
class TLSCredentials:
    """One node's identity: its cert/key plus the scenario CA to pin."""

    ca_cert: pathlib.Path
    cert: pathlib.Path
    key: pathlib.Path

    def _context(self, purpose: ssl.Purpose) -> ssl.SSLContext:
        ctx = ssl.create_default_context(purpose, cafile=str(self.ca_cert))
        ctx.load_cert_chain(str(self.cert), str(self.key))
        # authentication is CA pinning, not hostname matching: every
        # scenario member presents a cert from THIS scenario's CA;
        # hostnames are meaningless for ephemeral localhost ports
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def server_context(self) -> ssl.SSLContext:
        return self._context(ssl.Purpose.CLIENT_AUTH)

    def client_context(self) -> ssl.SSLContext:
        return self._context(ssl.Purpose.SERVER_AUTH)


def generate_scenario_ca(directory: str | pathlib.Path, name: str = "scenario"
                         ) -> tuple[pathlib.Path, pathlib.Path]:
    """Mint the scenario CA. Returns (ca_cert_path, ca_key_path)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    subject = _name(f"p2pfl_tpu CA {name}")
    cert = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _ONE_DAY)
        .not_valid_after(now + _VALIDITY)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    ca_cert, ca_key = directory / "ca.crt", directory / "ca.key"
    _write_cert(ca_cert, cert)
    _write_key(ca_key, key)
    return ca_cert, ca_key


def issue_node_cert(directory: str | pathlib.Path, idx: int,
                    ca_cert: str | pathlib.Path,
                    ca_key: str | pathlib.Path) -> TLSCredentials:
    """Issue node ``idx``'s certificate signed by the scenario CA."""
    directory = pathlib.Path(directory)
    ca_cert = pathlib.Path(ca_cert)
    ca = x509.load_pem_x509_certificate(ca_cert.read_bytes())
    ca_private = serialization.load_pem_private_key(
        pathlib.Path(ca_key).read_bytes(), password=None
    )
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(f"node{idx}"))
        .issuer_name(ca.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _ONE_DAY)
        .not_valid_after(now + _VALIDITY)
        .add_extension(
            x509.SubjectAlternativeName(
                [
                    x509.DNSName(f"node{idx}"),
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                ]
            ),
            critical=False,
        )
        .sign(ca_private, hashes.SHA256())
    )
    cert_path = directory / f"node{idx}.crt"
    key_path = directory / f"node{idx}.key"
    _write_cert(cert_path, cert)
    _write_key(key_path, key)
    return TLSCredentials(ca_cert=ca_cert, cert=cert_path, key=key_path)


def make_scenario_credentials(
    directory: str | pathlib.Path, n_nodes: int, name: str = "scenario"
) -> list[TLSCredentials]:
    """CA + one credential per node, all in ``directory``."""
    ca_cert, ca_key = generate_scenario_ca(directory, name)
    return [issue_node_cert(directory, i, ca_cert, ca_key)
            for i in range(n_nodes)]


def _cn_to_idx(cn: str) -> int | None:
    """The single source of the ``node<idx>`` CN naming rule."""
    if not cn.startswith("node"):
        return None
    try:
        return int(cn[4:])
    except ValueError:
        return None


def peer_index(peercert: dict | None) -> int | None:
    """Node index from a transport peer certificate, as returned by
    ``ssl``'s ``getpeercert()`` dict form (available because both
    contexts set CERT_REQUIRED). None if the CN is not ``node<idx>``."""
    if not peercert:
        return None
    for rdn in peercert.get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                return _cn_to_idx(value)
    return None


class MessageSigner:
    """Signs self-originated frames with this node's TLS key."""

    def __init__(self, creds: TLSCredentials):
        self._key = serialization.load_pem_private_key(
            creds.key.read_bytes(), password=None
        )
        self.cert_pem = creds.cert.read_bytes()

    def sign(self, data: bytes) -> bytes:
        return self._key.sign(data, ec.ECDSA(hashes.SHA256()))


class MessageVerifier:
    """Verifies origin signatures against the pinned scenario CA.

    Certificates arrive attached to the message (a receiver has only
    its own credentials + the CA, and flooded messages originate from
    nodes it never handshook with). Verified certs are cached by their
    PEM bytes so steady-state cost is one ECDSA verify per message.
    """

    _CACHE_MAX = 4096  # bounded: one entry per distinct member cert

    def __init__(self, ca_cert: str | pathlib.Path):
        ca = x509.load_pem_x509_certificate(
            pathlib.Path(ca_cert).read_bytes()
        )
        self._ca_key = ca.public_key()
        self._trusted: dict[bytes, tuple[int, object]] = {}

    def _load(self, cert_pem: bytes) -> tuple[int, object]:
        cached = self._trusted.get(cert_pem)
        if cached is not None:
            return cached
        cert = x509.load_pem_x509_certificate(cert_pem)
        # chain to the pinned CA (path length 0: members are leaves)
        self._ca_key.verify(
            cert.signature,
            cert.tbs_certificate_bytes,
            ec.ECDSA(cert.signature_hash_algorithm),
        )
        cn = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)[0].value
        idx = _cn_to_idx(cn)
        if idx is None:
            raise ValueError(f"not a member certificate: CN={cn!r}")
        entry = (idx, cert.public_key())
        if len(self._trusted) < self._CACHE_MAX:
            self._trusted[cert_pem] = entry
        return entry

    def verify(self, cert_pem: bytes, sig: bytes, data: bytes,
               claimed_idx: int) -> bool:
        """True iff ``cert_pem`` chains to the CA, its CN names
        ``claimed_idx``, and ``sig`` covers ``data``."""
        if not cert_pem or not sig:
            return False
        try:
            idx, public_key = self._load(cert_pem)
            if idx != claimed_idx:
                return False
            public_key.verify(sig, data, ec.ECDSA(hashes.SHA256()))
            return True
        except Exception:
            return False


def load_node_credentials(directory: str | pathlib.Path,
                          idx: int) -> TLSCredentials:
    """Load credentials previously minted by make_scenario_credentials
    (the multi-process children's path)."""
    directory = pathlib.Path(directory)
    creds = TLSCredentials(
        ca_cert=directory / "ca.crt",
        cert=directory / f"node{idx}.crt",
        key=directory / f"node{idx}.key",
    )
    for p in (creds.ca_cert, creds.cert, creds.key):
        if not p.exists():
            raise FileNotFoundError(f"missing TLS material: {p}")
    return creds
