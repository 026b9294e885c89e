"""Pairwise-mask secure aggregation for the socket plane.

The counterpart of ``p2pfl_tpu/privacy/secagg.py``, bit for bit: for
one seed, one tree and one weight the pair secrets, round seeds, mask
streams and masked updates are the JAX package's, so a fleet may mix
the two packages' nodes under secure aggregation.

Every pair of round members (i, j) shares a secret; each round the pair
derives a fresh mask stream from it, node ``min(i, j)`` adds the stream
to its outgoing update and node ``max(i, j)`` subtracts it, so the
masks cancel exactly in the sum at the quorum's close and an
aggregator learns only the aggregate. Updates are quantized to fixed
point (``round(x * 2^bits)``), multiplied by the node's integer sample
weight and masked with uniform draws over the uint64 ring; sums wrap
mod 2^64, where the pairwise cancellation is an identity.

Pair secrets come from P-256 ECDH between a node's TLS key and a peer's
certificate (:func:`pair_secrets_from_tls`, which needs the optional
``cryptography`` package and imports it only when called), or from the
scenario seed (:func:`fallback_pair_secret`): the latter hides updates
from observers without the seed, not from the aggregating peers.

Dropout recovery: when a member is evicted mid-round, each survivor
reveals its round seed for the dead pair only (SECAGG_SHARE), and the
quorum reconstructs and subtracts the dead member's mask terms at the
close. Trees are host numpy trees, flattened in the JAX package's order
(dict keys sorted, ``core/serialize.py``).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any

import numpy as np

from p2pfl_tpu_torch.core.serialize import (
    astype,
    dtype_name,
    to_host,
    tree_leaves_sorted,
    tree_map_sorted,
    tree_unflatten_sorted,
    widen_bf16,
)

Params = Any

#: fixed-point fraction bits — quantization error 2^-25 per value at
#: the default, ~an f32 ulp at unit scale; headroom analysis in
#: :func:`quantize_update`
DEFAULT_BITS = 24

_DOMAIN_PAIR = b"p2pfl-secagg-pair-v1"
_DOMAIN_ROUND = b"p2pfl-secagg-round-v1"


class SecaggError(Exception):
    """Secure-aggregation protocol failure (fail loud, never a
    silently-wrong aggregate)."""


class SecaggUnmaskError(SecaggError):
    """Quorum close could not reconstruct an evicted member's mask
    contributions (missing reveal shares in ECDH mode)."""


# ---------------------------------------------------------------------------
# pair secrets: TLS ECDH when available, seeded fallback otherwise
# ---------------------------------------------------------------------------


def fallback_pair_secret(i: int, j: int, root_seed: int) -> bytes:
    """Deterministic pair secret from the scenario seed — order-
    independent in (i, j). Dev/test mode: anyone holding the scenario
    seed can derive it (see module doc's threat model)."""
    lo, hi = (int(i), int(j)) if i < j else (int(j), int(i))
    return hashlib.sha256(
        _DOMAIN_PAIR + struct.pack(">qqq", int(root_seed), lo, hi)
    ).digest()


def ecdh_pair_secret(private_key, peer_public_key) -> bytes:
    """P-256 ECDH between two TLS identities, hashed to a pair secret.
    Both members compute the same bytes (ECDH commutes). Requires the
    optional ``cryptography`` dependency — callers gate on it."""
    from cryptography.hazmat.primitives.asymmetric import ec

    shared = private_key.exchange(ec.ECDH(), peer_public_key)
    return hashlib.sha256(_DOMAIN_PAIR + shared).digest()


def pair_secrets_from_tls(idx: int, private_key,
                          peer_certs: dict[int, Any]) -> dict[int, bytes]:
    """Pair secrets against every peer certificate via ECDH with the
    node's own TLS private key — the identity layer IS the key
    agreement (X25519-style, on the P-256 curve the signing certs
    already use)."""
    out = {}
    for j, cert in peer_certs.items():
        if int(j) == int(idx):
            continue
        out[int(j)] = ecdh_pair_secret(private_key, cert.public_key())
    return out


def round_pair_seed(secret: bytes, round_num: int) -> int:
    """Per-round 64-bit mask seed for one pair — fresh masks every
    round, and the unit a survivor reveals for dropout recovery
    (revealing it unmasks only streams involving that pair)."""
    h = hashlib.sha256(
        _DOMAIN_ROUND + secret + struct.pack(">q", int(round_num))
    ).digest()
    return struct.unpack(">Q", h[:8])[0]


# ---------------------------------------------------------------------------
# fixed-point masking arithmetic (all exact, mod 2^64)
# ---------------------------------------------------------------------------


def _f64(x) -> np.ndarray:
    """A leaf's values in float64 (a bf16 leaf's words widened)."""
    a = to_host(x)
    if dtype_name(a) == "bfloat16":
        a = widen_bf16(a)
    return np.asarray(a, np.float64)


def quantize_update(params: Params, weight: int,
                    bits: int = DEFAULT_BITS) -> Params:
    """``round(x · 2^bits) · weight`` per leaf as a uint64 (two's
    complement) tree — the exact-integer domain masks cancel in.

    Headroom: |x| < 2^8, weight < 2^12, 2^6 members ⇒ the true signed
    sum stays under 2^(bits+26) < 2^63 at the default — far from
    wrapping; the uint64 ring only ever wraps through mask terms,
    which is the construction.
    """
    w = int(round(float(weight)))
    if w < 1:
        raise SecaggError(f"secagg weight must be a positive sample "
                          f"count, got {weight!r}")
    scale = np.float64(2.0 ** int(bits))

    def leaf(x):
        q = np.rint(_f64(x) * scale).astype(np.int64)
        return (q * np.int64(w)).view(np.uint64)

    return tree_map_sorted(leaf, params)


def dequantize_sum(masked_sum: Params, total_weight: float,
                   template: Params, bits: int = DEFAULT_BITS) -> Params:
    """Unmasked modular sum back to the template's float leaves:
    reinterpret as signed, ``/ 2^bits / total_weight`` in f64, cast to
    each template leaf's dtype."""
    scale = np.float64(2.0 ** int(bits)) * np.float64(total_weight)

    def leaf(s, t):
        v = np.asarray(s, np.uint64).view(np.int64)
        return astype(v.astype(np.float64) / scale,
                      dtype_name(to_host(t)))

    return tree_map_sorted(leaf, masked_sum, template)


def masked_add(a: Params, b: Params) -> Params:
    """Elementwise mod-2^64 sum of two masked trees — the session's
    merge/fuse primitive (partial aggregates of masked entries stay in
    the masked domain; weights were already folded in at quantize)."""
    return tree_map_sorted(
        lambda x, y: np.asarray(x, np.uint64) + np.asarray(y, np.uint64),
        a, b,
    )


def masked_sum(entries) -> tuple[Params, float]:
    """Fuse a list of ``(masked_tree, weight)`` session entries:
    modular tree sum + total declared weight. Always returns owning
    uint64 accumulators (never a view into a wire blob)."""
    if not entries:
        raise SecaggError("masked fuse over zero entries")
    acc = tree_map_sorted(
        lambda x: np.asarray(x, np.uint64).copy(), entries[0][0])
    total = float(entries[0][1])
    for tree, w in entries[1:]:
        acc = masked_add(acc, tree)
        total += float(w)
    return acc, total


def _pair_stream(seed: int, shapes_dtypes) -> list[np.ndarray]:
    """The pair's per-round mask stream: one uniform-uint64 array per
    leaf, drawn sequentially in flatten order from a counter-based
    Philox generator — both pair members (and any reconstructing
    survivor quorum) replay identical bits from the 64-bit seed."""
    gen = np.random.Generator(np.random.Philox(key=int(seed)))
    return [gen.integers(0, 2 ** 64, size=shape, dtype=np.uint64)
            for shape, _ in shapes_dtypes]


# ---------------------------------------------------------------------------
# the per-node protocol object
# ---------------------------------------------------------------------------


class PairwiseMasker:
    """One node's secagg state: pair secrets, the current round's
    member set, eviction tracking and reveal shares.

    ``pair_secrets`` maps peer index → shared secret bytes (ECDH mode,
    from :func:`pair_secrets_from_tls`); when absent for a peer the
    deterministic fallback from ``root_seed`` is used — so mixed
    fleets degrade per-pair, never silently as a whole.
    """

    def __init__(self, idx: int, root_seed: int = 0,
                 bits: int = DEFAULT_BITS,
                 pair_secrets: dict[int, bytes] | None = None):
        self.idx = int(idx)
        self.root_seed = int(root_seed)
        self.bits = int(bits)
        if not 8 <= self.bits <= 40:
            raise SecaggError(
                f"secagg bits must be in [8, 40], got {bits}")
        self.pair_secrets = dict(pair_secrets or {})
        # per-round state
        self.round_num: int | None = None
        self.members: frozenset[int] = frozenset()
        self.evicted: set[int] = set()
        #: reveal shares received for dead pairs:
        #: (survivor, dead, round) -> per-round pair seed
        self.shares: dict[tuple[int, int, int], int] = {}
        # leaf layout (and the tree it came from) cached from the round's
        # own masked update: the template of the residue streams
        self._shapes_dtypes: list[tuple[tuple[int, ...], str]] | None = None
        self._template = None

    # -- secrets ------------------------------------------------------
    def _secret(self, i: int, j: int) -> bytes:
        """Pair secret for (i, j). Own pairs use the ECDH secret when
        present; any pair falls back to the seeded derivation when the
        protocol must reconstruct and no reveal share arrived — but
        ONLY in fallback mode (no ECDH secret involved)."""
        i, j = int(i), int(j)
        other = j if i == self.idx else (i if j == self.idx else None)
        if other is not None and other in self.pair_secrets:
            return self.pair_secrets[other]
        if self.pair_secrets and other is None:
            # ECDH fleet: third-party secrets are not derivable — the
            # caller must hold a reveal share instead
            raise SecaggUnmaskError(
                f"pair ({i},{j}) secret not derivable under ECDH "
                f"secrets; missing reveal share")
        return fallback_pair_secret(i, j, self.root_seed)

    def pair_seed(self, i: int, j: int, round_num: int) -> int:
        return round_pair_seed(self._secret(i, j), round_num)

    # -- round lifecycle ----------------------------------------------
    def begin_round(self, round_num: int, members) -> None:
        self.round_num = int(round_num)
        self.members = frozenset(int(m) for m in members)
        self.evicted.clear()
        self.shares = {k: v for k, v in self.shares.items()
                       if k[2] >= self.round_num}

    def note_evicted(self, node: int) -> None:
        """A member died mid-round (suspect/evict machinery) — its
        mask contributions may need reconstruction at quorum close."""
        if self.round_num is not None and int(node) in self.members:
            self.evicted.add(int(node))

    def reveal_share(self, dead: int) -> int:
        """This node's per-round pair seed against ``dead`` — what a
        survivor broadcasts so the quorum can unmask. Reveals only
        streams involving the dead pair."""
        if self.round_num is None:
            raise SecaggError("reveal_share outside a round")
        return self.pair_seed(self.idx, int(dead), self.round_num)

    def add_share(self, survivor: int, dead: int, round_num: int,
                  seed: int) -> None:
        self.shares[(int(survivor), int(dead), int(round_num))] = int(seed)

    # -- masking ------------------------------------------------------
    def mask_update(self, params: Params, weight: int) -> Params:
        """Quantize + pre-weight + pairwise-mask this node's update
        against every current round member. The masked tree is what
        enters the node's own session AND every ``_send_params``."""
        if self.round_num is None:
            raise SecaggError("mask_update outside a round "
                              "(begin_round not called)")
        leaves = [to_host(x) for x in tree_leaves_sorted(params)]
        self._shapes_dtypes = [
            (tuple(np.shape(x)), dtype_name(x)) for x in leaves]
        self._template = params
        masked = tree_leaves_sorted(
            quantize_update(params, weight, self.bits))
        masked = [m.copy() for m in masked]
        for j in sorted(self.members):
            if j == self.idx:
                continue
            seed = self.pair_seed(self.idx, j, self.round_num)
            stream = _pair_stream(seed, self._shapes_dtypes)
            if self.idx < j:
                for m, s in zip(masked, stream):
                    m += s
            else:
                for m, s in zip(masked, stream):
                    m -= s
        return tree_unflatten_sorted(params, masked)

    # -- dropout recovery ---------------------------------------------
    def residue(self, covered) -> Params | None:
        """The mask residue left in the quorum's modular sum by
        evicted members whose entries never landed: for each such dead
        ``d`` and each surviving contributor ``i``, the stream of pair
        (i, d) with i's sign. Returns a uint64 tree to SUBTRACT from
        the masked sum, or None when nothing needs reconstruction.

        Seeds come from reveal shares (ECDH mode) or are derived
        directly (fallback mode); a missing, non-derivable share is a
        loud :class:`SecaggUnmaskError` — never a silently-wrong
        aggregate.
        """
        if self.round_num is None or not self.evicted:
            return None
        covered = {int(i) for i in covered}
        dead = sorted(d for d in self.evicted if d not in covered)
        if not dead:
            return None
        if self._shapes_dtypes is None:
            raise SecaggUnmaskError(
                "residue reconstruction before any masked update "
                "fixed the leaf layout")
        acc = [np.zeros(shape, np.uint64)
               for shape, _ in self._shapes_dtypes]
        for d in dead:
            for i in sorted(covered):
                if i == d or i not in self.members:
                    continue
                share = self.shares.get((i, d, self.round_num))
                if share is None:
                    if i == self.idx or not self.pair_secrets:
                        share = self.pair_seed(i, d, self.round_num)
                    else:
                        raise SecaggUnmaskError(
                            f"no reveal share from survivor {i} for "
                            f"evicted {d} (round {self.round_num})")
                stream = _pair_stream(share, self._shapes_dtypes)
                if i < d:
                    for a, s in zip(acc, stream):
                        a += s
                else:
                    for a, s in zip(acc, stream):
                        a -= s
        return tree_unflatten_sorted(self._template, acc)

    def unmask(self, masked_sum_tree: Params, total_weight: float,
               covered, template: Params) -> tuple[Params, list[int]]:
        """Quorum close: subtract evicted members' reconstructed mask
        contributions (if any), dequantize to the template's dtypes.
        Returns ``(params, unmasked_dead)``."""
        covered = {int(i) for i in covered}
        res = self.residue(covered)
        unmasked_dead = sorted(
            d for d in self.evicted if d not in covered
        ) if res is not None else []
        if res is not None:
            masked_sum_tree = tree_map_sorted(
                lambda a, b: np.asarray(a, np.uint64) - b,
                masked_sum_tree, res)
        return (
            dequantize_sum(masked_sum_tree, total_weight, template,
                           self.bits),
            unmasked_dead,
        )
