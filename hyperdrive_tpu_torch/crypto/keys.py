"""Replica identity and signing keys.

The capability analogue of ``renproject/id`` in the reference (Signatory
pubkey-hash identities, PrivKey signing — reference usage:
process/process.go:105, process/message_test.go:145-158), with a deliberate
design change: a Signatory here *is* the 32-byte Ed25519 public key, which
is exactly the array layout the batch verifier consumes.

Port copy of ``hyperdrive_tpu/crypto/keys.py`` for the PyTorch package:
keys derive and sign through the native C++ signer
(:mod:`hyperdrive_tpu_torch.native`) when it builds, and through the
pure-Python oracle (:mod:`hyperdrive_tpu_torch.crypto.ed25519`) otherwise
or under ``HD_NO_NATIVE=1``. Ed25519 signing is deterministic (RFC 8032),
so keys and signatures are byte-identical either way.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from hyperdrive_tpu_torch.crypto import ed25519
from hyperdrive_tpu_torch.types import Signatory

__all__ = ["KeyPair", "KeyRing"]


def _backend():
    """The shared C++ signer when buildable, else None (Python oracle
    path). Resolved lazily so importing crypto never forces a compile."""
    from hyperdrive_tpu_torch import native

    return native.instance()


@dataclass(frozen=True)
class KeyPair:
    """A replica's Ed25519 seed and derived public identity."""

    seed: bytes
    public: Signatory

    @classmethod
    def from_seed(cls, seed: bytes) -> "KeyPair":
        n = _backend()
        if n is not None:
            return cls(seed=seed, public=n.public_from_seed(seed))
        return cls(seed=seed, public=ed25519.public_key_from_seed(seed))

    @classmethod
    def deterministic(cls, tag: bytes) -> "KeyPair":
        """Derive a keypair from an arbitrary tag (test/harness use)."""
        return cls.from_seed(hashlib.sha256(tag).digest())

    @property
    def signatory(self) -> Signatory:
        return self.public

    def sign_digest(self, digest: bytes) -> bytes:
        n = _backend()
        if n is not None:
            return n.sign(self.seed, digest, pub=self.public)
        return ed25519.sign(self.seed, digest)

    def sign_message(self, msg):
        """Attach a detached signature over the message's signing digest."""
        return msg.with_signature(self.sign_digest(msg.digest()))


class KeyRing:
    """An ordered set of keypairs — the signatory set of one network."""

    def __init__(self, pairs: list[KeyPair]):
        self.pairs = list(pairs)
        self.by_signatory = {kp.public: kp for kp in pairs}

    @classmethod
    def deterministic(cls, n: int, namespace: bytes = b"hyperdrive") -> "KeyRing":
        return cls(
            [KeyPair.deterministic(namespace + b"-%d" % i) for i in range(n)]
        )

    @property
    def signatories(self) -> list[Signatory]:
        return [kp.public for kp in self.pairs]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> KeyPair:
        return self.pairs[i]
