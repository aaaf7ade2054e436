"""Consensus messages: Propose, Prevote, Precommit, and Timeout.

Capability parity with the reference's message layer
(``process/message.go:43-345``, ``timer/timer.go:14-61``): immutable records
with height/round/value/sender fields, canonical binary serialization under a
byte budget, per-message signing digests that cover everything *except* the
sender (the sender is authenticated by the signature itself), and structural
equality.

Unlike the reference, messages here are hashable frozen dataclasses so they
can live directly in log dict/set structures, and they carry an optional
detached Ed25519 signature for the first-class Verifier path (the reference
assumes authentication happens outside the library,
``process/process.go:95-98``).

Port copy of ``hyperdrive_tpu/messages.py`` for the PyTorch package,
with the reference's ``@wire_codec`` registrations (``msg.*``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.types import (
    INT64_MIN,
    INT64_MAX,
    MessageType,
    NIL_SIGNATORY,
    NIL_VALUE,
)

__all__ = [
    "Propose",
    "Prevote",
    "Precommit",
    "Timeout",
    "marshal_message",
    "unmarshal_message",
]


def _check_i64(v: int, what: str) -> None:
    if not INT64_MIN <= v <= INT64_MAX:
        raise SerdeError(f"{what} out of int64 range: {v}")


@wire_codec(tag="msg.propose", max_bytes=1 << 20)
@dataclass(frozen=True, slots=True)
class Propose:
    """A proposer's value suggestion for one (height, round).

    Sent at most once per round by the scheduled proposer (reference:
    ``process/message.go:43-50``). ``valid_round`` carries the proposer's
    ValidRound for the L28 re-propose rule.

    ``payload`` is this framework's MPC extension (no reference analogue):
    an optional opaque byte blob riding with the proposal — in the Shamir
    path it carries the k-of-n share bundle the committer reconstructs per
    committed block (BASELINE config 5). It participates in equality (two
    proposals differing only in payload are equivocation) and is committed
    to by the signing digest.
    """

    height: int
    round: int
    valid_round: int
    value: bytes
    sender: bytes
    payload: bytes = b""
    signature: bytes = field(default=b"", compare=False)
    _digest: bytes = field(default=b"", init=False, repr=False, compare=False)

    def digest(self) -> bytes:
        """Signing digest over (height, round, valid_round, value[,
        payload]).

        Mirrors ``NewProposeHash`` (reference: process/message.go:53-78) —
        the sender is deliberately excluded; the signature authenticates it.
        The leading byte is a per-type domain-separation tag (the
        MessageType) so digests of different message types can never
        collide, regardless of field layout. A non-empty payload appends
        its SHA-256 (injective vs the empty case: the preimage lengths
        differ), so the signature also binds the share bundle.

        Memoized: in the harness one broadcast object fans out to every
        replica, so the digest is computed once per broadcast instead of
        once per delivery. (The cache never covers the signature, so
        ``with_signature`` copies need no invalidation.)
        """
        d = self._digest
        if d:
            return d
        w = Writer()
        w.i64(self.height)
        w.i64(self.round)
        w.i64(self.valid_round)
        w.bytes32(self.value)
        if self.payload:
            w.bytes32(hashlib.sha256(self.payload).digest())
        d = hashlib.sha256(b"\x01" + w.data()).digest()
        object.__setattr__(self, "_digest", d)
        return d

    def size_hint(self) -> int:
        return 8 + 8 + 8 + 32 + 32 + 4 + len(self.payload)

    def marshal(self, w: Writer) -> None:
        _check_i64(self.height, "height")
        _check_i64(self.round, "round")
        _check_i64(self.valid_round, "valid_round")
        w.i64(self.height)
        w.i64(self.round)
        w.i64(self.valid_round)
        w.bytes32(self.value)
        w.bytes32(self.sender)
        w.raw(self.payload)

    @classmethod
    def unmarshal(cls, r: Reader) -> "Propose":
        return cls(
            height=r.i64(),
            round=r.i64(),
            valid_round=r.i64(),
            value=r.bytes32(),
            sender=r.bytes32(),
            payload=r.raw(),
        )

    def with_signature(self, signature: bytes) -> "Propose":
        return replace(self, signature=signature)


@wire_codec(tag="msg.prevote", max_bytes=256)
@dataclass(frozen=True, slots=True)
class Prevote:
    """The first voting step (reference: ``process/message.go:156-162``)."""

    height: int
    round: int
    value: bytes
    sender: bytes
    signature: bytes = field(default=b"", compare=False)
    _digest: bytes = field(default=b"", init=False, repr=False, compare=False)

    def digest(self) -> bytes:
        """Mirrors ``NewPrevoteHash`` (reference: process/message.go:165-186).
        Memoized (see :meth:`Propose.digest`)."""
        d = self._digest
        if d:
            return d
        w = Writer()
        w.i64(self.height)
        w.i64(self.round)
        w.bytes32(self.value)
        d = hashlib.sha256(b"\x02" + w.data()).digest()
        object.__setattr__(self, "_digest", d)
        return d

    def size_hint(self) -> int:
        return 8 + 8 + 32 + 32

    def marshal(self, w: Writer) -> None:
        _check_i64(self.height, "height")
        _check_i64(self.round, "round")
        w.i64(self.height)
        w.i64(self.round)
        w.bytes32(self.value)
        w.bytes32(self.sender)

    @classmethod
    def unmarshal(cls, r: Reader) -> "Prevote":
        return cls(
            height=r.i64(),
            round=r.i64(),
            value=r.bytes32(),
            sender=r.bytes32(),
        )

    def with_signature(self, signature: bytes) -> "Prevote":
        return replace(self, signature=signature)


@wire_codec(tag="msg.precommit", max_bytes=256)
@dataclass(frozen=True, slots=True)
class Precommit:
    """The second voting step (reference: ``process/message.go:254-260``)."""

    height: int
    round: int
    value: bytes
    sender: bytes
    signature: bytes = field(default=b"", compare=False)
    _digest: bytes = field(default=b"", init=False, repr=False, compare=False)

    def digest(self) -> bytes:
        """Mirrors ``NewPrecommitHash`` (reference: process/message.go:263-284).

        A distinct domain-separation tag keeps prevote and precommit digests
        for the same (height, round, value) from colliding.
        Memoized (see :meth:`Propose.digest`).
        """
        d = self._digest
        if d:
            return d
        w = Writer()
        w.i64(self.height)
        w.i64(self.round)
        w.bytes32(self.value)
        d = hashlib.sha256(b"\x03" + w.data()).digest()
        object.__setattr__(self, "_digest", d)
        return d

    def size_hint(self) -> int:
        return 8 + 8 + 32 + 32

    def marshal(self, w: Writer) -> None:
        _check_i64(self.height, "height")
        _check_i64(self.round, "round")
        w.i64(self.height)
        w.i64(self.round)
        w.bytes32(self.value)
        w.bytes32(self.sender)

    @classmethod
    def unmarshal(cls, r: Reader) -> "Precommit":
        return cls(
            height=r.i64(),
            round=r.i64(),
            value=r.bytes32(),
            sender=r.bytes32(),
        )

    def with_signature(self, signature: bytes) -> "Precommit":
        return replace(self, signature=signature)


@wire_codec(tag="msg.timeout", max_bytes=32)
@dataclass(frozen=True, slots=True)
class Timeout:
    """A fired timeout event (reference: ``timer/timer.go:14-18``)."""

    message_type: MessageType
    height: int
    round: int

    def marshal(self, w: Writer) -> None:
        _check_i64(self.height, "height")
        _check_i64(self.round, "round")
        w.i8(int(self.message_type))
        w.i64(self.height)
        w.i64(self.round)

    @classmethod
    def unmarshal(cls, r: Reader) -> "Timeout":
        ty = r.i8()
        try:
            mt = MessageType(ty)
        except ValueError as e:
            raise SerdeError(f"invalid message type: {ty}") from e
        return cls(message_type=mt, height=r.i64(), round=r.i64())


_TYPE_TAGS = {
    Propose: MessageType.PROPOSE,
    Prevote: MessageType.PREVOTE,
    Precommit: MessageType.PRECOMMIT,
    Timeout: MessageType.TIMEOUT,
}

_TAG_CLASSES = {
    MessageType.PROPOSE: Propose,
    MessageType.PREVOTE: Prevote,
    MessageType.PRECOMMIT: Precommit,
    MessageType.TIMEOUT: Timeout,
}


#: Widest detached signature the envelope accepts: Ed25519 is 64 bytes,
#: BLS12-381 G2 is 96 — anything longer is a Byzantine frame, not a key
#: format we will ever grow into silently.
_MAX_SIGNATURE = 96


@wire_codec(tag="msg.envelope", max_bytes=1 << 20)
def marshal_message(msg, w: Writer) -> None:
    """Marshal any message with a leading type tag (the wire envelope used
    by scenario records). Unlike the core message serde, the envelope also
    carries the detached signature — on a real wire the signature travels
    with the message."""
    tag = _TYPE_TAGS.get(type(msg))
    if tag is None:
        raise SerdeError(f"unknown message type: {type(msg)!r}")
    w.i8(int(tag))
    msg.marshal(w)
    if not isinstance(msg, Timeout):
        w.raw(msg.signature)


@wire_codec(tag="msg.envelope", max_bytes=1 << 20)
def unmarshal_message(r: Reader):
    """Inverse of :func:`marshal_message`. Unknown tags and oversized
    trailing signatures are typed rejections — the envelope is the first
    decode a Byzantine peer's bytes meet."""
    ty = r.i8()
    try:
        cls = _TAG_CLASSES[MessageType(ty)]
    except (ValueError, KeyError) as e:
        raise SerdeError(f"invalid message tag: {ty}") from e
    msg = cls.unmarshal(r)
    if cls is not Timeout:
        signature = r.raw()
        if len(signature) > _MAX_SIGNATURE:
            raise SerdeError(
                f"detached signature too wide: {len(signature)} > "
                f"{_MAX_SIGNATURE}"
            )
        if signature:
            msg = msg.with_signature(signature)
    return msg
