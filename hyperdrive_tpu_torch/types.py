"""Core scalar types and sentinels for the consensus automaton.

Capability parity with the reference's type layer
(``process/state.go:283-338`` in the reference tree): heights and rounds are
signed 64-bit integers, steps are a tiny enum, values and signatories are
32-byte identifiers. The new framework makes two deliberate design changes:

- A ``Signatory`` is the raw 32-byte Ed25519 public key (the reference uses a
  Keccak hash of a secp256k1 public key, ``renproject/id``). Using the key
  itself as the identity removes one indirection and is exactly the array
  layout the TPU verification kernel wants.
- All types are plain Python ``int`` / ``bytes`` rather than wrapper classes,
  so messages can be packed densely into NumPy structured arrays for the
  batched device path.
"""

from __future__ import annotations

import enum

# Heights and rounds are int64 on the wire. Python ints are unbounded; the
# codec enforces the 64-bit range at serialization boundaries.
Height = int
Round = int

# 32-byte hash of a proposed value (a block, in blockchain terms).
Value = bytes

# 32-byte replica identity (Ed25519 public key).
Signatory = bytes

#: The genesis block is assumed to exist at height 0, so consensus starts at 1
#: (reference: process/state.go:12-14).
DEFAULT_HEIGHT: Height = 1
DEFAULT_ROUND: Round = 0

#: Reserved round meaning "no such round" — used for LockedRound/ValidRound
#: before any lock exists (reference: process/state.go:304).
INVALID_ROUND: Round = -1

#: Reserved all-zero value meaning "vote for nothing / advance the round"
#: (reference: process/state.go:337).
NIL_VALUE: Value = b"\x00" * 32

#: Reserved all-zero signatory (never a valid Ed25519 key in practice).
NIL_SIGNATORY: Signatory = b"\x00" * 32

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


class Step(enum.IntEnum):
    """The three steps of a consensus round (reference: process/state.go:288-295)."""

    PROPOSING = 0
    PREVOTING = 1
    PRECOMMITTING = 2


class MessageType(enum.IntEnum):
    """Wire tags for consensus messages (reference: process/message.go:11-22)."""

    PROPOSE = 1
    PREVOTE = 2
    PRECOMMIT = 3
    TIMEOUT = 4


def check_value(value: bytes, what: str = "value") -> bytes:
    """Validate that ``value`` is exactly 32 bytes."""
    if not isinstance(value, (bytes, bytearray)) or len(value) != 32:
        raise ValueError(f"{what} must be 32 bytes, got {value!r}")
    return bytes(value)


def check_int64(v: int, what: str = "int") -> int:
    """Validate that ``v`` fits a signed 64-bit integer."""
    if not INT64_MIN <= v <= INT64_MAX:
        raise ValueError(f"{what} out of int64 range: {v}")
    return v
