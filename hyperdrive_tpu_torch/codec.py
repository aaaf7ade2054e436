"""Deterministic binary codec with strict byte-budget accounting.

Provides the capability the reference gets from ``renproject/surge``
(reference usage: ``process/state.go:168-279``, ``process/message.go``):
fixed-width little-endian integers, 32-byte arrays, length-prefixed
containers, and a *remaining-byte budget* threaded through every operation so
that adversarial input raises :class:`SerdeError` — it never panics and never
allocates unboundedly. The encoding is canonical (map keys are sorted), so a
marshaled structure is a stable fingerprint suitable for hashing and replay.

This codec is host-side plumbing; the device path packs the same messages
into NumPy structured arrays (see the JAX package's ``batch`` module).
"""

from __future__ import annotations

import struct

__all__ = [
    "SerdeError",
    "MAX_BYTES",
    "Writer",
    "Reader",
]

#: Default byte budget, mirroring surge.MaxBytes's DoS-hardening role.
MAX_BYTES = 8 * 1024 * 1024

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I8 = struct.Struct("<b")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class SerdeError(Exception):
    """Raised on any malformed input or exhausted byte budget."""


class Writer:
    """Appends fixed-width values while charging them against a byte budget."""

    __slots__ = ("_parts", "rem")

    def __init__(self, rem: int = MAX_BYTES):
        self._parts: list[bytes] = []
        self.rem = rem

    def _take(self, n: int) -> None:
        if self.rem < n:
            raise SerdeError(f"byte budget exhausted: need {n}, have {self.rem}")
        self.rem -= n

    def _pack(self, st: struct.Struct, v) -> None:
        self._take(st.size)
        try:
            self._parts.append(st.pack(v))
        except struct.error as e:
            raise SerdeError(str(e)) from e

    def u8(self, v: int) -> None:
        self._pack(_U8, v)

    def u16(self, v: int) -> None:
        self._pack(_U16, v)

    def u32(self, v: int) -> None:
        self._pack(_U32, v)

    def u64(self, v: int) -> None:
        self._pack(_U64, v)

    def i8(self, v: int) -> None:
        self._pack(_I8, v)

    def i64(self, v: int) -> None:
        self._pack(_I64, v)

    def f64(self, v: float) -> None:
        self._pack(_F64, v)

    def bool(self, v: bool) -> None:
        self._pack(_U8, 1 if v else 0)

    def bytes32(self, v: bytes) -> None:
        if len(v) != 32:
            raise SerdeError(f"expected 32 bytes, got {len(v)}")
        self._take(32)
        self._parts.append(bytes(v))

    def raw(self, v: bytes) -> None:
        """Length-prefixed variable byte string."""
        self.u32(len(v))
        self._take(len(v))
        self._parts.append(bytes(v))

    def data(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    """Consumes fixed-width values, charging both the buffer and the budget.

    Any out-of-bounds read raises :class:`SerdeError`; fuzzed inputs must
    never crash the caller (reference test contract:
    ``process/state_test.go:20-29``).
    """

    __slots__ = ("_buf", "_pos", "rem")

    def __init__(self, data: bytes, rem: int = MAX_BYTES):
        self._buf = memoryview(bytes(data))
        self._pos = 0
        self.rem = rem

    def _take(self, n: int) -> memoryview:
        if self.rem < n:
            raise SerdeError(f"byte budget exhausted: need {n}, have {self.rem}")
        if self._pos + n > len(self._buf):
            raise SerdeError(
                f"buffer underflow: need {n} at {self._pos}, len {len(self._buf)}"
            )
        self.rem -= n
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def _unpack(self, st: struct.Struct):
        return st.unpack(self._take(st.size))[0]

    def u8(self) -> int:
        return self._unpack(_U8)

    def u16(self) -> int:
        return self._unpack(_U16)

    def u32(self) -> int:
        return self._unpack(_U32)

    def u64(self) -> int:
        return self._unpack(_U64)

    def i8(self) -> int:
        return self._unpack(_I8)

    def i64(self) -> int:
        return self._unpack(_I64)

    def f64(self) -> float:
        return self._unpack(_F64)

    def bool(self) -> bool:
        v = self.u8()
        if v not in (0, 1):
            raise SerdeError(f"invalid bool byte: {v}")
        return v == 1

    def bytes32(self) -> bytes:
        return bytes(self._take(32))

    def raw(self) -> bytes:
        n = self.u32()
        return bytes(self._take(n))

    def done(self) -> bool:
        return self._pos == len(self._buf)

    def remaining_bytes(self) -> int:
        return len(self._buf) - self._pos
