"""Cross-process causal trace propagation (the distributed half of obs).

Every per-process journal is causally blind past its own socket: a
``service.remote.submit`` in the parent and the matching
``exec.apply`` in a child tenant share no key, so commit latency on
a real deployment could not be attributed to a hop. This module
defines the compact trace-context stamp that rides in front of wire
frames:

    [u8 magic 0x54]["origin" u32]["seq" u64]["parent" u64]   (21 bytes)

``origin`` is the stamping process's trace id, ``seq`` a per-process
monotone frame counter, and ``parent`` an optional upstream
(origin << 32 | seq) reference for frames sent in reaction to a
received one. The magic byte cannot collide with any existing first
byte on either protocol: consensus envelopes open with a small
non-negative MessageType i8 and service frames with tags 1..5, while
0x54 is well clear of both. A reader peeks one byte, strips the stamp
when present, and decodes the remainder exactly as before, so unstamped
peers interoperate unchanged.

Stamping emits ``trace.send`` and stripping emits ``trace.recv``,
both with detail ``"origin:seq"``: the one shared key
:func:`~hyperdrive_tpu_torch.obs.merge.merge_journals` pairs across
journals and the Perfetto exporter draws cross-process flow arrows on.

Port copy of ``hyperdrive_tpu/obs/tracectx.py``: stamps are byte for
byte the JAX package's, so a traced process of either package merges
with the other's. The codec registers as the ``trace.ctx`` wire family
(64 bytes) and :func:`decode_stamp` reads through the sanitizer's budget
reader, as in the reference.
"""

from __future__ import annotations

import threading

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.analysis.sanitizer import maybe_wire_reader
from hyperdrive_tpu_torch.codec import SerdeError, Writer
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = [
    "TRACE_MAGIC",
    "STAMP_LEN",
    "encode_stamp",
    "decode_stamp",
    "split_frame",
    "span_id",
    "TraceSource",
    "note_recv",
]

#: First byte of every stamp. 0x54 ('T'): distinct from the i8
#: MessageType consensus envelopes open with and the 1..5 service tags.
TRACE_MAGIC = 0x54

#: Fixed stamp width: magic u8 + origin u32 + seq u64 + parent u64.
STAMP_LEN = 1 + 4 + 8 + 8


@wire_codec(tag="trace.ctx", max_bytes=64)
def encode_stamp(origin: int, seq: int, parent: int = 0) -> bytes:
    w = Writer()
    w.u8(TRACE_MAGIC)
    w.u32(origin)
    w.u64(seq)
    w.u64(parent)
    return w.data()


@wire_codec(tag="trace.ctx", max_bytes=64)
def decode_stamp(payload: bytes):
    """Decode one bare stamp to ``(origin, seq, parent)``.

    Rejects a wrong magic byte and trailing garbage with
    :class:`SerdeError`, so a fuzzed frame fails typed; the HDS005 budget
    (64 bytes) is charged through :func:`maybe_wire_reader` like every
    registered family.
    """
    r = maybe_wire_reader("trace.ctx", payload)
    magic = r.u8()
    if magic != TRACE_MAGIC:
        raise SerdeError(f"bad trace stamp magic {magic:#x}")
    origin = r.u32()
    seq = r.u64()
    parent = r.u64()
    if not r.done():
        raise SerdeError("trailing bytes after trace stamp")
    return origin, seq, parent


def split_frame(payload):
    """Strip a leading stamp from a frame payload, if present.

    Returns ``(ctx, rest)`` where ``ctx`` is ``(origin, seq, parent)``
    or ``None`` for an unstamped frame: peers that never learned to
    stamp keep decoding byte-identically.
    """
    if len(payload) < STAMP_LEN or payload[0] != TRACE_MAGIC:
        return None, payload
    ctx = decode_stamp(bytes(payload[:STAMP_LEN]))
    return ctx, payload[STAMP_LEN:]


def span_id(origin: int, seq: int) -> int:
    """The flow-arrow / parent-ref key: ``origin << 32 | seq``."""
    return (origin << 32) | (seq & 0xFFFFFFFF)


class TraceSource:
    """Per-process stamp mint: one monotone seq, one origin id.

    ``stamp()`` prefixes a payload with a fresh stamp and emits
    ``trace.send``; the counter is lock-guarded by default because
    TcpNode broadcast and the service client both send from multiple
    threads. Origin 0 is reserved for "tracing off": the transports
    treat a ``None`` source as the no-stamp fast path.
    """

    __slots__ = ("origin", "obs", "_lock", "_seq")

    def __init__(self, origin: int, obs=None, threadsafe: bool = True):
        if origin <= 0:
            raise ValueError("trace origin must be a positive int")
        self.origin = origin
        self.obs = obs if obs is not None else NULL_BOUND
        self._lock = threading.Lock() if threadsafe else None
        self._seq = 0

    def _next(self) -> int:
        lock = self._lock
        if lock is None:
            self._seq += 1
            return self._seq
        with lock:
            self._seq += 1
            return self._seq

    def stamp(self, payload: bytes, parent: int = 0,
              height: int = -1, round_: int = -1) -> bytes:
        seq = self._next()
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "trace.send", height, round_, f"{self.origin}:{seq}"
            )
        return encode_stamp(self.origin, seq, parent) + payload


def note_recv(obs, ctx, height: int = -1, round_: int = -1) -> None:
    """Emit the receive-side half of a span: ``trace.recv`` keyed on
    the SENDER's ``origin:seq`` so merge can pair it with the matching
    ``trace.send`` in another process's journal."""
    if obs is not NULL_BOUND and ctx is not None:
        obs.emit("trace.recv", height, round_, f"{ctx[0]}:{ctx[1]}")
