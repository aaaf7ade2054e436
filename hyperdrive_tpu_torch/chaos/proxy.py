"""ChaosProxy: a frame-aware fault-injecting TCP forwarder.

The deterministic harness interprets FaultPlans in virtual time; this is
the same fault vocabulary applied to the REAL transport
(:class:`~hyperdrive_tpu_torch.transport.TcpNode`): a proxy listens on its own
port, peers dial it instead of the target node, and every length-framed
consensus envelope flowing through it can be dropped, duplicated,
delayed, or black-holed by an in-flight :meth:`partition` /
:meth:`heal` toggle.

The proxy parses the transport's 4-byte little-endian framing rather
than splicing raw bytes, so faults land on whole messages — dropping
half a frame would just desynchronize the stream and close the
connection, which is a different (and less interesting) failure than
losing a vote. Faults draw from a seeded RNG; counters
(``forwarded``/``dropped``) make tests assertable.

One proxy covers one direction (peer -> target inbound). Symmetric
partitions place one in front of each side — exactly how toxiproxy-style
tools are deployed.

Port copy of ``hyperdrive_tpu/chaos/proxy.py``, whole. It does no device
work: it sits between :class:`~hyperdrive_tpu_torch.transport.TcpNode`
sockets on the host.
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time

__all__ = ["ChaosProxy"]

_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 20  # match transport.py: beyond this is a framing attack


class ChaosProxy:
    """Listen on ``self.port``; forward framed traffic to
    ``(target_host, target_port)`` with seeded faults.

    Parameters mirror :class:`~hyperdrive_tpu_torch.chaos.plan.LinkFault`:
    ``drop``/``duplicate``/``delay`` are per-frame probabilities, and a
    delayed frame sleeps a uniform draw from ``delay_s`` before being
    written (the link stays FIFO — real TCP links are). While
    partitioned, inbound frames are read and discarded, keeping the
    peer's connection alive so heal resumes without a redial.

    ``bandwidth_bps > 0`` models a slow link rather than a lossy one:
    every forwarded frame pays a serialization delay of ``frame bits /
    bandwidth_bps`` seconds before the write (FIFO, so the slow-peer
    backlog accumulates exactly as a saturated pipe would). This is the
    overload family's slow-peer fault — the reader-side complement of
    the sender's backpressure: the target node's peer queue toward a
    throttled peer fills and sheds while healthy peers stay fast.

    ``fuzz_every = K > 0`` is the Byzantine-bytes fault: every Kth
    forwarded frame has its PAYLOAD mutated (seeded truncate / extend /
    bitflip / tag-swap, same vocabulary as tests/test_wire_audit.py)
    and its length header recomputed, so the stream stays parseable and
    the corruption lands in the target's DECODE path, not its framing
    layer. The target must count the frame (``malformed_frames``) or
    deliver a still-valid decode — never crash a read thread. ``fuzzed``
    counts mutations for assertions.
    """

    def __init__(
        self,
        target_host: str,
        target_port: int,
        *,
        listen_host: str = "127.0.0.1",
        seed: int = 0,
        drop: float = 0.0,
        duplicate: float = 0.0,
        delay: float = 0.0,
        delay_s: tuple[float, float] = (0.005, 0.05),
        bandwidth_bps: float = 0.0,
        fuzz_every: int = 0,
    ) -> None:
        self._target = (target_host, target_port)
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.drop = drop
        self.duplicate = duplicate
        self.delay = delay
        self.delay_s = delay_s
        if bandwidth_bps < 0.0:
            raise ValueError(
                f"bandwidth_bps must be >= 0, got {bandwidth_bps}"
            )
        self.bandwidth_bps = bandwidth_bps
        #: Cumulative seconds of serialization delay paid (tests assert
        #: the throttle actually bit).
        self.throttled_s = 0.0
        if fuzz_every < 0:
            raise ValueError(f"fuzz_every must be >= 0, got {fuzz_every}")
        self.fuzz_every = fuzz_every
        #: Frames mutated by the fuzz fault (tests assert the mutation
        #: cadence actually bit).
        self.fuzzed = 0
        self._fuzz_ctr = 0
        self._partitioned = threading.Event()
        self._stop = threading.Event()
        self.forwarded = 0
        self.dropped = 0
        self._count_lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((listen_host, 0))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True)
        ]

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ChaosProxy":
        for t in self._threads:
            if not t.is_alive():
                t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._count_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- faults

    def partition(self) -> None:
        """Black-hole traffic (frames read and discarded) until heal."""
        self._partitioned.set()

    def heal(self) -> None:
        self._partitioned.clear()

    @property
    def partitioned(self) -> bool:
        return self._partitioned.is_set()

    # ------------------------------------------------------------ plumbing

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._count_lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._pipe, args=(conn,), daemon=True
            ).start()

    def _pipe(self, conn: socket.socket) -> None:
        """One inbound connection: parse frames, apply faults, forward
        over a dedicated upstream connection (dialed lazily so the proxy
        can accept before the target listens)."""
        upstream: socket.socket | None = None
        try:
            with conn:
                while not self._stop.is_set():
                    frame = self._read_frame(conn)
                    if frame is None:
                        return
                    if self._partitioned.is_set():
                        self._note(dropped=1)
                        continue
                    with self._rng_lock:
                        r_drop = self._rng.random()
                        r_dup = self._rng.random()
                        r_delay = self._rng.random()
                        pause = self._rng.uniform(*self.delay_s)
                    if self.drop and r_drop < self.drop:
                        self._note(dropped=1)
                        continue
                    if self.delay and r_delay < self.delay:
                        time.sleep(pause)
                    if self.bandwidth_bps:
                        # Slow link: serialization time proportional to
                        # frame size, paid on every frame (deterministic
                        # in size, not seeded — a pipe's width is not a
                        # coin flip).
                        pay = len(frame) * 8.0 / self.bandwidth_bps
                        with self._count_lock:
                            self.throttled_s += pay
                        time.sleep(pay)
                    if self.fuzz_every:
                        with self._count_lock:
                            self._fuzz_ctr += 1
                            hit = self._fuzz_ctr % self.fuzz_every == 0
                        if hit:
                            frame = self._fuzz(frame)
                            with self._count_lock:
                                self.fuzzed += 1
                    copies = (
                        2 if self.duplicate and r_dup < self.duplicate else 1
                    )
                    for _ in range(copies):
                        if upstream is None:
                            upstream = self._dial()
                            if upstream is None:
                                return
                        try:
                            upstream.sendall(frame)
                        except OSError:
                            return
                        self._note(forwarded=1)
        finally:
            if upstream is not None:
                try:
                    upstream.close()
                except OSError:
                    pass

    def _fuzz(self, frame: bytes) -> bytes:
        """Mutate a frame's payload and recompute its length header.

        The framing layer stays intact on purpose: a bad length prefix
        only exercises the target's ``_read_frame`` guard, while a
        well-framed garbage payload reaches ``unmarshal_message`` — the
        decode path HD007/HDS005 exist to defend. Mutations mirror the
        wire-audit corpus: truncate, extend with junk, flip one bit,
        smash the leading tag byte."""
        payload = frame[_LEN.size:]
        with self._rng_lock:
            kind = self._rng.randrange(4)
            if kind == 0 and len(payload) > 1:
                payload = payload[: self._rng.randrange(1, len(payload))]
            elif kind == 1:
                payload = payload + bytes(
                    self._rng.randrange(256)
                    for _ in range(self._rng.randrange(1, 17))
                )
            elif kind == 2 and payload:
                i = self._rng.randrange(len(payload))
                b = bytearray(payload)
                b[i] ^= 1 << self._rng.randrange(8)
                payload = bytes(b)
            elif payload:
                b = bytearray(payload)
                b[0] = self._rng.randrange(256)
                payload = bytes(b)
        return _LEN.pack(len(payload)) + payload

    def _dial(self) -> "socket.socket | None":
        deadline = time.monotonic() + 5.0
        while not self._stop.is_set() and time.monotonic() < deadline:
            try:
                s = socket.create_connection(self._target, timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with self._count_lock:
                    self._conns.append(s)
                return s
            except OSError:
                time.sleep(0.05)
        return None

    def _read_frame(self, conn: socket.socket) -> "bytes | None":
        head = self._recv_exact(conn, _LEN.size)
        if head is None:
            return None
        (length,) = _LEN.unpack(head)
        if length > _MAX_FRAME:
            return None  # mirror the transport: framing attack, hang up
        payload = self._recv_exact(conn, length)
        if payload is None:
            return None
        return head + payload

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> "bytes | None":
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _note(self, forwarded: int = 0, dropped: int = 0) -> None:
        with self._count_lock:
            self.forwarded += forwarded
            self.dropped += dropped
