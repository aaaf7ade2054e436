"""Loopback-TCP binding of the Broadcaster seam.

The reference leaves networking to the embedding application: the
``Broadcaster`` interface is the whole communication contract (broadcast
to all including self, eventual delivery, no ordering; reference:
process/process.go:47-60). This module binds that seam to real sockets: a
full-mesh, length-framed TCP transport driving threaded replicas
(:meth:`~hyperdrive_tpu_torch.replica.Replica.run`) with wall-clock
:class:`~hyperdrive_tpu_torch.timer.LinearTimer` timeouts, so consensus
runs across OS processes with no shared memory. It carries the consensus
envelopes a deployment gossips over its host network; the card sees only
the verify and tally work behind each replica.

Wire format: 4-byte little-endian length + the signed message envelope
(:func:`hyperdrive_tpu_torch.messages.marshal_message`). A malformed
envelope from a peer is counted and dropped; an oversize length header
closes only that peer's connection.

Port copy of ``hyperdrive_tpu/transport.py``: :func:`encode_frame`,
:func:`reconnect_schedule`, :class:`TcpNode` (accept, read and per-peer
send loops, oldest-frame shedding of a full peer backlog, the
``malformed_frames``, ``oversize_frames`` and ``dropped_frames``
counters), :class:`TcpBroadcaster`, :class:`FlightRecorder` and
:func:`replay_flight`; frames and flight logs are byte for byte the JAX
package's. Dropped, as the port's conventions say: the wire-codec lint
markers (``analysis.annotations``), the sanitizer's wire reader
(``analysis.sanitizer``), the causal trace stamp (``trace=``,
``obs.tracectx``), the metrics recorder (the ``obs=`` argument), the
metrics registry (``registry=``), the logger (``utils.log``; the counters stay), the
admission gate (``admission=``, the ``load/`` package) and with it the
priority-aware prevote shedding, and the retired-generation filter on
wire ingress (it needs ``load.frames``). Epochs are not ported:
:meth:`TcpNode.rotate_epoch` raises ``NotImplementedError``, as do the
constructor's ``trace``, ``admission`` and ``registry`` when they are not
None.
"""

from __future__ import annotations

import queue
import random
import socket
import struct
import threading

from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.messages import (
    Precommit,
    Prevote,
    Propose,
    marshal_message,
    unmarshal_message,
)
from hyperdrive_tpu_torch.replica import ResetHeight

__all__ = [
    "TcpBroadcaster",
    "TcpNode",
    "encode_frame",
    "reconnect_schedule",
    "FlightRecorder",
    "replay_flight",
]

_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 20  # 1 MiB: far above any consensus envelope
#: Per-peer outbound buffer (frames). A peer that stays unreachable longer
#: than this many broadcasts sees the oldest frames dropped: best-effort,
#: as in the reference's trust model, where eventual delivery is the
#: embedding network's promise (process/process.go:47-60).
_PEER_QUEUE = 4096

_LATER = "not ported to the PyTorch package yet (a later slice of the port)"


def encode_frame(msg) -> bytes:
    w = Writer()
    marshal_message(msg, w)
    payload = w.data()
    return _LEN.pack(len(payload)) + payload


def reconnect_schedule(seed: int, key, *, base: float = 0.05,
                       factor: float = 2.0, cap: float = 2.0,
                       jitter: float = 0.5):
    """Seeded exponential-backoff delays for one peer's dialer.

    Yields connect-retry sleeps: a ramp from ``base`` (x ``factor`` per
    failed attempt) clamped at ``cap``, then stretched by up to ``jitter``
    (cap before jitter, so a mesh retrying a rebooted peer never
    synchronizes). Every yield lies in ``[delay, delay * (1 + jitter)]``
    with ``delay <= cap``. Deterministic per ``(seed, key)``; a node
    re-creates the generator after each successful connect.
    """
    if base <= 0.0 or cap < base:
        raise ValueError(
            f"backoff needs 0 < base <= cap, got base={base} cap={cap}"
        )
    if factor < 1.0 or jitter < 0.0:
        raise ValueError(
            f"backoff needs factor >= 1 and jitter >= 0, got "
            f"factor={factor} jitter={jitter}"
        )
    # String seeding hashes through SHA-512 inside random.seed: stable
    # across processes (hash() of a str is randomized per process).
    rng = random.Random(f"reconnect:{seed}:{key!r}")
    delay = base
    while True:
        yield delay * (1.0 + jitter * rng.random())
        delay = min(cap, delay * factor)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class TcpNode:
    """One process's endpoint of the full-mesh broadcast transport.

    Hosts any number of local replicas. :meth:`broadcast` serializes once,
    delivers to every LOCAL replica directly (the Broadcaster contract
    includes the sender), and queues the frame for every remote peer's
    sender thread. Inbound frames are decoded once and delivered to every
    local replica. Peers are dialed lazily with retries, so nodes may start
    in any order.
    """

    def __init__(self, listen_port: int = 0, host: str = "127.0.0.1",
                 admission=None, registry=None, seed: int = 0,
                 backoff=None, trace=None):
        for name, value in (("trace", trace), ("admission", admission),
                            ("registry", registry)):
            if value is not None:
                raise NotImplementedError(f"TcpNode({name}=...) is {_LATER}")
        self._host = host
        #: Reconnect-backoff shaping overrides (``base`` / ``factor`` /
        #: ``cap`` / ``jitter`` of :func:`reconnect_schedule`), validated
        #: here, not on the first outage.
        self.backoff = dict(backoff or {})
        next(reconnect_schedule(int(seed), None, **self.backoff))
        #: Seed for the per-peer reconnect backoff schedules.
        self.seed = int(seed)
        #: Wire-anomaly counters (guarded by ``_lock``): frames dropped for
        #: a malformed envelope / connections closed for an oversize
        #: length header.
        self.malformed_frames = 0
        self.oversize_frames = 0
        self._verifiers: list = []
        self._replicas: list = []
        #: peer key -> outbound frame queue, drained by one sender thread
        #: per peer: a dead or slow peer never stalls a broadcast.
        self._peer_queues: dict[tuple[str, int], queue.Queue] = {}
        #: peer key -> frames shed from that peer's backlog (``_PEER_QUEUE``
        #: overflow). Guarded by ``_lock``: any replica thread broadcasts.
        self.dropped_frames: dict[tuple[str, int], int] = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._accepted: list[socket.socket] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, listen_port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True)
        ]

    # ------------------------------------------------------------ lifecycle

    def add_replica(self, replica) -> None:
        """Register a local threaded replica (its ``propose``/``prevote``/
        ``precommit`` inbox methods receive every delivered message)."""
        self._replicas.append(replica)

    def add_peer(self, host: str, port: int) -> None:
        key = (host, port)
        if key in self._peer_queues:
            return
        q: queue.Queue = queue.Queue(maxsize=_PEER_QUEUE)
        self._peer_queues[key] = q
        self._threads.append(
            threading.Thread(
                target=self._send_loop, args=(key, q), daemon=True
            )
        )

    def register_wire_verifier(self, verifier) -> None:
        """Attach a wire-path signature verifier (e.g.
        :class:`~hyperdrive_tpu_torch.ops.ed25519_wire.TorchWireVerifier`)
        whose key table would follow this node's epoch switches."""
        self._verifiers.append(verifier)

    def rotate_epoch(self, generation: int, table=None,
                     retired=None) -> None:
        raise NotImplementedError(f"epoch rotation on the wire is {_LATER}")

    def start(self) -> None:
        for t in self._threads:
            if not t.is_alive():
                try:
                    t.start()
                except RuntimeError:
                    pass  # already started (idempotent start)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for q in self._peer_queues.values():
            try:
                q.put_nowait(None)  # wake the sender thread
            except queue.Full:
                pass
        with self._lock:
            for sock in self._accepted:
                try:
                    sock.close()
                except OSError:
                    pass
            self._accepted.clear()

    # ------------------------------------------------------------- inbound

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    continue
                self._accepted.append(conn)
            t = threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True
            )
            t.start()

    def _read_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    head = _recv_exact(conn, _LEN.size)
                    if head is None:
                        return
                    (length,) = _LEN.unpack(head)
                    if length > _MAX_FRAME:
                        with self._lock:
                            self.oversize_frames += 1
                        return  # framing attack: drop the connection
                    payload = _recv_exact(conn, length)
                    if payload is None:
                        return
                except OSError:
                    return
                try:
                    msg = unmarshal_message(Reader(payload))
                except SerdeError:
                    with self._lock:
                        self.malformed_frames += 1
                    continue  # malformed envelope: drop the frame
                if self._stop.is_set():
                    return
                self._deliver(msg)

    def _deliver(self, msg) -> None:
        # Timeouts are LOCAL events (each replica's own LinearTimer
        # enqueues them); one arriving off the wire is a forgery attempt
        # that could drive honest replicas into premature round changes.
        # Deliver only the three signed consensus message types.
        t = type(msg)
        for r in self._replicas:
            if t is Propose:
                r.propose(msg, self._stop)
            elif t is Prevote:
                r.prevote(msg, self._stop)
            elif t is Precommit:
                r.precommit(msg, self._stop)

    # ------------------------------------------------------------- outbound

    def _send_loop(self, key, q: "queue.Queue") -> None:
        """One peer's sender: connect (retrying on the seeded backoff of
        :func:`reconnect_schedule`, reset after every successful connect),
        then drain the frame queue. A dead peer costs nothing to anyone
        else: broadcasts only enqueue."""
        sock: socket.socket | None = None
        sched = reconnect_schedule(self.seed, key, **self.backoff)
        attempts = 0
        while not self._stop.is_set():
            frame = q.get()
            if frame is None or self._stop.is_set():
                break
            while not self._stop.is_set():
                if sock is None:
                    try:
                        sock = socket.create_connection(key, timeout=5.0)
                        sock.setsockopt(
                            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                        )
                    except OSError:
                        attempts += 1
                        if self._stop.wait(next(sched)):
                            break
                        continue
                    if attempts:
                        sched = reconnect_schedule(
                            self.seed, key, **self.backoff
                        )
                        attempts = 0
                try:
                    sock.sendall(frame)
                    break
                except OSError:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def broadcast(self, msg) -> None:
        """Fan out to all: local replicas directly, remote peers via their
        sender queues (never blocks on a slow or dead peer). A full peer
        queue sheds its oldest frame, counted per peer in
        ``dropped_frames``."""
        self._deliver(msg)
        frame = encode_frame(msg)
        for key, q in self._peer_queues.items():
            while True:
                try:
                    q.put_nowait(frame)
                    break
                except queue.Full:
                    try:
                        q.get_nowait()  # shed the oldest frame
                    except queue.Empty:
                        continue
                    self._count_shed(key)

    def _count_shed(self, key) -> None:
        with self._lock:
            self.dropped_frames[key] = self.dropped_frames.get(key, 0) + 1


class FlightRecorder:
    """One replica's consumption log: every input the replica's event loop
    consumed (votes, local timeouts, resets) in consumption order.

    The replica is the serialization point, so its log is a complete
    causal record: replaying it into a fresh in-process replica with the
    same deterministic DI set reproduces the replica's whole trajectory
    with no sockets, timers or other processes (the reference's
    failure.dump workflow, replica/replica_test.go:850-928, on the
    deployment path).

    ``record`` runs on the owning replica's event-loop thread only;
    ``dump`` may run on any thread after the loop stops.

    Format: per record, a one-byte kind tag (0 = message envelope,
    signatures included; 1 = height reset, height + signatory list), then
    the 4-byte-length-framed body.
    """

    KIND_MSG = 0
    KIND_RESET = 1

    def __init__(self):
        self.frames: list[bytes] = []

    def record(self, msg) -> None:
        w = Writer()
        if isinstance(msg, ResetHeight):
            kind = self.KIND_RESET
            w.i64(msg.height)
            w.u32(len(msg.signatories))
            for s in msg.signatories:
                w.raw(s)
        else:
            kind = self.KIND_MSG
            marshal_message(msg, w)
        body = w.data()
        self.frames.append(bytes([kind]) + _LEN.pack(len(body)) + body)

    def dump(self, path) -> None:
        with open(path, "wb") as f:
            for frame in self.frames:
                f.write(frame)

    @staticmethod
    def load(path) -> list:
        """Decode a dumped flight log back into input objects (messages and
        :class:`~hyperdrive_tpu_torch.replica.ResetHeight`), in recorded
        order.

        A partial trailing frame (the recording process was killed
        mid-write) ends the log cleanly: the intact prefix is returned. A
        corrupt frame body (unknown kind, malformed envelope) raises
        SerdeError.
        """
        out = []
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        n = len(data)
        while off < n:
            if n - off < 5:
                break  # partial header: killed mid-write
            kind = data[off]
            (length,) = _LEN.unpack(data[off + 1 : off + 5])
            body = data[off + 5 : off + 5 + length]
            if len(body) != length:
                break  # partial body: killed mid-write
            off += 5 + length
            if kind == FlightRecorder.KIND_MSG:
                out.append(unmarshal_message(Reader(body)))
            elif kind == FlightRecorder.KIND_RESET:
                r = Reader(body)
                height = r.i64()
                sigs = tuple(r.raw() for _ in range(r.u32()))
                out.append(ResetHeight(height, sigs))
            else:
                raise SerdeError(f"unknown flight record kind {kind}")
        return out


def replay_flight(path, replica) -> None:
    """Re-drive a fresh replica through a dumped flight log, offline.

    ``replica`` must be built with the DI set the recorded run used
    (proposer, validator, committer semantics, signatory whitelist and,
    for signed runs, an equivalent verifier: the log holds raw
    pre-verification inputs, signatures included). Its broadcaster may be
    None (every self-delivered broadcast the live run consumed is in the
    log) and so may its timer (recorded Timeouts stand in for the clock).
    """
    replica.start()
    for msg in FlightRecorder.load(path):
        replica.handle(msg)


class TcpBroadcaster:
    """Per-replica Broadcaster facade over a shared :class:`TcpNode`,
    signing each outbound message when a keypair is supplied (the wire
    envelope carries the detached signature)."""

    def __init__(self, node: TcpNode, keypair=None):
        self._node = node
        self._kp = keypair

    def _send(self, msg) -> None:
        if self._kp is not None:
            msg = self._kp.sign_message(msg)
        self._node.broadcast(msg)

    def broadcast_propose(self, propose: Propose) -> None:
        self._send(propose)

    def broadcast_prevote(self, prevote: Prevote) -> None:
        self._send(prevote)

    def broadcast_precommit(self, precommit: Precommit) -> None:
        self._send(precommit)
