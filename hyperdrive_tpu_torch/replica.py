"""The Replica driver: an event loop around one consensus Process.

Capability parity with the reference's ``replica/replica.go``: a Replica
owns a :class:`~hyperdrive_tpu_torch.process.Process` and a
:class:`~hyperdrive_tpu_torch.mq.MessageQueue`, computes ``f = n // 3`` from
the signatory set, filters messages below the current height, whitelists
senders, serializes all handling through a single inbox, and supports
``ResetHeight`` resync.

Two driving modes:

- **Synchronous** (:meth:`Replica.handle`, and the two-phase external
  flush ``drain_pending``/``dispatch_window`` with
  ``ingest_insert_window``/``ingest_cascade_window`` for device tallies,
  which the simulator's settle layer drives);
- **Threaded** (:meth:`Replica.run`): a background thread drains a
  ``queue.Queue`` inbox until a stop event fires (the reference's
  ``Replica.Run``, replica/replica.go:88-151), fed by
  :class:`~hyperdrive_tpu_torch.transport.TcpNode`. A ``flusher``
  (:class:`~hyperdrive_tpu_torch.tallyflush.DeviceTallyFlusher`,
  :class:`~hyperdrive_tpu_torch.devsched.flusher.QueueFlusher`) takes over
  the flush; a ``recorder``
  (:class:`~hyperdrive_tpu_torch.transport.FlightRecorder`) logs every
  consumed input; :meth:`Replica.restore` revives a crashed replica from a
  checkpoint (:mod:`hyperdrive_tpu_torch.utils.checkpoint`).

Port copy of ``hyperdrive_tpu/replica.py``, plus :func:`merge_drain`.
Removed: the tracer, logger, metrics recorder (``obs``) and sanitizer
hooks (``utils.trace``, ``utils.log``, ``obs.recorder``,
``analysis.sanitizer``, ``@hot_path``) and the committer/catcher wrappers
that only fed them; the epoch stale-key filter and the admission gate
(neither exists in this package yet). A ``certifier``
(:class:`~hyperdrive_tpu_torch.certificates.Certifier`) goes to the
Process, which mints a certificate at every commit. Not ported yet, and
refused with ``NotImplementedError``: the columnar settle path
(``dispatch_window_cols``).
"""

from __future__ import annotations

import queue as _queue
import threading
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Optional

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose, Timeout
from hyperdrive_tpu_torch.mq import DEFAULT_MAX_CAPACITY, MessageQueue
from hyperdrive_tpu_torch.process import (
    Broadcaster,
    Catcher,
    Committer,
    Process,
    Proposer,
    Timer,
    Validator,
)
from hyperdrive_tpu_torch.scheduler import RoundRobin
from hyperdrive_tpu_torch.state import State
from hyperdrive_tpu_torch.types import (
    DEFAULT_HEIGHT,
    Height,
    MessageType,
    Round,
    Signatory,
    Step,
)
from hyperdrive_tpu_torch.utils.checkpoint import restore_bytes

__all__ = ["Replica", "ReplicaOptions", "ResetHeight", "merge_drain"]

#: Named in every refusal of a reference feature this package lacks.
_LATER = "not ported to the PyTorch package yet (a later slice of the port)"


def merge_drain(backlog: list, fresh: list, order_of) -> list:
    """Merge two message lists under the drain ordering contract: global
    ascending (height, round), senders tie-broken by ``order_of``
    registration order, ``backlog`` entries preceding ``fresh`` on full
    ties (backlog predates by construction), FIFO within each list.

    Shared by :meth:`Replica.drain_pending` (queue backlog + fast lane)
    and the harness's shared-superstep window builder (queue backlog +
    shared broadcast lane).
    """
    if not fresh:
        return backlog
    if not backlog:
        fresh = [
            (m.height, m.round, order_of(m.sender), j, m)
            for j, m in enumerate(fresh)
        ]
        fresh.sort()
        return [t[4] for t in fresh]
    keyed = [
        (m.height, m.round, order_of(m.sender), 0, j, m)
        for j, m in enumerate(backlog)
    ]
    keyed += [
        (m.height, m.round, order_of(m.sender), 1, j, m)
        for j, m in enumerate(fresh)
    ]
    keyed.sort()
    return [t[5] for t in keyed]


@dataclass(frozen=True)
class ReplicaOptions:
    """Immutable functional options (reference: replica/opt.go:11-46)."""

    starting_height: Height = DEFAULT_HEIGHT
    max_capacity: int = DEFAULT_MAX_CAPACITY
    verify_window: int = 1024
    #: When True, :meth:`Replica.handle` buffers into the mq but never
    #: flushes — an external driver runs the two-phase
    #: :meth:`Replica.drain_pending` / :meth:`Replica.dispatch_window`
    #: protocol so many replicas' windows can be signature-verified in one
    #: aggregated device launch (the harness burst mode).
    external_flush: bool = False
    #: When True, :meth:`Replica.dispatch_window` feeds survivors through
    #: the Process's batched ingestion — one rule-cascade pass per window
    #: instead of per message.
    batch_ingest: bool = False

    def with_starting_height(self, height: Height) -> "ReplicaOptions":
        return replace(self, starting_height=height)

    def with_max_capacity(self, capacity: int) -> "ReplicaOptions":
        return replace(self, max_capacity=capacity)

    def with_verify_window(self, window: int) -> "ReplicaOptions":
        return replace(self, verify_window=window)


@dataclass(frozen=True)
class ResetHeight:
    """Resync instruction: jump to ``height``, optionally rotating the
    signatory set (reference: replica/replica.go:266-270)."""

    height: Height
    signatories: tuple[Signatory, ...] = ()


class Replica:
    """A replicated-state-machine participant."""

    def __init__(
        self,
        opts: ReplicaOptions,
        whoami: Signatory,
        signatories: list[Signatory],
        timer: Optional[Timer],
        proposer: Optional[Proposer],
        validator: Optional[Validator],
        committer: Optional[Committer],
        catcher: Optional[Catcher],
        broadcaster: Optional[Broadcaster],
        did_handle_message: Optional[Callable[[], None]] = None,
        verifier=None,
        flusher=None,
        recorder=None,
        certifier=None,
    ):
        f = len(signatories) // 3
        self.opts = opts
        self.proc = Process(
            whoami=whoami,
            f=f,
            timer=timer,
            scheduler=RoundRobin(signatories),
            proposer=proposer,
            validator=validator,
            broadcaster=broadcaster,
            committer=committer,
            certifier=certifier,
            catcher=catcher,
            height=opts.starting_height,
        )
        self.procs_allowed: set[Signatory] = set(signatories)
        self.mq = MessageQueue(max_capacity=opts.max_capacity)
        # Pre-register the whitelist in the queue's tie-break order map:
        # "senders tie-broken by registration order" then means whitelist
        # order — identical across replicas and across driving modes.
        for s in signatories:
            self.mq.order_of(s)
        self.did_handle_message = did_handle_message
        self.verifier = verifier
        #: Optional flush delegate (``flush(replica) -> None`` drains the
        #: queue to quiescence): the seam a deployment uses to put a device
        #: vote grid behind this replica's own event loop
        #: (:class:`~hyperdrive_tpu_torch.tallyflush.DeviceTallyFlusher`).
        self.flusher = flusher
        #: Optional consumption log (``record(msg)``): every input this
        #: replica consumes, in consumption order
        #: (:class:`~hyperdrive_tpu_torch.transport.FlightRecorder`).
        self.recorder = recorder
        self._inbox: _queue.Queue = _queue.Queue(maxsize=opts.max_capacity)
        # Synchronous-mode reentrancy guard: a broadcaster wired straight
        # back into handle() (loopback) must enqueue, not recurse.
        self._handling = False
        self._pending: deque = deque()
        # Burst fast lane (external_flush only): votes for the CURRENT
        # height skip the sorted queue entirely; drain_pending merges lane
        # and queue under the same (height, round, sender, arrival)
        # ordering the queue drain guarantees. Per-sender capacity mirrors
        # the queue's bound so a current-height flood cannot bypass DoS
        # limits.
        self._lane: list = []
        self._lane_counts: dict = {}

    # ------------------------------------------------------------ sync driving

    def start(self) -> None:
        """Start the underlying Process (round 0 of the starting height)."""
        self.proc.start()

    def restore(self, checkpoint: "bytes | None" = None) -> None:
        """Crash-restart revive path: restore the Process from a
        checkpoint envelope (:mod:`hyperdrive_tpu_torch.utils.checkpoint`)
        and reset every volatile buffer (the sorted queue, the burst fast
        lane, the reentrant backlog); only the checkpoint survives a
        crash. The queue's tie-break order map is kept: it derives from
        the whitelist, not from traffic.

        ``checkpoint=None`` models a replica that crashed before its first
        checkpoint: the Process restarts from the default state at
        ``opts.starting_height``. Callers then rejoin via ResetHeight or
        ``proc.resume()``.
        """
        if checkpoint is not None:
            restore_bytes(self.proc, checkpoint)
        else:
            self.proc.state = State.default_with_height(self.opts.starting_height)
        self.mq.clear()
        self._lane.clear()
        self._lane_counts.clear()
        self._pending.clear()
        if self.flusher is not None and hasattr(self.flusher, "reset"):
            # Queue-backed flushers hold in-flight settle futures; the
            # revived replica must not apply its dead predecessor's
            # windows on top of the checkpoint.
            self.flusher.reset(self)

    def handle(self, msg) -> None:
        """Synchronously handle one input message, then flush the queue
        (reference: replica/replica.go:104-148). Reentrant calls are
        buffered and drained by the outermost call."""
        self._pending.append(msg)
        if self._handling:
            return
        self._handling = True
        try:
            while self._pending:
                self._handle_one(self._pending.popleft())
        except BaseException:
            # A failing callback aborts the cascade; the undelivered tail
            # would otherwise leak into the next unrelated handle() call.
            self._pending.clear()
            raise
        finally:
            self._handling = False

    def handle_burst(self, msgs) -> None:
        """Buffer one superstep's deliveries in a single pass — identical
        to :meth:`handle` per message in ``external_flush`` mode (votes
        buffer to the fast lane or queue; timeouts and resets take the
        full path)."""
        if not self.opts.external_flush:
            raise RuntimeError(
                "handle_burst requires external_flush=True (burst driving); "
                "use handle() in self-flushing modes"
            )
        lane = self._lane
        counts = self._lane_counts
        cap = self.opts.max_capacity
        cur = self.proc.current_height
        dh = self.did_handle_message
        for msg in msgs:
            t = type(msg)
            if t is Prevote or t is Precommit or t is Propose:
                h = msg.height
                if h >= cur:
                    if h == cur:
                        c = counts.get(msg.sender, 0)
                        if c < cap:
                            counts[msg.sender] = c + 1
                            lane.append(msg)
                    elif t is Prevote:
                        self.mq.insert_prevote(msg)
                    elif t is Precommit:
                        self.mq.insert_precommit(msg)
                    else:
                        self.mq.insert_propose(msg)
                if dh is not None:
                    dh()
            else:
                self.handle(msg)
                cur = self.proc.current_height
                counts = self._lane_counts
                lane = self._lane

    def _handle_one(self, msg) -> None:
        if self.recorder is not None:
            self.recorder.record(msg)
        try:
            if isinstance(msg, Timeout):
                if msg.message_type == MessageType.PROPOSE:
                    self.proc.on_timeout_propose(msg.height, msg.round)
                elif msg.message_type == MessageType.PREVOTE:
                    self.proc.on_timeout_prevote(msg.height, msg.round)
                elif msg.message_type == MessageType.PRECOMMIT:
                    self.proc.on_timeout_precommit(msg.height, msg.round)
                else:
                    return
            elif isinstance(msg, (Propose, Prevote, Precommit)):
                self._buffer_vote(msg)
            elif isinstance(msg, ResetHeight):
                self.proc.state = State.default_with_height(msg.height)
                self.mq.drop_messages_below_height(msg.height)
                # Lane messages were for the pre-reset current height,
                # which is below the resync target by contract.
                self._lane.clear()
                self._lane_counts.clear()
                if msg.signatories:
                    sigs = list(msg.signatories)
                    self.proc.start_with_new_signatories(
                        len(sigs) // 3, RoundRobin(sigs)
                    )
                    self.procs_allowed = set(sigs)
            else:
                return
            if not self.opts.external_flush:
                self._flush()
        finally:
            if self.did_handle_message is not None:
                self.did_handle_message()

    def _buffer_vote(self, msg) -> None:
        """Height-filter + buffer one vote: below-height drops, the
        current-height fast lane in ``external_flush`` mode, the sorted
        queue otherwise. :meth:`handle_burst` inlines the same rule."""
        h = msg.height
        cur = self.proc.current_height
        if h < cur:
            return
        if h == cur and self.opts.external_flush:
            c = self._lane_counts.get(msg.sender, 0)
            if c < self.opts.max_capacity:
                self._lane_counts[msg.sender] = c + 1
                self._lane.append(msg)
            return
        if isinstance(msg, Propose):
            self.mq.insert_propose(msg)
        elif isinstance(msg, Prevote):
            self.mq.insert_prevote(msg)
        else:
            self.mq.insert_precommit(msg)

    def _flush(self) -> None:
        """Drain the queue into the Process until quiescent
        (reference: replica/replica.go:251-264); with a Verifier installed,
        votes drain in windows and are batch-verified before dispatch; a
        flusher, when installed, owns the whole flush."""
        if self.flusher is not None:
            self.flusher.flush(self)
            return
        if self.verifier is None:
            while True:
                n = self.mq.consume(
                    self.proc.current_height,
                    self.proc.propose,
                    self.proc.prevote,
                    self.proc.precommit,
                    self.procs_allowed,
                )
                if n == 0:
                    return
        else:
            while True:
                window = self.mq.drain_window(
                    self.proc.current_height, self.opts.verify_window
                )
                if not window:
                    return
                self.dispatch_window(window, self.verifier.verify_batch(window))

    # ------------------------------------------------- external (burst) flush

    def drain_pending(self) -> list:
        """Phase 1: pop this replica's eligible window without dispatching:
        the queue backlog merged with the current-height fast lane under
        the queue drain's ordering contract."""
        cur = self.proc.current_height
        backlog = self.mq.drain_all(cur)
        lane = self._lane
        if not lane:
            return backlog
        self._lane = []
        self._lane_counts = {}
        return merge_drain(backlog, lane, self.mq.order_of)

    def dispatch_window(self, window, keep=None) -> None:
        """Phase 2: feed the verified survivors of ``window`` to the Process.

        ``keep`` is the external verifier's accept mask (None = all
        accepted). Whitelisting stays here — it is replica state
        (reference: replica/replica.go:69-72), not a property of the
        signature."""
        if self.opts.batch_ingest:
            self.proc.ingest_cascade(self.ingest_insert_window(window, keep))
            return
        verified = keep is not None
        allowed = self.procs_allowed
        for j, msg in enumerate(window):
            if verified and not keep[j]:
                continue
            if msg.sender not in allowed:
                continue
            if isinstance(msg, Propose):
                self.proc.propose(msg)
            elif isinstance(msg, Prevote):
                self.proc.prevote(msg)
            else:
                self.proc.precommit(msg)

    def ingest_insert_window(self, window, keep=None, on_accepted=None):
        """Phase 2a: filter + insert only, no rules. Same filtering as
        :meth:`dispatch_window`; returns the plan for the cascade."""
        verified = keep is not None
        allowed = self.procs_allowed
        batch = [
            msg
            for j, msg in enumerate(window)
            if (not verified or keep[j]) and msg.sender in allowed
        ]
        return self.proc.ingest_insert(batch, on_accepted)

    def ingest_cascade_window(self, plan, tallies=None) -> None:
        """Phase 2b (device-tally mode): run the rule cascade with the
        device tally counts installed."""
        self.proc.ingest_cascade(plan, tallies)

    def dispatch_window_cols(self, cols, keep=None) -> None:
        raise NotImplementedError(f"the columnar settle path is {_LATER}")

    # -------------------------------------------------------- threaded driving

    def run(self, stop: threading.Event, coalesce: bool = False) -> None:
        """Drain the inbox until ``stop`` fires (the reference's Run loop,
        replica/replica.go:88-151). Call from a dedicated thread.

        ``coalesce=True`` drains every message already waiting in the
        inbox (up to ``verify_window``) before flushing once, instead of
        flushing after each: a device-verified replica then pays one
        launch per burst rather than one per vote. Backpressure still
        fires ``did_handle_message`` per message.
        """
        self.proc.start()
        cap = max(self.opts.verify_window, 1)
        while not stop.is_set():
            try:
                msg = self._inbox.get(timeout=0.05)
            except _queue.Empty:
                continue
            if not coalesce:
                self.handle(msg)
                continue
            batch = [msg]
            while len(batch) < cap:
                try:
                    batch.append(self._inbox.get_nowait())
                except _queue.Empty:
                    break
            self.handle_coalesced(batch)
        # As the reference: the callback also fires on cancellation
        # (replica/replica.go:16-18).
        if self.did_handle_message is not None:
            self.did_handle_message()

    def handle_coalesced(self, msgs) -> None:
        """Buffer a burst of inbox messages, then flush ONCE.

        Votes height-filter and insert into the queue without the
        per-message flush; timeouts and resets take the full
        :meth:`handle` path (they can move the height). The final flush
        restores the quiescence contract for the whole burst. The
        ``external_flush`` mode's batch entry is :meth:`handle_burst`."""
        if self.opts.external_flush:
            raise RuntimeError(
                "handle_coalesced is the self-flushing batch entry; "
                "external_flush callers use handle_burst"
            )
        dh = self.did_handle_message
        for msg in msgs:
            t = type(msg)
            if t is Propose or t is Prevote or t is Precommit:
                if self.recorder is not None:
                    self.recorder.record(msg)
                self._buffer_vote(msg)
                if dh is not None:
                    dh()
            else:
                self.handle(msg)
        self._flush()

    def _enqueue(self, msg, stop: Optional[threading.Event] = None) -> None:
        while True:
            try:
                self._inbox.put(msg, timeout=0.05)
                return
            except _queue.Full:
                if stop is not None and stop.is_set():
                    return

    def propose(self, propose: Propose, stop=None) -> None:
        """Async insert (reference: replica/replica.go:156-161)."""
        self._enqueue(propose, stop)

    def prevote(self, prevote: Prevote, stop=None) -> None:
        self._enqueue(prevote, stop)

    def precommit(self, precommit: Precommit, stop=None) -> None:
        self._enqueue(precommit, stop)

    def timeout(self, timeout: Timeout, stop=None) -> None:
        self._enqueue(timeout, stop)

    def reset_height(
        self, new_height: Height, signatories: list[Signatory] = (), stop=None
    ) -> None:
        """Jump a lagging replica to ``new_height`` (> current), dropping
        stale queued messages (reference: replica/replica.go:222-235)."""
        if new_height <= self.proc.current_height:
            return
        self._enqueue(ResetHeight(new_height, tuple(signatories)), stop)

    # ------------------------------------------------------------- inspection

    def current_state(self) -> tuple[Height, Round, Step]:
        return (
            self.proc.current_height,
            self.proc.current_round,
            self.proc.current_step,
        )

    def current_height(self) -> Height:
        return self.proc.current_height
