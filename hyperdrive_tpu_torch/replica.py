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
  which the simulator's settle layer drives; ``dispatch_window_cols`` and
  ``ingest_insert_window_cols`` take the columnar path over one shared
  :class:`~hyperdrive_tpu_torch.batch.WindowColumns` view);
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
The tracer (``ReplicaOptions.tracer``: ``replica.msg.*``,
``replica.verify.*``, ``replica.ingest.*``, ``replica.commit*``,
``replica.caught.*``) and the flight recorder (``ReplicaOptions.obs``)
are the reference's, with the committer and catcher wrappers that feed
them. Removed: the logger (``utils.log``: ``ReplicaOptions.logger`` and
every log line), the sanitizer hook (``analysis.sanitizer``) and the
``@hot_path`` lint marker. The epoch
stale-key filter (``retired``, ``stale_votes``) and the admission gate
(``admission``, a :class:`~hyperdrive_tpu_torch.load.backpressure.
AdmissionGate` consulted after the height and stale-key filters) are the
reference's. A ``certifier``
(:class:`~hyperdrive_tpu_torch.certificates.Certifier`) goes to the
Process, which mints a certificate at every commit.
"""

from __future__ import annotations

import queue as _queue
import threading
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Optional

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose, Timeout
from hyperdrive_tpu_torch.mq import DEFAULT_MAX_CAPACITY, MessageQueue
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
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
from hyperdrive_tpu_torch.utils.trace import NULL_TRACER

__all__ = ["Replica", "ReplicaOptions", "ResetHeight", "merge_drain"]


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


#: Precomputed metric names: the dispatch path must not pay string
#: formatting per message.
_MSG_METRIC = {
    Propose: "replica.msg.propose",
    Prevote: "replica.msg.prevote",
    Precommit: "replica.msg.precommit",
    Timeout: "replica.msg.timeout",
}

#: The same for evidence counters.
_CAUGHT_METRIC = {
    "double_propose": "replica.caught.double_propose",
    "double_prevote": "replica.caught.double_prevote",
    "double_precommit": "replica.caught.double_precommit",
    "out_of_turn_propose": "replica.caught.out_of_turn_propose",
}


@dataclass(frozen=True)
class ReplicaOptions:
    """Immutable functional options (reference: replica/opt.go:11-46).

    ``tracer`` (a :class:`~hyperdrive_tpu_torch.utils.trace.Tracer`) and
    ``obs`` (a bound flight-recorder handle from
    :mod:`~hyperdrive_tpu_torch.obs.recorder`) default to the shared
    no-op singletons. The seam is called ``obs``, not ``recorder``,
    because Replica already takes a ``recorder`` for the transport
    consumption log."""

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
    tracer: object = None
    obs: object = None

    def with_starting_height(self, height: Height) -> "ReplicaOptions":
        return replace(self, starting_height=height)

    def with_max_capacity(self, capacity: int) -> "ReplicaOptions":
        return replace(self, max_capacity=capacity)

    def with_verify_window(self, window: int) -> "ReplicaOptions":
        return replace(self, verify_window=window)

    def with_tracer(self, tracer) -> "ReplicaOptions":
        return replace(self, tracer=tracer)

    def with_obs(self, obs) -> "ReplicaOptions":
        return replace(self, obs=obs)


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
        self.tracer = opts.tracer if opts.tracer is not None else NULL_TRACER
        self.obs = opts.obs if opts.obs is not None else NULL_BOUND
        self.proc = Process(
            whoami=whoami,
            f=f,
            timer=timer,
            scheduler=RoundRobin(signatories),
            proposer=proposer,
            validator=validator,
            broadcaster=broadcaster,
            committer=self._instrument_committer(committer),
            certifier=certifier,
            catcher=self._instrument_catcher(catcher),
            height=opts.starting_height,
            obs=self.obs,
        )
        self.procs_allowed: set[Signatory] = set(signatories)
        self.mq = MessageQueue(max_capacity=opts.max_capacity)
        self.mq.obs = self.obs
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
        self._last_commit_time: Optional[float] = None
        # Burst fast lane (external_flush only): votes for the CURRENT
        # height skip the sorted queue entirely; drain_pending merges lane
        # and queue under the same (height, round, sender, arrival)
        # ordering the queue drain guarantees. Per-sender capacity mirrors
        # the queue's bound so a current-height flood cannot bypass DoS
        # limits.
        self._lane: list = []
        self._lane_counts: dict = {}
        #: Retired identities (epoch key rotation): signatory -> first
        #: height at which votes under it are stale. A height, not a
        #: blanket ban: the retiring boundary's own height legitimately
        #: carries old-key votes, and a laggard still finishing it must
        #: keep accepting them. The simulator shares one dict across its
        #: replicas. Empty = one truthiness check a vote.
        self.retired: dict = {}
        #: Stale-generation votes rejected.
        self.stale_votes = 0
        #: Optional AdmissionGate (:mod:`~hyperdrive_tpu_torch.load.
        #: backpressure`): consulted after the height and stale-key filters
        #: in :meth:`_buffer_vote` and the inlined :meth:`handle_burst`
        #: rule. Under pressure, classified traffic (duplicates, over-share
        #: prevotes) sheds here before it can buffer. None = admit all.
        self.admission = None

    # --------------------------------------------------------- observability

    def _instrument_committer(self, committer):
        """Wrap the app's committer with metrics: commit counter,
        per-height latency histogram, rounds-to-commit histogram."""
        if committer is None:
            return None
        replica = self

        class _TracingCommitter:
            def commit(self, height, value):
                t = replica.tracer
                now = t.now()
                t.count("replica.commits")
                t.observe("replica.commit.rounds", replica.proc.current_round + 1)
                if replica._last_commit_time is not None:
                    t.observe("replica.height.latency", now - replica._last_commit_time)
                replica._last_commit_time = now
                return committer.commit(height, value)

        return _TracingCommitter()

    def _instrument_catcher(self, catcher):
        """Wrap the app's catcher: count and journal every piece of
        evidence."""
        if catcher is None:
            return None
        replica = self

        class _TracingCatcher:
            def _note(self, kind):
                replica.tracer.count(_CAUGHT_METRIC[kind])
                if replica.obs is not NULL_BOUND:
                    replica.obs.emit(
                        "equivocation",
                        replica.proc.current_height,
                        replica.proc.current_round,
                        kind,
                    )

            def catch_double_propose(self, new, existing):
                self._note("double_propose")
                catcher.catch_double_propose(new, existing)

            def catch_double_prevote(self, new, existing):
                self._note("double_prevote")
                catcher.catch_double_prevote(new, existing)

            def catch_double_precommit(self, new, existing):
                self._note("double_precommit")
                catcher.catch_double_precommit(new, existing)

            def catch_out_of_turn_propose(self, propose):
                self._note("out_of_turn_propose")
                catcher.catch_out_of_turn_propose(propose)

        return _TracingCatcher()

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
        self._last_commit_time = None
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
        retired = self.retired
        adm = self.admission
        n_pv = n_pc = n_pp = 0
        for msg in msgs:
            t = type(msg)
            if t is Prevote or t is Precommit or t is Propose:
                if t is Prevote:
                    n_pv += 1
                elif t is Precommit:
                    n_pc += 1
                else:
                    n_pp += 1
                h = msg.height
                if retired:
                    bad_from = retired.get(msg.sender)
                    if bad_from is not None and h >= bad_from:
                        self._note_stale(msg)
                        if dh is not None:
                            dh()
                        continue
                if h >= cur:
                    if adm is not None and not adm.admit(msg):
                        if dh is not None:
                            dh()
                        continue
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
        if self.tracer is not NULL_TRACER:
            if n_pv:
                self.tracer.count("replica.msg.prevote", n_pv)
            if n_pc:
                self.tracer.count("replica.msg.precommit", n_pc)
            if n_pp:
                self.tracer.count("replica.msg.propose", n_pp)

    def _handle_one(self, msg) -> None:
        if self.recorder is not None:
            self.recorder.record(msg)
        if self.tracer is not NULL_TRACER:
            self.tracer.count(
                _MSG_METRIC.get(type(msg), "replica.msg.other")
            )
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
                if self.obs is not NULL_BOUND:
                    self.obs.emit(
                        "height.resync",
                        self.proc.current_height,
                        self.proc.current_round,
                        msg.height,
                    )
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
        """Height-filter + buffer one vote: below-height and stale-key
        drops, the admission gate's sheds, the current-height fast lane in ``external_flush`` mode, the
        sorted queue otherwise. :meth:`handle_burst` inlines the same
        rule."""
        h = msg.height
        cur = self.proc.current_height
        if h < cur:
            return
        if self.retired:
            bad_from = self.retired.get(msg.sender)
            if bad_from is not None and h >= bad_from:
                self._note_stale(msg)
                return
        if self.admission is not None and not self.admission.admit(msg):
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

    def _note_stale(self, msg) -> None:
        """A vote signed under a retired key generation at a height where
        the rotation already binds: dropped before it can buffer, counted
        (``replica.msg.stale_vote``) and journaled (``epoch.stale_vote``)."""
        self.stale_votes += 1
        if self.tracer is not NULL_TRACER:
            self.tracer.count("replica.msg.stale_vote")
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "epoch.stale_vote",
                msg.height,
                getattr(msg, "round", -1),
                self.stale_votes,
            )

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
                self.tracer.observe("replica.verify.window", len(window))
                with self.tracer.span("replica.verify.latency"):
                    keep = self.verifier.verify_batch(window)
                self.dispatch_window(window, keep)

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
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "ingest.window",
                self.proc.current_height,
                self.proc.current_round,
                len(window),
            )
        verified = keep is not None
        allowed = self.procs_allowed
        n_ok = 0
        for j, msg in enumerate(window):
            if verified and not keep[j]:
                continue
            if msg.sender not in allowed:
                continue
            n_ok += 1
            if isinstance(msg, Propose):
                self.proc.propose(msg)
            elif isinstance(msg, Prevote):
                self.proc.prevote(msg)
            else:
                self.proc.precommit(msg)
        if verified and self.tracer is not NULL_TRACER:
            self.tracer.count("replica.verify.accepted", n_ok)
            self.tracer.count("replica.verify.rejected", len(window) - n_ok)

    def ingest_insert_window(self, window, keep=None, on_accepted=None):
        """Phase 2a: filter + insert only, no rules. Same filtering as
        :meth:`dispatch_window`; returns the plan for the cascade."""
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "ingest.window",
                self.proc.current_height,
                self.proc.current_round,
                len(window),
            )
        verified = keep is not None
        allowed = self.procs_allowed
        batch = [
            msg
            for j, msg in enumerate(window)
            if (not verified or keep[j]) and msg.sender in allowed
        ]
        if verified and self.tracer is not NULL_TRACER:
            self.tracer.count("replica.verify.accepted", len(batch))
            self.tracer.count("replica.verify.rejected",
                              len(window) - len(batch))
        return self.proc.ingest_insert(batch, on_accepted)

    def ingest_cascade_window(self, plan, tallies=None) -> None:
        """Phase 2b (device-tally mode): run the rule cascade with the
        device tally counts installed."""
        self.proc.ingest_cascade(plan, tallies)

    def ingest_insert_window_cols(self, cols, keep=None, on_accepted=None):
        """Columnar phase 2a: insert a :class:`~hyperdrive_tpu_torch.batch.
        WindowColumns` view with the keep-mask and whitelist filters fused
        into the loop: no per-replica window copy, no per-replica
        attribute extraction (it was paid once when ``cols`` was built).
        Filtering, insertion and accounting match
        :meth:`ingest_insert_window` row for row;
        ``replica.ingest.fastpath_rows`` counts the rows that rode the
        columnar path."""
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "ingest.window",
                self.proc.current_height,
                self.proc.current_round,
                cols.n,
            )
        plan, n_ok = self.proc.ingest_insert_cols(
            cols, keep, self.procs_allowed, on_accepted
        )
        if self.tracer is not NULL_TRACER:
            self.tracer.count("replica.ingest.fastpath_rows", cols.n)
            if keep is not None:
                self.tracer.count("replica.verify.accepted", n_ok)
                self.tracer.count("replica.verify.rejected", cols.n - n_ok)
        return plan

    def dispatch_window_cols(self, cols, keep=None) -> None:
        """Columnar phase 2: insert + cascade over a WindowColumns view
        (the batched-ingest analogue of :meth:`dispatch_window`; callers
        use it only when ``opts.batch_ingest`` is set: the per-message
        path has no columnar equivalent)."""
        self.proc.ingest_cascade(self.ingest_insert_window_cols(cols, keep))

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
                if self.tracer is not NULL_TRACER:
                    self.tracer.count(_MSG_METRIC[t])
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
