"""The Tendermint-BFT consensus automaton (host-side).

Capability parity with the reference's core state machine
(``process/process.go``): a deterministic finite automaton that consumes
Propose/Prevote/Precommit messages and fires the paper's rules L11-L65
("The latest gossip on BFT consensus", arXiv:1807.04938), with the same
seven dependency-injection seams (Timer, Scheduler, Proposer, Validator,
Broadcaster, Committer, Catcher), the same once-flag discipline, the same
deferred retry cascade, and the same equivocation catching.

Design stance (SURVEY.md §7.1): this control flow is branchy, per-message,
and operates on tiny state — it runs on the host. The TPU handles the
batchable work in front of it: signature verification and quorum tallies
over vote tensors (:mod:`hyperdrive_tpu_torch.ops`). A Process assumes messages
reaching it are already authenticated (reference: process/process.go:95-98);
authentication is performed by the Verifier in the replica's drain loop.

A Process is **not** safe for concurrent use: all methods must be called
from a single thread (reference: process/process.go:100-101).

Rule map (paper label -> method):

- L10/L11  start / start_round
- L22      _try_prevote_upon_propose
- L28      _try_prevote_upon_sufficient_prevotes
- L34      _try_timeout_prevote_upon_sufficient_prevotes
- L36      _try_precommit_upon_sufficient_prevotes
- L44      _try_precommit_nil_upon_sufficient_prevotes
- L47      _try_timeout_precommit_upon_sufficient_precommits
- L49      _try_commit_upon_sufficient_precommits
- L55      _try_skip_to_future_round
- L57/61/65  on_timeout_propose / on_timeout_prevote / on_timeout_precommit

Port copy of ``hyperdrive_tpu/process.py`` for the PyTorch package: the
``@wire_codec`` lint decorator is removed. Everything else, the
flight-recorder hook (``obs`` and every ``obs.emit`` site) included, is
unchanged.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from hyperdrive_tpu_torch.codec import Reader, Writer
from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.state import OnceFlag, State
from hyperdrive_tpu_torch.types import (
    INVALID_ROUND,
    NIL_VALUE,
    Height,
    Round,
    Signatory,
    Step,
    Value,
)

__all__ = [
    "Timer",
    "Scheduler",
    "Proposer",
    "Validator",
    "Broadcaster",
    "Committer",
    "Catcher",
    "Process",
]


# --------------------------------------------------------------------- seams
# The seven DI interfaces (reference: process/process.go:17-88). All are
# structural protocols; any object with the right methods satisfies them.


@runtime_checkable
class Timer(Protocol):
    """Schedules timeout events proportional to the round."""

    def timeout_propose(self, height: Height, round: Round) -> None: ...
    def timeout_prevote(self, height: Height, round: Round) -> None: ...
    def timeout_precommit(self, height: Height, round: Round) -> None: ...


@runtime_checkable
class Scheduler(Protocol):
    """Elects the proposer for a (height, round); must be deterministic and
    derived only from values on which consensus has already been reached."""

    def schedule(self, height: Height, round: Round) -> Signatory: ...


@runtime_checkable
class Proposer(Protocol):
    """Produces new values to propose; must never return two different
    values for the same (height, round)."""

    def propose(self, height: Height, round: Round) -> Value: ...


@runtime_checkable
class Validator(Protocol):
    """Application-defined validity predicate; correct processes are not
    required to agree on validity."""

    def valid(self, height: Height, round: Round, value: Value) -> bool: ...


@runtime_checkable
class Broadcaster(Protocol):
    """Fans a message out to all processes, including the sender. Eventual
    delivery is assumed; ordering is not."""

    def broadcast_propose(self, propose: Propose) -> None: ...
    def broadcast_prevote(self, prevote: Prevote) -> None: ...
    def broadcast_precommit(self, precommit: Precommit) -> None: ...


@runtime_checkable
class Committer(Protocol):
    """Receives committed values; may rotate the validator set by returning
    a non-zero f and/or a new Scheduler (epoch change)."""

    def commit(
        self, height: Height, value: Value
    ) -> tuple[int, Optional[Scheduler]]: ...


@runtime_checkable
class Catcher(Protocol):
    """Receives evidence of Byzantine behaviour (equivocation, out-of-turn
    proposing). Catching is best-effort: messages dropped by height filters
    are never inspected."""

    def catch_double_propose(self, new: Propose, existing: Propose) -> None: ...
    def catch_double_prevote(self, new: Prevote, existing: Prevote) -> None: ...
    def catch_double_precommit(self, new: Precommit, existing: Precommit) -> None: ...
    def catch_out_of_turn_propose(self, propose: Propose) -> None: ...


# -------------------------------------------------------------------- process


class Process:
    """The consensus automaton for one replica identity.

    All injected collaborators except ``committer`` are optional (nil-safe),
    matching the reference's null-check discipline
    (process/process.go:324-348); the committer is demanded at commit time
    exactly as the reference demands it (process/process.go:703).
    """

    __slots__ = (
        "whoami",
        "f",
        "timer",
        "scheduler",
        "proposer",
        "validator",
        "broadcaster",
        "committer",
        "certifier",
        "catcher",
        "state",
        "_tally_source",
        "host_counts",
        "obs",
    )

    def __init__(
        self,
        whoami: Signatory,
        f: int,
        timer: Optional[Timer] = None,
        scheduler: Optional[Scheduler] = None,
        proposer: Optional[Proposer] = None,
        validator: Optional[Validator] = None,
        broadcaster: Optional[Broadcaster] = None,
        committer: Optional[Committer] = None,
        certifier=None,
        catcher: Optional[Catcher] = None,
        height: Height | None = None,
        state: State | None = None,
        obs=None,
    ):
        self.whoami = whoami
        self.f = int(f)
        self.timer = timer
        self.scheduler = scheduler
        self.proposer = proposer
        self.validator = validator
        self.broadcaster = broadcaster
        self.committer = committer
        #: Optional certificates.Certifier: when set, every L49 commit
        #: also mints a constant-size QuorumCertificate from the 2f+1
        #: precommit signers (the O(1) commit proof downstream consumers
        #: carry instead of the vote set).
        self.certifier = certifier
        self.catcher = catcher
        if state is not None:
            self.state = state
        elif height is not None:
            self.state = State.default_with_height(height)
        else:
            self.state = State()
        #: Device tally counts installed for the duration of one
        #: ingest_cascade call (see the _prevotes_for family); None means
        #: every threshold check reads the host counters.
        self._tally_source = None
        #: When False (device-tally deployments), batched ingestion skips
        #: maintaining the derived per-value tally dicts — the vote grid
        #: answers the hot quorum queries, and declined queries fall back
        #: to State.count_*'s O(V) log scan. The logs themselves (the
        #: checkpoint/evidence source of truth) are always maintained.
        self.host_counts = True
        #: Flight-recorder handle (obs/recorder.py); the shared no-op
        #: singleton when observability is off, so every emit site can
        #: gate on one identity check. Named ``obs`` because ``recorder``
        #: already means the transport-replay FlightRecorder elsewhere.
        self.obs = obs if obs is not None else NULL_BOUND

    # ---------------------------------------------------------------- inputs

    def propose(self, propose: Propose) -> None:
        """Receive a Propose (including our own broadcasts); try every rule
        its receipt could open (reference: process/process.go:229-239)."""
        if not self._insert_propose(propose):
            return
        self._try_skip_to_future_round(propose.round)
        self._try_commit_upon_sufficient_precommits(propose.round)
        self._try_precommit_upon_sufficient_prevotes()
        self._try_prevote_upon_propose()
        self._try_prevote_upon_sufficient_prevotes()

    def prevote(self, prevote: Prevote) -> None:
        """Receive a Prevote (reference: process/process.go:245-255)."""
        if not self._insert_prevote(prevote):
            return
        self._try_skip_to_future_round(prevote.round)
        self._try_precommit_upon_sufficient_prevotes()
        self._try_precommit_nil_upon_sufficient_prevotes()
        self._try_prevote_upon_sufficient_prevotes()
        self._try_timeout_prevote_upon_sufficient_prevotes()

    def precommit(self, precommit: Precommit) -> None:
        """Receive a Precommit (reference: process/process.go:261-269)."""
        if not self._insert_precommit(precommit):
            return
        self._try_skip_to_future_round(precommit.round)
        self._try_commit_upon_sufficient_precommits(precommit.round)
        self._try_timeout_precommit_upon_sufficient_precommits()

    def ingest(self, msgs) -> None:
        """Receive a whole verified window: insert every message, then run
        the rule cascade ONCE (per touched round for the round-
        parameterized rules) instead of once per message.

        This is the batched driving mode (SURVEY.md §7.1(4)): the try*
        rules are monotone threshold checks over the logs with once-flag
        idempotence, so evaluating them after the window sees exactly the
        final log state every per-message schedule would eventually reach —
        the outcome corresponds to a legal delivery order of the same
        messages (order-insensitivity is property-tested). Observable
        differences vs strict per-message delivery are confined to (a)
        equivocation evidence for messages a mid-window commit would have
        dropped — strictly more evidence — and (b) timeout schedulings
        whose guards (step checks at fire time) make them no-ops anyway.

        All messages must be for the current height (the mq drain
        guarantees this); inserts therefore happen before any rule can
        advance the height, and a commit fired from the cascade wipes the
        very logs later-round rule evaluations would have read — those
        evaluations then no-op on empty logs, exactly as if the messages
        had arrived after the commit and been height-filtered.
        """
        self.ingest_cascade(self.ingest_insert(msgs))

    def ingest_insert(self, msgs, on_accepted=None):
        """Insert phase of the batched driving mode: log every message,
        fire no rules. Returns the opaque plan for :meth:`ingest_cascade`.

        ``on_accepted(msg, is_precommit)`` is invoked for each *accepted*
        prevote/precommit — the hook the device vote grid uses to scatter
        exactly the votes the host logs accepted (duplicates, equivocation,
        and wrong-height messages never reach it), keeping grid and logs
        byte-equivalent.
        """
        commit_rounds = set()
        vote_rounds = set()
        # The vote inserts are inlined from State.add_prevote/add_precommit
        # (same semantics, property-tested equivalent): at 256 validators a
        # settle window is ~512 votes x 256 replicas, and the per-message
        # call chain (_insert_* -> State.add_*) costs more than the dict
        # operations themselves. Windows arrive (height, round)-sorted, so
        # the per-round dict views are cached across consecutive messages.
        st = self.state
        cur_h = st.current_height
        catcher = self.catcher
        traces = st.trace_logs
        hc = self.host_counts
        last_rnd = None
        last_is_pc = None
        votes = counts = trace = None
        for msg in msgs:
            t = type(msg)
            if t is Prevote:
                if msg.height != cur_h:
                    continue
                rnd = msg.round
                if rnd != last_rnd or last_is_pc is not False:
                    last_rnd, last_is_pc = rnd, False
                    votes = st.prevote_logs.get(rnd)
                    if votes is None:
                        votes = st.prevote_logs[rnd] = {}
                    if hc:
                        counts = st.prevote_counts.get(rnd)
                        if counts is None:
                            counts = st.prevote_counts[rnd] = {}
                    else:
                        # A stale tally (e.g. rebuilt by a checkpoint
                        # restore) must not shadow the scan fallback.
                        st.prevote_counts.pop(rnd, None)
                    trace = traces.get(rnd)
                    if trace is None:
                        trace = traces[rnd] = set()
                sender = msg.sender
                existing = votes.get(sender)
                if existing is not None:
                    if msg != existing and catcher is not None:
                        catcher.catch_double_prevote(msg, existing)
                    continue
                votes[sender] = msg
                if hc:
                    v = msg.value
                    counts[v] = counts.get(v, 0) + 1
                trace.add(sender)
                vote_rounds.add(rnd)
                if on_accepted is not None:
                    on_accepted(msg, False)
            elif t is Precommit:
                if msg.height != cur_h:
                    continue
                rnd = msg.round
                if rnd != last_rnd or last_is_pc is not True:
                    last_rnd, last_is_pc = rnd, True
                    votes = st.precommit_logs.get(rnd)
                    if votes is None:
                        votes = st.precommit_logs[rnd] = {}
                    if hc:
                        counts = st.precommit_counts.get(rnd)
                        if counts is None:
                            counts = st.precommit_counts[rnd] = {}
                    else:
                        st.precommit_counts.pop(rnd, None)
                    trace = traces.get(rnd)
                    if trace is None:
                        trace = traces[rnd] = set()
                sender = msg.sender
                existing = votes.get(sender)
                if existing is not None:
                    if msg != existing and catcher is not None:
                        catcher.catch_double_precommit(msg, existing)
                    continue
                votes[sender] = msg
                if hc:
                    v = msg.value
                    counts[v] = counts.get(v, 0) + 1
                trace.add(sender)
                vote_rounds.add(rnd)
                commit_rounds.add(rnd)
                if on_accepted is not None:
                    on_accepted(msg, True)
            else:
                if self._insert_propose(msg):
                    vote_rounds.add(msg.round)
                    commit_rounds.add(msg.round)
                # The propose insert may have touched the cached round's
                # trace set; invalidate so the next vote re-fetches.
                last_rnd = None
        return (commit_rounds, vote_rounds)

    def ingest_insert_cols(self, cols, keep=None, allowed=None,
                           on_accepted=None):
        """Columnar insert phase: the settle fast path over a
        :class:`~hyperdrive_tpu_torch.batch.WindowColumns` view.

        Semantically identical to :meth:`ingest_insert` over the filtered
        window ``[cols.msg(i) for i surviving keep/allowed]`` (property-
        tested: equal logs, once-flags, locks, and catcher calls) — but the
        per-message attribute extraction and type dispatch were paid once
        when ``cols`` was built, the keep-mask and whitelist filters fuse
        into the loop (no intermediate window copy per replica), and the
        round-log views are fetched once per (kind, height, round) run.
        Message objects are touched only for rows the automaton keeps
        (log insertion) or reports (equivocation evidence); on a wire-built
        view (``WindowColumns.from_block``) every other row skips object
        materialization entirely.

        Returns ``(plan, ingested)`` where ``plan`` feeds
        :meth:`ingest_cascade` and ``ingested`` counts the rows that
        survived the keep/allowed filters (the replica's accept
        accounting).
        """
        commit_rounds = set()
        vote_rounds = set()
        vr_add = vote_rounds.add
        cr_add = commit_rounds.add
        st = self.state
        cur_h = st.current_height
        catcher = self.catcher
        traces = st.trace_logs
        hc = self.host_counts
        senders = cols.senders
        values = cols.values
        msg_at = cols.msg
        # Accepted/equivocating rows read the message LIST directly — on
        # the from_messages path every slot is populated, so the common
        # case is a plain index instead of a bound-method call; only
        # wire-built views (None slots) fall back to lazy materialization.
        mlist = cols.msgs
        KP = cols.KIND_PROPOSE
        ingested = 0
        for kind, h, rnd, start, end in cols.runs:
            if kind == KP:
                for i in range(start, end):
                    if keep is not None and not keep[i]:
                        continue
                    if allowed is not None and senders[i] not in allowed:
                        continue
                    ingested += 1
                    m = msg_at(i)
                    if self._insert_propose(m):
                        vote_rounds.add(rnd)
                        commit_rounds.add(rnd)
                continue
            is_pc = kind == cols.KIND_PRECOMMIT
            if h != cur_h:
                # Wrong-height rows still count as delivered (they passed
                # the keep/allowed filters — the object path counts them
                # in its filtered window before the height check drops
                # them), but never touch state or materialize objects.
                if keep is None and allowed is None:
                    ingested += end - start
                else:
                    for i in range(start, end):
                        if (keep is None or keep[i]) and (
                            allowed is None or senders[i] in allowed
                        ):
                            ingested += 1
                continue
            # Round-log views fetch lazily on the first surviving row:
            # a fully filtered-out run must not create empty log dicts
            # the object path would never have created (checkpoint bytes
            # and state-parity both see the difference).
            votes = vget = cget = tadd = counts = trace = None
            n0 = 0
            for i in range(start, end):
                if keep is not None and not keep[i]:
                    continue
                sender = senders[i]
                if allowed is not None and sender not in allowed:
                    continue
                ingested += 1
                if votes is None:
                    if is_pc:
                        votes = st.precommit_logs.get(rnd)
                        if votes is None:
                            votes = st.precommit_logs[rnd] = {}
                        if hc:
                            counts = st.precommit_counts.get(rnd)
                            if counts is None:
                                counts = st.precommit_counts[rnd] = {}
                        else:
                            st.precommit_counts.pop(rnd, None)
                    else:
                        votes = st.prevote_logs.get(rnd)
                        if votes is None:
                            votes = st.prevote_logs[rnd] = {}
                        if hc:
                            counts = st.prevote_counts.get(rnd)
                            if counts is None:
                                counts = st.prevote_counts[rnd] = {}
                        else:
                            st.prevote_counts.pop(rnd, None)
                    trace = traces.get(rnd)
                    if trace is None:
                        trace = traces[rnd] = set()
                    # Bind the per-run view methods once: the row loop
                    # below is the engine's hottest host code, and a
                    # LOAD_METHOD per row costs as much as the dict op.
                    vget = votes.get
                    tadd = trace.add
                    if hc:
                        cget = counts.get
                    n0 = len(votes)
                existing = vget(sender)
                if existing is not None:
                    m = mlist[i]
                    if m is None:
                        m = msg_at(i)
                    if m != existing and catcher is not None:
                        if is_pc:
                            catcher.catch_double_precommit(m, existing)
                        else:
                            catcher.catch_double_prevote(m, existing)
                    continue
                m = mlist[i]
                if m is None:
                    m = msg_at(i)
                votes[sender] = m
                if hc:
                    v = values[i]
                    counts[v] = cget(v, 0) + 1
                tadd(sender)
                if on_accepted is not None:
                    on_accepted(m, is_pc)
            # The round sets are run-constant: one membership add when any
            # row of the run was accepted (every accepted row grows the
            # votes dict, so the length delta is the acceptance signal)
            # instead of a set.add per row.
            if votes is not None and len(votes) != n0:
                vr_add(rnd)
                if is_pc:
                    cr_add(rnd)
        return (commit_rounds, vote_rounds), ingested

    def ingest_cascade(self, plan, tallies=None) -> None:
        """Rule phase of the batched driving mode. With ``tallies`` (a
        TallyView over the device vote grids), the quorum threshold checks
        read the device counts; the host counters remain the fallback for
        anything the grid doesn't cover (rounds beyond its slot window,
        post-commit heights, value mismatches)."""
        commit_rounds, vote_rounds = plan
        if not vote_rounds and not commit_rounds:
            return
        self._tally_source = tallies
        try:
            # Commits first (progress beats round-skipping when both are
            # enabled — each is a legal next transition); then the
            # future-round skip; then the current-round cascade. The skip
            # walks rounds highest-first and stops at the first that fires:
            # the final round is the maximal qualifying one either way, and
            # stopping there avoids scheduling timeouts for intermediate
            # rounds the automaton would immediately leave.
            for r in sorted(commit_rounds):
                self._try_commit_upon_sufficient_precommits(r)
            for r in sorted(vote_rounds, reverse=True):
                before = self.state.current_round
                self._try_skip_to_future_round(r)
                if self.state.current_round != before:
                    break
            self._try_precommit_upon_sufficient_prevotes()
            self._try_precommit_nil_upon_sufficient_prevotes()
            self._try_prevote_upon_propose()
            self._try_prevote_upon_sufficient_prevotes()
            self._try_timeout_precommit_upon_sufficient_precommits()
            self._try_timeout_prevote_upon_sufficient_prevotes()
        finally:
            self._tally_source = None

    # ------------------------------------------------------- tally sources

    def _prevotes_for(self, round: Round, value: Value) -> int:
        """Prevotes at ``round`` for ``value`` — from the device tally
        source when one is installed and covers the query, else the O(1)
        host counter. The source declines (returns None) whenever its
        snapshot might not match the logs: different height (a commit
        advanced us mid-cascade), uncovered round slot, or a target value
        other than the one it tallied against."""
        src = self._tally_source
        if src is not None and src.height == self.state.current_height:
            c = src.prevotes_for(round, value)
            if c is not None:
                return c
        return self.state.count_prevotes_for(round, value)

    def _precommits_for(self, round: Round, value: Value) -> int:
        src = self._tally_source
        if src is not None and src.height == self.state.current_height:
            c = src.precommits_for(round, value)
            if c is not None:
                return c
        return self.state.count_precommits_for(round, value)

    def _prevote_total(self, round: Round) -> int:
        src = self._tally_source
        if src is not None and src.height == self.state.current_height:
            c = src.prevote_total(round)
            if c is not None:
                return c
        return len(self.state.prevote_logs.get(round, {}))

    def _precommit_total(self, round: Round) -> int:
        src = self._tally_source
        if src is not None and src.height == self.state.current_height:
            c = src.precommit_total(round)
            if c is not None:
                return c
        return len(self.state.precommit_logs.get(round, {}))

    # --------------------------------------------------------------- control

    def start(self) -> None:
        """L10: upon start do StartRound(0)."""
        self.start_round(0)

    def start_with_new_signatories(self, f: int, scheduler: Scheduler) -> None:
        """Restart at round 0 under a rotated validator set
        (reference: process/process.go:281-285)."""
        self.f = int(f)
        self.scheduler = scheduler
        self.start_round(0)

    def resume(self) -> None:
        """Re-arm the current step's timeout after a crash-restore.

        A restored Process re-enters consensus mid-round with whatever
        its checkpoint held — locked/valid values, vote logs, once-flags
        — but the timer it had armed died with the old process, and
        without a deadline the replica could wait forever on a quorum
        that already moved on. Re-arming is safe where re-running
        ``start_round`` would not be: no message is broadcast (a re-sent
        propose or vote after restore is exactly the double-send the
        catcher flags as equivocation), and a duplicate timeout is
        harmless — every on_timeout_* height/round/step-guards itself.
        """
        if self.timer is None:
            return
        h = self.state.current_height
        r = self.state.current_round
        step = self.state.current_step
        obs = self.obs
        if step == Step.PROPOSING:
            self.timer.timeout_propose(h, r)
            if obs is not NULL_BOUND:
                obs.emit("timeout.propose.scheduled", h, r)
        elif step == Step.PREVOTING:
            self.timer.timeout_prevote(h, r)
            if obs is not NULL_BOUND:
                obs.emit("timeout.prevote.scheduled", h, r)
        else:
            self.timer.timeout_precommit(h, r)
            if obs is not NULL_BOUND:
                obs.emit("timeout.precommit.scheduled", h, r)

    def start_round(self, round: Round) -> None:
        """L11: begin a new round at the current height.

        After the round/step reset — whatever path is taken — every condition
        that depends on the current round or step is retried (the reference
        does this with a deferred closure, process/process.go:305-312).
        """
        try:
            self.state.current_round = round
            self.state.current_step = Step.PROPOSING
            obs = self.obs
            if obs is not NULL_BOUND:
                obs.emit("round.start", self.state.current_height, round)

            # Without a scheduler we can never know the proposer; do nothing
            # (matching reference behaviour when the seam is nil).
            if self.scheduler is None:
                return
            proposer = self.scheduler.schedule(
                self.state.current_height, self.state.current_round
            )
            if proposer != self.whoami:
                if self.timer is not None:
                    self.timer.timeout_propose(
                        self.state.current_height, self.state.current_round
                    )
                    if obs is not NULL_BOUND:
                        obs.emit(
                            "timeout.propose.scheduled",
                            self.state.current_height,
                            round,
                        )
                return

            # We are the proposer: re-propose our ValidValue if we have one,
            # otherwise ask the application for a fresh value.
            propose_value = self.state.valid_value
            if propose_value == NIL_VALUE and self.proposer is not None:
                propose_value = self.proposer.propose(
                    self.state.current_height, self.state.current_round
                )
            # MPC extension: a proposer that derives payloads from values
            # (duck-typed `payload_for_value`) attaches the share bundle.
            # Keying on the VALUE — not (height, round) — means a
            # re-proposed ValidValue from an earlier round carries its
            # original payload.
            payload = b""
            if propose_value != NIL_VALUE and self.proposer is not None:
                payload_fn = getattr(self.proposer, "payload_for_value", None)
                if payload_fn is not None:
                    payload = payload_fn(propose_value)
            if self.broadcaster is not None:
                self.broadcaster.broadcast_propose(
                    Propose(
                        height=self.state.current_height,
                        round=self.state.current_round,
                        valid_round=self.state.valid_round,
                        value=propose_value,
                        sender=self.whoami,
                        payload=payload,
                    )
                )
        finally:
            self._try_precommit_upon_sufficient_prevotes()
            self._try_precommit_nil_upon_sufficient_prevotes()
            self._try_prevote_upon_propose()
            self._try_prevote_upon_sufficient_prevotes()
            self._try_timeout_precommit_upon_sufficient_precommits()
            self._try_timeout_prevote_upon_sufficient_prevotes()

    # -------------------------------------------------------------- timeouts

    def on_timeout_propose(self, height: Height, round: Round) -> None:
        """L57: a propose timeout fired — prevote nil if still proposing
        (reference: process/process.go:361-373)."""
        if (
            height == self.state.current_height
            and round == self.state.current_round
            and self.state.current_step == Step.PROPOSING
        ):
            if self.obs is not NULL_BOUND:
                self.obs.emit("timeout.propose.fired", height, round)
            if self.broadcaster is not None:
                self.broadcaster.broadcast_prevote(
                    Prevote(
                        height=self.state.current_height,
                        round=self.state.current_round,
                        value=NIL_VALUE,
                        sender=self.whoami,
                    )
                )
            self._step_to_prevoting()

    def on_timeout_prevote(self, height: Height, round: Round) -> None:
        """L61: a prevote timeout fired — precommit nil if still prevoting
        (reference: process/process.go:384-396)."""
        if (
            height == self.state.current_height
            and round == self.state.current_round
            and self.state.current_step == Step.PREVOTING
        ):
            if self.obs is not NULL_BOUND:
                self.obs.emit("timeout.prevote.fired", height, round)
            if self.broadcaster is not None:
                self.broadcaster.broadcast_precommit(
                    Precommit(
                        height=self.state.current_height,
                        round=self.state.current_round,
                        value=NIL_VALUE,
                        sender=self.whoami,
                    )
                )
            self._step_to_precommitting()

    def on_timeout_precommit(self, height: Height, round: Round) -> None:
        """L65: a precommit timeout fired — move to the next round
        (reference: process/process.go:406-410)."""
        if height == self.state.current_height and round == self.state.current_round:
            if self.obs is not NULL_BOUND:
                self.obs.emit("timeout.precommit.fired", height, round)
            self.start_round(round + 1)

    # ------------------------------------------------------------- rules L22+

    def _try_prevote_upon_propose(self) -> None:
        """L22: fresh proposal (valid_round == -1) at the current round while
        proposing -> prevote it (or nil) (reference: process/process.go:424-457)."""
        if self.state.current_step != Step.PROPOSING:
            return
        propose = self.state.propose_logs.get(self.state.current_round)
        if propose is None or propose.valid_round != INVALID_ROUND:
            return
        propose_is_valid = self.state.propose_is_valid.get(
            self.state.current_round, False
        )

        if self.broadcaster is not None:
            lockable = (
                self.state.locked_round == INVALID_ROUND
                or self.state.locked_value == propose.value
            )
            self.broadcaster.broadcast_prevote(
                Prevote(
                    height=self.state.current_height,
                    round=self.state.current_round,
                    value=propose.value if (lockable and propose_is_valid) else NIL_VALUE,
                    sender=self.whoami,
                )
            )
        self._step_to_prevoting()

    def _try_prevote_upon_sufficient_prevotes(self) -> None:
        """L28: re-proposal carrying valid_round vr plus 2f+1 prevotes for
        its value at vr -> prevote it (or nil)
        (reference: process/process.go:472-515)."""
        if self.state.current_step != Step.PROPOSING:
            return
        propose = self.state.propose_logs.get(self.state.current_round)
        if propose is None:
            return
        vr = propose.valid_round
        if vr <= INVALID_ROUND or vr >= self.state.current_round:
            return
        propose_is_valid = self.state.propose_is_valid.get(
            self.state.current_round, False
        )

        # Device-or-host tally (the reference scans the round's votes here,
        # process/process.go:486-491). Cross-round query: the vote grid
        # answers it via its L28 lane (prevotes at vr vs the CURRENT
        # round's proposal value).
        if self._prevotes_for(vr, propose.value) < 2 * self.f + 1:
            return

        if self.broadcaster is not None:
            lockable = (
                self.state.locked_round <= vr
                or self.state.locked_value == propose.value
            )
            self.broadcaster.broadcast_prevote(
                Prevote(
                    height=self.state.current_height,
                    round=self.state.current_round,
                    value=propose.value if (lockable and propose_is_valid) else NIL_VALUE,
                    sender=self.whoami,
                )
            )
        self._step_to_prevoting()

    def _try_timeout_prevote_upon_sufficient_prevotes(self) -> None:
        """L34: first time 2f+1 prevotes (any value) arrive while prevoting
        -> schedule the prevote timeout (reference: process/process.go:527-540)."""
        if self._check_once_flag(
            self.state.current_round, OnceFlag.TIMEOUT_PREVOTE_UPON_SUFFICIENT_PREVOTES
        ):
            return
        if self.state.current_step != Step.PREVOTING:
            return
        if self._prevote_total(self.state.current_round) >= 2 * self.f + 1:
            if self.timer is not None:
                self.timer.timeout_prevote(
                    self.state.current_height, self.state.current_round
                )
                if self.obs is not NULL_BOUND:
                    self.obs.emit(
                        "timeout.prevote.scheduled",
                        self.state.current_height,
                        self.state.current_round,
                    )
                self._set_once_flag(
                    self.state.current_round,
                    OnceFlag.TIMEOUT_PREVOTE_UPON_SUFFICIENT_PREVOTES,
                )

    def _try_precommit_upon_sufficient_prevotes(self) -> None:
        """L36: valid proposal plus 2f+1 prevotes for its value, first time,
        at step >= prevote -> lock it, precommit it, and record it as valid
        (reference: process/process.go:558-611).

        The reference sets the once-flag *before* its deferred
        step-change/retries run (Go defers are LIFO); the equivalent ordering
        here is: lock+broadcast, record valid value/round, set the flag, and
        only then run the retries and the step change.
        """
        if self._check_once_flag(
            self.state.current_round, OnceFlag.PRECOMMIT_UPON_SUFFICIENT_PREVOTES
        ):
            return
        if self.state.current_step < Step.PREVOTING:
            return
        propose = self.state.propose_logs.get(self.state.current_round)
        if propose is None:
            return
        if not self.state.propose_is_valid.get(self.state.current_round, False):
            return
        # Device-or-host tally (reference scan: process/process.go:574-579).
        if (
            self._prevotes_for(self.state.current_round, propose.value)
            < 2 * self.f + 1
        ):
            return

        was_prevoting = self.state.current_step == Step.PREVOTING
        if was_prevoting:
            self.state.locked_value = propose.value
            self.state.locked_round = self.state.current_round
            if self.broadcaster is not None:
                self.broadcaster.broadcast_precommit(
                    Precommit(
                        height=self.state.current_height,
                        round=self.state.current_round,
                        value=propose.value,
                        sender=self.whoami,
                    )
                )
        self.state.valid_value = propose.value
        self.state.valid_round = self.state.current_round
        self._set_once_flag(
            self.state.current_round, OnceFlag.PRECOMMIT_UPON_SUFFICIENT_PREVOTES
        )
        if was_prevoting:
            # Locked value/round changed: retry the prevote rules (no-ops
            # unless a later rule moved us back to Proposing), then step.
            self._try_prevote_upon_propose()
            self._try_prevote_upon_sufficient_prevotes()
            self._step_to_precommitting()

    def _try_precommit_nil_upon_sufficient_prevotes(self) -> None:
        """L44: 2f+1 nil prevotes while prevoting -> precommit nil
        (reference: process/process.go:622-643)."""
        if self.state.current_step != Step.PREVOTING:
            return
        # Device-or-host tally (reference scan: process/process.go:626-631).
        if (
            self._prevotes_for(self.state.current_round, NIL_VALUE)
            >= 2 * self.f + 1
        ):
            if self.broadcaster is not None:
                self.broadcaster.broadcast_precommit(
                    Precommit(
                        height=self.state.current_height,
                        round=self.state.current_round,
                        value=NIL_VALUE,
                        sender=self.whoami,
                    )
                )
            self._step_to_precommitting()

    def _try_timeout_precommit_upon_sufficient_precommits(self) -> None:
        """L47: first time 2f+1 precommits (any value) arrive at the
        current round -> schedule the precommit timeout
        (reference: process/process.go:654-664). The reference checks
        ``== 2f+1`` — safe there because per-message inserts grow the log
        by exactly one, so the first sufficient state is always exactly
        2f+1. Under batched ingestion (:meth:`ingest`) a window can jump
        the count past 2f+1 in one pass, so the check must be ``>=``; the
        once-flag keeps it single-fire, making ``>=`` and ``==``
        observationally identical on the per-message path."""
        if self._check_once_flag(
            self.state.current_round,
            OnceFlag.TIMEOUT_PRECOMMIT_UPON_SUFFICIENT_PRECOMMITS,
        ):
            return
        if self._precommit_total(self.state.current_round) >= 2 * self.f + 1:
            if self.timer is not None:
                self.timer.timeout_precommit(
                    self.state.current_height, self.state.current_round
                )
                if self.obs is not NULL_BOUND:
                    self.obs.emit(
                        "timeout.precommit.scheduled",
                        self.state.current_height,
                        self.state.current_round,
                    )
                self._set_once_flag(
                    self.state.current_round,
                    OnceFlag.TIMEOUT_PRECOMMIT_UPON_SUFFICIENT_PRECOMMITS,
                )

    def _try_commit_upon_sufficient_precommits(self, round: Round) -> None:
        """L49: valid proposal at ``round`` plus 2f+1 precommits for its
        value -> commit, advance the height, and restart at round 0
        (reference: process/process.go:686-730). The committer may rotate
        the validator set by returning a non-zero f / non-None scheduler."""
        propose = self.state.propose_logs.get(round)
        if propose is None:
            return
        if not self.state.propose_is_valid.get(round, False):
            return
        # Device-or-host tally (reference scan: process/process.go:696-701).
        if self._precommits_for(round, propose.value) < 2 * self.f + 1:
            return

        if self.obs is not NULL_BOUND:
            # Emit before the height advance so the event's (height, round)
            # keys name the committed height, not its successor.
            self.obs.emit(
                "commit",
                self.state.current_height,
                round,
                propose.value.hex()[:16],
            )
        if self.certifier is not None:
            # Mint the O(1) commit proof from the quorum that just fired.
            # The log scan is once-per-commit (cold path); the hot tally
            # checks above never touch it.
            signers = [
                sender
                for sender, pc in self.state.precommit_logs.get(
                    round, {}
                ).items()
                if pc.value == propose.value
            ]
            self.certifier.observe_commit(
                self.state.current_height, round, propose.value, signers
            )
        new_f, new_scheduler = self.committer.commit(
            self.state.current_height, propose.value
        )
        if new_f != 0:
            self.f = int(new_f)
        if new_scheduler is not None:
            self.scheduler = new_scheduler
        self.state.current_height += 1
        self.state.reset_for_new_height()
        self.start_round(0)

    def _try_skip_to_future_round(self, round: Round) -> None:
        """L55: messages from f+1 unique signatories at a future round ->
        jump to that round (reference: process/process.go:744-754)."""
        if round <= self.state.current_round:
            return
        if len(self.state.trace_logs.get(round, ())) >= self.f + 1:
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "round.skip",
                    self.state.current_height,
                    round,
                    self.state.current_round,
                )
            self.start_round(round)

    # --------------------------------------------------------------- inserts

    def _insert_propose(self, propose: Propose) -> bool:
        """Validate and log a Propose (reference: process/process.go:758-819).

        Returns True iff the message was inserted (valid or not); an invalid
        or nil-valued proposal is logged as invalid so duplicates are still
        detected, but its sender earns no trace-log credit.
        """
        if propose.height != self.state.current_height:
            return False
        if propose.round <= INVALID_ROUND:
            return False

        # Schedule check precedes duplicate detection: duplicates only matter
        # from the scheduled proposer.
        if self.scheduler is not None:
            expected = self.scheduler.schedule(propose.height, propose.round)
            if expected != propose.sender:
                if self.catcher is not None:
                    self.catcher.catch_out_of_turn_propose(propose)
                return False

        existing = self.state.propose_logs.get(propose.round)
        if existing is not None:
            if propose != existing and self.catcher is not None:
                self.catcher.catch_double_propose(propose, existing)
            return False

        # NIL proposals short-circuit before the validator runs (validators
        # never see NIL values — the pre-existing contract). Otherwise a
        # validator that checks whole proposals (duck-typed `valid_propose`,
        # e.g. "does the payload bundle match the value commitment?") takes
        # precedence over the value-only check — the MPC extension hook.
        if propose.value == NIL_VALUE:
            is_valid = False
        elif self.validator is None:
            is_valid = True
        else:
            valid_propose = getattr(self.validator, "valid_propose", None)
            if valid_propose is not None:
                is_valid = valid_propose(propose)
            else:
                is_valid = self.validator.valid(
                    propose.height, propose.round, propose.value
                )
        if not is_valid:
            self.state.propose_logs[propose.round] = propose
            self.state.propose_is_valid[propose.round] = False
            return True

        self.state.propose_logs[propose.round] = propose
        self.state.propose_is_valid[propose.round] = True
        self.state.trace_logs.setdefault(propose.round, set()).add(propose.sender)
        return True

    def _insert_prevote(self, prevote: Prevote) -> bool:
        """Validate and log a Prevote (reference: process/process.go:823-855)."""
        if prevote.height != self.state.current_height:
            return False
        existing = self.state.add_prevote(prevote)
        if existing is not None:
            if prevote != existing and self.catcher is not None:
                self.catcher.catch_double_prevote(prevote, existing)
            return False
        return True

    def _insert_precommit(self, precommit: Precommit) -> bool:
        """Validate and log a Precommit (reference: process/process.go:860-892)."""
        if precommit.height != self.state.current_height:
            return False
        existing = self.state.add_precommit(precommit)
        if existing is not None:
            if precommit != existing and self.catcher is not None:
                self.catcher.catch_double_precommit(precommit, existing)
            return False
        return True

    # ------------------------------------------------------------ step moves

    def _step_to_prevoting(self) -> None:
        """Enter Prevoting and retry the rules the step change could open
        (reference: process/process.go:896-905)."""
        self.state.current_step = Step.PREVOTING
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "step.prevoting",
                self.state.current_height,
                self.state.current_round,
            )
        self._try_precommit_upon_sufficient_prevotes()
        self._try_precommit_nil_upon_sufficient_prevotes()
        self._try_timeout_prevote_upon_sufficient_prevotes()

    def _step_to_precommitting(self) -> None:
        """Enter Precommitting and retry the rules the step change could open
        (reference: process/process.go:909-916)."""
        self.state.current_step = Step.PRECOMMITTING
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "step.precommitting",
                self.state.current_height,
                self.state.current_round,
            )
        self._try_precommit_upon_sufficient_prevotes()

    # ------------------------------------------------------------ once flags

    def _check_once_flag(self, round: Round, flag: int) -> bool:
        return (self.state.once_flags.get(round, 0) & flag) == flag

    def _set_once_flag(self, round: Round, flag: int) -> None:
        self.state.once_flags[round] = self.state.once_flags.get(round, 0) | flag

    # ----------------------------------------------------------------- serde

    def marshal(self, w: Writer) -> None:
        """Checkpoint identity, f, and the full State
        (reference: process/process.go:183-206)."""
        w.bytes32(self.whoami)
        w.u64(self.f)
        self.state.marshal(w)

    def unmarshal_into(self, r: Reader) -> None:
        """Restore identity, f, and State from a checkpoint
        (reference: process/process.go:209-223).

        All fields are parsed into locals first and assigned only once the
        whole payload has deserialized, so a malformed checkpoint (even one
        that passes the envelope CRC) raises without leaving the Process
        torn between old and new state.
        """
        whoami = r.bytes32()
        f = r.u64()
        state = State.unmarshal(r)
        self.whoami = whoami
        self.f = f
        self.state = state

    # ------------------------------------------------------------ properties

    @property
    def current_height(self) -> Height:
        return self.state.current_height

    @property
    def current_round(self) -> Round:
        return self.state.current_round

    @property
    def current_step(self) -> Step:
        return self.state.current_step
