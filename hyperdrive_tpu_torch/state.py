"""The mutable State of a consensus Process, with checkpoint serde.

Capability parity with the reference's ``process/state.go:35-279``: current
height/round/step, the locked and valid value/round pair, full per-round
message logs (proposes + validity, prevotes, precommits), once-flags, and
trace logs (unique signatories seen per round, powering the f+1 round-skip
rule L55). The whole State round-trips through the canonical codec so a
replica can be checkpointed after every method call and restored after a
crash (reference contract: process/state.go:18-20).

Port copy of ``hyperdrive_tpu/state.py`` for the PyTorch package,
unchanged, with its ``state.checkpoint`` wire registration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose
from hyperdrive_tpu_torch.types import (
    DEFAULT_HEIGHT,
    DEFAULT_ROUND,
    INVALID_ROUND,
    NIL_VALUE,
    Step,
)

__all__ = ["State", "OnceFlag"]


class OnceFlag:
    """Bit flags guaranteeing per-round once-only events.

    Reference: ``process/process.go:929-938``.
    """

    TIMEOUT_PRECOMMIT_UPON_SUFFICIENT_PRECOMMITS = 1
    TIMEOUT_PREVOTE_UPON_SUFFICIENT_PREVOTES = 2
    PRECOMMIT_UPON_SUFFICIENT_PREVOTES = 4


# A sane upper bound on log sizes accepted while unmarshaling a checkpoint.
# (The byte budget is the real defense; this just gives clearer errors.)
_MAX_LOG_ENTRIES = 1 << 20


@wire_codec(tag="state.checkpoint", max_bytes=1 << 28)
@dataclass
class State:
    """Consensus-automaton state (paper L1 initialization block)."""

    current_height: int = DEFAULT_HEIGHT
    current_round: int = DEFAULT_ROUND
    current_step: Step = Step.PROPOSING
    locked_value: bytes = NIL_VALUE
    locked_round: int = INVALID_ROUND
    valid_value: bytes = NIL_VALUE
    valid_round: int = INVALID_ROUND

    # round -> Propose
    propose_logs: dict[int, Propose] = field(default_factory=dict)
    # round -> bool (validity of the stored propose)
    propose_is_valid: dict[int, bool] = field(default_factory=dict)
    # round -> {signatory -> Prevote}
    prevote_logs: dict[int, dict[bytes, Prevote]] = field(default_factory=dict)
    # round -> {signatory -> Precommit}
    precommit_logs: dict[int, dict[bytes, Precommit]] = field(default_factory=dict)
    # round -> OnceFlag bits
    once_flags: dict[int, int] = field(default_factory=dict)
    # round -> set of unique signatories seen this round (L55 round skip)
    trace_logs: dict[int, set[bytes]] = field(default_factory=dict)

    # Derived tallies: round -> {value -> count} over the vote logs,
    # maintained incrementally by :meth:`add_prevote`/:meth:`add_precommit`
    # so every quorum rule reads one dict lookup instead of scanning the
    # round's votes (the reference's four O(n) hot loops,
    # process/process.go:487-491, 574-579, 626-631, 696-701 — at n=256
    # those scans are the host bottleneck). Not serialized: rebuilt from
    # the logs on unmarshal, so the checkpoint format is unchanged.
    prevote_counts: dict[int, dict[bytes, int]] = field(default_factory=dict)
    precommit_counts: dict[int, dict[bytes, int]] = field(default_factory=dict)

    # ------------------------------------------------------------------ basics

    @classmethod
    def default_with_height(cls, height: int) -> "State":
        return cls(current_height=height)

    def clone(self) -> "State":
        """Deep copy (reference: process/state.go:89-134)."""
        return State(
            current_height=self.current_height,
            current_round=self.current_round,
            current_step=self.current_step,
            locked_value=self.locked_value,
            locked_round=self.locked_round,
            valid_value=self.valid_value,
            valid_round=self.valid_round,
            propose_logs=dict(self.propose_logs),
            propose_is_valid=dict(self.propose_is_valid),
            prevote_logs={r: dict(m) for r, m in self.prevote_logs.items()},
            precommit_logs={r: dict(m) for r, m in self.precommit_logs.items()},
            once_flags=dict(self.once_flags),
            trace_logs={r: set(s) for r, s in self.trace_logs.items()},
            prevote_counts={r: dict(c) for r, c in self.prevote_counts.items()},
            precommit_counts={r: dict(c) for r, c in self.precommit_counts.items()},
        )

    def equal(self, other: "State") -> bool:
        """Scalar-field equality; logs and once-flags are ignored
        (reference: process/state.go:139-149)."""
        return (
            self.current_height == other.current_height
            and self.current_round == other.current_round
            and self.current_step == other.current_step
            and self.locked_value == other.locked_value
            and self.locked_round == other.locked_round
            and self.valid_value == other.valid_value
            and self.valid_round == other.valid_round
        )

    def reset_for_new_height(self) -> None:
        """Wipe locks and logs when moving to the next height
        (reference: process/process.go:712-725)."""
        self.locked_value = NIL_VALUE
        self.locked_round = INVALID_ROUND
        self.valid_value = NIL_VALUE
        self.valid_round = INVALID_ROUND
        self.propose_logs = {}
        self.propose_is_valid = {}
        self.prevote_logs = {}
        self.precommit_logs = {}
        self.once_flags = {}
        self.trace_logs = {}
        self.prevote_counts = {}
        self.precommit_counts = {}

    # ------------------------------------------------------------ vote logging

    def add_prevote(self, prevote: Prevote):
        """Log a prevote, updating the round's tally and trace log.

        Returns the already-logged vote from the same sender (without
        mutating anything) if one exists — the caller decides whether that
        is a duplicate or equivocation — else None after inserting.
        """
        rnd = prevote.round
        votes = self.prevote_logs.get(rnd)
        if votes is None:
            votes = self.prevote_logs[rnd] = {}
        existing = votes.get(prevote.sender)
        if existing is not None:
            return existing
        votes[prevote.sender] = prevote
        counts = self.prevote_counts.get(rnd)
        if counts is None:
            counts = self.prevote_counts[rnd] = {}
        counts[prevote.value] = counts.get(prevote.value, 0) + 1
        trace = self.trace_logs.get(rnd)
        if trace is None:
            trace = self.trace_logs[rnd] = set()
        trace.add(prevote.sender)
        return None

    def add_precommit(self, precommit: Precommit):
        """Log a precommit; same contract as :meth:`add_prevote`."""
        rnd = precommit.round
        votes = self.precommit_logs.get(rnd)
        if votes is None:
            votes = self.precommit_logs[rnd] = {}
        existing = votes.get(precommit.sender)
        if existing is not None:
            return existing
        votes[precommit.sender] = precommit
        counts = self.precommit_counts.get(rnd)
        if counts is None:
            counts = self.precommit_counts[rnd] = {}
        counts[precommit.value] = counts.get(precommit.value, 0) + 1
        trace = self.trace_logs.get(rnd)
        if trace is None:
            trace = self.trace_logs[rnd] = set()
        trace.add(precommit.sender)
        return None

    def count_prevotes_for(self, round: int, value: bytes) -> int:
        """Prevotes at ``round`` whose value equals ``value`` — O(1) from
        the derived tally, with an O(V) log scan when the round has no
        tally dict (device-tally ingestion skips host tally maintenance —
        the vote grid answers the hot queries, and the rare declined query
        lands here)."""
        counts = self.prevote_counts.get(round)
        if counts is not None:
            return counts.get(value, 0)
        votes = self.prevote_logs.get(round)
        if not votes:
            return 0
        return sum(1 for v in votes.values() if v.value == value)

    def count_precommits_for(self, round: int, value: bytes) -> int:
        """Precommits at ``round``; same contract as
        :meth:`count_prevotes_for`."""
        counts = self.precommit_counts.get(round)
        if counts is not None:
            return counts.get(value, 0)
        votes = self.precommit_logs.get(round)
        if not votes:
            return 0
        return sum(1 for v in votes.values() if v.value == value)

    def rebuild_counts(self) -> None:
        """Recompute the derived tallies from the logs — for states whose
        logs were populated directly (unmarshal, test generators)."""
        self.prevote_counts = {}
        for rnd, votes in self.prevote_logs.items():
            counts = self.prevote_counts.setdefault(rnd, {})
            for v in votes.values():
                counts[v.value] = counts.get(v.value, 0) + 1
        self.precommit_counts = {}
        for rnd, votes in self.precommit_logs.items():
            counts = self.precommit_counts.setdefault(rnd, {})
            for v in votes.values():
                counts[v.value] = counts.get(v.value, 0) + 1

    # ------------------------------------------------------------------- serde

    def marshal(self, w: Writer) -> None:
        w.i64(self.current_height)
        w.i64(self.current_round)
        w.u8(int(self.current_step))
        w.bytes32(self.locked_value)
        w.i64(self.locked_round)
        w.bytes32(self.valid_value)
        w.i64(self.valid_round)

        w.u32(len(self.propose_logs))
        for rnd in sorted(self.propose_logs):
            w.i64(rnd)
            self.propose_logs[rnd].marshal(w)

        w.u32(len(self.propose_is_valid))
        for rnd in sorted(self.propose_is_valid):
            w.i64(rnd)
            w.bool(self.propose_is_valid[rnd])

        w.u32(len(self.prevote_logs))
        for rnd in sorted(self.prevote_logs):
            w.i64(rnd)
            votes = self.prevote_logs[rnd]
            w.u32(len(votes))
            for sig in sorted(votes):
                votes[sig].marshal(w)

        w.u32(len(self.precommit_logs))
        for rnd in sorted(self.precommit_logs):
            w.i64(rnd)
            votes = self.precommit_logs[rnd]
            w.u32(len(votes))
            for sig in sorted(votes):
                votes[sig].marshal(w)

        w.u32(len(self.once_flags))
        for rnd in sorted(self.once_flags):
            w.i64(rnd)
            w.u16(self.once_flags[rnd])

        w.u32(len(self.trace_logs))
        for rnd in sorted(self.trace_logs):
            w.i64(rnd)
            sigs = self.trace_logs[rnd]
            w.u32(len(sigs))
            for sig in sorted(sigs):
                w.bytes32(sig)

    @classmethod
    def unmarshal(cls, r: Reader) -> "State":
        st = cls()
        st.current_height = r.i64()
        st.current_round = r.i64()
        step = r.u8()
        try:
            st.current_step = Step(step)
        except ValueError as e:
            raise SerdeError(f"invalid step: {step}") from e
        st.locked_value = r.bytes32()
        st.locked_round = r.i64()
        st.valid_value = r.bytes32()
        st.valid_round = r.i64()

        def _count() -> int:
            n = r.u32()
            if n > _MAX_LOG_ENTRIES:
                raise SerdeError(f"log length {n} exceeds cap")
            return n

        for _ in range(_count()):
            rnd = r.i64()
            st.propose_logs[rnd] = Propose.unmarshal(r)
        for _ in range(_count()):
            rnd = r.i64()
            st.propose_is_valid[rnd] = r.bool()
        for _ in range(_count()):
            rnd = r.i64()
            votes: dict[bytes, Prevote] = {}
            for _ in range(_count()):
                v = Prevote.unmarshal(r)
                votes[v.sender] = v
            st.prevote_logs[rnd] = votes
        for _ in range(_count()):
            rnd = r.i64()
            pvotes: dict[bytes, Precommit] = {}
            for _ in range(_count()):
                v = Precommit.unmarshal(r)
                pvotes[v.sender] = v
            st.precommit_logs[rnd] = pvotes
        for _ in range(_count()):
            rnd = r.i64()
            st.once_flags[rnd] = r.u16()
        for _ in range(_count()):
            rnd = r.i64()
            sigs: set[bytes] = set()
            for _ in range(_count()):
                sigs.add(r.bytes32())
            st.trace_logs[rnd] = sigs
        st.rebuild_counts()
        return st
