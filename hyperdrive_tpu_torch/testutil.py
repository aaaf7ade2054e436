"""Test doubles for the consensus seams.

Port copy of the callback-struct mocks of ``hyperdrive_tpu/testutil.py``
(reference: processutil/processutil.go:12-130) that the harness wires into
every replica: ``BroadcasterCallbacks``, ``CommitterCallback``,
``MockProposer``, ``MockValidator`` and ``CatcherCallbacks``. The random
edge-case generators are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose
from hyperdrive_tpu_torch.types import NIL_VALUE, Height, Round, Value

__all__ = [
    "BroadcasterCallbacks",
    "CommitterCallback",
    "MockProposer",
    "MockValidator",
    "CatcherCallbacks",
]


# ------------------------------------------------------------------- mocks


@dataclass
class BroadcasterCallbacks:
    """Nil-safe broadcast hooks (reference: processutil/processutil.go:12-44)."""

    on_propose: Optional[Callable[[Propose], None]] = None
    on_prevote: Optional[Callable[[Prevote], None]] = None
    on_precommit: Optional[Callable[[Precommit], None]] = None

    def broadcast_propose(self, propose: Propose) -> None:
        if self.on_propose is not None:
            self.on_propose(propose)

    def broadcast_prevote(self, prevote: Prevote) -> None:
        if self.on_prevote is not None:
            self.on_prevote(prevote)

    def broadcast_precommit(self, precommit: Precommit) -> None:
        if self.on_precommit is not None:
            self.on_precommit(precommit)


@dataclass
class CommitterCallback:
    """Commit hook returning (new_f, new_scheduler)
    (reference: processutil/processutil.go:47-58)."""

    on_commit: Optional[Callable[[Height, Value], tuple[int, object]]] = None

    def commit(self, height: Height, value: Value):
        if self.on_commit is not None:
            return self.on_commit(height, value)
        return 0, None


@dataclass
class MockProposer:
    """Fixed- or callback-valued proposer
    (reference: processutil/processutil.go:61-75)."""

    value: Optional[Value] = None
    fn: Optional[Callable[[Height, Round], Value]] = None

    def propose(self, height: Height, round: Round) -> Value:
        if self.fn is not None:
            return self.fn(height, round)
        return self.value if self.value is not None else NIL_VALUE


@dataclass
class MockValidator:
    """Constant or callback validity predicate
    (reference: processutil/processutil.go:78-95)."""

    ok: bool = True
    fn: Optional[Callable[[Height, Round, Value], bool]] = None

    def valid(self, height: Height, round: Round, value: Value) -> bool:
        if self.fn is not None:
            return self.fn(height, round, value)
        return self.ok


@dataclass
class CatcherCallbacks:
    """Nil-safe misbehaviour hooks (reference: processutil/processutil.go:98-130)."""

    on_double_propose: Optional[Callable[[Propose, Propose], None]] = None
    on_double_prevote: Optional[Callable[[Prevote, Prevote], None]] = None
    on_double_precommit: Optional[Callable[[Precommit, Precommit], None]] = None
    on_out_of_turn_propose: Optional[Callable[[Propose], None]] = None

    def catch_double_propose(self, new: Propose, existing: Propose) -> None:
        if self.on_double_propose is not None:
            self.on_double_propose(new, existing)

    def catch_double_prevote(self, new: Prevote, existing: Prevote) -> None:
        if self.on_double_prevote is not None:
            self.on_double_prevote(new, existing)

    def catch_double_precommit(self, new: Precommit, existing: Precommit) -> None:
        if self.on_double_precommit is not None:
            self.on_double_precommit(new, existing)

    def catch_out_of_turn_propose(self, propose: Propose) -> None:
        if self.on_out_of_turn_propose is not None:
            self.on_out_of_turn_propose(propose)
