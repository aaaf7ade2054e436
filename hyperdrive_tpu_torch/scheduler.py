"""Proposer election schedulers.

Capability parity with the reference's ``scheduler/scheduler.go``: at every
(height, round) exactly one process must be elected proposer, all correct
processes must agree on the election, and the schedule must be locally
computable (no consensus needed to agree on the schedule itself).
"""

from __future__ import annotations

from hyperdrive_tpu_torch.types import INVALID_ROUND, Height, Round, Signatory

__all__ = ["RoundRobin"]

_U64_MASK = (1 << 64) - 1


class RoundRobin:
    """Rotates through the signatory set by ``(height + round) % n``.

    Simple and easy to audit, but unfair — avoid when proposers are
    rewarded (reference: scheduler/scheduler.go:26-31). Height/round sums
    wrap modulo 2^64 exactly as the reference's uint64 conversion does
    (scheduler/scheduler.go:52), so edge-case heights like MaxInt64 elect
    the same proposer in both implementations.
    """

    __slots__ = ("signatories",)

    def __init__(self, signatories: list[Signatory]):
        self.signatories = list(signatories)

    def schedule(self, height: Height, round: Round) -> Signatory:
        if not self.signatories:
            raise ValueError("no processes to schedule")
        if height <= 0:
            raise ValueError(f"invalid height: {height}")
        if round <= INVALID_ROUND:
            raise ValueError(f"invalid round: {round}")
        idx = (((height & _U64_MASK) + (round & _U64_MASK)) & _U64_MASK) % len(
            self.signatories
        )
        return self.signatories[idx]
