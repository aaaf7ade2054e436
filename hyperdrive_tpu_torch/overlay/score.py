"""Contribution scoring: the overlay's Byzantine-robustness mechanism.

Handel's insight (arXiv:1906.05132 §4.3) is that an aggregation tree
does not need to *detect* Byzantine peers, only to *deprioritize*
them: every frame a peer contributes is scored by how much new signer
coverage it delivered, and peers whose frames are invalid, stale, or
simply absent drift to the back of every contact queue. The sim keeps
one network-wide score table (a real deployment scores per-observer;
collapsing to a shared table is a documented simplification that keeps
memory O(n) instead of O(n²) at 4096 validators and makes the
monitor's "no honest peer permanently demoted" invariant directly
checkable).

All arithmetic is integer — scores feed ranked fallback ordering,
which feeds message order, which feeds the commit digest, so a float
anywhere here would put platform rounding into consensus replay.

Demotion is advisory, never exclusion (the never-starve doctrine): a
demoted peer still has its frames processed and can still earn its way
back over the demotion threshold — chaos asserts that honest peers
demoted during a fault window recover after it heals.

Port copy of ``hyperdrive_tpu/overlay/score.py``, unchanged (pure integer
Python). The chaos monitor named above is
:class:`~hyperdrive_tpu_torch.chaos.InvariantMonitor` (``_check_overlay``).
"""

from __future__ import annotations

__all__ = ["ContributionScores", "CHARGE_WEIGHTS"]

#: Integer penalty per misbehavior class. Keys align with the shared
#: frame-classification vocabulary (load/frames.py) plus the two
#: overlay-only verdicts a classifier cannot see: ``invalid`` (the
#: DeviceWorkQueue verify mask rejected rows of the partial aggregate)
#: and ``withheld`` (a contacted peer sent nothing inside the level
#: window).
CHARGE_WEIGHTS = {
    "invalid": 6,
    "stale_generation": 2,
    "duplicate": 1,
    "withheld": 1,
}


class ContributionScores:
    """Network-wide integer reputation for overlay contributors."""

    def __init__(
        self,
        n: int,
        *,
        credit: int = 2,
        demote_at: int = -8,
        floor: int = -64,
        on_demote=None,
        on_recover=None,
    ):
        if demote_at <= floor:
            raise ValueError("demote_at must sit above the score floor")
        self.n = n
        self.credit_per_signer = int(credit)
        self.demote_at = int(demote_at)
        self.floor = int(floor)
        self.scores = [0] * n
        self.demoted: set = set()
        self.demotions = 0
        self.recoveries = 0
        self.charges = {k: 0 for k in CHARGE_WEIGHTS}
        self._on_demote = on_demote
        self._on_recover = on_recover

    # ------------------------------------------------------------ updates

    def credit_coverage(self, peer: int, new_signers: int) -> int:
        """Reward ``peer`` for a frame that delivered ``new_signers``
        previously-unseen valid signatures to its receiver."""
        if new_signers <= 0:
            return self.scores[peer]
        s = self.scores[peer] + self.credit_per_signer * new_signers
        self.scores[peer] = s
        if peer in self.demoted and s > self.demote_at:
            self.demoted.discard(peer)
            self.recoveries += 1
            if self._on_recover is not None:
                self._on_recover(peer, s)
        return s

    def charge(self, peer: int, cls: str) -> int:
        """Debit ``peer`` for a misbehavior class; clamps at the floor
        so a long fault window stays recoverable in bounded credit."""
        weight = CHARGE_WEIGHTS[cls]
        self.charges[cls] += 1
        s = max(self.floor, self.scores[peer] - weight)
        self.scores[peer] = s
        if s <= self.demote_at and peer not in self.demoted:
            self.demoted.add(peer)
            self.demotions += 1
            if self._on_demote is not None:
                self._on_demote(peer, s, cls)
        return s

    def rehabilitate(self, amount: int) -> None:
        """Time-based amnesty: pull every nonzero score ``amount``
        toward zero. Called once per committed height, it bounds how
        long any verdict — fair or not — stays on the books. The
        asymmetry that makes this safe: a peer silenced by a partition
        is indistinguishable from a withholder to its observers, but it
        stops accruing charges the moment the fault heals, so amnesty
        plus fresh contribution credit restores it in
        O(depth / heal_rate) heights — while an actively-Byzantine peer
        re-earns its debt every slot faster than amnesty forgives it
        (invalid frames cost ``6`` per observer vs one amnesty step per
        committed height)."""
        if amount <= 0:
            return
        for p in range(self.n):
            s = self.scores[p]
            if s < 0:
                s = min(0, s + amount)
            elif s > 0:
                s = max(0, s - amount)
            else:
                continue
            self.scores[p] = s
            if p in self.demoted and s > self.demote_at:
                self.demoted.discard(p)
                self.recoveries += 1
                if self._on_recover is not None:
                    self._on_recover(p, s)

    # ------------------------------------------------------------ queries

    def is_demoted(self, peer: int) -> bool:
        return peer in self.demoted

    def ranked(self, exclude: int = -1) -> list:
        """All peers best-first: score desc, demoted last, index as the
        deterministic tiebreak. Feeds the ranked direct-gossip fallback
        — demoted peers are *last*, not absent (never-starve)."""
        return sorted(
            (p for p in range(self.n) if p != exclude),
            key=lambda p: (p in self.demoted, -self.scores[p], p),
        )

    def snapshot(self) -> dict:
        return {
            "demoted": sorted(self.demoted),
            "demotions": self.demotions,
            "recoveries": self.recoveries,
            "charges": dict(self.charges),
            "min": min(self.scores) if self.scores else 0,
            "max": max(self.scores) if self.scores else 0,
        }
