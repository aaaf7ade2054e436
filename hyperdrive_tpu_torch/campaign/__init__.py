"""Attack campaigns: the adversarial economy as a first-class workload.

Port copy of the JAX package's ``campaign/`` package. Tendermint-BFT's
safety argument (PAPER.md, arXiv:1807.04938) assumes less than one third
of *stake* is Byzantine. The repo grew the defenses that protect that
assumption one module at a time: stake-driven elections (epochs.py),
overload shedding (load/), overlay contribution scoring
(overlay/score.py) and batch signature verification. This package
composes them against the economic attacks they were built to resist:
seeded, replayable, multi-epoch attack campaigns, run as probe-style
workloads against the real subsystems (the admission gate, the host
ledger executor, the epoch schedule, the aggregation topology) at 1024+
validators, with the chaos monitor's
:class:`~hyperdrive_tpu_torch.chaos.monitor.InvariantViolation` as the
only failure currency.

Three campaign families (families.py):

- **storm**: signed-vote storms, forged-but-well-formed Ed25519
  signatures at open-loop rates that pass every cheap admission check
  and die only at batch verify, exercising the
  :class:`~hyperdrive_tpu_torch.load.backpressure.SignerReputation`
  feedback loop that moves repeat forgers from the expensive post-verify
  shed to the cheap pre-verify one.
- **capture**: validator-set capture, an adversary with a fixed stake
  budget drives grinding / splitting / delegation-churn transaction
  workloads through the real ``exec/`` ledger across >= 8 epochs,
  trying to exceed its proportional committee share; the
  arXiv:2004.12990 proportionality bound is enforced over the whole
  campaign trajectory, grinding allowance included.
- **coincidence**: everything at once, the capture attempt, plus a
  partition slicing the aggregation tree along a level boundary, plus
  the signature storm overloading admission.

Every campaign is a pure function of its :class:`CampaignConfig`; a
:class:`~hyperdrive_tpu_torch.campaign.record.CampaignRecord` captures
the config and the outcome digest, and replay re-derives the identical
trajectory bit for bit. The batch verify of the storm and coincidence
families runs the ``ed25519_verify`` kernel through a card
``TorchBatchVerifier`` (``device="cpu"``: a ``HostVerifier``); the
summary, and so the digest, is the same either way. Everything else is
host-side numpy. The campaign CLI (``python -m hyperdrive_tpu.campaign``)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = [
    "FAMILIES",
    "CampaignConfig",
    "CampaignRecord",
    "CampaignOutcome",
    "run_campaign",
    "replay_campaign",
]

#: The closed family vocabulary, in CLI order. Index IS the wire
#: encoding (CampaignRecord stores the index), so order is append-only.
FAMILIES = ("storm", "capture", "coincidence")


@dataclass(frozen=True)
class CampaignConfig:
    """One campaign's full parameterization.

    Every field is an integer (or the family name, wire-encoded as its
    :data:`FAMILIES` index), so :meth:`as_ints` round-trips the whole
    config through the record's length-prefixed u64 trailer, the same
    forward-compatible shape ScenarioRecord's execution trailer uses.
    """

    family: str = "storm"
    seed: int = 0
    #: Validator-pool size (the ``n`` every subsystem is sized to).
    validators: int = 1024
    #: Committee size: the active signer set in a storm, the elected
    #: committee in a capture.
    committee_size: int = 64
    #: Capture/coincidence: epochs the campaign spans (>= 8 for the
    #: acceptance trajectory) and heights per epoch.
    epochs: int = 8
    epoch_length: int = 4
    #: Storm: forging signers (a suffix of the committee), open-loop
    #: waves, honest votes per signer per wave, and the forged-frame
    #: multiplier per attacker per wave.
    attackers: int = 16
    waves: int = 6
    wave_votes: int = 2
    attack_rate: int = 8
    #: Capture: adversary (sybil) accounts and their share of genesis
    #: stake in milli (200 = 20%), and the number of candidate
    #: boundary-block plans the grinder evaluates per epoch.
    sybils: int = 16
    budget_milli: int = 200
    grind_width: int = 8
    #: Storm: reputation loop on. The bench's no-reputation control
    #: flips this to measure the loop's post-verify-cost cut.
    reputation: bool = True

    def validate(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown campaign family {self.family!r}")
        if self.validators < 4:
            raise ValueError("campaign needs >= 4 validators")
        if not 3 <= self.committee_size <= self.validators:
            raise ValueError(
                f"committee_size {self.committee_size} out of range "
                f"[3, {self.validators}]"
            )
        if not 0 < self.attackers < self.committee_size:
            raise ValueError(
                "attackers must leave at least one honest signer"
            )
        if not 0 < self.sybils <= self.validators // 2:
            raise ValueError("sybils must be in (0, validators/2]")
        if not 0 < self.budget_milli < 334:
            raise ValueError(
                "budget_milli must stay under the 1/3 Byzantine-stake "
                "assumption (got %d)" % self.budget_milli
            )
        if self.epochs < 1 or self.epoch_length < 1:
            raise ValueError("epochs and epoch_length must be >= 1")
        if self.waves < 1 or self.wave_votes < 1 or self.attack_rate < 1:
            raise ValueError("storm knobs must be >= 1")
        if self.grind_width < 1:
            raise ValueError("grind_width must be >= 1")

    def as_ints(self) -> tuple:
        """The config as a fixed-order u64 tuple (record trailer)."""
        return (
            FAMILIES.index(self.family),
            self.seed,
            self.validators,
            self.committee_size,
            self.epochs,
            self.epoch_length,
            self.attackers,
            self.waves,
            self.wave_votes,
            self.attack_rate,
            self.sybils,
            self.budget_milli,
            self.grind_width,
            1 if self.reputation else 0,
        )

    @classmethod
    def from_ints(cls, ints) -> "CampaignConfig":
        """Rebuild from :meth:`as_ints` output. Extra trailing ints are
        ignored (same forward-compatibility rule as the execution
        trailer: a future field extends the tuple, old readers skip)."""
        vals = list(ints)
        if len(vals) < 14:
            raise ValueError(
                f"campaign config trailer too short: {len(vals)} ints"
            )
        if not 0 <= int(vals[0]) < len(FAMILIES):
            raise ValueError(
                f"unknown campaign family index {int(vals[0])}"
            )
        return cls(
            family=FAMILIES[int(vals[0])],
            seed=int(vals[1]),
            validators=int(vals[2]),
            committee_size=int(vals[3]),
            epochs=int(vals[4]),
            epoch_length=int(vals[5]),
            attackers=int(vals[6]),
            waves=int(vals[7]),
            wave_votes=int(vals[8]),
            attack_rate=int(vals[9]),
            sybils=int(vals[10]),
            budget_milli=int(vals[11]),
            grind_width=int(vals[12]),
            reputation=bool(vals[13]),
        )

    def with_family(self, family: str) -> "CampaignConfig":
        return replace(self, family=family)


def __getattr__(name):
    # Lazy re-exports: importing the package stays cheap until a
    # campaign actually runs (the idiom exec/__init__.py uses for its
    # executor classes).
    if name == "CampaignRecord":
        from hyperdrive_tpu_torch.campaign.record import CampaignRecord

        return CampaignRecord
    if name in ("CampaignOutcome", "run_campaign", "replay_campaign"):
        from hyperdrive_tpu_torch.campaign import runner

        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
