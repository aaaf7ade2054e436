"""Campaign runner: run, check, record, replay.

Port copy of the JAX package's ``campaign/runner.py``. ``run_campaign``
drives one family engine, feeds the summary through the chaos monitor's
campaign checks, and wraps the outcome in a
:class:`~hyperdrive_tpu_torch.campaign.record.CampaignRecord`. Violations
are collected, not raised: the caller decides whether a violation dumps
artifacts, raises, or both.

``replay_campaign`` is the determinism proof: re-run the record's config
from scratch and require the fresh summary digest to equal the recorded
one bit for bit.

The storm and coincidence engines batch-verify on ``device``: the card by
default (``TorchBatchVerifier``, the ``ed25519_verify`` kernel),
``device="cpu"`` for the reference's ``HostVerifier``; ``run_campaign(
verifier=)`` hands in any object with ``verify_signatures`` instead. The
digest does not depend on the choice. Dropped, as the port's conventions say: the
metrics ``registry`` and the recorder (``obs``); a value other than None
for either raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperdrive_tpu_torch.campaign import CampaignConfig
from hyperdrive_tpu_torch.campaign.families import ENGINES, batch_verifier
from hyperdrive_tpu_torch.campaign.record import CampaignRecord
from hyperdrive_tpu_torch.chaos.monitor import InvariantMonitor, InvariantViolation

__all__ = ["CampaignOutcome", "run_campaign", "replay_campaign"]

_LATER = "not ported to the PyTorch package yet (a later slice of the port)"


@dataclass
class CampaignOutcome:
    config: CampaignConfig
    summary: dict
    record: CampaignRecord
    #: ``(kind, detail)`` per check that failed; empty = clean run.
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def digest(self) -> bytes:
        return self.record.digest


def _checks_for(config: CampaignConfig, summary: dict):
    mon = InvariantMonitor
    if config.family == "storm":
        yield lambda: mon.check_storm_hygiene(summary)
    if config.family in ("capture", "coincidence"):
        yield lambda: mon.check_campaign_proportionality(
            summary["trajectory"], grind_width=config.grind_width
        )
    if config.family == "coincidence":
        yield lambda: mon.check_campaign_economy(summary)


def run_campaign(
    config: CampaignConfig,
    *,
    device=None,
    verifier=None,
    registry=None,
    obs=None,
) -> CampaignOutcome:
    """Run one campaign and judge it. Deterministic in ``config``: the
    verifier's device never feeds the summary, so the outcome digest is
    a pure function of the config. Capture verifies no signature and
    builds no verifier."""
    for name, value in (("registry", registry), ("obs", obs)):
        if value is not None:
            raise NotImplementedError(f"run_campaign({name}=...) is {_LATER}")
    config.validate()
    if verifier is None and config.family != "capture":
        verifier = batch_verifier(device)
    summary = ENGINES[config.family](config, verifier)
    violations = []
    for check in _checks_for(config, summary):
        try:
            check()
        except InvariantViolation as err:
            violations.append((err.kind, str(err)))
    return CampaignOutcome(
        config=config,
        summary=summary,
        record=CampaignRecord.capture(config, summary),
        violations=violations,
    )


def replay_campaign(
    record: CampaignRecord, *, device=None, registry=None, obs=None,
) -> tuple[bool, CampaignOutcome]:
    """Re-run a recorded campaign from its config alone, on ``device``,
    and compare digests. ``(True, outcome)`` iff the fresh trajectory is
    bit-identical to the recorded one."""
    outcome = run_campaign(record.config, device=device, registry=registry,
                           obs=obs)
    return outcome.digest == record.digest, outcome
