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
digest does not depend on the choice. The metrics ``registry`` and the
recorder (``obs``) are the reference's hooks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperdrive_tpu_torch.campaign import CampaignConfig
from hyperdrive_tpu_torch.campaign.families import ENGINES, batch_verifier
from hyperdrive_tpu_torch.campaign.record import CampaignRecord
from hyperdrive_tpu_torch.chaos.monitor import InvariantMonitor, InvariantViolation
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = ["CampaignOutcome", "run_campaign", "replay_campaign"]

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
    obs=NULL_BOUND,
) -> CampaignOutcome:
    """Run one campaign and judge it. Deterministic in ``config``: the
    verifier's device, the registry and obs observe the run but never feed
    the summary, so the outcome digest is a pure function of the config.
    Capture verifies no signature and builds no verifier."""
    config.validate()
    if verifier is None and config.family != "capture":
        verifier = batch_verifier(device)
    summary = ENGINES[config.family](config, verifier, registry, obs)
    violations = []
    for check in _checks_for(config, summary):
        try:
            check()
        except InvariantViolation as err:
            violations.append((err.kind, str(err)))
            if obs is not NULL_BOUND:
                obs.emit("campaign.violation", -1, -1, err.kind)
    record = CampaignRecord.capture(config, summary)
    if registry is not None:
        registry.count("campaign.runs", label=config.family)
        if violations:
            registry.count("campaign.violations", len(violations))
    if obs is not NULL_BOUND:
        obs.emit(
            "campaign.done", -1, -1,
            "%s %s violations=%d"
            % (config.family, record.digest[:8].hex(), len(violations)),
        )
    return CampaignOutcome(
        config=config,
        summary=summary,
        record=record,
        violations=violations,
    )


def replay_campaign(
    record: CampaignRecord, *, device=None, registry=None, obs=NULL_BOUND,
) -> tuple[bool, CampaignOutcome]:
    """Re-run a recorded campaign from its config alone, on ``device``,
    and compare digests. ``(True, outcome)`` iff the fresh trajectory is
    bit-identical to the recorded one."""
    outcome = run_campaign(record.config, device=device, registry=registry,
                           obs=obs)
    return outcome.digest == record.digest, outcome
