"""SLO definitions evaluated as burn-rate checks.

ACE Runtime (PAPERS.md, arXiv:2603.10242) makes sub-second finality
the *product* metric — so the soak legs should fail on the product
metric, not only on invariant violations. This module defines the
three serving objectives and evaluates them against what a run
already produces (a metrics-Registry snapshot and/or a journal event
stream), emitting one closed-taxonomy verdict mark per objective:

``finality_p99``
    99th-percentile certificate-accept latency, from the
    ``tenant.commit.latency`` histogram (worst tenant wins — an SLO
    is a floor for every tenant, not an average).
``shed_rate``
    shed frames / (shed + served) over the journal's admission and
    serve marks. Shedding is doctrine under overload, but a soak
    whose steady state sheds most of its offered load is failing its
    clients while passing its invariants.
``rollback_rate``
    speculative rollbacks / speculations (``exec.spec.*``). The
    speculation doctrine says mispredicts must be rare enough
    that the pipeline wins; this is where "rare enough" gets a number.

``burn`` is the classic burn-rate ratio measured/objective: 1.0 is
exactly on budget, >1.0 is burning error budget. Objectives whose
inputs are absent from the run (no histogram, no speculation) are
skipped, not passed — a missing signal is not evidence of health.

Port copy of ``hyperdrive_tpu/obs/slo.py``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass

from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = ["SloResult", "DEFAULT_OBJECTIVES", "evaluate_slos"]

#: Objective ceilings: finality p99 (seconds), shed fraction, rollback
#: fraction. Chaos/load soak legs evaluate against these unless the
#: caller overrides.
DEFAULT_OBJECTIVES = {
    "finality_p99": 0.75,
    "shed_rate": 0.25,
    "rollback_rate": 0.05,
}

#: Journal kinds that count as one shed decision.
_SHED_KINDS = frozenset({
    "admission.shed", "wire.frame.shed", "service.remote.shed",
    "proof.shed", "metrics.shed",
})

#: Journal kinds that count as one served/admitted unit of work — the
#: shed-rate denominator's "what got through" half.
_SERVE_KINDS = frozenset({
    "service.remote.submit", "proof.serve", "metrics.serve",
    "ingest.window",
})


@dataclass(frozen=True)
class SloResult:
    """One objective's verdict: the measured value, the ceiling, and
    the burn-rate ratio (measured / objective)."""

    name: str
    measured: float
    objective: float
    burn: float
    ok: bool


def _finality_p99(snapshot: dict):
    hists = (snapshot or {}).get("histograms", {})
    rows = hists.get("tenant.commit.latency")
    if not rows:
        return None
    if "p99" in rows:  # unlabeled histogram: one stats row
        return float(rows["p99"])
    worst = None
    for stats in rows.values():
        p99 = float(stats.get("p99", 0.0))
        if worst is None or p99 > worst:
            worst = p99
    return worst


def _shed_rate(events):
    sheds = served = 0
    for ev in events:
        kind = ev[4]
        if kind in _SHED_KINDS:
            sheds += 1
        elif kind in _SERVE_KINDS:
            served += 1
    if sheds + served == 0:
        return None
    return sheds / (sheds + served)


def _rollback_rate(events):
    rollbacks = speculations = 0
    for ev in events:
        kind = ev[4]
        if kind == "exec.spec.rollback":
            rollbacks += 1
        elif kind == "exec.spec.speculate":
            speculations += 1
    if speculations == 0:
        return None
    return rollbacks / speculations


def evaluate_slos(snapshot=None, events=None, objectives=None,
                  obs=None) -> list:
    """Evaluate every objective whose inputs are present.

    ``snapshot`` is a :meth:`Registry.snapshot` dict (feeds
    finality_p99); ``events`` a journal event sequence (feeds
    shed_rate and rollback_rate); either may be None. Each evaluated
    objective emits ``slo.ok`` / ``slo.breach`` on ``obs`` with detail
    ``"<name>:<measured>"`` and lands in the returned list.
    """
    objectives = {**DEFAULT_OBJECTIVES, **(objectives or {})}
    obs = obs if obs is not None else NULL_BOUND
    measured = {}
    if snapshot is not None:
        measured["finality_p99"] = _finality_p99(snapshot)
    if events is not None:
        measured["shed_rate"] = _shed_rate(events)
        measured["rollback_rate"] = _rollback_rate(events)
    results = []
    for name in sorted(objectives):
        value = measured.get(name)
        if value is None:
            continue
        ceiling = float(objectives[name])
        burn = value / ceiling if ceiling > 0 else float("inf")
        ok = burn <= 1.0
        if obs is not NULL_BOUND:
            obs.emit(
                "slo.ok" if ok else "slo.breach", -1, -1,
                f"{name}:{value:.6f}",
            )
        results.append(SloResult(name, value, ceiling, burn, ok))
    return results
