"""Byzantine-resilient aggregation overlay.

A dissemination layer between :mod:`hyperdrive_tpu_torch.replica` and the
harness: votes travel a seeded binomial aggregation tree as partial-
aggregate frames instead of all-to-all fan-out, with contribution
scoring for Byzantine robustness. See ``ROBUSTNESS.md`` ("Aggregation
doctrine") for the operational invariants and ``runtime.py`` for the
determinism contract.

Public surface:

- :class:`OverlayConfig` — ``Simulation(overlay=OverlayConfig(...))``.
- :class:`OverlayFaults` — Byzantine-contributor chaos knobs, composed
  by ``FaultPlan.overlay``.
- :class:`Topology` — the pure (seed, anchor, validator set) → tree
  function; property-tested for cross-process identity.
- :class:`ContributionScores` — the integer scoring/demotion table.
- :class:`OverlayRuntime` / :class:`OverlayFrame` / :class:`OverlayTick`
  — harness-facing internals (the sim's delivery loop intercepts frame
  and tick objects by type).

Port copy of ``hyperdrive_tpu/overlay/``: the topology and the scores are
the reference's unchanged; the runtime drops the analysis hooks, the
recorder and the registry (see :mod:`.runtime`). ``OverlayFaults`` is
used by ``Simulation(overlay=OverlayConfig(faults=...))``, and
:meth:`~hyperdrive_tpu_torch.chaos.FaultPlan.overlay` composes it with a
tree-slicing partition and a crash.
"""

from hyperdrive_tpu_torch.overlay.runtime import (
    OverlayConfig,
    OverlayFaults,
    OverlayFrame,
    OverlayRuntime,
    OverlayTick,
)
from hyperdrive_tpu_torch.overlay.score import CHARGE_WEIGHTS, ContributionScores
from hyperdrive_tpu_torch.overlay.topology import Topology

__all__ = [
    "OverlayConfig",
    "OverlayFaults",
    "OverlayFrame",
    "OverlayRuntime",
    "OverlayTick",
    "Topology",
    "ContributionScores",
    "CHARGE_WEIGHTS",
]
