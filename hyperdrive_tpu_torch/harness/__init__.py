"""Deterministic in-process network simulation: lock-step or burst
delivery, with or without device tallies, recorded for replay."""

from hyperdrive_tpu_torch.harness.sim import (
    ScenarioRecord,
    Simulation,
    SimulationResult,
    VirtualClock,
)

__all__ = ["ScenarioRecord", "Simulation", "SimulationResult", "VirtualClock"]
