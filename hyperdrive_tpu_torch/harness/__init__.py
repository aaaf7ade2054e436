"""Deterministic in-process network simulation (burst mode, with or
without device tallies)."""

from hyperdrive_tpu_torch.harness.sim import (
    Simulation,
    SimulationResult,
    VirtualClock,
)

__all__ = ["Simulation", "SimulationResult", "VirtualClock"]
