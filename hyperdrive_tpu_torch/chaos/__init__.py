"""Chaos engineering for the consensus stack.

Port of the JAX package's ``chaos/`` package. Seeded, replayable
adversarial conditions:

- :mod:`~hyperdrive_tpu_torch.chaos.plan`: the FaultPlan DSL (link faults,
  scheduled partitions, crash-restarts) interpreted by the deterministic
  harness (``Simulation(chaos=...)``).
- :mod:`~hyperdrive_tpu_torch.chaos.monitor`: the InvariantMonitor
  asserting no fork across restarts, commit-digest equality, and bounded
  rounds to commit after every heal.
- :mod:`~hyperdrive_tpu_torch.chaos.proxy`: a fault-injecting TCP proxy
  for real-socket partition and heal tests against TcpNode.

The soak CLI is ``python -m hyperdrive_tpu_torch.chaos`` (``soak`` with
every leg of the reference, ``replay``; :mod:`.__main__`).
"""

from hyperdrive_tpu_torch.chaos.monitor import InvariantMonitor, InvariantViolation
from hyperdrive_tpu_torch.chaos.plan import (
    CrashRestart,
    FaultPlan,
    LinkFault,
    Partition,
)
from hyperdrive_tpu_torch.chaos.proxy import ChaosProxy

__all__ = [
    "LinkFault",
    "Partition",
    "CrashRestart",
    "FaultPlan",
    "InvariantMonitor",
    "InvariantViolation",
    "ChaosProxy",
]
