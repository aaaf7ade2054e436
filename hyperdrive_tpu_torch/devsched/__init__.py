"""Async device-work scheduling: one queue, futures, coalesced launches.

Port copy of ``hyperdrive_tpu/devsched/`` (host code, no device import).
:class:`DeviceWorkQueue` replaces per-call blocking device access with
submitted commands returning :class:`DeviceFuture` handles. Pending
commands against the same launcher coalesce into ONE device launch at the
next drain, so the sync floor is paid once per pipeline slot instead of
once per call. On top of it the sim harness pipelines consensus
(``Simulation(pipeline_heights=True)``): a replica enters height h+1's
propose/prevote while height h's verification is still in flight, with
commit finalization gated on the future's resolution.

:class:`~hyperdrive_tpu_torch.devsched.flusher.QueueFlusher` puts the
queue behind a replica's own flush seam (lock-step runs:
``Simulation(devsched=q, flusher_for=...)``).
``python -m hyperdrive_tpu_torch.devsched parity`` is the parity smoke.
"""

from hyperdrive_tpu_torch.devsched.flusher import QueueFlusher
from hyperdrive_tpu_torch.devsched.policy import DeficitRoundRobin, FifoDrainPolicy
from hyperdrive_tpu_torch.devsched.queue import (
    DeviceFuture,
    DeviceWorkQueue,
    NullVerifyLauncher,
    SpeculationMismatch,
    VerifyLauncher,
)

__all__ = [
    "DeficitRoundRobin",
    "DeviceFuture",
    "DeviceWorkQueue",
    "FifoDrainPolicy",
    "NullVerifyLauncher",
    "QueueFlusher",
    "SpeculationMismatch",
    "VerifyLauncher",
]
