"""Open-loop load generation and the backpressure spine.

Port of the JAX package's ``load/`` package:

- :mod:`~hyperdrive_tpu_torch.load.schedule`: deterministic seeded
  arrival processes (Poisson and bursty), the open-loop clock both the sim
  injector and the real-socket generator draw from.
- :mod:`~hyperdrive_tpu_torch.load.backpressure`: a
  :class:`BackpressureController` watching the device-work queue's depth
  and drain latency and the peers' send-queue occupancy, exposing one
  admission level (ACCEPT, SHED_DUPLICATES, SHED_LOW_PRIORITY,
  CRITICAL_ONLY), and the :class:`AdmissionGate` that classifies and sheds
  messages under it. Proposals, precommits and certificates are never
  shed; duplicates and stale-height votes go first, exactly the classes
  the Process ignores anyway, so behaviour-neutral shedding commits the
  same chain as an unloaded run.
- :mod:`~hyperdrive_tpu_torch.load.generator`: :class:`LoadProfile` (the
  sim-side open-loop injector, interpreted by ``Simulation(load=...)``)
  and :class:`TcpLoadGenerator` (a wall-clock firehose of pre-encoded
  frames at a real :class:`~hyperdrive_tpu_torch.transport.TcpNode`).
- :mod:`~hyperdrive_tpu_torch.load.frames`: the shared frame vocabulary
  (fresh, duplicate, stale height, stale generation, query) that the
  gate, the overlay's scorer and the transport's stale-generation filter
  judge arriving frames by.

The soak CLI (``python -m hyperdrive_tpu.load``) is not ported yet: it
needs the flight recorder's report, and comes with the other entry points.
"""

from hyperdrive_tpu_torch.load.backpressure import (
    ACCEPT,
    CRITICAL_ONLY,
    LEVEL_NAMES,
    SHED_DUPLICATES,
    SHED_LOW_PRIORITY,
    AdmissionGate,
    BackpressureController,
)
from hyperdrive_tpu_torch.load.frames import (
    DUPLICATE,
    FRAME_CLASSES,
    FRESH,
    QUERY,
    STALE_GENERATION,
    STALE_HEIGHT,
    MetricsFrame,
    QueryFrame,
    classify_frame,
)
from hyperdrive_tpu_torch.load.generator import LoadProfile, TcpLoadGenerator
from hyperdrive_tpu_torch.load.schedule import BurstSchedule, PoissonSchedule

__all__ = [
    "ACCEPT",
    "SHED_DUPLICATES",
    "SHED_LOW_PRIORITY",
    "CRITICAL_ONLY",
    "LEVEL_NAMES",
    "AdmissionGate",
    "BackpressureController",
    "BurstSchedule",
    "PoissonSchedule",
    "LoadProfile",
    "TcpLoadGenerator",
    "FRESH",
    "DUPLICATE",
    "STALE_HEIGHT",
    "STALE_GENERATION",
    "QUERY",
    "FRAME_CLASSES",
    "QueryFrame",
    "MetricsFrame",
    "classify_frame",
]
