"""Frame classification, the one module of the JAX package's ``load/``
that the port carries so far.

:mod:`~hyperdrive_tpu_torch.load.frames` is the shared vocabulary (fresh,
duplicate, stale height, stale generation, query) that the overlay's
scorer and the transport's stale-generation filter judge arriving frames
by. The rest of ``load/`` (the arrival schedules, the backpressure
controller and admission gate, the load generators and the soak) comes
to the port with chaos, whose monitor imports it; it needs the queue's
controller seam, which the port's queue does not have yet.
"""

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

__all__ = [
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
