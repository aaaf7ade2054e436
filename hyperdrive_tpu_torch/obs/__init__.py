"""Consensus observability: flight recorder, anatomy report, traces,
device-launch telemetry, metrics registry and SLO checks.

The hot-path contract is the same as utils/trace.py's NULL_TRACER:
components hold a recorder handle that defaults to the shared no-op
singleton and guard any non-trivial event construction with an identity
check (device telemetry follows suit with NULL_DEVTEL).

Port of the JAX package's ``obs/`` package: the recorder, the registry,
the launch telemetry, the Perfetto exporter, the report and the SLO
checks. The cross-node half (``tracectx``: trace stamps on frames;
``merge``: merged multi-process journals) and ``benchdiff`` wait for
ROADMAP Queue A item 4b: their names raise ``NotImplementedError`` that
says so. The ``python -m`` CLI waits for Queue A item 6.
"""

from hyperdrive_tpu_torch.obs.devtel import (
    NULL_DEVTEL,
    DeviceTelemetry,
    LaunchRecord,
    NullDeviceTelemetry,
)
from hyperdrive_tpu_torch.obs.metrics import (
    Gauge,
    Registry,
    histogram_stats,
    merge_histograms,
    to_prometheus,
)
from hyperdrive_tpu_torch.obs.perfetto import DEVICE_TID, export, to_trace_events
from hyperdrive_tpu_torch.obs.recorder import (
    EVENT_KINDS,
    NULL_BOUND,
    NULL_RECORDER,
    BoundRecorder,
    Event,
    NullBound,
    NullRecorder,
    Recorder,
    load_journal,
)
from hyperdrive_tpu_torch.obs.report import (
    anatomy,
    critical_path_summary,
    phase_summary,
    render_critical_path_table,
    render_table,
    render_tenant_table,
    tenant_summary,
)
from hyperdrive_tpu_torch.obs.slo import (
    DEFAULT_OBJECTIVES,
    SloResult,
    evaluate_slos,
)

#: The reference's cross-node and bench-diff exports, not ported yet.
_LATER = (
    "STAMP_LEN",
    "TRACE_MAGIC",
    "TraceSource",
    "decode_stamp",
    "encode_stamp",
    "note_recv",
    "span_id",
    "split_frame",
    "estimate_offsets",
    "merge_journals",
    "merged_digest",
    "save_merged",
    "benchdiff_compare",
)

__all__ = [
    "EVENT_KINDS",
    "NULL_BOUND",
    "NULL_RECORDER",
    "BoundRecorder",
    "Event",
    "NullBound",
    "NullRecorder",
    "Recorder",
    "load_journal",
    "anatomy",
    "critical_path_summary",
    "phase_summary",
    "render_critical_path_table",
    "render_table",
    "render_tenant_table",
    "tenant_summary",
    "DEVICE_TID",
    "export",
    "to_trace_events",
    "DEFAULT_OBJECTIVES",
    "SloResult",
    "evaluate_slos",
    "NULL_DEVTEL",
    "DeviceTelemetry",
    "LaunchRecord",
    "NullDeviceTelemetry",
    "Gauge",
    "Registry",
    "histogram_stats",
    "merge_histograms",
    "to_prometheus",
]


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"obs.{name} is not ported to the PyTorch package yet: the "
            "cross-node trace stamps, journal merging and benchdiff wait "
            "for ROADMAP Queue A item 4b"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
