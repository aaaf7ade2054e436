"""Consensus observability: flight recorder, anatomy report, traces,
device-launch telemetry, metrics registry and SLO checks.

The hot-path contract is the same as utils/trace.py's NULL_TRACER:
components hold a recorder handle that defaults to the shared no-op
singleton and guard any non-trivial event construction with an identity
check (device telemetry follows suit with NULL_DEVTEL).

Port of the JAX package's ``obs/`` package: the recorder, the registry,
the launch telemetry, the Perfetto exporter, the report, the SLO checks,
the cross-node half (``tracectx``: trace stamps on frames; ``merge``:
merged multi-process journals) and ``benchdiff``, with the same exports.
The ``python -m`` CLI waits for ROADMAP Queue A item 6.
"""

from hyperdrive_tpu_torch.obs.benchdiff import compare as benchdiff_compare
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
from hyperdrive_tpu_torch.obs.merge import (
    estimate_offsets,
    merge_journals,
    merged_digest,
    save_merged,
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
from hyperdrive_tpu_torch.obs.tracectx import (
    STAMP_LEN,
    TRACE_MAGIC,
    TraceSource,
    decode_stamp,
    encode_stamp,
    note_recv,
    span_id,
    split_frame,
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
    "benchdiff_compare",
]

