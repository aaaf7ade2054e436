"""Device-pipeline telemetry: launch probes for the async work queue.

Every :class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue` drain becomes a
:class:`LaunchRecord` with a monotonically-assigned ``launch_id``:
submit→drain queue wait per command, lanes requested vs padded (the
bucket-padding bill), occupancy %, coalescing factor, generation-split
count, and the wall clock split into pack / dispatch / sync / unpack —
the sync share tapped straight from :func:`~hyperdrive_tpu_torch.analysis.
annotations.device_fetch`, the one blessed materialization point.

Two sinks, one probe:

- the flight-recorder journal gets the deterministic integers
  (``sched.launch.*`` events on the devsched track, with per-command
  ``sched.launch.submit``/``sched.launch.cmd`` events carrying the
  submitter's track so the Perfetto exporter can draw flow arrows
  submit → drain → gated commit);
- the metrics :class:`~hyperdrive_tpu_torch.obs.metrics.Registry` gets the
  histograms (queue wait, occupancy, wall splits) and counters.

``time_fn`` is injectable exactly like the recorder's: the sim passes
its VirtualClock so queue waits are virtual seconds and the journal +
registry snapshot stay digest-identical across fixed-seed runs;
standalone deployments default to ``time.perf_counter`` and get real
wall splits.

Off state is the NULL_TRACER discipline: the queue holds
:data:`NULL_DEVTEL` and guards with ``devtel is not NULL_DEVTEL`` — one
pointer compare per submit/drain, nothing else.

Port copy of ``hyperdrive_tpu/obs/devtel.py``, whole. The fetch probe
is the port's :func:`~hyperdrive_tpu_torch.analysis.annotations.
device_fetch` tap; ``launch_lanes`` reads the port verifiers' bucket
ladder (``TorchBatchVerifier.host.buckets``).
"""

from __future__ import annotations

import time

from hyperdrive_tpu_torch.analysis.annotations import set_fetch_probe
from hyperdrive_tpu_torch.obs.metrics import Registry
from hyperdrive_tpu_torch.ops.bucketing import bucket_for

__all__ = [
    "CmdMeta",
    "LaunchRecord",
    "DeviceTelemetry",
    "NullDeviceTelemetry",
    "NULL_DEVTEL",
    "EXEC_ORIGIN",
]

#: The submitting-track id the sim stamps on execution-layer commands
#: (tx-signature rows riding the fused drain). A launch whose metas
#: include this origin is a FUSED drain — votes and exec rows in one
#: coalesced device program — and its stage spans are double-booked
#: under ``devtel.fused.*`` so the fused pipeline's pack/dispatch/
#: sync/unpack economics are separable from pure vote drains.
EXEC_ORIGIN = -3


class CmdMeta:
    """Per-command probe state: submission sequence number (the flow-
    arrow key), submit timestamp, submitting track (replica / tenant /
    sim), and requested rows."""

    __slots__ = ("seq", "ts", "origin", "rows")

    def __init__(self, seq, ts, origin, rows):
        self.seq = seq
        self.ts = ts
        self.origin = origin
        self.rows = rows


class LaunchRecord:
    """One coalesced device launch, fully attributed.

    Deterministic fields (journal-bound): ``launch_id``, ``kind``,
    ``generation``, ``commands``, ``rows``, ``lanes``,
    ``occupancy_pct``, ``queue_wait_max`` / ``queue_wait_sum`` (in the
    probe clock's seconds — virtual under the sim), ``origins``,
    ``syncs``. Clock-derived fields (registry-bound): ``t_pack`` /
    ``t_dispatch`` / ``t_sync`` / ``t_unpack`` / ``wall``.
    """

    __slots__ = (
        "launch_id", "kind", "generation", "commands", "rows", "lanes",
        "occupancy_pct", "queue_wait_max", "queue_wait_sum", "origins",
        "syncs", "exec_rows", "t_pack", "t_dispatch", "t_sync",
        "t_unpack", "wall", "_t_begin", "_t_last",
    )

    def __init__(self, launch_id, kind, generation, metas, now):
        self.launch_id = launch_id
        self.kind = kind
        self.generation = generation
        self.commands = len(metas)
        self.rows = sum(m.rows for m in metas)
        self.lanes = self.rows
        self.occupancy_pct = 100
        waits = [now - m.ts for m in metas]
        self.queue_wait_max = max(waits, default=0.0)
        self.queue_wait_sum = sum(waits)
        self.origins = tuple(m.origin for m in metas)
        self.syncs = 0
        #: Rows submitted by the execution layer (origin EXEC_ORIGIN):
        #: nonzero marks this launch as a fused drain.
        self.exec_rows = sum(
            m.rows for m in metas if m.origin == EXEC_ORIGIN
        )
        self.t_pack = 0.0
        self.t_dispatch = 0.0
        self.t_sync = 0.0
        self.t_unpack = 0.0
        self.wall = 0.0
        self._t_begin = now
        self._t_last = now

    def _mark(self, attr, now) -> None:
        setattr(self, attr, getattr(self, attr) + (now - self._t_last))
        self._t_last = now

    def as_dict(self) -> dict:
        return {
            "launch_id": self.launch_id,
            "kind": self.kind,
            "generation": self.generation,
            "commands": self.commands,
            "rows": self.rows,
            "lanes": self.lanes,
            "occupancy_pct": self.occupancy_pct,
            "queue_wait_max": self.queue_wait_max,
            "queue_wait_sum": self.queue_wait_sum,
            "origins": list(self.origins),
            "syncs": self.syncs,
            "exec_rows": self.exec_rows,
            "t_pack": self.t_pack,
            "t_dispatch": self.t_dispatch,
            "t_sync": self.t_sync,
            "t_unpack": self.t_unpack,
            "wall": self.wall,
        }


class DeviceTelemetry:
    """The live probe: owns launch-id assignment, the registry, and the
    journal emissions. One instance per queue (the sim builds one and
    hands it to its queue; a service can share one across queues only if
    those queues never interleave drains).

    ``recorder``: a :class:`~hyperdrive_tpu_torch.obs.recorder.Recorder` (not
    a bound handle — per-command events carry the submitting track, so
    the probe scopes per emission). None disables journal output while
    keeping the registry live.
    """

    def __init__(self, recorder=None, registry=None, time_fn=None,
                 keep: int = 256):
        self._rec = recorder
        self.registry = (
            registry if registry is not None else Registry(time_fn=time_fn)
        )
        self._time = time_fn or time.perf_counter
        self._next_id = 0
        self._next_seq = 0
        self._open: LaunchRecord | None = None
        #: Ring of the most recent ``keep`` completed LaunchRecords.
        self.records: list = []
        self._keep = keep

    def now(self) -> float:
        return self._time()

    # ----------------------------------------------------------- submit

    def command(self, origin, rows) -> CmdMeta:
        """Stamp one submitted command; emits ``sched.launch.submit``
        on the submitter's track with the sequence number the exporter
        keys the submit→drain flow arrow on."""
        seq = self._next_seq
        self._next_seq += 1
        meta = CmdMeta(seq, self._time(), origin, int(rows))
        if self._rec is not None:
            track = -2 if origin is None else origin
            self._rec.emit("sched.launch.submit", track, -1, -1, seq)
        self.registry.count("devtel.submitted")
        return meta

    # ------------------------------------------------------------ drain

    def splits(self, n: int) -> None:
        """A drain cycle split into ``n`` extra per-generation launches
        (epoch boundaries inside one coalescing window)."""
        if self._rec is not None:
            self._rec.emit("sched.launch.split", -2, -1, -1, n)
        self.registry.count("devtel.launch.gen_splits", n)

    def launch_begin(self, kind, generation, metas) -> LaunchRecord:
        launch_id = self._next_id
        self._next_id += 1
        rec = LaunchRecord(launch_id, kind, generation, metas, self._time())
        self._open = rec
        set_fetch_probe(self)
        if self._rec is not None:
            emit = self._rec.emit
            emit("sched.launch.begin", -2, -1, -1, launch_id)
            for m in metas:
                emit(
                    "sched.launch.cmd",
                    -2 if m.origin is None else m.origin,
                    -1, -1, m.seq,
                )
        return rec

    def mark_pack(self, rec: LaunchRecord) -> None:
        rec._mark("t_pack", self._time())

    def mark_dispatch(self, rec: LaunchRecord) -> None:
        # The dispatch leg brackets the launcher call; fetch-probe time
        # accrued inside it is the sync share, carved out below.
        rec._mark("t_dispatch", self._time())
        rec.t_dispatch = max(0.0, rec.t_dispatch - rec.t_sync)

    def launch_lanes(self, rec: LaunchRecord, launcher) -> None:
        """Resolve lanes-requested vs lanes-padded for this launch from
        the launcher's bucket ladder (TpuBatchVerifier exposes it at
        ``verifier.host.buckets``); ladderless launchers (host / null
        verifiers) pad nothing."""
        verifier = getattr(launcher, "verifier", None)
        buckets = getattr(verifier, "buckets", None)
        if buckets is None:
            buckets = getattr(
                getattr(verifier, "host", None), "buckets", None
            )
        rec.lanes = bucket_for(rec.rows, buckets) if buckets else rec.rows
        rec.occupancy_pct = int(
            round(100 * rec.rows / max(rec.lanes, 1))
        )

    def launch_end(self, rec: LaunchRecord) -> None:
        set_fetch_probe(None)
        self._open = None
        now = self._time()
        rec._mark("t_unpack", now)
        rec.wall = now - rec._t_begin
        self.records.append(rec)
        if len(self.records) > self._keep:
            del self.records[: -self._keep]
        if self._rec is not None:
            emit = self._rec.emit
            emit("sched.launch.rows", -2, -1, -1, rec.rows)
            emit("sched.launch.lanes", -2, -1, -1, rec.lanes)
            emit("sched.launch.occupancy", -2, -1, -1, rec.occupancy_pct)
            emit(
                "sched.launch.queue_wait", -2, -1, -1,
                int(round(rec.queue_wait_max * 1e6)),
            )
            emit("sched.launch.end", -2, -1, -1, rec.launch_id)
        reg = self.registry
        reg.count("devtel.launches")
        reg.count("devtel.launch.commands", rec.commands)
        reg.count("devtel.launch.rows", rec.rows)
        reg.count("devtel.launch.lanes", rec.lanes)
        reg.count("devtel.launch.syncs", rec.syncs)
        reg.set_gauge("devtel.launch.last_id", rec.launch_id)
        reg.observe("devtel.launch.occupancy", rec.occupancy_pct)
        reg.observe("devtel.launch.coalesce", rec.commands)
        reg.observe("devtel.launch.queue_wait.latency", rec.queue_wait_max)
        reg.observe("devtel.launch.pack.latency", rec.t_pack)
        reg.observe("devtel.launch.dispatch.latency", rec.t_dispatch)
        reg.observe("devtel.launch.sync.latency", rec.t_sync)
        reg.observe("devtel.launch.unpack.latency", rec.t_unpack)
        reg.observe("devtel.launch.wall.latency", rec.wall)
        if rec.exec_rows:
            # Fused-drain stage spans: this launch carried
            # exec-layer signature rows coalesced with vote verifies,
            # so its per-stage latencies are double-booked under the
            # fused series — `obs report` and the exporter can show
            # what the speculative pipeline's shared launches cost at
            # each stage without disentangling mixed histograms.
            reg.count("devtel.fused.launches")
            reg.count("devtel.fused.exec_rows", rec.exec_rows)
            reg.observe("devtel.fused.pack.latency", rec.t_pack)
            reg.observe("devtel.fused.dispatch.latency", rec.t_dispatch)
            reg.observe("devtel.fused.sync.latency", rec.t_sync)
            reg.observe("devtel.fused.unpack.latency", rec.t_unpack)
            reg.observe("devtel.fused.wall.latency", rec.wall)

    # ------------------------------------------- device_fetch probe taps

    def fetch_begin(self, why: str) -> None:
        rec = self._open
        if rec is not None:
            rec.syncs += 1
            self._sync_t0 = self._time()

    def fetch_end(self, why: str) -> None:
        rec = self._open
        if rec is not None:
            rec.t_sync += self._time() - getattr(self, "_sync_t0", self._time())

    # ----------------------------------------------------- per-tenant

    #: Latency legs a service attributes per tenant. ``commit_rejected``
    #: is deliberately a separate histogram: a failed certificate verify
    #: must not pollute the committed-path p95/p99.
    _TENANT_LEGS = {
        "verify": "tenant.verify.latency",
        "commit": "tenant.commit.latency",
        "commit_rejected": "tenant.commit_rejected.latency",
    }

    def tenant_latency(self, tenant, seconds: float, leg: str = "verify"):
        """Per-tenant latency attribution (ShardVerifyService): labeled
        histograms so cross-tenant aggregation stays mergeable."""
        self.registry.observe(
            self._TENANT_LEGS[leg], seconds, label=tenant
        )


class NullDeviceTelemetry(DeviceTelemetry):
    """Probing disabled: every hook is a no-op; the off-state guard is
    ``devtel is not NULL_DEVTEL`` at the queue's call sites, so none of
    these methods run on hot paths anyway."""

    def __init__(self):
        super().__init__(time_fn=lambda: 0.0)

    def command(self, origin, rows):
        return None

    def splits(self, n):
        pass

    def launch_begin(self, kind, generation, metas):
        return None

    def launch_end(self, rec):
        pass


NULL_DEVTEL = NullDeviceTelemetry()
