"""Consensus flight recorder: a bounded, deterministic event journal.

The Tracer (utils/trace.py) answers "how many / how long"; this module
answers "in what order, and why". A :class:`Recorder` captures typed
events — step transitions, timeout schedules and fires, commits,
equivocations, flush launches/settles, device fetches — into a fixed
ring buffer, each stamped with (ts, replica, height, round, kind,
detail). The timestamp comes from an injectable ``time_fn`` so a sim
wired to the VirtualClock produces a replay-identical journal: two
fixed-seed runs digest to the same bytes (tests/analysis/
test_digest_stability.py).

Disabled recording follows the NULL_TRACER discipline: hot paths hold a
:data:`NULL_BOUND` handle and guard with an identity check, so the off
state costs one attribute load and one ``is not``. The ``Replica``
constructor seam is named ``obs`` throughout — ``recorder`` was already
taken by the transport-replay FlightRecorder (transport.py), which logs
consumption, not causality.

Event kinds are a closed, documented taxonomy (OBSERVABILITY.md); the
``detail`` slot carries at most one deterministic scalar (an int or a
short string), never wall-clock-, id()- or hash-order-derived values.

Port copy of ``hyperdrive_tpu/obs/recorder.py``, whole: the journal
format (``JOURNAL_VERSION = 1``) is the reference's byte for byte, so
each package loads the other's journal.
"""

from __future__ import annotations

import hashlib
import json
import threading

__all__ = [
    "Event",
    "Recorder",
    "BoundRecorder",
    "NullRecorder",
    "NullBound",
    "NULL_RECORDER",
    "NULL_BOUND",
    "load_journal",
]

# The closed event taxonomy. Kept here (not just in docs) so tooling —
# the report, the exporter, HD005 fixtures — can validate against it.
EVENT_KINDS = frozenset(
    {
        "round.start",
        "round.skip",
        "step.prevoting",
        "step.precommitting",
        "timeout.propose.scheduled",
        "timeout.propose.fired",
        "timeout.prevote.scheduled",
        "timeout.prevote.fired",
        "timeout.precommit.scheduled",
        "timeout.precommit.fired",
        "commit",
        "equivocation",
        "height.resync",
        "ingest.window",
        "mq.drop",
        "settle.pass",
        "settle.speculative",
        "verify.launch",
        "verify.rlc.verdict",
        "verify.rlc.fallbacks",
        "verify.msm.windows",
        "verify.msm.occupancy",
        "verify.msm.depth",
        "cert.emit",
        "cert.verify",
        "tally.launch",
        "sched.submit",
        "sched.coalesce",
        "sched.drain",
        "sched.gated",
        # Device-pipeline telemetry (obs/devtel.py): one launch-probe
        # family per coalesced DeviceWorkQueue drain. submit/cmd carry
        # the per-command sequence number the Perfetto exporter keys
        # its submit->drain flow arrows on; commit closes the loop on
        # the gated replica's track with the covering launch_id.
        "sched.launch.submit",
        "sched.launch.begin",
        "sched.launch.cmd",
        "sched.launch.rows",
        "sched.launch.lanes",
        "sched.launch.occupancy",
        "sched.launch.queue_wait",
        "sched.launch.split",
        "sched.launch.end",
        "sched.launch.commit",
        # Lanes-requested vs bucket-padded economics per verify chunk
        # (ops/ed25519.py).
        "verify.occupancy.rows",
        "verify.occupancy.lanes",
        "verify.occupancy.pct",
        # Metrics registry (obs/metrics.py) lifecycle marks.
        "metrics.snapshot",
        "flush.launch",
        "flush.settle",
        "fetch.sync",
        "wire.frame.malformed",
        "wire.frame.oversize",
        "wire.frame.shed",
        "wire.frame.stale",
        # HDS005 decode-budget breach (analysis/sanitizer.py WireBudget):
        # detail = "<tag>:<bytes needed>".
        "wire.budget.exceeded",
        "transport.peer.dropped",
        "transport.reconnect",
        # Overload harness (load/): offered-load marks from the open-loop
        # injector and the backpressure spine's admission decisions.
        "load.offered",
        "load.burst",
        "admission.level",
        "admission.shed",
        "chaos.partition",
        "chaos.heal",
        "chaos.crash",
        "chaos.restore",
        "epoch.begin",
        "epoch.elect",
        "epoch.switch",
        "epoch.proof",
        "epoch.stale_vote",
        # Aggregation overlay (overlay/runtime.py): frame accounting,
        # contribution-score verdicts, level-window escalation, and the
        # never-starve fallback. Closed family — the --overlay report
        # decoder and OBSERVABILITY.md enumerate exactly these.
        "overlay.frame",
        "overlay.invalid",
        "overlay.stale",
        "overlay.duplicate",
        "overlay.withhold",
        "overlay.level.timeout",
        "overlay.fallback",
        "overlay.demote",
        "overlay.recover",
        "overlay.rekey",
        # BLS aggregate path (certificates.py, overlay/runtime.py):
        # one mark per minted aggregate-signature certificate (detail
        # carries partial count + host|device aggregation route) and
        # one per merge-level partial-aggregate reject (the contributor
        # charged before any batch verify). Closed family — the lint
        # (HD005) and OBSERVABILITY.md enumerate exactly these.
        "bls.cert.agg",
        "bls.partial.reject",
        # Multi-tenant serving (devsched/policy.py, parallel/service.py):
        # drain-policy deferrals/starvation-bound firings on the queue
        # track, and the cross-process submit path's lifecycle — remote
        # windows admitted, certificate frames resolved, overload sheds,
        # retired tenant certificate prunes. Closed families — the lint
        # (HD005) and OBSERVABILITY.md enumerate exactly these.
        "tenant.drain.deferred",
        "tenant.drain.forced",
        "service.remote.submit",
        "service.remote.resolve",
        "service.remote.shed",
        "service.tenant.retire",
        # Execution layer (exec/ledger.py, harness/sim.py): one mark
        # per applied block (detail: tx count, admitted count, host vs
        # device kernel route), one per chained state root, and one per
        # boundary stake snapshot read by an epoch election. Closed
        # family — the lint (HD005), the --exec report decoder, and
        # OBSERVABILITY.md enumerate exactly these.
        "exec.apply",
        "exec.root",
        "exec.stake",
        # Speculative execution pipeline (exec/ledger.py speculate/
        # resolve): one mark per speculative apply (detail: signed
        # guess or exact), one per confirmed height, one per rollback
        # (detail: heights unwound). Closed family — the lint (HD005),
        # the --exec report's speculation-outcome table, and
        # OBSERVABILITY.md enumerate exactly these.
        "exec.spec.speculate",
        "exec.spec.confirm",
        "exec.spec.rollback",
        # Merkleized state (ops/merkle.py via both executors): one mark
        # per applied block's account-tree root and one per incremental
        # update (detail: scatter-target count, tree depth, whether the
        # kernel fell back to a full rebuild). Closed family — the lint
        # (HD005), the --proofs report decoder, and OBSERVABILITY.md
        # enumerate exactly these.
        "merkle.root",
        "merkle.update",
        # Proof serving (parallel/service.py TAG_QUERY path): one mark
        # per proof frame served (detail: account, frame bytes) and one
        # per query shed by the admission gate (detail: tenant). Closed
        # family — same three consumers as merkle.*.
        "proof.serve",
        "proof.shed",
        # Live metrics plane (parallel/service.py TAG_METRICS path):
        # one mark per Prometheus snapshot served on remote_port()
        # (detail: rendered bytes) and one per scrape the admission
        # gate shed ahead of consensus traffic (detail: tenant).
        # Closed family (the `metrics.` prefix already is) — the lint
        # (HD005) and OBSERVABILITY.md enumerate exactly these.
        "metrics.serve",
        "metrics.shed",
        # Cross-process causal tracing (obs/tracectx.py): one mark per
        # stamped frame sent (detail: "origin:seq"), one per stamped
        # frame received (detail: "origin:seq" of the SENDER's stamp —
        # the merge CLI pairs send/recv on it), and one per estimated
        # wall-clock offset from a HELLO echo exchange (detail:
        # "peer_origin:offset_seconds"). Closed family — the lint
        # (HD005), obs merge, and OBSERVABILITY.md enumerate exactly
        # these.
        "trace.send",
        "trace.recv",
        "trace.offset",
        # SLO burn-rate checks (obs/slo.py): one verdict mark per
        # objective evaluated against a registry snapshot or merged
        # journal (detail: "<slo name>:<measured value>"). Closed
        # family — the lint (HD005) and OBSERVABILITY.md enumerate
        # exactly these.
        "slo.ok",
        "slo.breach",
        # Admission-gate reputation loop (load/backpressure.py
        # SignerReputation): one mark per verify-failure charge (detail:
        # charge class), one per signer demotion and one per recovery
        # (detail: peer label). Closed family — the lint (HD005), the
        # --campaign report decoder, and OBSERVABILITY.md enumerate
        # exactly these.
        "admission.reputation.charge",
        "admission.reputation.demote",
        "admission.reputation.recover",
        # Attack-campaign workloads (campaign/): one mark per family
        # launch (detail: family name), per storm wave reaching batch
        # verify (detail: admitted rows), per capture epoch (detail:
        # adversary seats), per grinding pick (detail: candidate
        # index), per overlay slice engaged/healed in a coincidence run
        # (detail: level), per invariant violation (detail: kind), and
        # one closing mark carrying the campaign digest prefix. Closed
        # family — the lint (HD005), the --campaign report decoder, and
        # OBSERVABILITY.md enumerate exactly these.
        "campaign.family",
        "campaign.wave",
        "campaign.epoch",
        "campaign.grind",
        "campaign.partition",
        "campaign.heal",
        "campaign.violation",
        "campaign.done",
    }
)

JOURNAL_VERSION = 1


class Event(tuple):
    """A recorded event: ``(ts, replica, height, round, kind, detail)``.

    A bare tuple subclass (not a dataclass) so ring inserts stay a
    single allocation; the named properties are for report/export code,
    which is off the hot path.

    Merged journals (obs/merge.py) append a seventh slot — the origin
    process id — so one stream can hold events from N processes; a
    plain per-process event reads as pid 0.
    """

    __slots__ = ()

    ts = property(lambda self: self[0])
    replica = property(lambda self: self[1])
    height = property(lambda self: self[2])
    round = property(lambda self: self[3])
    kind = property(lambda self: self[4])
    detail = property(lambda self: self[5])
    pid = property(lambda self: self[6] if len(self) > 6 else 0)


class Recorder:
    """Fixed-capacity ring journal of consensus events.

    Parameters
    ----------
    capacity:
        Maximum retained events; older events are overwritten (the
        ``dropped`` counter in the journal says how many).
    time_fn:
        Zero-arg timestamp source. Inject the sim's VirtualClock
        (``lambda: clock.now``) for deterministic journals; defaults to
        a monotonically increasing sequence number when omitted so the
        recorder is still usable standalone.
    threadsafe:
        Guard inserts with a lock. The sim is single-threaded and
        passes False; TcpNode wiring needs True.
    """

    __slots__ = (
        "capacity", "_ring", "total", "_time_fn", "_lock", "_seq",
        "_dropped",
    )

    def __init__(self, capacity=65536, time_fn=None, threadsafe=False):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._ring = []
        self.total = 0
        self._time_fn = time_fn
        self._lock = threading.Lock() if threadsafe else None
        self._seq = 0
        self._dropped = 0

    # ------------------------------------------------------------ insert

    def emit(self, kind, replica, height, round_, detail=None):
        # The whole emit — timestamp draw (the fallback _tick mutates
        # _seq), ring write, and overwrite accounting — runs under the
        # lock in threadsafe mode: a torn total/_dropped pair would let
        # `dropped` disagree with what snapshot() actually returns.
        lock = self._lock
        if lock is None:
            self._insert(kind, replica, height, round_, detail)
        else:
            with lock:
                self._insert(kind, replica, height, round_, detail)

    def _insert(self, kind, replica, height, round_, detail):
        ts = self._time_fn() if self._time_fn is not None else self._tick()
        ev = Event((ts, replica, height, round_, kind, detail))
        ring = self._ring
        if len(ring) < self.capacity:
            ring.append(ev)
        else:
            ring[self.total % self.capacity] = ev
            self._dropped += 1
        self.total += 1

    def _tick(self):
        self._seq += 1
        return float(self._seq)

    # ------------------------------------------------------------- views

    def scoped(self, replica):
        """A per-replica handle that pre-binds the replica key."""
        return BoundRecorder(self, replica)

    def __len__(self):
        return len(self._ring)

    @property
    def dropped(self):
        """Events the ring overwrote — an explicit counter maintained
        under the same lock as the ring write, so a concurrent reader
        never sees it disagree with the snapshot (the old derived
        ``total - capacity`` could tear against a mid-flight insert)."""
        lock = self._lock
        if lock is None:
            return self._dropped
        with lock:
            return self._dropped

    def snapshot(self):
        """Events oldest-to-newest, as a new list of :class:`Event`."""
        lock = self._lock
        if lock is None:
            return self._snapshot()
        with lock:
            return self._snapshot()

    def _snapshot(self):
        ring = self._ring
        if self.total <= self.capacity:
            return list(ring)
        head = self.total % self.capacity
        return ring[head:] + ring[:head]

    def journal(self, meta=None):
        """A JSON-ready dict of the whole journal.

        ``meta`` (optional dict) rides along verbatim — the serve CLI
        stamps each per-process journal with its trace origin id so
        ``obs merge`` can key offset estimates without guessing from
        filenames. :func:`load_journal` returns it untouched.
        """
        data = {
            "version": JOURNAL_VERSION,
            "capacity": self.capacity,
            "total": self.total,
            "dropped": self.dropped,
            "events": [list(ev) for ev in self.snapshot()],
        }
        if meta:
            data["meta"] = dict(meta)
        return data

    def digest(self):
        """sha256 over the canonical JSON encoding of the events.

        Two fixed-seed sim runs must agree here — any nondeterminism in
        the hook sites (hash-order iteration, wall-clock stamps) shows
        up as a digest mismatch.
        """
        blob = json.dumps(
            [list(ev) for ev in self.snapshot()],
            separators=(",", ":"),
            sort_keys=False,
        ).encode()
        return hashlib.sha256(blob).hexdigest()

    def save(self, path, meta=None):
        with open(path, "w") as fh:
            json.dump(self.journal(meta=meta), fh, separators=(",", ":"))
            fh.write("\n")


class BoundRecorder:
    """A recorder handle with the replica key baked in.

    This is what hot paths hold: ``obs.emit(kind, height, round)`` is
    one bound-method call, and the disabled case is the shared
    :data:`NULL_BOUND` singleton so ``obs is not NULL_BOUND`` gates any
    extra work (building a detail value, say) off entirely.
    """

    __slots__ = ("_rec", "replica")

    def __init__(self, rec, replica):
        self._rec = rec
        self.replica = replica

    def emit(self, kind, height, round_, detail=None):
        self._rec.emit(kind, self.replica, height, round_, detail)


class NullRecorder(Recorder):
    """Recording disabled: every emit is a no-op, scoped() is shared."""

    __slots__ = ()

    def __init__(self):
        super().__init__(capacity=1)

    def emit(self, kind, replica, height, round_, detail=None):
        pass

    def scoped(self, replica):
        return NULL_BOUND


class NullBound(BoundRecorder):
    __slots__ = ()

    def __init__(self):
        super().__init__(None, -1)

    def emit(self, kind, height, round_, detail=None):
        pass


NULL_RECORDER = NullRecorder()
NULL_BOUND = NullBound()


def load_journal(path):
    """Read a journal written by :meth:`Recorder.save`.

    Returns the journal dict with ``events`` rehydrated to
    :class:`Event` instances (tuples with named accessors).
    """
    with open(path) as fh:
        data = json.load(fh)
    if data.get("version") != JOURNAL_VERSION:
        raise ValueError(
            f"unsupported journal version {data.get('version')!r}"
        )
    data["events"] = [Event(tuple(ev)) for ev in data["events"]]
    return data
