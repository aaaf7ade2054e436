"""The simulator: virtual time, seeded adversaries, signed votes,
record/replay, and settle windows verified in one batched launch.

Port of the JAX package's ``harness/sim.py``. Two delivery modes:

- **Lock-step** (``burst=False``, the default, as in the reference): one
  global queue of ``(to, msg)`` records, a broadcast one record per
  recipient (the sender included), delivered one message at a time
  (:meth:`Simulation._run_delivery`): the serialized interleaving of the
  Go reference's ``replica_test.go``. Every delivery flushes its replica,
  through the replica's own verifier (``verifier_for``; with
  ``sign=True`` and no override every replica gets one of its own on
  ``device``: a ``TorchBatchVerifier`` on the card, the reference's
  ``HostVerifier`` with ``device="cpu"``) or through a queue-backed
  flusher (``flusher_for``, e.g.
  :class:`~hyperdrive_tpu_torch.devsched.QueueFlusher`) submitting to an
  injected :class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue`
  (``devsched=``). The loop drains that queue before it lets virtual time
  jump to a timeout, so no timeout fires over a settle in flight.
- **Burst** (``burst=True``): supersteps settled through aggregated
  verification, as below.

Burst mode runs the signed, dedup-verified network (the "256 replicas,
Ed25519 batch-verify offload" deployment):

- One global queue of ``(to, msg)`` records. In shared-superstep mode
  (the default without a per-delivery adversary) a broadcast is ONE entry
  (``to = -1``: every live replica); otherwise it is one entry per
  recipient. Timeouts are addressed to their owner and run on a
  :class:`VirtualClock`: when the network drains, the clock jumps to the
  next deadline.
- Each superstep takes the whole pending queue (shuffled under
  ``reorder``), applies the kills due by then, and buffers it: in shared
  mode every broadcast goes once onto a shared lane, which becomes
  per-replica windows (:meth:`Simulation._shared_windows`); per delivery,
  each replica buffers its own votes (``handle_burst``, minus the
  deliveries ``drop_rate`` drops) while timeouts run inline. Then the
  network settles: ALL windows are signature-checked in one
  ``batch_verifier`` call per settle pass, each replica runs its rule
  cascade on the survivors, and the pass repeats until the network is
  quiescent.
- With batched ingestion (``batch_ingest``, on in burst mode) every
  window that IS the shared lockstep list is ingested through ONE
  :class:`~hyperdrive_tpu_torch.batch.WindowColumns` extraction shared by
  every replica (``columnar_ingest``, on by default); stragglers take
  the object path. ``batch_ingest=False`` dispatches message by message.
- Without dedup or device tallies, ``pipeline_verify`` (on by default)
  double-buffers a settle pass: its windows are verified in replica
  groups of about one verify bucket, group g+1's launches enqueued before
  group g's mask is read (:meth:`Simulation._settle_pipelined`).

Delivery order, the adversaries' draws from ``self.rng``, the
small-window routing rule and the commit bookkeeping are the
reference's, so the two commit the same chain step for step.

With ``device_tally=True`` the quorum counts come from the device vote
grid (:class:`~hyperdrive_tpu_torch.ops.votegrid.VoteGrid`, one grid
for the network on ``device``): a lockstep settle whose verifier exposes
``fused_inner`` verifies, merges and tallies behind one upload and one
download (:meth:`Simulation._dispatch_fused`); any other settle verifies,
inserts, then scatters and tallies in a second launch
(:meth:`Simulation._dispatch_tallied`). ``fused_min_window`` routes
sub-crossover settles fully to the host and poisons the grid slots they
bypass; ``route_hysteresis`` drops the grid upkeep over a host-shaped
stretch and rebuilds it on re-engagement. Besides the reference's
tracer series (``sim.tally.launch``, ``sim.settle.host_routed``,
``sim.fused.*``) three plain counters count these routes
(``fused_settles``, ``tally_launches``, ``host_routed_settles``).

With ``pipeline_heights=True`` each settle pass dispatches at once on a
speculative verdict (every parseable, signed row accepted) and submits
its verification to a :class:`~hyperdrive_tpu_torch.devsched.
DeviceWorkQueue`, which coalesces up to ``pipeline_depth`` settles into
one ``verify_signatures`` call (:meth:`Simulation._settle_speculative`).
Commits raised meanwhile are gated until the covering drain confirms the
speculation; a verdict that differs raises
:class:`~hyperdrive_tpu_torch.devsched.SpeculationMismatch`. The queue is
``Simulation._sched``.

With ``execution=ExecutionConfig(...)`` every height carries a
deterministic transaction block (:mod:`hyperdrive_tpu_torch.exec`):
proposers propose its value, validators accept only that value, and
every commit record is the value extended with the 32-byte chained state
root of the replica's executor (``DeviceLedgerExecutor`` on ``device``
when ``config.device``, else the host reference executor). With
``sign_txs`` the block's signatures ride the device-work queue, fused
into the vote launch (``fused_exec_drain``) or as a launch of their own
(``ExecApplyLauncher``); a sequential run verifies each block once
through the batch verifier at its first commit. ``exec_speculate``
applies each height at propose time under a guessed mask and rolls back
on a mismatch; ``dedup_exec`` shares one executor across the replicas.

With ``payload_bytes > 0`` (BASELINE config 5) every proposed value
carries a (2f+1)-of-n Shamir share bundle of a payload derived from it,
validators accept only that bundle, and every commit reconstructs the
payload (:meth:`Simulation._reconstruct_commit`) through
``reconstructor`` (by default an
:class:`~hyperdrive_tpu_torch.ops.shamir.AdaptiveReconstructor` whose
device leg is on ``device``); ``reconstructed[i][h]`` keeps the bytes and
``reconstruct_latency`` the wall time of each reconstruction (the
reference's ``sim.reconstruct.latency`` histogram). With
``certificates=True`` every replica's Process carries a
:class:`~hyperdrive_tpu_torch.certificates.Certifier` bound to the batch
verifier's ``last_transcript``; ``SimulationResult.cert_digests`` holds
each replica's chain digest. ``bls_certificates`` (True or ``"device"``)
implies ``certificates`` and adds the 48-byte BLS aggregate signature to
every certificate, folded on the host or, with ``"device"``, by the
``g1_aggregate`` kernel on ``device``.

Every run is recorded unless ``record=False``: each delivered ``(to,
msg)`` in delivery order, the superstep sizes of a burst run, and the
epoch and execution trailers, in a :class:`ScenarioRecord` whose v7 wire
format is the reference's byte for byte. :meth:`Simulation.replay`
re-delivers a record (a dump of this package or of the JAX package)
message for message. ``ScenarioRecord.load`` reads through a plain
:class:`~hyperdrive_tpu_torch.codec.Reader` with a 1 GiB budget: the
reference's wire-audit hooks (``wire_codec``, ``wire_entry``,
``maybe_wire_reader``) are dropped with the other analysis hooks.

With ``epochs=EpochConfig(...)`` (lock-step and unsigned, as in the
reference) heights partition into epochs: every boundary commit elects
the next committee and rotates keys (:mod:`hyperdrive_tpu_torch.epochs`),
the committing replica takes the new whitelist, quorum, proposer
schedule and identity at the commit seam, and retired identities enter
one stale-vote map that every replica shares (``Replica.retired``). With
``certificates=True`` every certifier is an
:class:`~hyperdrive_tpu_torch.epochs.EpochCertifier` that mints the
epoch proofs, with ``bls_certificates`` over a BLS keyring built from
epoch 0's committee. With ``execution=`` the elections are stake-driven:
a host stake oracle (a ``HostLedgerExecutor`` bound to the schedule's
``stake_source``) elects from the committed ledger's stake column,
whatever executors the replicas run.

With ``overlay=OverlayConfig(...)`` (lock-step, paced by
``delivery_cost``) votes travel the seeded binomial aggregation tree of
:mod:`hyperdrive_tpu_torch.overlay` as partial-aggregate frames, one
``delivery_cost`` a frame, instead of the n-wide fan-out; proposals keep
the fan-out. Constituent votes are delivered and recorded as plain
``(to, vote)`` tuples, so a dump replays with no overlay wiring. A
signed overlay run verifies each vote once network-wide through one
shared verifier behind the device-work queue (a ``TorchBatchVerifier``
on the card; a ``HostVerifier`` with ``device="cpu"``), and
``bls_partials`` merges go through a ``G1SumLauncher`` on ``device``
(the host fold only with ``device="cpu"`` and no ``devsched``); the
reference verifies on the host and folds on the host without a queue,
with the same aggregates and digests. Frame and tick deliveries run the
laggard sweep (``catchup_every``, ``catchup_lag``), whose resyncs are
recorded as ``OP_RESYNC`` lifecycle operations and replayed.

With ``chaos=FaultPlan(...)`` (lock-step, paced by ``delivery_cost``
when the plan has partitions) the plan is interpreted per delivery
(:meth:`Simulation._chaos_deliver`, :meth:`Simulation._chaos_tick`): link
faults drop, duplicate and delay deliveries from a chaos stream of their
own, partitions block deliveries between groups on the virtual clock and
resync the laggards at their heal, and a crash victim checkpoints its
Process after every delivery it handles, goes down at its step and is
restored from its latest checkpoint ``restart_after_steps`` later
(:meth:`Simulation._apply_restore`); its queue-backed flusher cancels the
dead incarnation's in-flight windows. Crashes and restores are recorded as
``OP_CRASH`` and ``OP_RESTORE`` lifecycle operations and replayed, the
checkpoints re-derived. An
:class:`~hyperdrive_tpu_torch.chaos.InvariantMonitor` hooks the commit
seam (``_on_commit``). With ``load=LoadProfile(...)`` (lock-step, paced)
each delivered vote due an open-loop arrival is re-delivered as a gossip
duplicate (no step, no clock, no rng draw), and with the profile's
``admission`` every replica gets an
:class:`~hyperdrive_tpu_torch.load.AdmissionGate` on one
:class:`~hyperdrive_tpu_torch.load.BackpressureController` on the
virtual clock, which with ``pin=False`` watches the device-work queue
(:meth:`Simulation.overload_snapshot`).

Observability (:mod:`hyperdrive_tpu_torch.obs`): ``self.tracer``, one
:class:`~hyperdrive_tpu_torch.utils.trace.Tracer` on the virtual clock,
always on (``sim.*`` and every replica's ``replica.*`` series), and
``self.registry``, a :class:`~hyperdrive_tpu_torch.obs.metrics.Registry`
that :meth:`Simulation.metrics_snapshot` folds the tracer into. With
``observe=True`` a :class:`~hyperdrive_tpu_torch.obs.recorder.Recorder`
of ``obs_capacity`` events (``self.obs``) journals the replicas'
consensus events, the settle layer's passes and launches, the queue's
``sched.*`` events and the launch probe (``self.devtel``, a
:class:`~hyperdrive_tpu_torch.obs.devtel.DeviceTelemetry` handed to the
queue), and, through the device-fetch observer, every device-to-host
copy (``fetch.sync``); a batch verifier with an unbound ``obs`` is bound
to the sim's track. Journal and snapshot equal the JAX package's on the
same run. The chaos monitor, the admission gates, the certifiers, the
executors and the overlay runtime journal through the same recorder,
with the reference's hooks.

``tally_mesh`` (a ("hr", "val") mesh of ranks from
:func:`~hyperdrive_tpu_torch.parallel.mesh.make_mesh`) shards the vote
grid's validator axis over the mesh: every rank runs the same
deterministic network, scatters the rows of its validators and sums the
quorum counts over the ``val`` group in every settle's grid call; such a
run takes the two-launch settle (the fused settle is single-device).
"""

from __future__ import annotations

import hashlib
import heapq
import random
import time
from dataclasses import dataclass, field, replace
from itertools import repeat
from typing import Callable, Optional

import numpy as np

from hyperdrive_tpu_torch.batch import MessageBlock, WindowColumns
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.messages import (
    Precommit,
    Prevote,
    Propose,
    Timeout,
    marshal_message,
    unmarshal_message,
)
from hyperdrive_tpu_torch.analysis.annotations import set_fetch_observer
from hyperdrive_tpu_torch.obs.devtel import NULL_DEVTEL, DeviceTelemetry
from hyperdrive_tpu_torch.obs.metrics import Registry
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND as _OBS_NULL
from hyperdrive_tpu_torch.obs.recorder import NULL_RECORDER, Recorder
from hyperdrive_tpu_torch.overlay.runtime import OverlayFrame, OverlayTick
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions, ResetHeight, merge_drain
from hyperdrive_tpu_torch.scheduler import RoundRobin
from hyperdrive_tpu_torch.testutil import (
    BroadcasterCallbacks,
    CatcherCallbacks,
    CommitterCallback,
    MockProposer,
    MockValidator,
)
from hyperdrive_tpu_torch.timer import VirtualTimer
from hyperdrive_tpu_torch.types import Height, Value
from hyperdrive_tpu_torch.utils.trace import Tracer

__all__ = ["VirtualClock", "ScenarioRecord", "SimulationResult", "Simulation"]

#: The laggard sweep's defaults: delivery steps between sweeps, and the
#: height lag tolerated before a laggard is jumped forward.
_CATCHUP_EVERY = 256
_CATCHUP_LAG = 2


class VirtualClock:
    """A deterministic event clock: deadlines in a heap, time advances only
    when the simulator asks for the next due event."""

    def __init__(self):
        self.now = 0.0
        self._seq = 0
        self._heap: list[tuple[float, int, object, object]] = []

    def schedule(self, delay: float, event, handler) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (self.now + delay, self._seq, event, handler))

    def pending(self) -> int:
        return len(self._heap)

    def fire_next(self):
        """Jump to the earliest deadline; return (event, handler). Time
        never moves backwards."""
        deadline, _, event, handler = heapq.heappop(self._heap)
        self.now = max(self.now, deadline)
        return event, handler

    def prune(self, keep) -> int:
        """Drop scheduled events failing ``keep(event)``; returns the drop
        count (timeouts for long-committed heights pile up otherwise)."""
        kept = [e for e in self._heap if keep(e[2])]
        dropped = len(self._heap) - len(kept)
        if dropped:
            heapq.heapify(kept)
            self._heap = kept
        return dropped


@dataclass
class ScenarioRecord:
    """A reproducible account of one simulated run (the Go reference's
    ``Scenario``, ``replica_test.go:850-860``)."""

    seed: int
    n: int
    f: int
    target_height: Height
    signatories: list[bytes] = field(default_factory=list)
    #: Every delivered (to, message) in delivery order.
    messages: list[tuple[int, object]] = field(default_factory=list)
    #: A burst run's delivered-message count per superstep, so replay
    #: reproduces the window boundaries (empty = a lock-step run).
    bursts: list[int] = field(default_factory=list)
    #: Whether burst windows went through batched ingestion or per-message
    #: dispatch: replay must match, or timeout schedules and evidence can
    #: diverge from the recorded run.
    batch_ingest: bool = True
    #: Chaos lifecycle operations ``(kind, pos, replica, aux)``: kind one
    #: of OP_CRASH / OP_RESTORE / OP_RESYNC, ``pos`` the delivered-message
    #: count when the op fired, ``aux`` the resync height (0 for a crash).
    lifecycle: list[tuple[int, int, int, int]] = field(default_factory=list)
    #: ``(epoch_length, committee_size, rekey_per_epoch, seed, stakes)``
    #: of an epoch run, or None: replay rebuilds the same EpochSchedule.
    epochs: "tuple | None" = None
    #: ``ExecutionConfig.as_ints()`` of an execution run, or None: blocks,
    #: masks and chained roots are functions of these ints and the
    #: committed heights, so replay re-derives the ledger.
    execution: "tuple | None" = None

    OP_CRASH = 0
    OP_RESTORE = 1
    OP_RESYNC = 2

    #: Format magic and version. v3 appends the burst sizes, v4 the
    #: batch_ingest flag (older dumps load as per-message dispatch), v5 the
    #: lifecycle ops, v6 the epoch trailer, v7 the execution trailer.
    MAGIC = 0x48594456  # "HYDV"
    VERSION = 7

    def marshal(self, w: Writer) -> None:
        w.u32(self.MAGIC)
        w.u32(self.VERSION)
        w.u64(self.seed)
        w.u32(self.n)
        w.u32(self.f)
        w.i64(self.target_height)
        w.u32(len(self.signatories))
        for s in self.signatories:
            w.bytes32(s)
        w.u32(len(self.messages))
        for to, msg in self.messages:
            w.u32(to)
            marshal_message(msg, w)
        w.u32(len(self.bursts))
        for b in self.bursts:
            w.u32(b)
        w.bool(self.batch_ingest)
        w.u32(len(self.lifecycle))
        for kind, pos, replica, aux in self.lifecycle:
            w.u32(kind)
            w.u32(pos)
            w.u32(replica)
            w.i64(aux)
        w.bool(self.epochs is not None)
        if self.epochs is not None:
            epoch_length, committee, rekey, eseed, stakes = self.epochs
            w.u32(epoch_length)
            w.u32(committee)
            w.u32(rekey)
            w.u64(eseed)
            w.u32(len(stakes))
            for s in stakes:
                w.u64(s)
        w.bool(self.execution is not None)
        if self.execution is not None:
            # Length-prefixed: a new config int extends the trailer
            # without a version bump.
            w.u32(len(self.execution))
            for v in self.execution:
                w.u64(int(v))

    @classmethod
    def unmarshal(cls, r: Reader) -> "ScenarioRecord":
        magic = r.u32()
        if magic != cls.MAGIC:
            raise SerdeError(f"not a scenario dump (magic {magic:#x})")
        version = r.u32()
        if version not in (2, 3, 4, 5, 6, cls.VERSION):
            raise SerdeError(
                f"scenario dump version {version} unsupported "
                f"(expected {cls.VERSION})"
            )
        rec = cls(seed=r.u64(), n=r.u32(), f=r.u32(), target_height=r.i64())
        nsigs = r.u32()
        if nsigs > 1 << 20:
            raise SerdeError("signatory count too large")
        rec.signatories = [r.bytes32() for _ in range(nsigs)]
        nmsgs = r.u32()
        if nmsgs > 1 << 24:
            raise SerdeError("message count too large")
        # Intern equal messages: a live run delivers ONE broadcast object
        # to every receiver, and the identity-keyed dedup verification
        # leans on that. Message equality excludes the signature, so the
        # key carries it: deliveries that differ only in signature stay
        # distinct objects, or replayed verdicts could flip. (Timeouts
        # have no signature; their equality covers every field.)
        interned: dict = {}
        rec.messages = []
        for _ in range(nmsgs):
            to = r.u32()
            msg = unmarshal_message(r)
            key = (msg, getattr(msg, "signature", None))
            rec.messages.append((to, interned.setdefault(key, msg)))
        if version >= 3:
            nb = r.u32()
            if nb > 1 << 24:
                raise SerdeError("burst count too large")
            rec.bursts = [r.u32() for _ in range(nb)]
        rec.batch_ingest = r.bool() if version >= 4 else False
        if version >= 5:
            nops = r.u32()
            if nops > 1 << 20:
                raise SerdeError("lifecycle op count too large")
            rec.lifecycle = [
                (r.u32(), r.u32(), r.u32(), r.i64()) for _ in range(nops)
            ]
        if version >= 6 and r.bool():
            epoch_length = r.u32()
            committee = r.u32()
            rekey = r.u32()
            eseed = r.u64()
            nstakes = r.u32()
            if nstakes > 1 << 20:
                raise SerdeError("stake count too large")
            rec.epochs = (
                epoch_length, committee, rekey, eseed,
                tuple(r.u64() for _ in range(nstakes)),
            )
        if version >= 7 and r.bool():
            nvals = r.u32()
            if nvals > 64:
                raise SerdeError("execution trailer too large")
            rec.execution = tuple(r.u64() for _ in range(nvals))
        return rec

    def dump(self, path: str) -> None:
        w = Writer(rem=1 << 30)
        self.marshal(w)
        with open(path, "wb") as fh:
            fh.write(w.data())

    @classmethod
    def load(cls, path: str) -> "ScenarioRecord":
        with open(path, "rb") as fh:
            return cls.unmarshal(Reader(fh.read(), rem=1 << 30))


class _Discard:
    """The message sink of a ``record=False`` run: appends are no-ops, so
    the delivery loops make one unconditional call either way."""

    __slots__ = ()

    def append(self, item) -> None:
        pass

    def append_broadcast(self, msg, live) -> None:
        pass


_DISCARD = _Discard()


class RecordedMessages:
    """The delivery log, list-compatible but broadcast-compact.

    A shared-superstep broadcast reaches every live replica: one op
    ``(msg, live)`` stands for ``len(live)`` deliveries. The flat
    per-delivery view that replay, serde and equality read is built on
    first indexed access; a run only appends. ``live`` lists are shared
    by reference across one superstep's ops and must not be mutated
    afterwards (the burst loop builds a new list every superstep).
    """

    __slots__ = ("_ops", "_len", "_flat")

    _TARGETED = None  # the ``live`` of a single (to, msg) delivery

    def __init__(self):
        self._ops: list = []
        self._len = 0
        self._flat = None

    def append(self, item) -> None:
        """One targeted delivery: item = (to, msg)."""
        if self._flat is not None:
            self._flat.append(item)
        self._ops.append((item, self._TARGETED))
        self._len += 1

    def append_broadcast(self, msg, live) -> None:
        """One broadcast delivered to every replica in ``live``, in
        order, recorded as a single op."""
        if self._flat is not None:
            self._flat.extend((i, msg) for i in live)
        self._ops.append((msg, live))
        self._len += len(live)

    def _materialize(self) -> list:
        flat = self._flat
        if flat is None:
            flat = []
            for head, live in self._ops:
                if live is self._TARGETED:
                    flat.append(head)
                else:
                    flat.extend((i, head) for i in live)
            self._flat = flat
        return flat

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, idx):
        return self._materialize()[idx]

    def __eq__(self, other) -> bool:
        if isinstance(other, RecordedMessages):
            other = other._materialize()
        if isinstance(other, list):
            return self._materialize() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"RecordedMessages({self._len} deliveries)"


class _OwnedClock:
    """Wraps the shared clock so fired timeouts carry their owner index."""

    __slots__ = ("_clock", "_owner")

    def __init__(self, clock: VirtualClock, owner: int):
        self._clock = clock
        self._owner = owner

    def schedule(self, delay: float, event, handler) -> None:
        self._clock.schedule(delay, event, self._owner)


@dataclass
class SimulationResult:
    completed: bool
    steps: int
    virtual_time: float
    heights: list[Height]
    commits: list[dict[Height, Value]]
    #: The run's replay log; None when the run had ``record=False``.
    record: "ScenarioRecord | None"
    alive: list[bool]
    #: Per-replica certificate chain digests (``certificates=True`` runs).
    cert_digests: "list[str] | None" = None
    #: The Simulation behind a :meth:`Simulation.replay` result (a live
    #: ``run()`` caller already holds its own).
    sim: "Simulation | None" = field(default=None, repr=False, compare=False)

    def assert_safety(self) -> None:
        """All replicas must agree byte for byte wherever their commit maps
        overlap."""
        maps = self.commits
        for h in sorted(set().union(*[set(c) for c in maps])) if maps else ():
            vals = {c[h] for c in maps if h in c}
            assert len(vals) <= 1, f"safety violation at height {h}: {vals}"

    def commit_digest(self, up_to: int | None = None) -> str:
        """SHA-256 over the height-sorted (height, value) pairs of the
        merged commit maps, bounded to heights <= ``up_to`` when given
        (two runs may overshoot the target by different amounts)."""
        self.assert_safety()
        merged: dict = {}
        for c in self.commits:
            merged.update(c)
        if up_to is not None:
            merged = {k: v for k, v in merged.items() if k <= up_to}
        h = hashlib.sha256()
        for height in sorted(merged):
            v = merged[height]
            h.update(int(height).to_bytes(8, "little"))
            h.update(len(v).to_bytes(4, "little"))
            h.update(v)
        return h.hexdigest()


class Simulation:
    """Build and run one n-replica scenario.

    Delivery is lock-step (``burst=False``, the default) or by superstep
    (``burst=True``), as the module docstring says. ``sign=True`` gives
    every replica the deterministic Ed25519 keypair of the reference
    (``KeyRing.deterministic(n, namespace=b"sim-%d" % seed)``) and signs
    every broadcast. In lock-step every replica then verifies its own
    windows: through ``verifier_for(i)`` (anything with ``verify_batch``,
    e.g. a :class:`~hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier`
    on the card), else through one of its own on ``device``, as the
    reference gives each its own: a ``TorchBatchVerifier`` on the card
    (the default), a ``HostVerifier`` with ``device="cpu"``.
    ``flusher_for(i, committee)`` gives replica ``i`` a flusher
    instead (``QueueFlusher(verifier, q)``, or a ``DeviceTallyFlusher``
    with ``queue=q``) on the queue passed as ``devsched=q``; flushers
    coalesce only when they share one verifier object. ``signatories``
    overrides the unsigned identities (it must equal the ring's with
    ``sign=True``; replay passes the recorded ones).

    With ``burst=True`` and no ``batch_verifier``, the settle layer
    verifies through
    :class:`~hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier` on
    ``device`` (the card unless the caller asks for the CPU); pass
    ``batch_verifier=HostVerifier()`` for the host baseline.
    ``dedup_verify=True`` verifies each distinct broadcast once per settle
    pass. ``small_window_host``: None = route sub-64-signature settles to
    the host verifier when the batch verifier is a device one, False =
    every settle through the batch verifier, True = always route. With the
    default, ``device="cuda"`` still verifies each height's propose settle
    (one signature) on the host, as the reference does; pass False to send
    every settle through the kernel.

    ``pipeline_heights=True`` (needs ``burst`` and a batch verifier, or
    ``sign=True``) settles on speculative verdicts and coalesces up to
    ``pipeline_depth`` settles' verification into one launch through
    ``self._sched`` (``devsched=`` if given, else a queue of its own);
    commits are gated until the covering drain.

    ``device_tally=True`` keeps the quorum counts in a
    :class:`~hyperdrive_tpu_torch.ops.votegrid.VoteGrid` on ``device``;
    ``tally_check`` (a callable ``(view, proc) -> view``, e.g.
    ``CheckedTallyView``) wraps every tally view. ``fused_min_window``: a
    lockstep settle of fewer messages (or a straggler settle of fewer
    distinct messages) runs fully on the host with the grid poisoned for
    the slots it bypasses; 0 = never. ``route_hysteresis`` N: when 95% of
    the last N routed settles went to the host, grid upkeep stops until a
    device-routed settle rebuilds it (0 = off).
    ``tally_mesh``: a mesh of ranks
    (:func:`~hyperdrive_tpu_torch.parallel.mesh.make_mesh`) to shard the
    grid's validator axis over (the validator count must divide over its
    ``val`` axis); the grid lives on the rank's mesh device, which
    ``device`` must name, and every rank of the mesh must run the same
    network (each settle's grid call is a collective).

    ``payload_bytes``, ``dedup_reconstruct`` (reconstruct each committed
    value once, not once per replica) and ``reconstructor``: the Shamir
    payload path (refused with ``pipeline_heights``). ``certificates``:
    a quorum certificate at every commit. ``bls_certificates``: False,
    True (every certificate carries the committee's BLS aggregate
    signature, folded on the host) or ``"device"`` (folded by the
    ``g1_aggregate`` kernel on ``device``, at the committee width rounded
    up to a power of two; it resolves ``device``, so it raises without
    CUDA unless ``device="cpu"``); either implies ``certificates``.

    ``execution`` (an :class:`~hyperdrive_tpu_torch.exec.ExecutionConfig`)
    puts a ledger behind every committed height; it resolves ``device``
    (so it raises without CUDA unless ``device="cpu"``), and with
    ``config.device`` the executors' tensors live there.
    ``exec_speculate``, ``fused_exec_drain`` and ``dedup_exec`` default
    to ``pipeline_heights``; a lock-step run speculates only with an
    injected ``devsched``, whose drains resolve the speculation.

    ``epochs`` (an :class:`~hyperdrive_tpu_torch.epochs.EpochConfig`):
    dynamic validator sets, lock-step and unsigned only; with
    ``execution`` the elections read the committed stake column (it needs
    at least ``n`` accounts). ``overlay`` (an
    :class:`~hyperdrive_tpu_torch.overlay.OverlayConfig`): the aggregation
    overlay, lock-step with ``delivery_cost > 0``, no ``drop_rate``,
    ``reorder`` or ``verifier_for``, and an epoch committee of all ``n``;
    it resolves ``device`` when signed or with ``bls_partials``.
    ``chaos`` (a :class:`~hyperdrive_tpu_torch.chaos.FaultPlan`) and
    ``load`` (a :class:`~hyperdrive_tpu_torch.load.LoadProfile`): the
    chaos engine and open-loop load, lock-step only, as the module
    docstring says; ``load`` is refused with ``overlay`` and both need
    ``delivery_cost > 0`` (chaos only when its plan has partitions).
    ``catchup_every`` (default 256 steps) and ``catchup_lag`` (default 2
    heights): the laggard sweep of an overlay or chaos run. ``record``
    (default True) keeps the :class:`ScenarioRecord` that
    ``SimulationResult.record`` returns. ``observe`` (default False)
    keeps a flight-recorder journal of ``obs_capacity`` events in
    ``self.obs``, and a launch probe on the device-work queue
    (``self.devtel``); :meth:`metrics_snapshot` works either way.

    The adversaries, as in the reference, all drawing from ``self.rng =
    random.Random(seed)``: ``reorder`` swaps a random pending delivery to
    the head of the queue (one ``randrange`` a lock-step delivery) or
    shuffles every superstep; ``drop_rate`` drops each non-timeout
    delivery with that probability (one ``self.rng.random()`` a
    delivery); ``kill_at_step`` ``{replica: step}`` kills at that
    delivery step (at the first superstep boundary at or past it in
    burst mode); ``offline`` replicas never start; ``byzantine_proposer``
    ``{replica: fn(height, round) -> value}`` and ``byzantine_validator``
    ``{replica: fn(height, round, value) -> bool}`` replace those
    replicas' proposer and validator; ``delivery_cost`` charges that many
    virtual seconds a delivery.

    Differential knobs of burst mode: ``shared_superstep`` (None = on
    without ``reorder``/``drop_rate``; False forces the per-delivery
    path, which gives the same trajectory), ``batch_ingest`` (None = on;
    False dispatches message by message), ``columnar_ingest`` (None =
    ``batch_ingest``; False keeps the object path), ``pipeline_verify``
    (None = on; False verifies each settle pass in one call).
    """

    def __init__(
        self,
        n: int,
        target_height: Height,
        seed: int = 1,
        timeout: float = 1.0,
        timeout_scaling: float = 0.5,
        max_capacity: int = 1000,
        reorder: bool = False,
        drop_rate: float = 0.0,
        kill_at_step: Optional[dict[int, int]] = None,
        offline: Optional[set[int]] = None,
        byzantine_proposer: Optional[dict[int, Callable]] = None,
        byzantine_validator: Optional[dict[int, Callable]] = None,
        verifier_for: Optional[Callable[[int], object]] = None,
        signatories: Optional[list[bytes]] = None,
        sign: bool = False,
        delivery_cost: float = 0.0,
        burst: bool = False,
        dedup_verify: bool = False,
        batch_verifier=None,
        batch_ingest: Optional[bool] = None,
        shared_superstep: Optional[bool] = None,
        small_window_host: Optional[bool] = None,
        columnar_ingest: Optional[bool] = None,
        pipeline_verify: Optional[bool] = None,
        device_tally: bool = False,
        tally_check=None,
        fused_min_window: int = 0,
        route_hysteresis: int = 32,
        pipeline_heights: Optional[bool] = None,
        pipeline_depth: int = 6,
        devsched=None,
        flusher_for: Optional[Callable[[int, list], object]] = None,
        record: bool = True,
        payload_bytes: int = 0,
        dedup_reconstruct: bool = True,
        reconstructor=None,
        certificates: bool = False,
        bls_certificates=False,
        epochs=None,
        execution=None,
        exec_speculate: Optional[bool] = None,
        fused_exec_drain: Optional[bool] = None,
        dedup_exec: Optional[bool] = None,
        overlay=None,
        chaos=None,
        load=None,
        catchup_every: Optional[int] = None,
        catchup_lag: Optional[int] = None,
        observe: bool = False,
        obs_capacity: int = 65536,
        tally_mesh=None,
        device="cuda",
    ):
        #: The adversaries' one random stream: ``reorder`` draws once a
        #: lock-step delivery (or shuffles each superstep), ``drop_rate``
        #: once per non-timeout delivery, in the reference's order (one
        #: extra draw moves every trajectory).
        self.rng = random.Random(seed)
        self.reorder = reorder
        self.drop_rate = drop_rate
        #: Virtual seconds charged per delivered message (0 = free).
        self.delivery_cost = delivery_cost
        self.kill_at_step = dict(kill_at_step or {})
        self.offline = set(offline or ())
        self.burst = burst
        #: Shared-superstep mode: with no per-delivery adversary every live
        #: replica receives the same broadcast sequence, so a broadcast is
        #: ONE queue entry and the settle sorts and verifies it once.
        self._shared_mode = (
            burst and not reorder and drop_rate == 0.0
            if shared_superstep is None
            else bool(shared_superstep)
        )
        if self._shared_mode and not (burst and not reorder and drop_rate == 0.0):
            raise ValueError(
                "shared_superstep=True requires burst mode with no "
                "per-delivery adversary (reorder/drop_rate)"
            )
        #: Burst mode ingests a window at a time (one rule cascade a
        #: window); False dispatches message by message.
        self.batch_ingest = burst if batch_ingest is None else batch_ingest
        if self.batch_ingest and not burst:
            raise ValueError("batch_ingest requires burst=True")
        #: Columnar settle: lockstep windows ingest through ONE
        #: WindowColumns extraction shared by every replica.
        self.columnar_ingest = (
            self.batch_ingest if columnar_ingest is None else bool(columnar_ingest)
        )
        if self.columnar_ingest and not self.batch_ingest:
            raise ValueError("columnar_ingest requires batched ingestion")
        #: Double-buffered redundant settle (no dedup, no device tally):
        #: replica groups, group g+1 enqueued before group g's mask is read.
        self._pipeline_verify = (
            True if pipeline_verify is None else bool(pipeline_verify)
        )
        #: Chained height pipelining through the device-work queue: None or
        #: False = off (the sequential trajectory, the differential
        #: baseline).
        self._pipeline_heights = bool(pipeline_heights or False)
        self._pipeline_depth = int(pipeline_depth)
        if self._pipeline_heights:
            if not burst:
                raise ValueError(
                    "pipeline_heights requires burst mode (settles are the "
                    "unit of pipelining; lock-step replicas pipeline "
                    "through a queue-backed flusher instead)"
                )
            if batch_verifier is None and not sign:
                raise ValueError(
                    "pipeline_heights pipelines the batch_verifier's "
                    "launches; pass one (or sign=True, which installs a "
                    "default)"
                )
            if payload_bytes:
                raise ValueError(
                    "pipeline_heights defers commit finalization past "
                    "the height, but payload reconstruction reads the "
                    "committed height's propose logs at commit time — "
                    "run the payload path sequentially"
                )
        if device_tally and not (burst and self.batch_ingest):
            raise ValueError(
                "device_tally requires burst=True with batched ingestion"
            )
        if batch_verifier is not None and not burst:
            raise ValueError("batch_verifier requires burst=True")
        if burst and verifier_for is not None:
            raise ValueError(
                "burst mode verifies at the network settle layer; pass "
                "batch_verifier instead of per-replica verifier_for"
            )
        #: Per-replica flusher factory ``(i, committee) -> flusher`` for
        #: lock-step pipelining: queue-backed flushers submit through the
        #: injected ``devsched`` queue, which the delivery loop drains
        #: whenever the network quiesces.
        self._flusher_for = flusher_for
        if flusher_for is not None and burst:
            raise ValueError(
                "flusher_for wires per-replica flushers for lock-step "
                "delivery; burst mode settles through the aggregated "
                "harness path (use pipeline_heights there)"
            )
        self.n = n
        self.f = n // 3
        self.target_height = target_height
        self.seed = seed
        self.clock = VirtualClock()
        # One shared tracer across all replicas, on virtual time: metrics
        # (round latencies, verify windows, equivocation counts) are
        # deterministic and replay-identical. The sim is single-threaded,
        # so the tracer skips its per-call lock.
        self.tracer = Tracer(time_fn=lambda: self.clock.now, threadsafe=False)
        #: Flight recorder (obs/recorder.py): a bounded, deterministic
        #: event journal on the same virtual clock. Off by default:
        #: NULL_RECORDER hands every component the shared no-op handle.
        self.obs = (
            Recorder(
                capacity=obs_capacity,
                time_fn=lambda: self.clock.now,
                threadsafe=False,
            )
            if observe
            else NULL_RECORDER
        )
        #: Sim-level emit handle (replica = -1): settle, verify and tally
        #: launch events that belong to the harness, not to one replica.
        self._obs_sim = self.obs.scoped(-1)
        #: Metrics registry (always; metrics_snapshot() folds the tracer
        #: in) and the device-launch probe (only when observing), both on
        #: the virtual clock.
        self.registry = Registry(time_fn=lambda: self.clock.now)
        self.devtel = (
            DeviceTelemetry(
                recorder=self.obs,
                registry=self.registry,
                time_fn=lambda: self.clock.now,
            )
            if observe
            else NULL_DEVTEL
        )
        self.queue: list[tuple[int, object]] = []
        self._qhead = 0
        #: ``record=False`` drops the replay log (at depth it dominates
        #: memory); the result's ``record`` is then None, so a dump attempt
        #: fails loudly instead of replaying an empty scenario. Live runs
        #: log through the broadcast-compact RecordedMessages.
        self._record_on = record
        self.record = ScenarioRecord(
            seed=seed, n=n, f=self.f, target_height=target_height
        )
        self.record.messages = RecordedMessages()
        self.record.batch_ingest = self.batch_ingest
        self.batch_verifier = batch_verifier
        self.dedup_verify = dedup_verify
        self._small_win_host = None
        self.ring = None
        if sign:
            from hyperdrive_tpu_torch.crypto.keys import KeyRing

            self.ring = KeyRing.deterministic(n, namespace=b"sim-%d" % seed)
            if signatories is not None and signatories != self.ring.signatories:
                raise ValueError(
                    "sign=True derives identities from the keyring; a "
                    "signatories override that differs from the ring's "
                    "public keys would make every signature verification "
                    "fail (replay a signed dump with the same seed instead)"
                )
            self.signatories = self.ring.signatories
            if burst:
                if self.batch_verifier is None:
                    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

                    self.batch_verifier = TorchBatchVerifier(device=device)
            elif verifier_for is None and flusher_for is None and overlay is None:
                # Every replica verifies its own windows, as in the
                # reference, on ``device``: a flusher, when given, owns
                # the flush and needs none, and an overlay run verifies
                # once network-wide at the dissemination layer instead.
                verifier_for = lambda i: _lockstep_verifier(device)  # noqa: E731
        else:
            self.signatories = signatories or [
                hashlib.sha256(b"sim-replica-%d-%d" % (seed, i)).digest()
                for i in range(n)
            ]
        self._init_epochs(epochs, signatories, sign, burst, payload_bytes)
        self.record.signatories = list(self.signatories)
        # An observed run adopts a device verifier's recorder handle (one
        # it built itself included) so its occupancy and RLC events land
        # in this journal; an explicitly bound handle wins.
        if observe and getattr(self.batch_verifier, "obs", None) is _OBS_NULL:
            self.batch_verifier.obs = self._obs_sim
        #: Laggard catch-up sweep (overlay runs): every ``catchup_every``
        #: delivery steps, an alive replica more than ``catchup_lag``
        #: heights below the network's working height is jumped to it.
        self._catchup_every = (
            _CATCHUP_EVERY if catchup_every is None else int(catchup_every)
        )
        self._catchup_lag = (
            _CATCHUP_LAG if catchup_lag is None else int(catchup_lag)
        )
        if self._catchup_every < 1:
            raise ValueError("catchup_every must be >= 1")
        if self._catchup_lag < 0:
            raise ValueError("catchup_lag must be >= 0")
        self._check_overlay(overlay, epochs, burst, drop_rate, reorder,
                            delivery_cost, verifier_for, load)
        bv = self.batch_verifier
        if small_window_host is True and bv is None:
            raise ValueError(
                "small_window_host=True requires a batch_verifier to "
                "route small windows away from"
            )
        if bv is not None and (
            small_window_host is True
            or (small_window_host is None and hasattr(bv, "fused_inner"))
        ):
            from hyperdrive_tpu_torch.verifier import HostVerifier

            self._small_win_host = HostVerifier()
        #: The async device-work queue: injected (``devsched=``, the queue
        #: lock-step flushers submit through, drained by the delivery loop
        #: before any timeout fires), or a pipelined burst run's own, or
        #: None. Its drains finalize the gated commits (_on_sched_drain).
        self._sched = devsched
        if self._sched is None and self._pipeline_heights:
            from hyperdrive_tpu_torch.devsched import DeviceWorkQueue

            self._sched = DeviceWorkQueue(
                max_depth=self._pipeline_depth,
                obs=self.obs.scoped(-2),
                tracer=self.tracer,
                devtel=self.devtel,
            )
        if self._sched is not None:
            self._sched.on_drain = self._on_sched_drain
            # An injected queue adopts this run's seams unless they were
            # bound when it was made: sched.* events on the devsched track (-2),
            # sim.sched.* metrics on the run's tracer.
            if self._sched.obs is _OBS_NULL:
                self._sched.obs = self.obs.scoped(-2)
            if self._sched.tracer is None:
                self._sched.tracer = self.tracer
            if self._sched.devtel is NULL_DEVTEL:
                self._sched.devtel = self.devtel
        #: Commit finalizations gated on in-flight speculation: (replica,
        #: height, value, covering future) in commit order, flushed by
        #: _on_sched_drain once the covering futures resolve.
        self._gated_commits: list = []
        self._spec_inflight = 0
        #: The most recent speculative-settle future: what a commit raised
        #: while speculation is in flight is gated on.
        self._spec_last_fut = None
        #: Rows accumulated in the open pipeline slot: the row-aware drain
        #: trigger (_settle_speculative) closes the slot just before a
        #: submission would spill into a larger verify bucket.
        self._spec_rows = 0
        self._max_capacity = max_capacity
        #: Sender -> tie-break index for the shared-lane sort; seeded with
        #: the whitelist so it matches every replica's mq order map.
        self._order_pos = {s: v for v, s in enumerate(self.signatories)}
        self._shared: list = []
        self.commits: list[dict[Height, Value]] = [dict() for _ in range(n)]
        self.alive = [i not in self.offline for i in range(n)]
        # A replica leaves the pending set when it commits the target
        # height or dies.
        self._pending_replicas = {i for i in range(n) if self.alive[i]}
        self.caught: list[tuple[str, int]] = []
        self._init_chaos(chaos, load, burst, delivery_cost)
        #: Settle accounting: passes, passes whose windows carried votes,
        #: and signatures handed to a verifier (after dedup).
        self.settle_passes = 0
        self.vote_settles = 0
        self.verified_sigs = 0
        #: Device-tally accounting: settles verified, merged and tallied in
        #: one fused call; separate tally launches (update_and_tally, one
        #: per two-launch settle, propose settles included); settles the
        #: crossover router kept on the host.
        self.fused_settles = 0
        self.tally_launches = 0
        self.host_routed_settles = 0
        #: certificates=True: every replica's Process carries a
        #: certificates.Certifier minting a QuorumCertificate at each
        #: commit (transcript-bound to the batch verifier when it has
        #: one); chain digests land in SimulationResult.cert_digests.
        self.certificates_on = bool(certificates) or bool(bls_certificates)
        #: bls_certificates: False | True | "device". Truthy implies
        #: certificates=True and installs the deterministic BLS committee
        #: keyring on every certifier, so each commit's certificate
        #: carries the 48-byte aggregate signature a light client can
        #: check with no transcript trust. "device" routes the G1
        #: aggregation through the g1_aggregate kernel on ``device``;
        #: True keeps the host fold — digests are identical either way.
        self.bls_certificates = bls_certificates
        self._bls_keyring: "dict | None" = None
        self._bls_device = None
        if str(bls_certificates) == "device":
            from hyperdrive_tpu_torch.ops.fp381 import resolve_device

            self._bls_device = resolve_device(device)
        self.certifiers: list = []
        #: The MPC payload path (BASELINE config 5): every proposed value
        #: carries its (2f+1)-of-n share bundle, validators accept only
        #: that bundle, and every commit reconstructs the payload.
        self.payload_bytes = payload_bytes
        self.dedup_reconstruct = dedup_reconstruct
        self._bundle_cache: dict[Value, bytes] = {}
        self._recon_cache: dict[Value, bytes] = {}
        #: Wall seconds of each commit's reconstruction (the reference's
        #: ``sim.reconstruct.latency`` histogram; no tracer here).
        self.reconstruct_latency: list[float] = []
        if payload_bytes:
            from hyperdrive_tpu_torch.ops.shamir import (
                AdaptiveReconstructor,
                BatchReconstructor,
            )

            self.k = 2 * self.f + 1
            #: Routes host/device by block count: commit-sized batches
            #: (~16 blocks) sit below the provisional crossover and below
            #: calibrate_at, so every commit takes the cached-weight host
            #: leg and launches nothing. ``reconstructor=`` pins a
            #: backend, e.g. BatchReconstructor() for the device program
            #: at every commit. The default's device leg is on ``device``.
            self.reconstructor = (
                reconstructor
                if reconstructor is not None
                else AdaptiveReconstructor(BatchReconstructor(device=device))
            )
            #: Per-replica height -> reconstructed payload bytes.
            self.reconstructed: list[dict[Height, bytes]] = [
                dict() for _ in range(n)
            ]
        self._init_execution(
            execution, exec_speculate, fused_exec_drain, dedup_exec, device
        )
        byz_prop = byzantine_proposer or {}
        byz_val = byzantine_validator or {}
        self.replicas: list[Replica] = [
            self._build_replica(
                i, timeout, timeout_scaling, max_capacity,
                byz_prop.get(i), byz_val.get(i),
                verifier_for(i) if verifier_for else None,
            )
            for i in range(n)
        ]
        if self.epoch_schedule is not None:
            # One retired-identity map for the network: "identity X is
            # stale from height H" is a fact of the key history, not of a
            # replica's own progress, so a laggard still finishing the
            # boundary height keeps accepting the old key below H.
            for r in self.replicas:
                r.retired = self._retired
        self._init_overlay(overlay, sign, device)
        self._init_admission()
        #: Device-resident quorum tallies: behavior-neutral by construction
        #: (counts equal the host counters wherever a TallyView answers).
        self.device_tally = device_tally
        self._tally_check = tally_check
        #: Crossover routing: a settle below this many messages is handled
        #: entirely on the host (host verification + host-counter cascade)
        #: and the grid is poisoned for the slots it bypassed. 0 = never.
        self._fused_min_window = int(fused_min_window)
        #: Router hysteresis window N (0 = off): when >= 95% of the last N
        #: routed settles went to the host, grid upkeep stops until a
        #: device-routed settle rebuilds the grid (claimed fully dirty).
        self._route_hyst_n = int(route_hysteresis)
        if device_tally:
            from hyperdrive_tpu_torch.ops.votegrid import VoteGrid

            # 4 round slots: the happy path plus three retry rounds on
            # device; deeper rounds fall back to the host counters.
            # ``tally_mesh``: shard the grid's validator axis over the
            # mesh's ranks (sharded consensus: every settle's scatter routes
            # rows by global validator index and the counts sum over the
            # mesh before the rule cascade reads them).
            self.vote_grid = VoteGrid(
                n, len(self.signatories), r_slots=4, mesh=tally_mesh,
                device=device,
            )
            self._grid_height = [-1] * n
            self._grid_dirty: list[set] = [set() for _ in range(n)]
            #: Engaged = the grid receives its per-settle upkeep (scatter
            #: bookkeeping, poison marks); _reengage_grid rebuilds it.
            self._grid_engaged = True
            self._route_hist: list = []
            self._route_hyst_thresh = -(-95 * self._route_hyst_n // 100)
            self._sender_pos = {s: v for v, s in enumerate(self.signatories)}
            #: Fused verify + merge + tally: available in shared-superstep
            #: mode when the verifier exposes its batch kernel and its
            #: packer, and the run dedups verification (shared verdicts =
            #: shared merge).
            self._fused_ok = (
                self._shared_mode
                and tally_mesh is None  # the fused launcher is single-device
                and dedup_verify
                and hasattr(bv, "fused_inner")
                and hasattr(getattr(bv, "host", None), "pack")
            )
            if self._fused_ok:
                bv_device = getattr(bv, "device", self.vote_grid.device)
                if bv_device != self.vote_grid.device:
                    raise ValueError(
                        f"the fused settle verifies on the grid's device "
                        f"({self.vote_grid.device}); the batch verifier is "
                        f"on {bv_device}: pass the same device"
                    )
                self.vote_grid.attach_fused(bv.fused_inner)
            # The grid answers the hot quorum queries; the host keeps the
            # logs but skips the derived per-value tally dicts (declined
            # queries fall back to State.count_*'s log scan).
            for r in self.replicas:
                r.proc.host_counts = False
            # Whitelist identity snapshot: a replica whose procs_allowed
            # was replaced can no longer ride the shared merge.
            self._allowed_objs = [r.procs_allowed for r in self.replicas]

    # ------------------------------------------------------------- wiring

    def _default_value(self, height: Height, round_: int) -> Value:
        return hashlib.sha256(
            b"value-%d-%d-%d" % (self.seed, height, round_)
        ).digest()

    def _build_replica(self, i, timeout, scaling, capacity, byz_proposer,
                       byz_validator, verifier) -> Replica:
        keypair = self.ring[i] if self.ring is not None else None
        recipients = range(self.n)

        if self._shared_mode:
            def bcast(msg):
                # ONE queue entry per broadcast (to=-1: all live replicas);
                # the sender attaches its detached signature on the
                # outbound edge.
                if keypair is not None:
                    msg = keypair.sign_message(msg)
                self.queue.append((-1, msg))
        else:
            def bcast(msg):
                # One delivery per recipient, self included.
                if keypair is not None:
                    msg = keypair.sign_message(msg)
                ov = self._overlay
                if ov is not None:
                    # Overlay dissemination: a vote enters the aggregation
                    # tree instead of fanning out n-wide, and the sender's
                    # own copy still rides the queue (recorded like any
                    # delivery). A proposal keeps the all-to-all fan-out
                    # (one a round, nothing to aggregate), verified once
                    # network-wide.
                    if type(msg) is not Propose:
                        self.queue.append((i, msg))
                        ov.on_broadcast(i, msg)
                        return
                    if not ov.verify_propose(msg):
                        return
                self.queue.extend(zip(recipients, repeat(msg, self.n)))

        timer = VirtualTimer(
            _OwnedClock(self.clock, i),
            handler=None,
            timeout=timeout,
            timeout_scaling=scaling,
        )
        caught = self.caught
        proposer = MockProposer(fn=byz_proposer or self._default_value)
        validator = (
            MockValidator(fn=byz_validator)
            if byz_validator
            else MockValidator(ok=True)
        )
        if self.payload_bytes:
            proposer = _PayloadProposer(self, byz_proposer or self._default_value)
            if not byz_validator:
                validator = _PayloadValidator(self)
        if self._execution is not None:
            # The proposed value commits to the height's deterministic tx
            # block (round-independent: retries re-propose the same
            # block), and honest validators accept ONLY that value.
            proposer = MockProposer(fn=byz_proposer or self._exec_value)
            if not byz_validator:
                validator = MockValidator(fn=self._exec_valid)
        certifier = None
        if self.certificates_on:
            from hyperdrive_tpu_torch.certificates import Certifier

            # Bind the batch verifier lazily: its last_transcript is the
            # launch that verified this commit's quorum (b"" on the
            # ladder and host paths).
            bls_keyring = None
            bls_agg_fn = None
            if self.bls_certificates:
                bls_keyring = self._bls_committee_keyring()
                if self._bls_device is not None:
                    bls_agg_fn = self._bls_device_aggregate
            transcript_source = lambda: getattr(  # noqa: E731
                self.batch_verifier, "last_transcript", b""
            )
            if self.epoch_schedule is not None:
                from hyperdrive_tpu_torch.epochs import EpochCertifier

                certifier = EpochCertifier(
                    self.epoch_schedule, transcript_source=transcript_source,
                    obs=self.obs.scoped(i), bls_keyring=bls_keyring,
                    bls_aggregate_fn=bls_agg_fn,
                )
            else:
                certifier = Certifier(
                    list(self.signatories),
                    self.f,
                    transcript_source=transcript_source,
                    obs=self.obs.scoped(i),
                    bls_keyring=bls_keyring,
                    bls_aggregate_fn=bls_agg_fn,
                )
            self.certifiers.append(certifier)
        # Epoch mode: consensus runs under epoch 0's elected committee
        # (its whitelist, quorum and proposer order) while the replica
        # keeps its pool identity; a non-member follows the commits, and
        # everyone's whitelist filters its votes.
        committee = (
            list(self.epoch_schedule.signatories(0))
            if self.epoch_schedule is not None
            else list(self.signatories)
        )
        return Replica(
            ReplicaOptions(
                max_capacity=capacity, external_flush=self.burst,
                batch_ingest=self.batch_ingest, tracer=self.tracer,
                obs=self.obs.scoped(i),
            ),
            self.signatories[i],
            committee,
            timer,
            proposer,
            validator,
            CommitterCallback(on_commit=lambda h, v, i=i: self._on_commit(i, h, v)),
            CatcherCallbacks(
                on_double_propose=lambda a, b, i=i: caught.append(("double_propose", i)),
                on_double_prevote=lambda a, b, i=i: caught.append(("double_prevote", i)),
                on_double_precommit=lambda a, b, i=i: caught.append(("double_precommit", i)),
                on_out_of_turn_propose=lambda p, i=i: caught.append(("out_of_turn", i)),
            ),
            BroadcasterCallbacks(
                on_propose=bcast, on_prevote=bcast, on_precommit=bcast
            ),
            verifier=verifier,
            flusher=(
                self._flusher_for(i, committee)
                if self._flusher_for is not None
                else None
            ),
            certifier=certifier,
        )

    # -------------------------------------------------------- chaos, load

    def _init_chaos(self, chaos, load, burst, delivery_cost) -> None:
        """Open-loop load (``load``, a
        :class:`~hyperdrive_tpu_torch.load.generator.LoadProfile`) and the
        chaos engine (``chaos``, a
        :class:`~hyperdrive_tpu_torch.chaos.plan.FaultPlan`), with their
        refusals (``ValueError``).

        Load arrivals are checked against the virtual clock at every
        delivered vote, and each due arrival re-delivers that vote inline as
        a gossip duplicate, consuming no step, no virtual time and no rng
        draw. Chaos faults draw from a stream of their own (not
        ``self.rng``), so a plan never perturbs the adversaries' draws. The
        checkpoint store and capture set exist without a plan too: replay
        of a chaos record re-derives its victims' checkpoints."""
        from hyperdrive_tpu_torch.utils.checkpoint import CheckpointStore

        self._load = None
        self.load_controller = None
        if load is not None:
            if burst:
                raise ValueError(
                    "open-loop load injects per delivery; use lock-step "
                    "mode (burst=False)"
                )
            if delivery_cost <= 0.0:
                raise ValueError(
                    "load arrivals are scheduled on the virtual clock, and "
                    "without delivery pacing a busy network never advances "
                    "it: pass delivery_cost > 0"
                )
            from hyperdrive_tpu_torch.load.generator import LoadRuntime

            self._load = LoadRuntime(load)
        self._chaos = chaos
        self._chaos_monitor = None
        self._ckpt_store = CheckpointStore()
        self._ckpt_capture: set[int] = set()
        if chaos is None:
            return
        if burst:
            raise ValueError(
                "chaos faults apply per delivery; use lock-step mode "
                "(burst=False)"
            )
        chaos.validate(self.n)
        if chaos.partitions and delivery_cost <= 0.0:
            raise ValueError(
                "partitions are scheduled on the virtual clock, and without "
                "delivery pacing a busy network never advances it: pass "
                "delivery_cost > 0 (the reference harness paces at 1 ms)"
            )
        self._chaos_rng = random.Random((self.seed << 1) ^ 0x43484F53)
        self._chaos_links = {(lf.src, lf.dst): lf for lf in chaos.links}
        self._chaos_parts = [_PartitionRT(p) for p in chaos.partitions]
        self._chaos_crashes = {c.replica: c for c in chaos.crashes}
        self._chaos_restores: dict[int, int] = {}
        self._ckpt_capture = set(self._chaos_crashes)

    def _init_admission(self) -> None:
        """The backpressure spine of a loaded run whose profile has
        ``admission``: one shared controller pinned at the profile's floor
        on the virtual clock (``pin=False`` also has it watch the
        device-work queue's depth and drain latency), and one
        AdmissionGate a replica, so dedup memory stays a local property of
        each ingress."""
        if self._load is None or not self._load.profile.admission:
            return
        from hyperdrive_tpu_torch.load.backpressure import (
            AdmissionGate,
            BackpressureController,
        )

        p = self._load.profile
        ctrl = BackpressureController(
            registry=self.registry,
            obs=self._obs_sim,
            time_fn=lambda: self.clock.now,
        )
        ctrl.floor = p.floor
        if not p.pin and self._sched is not None:
            ctrl.watch(self._sched)
        ctrl.poll()
        self.load_controller = ctrl
        for i, r in enumerate(self.replicas):
            r.admission = AdmissionGate(
                ctrl,
                height_fn=r.current_height,
                registry=self.registry,
                obs=self.obs.scoped(i),
            )

    def overload_snapshot(self) -> dict:
        """Aggregated overload accounting for a loaded run: injected
        duplicates, the network-wide offered/admitted/shed-by-class gate
        counters, and the controller's level and transition count."""
        lr = self._load
        out: dict = {
            "injected": lr.offered if lr is not None else 0,
            #: Vote duplicates injected at un-advanced heights: the storm
            #: fraction the gate must shed.
            "injected_sheddable": lr.sheddable if lr is not None else 0,
            "offered": 0,
            "admitted": 0,
            "shed": {},
            "level": 0,
            "transitions": 0,
        }
        for r in self.replicas:
            gate = r.admission
            if gate is None:
                continue
            snap = gate.snapshot()
            out["offered"] += snap["offered"]
            out["admitted"] += snap["admitted"]
            for cls, v in snap["shed"].items():
                out["shed"][cls] = out["shed"].get(cls, 0) + v
        if self.load_controller is not None:
            out["level"] = self.load_controller.level
            out["transitions"] = self.load_controller.transitions
        return out

    # ------------------------------------------------------------ overlay

    def _check_overlay(self, overlay, epochs, burst, drop_rate, reorder,
                       delivery_cost, verifier_for, load) -> None:
        """The reference's refusals of an overlay run (``ValueError``)."""
        self._overlay = None
        self._overlay_coalesce = False
        if overlay is None:
            return
        if burst:
            raise ValueError(
                "the overlay disseminates per delivery on the shared virtual "
                "clock; use lock-step mode (burst=False)"
            )
        if load is not None:
            raise ValueError(
                "open-loop load injection bypasses the overlay's broadcast "
                "path; run overload and overlay scenarios separately"
            )
        if drop_rate or reorder:
            raise ValueError(
                "the seeded drop/reorder adversary acts on the raw queue and "
                "would desynchronize frame bookkeeping; use link faults "
                "with the overlay instead"
            )
        if delivery_cost <= 0.0:
            raise ValueError(
                "overlay level windows ride the virtual clock, and without "
                "delivery pacing a busy network never advances it: pass "
                "delivery_cost > 0"
            )
        if verifier_for is not None:
            raise ValueError(
                "overlay runs verify once at the dissemination layer "
                "(replicas get verifier=None); per-replica verifier_for "
                "would re-verify every constituent"
            )
        if epochs is not None and (epochs.committee_size or self.n) != self.n:
            raise ValueError(
                "overlay coverage masks index validator slots 1:1 with "
                "replicas; partial committees are not supported "
                "(committee_size must equal n)"
            )
        overlay.validate(self.n)

    def _init_overlay(self, overlay, sign, device) -> None:
        """Wire the aggregation overlay (:mod:`hyperdrive_tpu_torch.
        overlay`): votes travel a seeded binomial tree as partial-aggregate
        frames. A signed run verifies each vote once network-wide through
        one shared verifier behind the device-work queue: a
        ``TorchBatchVerifier`` on the card, a ``HostVerifier`` with
        ``device="cpu"``. ``bls_partials`` merges go through a
        ``G1SumLauncher`` on ``device`` behind the queue (one is made if
        none was passed); only a CPU run without ``devsched`` folds on the
        host. Aggregates and digests are the same either way."""
        if overlay is None:
            return
        from hyperdrive_tpu_torch.devsched.queue import DeviceWorkQueue
        from hyperdrive_tpu_torch.ops.merkle import resolve_device
        from hyperdrive_tpu_torch.overlay import OverlayRuntime

        # Only a signed or bls_partials run has device work: an unsigned
        # overlay resolves no device.
        dev = None
        verifier = None
        ov_sched = None
        ov_bls_keyring = None
        if getattr(overlay, "bls_partials", False):
            dev = resolve_device(device)
            ov_bls_keyring = self._bls_committee_keyring()
            ov_sched = self._sched
            if ov_sched is None and dev.type != "cpu":
                ov_sched = self._sched = DeviceWorkQueue()
        if sign:
            dev = resolve_device(device)
            verifier = _lockstep_verifier(dev)
            ov_sched = self._sched
            if ov_sched is None:
                ov_sched = self._sched = DeviceWorkQueue()
        if self.epoch_schedule is not None:
            anchor = self.epoch_schedule.anchor(0)
        else:
            from hyperdrive_tpu_torch.epochs import genesis_anchor

            anchor = genesis_anchor(self.seed)
        self._overlay_coalesce = overlay.coalesce_ingest
        self._overlay = OverlayRuntime(
            overlay,
            n=self.n,
            seed=self.seed,
            anchor=anchor,
            identities=list(self._identity),
            quorum=2 * self.f + 1,
            delivery_cost=self.delivery_cost,
            enqueue=lambda to, fr: self.queue.append((to, fr)),
            schedule=self.clock.schedule,
            now=lambda: self.clock.now,
            deliver=self._overlay_deliver,
            alive=self.alive,
            order_pos=self._order_pos,
            retired=self._retired,
            verifier=verifier,
            sched=ov_sched,
            obs=self.obs if self._obs_sim is not _OBS_NULL else None,
            registry=self.registry,
            bls_keyring=ov_bls_keyring,
            device=dev,
        )

    def overlay_snapshot(self) -> dict:
        """The overlay runtime's accounting: frames by kind, verify rows,
        scores and demotions, the topology digest."""
        if self._overlay is None:
            raise ValueError("overlay_snapshot() on a run without overlay=")
        return self._overlay.snapshot()

    def _overlay_blocked(self, frame, to: int) -> bool:
        """Chaos faults for overlay frames: partitions block on the
        (contributor, receiver) pair exactly as :meth:`_chaos_deliver`
        blocks vote senders; link faults apply their drop rate (duplication
        and delay stay vote-only: frame bookkeeping is idempotent, but the
        clock cost of a ghost frame is not)."""
        src = frame.src
        for p in self._chaos_parts:
            if p.engaged and p.blocks(src, to):
                return True
        lf = self._chaos_links.get((src, to))
        if lf is not None and lf.drop and self._chaos_rng.random() < lf.drop:
            return True
        return False

    def _overlay_deliver(self, to: int, votes) -> None:
        """Constituent votes reaching replica ``to`` from one overlay
        frame, recorded as plain ``(to, vote)`` tuples (replay is
        record-driven and never rebuilds the overlay), and handled one by
        one or, with ``coalesce_ingest``, through one
        ``handle_coalesced`` call."""
        if not self.alive[to] or not votes:
            return
        rec = self.record.messages if self._record_on else _DISCARD
        r = self.replicas[to]
        for v in votes:
            rec.append((to, v))
        if self._overlay_coalesce and len(votes) > 1:
            r.handle_coalesced(votes)
        else:
            for v in votes:
                r.handle(v)
        if to in self._ckpt_capture:
            self._ckpt_store.save(to, r.proc)

    # ----------------------------------------------------- laggard sweep

    def _laggard_sweep(self, steps: int) -> None:
        """Laggard catch-up on a timer: every ``catchup_every`` steps, jump
        each alive replica more than ``catchup_lag`` heights below the
        network's working height to an active join of it (the reference's
        application-driven catch-up, replica/replica.go:222-235). The
        overlay prunes slots at the commit floor, so a replica that misses
        a quorum while the rest move on is stranded, and in lock-step
        delivery its round timeout cannot fire while the busy majority
        keeps the queue full. Runs at the end of every chaos tick, and on
        overlay frame and tick deliveries of a run without chaos; each
        resync is recorded as an ``OP_RESYNC`` lifecycle op, so replay needs
        no cadence."""
        if steps % self._catchup_every == 0:
            net = self._net_height()
            if net > self._catchup_lag + 1:
                self._resync(net, lag=self._catchup_lag)

    def _net_height(self) -> Height:
        """The network's next height: one past the best commit any replica
        has recorded (the resync target)."""
        best = 0
        for c in self.commits:
            if c:
                m = max(c)
                if m > best:
                    best = m
        return best + 1

    def _resync(self, target: Height, lag: int = 0) -> int:
        """Jump every alive replica more than ``lag`` heights below
        ``target`` to an active join of it: the ResetHeight carries the
        signatory set, so the replica starts round 0 there (arming its
        propose timeout, or proposing). Equivocation-free: a replica below
        the target never voted at it."""
        sigs = self._resync_sigs(target)
        resynced = 0
        for i in range(self.n):
            r = self.replicas[i]
            if self.alive[i] and target - r.proc.current_height > lag:
                self._note_lifecycle(ScenarioRecord.OP_RESYNC, i, target)
                self._apply_epoch_state(i, target)
                r.handle(ResetHeight(height=target, signatories=sigs))
                resynced += 1
        return resynced

    def _note_lifecycle(self, kind: int, replica: int, aux: int) -> None:
        if self._record_on:
            self.record.lifecycle.append(
                (kind, len(self.record.messages), replica, aux)
            )

    def _replay_lifecycle(self, op: tuple) -> None:
        """Replay one recorded crash, restore or resync operation."""
        kind, _, replica, aux = op
        if kind == ScenarioRecord.OP_CRASH:
            self.alive[replica] = False
        elif kind == ScenarioRecord.OP_RESTORE:
            self._apply_restore(replica, aux)
        else:  # OP_RESYNC
            self._apply_epoch_state(replica, aux)
            self.replicas[replica].handle(
                ResetHeight(height=aux, signatories=self._resync_sigs(aux))
            )

    # ---------------------------------------------------------------- chaos

    def _chaos_tick(self, steps: int) -> None:
        """Advance the FaultPlan's schedule: engage and heal partitions by
        virtual time, crash and restore replicas by delivery step; then the
        laggard sweep."""
        now = self.clock.now
        for p in self._chaos_parts:
            if not p.engaged and not p.healed and now >= p.spec.at:
                p.engaged = True
                if self._obs_sim is not _OBS_NULL:
                    self._obs_sim.emit("chaos.partition", -1, -1, len(p.gid))
            if p.engaged and now >= p.spec.heal:
                p.engaged = False
                p.healed = True
                self._chaos_heal(p)
        for victim, c in list(self._chaos_crashes.items()):
            if steps >= c.crash_at_step:
                del self._chaos_crashes[victim]
                if not self.alive[victim]:
                    continue
                self.alive[victim] = False
                # Unlike kill_at_step's permanent kills, the victim STAYS
                # in _pending_replicas: a restart is scheduled, so the run
                # must not complete while it is down.
                self._chaos_restores[victim] = steps + c.restart_after_steps
                self._note_lifecycle(ScenarioRecord.OP_CRASH, victim, 0)
                if self._obs_sim is not _OBS_NULL:
                    self._obs_sim.emit("chaos.crash", -1, -1, victim)
                m = self._chaos_monitor
                if m is not None:
                    m.note_crash(victim, now)
        for victim, due in list(self._chaos_restores.items()):
            if steps >= due:
                del self._chaos_restores[victim]
                target = self._net_height()
                self._note_lifecycle(ScenarioRecord.OP_RESTORE, victim, target)
                self._apply_restore(victim, target)
                if self._obs_sim is not _OBS_NULL:
                    self._obs_sim.emit("chaos.restore", -1, -1, victim)
                m = self._chaos_monitor
                if m is not None:
                    m.note_restore(victim, target)
        self._laggard_sweep(steps)

    def _chaos_deliver(self, to: int, msg):
        """Apply the fault plan to one pending delivery. Returns the message
        to deliver, or None when a fault swallowed it (dropped, blocked by
        an engaged partition, or deferred on the clock). Timeouts are local
        events, never faulted. The chaos stream draws once a fault check, in
        the order drop, duplicate, delay. Delayed and duplicated copies ride
        a :class:`_ChaosEnvelope`, so they are never faulted again, though
        partitions still apply at their eventual delivery."""
        if isinstance(msg, Timeout):
            return msg
        immune = type(msg) is _ChaosEnvelope
        if immune:
            msg = msg.msg
        src = self._order_pos.get(getattr(msg, "sender", None))
        for p in self._chaos_parts:
            if p.engaged and src is not None and p.blocks(src, to):
                return None
        if immune or src is None:
            return msg
        lf = self._chaos_links.get((src, to))
        if lf is None:
            return msg
        rng = self._chaos_rng
        if lf.drop and rng.random() < lf.drop:
            return None
        if lf.duplicate and rng.random() < lf.duplicate:
            self.queue.append((to, _ChaosEnvelope(msg)))
        if lf.delay and rng.random() < lf.delay:
            self.clock.schedule(
                rng.uniform(lf.delay_min, lf.delay_max), _ChaosEnvelope(msg), to
            )
            return None
        return msg

    def _chaos_heal(self, p: "_PartitionRT") -> None:
        """A partition healed: tell the monitor, then (``resync_on_heal``)
        jump every alive laggard to an active join of the network's working
        height. The protocol has no retransmission, so what a replica missed
        while cut off is gone for good (the reference's catch-up path,
        replica/replica.go:222-235)."""
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit("chaos.heal", -1, -1, len(p.gid))
        m = self._chaos_monitor
        if m is not None:
            m.note_heal(self.clock.now)
        if p.spec.resync_on_heal:
            self._resync(self._net_height())

    def _chaos_rescue(self, steps: int) -> bool:
        """The delivery queue and the virtual clock drained mid-run. Both
        chaos timelines are delivery-driven, so a deadlocked network would
        freeze the plan's remaining schedule: jump to the next scheduled
        event (the nearest partition boundary in virtual time, then a
        step-scheduled crash or restore pulled to the present) and re-tick;
        with no schedule left, resync stranded laggards. Returns True when
        anything was applied. Every rescue consumes schedule or raises a
        height, so a run that cannot progress still stops. Its lifecycle
        ops carry the current record position like any other."""
        if self._chaos is None:
            return False
        boundary = None
        for p in self._chaos_parts:
            if p.healed:
                continue
            b = p.spec.heal if p.engaged else p.spec.at
            if boundary is None or b < boundary:
                boundary = b
        if boundary is not None:
            if boundary > self.clock.now:
                self.clock.now = boundary
            self._chaos_tick(steps)
            return True
        if self._chaos_crashes:
            victim = min(
                self._chaos_crashes,
                key=lambda v: self._chaos_crashes[v].crash_at_step,
            )
            c = self._chaos_crashes[victim]
            if c.crash_at_step > steps:
                self._chaos_crashes[victim] = replace(c, crash_at_step=steps)
            self._chaos_tick(steps)
            return True
        if self._chaos_restores:
            victim = min(self._chaos_restores, key=self._chaos_restores.get)
            if self._chaos_restores[victim] > steps:
                self._chaos_restores[victim] = steps
            self._chaos_tick(steps)
            return True
        return self._resync(self._net_height()) > 0

    def _apply_restore(self, victim: int, net_height: Height) -> None:
        """The revive path, shared by the live chaos engine and replay:
        restore the Process from the victim's latest checkpoint (None: it
        crashed before its first one, so genesis state), then rejoin.

        If the network has committed past the checkpoint (``net_height``,
        its working height at restore time, is above the victim's), the
        victim makes an active join of it through a signatory-carrying
        ResetHeight, as a heal resync does; otherwise
        :meth:`~hyperdrive_tpu_torch.process.Process.resume` re-arms the
        current step's timeout in place and broadcasts nothing, so the
        restored locked and valid values steer its next votes. Epoch state
        is applied first in both branches. Both are functions of the
        restored state and ``net_height``, which replay reproduces."""
        r = self.replicas[victim]
        r.restore(self._ckpt_store.latest(victim))
        self.alive[victim] = True
        if net_height > r.proc.current_height:
            self._apply_epoch_state(victim, net_height)
            r.handle(
                ResetHeight(
                    height=net_height, signatories=self._resync_sigs(net_height)
                )
            )
        else:
            # The checkpoint's identity may predate a rotation that happened
            # while the victim was down (epoch mode).
            self._apply_epoch_state(victim, r.proc.current_height)
            r.proc.resume()
        if not any(h >= self.target_height for h in self.commits[victim]):
            self._pending_replicas.add(victim)

    # -------------------------------------------------- BLS certificates

    def _bls_committee_keyring(self) -> dict:
        """The shared committee keyring (identity -> BlsKeyPair), derived
        deterministically from signatory identities and built once — all
        certifiers alias one dict, exactly like the Ed25519 KeyRing."""
        if self._bls_keyring is None:
            from hyperdrive_tpu_torch.crypto import bls

            ids = (
                self.epoch_schedule.signatories(0)
                if self.epoch_schedule is not None
                else self.signatories
            )
            self._bls_keyring = {s: bls.bls_keypair_from_identity(s) for s in ids}
        return self._bls_keyring

    def _bls_device_aggregate(self, partials):
        """Certifier aggregation backend on the ``g1_aggregate`` kernel
        (the plain version on a CPU device). Launch width is the committee
        size rounded up to a power of two, so every commit — whatever its
        quorum count — launches one shape."""
        from hyperdrive_tpu_torch.ops import g1

        width = 1
        while width < max(len(self.signatories), 1):
            width *= 2
        return g1.aggregate_points(partials, width=width, device=self._bls_device)

    # -------------------------------------------------------------- running

    def _on_commit(self, i: int, height: Height, value: Value):
        if self._spec_inflight:
            # Pipelined finalize ordering: the commit rests on windows whose
            # verification is still in flight — buffer it (in commit order)
            # until the covering drain confirms the speculation. The replica
            # itself proceeds into the next height; only the external
            # commit effects wait. A mismatch raises out of the drain before
            # any gated commit is finalized.
            self._gated_commits.append((i, height, value, self._spec_last_fut))
            if self._obs_sim is not _OBS_NULL:
                self._obs_sim.emit("sched.gated", height, -1, i)
            return (0, None)
        self.commits[i][height] = (
            self._exec_extend(i, height, value) if self.executors else value
        )
        if self.payload_bytes:
            self._reconstruct_commit(i, height, value)
        if self._overlay is not None:
            # Slots below height - 1 can no longer change any replica: the
            # laggard sweep resyncs a replica left behind (no
            # retransmission).
            self._overlay.note_commit(height)
        if height >= self.target_height:
            self._pending_replicas.discard(i)
        if (
            self.epoch_schedule is not None
            and self.epoch_schedule.is_boundary(height)
        ):
            return self._epoch_advance(i, height, value)
        return (0, None)

    # ------------------------------------------------------------- epochs

    def _init_epochs(self, epochs, signatories, sign, burst,
                     payload_bytes) -> None:
        """Dynamic validator sets: the schedule, the generation-0 pool
        identities (``self.signatories``, what records carry), each
        replica's CURRENT identity (``_identity``; rekeys replace it) and
        the retired-identity map (identity -> first height its votes are
        stale), which every replica shares."""
        self.epoch_schedule = None
        self.epoch = 0
        self._identity = list(self.signatories)
        self._retired: dict = {}
        #: The epoch each replica last switched to (for its epoch.switch
        #: event).
        self._replica_epoch = [0] * self.n
        if epochs is None:
            return
        if burst:
            raise ValueError(
                "epochs advance on lock-step boundary commits; use "
                "burst=False (the settle layer rotates per-launch table "
                "generations instead)"
            )
        if sign:
            raise ValueError(
                "epochs derive identities per (index, generation); the "
                "deterministic keyring has no generation axis — run epoch "
                "scenarios unsigned"
            )
        if payload_bytes:
            raise ValueError(
                "payload reconstruction pins k = 2f+1 at construction; "
                "epoch-rotated thresholds are not supported on the "
                "payload path"
            )
        from hyperdrive_tpu_torch.epochs import EpochSchedule, default_signatory

        n = self.n
        stakes = tuple(epochs.stakes) or (1,) * n
        if len(stakes) != n:
            raise ValueError(
                f"epochs.stakes has {len(stakes)} entries for {n} replicas"
            )
        ns = b"sim-%d" % self.seed

        def sig_fn(idx, gen):
            return default_signatory(idx, gen, namespace=ns)

        self.epoch_schedule = EpochSchedule(
            stakes,
            epochs.committee_size or n,
            epochs.epoch_length,
            epochs.seed or self.seed,
            rekey_per_epoch=epochs.rekey_per_epoch,
            signatory_fn=sig_fn,
        )
        derived = [sig_fn(i, 0) for i in range(n)]
        if signatories is not None and list(signatories) != derived:
            raise ValueError(
                "epochs derive identities from the schedule's signatory "
                "function; a signatories override that differs would "
                "desynchronize elections (replay an epoch dump with the "
                "same seed instead)"
            )
        self.signatories = derived
        self._identity = list(derived)
        self.record.epochs = (
            int(epochs.epoch_length),
            int(epochs.committee_size or n),
            int(epochs.rekey_per_epoch),
            int(epochs.seed or self.seed),
            stakes,
        )

    def _epoch_advance(self, i: int, height: Height, value: Value):
        """Replica ``i`` committed an epoch boundary: fetch (or compute)
        the deterministic transition, install its network-level effects
        once (the first committer; a different value at the same boundary
        trips the schedule's fork check), and hand the Process its
        next-height committee: the returned ``(f, scheduler)`` flows
        through the commit seam into ``start_round(0)`` of ``height + 1``."""
        stakes = None
        if self.executors:
            # Stake-driven election: the ledger's stake column at the
            # boundary height (this replica's executor applied the boundary
            # block in _exec_extend), the same in every replica that
            # committed the same heights.
            stakes = self.executors[i].election_stakes(self.n)
            sched = self.epoch_schedule
            if (
                self._obs_sim is not _OBS_NULL
                and sched.epoch_of(height) + 1 > sched.latest_epoch
            ):
                self._obs_sim.emit(
                    "exec.stake", height, -1,
                    "e%d min=%d max=%d" % (
                        sched.epoch_of(height) + 1, min(stakes), max(stakes),
                    ),
                )
        tr = self.epoch_schedule.transition_at(height, value, stakes=stakes)
        if tr.epoch > self.epoch:
            self._epoch_install(tr, height)
        r = self.replicas[i]
        sigs = list(tr.signatories)
        r.procs_allowed = set(sigs)
        for s in sigs:
            r.mq.order_of(s)
        # The replica's own identity may have rotated in this transition.
        r.proc.whoami = self._identity[i]
        if self._replica_epoch[i] != tr.epoch:
            self._replica_epoch[i] = tr.epoch
            if r.obs is not _OBS_NULL:
                r.obs.emit("epoch.switch", height, -1, tr.epoch)
        if self.certifiers and self.certifiers[i].epoch != tr.epoch:
            # EpochCertifier.observe_commit normally rotated itself at this
            # boundary already.
            self.certifiers[i].rotate_to(tr.epoch)
        return len(sigs) // 3, RoundRobin(sigs)

    def _epoch_install(self, tr, height: Height) -> None:
        """One-time effects of a transition: rotated identities become
        current (the pool member signs with the new key from ``height +
        1``), and retired identities enter the shared stale-vote map."""
        new_by_index = {v.index: v.signatory for v in tr.committee}
        for idx, old in zip(tr.rekeyed, tr.retired):
            fresh = new_by_index[idx]
            self._identity[idx] = fresh
            self._order_pos[fresh] = idx
            self._retired[old] = height + 1
        self.epoch = tr.epoch
        if self._overlay is not None:
            # Churn re-keys tree positions: the next epoch's tree hangs off
            # the boundary-chained anchor and the rotated identity set.
            self._overlay.rekey(
                self.epoch_schedule.anchor(tr.epoch), list(self._identity),
                tr.epoch,
            )
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit(
                "epoch.elect", height, -1,
                "e%d j%d l%d r%d" % (
                    tr.epoch, len(tr.joined), len(tr.left), len(tr.rekeyed),
                ),
            )
            self._obs_sim.emit("epoch.begin", height + 1, -1, tr.epoch)

    def _resync_sigs(self, target: Height) -> tuple:
        """The signatory set a ResetHeight to ``target`` carries: the
        committee of ``target``'s epoch (clamped to the latest elected:
        the schedule cannot see past the last committed boundary), or the
        static whitelist outside epoch mode."""
        sched = self.epoch_schedule
        if sched is None:
            return tuple(self.signatories)
        e = min(sched.latest_epoch, sched.epoch_of(target))
        return sched.signatories(e)

    def _apply_epoch_state(self, i: int, target: Height) -> None:
        """Epoch effects of a resync to ``target`` that the ResetHeight
        cannot carry: the replica's own (possibly rotated) identity and its
        certifier's committee. Runs BEFORE the ResetHeight is handled:
        round 0 at the target may make this replica the proposer, and it
        must propose under its current key."""
        sched = self.epoch_schedule
        if sched is None:
            return
        e = min(sched.latest_epoch, sched.epoch_of(target))
        r = self.replicas[i]
        r.proc.whoami = self._identity[i]
        if self.certifiers and self.certifiers[i].epoch != e:
            self.certifiers[i].rotate_to(e)
        if self._replica_epoch[i] != e:
            self._replica_epoch[i] = e
            if r.obs is not _OBS_NULL:
                r.obs.emit("epoch.switch", target, -1, e)

    def _on_sched_drain(self, resolved: int) -> None:
        """Queue drain hook: every in-flight speculative settle just
        resolved (mismatches raise out of the drain itself), so gated
        commits are confirmed — finalize them in commit order."""
        self._spec_inflight = 0
        self._spec_rows = 0
        self._spec_last_fut = None
        if self._exec_speculate:
            # The drain just resolved every exec speculation it covered:
            # confirm any still-open exact windows so the gated finalizes
            # below read settled roots, then close the speculation epoch
            # (the block cache may evict the window's columns from here
            # on: rollbacks can no longer replay them).
            for ex in self._exec_unique:
                ex.confirm_to(ex.height)
            self._exec_source.spec_epoch += 1
        gated = self._gated_commits
        self._gated_commits = []
        for i, height, value, fut in gated:
            # The covering drain resolved the height's exec mask, so the
            # executor can apply the block and extend the record.
            if self.executors:
                value = self._exec_extend(i, height, value)
            self.commits[i][height] = value
            if (
                self._obs_sim is not _OBS_NULL
                and fut is not None
                and fut.launch_id is not None
            ):
                # Close the cross-layer loop on the replica's own track:
                # this commit finalized because that coalesced launch
                # confirmed its speculation (the Perfetto exporter draws
                # the drain -> commit flow arrow from this event).
                self.obs.emit(
                    "sched.launch.commit", i, height, -1, fut.launch_id
                )
            if height >= self.target_height:
                self._pending_replicas.discard(i)

    def metrics_snapshot(self) -> dict:
        """The run's metrics-registry snapshot (obs/metrics.py), with the
        tracer's counters and histograms folded in. On the virtual clock
        everything in it is deterministic: two fixed-seed runs snapshot
        to identical bytes (``self.registry.digest()``)."""
        self.registry.absorb_tracer(self.tracer)
        if self._obs_sim is not _OBS_NULL:
            # Flight-recorder health rides the same snapshot: a journal
            # that overwrote its oldest events would otherwise present a
            # truncated anatomy as a complete one.
            self.registry.set_gauge("obs.recorder.dropped", self.obs.dropped)
            self.registry.set_gauge("obs.recorder.capacity", self.obs.capacity)
            self.registry.set_gauge("obs.recorder.total", self.obs.total)
        gates = [r.admission for r in self.replicas
                 if getattr(r, "admission", None) is not None]
        if gates:
            # Admission-gate health: distinct peers charged sheds, and
            # signers reputation-demoted right now.
            demoted: set = set()
            peers_shed = 0
            for g in gates:
                peers_shed += len(g.shed_by_peer)
                if g.reputation is not None:
                    demoted |= g.reputation.demoted
            self.registry.set_gauge("admission.shed_peers", peers_shed)
            self.registry.set_gauge(
                "admission.reputation.demoted", len(demoted)
            )
        snap = self.registry.snapshot()
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit(
                "metrics.snapshot", -1, -1,
                len(snap["counters"]) + len(snap["histograms"]),
            )
        return snap

    # ---------------------------------------------------------- execution

    def _init_execution(self, execution, exec_speculate, fused_exec_drain,
                        dedup_exec, device) -> None:
        """Execution-layer wiring: the block source, the executors (one,
        shared, with ``dedup_exec``; else one per replica), speculation
        and the exec launcher of a ``sign_txs`` run."""
        self.executors: list = []
        self._execution = None
        self._exec_source = None
        self._exec_masks: dict = {}
        #: Heights whose exec work (speculation, signature rows) was
        #: started at their first proposal.
        self._exec_proposed: set = set()
        self._exec_launcher = None
        #: A sequential sign_txs run's block verifier (the sim's batch
        #: verifier), and the last height whose mask it has filled.
        self._exec_verifier = None
        self._exec_masked_to = 0
        #: Unique executor objects (dedup_exec aliases one across all
        #: replicas) — the speculate/resolve fan-out target.
        self._exec_unique: list = []
        self._exec_spec_heights: set = set()
        self._exec_speculate = False
        self._exec_fused = False
        if execution is None:
            if exec_speculate or fused_exec_drain or dedup_exec:
                raise ValueError(
                    "exec_speculate/fused_exec_drain/dedup_exec require "
                    "execution="
                )
            return
        if self.payload_bytes:
            raise ValueError(
                "execution blocks and MPC payload bundles both define the "
                "proposed value's content; run one content layer at a time"
            )
        if self._load is not None:
            raise ValueError(
                "open-loop load re-injects recorded votes with no block "
                "content; run load and execution separately"
            )
        import dataclasses

        from hyperdrive_tpu_torch.exec.ledger import BlockSource, HostLedgerExecutor
        from hyperdrive_tpu_torch.ops.merkle import resolve_device

        # The execution layer is an entry point: on the card unless the
        # caller asks for the CPU, whichever executor the config picks.
        dev = resolve_device(device)
        n = self.n
        cfg = execution
        if cfg.stake_accounts == 0 and cfg.stake_every > 0:
            if cfg.accounts < n:
                raise ValueError(
                    f"execution.accounts={cfg.accounts} cannot host {n} "
                    "validator stake accounts (accounts 0..n-1)"
                )
            cfg = dataclasses.replace(cfg, stake_accounts=n)
        self._execution = cfg
        self.record.execution = cfg.as_ints()
        self._exec_source = BlockSource(cfg)
        genesis_stakes = (
            self.epoch_schedule.stakes if self.epoch_schedule is not None else ()
        )
        kwargs = dict(source=self._exec_source, masks=self._exec_masks)
        exec_cls = HostLedgerExecutor
        if cfg.device:
            from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor

            exec_cls = DeviceLedgerExecutor
            kwargs["device"] = dev
        #: Executor dedup (pipelined default): executors are pure
        #: functions of the committed height sequence, so in a run where
        #: every replica commits every height the n per-replica ledgers
        #: are n identical recomputations — alias ONE executor across all
        #: replicas and a height's block is applied once per network.
        if dedup_exec is None:
            dedup_exec = self._pipeline_heights
        observe = self._obs_sim is not _OBS_NULL
        self._exec_unique = [
            exec_cls(
                cfg, genesis_stakes,
                obs=self.obs.scoped(i) if observe else _OBS_NULL, **kwargs,
            )
            for i in range(1 if dedup_exec else n)
        ]
        self.executors = (
            self._exec_unique * n if dedup_exec else list(self._exec_unique)
        )
        #: Speculative execution: apply height h's block at PROPOSE time
        #: under the well-formedness guess while its verify launch is in
        #: flight; the exec future's resolution confirms or rolls back,
        #: and commit finalize reads the already-settled root. Default: on
        #: exactly when the run pipelines heights.
        if exec_speculate is None:
            exec_speculate = self._pipeline_heights
        elif exec_speculate and self._sched is None:
            raise ValueError(
                "exec_speculate resolves speculation at queue drains — "
                "wire a devsched (pipeline_heights=True or devsched=)"
            )
        self._exec_speculate = bool(exec_speculate)
        if cfg.sign_txs and self._sched is not None:
            #: Fused drain: the block's tx-signature triples go through the
            #: SAME memoized launcher that carries the vote verifies, so one
            #: drain cycle issues ONE launch for votes + exec rows. The
            #: two-kind path (ExecApplyLauncher, its own launch per drain)
            #: is the comparison baseline.
            if fused_exec_drain is None:
                fused_exec_drain = self._pipeline_heights
            self._exec_fused = bool(fused_exec_drain)
            if self._exec_fused:
                if self.batch_verifier is None:
                    raise ValueError(
                        "fused_exec_drain coalesces exec rows into the vote "
                        "verify launch: it needs a batch_verifier (burst mode)"
                    )
                self._exec_launcher = self._sched.verify_launcher(
                    self.batch_verifier
                )
            else:
                from hyperdrive_tpu_torch.exec.ledger import ExecApplyLauncher

                # A lock-step run has no batch verifier: the blocks' own
                # launcher verifies on ``device``.
                bv = self.batch_verifier
                if bv is None:
                    bv = _lockstep_verifier(dev)
                self._exec_launcher = ExecApplyLauncher(bv)
        elif fused_exec_drain:
            raise ValueError(
                "fused_exec_drain requires sign_txs execution and a devsched "
                "queue"
            )
        if self.epoch_schedule is not None:
            if cfg.accounts < n:
                raise ValueError(
                    f"execution.accounts={cfg.accounts} < n={n}: epoch "
                    "elections read stake accounts 0..n-1"
                )
            # The stake oracle: one extra HOST executor bound to the
            # schedule's stake_source, so the first path to mint a
            # boundary transition (EpochCertifier.observe_commit, inside
            # the replica's commit and before this sim's commit seam)
            # already elects from committed ledger state. A host class
            # whatever the replicas run: device roots equal host roots,
            # so it is digest-neutral.
            oracle = HostLedgerExecutor(
                cfg, genesis_stakes, source=self._exec_source,
                masks=self._exec_masks,
            )
            self._exec_oracle = oracle

            def stake_source(height, _o=oracle, _n=n):
                _o.advance_to(height)
                return _o.election_stakes(_n)

            self.epoch_schedule.stake_source = stake_source
        if cfg.sign_txs and self._exec_launcher is None:
            # Sequential sign_txs: each committed height's block is
            # verified ONCE, through the batch verifier (on the card by
            # default), before any executor applies it; the executors
            # read the verdicts from ``_exec_masks``. (The reference
            # leaves it to each executor's own host verifier: n
            # verifications of every block on the CPU without dedup.)
            self._exec_verifier = self.batch_verifier
            if self._exec_verifier is None:
                from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

                self._exec_verifier = TorchBatchVerifier(device=dev)

    def _exec_value(self, height: Height, round_: int) -> Value:
        """Proposal value in execution mode: commits to the height's
        deterministic tx block. The first proposal of a sign_txs height
        also submits the block's signature triples through the device
        queue (fused into the vote launcher or as an ``exec.apply``
        command), resolving the admission mask into ``_exec_masks``.

        With ``exec_speculate`` the height is also APPLIED here, under the
        well-formedness guess, while that launch is in flight: the
        future's resolution confirms the guess or rolls the executor back
        and re-applies under the true mask, so by the time the covering
        drain finalizes the gated commit the root is settled (a
        rolled-back root can never reach a commit record)."""
        if (
            (self._exec_launcher is not None or self._exec_speculate)
            and height not in self._exec_proposed
        ):
            self._exec_proposed.add(height)
            items = guess = None
            if self._execution.sign_txs:
                blk = self._exec_source.block(height)
                items = self._exec_source.sig_items(blk)
                guess = [
                    s is not None and len(s) == 64 and len(p) == 32
                    for (p, _, s) in items
                ]
            # Heights past the target are proposed (the pipeline runs
            # ahead) but never finalized — don't burn an apply on them.
            if self._exec_speculate and height <= self.target_height:
                self._exec_spec_heights.add(height)
                for ex in self._exec_unique:
                    ex.speculate(height, guess)
            if items is not None and self._exec_launcher is not None:
                if self._exec_fused:
                    # Fused rows count toward the row-aware slot close
                    # (_settle_speculative's would_spill check).
                    self._spec_rows += len(items)
                from hyperdrive_tpu_torch.exec.ledger import EXEC_ORIGIN

                def _resolve(f, h=height):
                    mask = [bool(b) for b in f.result()]
                    self._exec_masks.setdefault(h, mask)
                    if h in self._exec_spec_heights:
                        for ex in self._exec_unique:
                            ex.resolve(h, mask)

                # The callback goes in with the command: if this submit
                # auto-drains, _on_sched_drain confirms every window, and
                # the height must be resolved by then. (The reference
                # attaches it after submit returns, and then raises in
                # confirm_to.)
                self._sched.submit(
                    self._exec_launcher, items,
                    origin=EXEC_ORIGIN, rows=len(items), callback=_resolve,
                )
        return self._exec_source.value(height)

    def _exec_valid(self, height: Height, round_: int, value: Value) -> bool:
        return value == self._exec_source.value(height)

    def _exec_extend(self, i: int, height: Height, value: Value) -> Value:
        """The external commit record in execution mode: the agreed value
        extended with replica ``i``'s chained state root after applying
        every block up to ``height``. Votes and certificates keep the raw
        32-byte value; the extension is what ``commits`` and
        ``commit_digest`` cover, so two runs agree end to end only if
        their ledgers do."""
        if self._exec_verifier is not None:
            self._verify_exec_blocks(height)
        return value + self.executors[i].advance_to(height)

    def _verify_exec_blocks(self, height: Height) -> None:
        """Fill ``_exec_masks`` up to ``height`` in a sequential sign_txs
        run: one batch-verifier call a block. The verifier's
        ``last_transcript`` is kept as it was, since a certificate binds
        the launch that verified its quorum, not a block's."""
        bv = self._exec_verifier
        while self._exec_masked_to < height:
            h = self._exec_masked_to + 1
            if h not in self._exec_masks:
                items = self._exec_source.sig_items(self._exec_source.block(h))
                transcript = getattr(bv, "last_transcript", None)
                mask = bv.verify_signatures(items)
                if transcript is not None:
                    bv.last_transcript = transcript
                self._exec_masks[h] = [bool(b) for b in mask]
            self._exec_masked_to = h

    # ---------------------------------------------------- payload (config 5)

    def _payload_for_value(self, value: Value) -> bytes:
        """The deterministic payload a value commits to: a SHA-256 stream
        keyed by (seed, value), expanded to ``payload_bytes``."""
        out = bytearray()
        counter = 0
        while len(out) < self.payload_bytes:
            out += hashlib.sha256(
                b"payload-%d-" % self.seed + value + counter.to_bytes(4, "little")
            ).digest()
            counter += 1
        return bytes(out[: self.payload_bytes])

    def _bundle_for_value(self, value: Value) -> bytes:
        """The encoded (2f+1)-of-n share bundle for a value's payload.
        Deterministic (tagged by the value), so every replica — proposer,
        validator, re-proposer — derives the identical bundle; cached
        because splitting is the expensive host-side step."""
        bundle = self._bundle_cache.get(value)
        if bundle is None:
            from hyperdrive_tpu_torch.crypto import shamir as host_shamir

            blocks = host_shamir.split_payload(
                self._payload_for_value(value), self.k, self.n, tag=value
            )
            bundle = host_shamir.encode_share_bundle(blocks)
            # Bounded FIFO: entries are dead once every replica passes the
            # value's height.
            while len(self._bundle_cache) >= 64:
                self._bundle_cache.pop(next(iter(self._bundle_cache)))
            self._bundle_cache[value] = bundle
        return bundle

    def _reconstruct_commit(self, i: int, height: Height, value: Value) -> None:
        """Committer half of the payload path: pull the committed round's
        bundle from replica i's propose log, reconstruct from k shares,
        check the payload against the value's commitment."""
        payload = (
            self._recon_cache.get(value) if self.dedup_reconstruct else None
        )
        if payload is None:
            from hyperdrive_tpu_torch.crypto import shamir as host_shamir

            state = self.replicas[i].proc.state
            # Only a propose that passed validation can be the committed
            # one — an earlier-round tampered propose for the same value
            # sits in the logs marked invalid and must not be picked.
            propose = next(
                (
                    p
                    for rnd, p in state.propose_logs.items()
                    if p.value == value
                    and p.payload
                    and state.propose_is_valid.get(rnd)
                ),
                None,
            )
            if propose is None:  # committed without a payload-carrying propose
                return
            blocks = host_shamir.decode_share_bundle(propose.payload)
            # Any k of the n shares reconstruct; rotate the contributor set
            # by height so different subsets (hence different Lagrange
            # weight sets) are exercised across the run.
            start = height % self.n
            picked = [(start + j) % self.n for j in range(self.k)]
            subset = [[shares[x] for x in picked] for shares in blocks]
            t0 = time.perf_counter()
            payload = self.reconstructor.reconstruct_payload_shares(subset)
            dt = time.perf_counter() - t0
            self.reconstruct_latency.append(dt)
            self.tracer.observe("sim.reconstruct.latency", dt)
            if payload != self._payload_for_value(value):
                raise AssertionError(
                    f"reconstructed payload mismatch at height {height}"
                )
            if self.dedup_reconstruct:
                while len(self._recon_cache) >= 64:
                    self._recon_cache.pop(next(iter(self._recon_cache)))
                self._recon_cache[value] = payload
        self.reconstructed[i][height] = payload

    def _completed(self) -> bool:
        return not self._pending_replicas

    def run(self, max_steps: int = 2_000_000, start: bool = True) -> SimulationResult:
        """Drive the network to the target height. ``start=False`` resumes
        a network whose replicas are already mid-protocol: they are not
        (re)started, so nobody re-proposes or re-arms round timers."""
        if start:
            for i, r in enumerate(self.replicas):
                if self.alive[i]:
                    r.start()
        obs = self._obs_sim
        if obs is _OBS_NULL:
            res = self._run_delivery(max_steps)
        else:
            # Observed run: tap every device_fetch for the journal. The
            # observer is a module global, so install/remove brackets the
            # run (nested observed sims are not a thing).
            set_fetch_observer(
                lambda why: obs.emit("fetch.sync", -1, -1, why or None)
            )
            try:
                res = self._run_delivery(max_steps)
            finally:
                set_fetch_observer(None)
        if self.certifiers:
            res.cert_digests = [c.chain_digest() for c in self.certifiers]
        return res

    def _result(self, steps: int) -> SimulationResult:
        return SimulationResult(
            completed=self._completed(),
            steps=steps,
            virtual_time=self.clock.now,
            heights=[r.current_height() for r in self.replicas],
            commits=self.commits,
            record=self.record if self._record_on else None,
            alive=self.alive,
        )

    def _run_delivery(self, max_steps: int) -> SimulationResult:
        """The delivery loop behind :meth:`run`: lock-step here, one
        message at a time, or :meth:`_run_burst`. The adversaries act in
        the reference's order: the reorder swap (one ``randrange``), the
        drop draw, the kills due by this step, the liveness gate, the
        delivery cost."""
        if self.burst:
            return self._run_burst(max_steps)
        steps = 0
        record_messages = self.record.messages if self._record_on else _DISCARD
        sched = self._sched
        queue = self.queue
        replicas = self.replicas
        alive = self.alive
        while steps < max_steps and not self._completed():
            if self._qhead >= len(queue):
                # Resolve in-flight device work (queue-backed flushers)
                # before advancing virtual time: a timeout must not fire
                # over a settle still in flight, and the drain's cascade
                # may broadcast, refilling the queue.
                if sched is not None and sched.depth and sched.drain():
                    continue
                # The network drained: advance virtual time to the next
                # timeout.
                if self.clock.pending() == 0:
                    if self._chaos_rescue(steps):
                        continue
                    break  # genuine stall
                if self.clock.pending() > 65536:
                    self._prune_clock()
                    if self.clock.pending() == 0:
                        if self._chaos_rescue(steps):
                            continue
                        break
                event, owner = self.clock.fire_next()
                queue.append((owner, event))
                continue

            if self.reorder:
                # Swap a random remaining entry to the head: O(1), and the
                # chosen order is recorded, so replay is exact.
                idx = self.rng.randrange(self._qhead, len(queue))
                queue[self._qhead], queue[idx] = queue[idx], queue[self._qhead]
            to, msg = queue[self._qhead]
            self._qhead += 1
            if self._qhead > 8192 and self._qhead * 2 > len(queue):
                del queue[: self._qhead]
                self._qhead = 0
            steps += 1

            ov = self._overlay
            if ov is not None:
                t = type(msg)
                if t is OverlayFrame:
                    if self._chaos is not None:
                        self._chaos_tick(steps)
                        if self._overlay_blocked(msg, to):
                            continue
                    else:
                        self._laggard_sweep(steps)
                    if not alive[to]:
                        continue
                    # One delivery_cost a frame, whatever its mask carries:
                    # commit latency counts frames (O(n log n)), not votes.
                    self.clock.now += self.delivery_cost
                    ov.on_frame(to, msg)
                    continue
                if t is OverlayTick:
                    if self._chaos is not None:
                        self._chaos_tick(steps)
                    else:
                        self._laggard_sweep(steps)
                    # A tick is a local timer, not a network message: no
                    # delivery cost and no liveness gate (the runtime
                    # disarms dead owners itself).
                    ov.on_tick(to, msg)
                    continue

            if self._chaos is not None:
                self._chaos_tick(steps)
                msg = self._chaos_deliver(to, msg)
                if msg is None:
                    continue
            if self.drop_rate and not isinstance(msg, Timeout):
                if self.rng.random() < self.drop_rate:
                    continue
            if self.kill_at_step:
                for victim, at in list(self.kill_at_step.items()):
                    if steps >= at:
                        if alive[victim]:
                            alive[victim] = False
                            self._pending_replicas.discard(victim)
                        del self.kill_at_step[victim]  # fired: stop rescanning
            if not alive[to]:
                continue
            if self.delivery_cost:
                self.clock.now += self.delivery_cost
            record_messages.append((to, msg))
            replicas[to].handle(msg)
            capture = to in self._ckpt_capture
            if capture:
                # "State should be saved after every method call"
                # (process/state.go:18-20): a scheduled crash victim
                # checkpoints its Process after every delivery it handles,
                # so the restore image is its state at the last message it
                # survived.
                self._ckpt_store.save(to, replicas[to].proc)
            lr = self._load
            if lr is not None and (
                type(msg) is Prevote
                or type(msg) is Precommit
                or type(msg) is Propose
            ):
                # Open-loop injection point: every schedule arrival due at
                # this virtual instant re-delivers the CURRENT vote to the
                # same replica as a gossip duplicate, inline, after the real
                # delivery, with no step, no clock advance and no rng draw,
                # so the unloaded trajectory is untouched. Duplicates are
                # recorded (replay is exact) and checkpointed like any
                # handled delivery.
                k = lr.due(self.clock.now)
                if k:
                    self.registry.count("load.offered", k)
                    obs = self._obs_sim
                    if obs is not _OBS_NULL:
                        obs.emit("load.offered", -1, -1, k)
                        if k >= lr.profile.amp_cap:
                            obs.emit("load.burst", -1, -1, k)
                    r = replicas[to]
                    # Vote duplicates at an un-advanced height are the
                    # gate's guaranteed prey; proposal duplicates and votes
                    # behind the commit edge are admitted or height-filtered
                    # by doctrine.
                    if type(msg) is not Propose and msg.height >= r.current_height():
                        lr.sheddable += k
                    for _ in range(k):
                        record_messages.append((to, msg))
                        r.handle(msg)
                        if capture:
                            self._ckpt_store.save(to, r.proc)

        if sched is not None:
            sched.drain()
        return self._result(steps)

    def _run_burst(self, max_steps: int) -> SimulationResult:
        """Superstep delivery: buffer every pending message, then settle
        the whole network through aggregated verification. Steps count
        deliveries (a broadcast is ``n`` of them), as in the reference;
        reorder, drops and kills apply per superstep and per delivery as
        there. The record holds each superstep's deliveries in order and
        its size."""
        steps = 0
        n = self.n
        replicas = self.replicas
        alive = self.alive
        sched = self._sched
        record_messages = self.record.messages if self._record_on else _DISCARD
        bursts = self.record.bursts if self._record_on else _DISCARD
        while steps < max_steps and not self._completed():
            if self.clock.pending() > 65536:
                self._prune_clock()
            if self._qhead >= len(self.queue):
                # Nothing left to deliver: resolve in-flight device work
                # first — a drain can finalize gated commits (and so
                # complete the run) without burning a timeout, and virtual
                # time must never jump over a pipeline slot that still owes
                # its verdict.
                if sched is not None and sched.depth and sched.drain():
                    continue
                if self.clock.pending() == 0:
                    break  # genuine stall
                event, owner = self.clock.fire_next()
                self.queue.append((owner, event))

            # Take the whole pending slice; broadcasts emitted while
            # delivering form the NEXT superstep.
            batch = self.queue[self._qhead :]
            self.queue = []
            self._qhead = 0
            if self.reorder:
                self.rng.shuffle(batch)

            # Kills apply at superstep boundaries: a replica alive for any
            # part of a superstep settles the whole superstep.
            if self.kill_at_step:
                for victim, at in list(self.kill_at_step.items()):
                    if steps >= at:
                        if alive[victim]:
                            alive[victim] = False
                            self._pending_replicas.discard(victim)
                        del self.kill_at_step[victim]

            cost = self.delivery_cost
            delivered = 0
            if self._shared_mode:
                # A (-1, msg) entry is one broadcast to every live replica:
                # steps, delivery cost and the record count per delivery
                # (broadcast-major, ascending replica order), the message
                # goes ONCE onto the shared lane (_settle filters and
                # inserts it per replica). ``live`` is a new list every
                # superstep: the record's ops share it.
                live = [i for i in range(n) if alive[i]]
                nlive = len(live)
                shared = self._shared
                tracer = self.tracer
                for to, msg in batch:
                    if to < 0:
                        steps += n
                        if not nlive:
                            continue
                        if cost:
                            self.clock.now += cost * nlive
                        record_messages.append_broadcast(msg, live)
                        delivered += nlive
                        t = type(msg)
                        tracer.count(
                            "replica.msg.prevote" if t is Prevote
                            else "replica.msg.precommit" if t is Precommit
                            else "replica.msg.propose",
                            nlive,
                        )
                        shared.append(msg)
                        continue
                    steps += 1
                    if not alive[to]:
                        continue
                    if cost:
                        self.clock.now += cost
                    record_messages.append((to, msg))
                    replicas[to].handle(msg)
                    delivered += 1
                bursts.append(delivered)
                self._shared = []
                self._settle(shared)
                continue

            # Per delivery: group VOTE deliveries per replica (buffering is
            # state-invisible until the settle), but run timeouts inline at
            # their delivery point, after flushing that replica's votes so
            # far to keep its per-message order.
            per_replica: dict[int, list] = {}
            drop_rate = self.drop_rate
            for to, msg in batch:
                steps += 1
                if drop_rate and not isinstance(msg, Timeout):
                    if self.rng.random() < drop_rate:
                        continue
                if not alive[to]:
                    continue
                if cost:
                    self.clock.now += cost
                record_messages.append((to, msg))
                delivered += 1
                t = type(msg)
                if t is Propose or t is Prevote or t is Precommit:
                    lst = per_replica.get(to)
                    if lst is None:
                        lst = per_replica[to] = []
                    lst.append(msg)
                else:
                    lst = per_replica.pop(to, None)
                    if lst:
                        replicas[to].handle_burst(lst)
                    replicas[to].handle(msg)
            for to, msgs in per_replica.items():
                replicas[to].handle_burst(msgs)
            bursts.append(delivered)
            self._settle()

        if sched is not None:
            # No command may be dropped: the final drain resolves every
            # outstanding speculation (raising on a mismatch) and finalizes
            # the gated commits the result reports.
            sched.drain()
        return self._result(steps)

    def _prune_clock(self) -> None:
        """Drop timeouts for heights every live replica has already left
        (they would fire as no-ops: the Process height-guards every
        timeout)."""
        alive_heights = [
            r.proc.current_height
            for i, r in enumerate(self.replicas)
            if self.alive[i]
        ]
        if not alive_heights:
            return
        min_h = min(alive_heights)
        self.clock.prune(
            lambda ev: ev.height >= min_h if isinstance(ev, Timeout) else True
        )

    # ---------------------------------------------------------------- settle

    def _settle(self, shared: "list | None" = None) -> None:
        """Drain every replica's window, verify ALL windows in one
        aggregated ``batch_verifier`` call, dispatch the survivors; repeat
        until the network is quiescent. The first pass turns the shared
        broadcast lane into windows; later passes drain whatever the
        cascade made newly eligible."""
        while True:
            shared_window = None
            if shared:
                shared_window, windows = self._shared_windows(shared)
                shared = None
            else:
                windows = []
                for i, r in enumerate(self.replicas):
                    if not self.alive[i]:
                        continue
                    w = r.drain_pending()
                    if w:
                        windows.append((i, w))
            if not windows:
                return
            self.settle_passes += 1
            distinct = {id(w): w for _, w in windows}.values()
            if any(type(m) is not Propose for w in distinct for m in w):
                self.vote_settles += 1
            obs = self._obs_sim
            if obs is not _OBS_NULL:
                obs.emit("settle.pass", -1, -1, len(windows))
            if self._pipeline_heights:
                self._settle_speculative(windows, shared_window)
                continue
            if self.device_tally:
                self._settle_tallied(windows, shared_window)
                continue
            if (
                self._pipeline_verify
                and not self.dedup_verify
                and self.batch_verifier is not None
                and len(windows) > 1
            ):
                self._settle_pipelined(windows, shared_window)
                continue
            keeps = self._verify_windows(windows, shared_window)
            self._dispatch_windows(windows, keeps, shared_window)

    def _settle_tallied(self, windows, shared_window) -> None:
        """One device-tally settle pass, routed: a lockstep pass (every
        window IS the shared list) on a fused-capable verifier takes the
        fused launch unless it is below the crossover floor; a straggler
        pass below the floor (in distinct messages) stays on the host;
        everything else verifies, then tallies in a second launch."""
        if (
            shared_window is not None
            and self._fused_ok
            and len(shared_window) <= self.batch_verifier.host.buckets[-1]
            and all(w is shared_window for _, w in windows)
            and all(
                self.replicas[i].procs_allowed is self._allowed_objs[i]
                for i, _ in windows
            )
        ):
            if len(shared_window) < self._fused_min_window:
                self._route_settle_to_host(windows, shared_window)
                return
            self._reengage_grid()
            if self._dispatch_fused(shared_window, windows):
                self._note_route(False)
                return
            # Vote-free window (the propose settle): verification is still
            # needed, but there is nothing to merge or tally — skip the
            # grid (reset defers to the height's first vote-bearing
            # settle) and cascade on the host fallback.
            keeps = self._verify_windows(windows, shared_window)
            self._dispatch_windows(windows, keeps, shared_window)
            return
        if self._fused_min_window and not (
            # A single window never holds the same object twice, so any
            # window at/above the floor proves uniq >= floor.
            max(len(w) for _, w in windows) >= self._fused_min_window
        ):
            # UNIQUE broadcasts, not per-receiver deliveries: the floor is
            # in distinct signatures, as on the shared-lane branch.
            uniq = len({id(m) for _, w in windows for m in w})
            if uniq < self._fused_min_window:
                # Sub-crossover straggler settle: verify on the host too,
                # and poison the grid slots these windows' votes would
                # have filled (skipped while hysteresis has the grid
                # disengaged: the rebuild claims every slot dirty).
                if self._grid_engaged:
                    for i, w in windows:
                        touched = self._touched_slots(w)
                        if touched:
                            self._poison_grid(i, touched)
                else:
                    self.tracer.count("sim.settle.grid_upkeep_skipped")
                self._note_route(True)
                self.tracer.observe("sim.settle.host_routed", uniq)
                self.host_routed_settles += 1
                keeps = self._verify_windows(
                    windows, shared_window, force_host=True
                )
                self._dispatch_windows(windows, keeps, shared_window)
                return
        keeps = self._verify_windows(windows, shared_window)
        self._reengage_grid()
        self._dispatch_tallied(windows, keeps, shared_window)
        self._note_route(False)

    def _route_settle_to_host(self, windows, shared_window) -> None:
        """Handle one sub-crossover lockstep settle fully on the host:
        host verification, plain window dispatch (host-counter cascade),
        and grid poisoning — exactly the (plane, round) slots this
        window's votes would have occupied are marked dirty until the
        height advances. A vote-free window poisons nothing. While
        hysteresis has the grid disengaged the poison upkeep is skipped:
        the rebuild on re-engagement claims every slot dirty anyway."""
        if self._grid_engaged:
            touched = self._touched_slots(shared_window)
            if touched:
                for i, _ in windows:
                    self._poison_grid(i, touched)
        else:
            self.tracer.count("sim.settle.grid_upkeep_skipped")
        self._note_route(True)
        self.tracer.observe("sim.settle.host_routed", len(shared_window))
        self.host_routed_settles += 1
        keeps = self._verify_windows(windows, shared_window, force_host=True)
        self._dispatch_windows(windows, keeps, shared_window)

    def _note_route(self, host_routed: bool) -> None:
        """Feed the router hysteresis: one observation per routed settle.
        A full window of >= 95% host routes disengages grid upkeep; the
        history only governs disengagement (re-engagement is size-driven,
        see :meth:`_reengage_grid`), so a disengaged router records
        nothing."""
        n = self._route_hyst_n
        if not n or not self._fused_min_window or not self._grid_engaged:
            return
        hist = self._route_hist
        hist.append(host_routed)
        if len(hist) > n:
            del hist[0]
        elif len(hist) < n:
            return
        if sum(hist) >= self._route_hyst_thresh:
            self._grid_engaged = False
            hist.clear()
            self.tracer.count("sim.settle.grid_disengaged")

    def _reengage_grid(self) -> None:
        """Rebuild the grid bookkeeping before a device-routed settle
        touches a disengaged grid: each replica's CURRENT height is claimed
        with every slot dirty (votes host-routed while disengaged never
        reached the grid); the next height's reset starts it clean."""
        if self._grid_engaged:
            return
        all_slots = self.vote_grid.all_slots()
        for i, r in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            self._grid_height[i] = r.proc.current_height
            self._grid_dirty[i] = set(all_slots)
        self._grid_engaged = True
        self._route_hist.clear()
        self.tracer.count("sim.settle.grid_reengaged")

    def _order_key(self, sender) -> int:
        """Sender tie-break index: whitelist order for signatories, then
        first-seen registration."""
        o = self._order_pos.get(sender)
        if o is None:
            o = self._order_pos[sender] = len(self._order_pos)
        return o

    def _shared_windows(self, shared: list):
        """Turn the superstep's shared broadcast lane into per-replica
        windows: one global sort by the drain contract's key (ascending
        (height, round), senders by registration order, arrival FIFO within
        ties). Lockstep replicas share the sorted list itself; stragglers
        get a per-replica split (current-height rows merged with their
        drained backlog, future rows buffered into their mq). The
        per-sender lane capacity applies height-aware, in arrival order."""
        okey = self._order_key
        cap = self._max_capacity
        dropped_for: dict = {}
        if len(shared) > cap:
            arrival = list(shared)

            def dropped_at(cur) -> set:
                d = dropped_for.get(cur)
                if d is None:
                    d = dropped_for[cur] = set()
                    counts: dict = {}
                    for m in arrival:
                        if m.height == cur:
                            c = counts.get(m.sender, 0)
                            if c >= cap:
                                d.add(id(m))
                            else:
                                counts[m.sender] = c + 1
                return d
        else:
            def dropped_at(cur) -> set:
                return ()

        shared.sort(key=lambda m: (m.height, m.round, okey(m.sender)))
        hmin = shared[0].height
        hmax = shared[-1].height
        windows: list[tuple[int, list]] = []
        shared_capped: dict = {}  # cur -> capped shared list (lockstep case)
        for i, r in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            cur = r.proc.current_height
            plain = not r._lane and not r.mq.has_eligible(cur)
            if plain and hmin == hmax == cur:
                if len(shared) <= cap:
                    windows.append((i, shared))
                    continue
                w = shared_capped.get(cur)
                if w is None:
                    d = dropped_at(cur)
                    w = shared_capped[cur] = (
                        shared if not d
                        else [m for m in shared if id(m) not in d]
                    )
                windows.append((i, w))
                continue
            d = dropped_at(cur)
            cur_rows: list = []
            for m in shared:
                h = m.height
                if h == cur:
                    if id(m) not in d:
                        cur_rows.append(m)
                elif h > cur:
                    t = type(m)
                    if t is Prevote:
                        r.mq.insert_prevote(m)
                    elif t is Precommit:
                        r.mq.insert_precommit(m)
                    else:
                        r.mq.insert_propose(m)
            w = merge_drain(r.drain_pending(), cur_rows, okey)
            if w:
                windows.append((i, w))
        return shared, windows

    def _dispatch_windows(self, windows, keeps, shared_window) -> None:
        """Plain (host-cascade) dispatch of a settle pass's windows, on the
        columnar path for every window that IS the shared lockstep list:
        one WindowColumns extraction serves all of them. Stragglers keep
        the object path."""
        cols = None
        for (i, w), keep in zip(windows, keeps):
            if self.columnar_ingest and w is shared_window:
                if cols is None:
                    cols = WindowColumns.from_messages(shared_window)
                self.replicas[i].dispatch_window_cols(cols, keep)
            else:
                self.replicas[i].dispatch_window(w, keep)

    def _settle_pipelined(self, windows, shared_window) -> None:
        """Double-buffered redundant settle: verify + dispatch with the
        windows chunked into replica groups, group g+1's verify launches
        enqueued BEFORE group g's mask is read, so the device work runs
        under group g's host insert + cascade.

        Shared lockstep windows pack once for the whole pass:
        ``verify_signatures_begin(items, repeats=len(group))`` re-launches
        the packed rows once per receiver copy (every copy is verified on
        the device; no lane is re-packed or re-shipped). A verifier
        without ``verify_signatures_begin`` verifies group by group, with
        the same verdicts and no overlap.
        """
        from hyperdrive_tpu_torch.ops.bucketing import launch_target

        begin = getattr(self.batch_verifier, "verify_signatures_begin", None)
        buckets = getattr(
            getattr(self.batch_verifier, "host", None), "buckets", None
        )
        # Group so one launch carries about one verify bucket of lanes:
        # finer groups pay launch overhead, coarser ones leave nothing in
        # flight to hide behind the cascade.
        target = launch_target(buckets)
        per_win = max(len(w) for _, w in windows)
        gsize = max(1, target // max(per_win, 1))
        groups = [windows[a : a + gsize] for a in range(0, len(windows), gsize)]
        shared_items = None
        cols = None
        total_items = 0

        def launch(group):
            nonlocal shared_items, total_items
            if shared_window is not None and all(
                w is shared_window for _, w in group
            ):
                if shared_items is None:
                    shared_items = [
                        (m.sender, m.digest(), m.signature) for m in shared_window
                    ]
                total_items += len(shared_items) * len(group)
                if begin is not None:
                    self.verified_sigs += len(shared_items) * len(group)
                    return begin(shared_items, repeats=len(group)), None
                return self._verify_items(shared_items * len(group)), None
            items = []
            bounds = []
            for _, w in group:
                start = len(items)
                items.extend((m.sender, m.digest(), m.signature) for m in w)
                bounds.append((start, len(items)))
            total_items += len(items)
            if begin is not None:
                self.verified_sigs += len(items)
                return begin(items), bounds
            return self._verify_items(items), bounds

        inflight = launch(groups[0])
        for gi, group in enumerate(groups):
            nxt = launch(groups[gi + 1]) if gi + 1 < len(groups) else None
            handle, bounds = inflight
            mask = handle.mask() if hasattr(handle, "mask") else handle
            mask = mask.tolist() if hasattr(mask, "tolist") else list(mask)
            if bounds is None:
                m = len(mask) // len(group)
                keeps = [mask[j * m : (j + 1) * m] for j in range(len(group))]
            else:
                keeps = [mask[a:b] for a, b in bounds]
            for (i, w), keep in zip(group, keeps):
                if self.columnar_ingest and w is shared_window:
                    if cols is None:
                        cols = WindowColumns.from_messages(shared_window)
                    self.replicas[i].dispatch_window_cols(cols, keep)
                else:
                    self.replicas[i].dispatch_window(w, keep)
            inflight = nxt
        self.tracer.count("sim.settle.pipelined")
        self.tracer.observe("sim.verify.launch", total_items)
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit("verify.launch", -1, -1, total_items)

    def _verify_windows(self, windows, shared_window=None,
                        force_host: bool = False) -> list:
        """One aggregated verification for a settle pass's windows; returns
        the per-window keep masks (None entries = no verifier)."""
        keeps: list = [None] * len(windows)
        if self.batch_verifier is None:
            return keeps
        if self.dedup_verify:
            # One lane per distinct broadcast, keyed by message identity
            # (one object fans out to every receiver). Windows that ARE
            # the shared list take the mask's shared prefix.
            index: dict[int, int] = {}
            items: list = []
            shared_len = 0
            if shared_window is not None:
                items = [
                    (m.sender, m.digest(), m.signature) for m in shared_window
                ]
                shared_len = len(items)
                for j, m in enumerate(shared_window):
                    index[id(m)] = j
            slots: list = []
            for _, w in windows:
                if w is shared_window:
                    slots.append(None)
                    continue
                row = []
                for m in w:
                    j = index.get(id(m))
                    if j is None:
                        j = index[id(m)] = len(items)
                        items.append((m.sender, m.digest(), m.signature))
                    row.append(j)
                slots.append(row)
            self.tracer.observe("sim.verify.launch", len(items))
            if self._obs_sim is not _OBS_NULL:
                self._obs_sim.emit("verify.launch", -1, -1, len(items))
            mask = self._verify_items(items, force_host)
            shared_keep = (
                mask if shared_len == len(mask) else mask[:shared_len]
            )
            for wi, row in enumerate(slots):
                keeps[wi] = shared_keep if row is None else [mask[j] for j in row]
        else:
            items = []
            bounds = []
            for _, w in windows:
                start = len(items)
                items.extend((m.sender, m.digest(), m.signature) for m in w)
                bounds.append((start, len(items)))
            self.tracer.observe("sim.verify.launch", len(items))
            if self._obs_sim is not _OBS_NULL:
                self._obs_sim.emit("verify.launch", -1, -1, len(items))
            mask = self._verify_items(items, force_host)
            keeps = [mask[a:b] for a, b in bounds]
        return keeps

    def _verify_items(self, items, force_host: bool = False) -> list:
        """One aggregated signature verification, routed: sub-64-item
        windows go to the host verifier when small-window routing is on,
        everything else to the batch verifier. ``force_host``: a settle
        the crossover router kept on the host verifies there too, unless
        small-window routing is off (then the batch verifier answers)."""
        self.verified_sigs += len(items)
        if self._small_win_host is not None and (
            force_host or len(items) < 64
        ):
            mask = self._small_win_host.verify_signatures(items)
        else:
            mask = self.batch_verifier.verify_signatures(items)
        return mask.tolist() if hasattr(mask, "tolist") else list(mask)

    def _settle_speculative(self, windows, shared_window) -> None:
        """Chained height pipelining: dispatch this settle pass now on a
        speculative verdict and push the actual verification onto the
        device-work queue — replicas enter the next height's
        propose/prevote while this height's launch is still in flight, and
        the queue coalesces up to ``pipeline_depth`` settles into ONE
        launch.

        The speculation accepts exactly the parseable-and-signed rows
        (32-byte sender, 64-byte signature): for every honest signature
        the device's verdict is identical, so honest trajectories equal
        the sequential run's. A forged-but-well-formed row raises
        :class:`~hyperdrive_tpu_torch.devsched.SpeculationMismatch` at
        drain, before any commit gated on it finalizes.

        Dispatch runs on the host counters, so under ``device_tally`` the
        grid gets the poison upkeep of a host-routed settle; nothing is
        fused and no tally is launched.
        """
        from hyperdrive_tpu_torch.devsched import SpeculationMismatch
        from hyperdrive_tpu_torch.ops.bucketing import would_spill

        if self.device_tally:
            if self._grid_engaged:
                shared_touched = None
                for i, w in windows:
                    if w is shared_window:
                        if shared_touched is None:
                            shared_touched = self._touched_slots(w)
                        touched = shared_touched
                    else:
                        touched = self._touched_slots(w)
                    if touched:
                        self._poison_grid(i, touched)
            else:
                self.tracer.count("sim.settle.grid_upkeep_skipped")
            self._note_route(True)

        # Speculative verdicts for the unique-broadcast batch (identity
        # dedup, the keying of _verify_windows' dedup path).
        index: dict[int, int] = {}
        items: list = []
        expect: list = []

        def spec(m) -> bool:
            sig = m.signature
            return sig is not None and len(sig) == 64 and len(m.sender) == 32

        keeps: list = []
        shared_keep = None
        if shared_window is not None:
            for m in shared_window:
                index[id(m)] = len(items)
                items.append((m.sender, m.digest(), m.signature))
                expect.append(spec(m))
            shared_keep = list(expect)
        for _, w in windows:
            if w is shared_window:
                keeps.append(shared_keep)
                continue
            row = []
            for m in w:
                j = index.get(id(m))
                if j is None:
                    j = index[id(m)] = len(items)
                    items.append((m.sender, m.digest(), m.signature))
                    expect.append(spec(m))
                row.append(expect[j])
            keeps.append(row)

        if items:
            if self._obs_sim is not _OBS_NULL:
                self._obs_sim.emit("settle.speculative", -1, -1, len(items))
            self.tracer.observe("sim.verify.speculated", len(items))
            self.verified_sigs += len(items)
            sched = self._sched
            # Row-aware slot close: if adding this settle would push the
            # coalesced batch into a larger verify bucket, drain first —
            # padded launches cost by bucket, not by fill. Verifiers
            # without a bucket ladder (HostVerifier) rely on the queue's
            # command-count bound.
            buckets = getattr(
                getattr(self.batch_verifier, "host", None), "buckets", None
            )
            if would_spill(self._spec_rows, len(items), buckets):
                sched.drain()
            # Account BEFORE submit: submit may auto-drain at max_depth
            # (resolving this very command and zeroing the counters via
            # _on_sched_drain); incrementing afterwards would record a
            # phantom in-flight settle that gates commits forever.
            self._spec_rows += len(items)
            self._spec_inflight += 1
            fut = sched.submit(
                sched.verify_launcher(self.batch_verifier), items,
                origin=-1, rows=len(items),
            )
            self._spec_last_fut = fut

            def confirm(f, expected=expect, items=items):
                actual = [bool(b) for b in f.result()]
                if actual != expected:
                    bad = next(
                        j for j in range(len(actual)) if actual[j] != expected[j]
                    )
                    raise SpeculationMismatch(
                        "pipelined settle diverged from the device verdict "
                        f"at lane {bad}/{len(actual)} (sender "
                        f"{items[bad][0].hex()[:16]}…, speculated "
                        f"{expected[bad]}, actual {actual[bad]}): a "
                        "forged-but-well-formed signature was speculatively "
                        "dispatched; rerun with pipeline_heights=False"
                    )

            fut.add_done_callback(confirm)

        # Dispatch immediately — THIS is the pipeline: the network
        # progresses on the speculative verdicts while the launch is in
        # flight. Commits raised by the cascade gate in _on_commit.
        self._dispatch_windows(windows, keeps, shared_window)

        # A gated commit that would complete the run must not wait for the
        # depth trigger: drain now so run() terminates promptly instead of
        # speculating extra heights past the target.
        if self._gated_commits and any(
            h >= self.target_height and i in self._pending_replicas
            for i, h, _, _ in self._gated_commits
        ):
            self._sched.drain()

    # ----------------------------------------------------------- device tally

    def _touched_slots(self, msgs) -> set:
        """The (plane, round) grid slots a window's votes would fill —
        what a host-routed settle must poison. Out-of-window rounds never
        reach the grid and TallyView never serves them."""
        grid_r = self.vote_grid.R
        touched = set()
        for m in msgs:
            t = type(m)
            if t is Prevote or t is Precommit:
                rnd = m.round
                if 0 <= rnd < grid_r:
                    touched.add((1 if t is Precommit else 0, rnd))
        return touched

    def _poison_grid(self, i, touched) -> None:
        """Mark replica ``i``'s grid slots missing after a host-routed
        settle (``touched``: non-empty set of (plane, round) pairs its
        window's votes would have filled)."""
        h = self.replicas[i].current_height()
        if self._grid_height[i] != h:
            # The grid was never reset for this height: its rows are stale
            # for EVERY round, and claiming the height here (so the next
            # device settle does not reset and clear the poison) means no
            # zeroing will happen — poison the whole height.
            self._grid_height[i] = h
            self._grid_dirty[i] = set(self.vote_grid.all_slots())
        else:
            self._grid_dirty[i].update(touched)

    def _targets(self, i, win_props, h, dirty):
        """Replica ``i``'s launch targets: (targets [R, 8], valid [R],
        round -> value, l28 slot, l28 words [8], l28 value or None). The
        per-round targets are its logged proposes plus this window's
        schedule-checked ones (``win_props``: round -> the window's only
        propose there, None for conflicting ones, whose rounds are
        poisoned in ``dirty``)."""
        from hyperdrive_tpu_torch.ops.tally import pack_value

        R = self.vote_grid.R
        proc = self.replicas[i].proc
        st = proc.state
        targets = np.zeros((R, 8), dtype=np.int32)
        tvalid = np.zeros(R, dtype=bool)
        tmap: dict = {}
        for rnd, p in st.propose_logs.items():
            if 0 <= rnd < R:
                targets[rnd] = pack_value(p.value)
                tvalid[rnd] = True
                tmap[rnd] = p.value
        for rnd, wp in win_props.items():
            if rnd in tmap:
                continue  # logged propose wins; the window dup is rejected
            if wp is None:
                # Conflicting window proposes: the accepted one depends on
                # per-row verdicts; don't predict.
                dirty.add((0, rnd))
                dirty.add((1, rnd))
                continue
            if proc.scheduler is not None and proc.scheduler.schedule(
                h, rnd
            ) != wp.sender:
                continue  # out-of-turn: the host rejects it
            targets[rnd] = pack_value(wp.value)
            tvalid[rnd] = True
            tmap[rnd] = wp.value
        l28_slot = -1
        l28_words = np.zeros(8, dtype=np.int32)
        l28_value = None
        cur = st.propose_logs.get(st.current_round)
        if cur is not None and 0 <= cur.valid_round < R:
            l28_slot = cur.valid_round
            l28_words = pack_value(cur.value)
            l28_value = cur.value
        return targets, tvalid, tmap, l28_slot, l28_words, l28_value

    def _cascade(self, plans, counts, heights, tmaps, l28_slot, l28_vals):
        """Run every planned replica's rule cascade against its
        :class:`TallyView` slice of ``counts``."""
        from hyperdrive_tpu_torch.ops.votegrid import TallyView

        R = self.vote_grid.R
        for i, plan in plans:
            view = TallyView(
                i, heights[i], counts, R, tmaps[i], int(l28_slot[i]),
                l28_vals.get(i) or b"", dirty=self._grid_dirty[i],
            )
            if self._tally_check is not None:
                view = self._tally_check(view, self.replicas[i].proc)
            self.replicas[i].ingest_cascade_window(plan, view)

    def _launch_meta(self, windows, win_props, h=None):
        """Per-replica launch metadata for the windows' replicas: (reset,
        participate, targets, tvalid, l28_slot, l28_target, f, tmaps,
        l28_vals). A replica whose grid rows belong to an older height is
        reset (and its dirty set cleared) at ``h``, or at its current
        height when ``h`` is None."""
        n, R = self.n, self.vote_grid.R
        reset = np.zeros(n, dtype=bool)
        participate = np.zeros(n, dtype=bool)
        targets = np.zeros((n, R, 8), dtype=np.int32)
        tvalid = np.zeros((n, R), dtype=bool)
        l28_slot = np.full(n, -1, dtype=np.int32)
        l28_target = np.zeros((n, 8), dtype=np.int32)
        fs = np.zeros(n, dtype=np.int32)
        tmaps: dict[int, dict] = {}
        l28_vals: dict[int, bytes] = {}
        for i, _ in windows:
            participate[i] = True
            hi = self.replicas[i].current_height() if h is None else h
            if self._grid_height[i] != hi:
                reset[i] = True
                self._grid_height[i] = hi
                self._grid_dirty[i] = set()
        return (reset, participate, targets, tvalid, l28_slot, l28_target,
                fs, tmaps, l28_vals)

    def _dispatch_tallied(self, windows, keeps, shared_window=None) -> None:
        """Device-tally dispatch in two launches: insert every window,
        scatter the accepted votes into the persistent vote grid, run ONE
        tally launch for the whole network, then run each replica's rule
        cascade against its :class:`TallyView` slice. The counts are
        exactly equal to the host counters wherever the view answers, so
        runs are bit-identical to host-tally mode. Windows that ARE the
        shared lockstep list insert through one shared WindowColumns
        extraction."""
        R = self.vote_grid.R
        # Resets before the insert phase: inserts never change heights,
        # and the insert hooks' dirty marks for the NEW height must
        # survive.
        (reset, _, targets, tvalid, l28_slot, l28_target, fs, tmaps,
         l28_vals) = self._launch_meta(windows, {})

        accepted: list = []  # (replica, plane, msg) in scatter order
        sender_pos = self._sender_pos

        def make_hook(i, dirty):
            def on_accepted(msg, is_precommit):
                rnd = msg.round
                plane = 1 if is_precommit else 0
                if rnd < 0 or rnd >= R:
                    # Outside the slot window: TallyView declines these
                    # rounds. The lower bound matters — vote inserts accept
                    # negative rounds, and a slot of -1 would alias into a
                    # neighboring lane's slot R-1 as a phantom vote.
                    return
                if msg.sender not in sender_pos:
                    # Whitelisted sender outside the grid's validator axis:
                    # this round's device count would undercount.
                    dirty.add((plane, rnd))
                    return
                accepted.append((i, plane, msg))
            return on_accepted

        plans = []
        cols = None
        for (i, w), keep in zip(windows, keeps):
            hook = make_hook(i, self._grid_dirty[i])
            if self.columnar_ingest and w is shared_window:
                if cols is None:
                    cols = WindowColumns.from_messages(shared_window)
                plans.append(
                    (i, self.replicas[i].ingest_insert_window_cols(cols, keep, hook))
                )
            else:
                plans.append(
                    (i, self.replicas[i].ingest_insert_window(w, keep, hook))
                )
        # Matching targets are each replica's post-insert proposal value
        # per round slot; the L28 lane carries the cross-round
        # (valid_round, current proposal value) query.
        for i, _ in windows:
            fs[i] = self.replicas[i].proc.f
            (targets[i], tvalid[i], tmaps[i], l28_slot[i], l28_target[i],
             v) = self._targets(i, {}, None, self._grid_dirty[i])
            if v is not None:
                l28_vals[i] = v

        if accepted:
            block = MessageBlock.from_messages([m for _, _, m in accepted])
            words = np.ascontiguousarray(block.rows["value"]).view("<i4")
            idx = np.array(
                [(i, plane, m.round, sender_pos[m.sender]) for i, plane, m in accepted],
                dtype=np.int32,
            )
        else:
            words = np.zeros((0, 8), dtype=np.int32)
            idx = np.zeros((0, 4), dtype=np.int32)
        counts = self.vote_grid.update_and_tally(
            idx, words, reset, targets, tvalid, l28_slot, l28_target, fs
        )
        self.tally_launches += 1
        self.tracer.observe("sim.tally.launch", len(idx))
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit("tally.launch", -1, -1, len(idx))
        self._cascade(plans, counts, self._grid_height, tmaps, l28_slot,
                      l28_vals)

    def _dispatch_fused(self, shared, windows) -> bool:
        """Device-tally settle behind one upload and one download:
        verify the shared window, merge the verified votes into every
        lockstep replica's grid (presence-guarded, shared rows), tally —
        then the host inserts with the mask and cascades against the
        counts. The settle pays a single blocking sync (the mask), as the
        verify-only path does; the counts ride the same copy. Returns
        False, launching nothing, for a vote-free window.

        Eligibility (checked by the caller): every window IS the shared
        list, dedup verification, un-rotated whitelists, window within
        one verify bucket."""
        R = self.vote_grid.R
        h = shared[0].height
        if not any(
            type(m) is Prevote or type(m) is Precommit for m in shared
        ):
            # Nothing can be merged and no count can have changed. Grid
            # heights stay stale on purpose; the next vote-bearing
            # settle's reset brings them forward.
            return False

        items = [(m.sender, m.digest(), m.signature) for m in shared]
        self.verified_sigs += len(items)
        self.tracer.observe("sim.verify.launch", len(items))
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit("verify.launch", h, -1, len(items))
        arrays, prevalid, nitems = self.batch_verifier.host.pack(items)

        # The dense one-superstep update image: one lane per (plane,
        # round, validator), first parseable claimant wins (the host's
        # first-wins insert rule); conflicting claims poison the round
        # for this height. Proposes feed the target prediction instead.
        upd_lane = np.full((2, R, self.vote_grid.V), -1, dtype=np.int32)
        upd_vals = np.zeros((2, R, self.vote_grid.V, 8), dtype=np.int32)
        hazard: set = set()
        win_props: dict = {}
        sender_pos = self._sender_pos
        k = 0
        for j, m in enumerate(shared):
            t = type(m)
            if t is Prevote:
                plane = 0
            elif t is Precommit:
                plane = 1
            else:
                rnd = m.round
                if 0 <= rnd < R:
                    win_props[rnd] = None if rnd in win_props else m
                continue
            rnd = m.round
            if rnd < 0 or rnd >= R:
                continue
            v = sender_pos.get(m.sender)
            if v is None:
                # Whitelisted sender outside the grid's validator axis.
                hazard.add((plane, rnd))
                continue
            if upd_lane[plane, rnd, v] >= 0:
                hazard.add((plane, rnd))
                continue
            if not prevalid[j]:
                # Unparseable signature: the host rejects it; the lane
                # stays unclaimed for a later well-formed row.
                continue
            upd_lane[plane, rnd, v] = j
            upd_vals[plane, rnd, v] = np.frombuffer(m.value, dtype="<i4")
            k += 1
        self.tracer.observe("sim.tally.launch", k)
        if self._obs_sim is not _OBS_NULL:
            self._obs_sim.emit("tally.launch", h, -1, k)

        # Targets come from PRE-insert propose logs plus this window's
        # schedule-checked proposes — identical to the post-insert logs
        # except where a window propose fails verification, and then the
        # host log stays empty at that round and the cascade never asks.
        # Lockstep replicas almost always share their propose logs (the
        # very same broadcast objects), so the row is computed once and
        # fanned out while no window propose is in flight.
        (reset, participate, targets, tvalid, l28_slot, l28_target, fs,
         tmaps, l28_vals) = self._launch_meta(windows, win_props, h)
        ref = None
        for i, _ in windows:
            dirty = self._grid_dirty[i]
            dirty.update(hazard)
            st = self.replicas[i].proc.state
            fs[i] = self.replicas[i].proc.f
            if (
                ref is not None
                and not win_props
                and st.propose_logs == ref[0]
                and st.current_round == ref[1]
            ):
                row = ref[2]
            else:
                row = self._targets(i, win_props, h, dirty)
                if ref is None and not win_props:
                    ref = (st.propose_logs, st.current_round, row)
            (targets[i], tvalid[i], tmaps[i], l28_slot[i], l28_target[i],
             v) = row
            if v is not None:
                l28_vals[i] = v

        fused_out = self.vote_grid.fused_update_and_tally(
            arrays, upd_lane, upd_vals, reset, participate,
            targets, tvalid, l28_slot, l28_target, fs,
        )
        self.fused_settles += 1
        # The settle's one blocking sync: mask and packed counts arrive in
        # the same copy. Wall-clocked (seconds): the insert and cascade
        # below depend on it, so it is the settle's unhideable device
        # cost.
        t_sync = time.perf_counter()
        keep = (fused_out.mask() & prevalid)[:nitems].tolist()
        counts = fused_out.counts()
        self.tracer.observe(
            "sim.fused.sync.latency", time.perf_counter() - t_sync
        )
        t_host = time.perf_counter()
        # Every window IS the shared list (fused eligibility), so one
        # columnar extraction serves all n lockstep inserts.
        cols = WindowColumns.from_messages(shared) if self.columnar_ingest else None
        plans = [
            (
                i,
                self.replicas[i].ingest_insert_window_cols(cols, keep)
                if cols is not None and w is shared
                else self.replicas[i].ingest_insert_window(w, keep),
            )
            for i, w in windows
        ]
        self._cascade(plans, counts, {i: h for i, _ in windows}, tmaps,
                      l28_slot, l28_vals)
        # Host insert + cascade wall, the companion of the sync leg: when
        # it is shorter, no overlap can hide the sync behind host work.
        self.tracer.observe(
            "sim.fused.cascade.latency", time.perf_counter() - t_host
        )
        return True


    # -------------------------------------------------------------- replay

    @classmethod
    def replay(cls, record: ScenarioRecord, **kwargs) -> SimulationResult:
        """Re-deliver a recorded interleaving message for message (the Go
        reference's ``replay()``, ``replica_test.go:325-370``).

        The replayed network uses the recorded signatories and delivers
        only the recorded messages: no clock, no adversary. A burst record
        (non-empty ``bursts``) replays superstep for superstep, each
        recorded burst buffered, then settled (pass ``batch_verifier=`` to
        verify during replay). The epoch and execution trailers rebuild
        the run's ``EpochConfig`` and ``ExecutionConfig`` unless ``kwargs``
        names them. A record's ``OP_RESYNC`` lifecycle operations (the
        laggard sweep's) and the chaos engine's ``OP_CRASH`` and
        ``OP_RESTORE`` are applied at their recorded positions. A restore
        victim's checkpoints are re-derived during the replay (the same
        delivery stream gives the same Process bytes), so the dump stores
        none."""
        ops = list(record.lifecycle)
        if record.epochs is not None and "epochs" not in kwargs:
            from hyperdrive_tpu_torch.epochs import EpochConfig

            epoch_length, committee, rekey, eseed, stakes = record.epochs
            kwargs["epochs"] = EpochConfig(
                epoch_length=epoch_length,
                committee_size=committee,
                rekey_per_epoch=rekey,
                seed=eseed,
                stakes=stakes,
            )
        if record.execution is not None and "execution" not in kwargs:
            from hyperdrive_tpu_torch.exec import ExecutionConfig

            # The ledger trajectory is a function of the config ints and
            # the committed heights the message stream reproduces.
            kwargs["execution"] = ExecutionConfig.from_ints(record.execution)
        sim = cls(
            n=record.n,
            target_height=record.target_height,
            seed=record.seed,
            signatories=list(record.signatories),
            burst=bool(record.bursts),
            batch_ingest=record.batch_ingest if record.bursts else None,
            **kwargs,
        )
        for i, r in enumerate(sim.replicas):
            if sim.alive[i]:
                r.start()
        sim.queue.clear()
        sim._qhead = 0
        steps = 0
        if record.bursts:
            idx = 0
            for b in record.bursts:
                for to, msg in record.messages[idx : idx + b]:
                    if sim.alive[to]:
                        sim.replicas[to].handle(msg)
                        steps += 1
                idx += b
                sim.queue.clear()  # replay ignores re-broadcasts
                sim._qhead = 0
                sim._settle()
        else:
            sim._ckpt_capture = {
                rep for kind, _, rep, _ in ops if kind == ScenarioRecord.OP_RESTORE
            }
            optr = 0
            for j, (to, msg) in enumerate(record.messages):
                while optr < len(ops) and ops[optr][1] <= j:
                    sim._replay_lifecycle(ops[optr])
                    optr += 1
                if not sim.alive[to]:
                    continue
                sim.replicas[to].handle(msg)
                if to in sim._ckpt_capture:
                    sim._ckpt_store.save(to, sim.replicas[to].proc)
                steps += 1
            for op in ops[optr:]:
                sim._replay_lifecycle(op)
        res = sim._result(steps)
        res.record = record
        res.sim = sim
        return res


class _ChaosEnvelope:
    """Marks a delayed or duplicated delivery that already passed the
    link-fault stage, so its re-delivery meets partitions only (a delayed
    frame must not be delayed or duplicated again forever). Not a Timeout,
    so a pending delayed delivery survives :meth:`Simulation._prune_clock`."""

    __slots__ = ("msg",)

    def __init__(self, msg):
        self.msg = msg


class _PartitionRT:
    """Runtime state of one scheduled
    :class:`~hyperdrive_tpu_torch.chaos.plan.Partition`: group membership
    resolved to a dict, and the engaged/healed latch (each partition fires
    once)."""

    __slots__ = ("spec", "engaged", "healed", "gid")

    def __init__(self, spec):
        self.spec = spec
        self.engaged = False
        self.healed = False
        self.gid: dict[int, int] = {}
        for g, members in enumerate(spec.groups):
            for m in members:
                self.gid[m] = g

    def blocks(self, a: int, b: int) -> bool:
        # Replicas absent from every listed group share the implicit
        # remainder group (-1).
        return self.gid.get(a, -1) != self.gid.get(b, -1)


class _PayloadProposer:
    """Proposer for the MPC payload path: values as usual, with the
    value-keyed share bundle attached via the Process's duck-typed
    ``payload_for_value`` hook (so re-proposed ValidValues re-derive their
    original bundle)."""

    __slots__ = ("_sim", "_fn")

    def __init__(self, sim: "Simulation", fn):
        self._sim = sim
        self._fn = fn

    def propose(self, height, round_):
        return self._fn(height, round_)

    def payload_for_value(self, value):
        return self._sim._bundle_for_value(value)


class _PayloadValidator:
    """Accepts a proposal iff its payload is exactly the share bundle its
    value commits to (the Process's duck-typed ``valid_propose`` hook)."""

    __slots__ = ("_sim",)

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    def valid(self, height, round_, value):
        return True

    def valid_propose(self, propose):
        return propose.payload == self._sim._bundle_for_value(propose.value)


def _lockstep_verifier(device):
    """A lock-step verifier on ``device``: a ``TorchBatchVerifier`` on the
    card (raises without CUDA), the reference's ``HostVerifier`` on the
    CPU."""
    from hyperdrive_tpu_torch.ops.merkle import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        from hyperdrive_tpu_torch.verifier import HostVerifier

        return HostVerifier()
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    return TorchBatchVerifier(device=dev)
