"""The simulator, burst mode: virtual time, signed votes, settle windows
verified in one batched launch.

Port of the part of the JAX package's ``harness/sim.py`` that runs the
signed, burst-mode, dedup-verified network (the "256 replicas, Ed25519
batch-verify offload" deployment):

- One global queue of ``(to, msg)`` records. In shared-superstep mode a
  broadcast is ONE entry (``to = -1``: every live replica); timeouts are
  addressed to their owner. Timeouts run on a :class:`VirtualClock`: when
  the network drains, the clock jumps to the next deadline.
- Each superstep takes the whole pending queue, appends every broadcast
  once to a shared lane, then settles: the lane becomes per-replica
  windows (:meth:`Simulation._shared_windows`), ALL windows are
  signature-checked in one ``batch_verifier`` call per settle pass, each
  replica runs its rule cascade on the survivors, and the pass repeats
  until the network is quiescent.

Delivery order, the small-window routing rule and the commit bookkeeping
are the reference's, so the two commit the same chain step for step.

With ``device_tally=True`` the quorum counts come from the device vote
grid (:class:`~hyperdrive_tpu_torch.ops.votegrid.VoteGrid`, one grid
for the network on ``device``): a lockstep settle whose verifier exposes
``fused_inner`` verifies, merges and tallies behind one upload and one
download (:meth:`Simulation._dispatch_fused`); any other settle verifies,
inserts, then scatters and tallies in a second launch
(:meth:`Simulation._dispatch_tallied`). ``fused_min_window`` routes
sub-crossover settles fully to the host and poisons the grid slots they
bypass; ``route_hysteresis`` drops the grid upkeep over a host-shaped
stretch and rebuilds it on re-engagement. The reference's tracer spans
for these paths become three plain counters (``fused_settles``,
``tally_launches``, ``host_routed_settles``).

With ``pipeline_heights=True`` each settle pass dispatches at once on a
speculative verdict (every parseable, signed row accepted) and submits
its verification to a :class:`~hyperdrive_tpu_torch.devsched.
DeviceWorkQueue`, which coalesces up to ``pipeline_depth`` settles into
one ``verify_signatures`` call (:meth:`Simulation._settle_speculative`).
Commits raised meanwhile are gated until the covering drain confirms the
speculation; a verdict that differs raises
:class:`~hyperdrive_tpu_torch.devsched.SpeculationMismatch`. The queue is
``Simulation._sched``.

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
each replica's chain digest.

Not ported (a later slice of the port), and refused: lock-step delivery
(``burst=False``), per-delivery adversaries, kills, the sharded grid
(``tally_mesh``), an injected queue (``devsched=``) and per-replica
flushers, BLS certificates (``bls_certificates``), epochs, chaos, load,
overlay, execution and the record/replay log
(``SimulationResult.record`` is always None).
The tracer, flight recorder, metrics registry and device telemetry are
dropped (tracing returns in a later slice); the columnar
window path (``columnar_ingest``) is replaced by the object path with
batched ingestion, which the reference tests as equivalent row for row.
"""

from __future__ import annotations

import hashlib
import heapq
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose, Timeout
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions, merge_drain
from hyperdrive_tpu_torch.testutil import (
    BroadcasterCallbacks,
    CatcherCallbacks,
    CommitterCallback,
    MockProposer,
    MockValidator,
)
from hyperdrive_tpu_torch.timer import VirtualTimer
from hyperdrive_tpu_torch.types import Height, Value

__all__ = ["VirtualClock", "SimulationResult", "Simulation"]


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
    alive: list[bool]
    #: The replay log; this package does not record runs yet.
    record: None = field(default=None)
    #: Per-replica certificate chain digests (``certificates=True`` runs).
    cert_digests: "list[str] | None" = None

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
    """Build and run one n-replica burst-mode scenario.

    ``sign=True`` gives every replica the deterministic Ed25519 keypair of
    the reference (``KeyRing.deterministic(n, namespace=b"sim-%d" % seed)``)
    and signs every broadcast. With ``burst=True`` and no
    ``batch_verifier``, the settle layer verifies through
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
    ``self._sched``; commits are gated until the covering drain.

    ``device_tally=True`` keeps the quorum counts in a
    :class:`~hyperdrive_tpu_torch.ops.votegrid.VoteGrid` on ``device``;
    ``tally_check`` (a callable ``(view, proc) -> view``, e.g.
    ``CheckedTallyView``) wraps every tally view. ``fused_min_window``: a
    lockstep settle of fewer messages (or a straggler settle of fewer
    distinct messages) runs fully on the host with the grid poisoned for
    the slots it bypasses; 0 = never. ``route_hysteresis`` N: when 95% of
    the last N routed settles went to the host, grid upkeep stops until a
    device-routed settle rebuilds it (0 = off).

    ``payload_bytes``, ``dedup_reconstruct`` (reconstruct each committed
    value once, not once per replica) and ``reconstructor``: the Shamir
    payload path (refused with ``pipeline_heights``). ``certificates``:
    a quorum certificate at every commit.
    """

    def __init__(
        self,
        n: int,
        target_height: Height,
        seed: int = 1,
        timeout: float = 1.0,
        timeout_scaling: float = 0.5,
        max_capacity: int = 1000,
        sign: bool = False,
        burst: bool = False,
        dedup_verify: bool = False,
        batch_verifier=None,
        small_window_host: Optional[bool] = None,
        device_tally: bool = False,
        tally_check=None,
        fused_min_window: int = 0,
        route_hysteresis: int = 32,
        pipeline_heights: Optional[bool] = None,
        pipeline_depth: int = 6,
        payload_bytes: int = 0,
        dedup_reconstruct: bool = True,
        reconstructor=None,
        certificates: bool = False,
        device="cuda",
        **unported,
    ):
        if unported:
            raise NotImplementedError(
                f"Simulation options {sorted(unported)} are not ported to "
                "the PyTorch package yet (a later slice of the port)"
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
                    "unit of pipelining)"
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
        if device_tally and not burst:
            raise ValueError(
                "device_tally requires burst=True with batched ingestion"
            )
        if not burst:
            raise NotImplementedError(
                "lock-step delivery (burst=False) is not ported to the "
                "PyTorch package yet (a later slice of the port)"
            )
        self.n = n
        self.f = n // 3
        self.target_height = target_height
        self.seed = seed
        self.clock = VirtualClock()
        self.queue: list[tuple[int, object]] = []
        self._qhead = 0
        self.batch_verifier = batch_verifier
        self.dedup_verify = dedup_verify
        self._small_win_host = None
        self.ring = None
        if sign:
            from hyperdrive_tpu_torch.crypto.keys import KeyRing

            self.ring = KeyRing.deterministic(n, namespace=b"sim-%d" % seed)
            self.signatories = self.ring.signatories
            if self.batch_verifier is None:
                from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

                self.batch_verifier = TorchBatchVerifier(device=device)
        else:
            self.signatories = [
                hashlib.sha256(b"sim-replica-%d-%d" % (seed, i)).digest()
                for i in range(n)
            ]
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
        #: The async device-work queue of a pipelined run (None otherwise);
        #: its drains finalize the gated commits (_on_sched_drain).
        self._sched = None
        if self._pipeline_heights:
            from hyperdrive_tpu_torch.devsched import DeviceWorkQueue

            self._sched = DeviceWorkQueue(max_depth=self._pipeline_depth)
            self._sched.on_drain = self._on_sched_drain
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
        self.alive = [True] * n
        self._pending_replicas = set(range(n))
        self.caught: list[tuple[str, int]] = []
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
        self.certificates_on = bool(certificates)
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
        self.replicas: list[Replica] = [
            self._build_replica(i, timeout, timeout_scaling, max_capacity)
            for i in range(n)
        ]
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
            self.vote_grid = VoteGrid(
                n, len(self.signatories), r_slots=4, device=device
            )
            self._grid_height = [-1] * n
            self._grid_dirty: list[set] = [set() for _ in range(n)]
            #: Engaged = the grid receives its per-settle upkeep (scatter
            #: bookkeeping, poison marks); _reengage_grid rebuilds it.
            self._grid_engaged = True
            self._route_hist: list = []
            self._route_hyst_thresh = -(-95 * self._route_hyst_n // 100)
            self._sender_pos = {s: v for v, s in enumerate(self.signatories)}
            #: Fused verify + merge + tally: available when the verifier
            #: exposes its batch kernel and its packer, and the run dedups
            #: verification (shared verdicts = shared merge).
            self._fused_ok = (
                dedup_verify
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

    def _build_replica(self, i, timeout, scaling, capacity) -> Replica:
        keypair = self.ring[i] if self.ring is not None else None

        def bcast(msg):
            # ONE queue entry per broadcast (to=-1: all live replicas); the
            # sender attaches its detached signature on the outbound edge.
            if keypair is not None:
                msg = keypair.sign_message(msg)
            self.queue.append((-1, msg))

        timer = VirtualTimer(
            _OwnedClock(self.clock, i),
            handler=None,
            timeout=timeout,
            timeout_scaling=scaling,
        )
        caught = self.caught
        proposer = MockProposer(fn=self._default_value)
        validator = MockValidator(ok=True)
        if self.payload_bytes:
            proposer = _PayloadProposer(self, self._default_value)
            validator = _PayloadValidator(self)
        certifier = None
        if self.certificates_on:
            from hyperdrive_tpu_torch.certificates import Certifier

            # Bind the batch verifier lazily: its last_transcript is the
            # launch that verified this commit's quorum (b"" on the
            # ladder and host paths).
            certifier = Certifier(
                list(self.signatories),
                self.f,
                transcript_source=lambda: getattr(
                    self.batch_verifier, "last_transcript", b""
                ),
            )
            self.certifiers.append(certifier)
        return Replica(
            ReplicaOptions(
                max_capacity=capacity, external_flush=True, batch_ingest=True
            ),
            self.signatories[i],
            list(self.signatories),
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
            certifier=certifier,
        )

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
            return (0, None)
        self.commits[i][height] = value
        if self.payload_bytes:
            self._reconstruct_commit(i, height, value)
        if height >= self.target_height:
            self._pending_replicas.discard(i)
        return (0, None)

    def _on_sched_drain(self, resolved: int) -> None:
        """Queue drain hook: every in-flight speculative settle just
        resolved (mismatches raise out of the drain itself), so gated
        commits are confirmed — finalize them in commit order."""
        self._spec_inflight = 0
        self._spec_rows = 0
        self._spec_last_fut = None
        gated = self._gated_commits
        self._gated_commits = []
        for i, height, value, _ in gated:
            self.commits[i][height] = value
            if height >= self.target_height:
                self._pending_replicas.discard(i)

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
            self.reconstruct_latency.append(time.perf_counter() - t0)
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

    def run(self, max_steps: int = 2_000_000) -> SimulationResult:
        """Start every replica and drive the network to the target height."""
        for r in self.replicas:
            r.start()
        return self._run_burst(max_steps)

    def _run_burst(self, max_steps: int) -> SimulationResult:
        """Superstep delivery: buffer every pending message, then settle
        the whole network through aggregated verification. Steps count
        deliveries (a broadcast is ``n`` of them), as in the reference."""
        steps = 0
        n = self.n
        replicas = self.replicas
        sched = self._sched
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
            shared = self._shared
            for to, msg in batch:
                if to < 0:
                    steps += n
                    shared.append(msg)
                    continue
                steps += 1
                replicas[to].handle(msg)
            self._shared = []
            self._settle(shared)

        if sched is not None:
            # No command may be dropped: the final drain resolves every
            # outstanding speculation (raising on a mismatch) and finalizes
            # the gated commits the result reports.
            sched.drain()
        return SimulationResult(
            completed=self._completed(),
            steps=steps,
            virtual_time=self.clock.now,
            heights=[r.current_height() for r in self.replicas],
            commits=self.commits,
            alive=self.alive,
            cert_digests=(
                [c.chain_digest() for c in self.certifiers]
                if self.certifiers else None
            ),
        )

    def _prune_clock(self) -> None:
        """Drop timeouts for heights every replica has already left (they
        would fire as no-ops: the Process height-guards every timeout)."""
        min_h = min(r.proc.current_height for r in self.replicas)
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
                    w = r.drain_pending()
                    if w:
                        windows.append((i, w))
            if not windows:
                return
            self.settle_passes += 1
            distinct = {id(w): w for _, w in windows}.values()
            if any(type(m) is not Propose for w in distinct for m in w):
                self.vote_settles += 1
            if self._pipeline_heights:
                self._settle_speculative(windows, shared_window)
                continue
            if self.device_tally:
                self._settle_tallied(windows, shared_window)
                continue
            keeps = self._verify_windows(windows, shared_window)
            self._dispatch_windows(windows, keeps)

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
            self._dispatch_windows(windows, keeps)
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
                self._note_route(True)
                self.host_routed_settles += 1
                keeps = self._verify_windows(
                    windows, shared_window, force_host=True
                )
                self._dispatch_windows(windows, keeps)
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
        self._note_route(True)
        self.host_routed_settles += 1
        keeps = self._verify_windows(windows, shared_window, force_host=True)
        self._dispatch_windows(windows, keeps)

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

    def _reengage_grid(self) -> None:
        """Rebuild the grid bookkeeping before a device-routed settle
        touches a disengaged grid: each replica's CURRENT height is claimed
        with every slot dirty (votes host-routed while disengaged never
        reached the grid); the next height's reset starts it clean."""
        if self._grid_engaged:
            return
        all_slots = self.vote_grid.all_slots()
        for i, r in enumerate(self.replicas):
            self._grid_height[i] = r.proc.current_height
            self._grid_dirty[i] = set(all_slots)
        self._grid_engaged = True
        self._route_hist.clear()

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

    def _dispatch_windows(self, windows, keeps) -> None:
        for (i, w), keep in zip(windows, keeps):
            self.replicas[i].dispatch_window(w, keep)

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
            fut = sched.submit(sched.verify_launcher(self.batch_verifier), items)
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
        self._dispatch_windows(windows, keeps)

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
        runs are bit-identical to host-tally mode."""
        from hyperdrive_tpu_torch.ops.tally import pack_value

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

        plans = [
            (i, self.replicas[i].ingest_insert_window(
                w, keep, make_hook(i, self._grid_dirty[i])))
            for (i, w), keep in zip(windows, keeps)
        ]
        # Matching targets are each replica's post-insert proposal value
        # per round slot; the L28 lane carries the cross-round
        # (valid_round, current proposal value) query.
        for i, _ in windows:
            fs[i] = self.replicas[i].proc.f
            (targets[i], tvalid[i], tmaps[i], l28_slot[i], l28_target[i],
             v) = self._targets(i, {}, None, self._grid_dirty[i])
            if v is not None:
                l28_vals[i] = v

        words = np.zeros((len(accepted), 8), dtype=np.int32)
        idx = np.zeros((len(accepted), 4), dtype=np.int32)
        for j, (i, plane, m) in enumerate(accepted):
            words[j] = pack_value(m.value)
            idx[j] = (i, plane, m.round, sender_pos[m.sender])
        counts = self.vote_grid.update_and_tally(
            idx, words, reset, targets, tvalid, l28_slot, l28_target, fs
        )
        self.tally_launches += 1
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
        keep = (fused_out.mask() & prevalid)[:nitems].tolist()
        counts = fused_out.counts()
        plans = [
            (i, self.replicas[i].ingest_insert_window(w, keep))
            for i, w in windows
        ]
        self._cascade(plans, counts, {i: h for i, _ in windows}, tmaps,
                      l28_slot, l28_vals)
        return True


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
