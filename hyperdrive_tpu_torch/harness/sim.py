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

Not ported (a later slice of the port), and refused: lock-step delivery
(``burst=False``), per-delivery adversaries, kills, the device vote grid,
pipelining, payloads, certificates, epochs, chaos, load, overlay,
execution and the record/replay log (``SimulationResult.record`` is
always None). The tracer, flight recorder, metrics registry and device
telemetry are dropped (tracing returns in a later slice); the columnar
window path is replaced by the object path with batched ingestion, which
the reference tests as equivalent row for row.
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Optional

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
        device="cuda",
        **unported,
    ):
        if unported:
            raise NotImplementedError(
                f"Simulation options {sorted(unported)} are not ported to "
                "the PyTorch package yet (a later slice of the port)"
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
        self.replicas: list[Replica] = [
            self._build_replica(i, timeout, timeout_scaling, max_capacity)
            for i in range(n)
        ]

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
        return Replica(
            ReplicaOptions(
                max_capacity=capacity, external_flush=True, batch_ingest=True
            ),
            self.signatories[i],
            list(self.signatories),
            timer,
            MockProposer(fn=self._default_value),
            MockValidator(ok=True),
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
        )

    # -------------------------------------------------------------- running

    def _on_commit(self, i: int, height: Height, value: Value):
        self.commits[i][height] = value
        if height >= self.target_height:
            self._pending_replicas.discard(i)
        return (0, None)

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
        while steps < max_steps and not self._completed():
            if self.clock.pending() > 65536:
                self._prune_clock()
            if self._qhead >= len(self.queue):
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

        return SimulationResult(
            completed=self._completed(),
            steps=steps,
            virtual_time=self.clock.now,
            heights=[r.current_height() for r in self.replicas],
            commits=self.commits,
            alive=self.alive,
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
            keeps = self._verify_windows(windows, shared_window)
            self._dispatch_windows(windows, keeps)

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

    def _verify_windows(self, windows, shared_window=None) -> list:
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
            mask = self._verify_items(items)
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
            mask = self._verify_items(items)
            keeps = [mask[a:b] for a, b in bounds]
        return keeps

    def _verify_items(self, items) -> list:
        """One aggregated signature verification, routed: sub-64-item
        windows go to the host verifier when small-window routing is on,
        everything else to the batch verifier."""
        self.verified_sigs += len(items)
        if self._small_win_host is not None and len(items) < 64:
            mask = self._small_win_host.verify_signatures(items)
        else:
            mask = self.batch_verifier.verify_signatures(items)
        return mask.tolist() if hasattr(mask, "tolist") else list(mask)
