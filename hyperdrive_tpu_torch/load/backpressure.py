"""The backpressure spine: admission levels, classification, shedding.

Overload handling before this module was three disconnected fragments:
TcpNode shed the oldest frame on per-peer queue overflow, the device
work queue auto-drained at ``max_depth`` with no signal back to
admission, and nothing distinguished a duplicate low-value vote from an
irreplaceable proposal when deciding what to drop. This module is the
connective tissue: a :class:`BackpressureController` turns pipeline
signals (device-queue depth, drain latency, peer send-queue occupancy)
into one admission level, and an :class:`AdmissionGate` applies that
level at every ingress (wire delivery, broadcast, mq insert, replica
buffering) with a fixed shed-class doctrine.

Admission levels (escalating)::

    ACCEPT             everything admitted
    SHED_DUPLICATES    exact duplicates and stale-height votes shed
    SHED_LOW_PRIORITY  + fresh prevotes from over-share peers shed
                         (per-peer fairness: a firehose peer cannot
                         starve the rest)
    CRITICAL_ONLY      + every fresh prevote shed; only proposals,
                         precommits, and certificates flow

Never shed, at any level: proposals (irreplaceable — there is exactly
one legitimate proposal per round), precommits (quorum-forming), and
certificates / unknown message types (aggregates outrank raw votes —
arXiv:1911.04698's shed policy). The first two levels are
*behavior-neutral*: the Process dedups votes and the replica
height-filters stale ones, so a run shedding only those classes commits
a byte-identical chain to the unloaded run — the chaos overload family
asserts exactly that. CRITICAL_ONLY trades prevote liveness for
survival and is the transient panic level; safety is never at stake
(shedding inputs is indistinguishable from message loss, which the
protocol tolerates by design).

De-escalation is hysteretic: the level steps down only after
``hysteresis`` consecutive clean polls, so a queue oscillating around a
threshold does not flap the gate.

Port copy of ``hyperdrive_tpu/load/backpressure.py``, whole: the
controller, the gate and the reputation table take the reference's
``registry=`` and ``obs=`` and emit its ``admission.*`` events and
counts.
"""

from __future__ import annotations

import threading

from hyperdrive_tpu_torch.load.frames import FRESH, QUERY, classify_frame
from hyperdrive_tpu_torch.messages import Prevote
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = [
    "ACCEPT",
    "SHED_DUPLICATES",
    "SHED_LOW_PRIORITY",
    "CRITICAL_ONLY",
    "LEVEL_NAMES",
    "SHED_CLASSES",
    "REPUTATION_WEIGHTS",
    "BackpressureController",
    "SignerReputation",
    "AdmissionGate",
]

ACCEPT = 0
SHED_DUPLICATES = 1
SHED_LOW_PRIORITY = 2
CRITICAL_ONLY = 3

#: Level index -> stable wire/report name.
LEVEL_NAMES = ("accept", "shed_duplicates", "shed_low_priority",
               "critical_only")

#: The closed shed-class vocabulary (ROBUSTNESS.md "Overload doctrine").
#: ``duplicate`` / ``stale_height`` are behavior-neutral; ``low_priority``
#: / ``panic`` trade prevote liveness for survival; ``query`` is the
#: read path — proof queries shed from SHED_LOW_PRIORITY up, always
#: ahead of any consensus frame (reads are idempotent and retryable, so
#: a read storm must never starve certificates); ``reputation`` is the
#: economic path — prevotes from signers whose signatures keep FAILING
#: device batch verify shed at EVERY level once the signer is demoted
#: (ROBUSTNESS.md "Adversarial economy"). There is deliberately no
#: class for proposals, precommits, or certificates — they are never
#: shed, and the soak asserts the counters for them stay absent.
SHED_CLASSES = ("duplicate", "stale_height", "low_priority", "panic",
                "query", "reputation")

#: Integer reputation deltas, mirroring the overlay's CHARGE_WEIGHTS
#: (overlay/score.py): ``verify_failed`` is the expensive verdict — the
#: frame passed every cheap admission check and died at device batch
#: verify, so it outweighs everything else the gate can observe.
REPUTATION_WEIGHTS = {"verify_failed": 6, "shed_while_demoted": 0}

# Classification (duplicate / stale detection and the dedup key shape)
# is shared with the overlay contribution scorer through
# load/frames.classify_frame — the two ingress paths must never drift
# on what counts as a duplicate or a stale frame.


class BackpressureController:
    """Fuses pipeline pressure signals into one admission level.

    Signals (each optional — unsupplied signals simply never escalate):

    - **device-queue depth** — :class:`~hyperdrive_tpu_torch.devsched.queue.
      DeviceWorkQueue` pushes its depth on every submit and its drain
      wall time on every drain once ``queue.controller`` is set (or
      call :meth:`watch`).
    - **drain latency** — seconds one coalesced drain took; a pipeline
      that still drains fast can absorb a deep queue, so latency gates
      the two upper levels rather than depth alone.
    - **peer send-queue occupancy** — worst per-peer outbound backlog
      as a fraction of capacity (TcpNode reports it on every shed-path
      broadcast).

    The level is the max over the per-signal levels, plus an optional
    ``floor`` (the sim's deterministic overload profiles pin the floor
    instead of modeling device time, keeping fixed-seed digests exact).
    Escalation is immediate; de-escalation needs ``hysteresis``
    consecutive polls that all map below the current level.
    """

    def __init__(
        self,
        queue=None,
        *,
        depth_duplicates: int = 8,
        depth_low_priority: int = 64,
        depth_critical: int = 256,
        drain_latency_s: float = 0.25,
        occupancy_low_priority: float = 0.5,
        occupancy_critical: float = 0.9,
        hysteresis: int = 3,
        registry=None,
        obs=None,
        time_fn=None,
        threadsafe: bool = False,
    ):
        self.depth_duplicates = int(depth_duplicates)
        self.depth_low_priority = int(depth_low_priority)
        self.depth_critical = int(depth_critical)
        self.drain_latency_s = float(drain_latency_s)
        self.occupancy_low_priority = float(occupancy_low_priority)
        self.occupancy_critical = float(occupancy_critical)
        self.hysteresis = max(1, int(hysteresis))
        self.registry = registry
        self.obs = obs if obs is not None else NULL_BOUND
        #: Clock for drain-latency timing in the watched queue (the sim
        #: passes its virtual clock; real deployments time.monotonic).
        #: None keeps drain latency at 0.0 — depth and occupancy still
        #: escalate, and fixed-seed runs stay wall-clock-free.
        self.time_fn = time_fn
        self._lock = threading.Lock() if threadsafe else None
        #: Pinned minimum level (load profiles / tests); raw signals can
        #: escalate above the floor but never de-escalate below it.
        self.floor = ACCEPT
        self.level = ACCEPT
        #: Level transitions (escalations + de-escalations), for tests
        #: and the overload report.
        self.transitions = 0
        self._depth = 0
        self._drain_s = 0.0
        self._occupancy = 0.0
        self._calm = 0
        if queue is not None:
            self.watch(queue)

    def watch(self, queue) -> None:
        """Attach to a DeviceWorkQueue: its submit/drain paths push
        depth and drain-latency signals here from then on."""
        queue.controller = self

    # ------------------------------------------------------------ signals

    def note_depth(self, depth: int) -> None:
        lock = self._lock
        if lock is None:
            self._depth = depth
            self._update()
        else:
            with lock:
                self._depth = depth
                self._update()

    def note_drain(self, resolved: int, latency_s: float) -> None:
        lock = self._lock
        if lock is None:
            self._drain_s = latency_s
            self._depth = 0
            self._update()
        else:
            with lock:
                self._drain_s = latency_s
                self._depth = 0
                self._update()

    def note_peer_occupancy(self, fraction: float) -> None:
        """Worst outbound peer-queue occupancy in [0, 1]."""
        lock = self._lock
        if lock is None:
            self._occupancy = fraction
            self._update()
        else:
            with lock:
                self._occupancy = fraction
                self._update()

    def poll(self) -> int:
        """Recompute (hysteresis advances on clean polls); returns the
        current level."""
        lock = self._lock
        if lock is None:
            self._update()
        else:
            with lock:
                self._update()
        return self.level

    # ------------------------------------------------------------ fusion

    def _raw_level(self) -> int:
        level = self.floor
        d = self._depth
        if d >= self.depth_critical:
            level = max(level, CRITICAL_ONLY)
        elif d >= self.depth_low_priority:
            level = max(level, SHED_LOW_PRIORITY)
        elif d >= self.depth_duplicates:
            level = max(level, SHED_DUPLICATES)
        if self._drain_s >= self.drain_latency_s:
            level = max(level, SHED_LOW_PRIORITY)
        occ = self._occupancy
        if occ >= self.occupancy_critical:
            level = max(level, CRITICAL_ONLY)
        elif occ >= self.occupancy_low_priority:
            level = max(level, SHED_LOW_PRIORITY)
        return level

    def _update(self) -> None:
        raw = self._raw_level()
        if raw > self.level:
            self._set(raw)
            self._calm = 0
        elif raw < self.level:
            self._calm += 1
            if self._calm >= self.hysteresis:
                self._set(raw)
                self._calm = 0
        else:
            self._calm = 0

    def _set(self, level: int) -> None:
        self.level = level
        self.transitions += 1
        if self.registry is not None:
            self.registry.set_gauge("admission.level", level)
            self.registry.count("admission.transitions")
        if self.obs is not NULL_BOUND:
            self.obs.emit("admission.level", -1, -1, LEVEL_NAMES[level])


class SignerReputation:
    """Per-signer verify-failure reputation: the admission gate's
    economic memory (ROBUSTNESS.md "Adversarial economy").

    A forged-but-well-formed signature passes every cheap admission
    check and dies only at device batch verify — the most expensive
    verdict in the pipeline. This table closes the loop: the drain path
    reports each signer's per-row verify outcome back here
    (:meth:`AdmissionGate.note_verify`), repeat offenders cross
    ``demote_at`` and their SUBSEQUENT prevotes shed at the gate — at
    every admission level — under the ``reputation`` class, before the
    verifier ever sees them.

    The mechanism deliberately mirrors the overlay's
    :class:`~hyperdrive_tpu_torch.overlay.score.ContributionScores`: integer
    arithmetic only (scores feed shed decisions, which feed digests),
    demotion at a threshold above a clamping floor so debt stays
    repayable, per-commit amnesty (:meth:`rehabilitate`) so no verdict
    is forever, and recovery credit for verified signatures. The
    doctrine asymmetry carries over too: an attacker re-earns its debt
    6 per failed row while amnesty forgives 1 per committed height.
    Scope is narrower than the overlay's advisory demotion, on purpose:
    only PREVOTES are reputation-shed — proposals, precommits and
    certificates stay never-shed, so a mis-charged honest signer loses
    redundant-vote bandwidth, never safety-critical reach.
    """

    def __init__(
        self,
        *,
        credit: int = 1,
        demote_at: int = -8,
        floor: int = -64,
        registry=None,
        obs=None,
    ):
        if demote_at <= floor:
            raise ValueError("demote_at must sit above the score floor")
        self.credit_per_verify = int(credit)
        self.demote_at = int(demote_at)
        self.floor = int(floor)
        self.registry = registry
        self.obs = obs if obs is not None else NULL_BOUND
        #: peer -> integer score (absent = 0). Peers are whatever the
        #: gate attributes frames to: validator indices in the campaign
        #: engines, signatory bytes at a real transport ingress.
        self.scores: dict = {}
        self.demoted: set = set()
        self.demotions = 0
        self.recoveries = 0
        #: class -> total charges (REPUTATION_WEIGHTS keys only).
        self.charges = {k: 0 for k in REPUTATION_WEIGHTS}
        #: peer -> charge count, the per-peer view metrics export.
        self.charges_by_peer: dict = {}

    def charge(self, peer, cls: str = "verify_failed") -> int:
        """Debit ``peer`` for one failed verify row; clamps at the
        floor so a long storm stays repayable in bounded credit."""
        weight = REPUTATION_WEIGHTS[cls]
        self.charges[cls] += 1
        self.charges_by_peer[peer] = self.charges_by_peer.get(peer, 0) + 1
        s = max(self.floor, self.scores.get(peer, 0) - weight)
        self.scores[peer] = s
        if self.registry is not None:
            self.registry.count("admission.reputation.charges", label=cls)
        if self.obs is not NULL_BOUND:
            self.obs.emit("admission.reputation.charge", -1, -1, cls)
        if s <= self.demote_at and peer not in self.demoted:
            self.demoted.add(peer)
            self.demotions += 1
            if self.registry is not None:
                self.registry.count("admission.reputation.demotions")
                self.registry.set_gauge(
                    "admission.reputation.demoted", len(self.demoted)
                )
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "admission.reputation.demote", -1, -1, _peer_label(peer)
                )
        return s

    def credit(self, peer, rows: int = 1) -> int:
        """Reward ``peer`` for ``rows`` signatures that VERIFIED —
        the recovery path out of demotion."""
        if rows <= 0:
            return self.scores.get(peer, 0)
        s = min(0, self.scores.get(peer, 0) + self.credit_per_verify * rows)
        self.scores[peer] = s
        self._maybe_recover(peer, s)
        return s

    def rehabilitate(self, amount: int = 1) -> None:
        """Per-commit amnesty: pull every debt ``amount`` toward zero.
        Bounds how long any verdict stays on the books — an attacker
        that stops forging eventually sheds its demotion, exactly like
        the overlay's per-height rehabilitation."""
        if amount <= 0:
            return
        for peer in list(self.scores):
            s = self.scores[peer]
            if s >= 0:
                continue
            s = min(0, s + amount)
            self.scores[peer] = s
            self._maybe_recover(peer, s)

    def _maybe_recover(self, peer, s: int) -> None:
        if peer in self.demoted and s > self.demote_at:
            self.demoted.discard(peer)
            self.recoveries += 1
            if self.registry is not None:
                self.registry.count("admission.reputation.recoveries")
                self.registry.set_gauge(
                    "admission.reputation.demoted", len(self.demoted)
                )
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "admission.reputation.recover", -1, -1, _peer_label(peer)
                )

    def is_demoted(self, peer) -> bool:
        return peer in self.demoted

    def snapshot(self) -> dict:
        return {
            "demoted": sorted(self.demoted, key=_peer_label),
            "demotions": self.demotions,
            "recoveries": self.recoveries,
            "charges": dict(self.charges),
            "min": min(self.scores.values()) if self.scores else 0,
        }


def _peer_label(peer) -> str:
    """Stable short label for a peer key (int index or signatory
    bytes) — the one rendering metrics labels, journal details and
    snapshots share, so the three views join on equal strings."""
    if isinstance(peer, (bytes, bytearray, memoryview)):
        return bytes(peer)[:4].hex()
    return str(peer)


class AdmissionGate:
    """Classify one message against the controller's level and decide
    admit/shed. One gate per ingress point (a TcpNode, a replica);
    gates share a controller, never dedup memory — duplicate detection
    is a local property of what *this* ingress already saw.

    ``height_fn`` supplies the consumer's current height so below-height
    votes classify as stale (they would be dropped by the replica's
    height filter anyway — shedding them earlier is behavior-neutral
    and saves the decode/buffer work). ``peer`` attribution on
    :meth:`admit` feeds per-peer fairness at SHED_LOW_PRIORITY; callers
    without transport-level peer identity fall back to the sender.

    ``reputation`` (optional) attaches a :class:`SignerReputation`:
    the drain path reports per-row verify outcomes via
    :meth:`note_verify`, and prevotes from demoted signers shed under
    the ``reputation`` class at EVERY level — the feedback loop that
    moves repeat forgers from the expensive post-verify shed to the
    cheap pre-verify one.
    """

    def __init__(
        self,
        controller: BackpressureController,
        *,
        height_fn=None,
        dedup_capacity: int = 65536,
        fair_window: int = 1024,
        fair_share: float = 0.5,
        reputation: "SignerReputation | None" = None,
        registry=None,
        obs=None,
        threadsafe: bool = False,
    ):
        self.controller = controller
        self.height_fn = height_fn
        self.dedup_capacity = int(dedup_capacity)
        self.fair_window = max(1, int(fair_window))
        self.fair_share = float(fair_share)
        self.reputation = reputation
        self.registry = registry
        self.obs = obs if obs is not None else NULL_BOUND
        self._lock = threading.Lock() if threadsafe else None
        #: Insertion-ordered dedup memory: vote key -> None, FIFO-evicted
        #: at ``dedup_capacity`` (a bounded bloom-like memory, exact
        #: within the window).
        self._mem: dict = {}
        #: peer -> admitted count inside the current fairness window.
        self._fair: dict = {}
        self._fair_seen = 0
        self.offered = 0
        self.admitted = 0
        #: shed-class name -> count. Only SHED_CLASSES names ever appear.
        self.shed: dict = {}
        #: peer -> total sheds attributed to that peer (any class).
        self.shed_by_peer: dict = {}
        #: peer -> rows of that peer's signatures batch verify REJECTED
        #: (the post-verify shed cost the reputation loop exists to cut).
        self.verify_failed_by_peer: dict = {}

    # ------------------------------------------------------------- admit

    def admit(self, msg, peer=None) -> bool:
        lock = self._lock
        if lock is None:
            return self._admit(msg, peer)
        with lock:
            return self._admit(msg, peer)

    def _admit(self, msg, peer) -> bool:
        self.offered += 1
        cls, key = classify_frame(
            msg, seen=self._mem, height_fn=self.height_fn
        )
        # Never-shed invariant: proposals, and anything that is not one
        # of the three vote types (certificates, resets, future message
        # kinds), classify keyless and pass at every level. Aggregates
        # outrank raw votes.
        if key is None:
            self._admitted()
            return True
        level = self.controller.level
        if cls is QUERY:
            # Read path: queries are the FIRST sheddable class once
            # load crosses SHED_LOW_PRIORITY — before any fresh vote,
            # and always before certificates (which classify keyless
            # above and never reach here). Admitted queries are not
            # remembered: reads dedup to nothing and must not evict
            # vote keys from the bounded memory.
            if level >= SHED_LOW_PRIORITY:
                return self._shed(msg, "query", peer)
            self._admitted()
            return True
        if level >= SHED_DUPLICATES and cls is not FRESH:
            # cls is the shed class verbatim: the classifier's closed
            # vocabulary intersects SHED_CLASSES on exactly the two
            # behavior-neutral classes the gate polices.
            return self._shed(msg, cls, peer)
        if type(msg) is Prevote:
            who = peer if peer is not None else msg.sender
            rep = self.reputation
            if rep is not None and rep.is_demoted(who):
                # The economic shed: level-independent (a demoted
                # forger is expensive at ANY load) and prevote-only
                # (proposals / precommits / certificates stay
                # never-shed, so a mis-charge costs redundant votes,
                # never quorum reach).
                rep.charges["shed_while_demoted"] += 1
                return self._shed(msg, "reputation", who)
            if level >= CRITICAL_ONLY:
                return self._shed(msg, "panic", who)
            if level >= SHED_LOW_PRIORITY:
                budget = max(1, int(self.fair_share * self.fair_window))
                if self._fair.get(who, 0) >= budget:
                    return self._shed(msg, "low_priority", who)
                self._fair_note(who)
        self._remember(key)
        self._admitted()
        return True

    def note_verify(self, peer, ok: bool, rows: int = 1) -> None:
        """Batch-verify feedback for ``rows`` of ``peer``'s signatures:
        the drain loop calls this per (signer, verdict) after the
        device/host verifier resolves a window. Failures charge the
        attached reputation (and count toward the per-peer post-verify
        cost the loop exists to cut); successes repay debt."""
        if not ok:
            self.verify_failed_by_peer[peer] = (
                self.verify_failed_by_peer.get(peer, 0) + rows
            )
            if self.registry is not None:
                self.registry.count(
                    "admission.verify_failed", rows, label=_peer_label(peer)
                )
            if self.reputation is not None:
                for _ in range(rows):
                    self.reputation.charge(peer, "verify_failed")
        elif self.reputation is not None:
            self.reputation.credit(peer, rows)

    # ---------------------------------------------------------- plumbing

    def _remember(self, key) -> None:
        mem = self._mem
        if key not in mem:
            mem[key] = None
            if len(mem) > self.dedup_capacity:
                mem.pop(next(iter(mem)))

    def _fair_note(self, who) -> None:
        self._fair_seen += 1
        if self._fair_seen >= self.fair_window:
            self._fair.clear()
            self._fair_seen = 0
        self._fair[who] = self._fair.get(who, 0) + 1

    def _admitted(self) -> None:
        self.admitted += 1
        if self.registry is not None:
            self.registry.count("admission.offered")
            self.registry.count("admission.admitted")

    def _shed(self, msg, cls: str, peer=None) -> bool:
        self.shed[cls] = self.shed.get(cls, 0) + 1
        if peer is not None:
            self.shed_by_peer[peer] = self.shed_by_peer.get(peer, 0) + 1
        if self.registry is not None:
            self.registry.count("admission.offered")
            self.registry.count("admission.shed", label=cls)
            if peer is not None:
                self.registry.count(
                    "admission.shed_by_peer", label=_peer_label(peer)
                )
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "admission.shed", msg.height, getattr(msg, "round", -1), cls
            )
        return False

    def snapshot(self) -> dict:
        """Counter view for soak assertions and the overload report."""
        snap = {
            "offered": self.offered,
            "admitted": self.admitted,
            "shed": dict(self.shed),
            "level": self.controller.level,
            "shed_by_peer": dict(self.shed_by_peer),
            "verify_failed_by_peer": dict(self.verify_failed_by_peer),
        }
        if self.reputation is not None:
            snap["reputation"] = self.reputation.snapshot()
        return snap
