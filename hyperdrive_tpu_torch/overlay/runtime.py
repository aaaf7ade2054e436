"""The aggregation overlay runtime: dissemination between replica and sim.

This is the dissemination layer: replicas broadcast votes
into it instead of all-to-all fan-out, and it moves them along the
seeded binomial tree (:mod:`.topology`) as **partial-aggregate frames**
— one frame carries a contributor's whole coverage of a (kind, height,
round) slot as a signer bitmask over a network-global deduplicated
vote table, so frame size is O(1) object-wise and the sim charges one
``delivery_cost`` per frame, not per constituent vote. That pricing is
the scalability claim made measurable: virtual commit latency counts
frames, frames per slot are O(n log n) against all-to-all's O(n²),
and BENCH_r09 plots exactly that ratio.

Determinism contract (lock-step): every decision the runtime makes —
contact order, wave escalation, fallback ranking, Byzantine fault
draws — is a function of the sim seed, the epoch anchor chain, and
the delivery order the sim already records. Constituent votes are
delivered to replicas *per message* and recorded as plain ``(to,
vote)`` tuples, so a dump replays through the ordinary record-driven
path with no overlay at all: topology, frames, and ticks are
reconstruction detail, never record format.

Robustness mechanics (Handel, arXiv:1906.05132):

- **Contribution scoring** (:mod:`.score`): every frame is credited by
  new-signer coverage delivered; invalid rows from the device verify
  mask, stale-generation extras (classified by the *shared*
  ``load/frames.py`` helper — the same predicate the AdmissionGate
  sheds on, so the two ingresses cannot drift), and withheld level
  windows are charged to the **contributing peer**, never the signer.
- **Windowed level ticks with fast-path completion**: levels activate
  by tick index (windowed) or instantly when the previous level's
  block completes (fast path — the happy-path cascade never waits).
- **Never-starve fallback**: when waves exhaust on a dark level the
  node direct-gossips its aggregate to score-ranked peers, demoted
  peers last but never excluded.
- **Verification dedup**: each vote is device-verified once
  network-wide (``verified`` mask), batched per frame through the
  :class:`~hyperdrive_tpu_torch.devsched.queue.DeviceWorkQueue` with
  ``generation=level`` so an aggregation level coalesces naturally and
  the per-row verdict mask isolates culprits.

Port copy of ``hyperdrive_tpu/overlay/runtime.py``. The decisions, the
frames and the accounting are the reference's, so an overlay run commits
the JAX package's chain in the JAX package's steps, and the wire-budget
hooks are the reference's: the ``overlay.partial`` budget and the HDS005
charge at every partial frame's ingress (``wire_charge``). The recorder handle
(``obs``) and the metrics registry (``registry``) take the reference's
``overlay.*`` and ``bls.partial.reject`` events and counts. The verify
launcher and the :class:`~hyperdrive_tpu_torch.
ops.g1.G1SumLauncher` that the runtime submits to run where the sim puts
them: on the card by default (``ed25519_verify`` and ``g1_aggregate``).
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

from hyperdrive_tpu_torch.analysis.annotations import declare_wire_budget
from hyperdrive_tpu_torch.analysis.sanitizer import wire_charge
from hyperdrive_tpu_torch.load.frames import STALE_GENERATION, classify_frame
from hyperdrive_tpu_torch.messages import Precommit, Prevote

from .score import ContributionScores
from .topology import Topology

#: HDS005 budget for one partial-aggregate frame, as it would cost on a
#: wire: header + committee-wide mask + 48-byte BLS aggregate + one
#: full-envelope extra per committee member (the worst legal frame under
#: the on_frame shape caps). Object frames charge an ESTIMATE of this
#: footprint at ingress; the sanitizer fires only if the caps and this
#: budget drift apart.
declare_wire_budget("overlay.partial", 1 << 20)
#: Wire-size estimate for one extras envelope (signed vote riding
#: outside the table): 8 + 8 + 32 + 32 + 64 plus framing slack.
_EXTRA_WIRE_BYTES = 160

__all__ = [
    "OverlayConfig",
    "OverlayFaults",
    "OverlayFrame",
    "OverlayTick",
    "OverlayRuntime",
]

_PREVOTE, _PRECOMMIT = 1, 2
_VOTE_TAG = {Prevote: _PREVOTE, Precommit: _PRECOMMIT}
_VOTE_CLS = {_PREVOTE: Prevote, _PRECOMMIT: Precommit}

#: Seed salt for the Byzantine-contributor RNG ("OVLY"), disjoint from
#: the chaos ("CHOS") and churn ("EPOC") salts so composed fault plans
#: never share a stream.
_BYZ_SALT = 0x4F564C59


@dataclass(frozen=True)
class OverlayFaults:
    """Byzantine-contributor behavior for overlay chaos runs.

    Members of ``byzantine`` keep voting honestly (they are *signers*
    in good standing — the attack surface is the dissemination role):
    they withhold frames on the listed levels and replace a seeded
    fraction of the rest with garbage partial aggregates (empty
    coverage plus fabricated votes that fail device verification, a
    ``stale_rate`` slice of them signed under retired identities so
    the stale-generation charge path is exercised end-to-end).
    """

    byzantine: tuple = ()
    withhold_levels: tuple = ()
    garbage_rate: float = 0.35
    stale_rate: float = 0.25

    def validate(self, n: int) -> None:
        f = n // 3
        bad = sorted(set(int(b) for b in self.byzantine))
        if len(bad) != len(self.byzantine):
            raise ValueError("duplicate byzantine contributor indices")
        if any(b < 0 or b >= n for b in bad):
            raise ValueError(f"byzantine contributor out of range for n={n}")
        if len(bad) > f:
            raise ValueError(
                f"{len(bad)} byzantine contributors exceeds f={f} for n={n}"
            )
        if any(l < 0 for l in self.withhold_levels):
            raise ValueError("withhold levels must be >= 0")
        if not 0.0 <= self.garbage_rate <= 1.0:
            raise ValueError("garbage_rate must be within [0, 1]")
        if not 0.0 <= self.stale_rate <= 1.0:
            raise ValueError("stale_rate must be within [0, 1]")


@dataclass(frozen=True)
class OverlayConfig:
    """``Simulation(overlay=OverlayConfig(...))`` — dissemination knobs.

    ``level_window=None`` auto-scales the tick window to
    ``2 * n * delivery_cost``: the shared virtual clock advances once
    per frame network-wide, so a window that does not scale with n
    would fire withhold charges at honest peers whose frames are merely
    still in the global queue.
    """

    fanout: int = 2
    max_waves: int = 3
    fallback_fanout: int = 2
    level_window: float | None = None
    #: Deliver at most quorum (2f+1) constituent votes per (replica,
    #: value) — enough for every protocol rule, and the reason replica
    #: ingest work stays O(quorum) instead of O(n) at 4096.
    #: Batch a frame's constituents through ``handle_coalesced``
    #: instead of per-message ``handle`` — reserved for unrecorded
    #: mega-committee benches; per-message is the replay-exact default.
    coalesce_ingest: bool = False
    faults: OverlayFaults | None = None
    credit: int = 2
    demote_at: int = -8
    score_floor: int = -64
    #: Per-committed-height amnesty: every nonzero score moves this
    #: many points toward zero (ContributionScores.rehabilitate). This
    #: is what makes demotion recoverable after a long fault window —
    #: a partitioned peer looks exactly like a withholder to every
    #: observer and racks up charges for the whole window, so without
    #: time-based forgiveness the hole can exceed what contribution
    #: credit alone can refill before the run ends.
    heal_rate: int = 6
    #: Frames carry real BLS partial aggregates: each signer's G1
    #: partial over its vote digest enters the global table alongside
    #: the vote, every frame's mask is accompanied by the 48-byte
    #: compressed sum of the covered partials, and the receiver
    #: recomputes that sum (batched through the device queue's G1-sum
    #: launcher, generation=level) BEFORE merging coverage — a garbled
    #: partial aggregate charges its contributor at the merge level,
    #: without ever reaching the signature batch-verify.
    bls_partials: bool = False

    def validate(self, n: int) -> None:
        if self.fanout < 1 or self.fallback_fanout < 1:
            raise ValueError("overlay fanout values must be >= 1")
        if self.max_waves < 1:
            raise ValueError("overlay max_waves must be >= 1")
        if self.level_window is not None and self.level_window <= 0.0:
            raise ValueError("overlay level_window must be positive")
        if self.heal_rate < 0:
            raise ValueError("overlay heal_rate must be >= 0")
        if self.faults is not None:
            self.faults.validate(n)


class OverlayFrame:
    """One partial-aggregate message: contributor ``src``'s coverage of
    ``slot`` as a signer bitmask, plus any out-of-table ``extras``
    (only Byzantine injection produces those). ``agg`` is the 48-byte
    compressed BLS partial aggregate over the mask's covered partials
    (``bls_partials`` runs; None otherwise). Never recorded."""

    __slots__ = ("src", "slot", "level", "mask", "extras", "reciprocal",
                 "fallback", "agg")

    def __init__(self, src, slot, level, mask, extras=(),
                 reciprocal=False, fallback=False, agg=None):
        self.src = src
        self.slot = slot
        self.level = level
        self.mask = mask
        self.extras = extras
        self.reciprocal = reciprocal
        self.fallback = fallback
        self.agg = agg

    @property
    def height(self):
        return self.slot[1]


class OverlayTick:
    """A node's per-slot level-window timer, riding the sim's virtual
    clock like a Timeout (and pruned by height the same way)."""

    __slots__ = ("slot", "height")

    def __init__(self, slot):
        self.slot = slot
        self.height = slot[1]


class _SlotState:
    """All per-(kind, height, round) dissemination state."""

    __slots__ = ("votes", "all_mask", "verified", "cov", "t0", "tick_idx",
                 "armed", "done", "fb_pos", "waves", "dcount", "heard",
                 "charged", "recip", "frames_seen", "bls")

    def __init__(self, n: int, levels: int):
        self.votes: dict = {}          # signer slot -> verified-or-own vote
        self.bls: dict = {}            # signer slot -> BLS partial (G1 affine)
        self.all_mask = 0              # union of table bits
        self.verified = 0              # bits verified once network-wide
        self.cov = [0] * n             # per-node coverage bitmask
        self.t0 = [None] * n           # activation time per node
        self.tick_idx = [0] * n
        self.armed = [False] * n
        self.done = [False] * n
        self.fb_pos = [0] * n
        self.waves: dict = {}          # node -> per-level wave pointer
        self.dcount: dict = {}         # node -> {value: delivered count}
        self.heard: dict = {}          # node -> set of contributors heard
        self.charged: dict = {}        # node -> peers already withhold-charged
        self.recip: dict = {}          # node -> peers already reciprocated
        self.frames_seen: dict = {}    # node -> exact frames seen (dup charge)

    def wave_of(self, node: int, levels: int) -> list:
        w = self.waves.get(node)
        if w is None:
            w = self.waves[node] = [0] * (levels + 1)
        return w


def _bits(mask: int):
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


class OverlayRuntime:
    """One sim's overlay instance; the sim owns delivery and the clock,
    the runtime owns topology, coverage, scoring, and fault injection."""

    def __init__(
        self,
        config: OverlayConfig,
        *,
        n: int,
        seed: int,
        anchor: bytes,
        identities,
        quorum: int,
        delivery_cost: float,
        enqueue,          # (to, frame) -> sim queue append
        schedule,         # (delay, tick, owner) -> clock schedule
        now,              # () -> virtual time
        deliver,          # (to, [votes]) -> record + replica ingest
        alive,            # shared sim liveness list
        order_pos,        # shared identity -> slot index map
        retired,          # shared retired identity -> first stale height
        verifier=None,    # shared verifier for dedup verification (sign mode)
        sched=None,       # DeviceWorkQueue (required when verifier is set)
        obs=None,
        registry=None,
        bls_keyring=None,  # identity -> BlsKeyPair (bls_partials runs)
        device=None,      # where the G1SumLauncher sums (None: the card)
    ):
        config.validate(n)
        self.config = config
        self.n = n
        self.seed = int(seed)
        self.quorum = int(quorum)
        self.epoch = 0
        self.topo = Topology(seed, anchor, identities)
        self.window = (
            config.level_window
            if config.level_window is not None
            else 2.0 * n * delivery_cost
        )
        self._enqueue = enqueue
        self._schedule = schedule
        self._now = now
        self._deliver = deliver
        self._alive = alive
        self._order_pos = order_pos
        self._retired = retired
        self._verifier = verifier
        self._sched = sched
        if verifier is not None and sched is None:
            raise ValueError("overlay verification requires a device queue")
        self._obs = obs
        self._reg = registry
        #: BLS partial-aggregate plumbing (config.bls_partials): the
        #: shared committee keyring signs each own-vote's digest into
        #: the global table; masked partial sums ride every frame. With
        #: a device queue the sums run through the G1SumLauncher
        #: (generation=level, so one level's merges coalesce); without
        #: one they fold on host — byte-identical aggregates either way.
        self._bls_keyring = bls_keyring
        self._bls_launcher = None
        if bls_keyring is not None and sched is not None:
            from hyperdrive_tpu_torch.ops.g1 import G1SumLauncher

            width = 1
            while width < max(n, 1):
                width *= 2
            self._bls_launcher = G1SumLauncher(width, device=device)
        self._byz_rng = random.Random((self.seed << 1) ^ _BYZ_SALT)
        self._faults = config.faults
        self._byz = frozenset(self._faults.byzantine) if self._faults else frozenset()
        self._withhold = frozenset(self._faults.withhold_levels) if self._faults else frozenset()
        self.scores = ContributionScores(
            n,
            credit=config.credit,
            demote_at=config.demote_at,
            floor=config.score_floor,
            on_demote=self._on_demote,
            on_recover=self._on_recover,
        )
        self._slots: dict = {}
        self._floor = 0
        # Commit floor at each peer's most recent charge: the monitor's
        # permanent-demotion check only fires once enough floor has
        # advanced past this point that rehabilitation should have
        # recovered the peer.
        self._last_charge_floor: dict = {}
        self._garbage_ctr = 0
        # Accounting (overlay_snapshot, the chip smoke's overlay lines).
        self.frames_sent = 0
        self.frames_reciprocal = 0
        self.frames_fallback = 0
        self.frames_garbage = 0
        self.frames_withheld = 0
        self.votes_delivered = 0
        self.verify_rows = 0
        self.level_timeouts = 0
        self.fallback_engaged = 0
        self.windows_exhausted = 0
        self.rekeys = 0
        self.bls_partials_attached = 0
        self.bls_partial_rejects = 0
        #: Frames rejected at the shape caps (mask wider than the
        #: committee, extras flood) before any state was touched.
        self.frame_rejects = 0

    # -------------------------------------------------------------- events

    def _emit(self, kind, node, slot, detail=None):
        if self._obs is not None:
            self._obs.emit(kind, node, slot[1], slot[2], detail)

    def _count(self, name, k=1):
        if self._reg is not None:
            self._reg.count(name, k)

    def _on_demote(self, peer, score, cls):
        self._count("overlay.demotions")
        if self._obs is not None:
            self._obs.emit("overlay.demote", peer, 0, 0, f"{cls}:{score}")

    def _on_recover(self, peer, score):
        self._count("overlay.recoveries")
        if self._obs is not None:
            self._obs.emit("overlay.recover", peer, 0, 0, str(score))

    # ------------------------------------------------------------ lifecycle

    def rekey(self, anchor: bytes, identities, epoch: int) -> None:
        """Epoch boundary: rebuild the tree off the new anchor digest and
        rotated identity set. Coverage masks are slot-indexed, so
        in-flight slots carry across; only positions re-key."""
        self.topo = Topology(self.seed, anchor, identities)
        self.epoch = int(epoch)
        self.rekeys += 1
        self._count("overlay.rekeys")
        if self._obs is not None:
            self._obs.emit("overlay.rekey", -1, 0, 0,
                           f"epoch={epoch}:{self.topo.digest().hex()[:12]}")

    def note_commit(self, height: int) -> None:
        """Advance the slot floor: votes for heights below ``height - 1``
        can no longer change any honest replica (catch-up resyncs
        laggards; the overlay has no retransmission duty, matching the
        protocol's no-retransmission doctrine)."""
        floor = height - 1
        if floor <= self._floor:
            return
        # One amnesty step per height the floor actually advances over
        # (note_commit arrives once per replica per height; the floor
        # guard above dedupes). Integer, network-wide, replay-safe.
        self.scores.rehabilitate((floor - self._floor) *
                                 self.config.heal_rate)
        self._floor = floor
        dead = [s for s in self._slots if s[1] < floor]
        for s in dead:
            del self._slots[s]

    # --------------------------------------------------------------- ingress

    def on_broadcast(self, node: int, vote) -> None:
        """A replica's own vote enters the overlay (the sim already
        queued its self-delivery): seed the table, activate the node's
        tree participation for the slot."""
        tag = _VOTE_TAG.get(type(vote))
        if tag is None or vote.height < self._floor:
            return
        slot = (tag, vote.height, vote.round)
        st = self._slot(slot)
        idx = self._order_pos.get(vote.sender)
        if idx is not None and idx not in st.votes:
            st.votes[idx] = vote
            bit = 1 << idx
            st.all_mask |= bit
            if self._bls_keyring is not None:
                # The signer's BLS partial enters the global table with
                # the vote (in a deployment it rides the vote message).
                # Bits added through the Byzantine extras path never
                # gain a partial, so per bit the has-partial status is
                # fixed at insertion — sender and receiver of any frame
                # always sum the identical subset.
                kp = self._bls_keyring.get(vote.sender)
                if kp is not None:
                    st.bls[idx] = kp.sign(vote.digest())
            # NOT marked verified: the signer trusts its own vote (its
            # replica ingests it directly), but the first frame carrying
            # it to anyone else pays the one network-wide device
            # verification, batched with the rest of that frame's new
            # coverage under generation=level.
            st.cov[node] |= bit
            st.done[node] = False
        self._touch(st, slot, node)
        self._arm(st, slot, node)

    def on_frame(self, to: int, frame: OverlayFrame) -> None:
        # Byzantine frame-shape caps, enforced before ANY state mutation:
        # a mask wider than the committee or an extras flood is a typed
        # rejection scored against the contributor — never an unbounded
        # merge, never a crash.
        if (frame.mask < 0 or frame.mask.bit_length() > self.n
                or len(frame.extras) > self.n):
            self.frame_rejects += 1
            self._count("overlay.frame.reject")
            self._charge(frame.src, "invalid", frame.slot, to)
            return
        # HDS005: charge the frame's estimated wire footprint against
        # the declared overlay budget (object seam, no byte decode).
        wire_charge(
            "overlay.partial",
            16 + (frame.mask.bit_length() + 7) // 8 + 48
            + _EXTRA_WIRE_BYTES * len(frame.extras),
        )
        slot = frame.slot
        st = self._slots.get(slot)
        if st is None:
            if slot[1] < self._floor:
                return
            st = self._slot(slot)
        src = frame.src
        st.heard.setdefault(to, set()).add(src)
        self._touch(st, slot, to)

        # Byzantine extras: votes riding outside the global table. The
        # shared classifier (load/frames.py) is the stale-generation
        # authority here, exactly as it is for the AdmissionGate.
        for v in frame.extras:
            cls, _ = classify_frame(v, retired=self._retired)
            if cls is STALE_GENERATION:
                self._charge(src, "stale_generation", slot, to)
                continue
            idx = self._order_pos.get(v.sender)
            if idx is None or not self._verify_extra(v, frame.level, to):
                self._charge(src, "invalid", slot, to)
                continue
            if idx not in st.votes:
                st.votes[idx] = v
                st.all_mask |= 1 << idx
                st.verified |= 1 << idx

        # Coverage claims with no table backing are lies, not lag: the
        # table strictly precedes any mask bit a correct peer can send.
        phantom = frame.mask & ~st.all_mask
        if phantom:
            self._charge(src, "invalid", slot, to)
        # Merge-level BLS check: recompute the masked partial sum and
        # compare against the frame's aggregate BEFORE any coverage is
        # merged or any signature batch-verified. A garbled partial
        # aggregate charges the CONTRIBUTOR here and drops the frame —
        # the poisoned aggregate never propagates and never costs a
        # verify launch.
        if self._bls_keyring is not None and frame.mask:
            expect = self._bls_masked_sum(
                st, frame.mask & st.all_mask, frame.level, to
            )
            if frame.agg != expect:
                self.bls_partial_rejects += 1
                self._count("overlay.bls.reject")
                if self._obs is not None:
                    self._obs.emit("bls.partial.reject", to, slot[1],
                                   slot[2], f"src={src}:lvl={frame.level}")
                self._charge(src, "invalid", slot, to)
                return
        new = frame.mask & st.all_mask & ~st.cov[to]
        if new:
            pending = new & ~st.verified
            if pending and self._verifier is not None:
                ok = self._verify_mask(st, pending, frame.level, to)
                bad = pending & ~ok
                for _ in _bits(bad):
                    self._charge(src, "invalid", slot, to)
                st.verified |= ok
                new &= ~bad
        if new:
            self._deliver_new(to, st, slot, new)
            st.cov[to] |= new
            self.scores.credit_coverage(src, new.bit_count())
            self._emit("overlay.frame", to, slot,
                       f"src={src}:lvl={frame.level}:new={new.bit_count()}")
            st.done[to] = False
            self._advance(to, st, slot)
            self._arm(st, slot, to)
        elif not frame.fallback and not frame.reciprocal:
            # Redundant coverage is normal tree behavior — only an
            # *exact* repeat of a TREE frame this node already saw is
            # spam. Fallback and reciprocal frames are exempt: they are
            # the designed-redundancy rescue paths, and a node stuck
            # behind a partition re-advertises the same aggregate every
            # window until someone pushes it the gap — charging that
            # would demote exactly the peers the never-starve doctrine
            # exists to rescue.
            key = (src, frame.level, frame.mask, bool(frame.extras))
            seen = st.frames_seen.setdefault(to, set())
            if key in seen:
                self._charge(src, "duplicate", slot, to)
            else:
                seen.add(key)
        if not frame.reciprocal:
            self._reciprocate(to, src, st, slot, frame)

    def on_tick(self, node: int, tick: OverlayTick) -> None:
        slot = tick.slot
        st = self._slots.get(slot)
        if st is None:
            return
        st.armed[node] = False
        if not self._alive[node] or st.done[node] or slot[1] < self._floor:
            return
        k = st.tick_idx[node]
        st.tick_idx[node] = k + 1
        waves = st.wave_of(node, self.topo.levels)
        incomplete = False
        exhausted = True
        for lvl in range(1, self.topo.levels + 1):
            if self._complete(node, st, lvl):
                continue
            incomplete = True
            if waves[lvl] == 0:
                if lvl <= k + 2:
                    # Windowed activation: level lvl opens at tick lvl-2
                    # even if lower levels are dark (Handel's parallel
                    # levels — a stalled level never serializes the tree).
                    self._send_wave(node, st, slot, lvl, 0)
                    waves[lvl] = 1
                exhausted = False
            elif waves[lvl] <= self.config.max_waves:
                self.level_timeouts += 1
                self._count("overlay.timeouts")
                self._emit("overlay.level.timeout", node, slot,
                           f"lvl={lvl}:wave={waves[lvl]}")
                self._charge_withheld(node, st, slot, lvl, waves[lvl] - 1)
                self._send_wave(node, st, slot, lvl, waves[lvl])
                waves[lvl] += 1
                exhausted = False
        missing_known = st.cov[node] != st.all_mask
        if incomplete and exhausted and missing_known:
            self.windows_exhausted += 1
            # Every wave spent, the node still lacks votes the network
            # holds: ranked direct gossip advertises its aggregate so a
            # reciprocal push can fill the gap (never-starve).
            self._fallback(node, st, slot)
        if not incomplete or (exhausted and not missing_known):
            # Tree complete, or the node holds everything the network
            # knows and has no waves left to spend — go idle; a frame
            # bearing new coverage re-arms it.
            st.done[node] = True
        else:
            self._arm(st, slot, node)

    # ------------------------------------------------------------- internals

    def _slot(self, slot) -> _SlotState:
        st = self._slots.get(slot)
        if st is None:
            st = self._slots[slot] = _SlotState(self.n, self.topo.levels)
        return st

    def _touch(self, st: _SlotState, slot, node: int) -> None:
        if st.t0[node] is None:
            st.t0[node] = self._now()
            self._advance(node, st, slot)
            self._arm(st, slot, node)

    def _arm(self, st: _SlotState, slot, node: int) -> None:
        if not st.armed[node]:
            st.armed[node] = True
            self._schedule(self.window, OverlayTick(slot), node)

    def _complete(self, node: int, st: _SlotState, level: int) -> bool:
        bm = self.topo.block_mask(node, level)
        return st.cov[node] & bm == bm

    def _advance(self, node: int, st: _SlotState, slot) -> None:
        """Fast-path completion: the instant level ``l-1``'s block is
        whole, open level ``l`` without waiting for its tick window."""
        waves = st.wave_of(node, self.topo.levels)
        for lvl in range(1, self.topo.levels + 1):
            if waves[lvl] == 0 and (lvl == 1 or self._complete(node, st, lvl - 1)):
                self._send_wave(node, st, slot, lvl, 0)
                waves[lvl] = 1
            if not self._complete(node, st, lvl):
                break

    def _send_wave(self, node: int, st: _SlotState, slot, level: int,
                   wave: int) -> None:
        fo = self.config.fanout
        contacts = self.topo.contacts(node, level, (wave + 1) * fo)
        for peer in contacts[wave * fo:(wave + 1) * fo]:
            self._send_frame(node, peer, st, slot, level)

    def _send_frame(self, node: int, peer: int, st: _SlotState, slot,
                    level: int, reciprocal=False, fallback=False) -> None:
        if peer == node:
            return
        if node in self._byz:
            if level in self._withhold:
                self.frames_withheld += 1
                self._count("overlay.withheld_by_fault")
                return
            if self._byz_rng.random() < self._faults.garbage_rate:
                self._send_garbage(node, peer, slot, level)
                return
        mask = st.cov[node]
        if not mask:
            return
        agg = None
        if self._bls_keyring is not None:
            agg = self._bls_masked_sum(st, mask, level, node)
            self.bls_partials_attached += 1
        frame = OverlayFrame(node, slot, level, mask,
                             reciprocal=reciprocal, fallback=fallback,
                             agg=agg)
        self.frames_sent += 1
        self._count("overlay.frames")
        if reciprocal:
            self.frames_reciprocal += 1
            self._count("overlay.frames.reciprocal")
        if fallback:
            self.frames_fallback += 1
            self._count("overlay.frames.fallback")
        self._enqueue(peer, frame)

    def _send_garbage(self, node: int, peer: int, slot, level: int) -> None:
        """A Byzantine partial aggregate: zero real coverage, fabricated
        votes that the device verify mask will reject row-by-row — or,
        on BLS runs, a frame claiming the contributor's REAL coverage
        under a corrupted partial aggregate, which the receiver's
        merge-level sum check must catch before any verify launch."""
        st = self._slots.get(slot)
        if (self._bls_keyring is not None and st is not None
                and st.cov[node] and self._byz_rng.random() < 0.5):
            mask = st.cov[node]
            good = self._bls_masked_sum(st, mask, level, node)
            bad = (bytes([good[0] ^ 0x01]) + good[1:]) if good \
                else b"\xff" * 48
            frame = OverlayFrame(node, slot, level, mask, agg=bad)
            self.frames_sent += 1
            self.frames_garbage += 1
            self._count("overlay.frames")
            self._count("overlay.frames.garbage")
            self._enqueue(peer, frame)
            return
        self._garbage_ctr += 1
        cls = _VOTE_CLS[slot[0]]
        stale = None
        if self._retired and self._byz_rng.random() < self._faults.stale_rate:
            # Replay under a retired identity: exercises the shared
            # stale-generation classifier, not the verify mask.
            stale = min(self._retired)
        sender = stale if stale is not None else hashlib.sha256(
            b"hd-overlay-garbage" + self._garbage_ctr.to_bytes(8, "little")
        ).digest()
        value = hashlib.sha256(
            b"hd-overlay-garbage-value" + self._garbage_ctr.to_bytes(8, "little")
        ).digest()
        fake = cls(height=slot[1], round=slot[2], value=value,
                   sender=sender, signature=b"\x00" * 64)
        frame = OverlayFrame(node, slot, level, 0, extras=(fake,))
        self.frames_sent += 1
        self.frames_garbage += 1
        self._count("overlay.frames")
        self._count("overlay.frames.garbage")
        self._enqueue(peer, frame)

    def _reciprocate(self, to: int, src: int, st: _SlotState, slot,
                     frame: OverlayFrame) -> None:
        """Bidirectional exchange (Handel sessions are two-way): if the
        receiver holds coverage the sender's mask lacks, push it back —
        once per (receiver, sender, slot) — so a node whose own contact
        waves go dark is still fed by everyone who contacts *it*."""
        if src == to:
            return
        extra = st.cov[to] & ~frame.mask
        if not extra:
            return
        done = st.recip.setdefault(to, set())
        if src in done:
            return
        done.add(src)
        self._send_frame(to, src, st, slot, frame.level, reciprocal=True)

    def _fallback(self, node: int, st: _SlotState, slot) -> None:
        """Ranked direct gossip once every wave is spent: never-starve.
        Demoted peers rank last but stay reachable; the cursor walks the
        whole ring so repeated fallbacks cover different peers."""
        ranked = self.scores.ranked(exclude=node)
        if not ranked:
            return
        self.fallback_engaged += 1
        self._count("overlay.fallback")
        self._emit("overlay.fallback", node, slot, f"pos={st.fb_pos[node]}")
        pos = st.fb_pos[node]
        for _ in range(min(self.config.fallback_fanout, len(ranked))):
            peer = ranked[pos % len(ranked)]
            pos += 1
            self._send_frame(node, peer, st, slot, 0, fallback=True)
        st.fb_pos[node] = pos

    def _charge_withheld(self, node: int, st: _SlotState, slot, level: int,
                         wave: int) -> None:
        fo = self.config.fanout
        contacts = self.topo.contacts(node, level, (wave + 1) * fo)
        heard = st.heard.get(node, ())
        charged = st.charged.setdefault(node, set())
        for peer in contacts[wave * fo:(wave + 1) * fo]:
            if peer not in heard and peer not in charged:
                charged.add(peer)
                self._charge(peer, "withheld", slot, node)

    def _charge(self, peer: int, cls: str, slot, observer: int) -> None:
        self.scores.charge(peer, cls)
        self._last_charge_floor[peer] = self._floor
        self._count("overlay." + cls)
        kind = {
            "invalid": "overlay.invalid",
            "stale_generation": "overlay.stale",
            "duplicate": "overlay.duplicate",
            "withheld": "overlay.withhold",
        }[cls]
        self._emit(kind, observer, slot, f"peer={peer}")

    def _deliver_new(self, to: int, st: _SlotState, slot, new: int) -> None:
        """Materialize newly-covered votes from the global table and hand
        them to the replica, capped at quorum per (replica, value)."""
        dc = st.dcount.setdefault(to, {})
        out = []
        for idx in _bits(new):
            v = st.votes[idx]
            c = dc.get(v.value, 0)
            if c < self.quorum:
                dc[v.value] = c + 1
                out.append(v)
        if out:
            self.votes_delivered += len(out)
            self._count("overlay.votes.delivered", len(out))
            self._deliver(to, out)

    # ---------------------------------------------------------- verification

    def _bls_masked_sum(self, st: _SlotState, mask: int, level: int,
                        origin: int) -> bytes:
        """Compressed G1 sum of the table partials covered by ``mask``
        (bits without a partial — extras-path insertions — are excluded
        on both the sending and receiving side, so the subset is always
        identical). Device-batched through the queue when a launcher is
        installed; host fold otherwise."""
        pts = [st.bls[i] for i in _bits(mask) if i in st.bls]
        from hyperdrive_tpu_torch.crypto import bls

        if not pts:
            return b""
        if self._bls_launcher is not None:
            fut = self._sched.submit(
                self._bls_launcher, pts,
                generation=level, origin=origin, rows=len(pts),
            )
            self._sched.drain()
            agg = fut.result()
        else:
            agg = bls.aggregate_signatures(pts)
        return bls.g1_compress(agg)

    def _verify_mask(self, st: _SlotState, pending: int, level: int,
                     origin: int) -> int:
        idxs = list(_bits(pending))
        rows = [
            (st.votes[i].sender, st.votes[i].digest(), st.votes[i].signature)
            for i in idxs
        ]
        self.verify_rows += len(rows)
        self._count("overlay.verify.rows", len(rows))
        fut = self._sched.submit(
            self._sched.verify_launcher(self._verifier), rows,
            generation=level, origin=origin, rows=len(rows),
        )
        self._sched.drain()
        mask = fut.result()
        ok = 0
        for pos, idx in enumerate(idxs):
            if mask[pos]:
                ok |= 1 << idx
        return ok

    def _verify_extra(self, vote, level: int, origin: int) -> bool:
        if self._verifier is None:
            return False  # unsigned runs cannot authenticate off-table votes
        self.verify_rows += 1
        self._count("overlay.verify.rows", 1)
        fut = self._sched.submit(
            self._sched.verify_launcher(self._verifier),
            [(vote.sender, vote.digest(), vote.signature)],
            generation=level, origin=origin, rows=1,
        )
        self._sched.drain()
        return bool(fut.result()[0])

    def verify_propose(self, propose) -> bool:
        """Shared-verifier propose check (replicas run verifier=None in
        overlay mode; one network-wide verification replaces n)."""
        if self._verifier is None:
            return True
        return bool(self._verify_extra(propose, 0, -1))

    # ------------------------------------------------------------- queries

    def honest_demoted(self) -> list:
        """Non-Byzantine peers currently demoted — the monitor's
        'no honest peer permanently demoted' invariant reads this."""
        return sorted(self.scores.demoted - set(self._byz))

    def snapshot(self) -> dict:
        return {
            "epoch": self.epoch,
            "topology": self.topo.digest().hex(),
            "levels": self.topo.levels,
            "window": self.window,
            "frames": self.frames_sent,
            "frames_reciprocal": self.frames_reciprocal,
            "frames_fallback": self.frames_fallback,
            "frames_garbage": self.frames_garbage,
            "frames_withheld": self.frames_withheld,
            "votes_delivered": self.votes_delivered,
            "verify_rows": self.verify_rows,
            "level_timeouts": self.level_timeouts,
            "fallback_engaged": self.fallback_engaged,
            "windows_exhausted": self.windows_exhausted,
            "rekeys": self.rekeys,
            "bls_partials": self._bls_keyring is not None,
            "bls_partials_attached": self.bls_partials_attached,
            "bls_partial_rejects": self.bls_partial_rejects,
            "live_slots": len(self._slots),
            "scores": self.scores.snapshot(),
            "honest_demoted": self.honest_demoted(),
            "byzantine": sorted(self._byz),
        }
