"""Per-replica device-tally flushing: the deployment shape of the vote
grid.

The simulator settles a whole network in one aggregated launch (one
process owns every replica). A deployed replica instead owns its own
n = 1 grid (the "deployment (n = 1)" shape of
:class:`~hyperdrive_tpu_torch.ops.votegrid.VoteGrid`) and flushes at its
own pace, on its own event loop. A :class:`DeviceTallyFlusher` plugs into
:class:`~hyperdrive_tpu_torch.replica.Replica`'s ``flusher`` seam and, per
flush pass,

1. drains the replica's eligible window from the sorted queue,
2. batch-verifies it through the injected verifier (in a deployment:
   :class:`~hyperdrive_tpu_torch.ops.ed25519_wire.TorchWireVerifier` with a
   resident ValidatorTable, whose grouped challenge route launches
   ``ed25519_challenge`` and then ``ed25519_semiwire`` on the card),
3. inserts the survivors into the host automaton
   (:meth:`~hyperdrive_tpu_torch.replica.Replica.ingest_insert_window`),
   scattering each accepted vote into the grid,
4. runs ONE tally launch and hands the counts to the rule cascade
   (:meth:`~hyperdrive_tpu_torch.replica.Replica.ingest_cascade_window`).

The cascade reads the grid's counts where the grid covers the query and
the host counters elsewhere; they are equal by contract, which
``tally_check=CheckedTallyView`` enforces per query.

Port copy of ``hyperdrive_tpu/tallyflush.py``: the blocking
:meth:`~DeviceTallyFlusher.flush`, its double-buffered split through
``verify_signatures_begin``, the queue mode (``queue=``), the wire-facing
columnar :meth:`~DeviceTallyFlusher.settle_block` (a
:class:`~hyperdrive_tpu_torch.batch.MessageBlock` window straight into
the columnar insert), ``warmup``, ``reset`` and ``_settle``, whose
scatter words come from a ``MessageBlock`` of the accepted votes as in
the reference. Differences: the grid lives on an explicit ``device`` (by
default the verifier's, else the card; without CUDA it raises unless the
caller passes ``device="cpu"``); on the card each flusher runs its
launches on a CUDA stream of its own, so a replica thread waits only for
its own work, never for the launches of the replicas that share its
verifier. :meth:`~DeviceTallyFlusher.rotate_validators` (the epoch
boundary's hot swap) and the :attr:`~DeviceTallyFlusher.generation` that
queue-mode commands carry are the reference's, and so are the
flight-recorder seam (``obs``, a keyword here: ``flush.launch``,
``tally.launch`` and ``flush.settle`` events; queue-mode windows submit
its track as their ``origin``) and the two mask fetches through
:func:`~hyperdrive_tpu_torch.analysis.annotations.device_fetch`. Dropped:
the ``@async_scope`` lint marker and the sanitizer's default
``tally_check`` (``analysis.sanitizer.maybe_tally_check``). Added: the
``cancelled`` and ``plane_resets`` counts.

A ``certifier`` (:class:`~hyperdrive_tpu_torch.certificates.Certifier`,
shared with the replica's Process) is bound to the verifier's
``last_transcript`` when it has no transcript source, re-verifies every
certificate a settle minted, and is reset with the flusher.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hyperdrive_tpu_torch.analysis.annotations import device_fetch
from hyperdrive_tpu_torch.batch import MessageBlock
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.ops.tally import pack_value
from hyperdrive_tpu_torch.ops.votegrid import TallyView, VoteGrid

__all__ = ["DeviceTallyFlusher"]

class DeviceTallyFlusher:
    """Owns one replica's vote grid and its batched verify + tally flush.

    Single-writer: every method runs on the owning replica's event-loop
    thread. Local replicas each get their own flusher; they may share one
    verifier (its launches are independent, each on the calling
    flusher's stream).

    ``validators``: the signatory list in whitelist order (the grid's
    validator axis). ``tally_check``: optional ``(view, proc) -> view``
    wrapper (e.g. :class:`~hyperdrive_tpu_torch.ops.votegrid.
    CheckedTallyView`) installed over every launch's TallyView.
    """

    def __init__(self, verifier, validators, r_slots: int = 8,
                 buckets: tuple = (256, 1024, 4096), tally_check=None,
                 pipeline_split: int = 512, queue=None, certifier=None,
                 device=None, obs=None):
        self.verifier = verifier
        #: Flight-recorder handle (obs/recorder.py; NULL_BOUND = off).
        self.obs = obs if obs is not None else NULL_BOUND
        #: Optional Certifier shared with the replica's Process: the
        #: settle path re-verifies each newly minted certificate in O(1)
        #: (binding + quorum weight). One with no transcript source is
        #: bound to this flusher's verifier, so certificates commit to the
        #: batch launch that established their quorum.
        self.certifier = certifier
        if certifier is not None and certifier.transcript_source is None:
            certifier.transcript_source = lambda: getattr(
                self.verifier, "last_transcript", b""
            )
        if device is None:
            device = getattr(verifier, "device", None)
        self.grid = VoteGrid(
            1, len(validators), r_slots=r_slots, buckets=buckets, device=device
        )
        self.device = self.grid.device
        self._r_slots = r_slots
        self._buckets = buckets
        #: Epoch-keyed table generation (:mod:`~hyperdrive_tpu_torch.
        #: epochs`). Tags every queued verify command, so the queue never
        #: coalesces windows of two validator-set generations into one
        #: launch: a drain that spans an epoch boundary splits instead.
        self.generation = 0
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The grid's zeros (and the verifier's table) were written on
            # the creating thread's stream: order this stream after them.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._pos = {s: i for i, s in enumerate(validators)}
        self.tally_check = tally_check
        self._height = None
        self._dirty: set = set()
        #: Flush passes that ran a tally launch.
        self.launches = 0
        #: Wall seconds of the blocking flush inside verification: the
        #: verifier calls and the waits for their masks (queue mode
        #: verifies in the queue's launch and adds nothing here).
        self.verify_seconds = 0.0
        #: Wall seconds inside the grid's ``update_and_tally`` call (its
        #: upload and launches; the counts reach the host when the
        #: cascade first reads them, outside this span).
        self.tally_seconds = 0.0
        #: Double-buffered verify: a window at least this large splits in
        #: two, both halves' verify launches are enqueued up front, and the
        #: second half's device time runs under the first half's host
        #: insert. Needs a verifier with ``verify_signatures_begin``;
        #: others keep the single-launch schedule. 0 disables splitting.
        self.pipeline_split = int(pipeline_split)
        #: Rows ingested through the columnar path (the wire-facing
        #: :meth:`settle_block` entry).
        self.fastpath_rows = 0
        #: Async device-work queue
        #: (:class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue`). When
        #: set, :meth:`flush` stops blocking per window: each drained
        #: window becomes one submitted verify command, settled (insert +
        #: tally + cascade) at the queue's next drain, where windows from
        #: every flusher sharing the queue coalesce into one launch.
        self.queue = queue
        #: Futures of submitted-but-unsettled windows, in submission order
        #: (crash-restart :meth:`reset` cancels them).
        self._inflight: list = []
        #: Windows :meth:`reset` cancelled in flight, and settles that reset
        #: this replica's grid plane (a height move, or the first settle
        #: after a reset dropped the height claim). Port additions: the
        #: card's crash-restart check reads them.
        self.cancelled = 0
        self.plane_resets = 0

    def warmup(self) -> None:
        """Run the grid program once (an empty scatter) and the verifier's
        warmup before the replica starts, so a deployment pays builds and
        first launches at boot, not inside its first consensus round where
        they would read as network stalls and fire timeouts."""
        R = self.grid.R
        with torch.cuda.stream(self._stream):
            self.grid.update_and_tally(
                np.zeros((0, 4), dtype=np.int32),
                np.zeros((0, 8), dtype=np.int32),
                np.zeros(1, dtype=bool),
                np.zeros((1, R, 8), dtype=np.int32),
                np.zeros((1, R), dtype=bool),
                np.full(1, -1, dtype=np.int32),
                np.zeros((1, 8), dtype=np.int32),
                np.zeros(1, dtype=np.int32),
            )["total"]
            if hasattr(self.verifier, "warmup"):
                self.verifier.warmup()

    def reset(self, replica=None) -> None:
        """Crash-restart recovery hook (:meth:`~hyperdrive_tpu_torch.
        replica.Replica.restore` calls it): cancel every in-flight settle
        (a revived replica must not apply its dead predecessor's windows
        on top of its checkpoint) and drop the height claim, so the next
        settle resets the grid plane instead of trusting pre-crash
        scatters."""
        self.cancelled += len(self._inflight)
        for fut in self._inflight:
            fut.cancel()
        self._inflight.clear()
        self._height = None
        self._dirty = set()
        if self.certifier is not None:
            self.certifier.reset()

    def rotate_validators(self, validators, generation=None) -> None:
        """Install the next epoch's signatory list (whitelist order).

        Epoch-boundary hot swap: rebuilds the sender -> column map, builds
        a new grid on the flusher's device when the committee size changed
        (a same-size committee keeps its grid: the next settle's height
        move resets the plane anyway), and bumps :attr:`generation` so
        queued verify commands submitted after this point land in a launch
        of their own. In-flight windows keep their old generation tag, so
        the queue never mixes them with the new generation's windows. The
        split is all the queue does: its verify launchers have no
        ``set_generation``, so a verifier's table is not swapped by it."""
        validators = list(validators)
        if generation is None:
            generation = self.generation + 1
        self.generation = int(generation)
        if len(validators) != self.grid.V:
            self.grid = VoteGrid(
                1, len(validators), r_slots=self._r_slots,
                buckets=self._buckets, device=self.device,
            )
            if self._stream is not None:
                # The new grid's zeros were written on this thread's stream.
                self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._pos = {s: i for i, s in enumerate(validators)}
        # Pre-rotation scatters mean nothing under the new column order:
        # force the next settle to reset the grid plane.
        self._height = None
        self._dirty = set()

    def settle_block(self, replica, block) -> None:
        """Wire-facing columnar settle: one verified + tallied pass over a
        :class:`~hyperdrive_tpu_torch.batch.MessageBlock` window straight
        off the transport. Rows flow into the automaton through the
        columnar path (:meth:`~hyperdrive_tpu_torch.replica.Replica.
        ingest_insert_window_cols`): message objects materialize only for
        rows the automaton accepts or that trip a catcher, never for
        verify-rejected or duplicate rows. Bypasses the replica's queue:
        the caller owns windowing (this is the window). A verifier on the
        card launches its kernel here or raises."""
        cols = block.columns()
        items = block.verify_items()
        begin = getattr(self.verifier, "verify_signatures_begin", None)
        with torch.cuda.stream(self._stream):
            t0 = time.perf_counter()
            if begin is not None:
                pending = begin(items)
                resolve = lambda: [  # noqa: E731
                    bool(b)
                    for b in device_fetch(pending.mask(),
                                          why="columnar settle verify mask")
                ]
            elif hasattr(self.verifier, "verify_signatures"):
                mask = self.verifier.verify_signatures(items)
                resolve = lambda: [bool(b) for b in mask]  # noqa: E731
            else:
                # Transport-trusting verifier (NullVerifier): accept whatever
                # carries a signature. Unsigned rows still drop: a wire row
                # without a signature is a framing defect, not a trust call.
                keep = [bool(sig) for _, _, sig in items]
                resolve = lambda: keep  # noqa: E731
            self.verify_seconds += time.perf_counter() - t0
            self.fastpath_rows += cols.n
            self._settle(replica, [(None, cols, resolve)])

    def _flush_async(self, replica) -> None:
        """The queue schedule: drain windows now, settle at the queue's
        next drain. Each window's verify command goes onto the shared
        queue and its settle runs in the future's done-callback, reading
        the replica's state at drain time."""
        queue = self.queue
        launcher = queue.verify_launcher(self.verifier)
        while True:
            window = replica.mq.drain_window(
                replica.proc.current_height, replica.opts.verify_window
            )
            if not window:
                return
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "flush.launch",
                    replica.proc.current_height,
                    replica.proc.current_round,
                    len(window),
                )
            fut = queue.submit(
                launcher,
                [(m.sender, m.digest(), m.signature) for m in window],
                self.generation,
                origin=(
                    self.obs.replica
                    if self.obs is not NULL_BOUND else None
                ),
                rows=len(window),
            )
            self._inflight.append(fut)

            def settle(f, window=window, replica=replica):
                try:
                    self._inflight.remove(f)
                except ValueError:
                    pass
                # The launcher already applied the unsigned filter: its
                # verdicts are verify_batch's.
                keep = [bool(ok) for ok in f.result()]
                with torch.cuda.stream(self._stream):
                    self._settle(replica, [(window, None, lambda k=keep: k)])

            fut.add_done_callback(settle)

    def flush(self, replica) -> None:
        """Drain the replica's queue to quiescence (the reference flush
        contract, replica/replica.go:251-264), one verified + tallied
        window per pass.

        Double-buffered when the window is large and the verifier has
        ``verify_signatures_begin``: the window splits in half, both
        halves' launches are enqueued up front, then the first half's mask
        is fetched and inserted while the second half still verifies.
        Both halves feed ONE tally launch + cascade, so commits are
        identical to the single-launch schedule.
        """
        if self.queue is not None:
            self._flush_async(replica)
            return
        begin = getattr(self.verifier, "verify_signatures_begin", None)
        with torch.cuda.stream(self._stream):
            while True:
                window = replica.mq.drain_window(
                    replica.proc.current_height, replica.opts.verify_window
                )
                if not window:
                    return
                if self.obs is not NULL_BOUND:
                    self.obs.emit(
                        "flush.launch",
                        replica.proc.current_height,
                        replica.proc.current_round,
                        len(window),
                    )
                if (
                    begin is not None
                    and self.pipeline_split > 0
                    and len(window) >= max(2, self.pipeline_split)
                ):
                    mid = len(window) // 2
                    halves = (window[:mid], window[mid:])
                    # Enqueue BOTH launches before fetching either mask.
                    t0 = time.perf_counter()
                    pending = [
                        begin([(m.sender, m.digest(), m.signature) for m in h])
                        for h in halves
                    ]
                    self.verify_seconds += time.perf_counter() - t0
                    self._settle(
                        replica,
                        [
                            (
                                h,
                                None,
                                lambda p=p, h=h: [
                                    bool(ok) and bool(m.signature)
                                    for ok, m in zip(
                                        device_fetch(
                                            p.mask(),
                                            why="half-window verdicts; the "
                                                "2nd half verifies under "
                                                "this fetch + insert",
                                        ),
                                        h,
                                    )
                                ],
                            )
                            for h, p in zip(halves, pending)
                        ],
                    )
                else:
                    t0 = time.perf_counter()
                    keep = self.verifier.verify_batch(window)
                    self.verify_seconds += time.perf_counter() - t0
                    self._settle(replica, [(window, None, lambda k=keep: k)])

    def _settle(self, replica, parts) -> None:
        """Insert every part (resolving each part's verify mask just before
        its insert: the double-buffer overlap point), union the insert
        plans, then run ONE tally launch + cascade. ``parts``: ``(window,
        cols, resolve_keep)`` triples; exactly one of ``window`` (message
        list) and ``cols`` (WindowColumns) is set."""
        grid = self.grid
        R = grid.R
        proc = replica.proc

        # Reset the plane when the height moved since the grid was last
        # valid; decided BEFORE the inserts so the dirty marks they make
        # for the new height survive (inserts never move heights).
        reset = np.zeros(1, dtype=bool)
        h = proc.current_height
        if self._height != h:
            reset[0] = True
            self.plane_resets += 1
            self._height = h
            self._dirty = set()

        accepted: list = []
        dirty = self._dirty

        def on_accepted(msg, is_precommit):
            rnd = msg.round
            plane = 1 if is_precommit else 0
            if rnd < 0 or rnd >= R:
                return  # outside the slot window: the view declines it
            v = self._pos.get(msg.sender)
            if v is None:
                # A whitelisted sender outside the grid's validator axis:
                # poison the round for this height.
                dirty.add((plane, rnd))
                return
            accepted.append((plane, msg))

        commit_rounds: set = set()
        vote_rounds: set = set()
        for window, cols, resolve in parts:
            t0 = time.perf_counter()
            keep = resolve()
            self.verify_seconds += time.perf_counter() - t0
            if cols is not None:
                part_plan = replica.ingest_insert_window_cols(
                    cols, keep, on_accepted
                )
            else:
                part_plan = replica.ingest_insert_window(
                    window, keep, on_accepted
                )
            commit_rounds |= part_plan[0]
            vote_rounds |= part_plan[1]
        plan = (commit_rounds, vote_rounds)

        # Launch inputs (n = 1): per-round matching targets are this
        # replica's proposal values after the insert; the L28 lane carries
        # the cross-round (valid_round, current proposal value) query.
        st = proc.state
        targets = np.zeros((1, R, 8), dtype=np.int32)
        tvalid = np.zeros((1, R), dtype=bool)
        l28_slot = np.full(1, -1, dtype=np.int32)
        l28_target = np.zeros((1, 8), dtype=np.int32)
        tmap: dict = {}
        for rnd, p in st.propose_logs.items():
            if 0 <= rnd < R:
                targets[0, rnd] = pack_value(p.value)
                tvalid[0, rnd] = True
                tmap[rnd] = p.value
        l28_val = b""
        cur = st.propose_logs.get(st.current_round)
        if cur is not None and 0 <= cur.valid_round < R:
            l28_slot[0] = cur.valid_round
            l28_target[0] = pack_value(cur.value)
            l28_val = cur.value

        if accepted:
            block = MessageBlock.from_messages([m for _, m in accepted])
            words = np.ascontiguousarray(block.rows["value"]).view("<i4")
            idx = np.array(
                [(0, plane, m.round, self._pos[m.sender]) for plane, m in accepted],
                dtype=np.int32,
            )
        else:
            words = np.zeros((0, 8), dtype=np.int32)
            idx = np.zeros((0, 4), dtype=np.int32)
        t0 = time.perf_counter()
        counts = grid.update_and_tally(
            idx, words, reset, targets, tvalid, l28_slot, l28_target,
            np.array([proc.f], dtype=np.int32),
        )
        self.tally_seconds += time.perf_counter() - t0
        self.launches += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit("tally.launch", h, st.current_round, len(idx))
        view = TallyView(
            0, self._height, counts, R, tmap, int(l28_slot[0]), l28_val,
            dirty=dirty,
        )
        if self.tally_check is not None:
            view = self.tally_check(view, proc)
        h_before = proc.current_height
        replica.ingest_cascade_window(plan, view)
        if self.certifier is not None:
            # Any height the cascade just committed minted a certificate
            # (Process L49); re-check each here in O(1), so a broken
            # emission seam fails the settle that produced it.
            for ch in range(h_before, proc.current_height):
                cert = self.certifier.certificate_for(ch)
                if cert is not None:
                    self.certifier.verify(cert)
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "flush.settle", proc.current_height, proc.current_round
            )
