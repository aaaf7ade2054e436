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
``verify_signatures_begin``, the queue mode (``queue=``), ``warmup``,
``reset`` and ``_settle``. Differences: the grid lives on an explicit
``device`` (by default the verifier's, else the card; without CUDA it
raises unless the caller passes ``device="cpu"``); on the card each
flusher runs its launches on a CUDA stream of its own, so a replica
thread waits only for its own work, never for the launches of the
replicas that share its verifier; the scatter words come from
:func:`~hyperdrive_tpu_torch.ops.tally.pack_value` per accepted row where
the reference builds a ``batch.MessageBlock``; queue-mode commands carry
no ``generation`` (the port's ``DeviceWorkQueue.submit`` has none, since
epochs are not ported). Dropped, as the port's conventions say: the
metrics recorder (``obs``), the ``@async_scope`` and ``device_fetch``
analysis hooks, and the sanitizer's default ``tally_check``
(``analysis.sanitizer.maybe_tally_check``). Refused with
``NotImplementedError``: :meth:`~DeviceTallyFlusher.settle_block` (the
columnar path) and :meth:`~DeviceTallyFlusher.rotate_validators`
(epochs).

A ``certifier`` (:class:`~hyperdrive_tpu_torch.certificates.Certifier`,
shared with the replica's Process) is bound to the verifier's
``last_transcript`` when it has no transcript source, re-verifies every
certificate a settle minted, and is reset with the flusher.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hyperdrive_tpu_torch.ops.tally import pack_value
from hyperdrive_tpu_torch.ops.votegrid import TallyView, VoteGrid

__all__ = ["DeviceTallyFlusher"]

_LATER = "not ported to the PyTorch package yet (a later slice of the port)"


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
                 device=None):
        self.verifier = verifier
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
        for fut in self._inflight:
            fut.cancel()
        self._inflight.clear()
        self._height = None
        self._dirty = set()
        if self.certifier is not None:
            self.certifier.reset()

    def rotate_validators(self, validators, generation=None) -> None:
        raise NotImplementedError(f"epoch rotation of the grid is {_LATER}")

    def settle_block(self, replica, block) -> None:
        raise NotImplementedError(f"the columnar settle path is {_LATER}")

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
            fut = queue.submit(
                launcher,
                [(m.sender, m.digest(), m.signature) for m in window],
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
                    self._settle(replica, [(window, lambda k=keep: k)])

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
                                lambda p=p, h=h: [
                                    bool(ok) and bool(m.signature)
                                    for ok, m in zip(p.mask(), h)
                                ],
                            )
                            for h, p in zip(halves, pending)
                        ],
                    )
                else:
                    t0 = time.perf_counter()
                    keep = self.verifier.verify_batch(window)
                    self.verify_seconds += time.perf_counter() - t0
                    self._settle(replica, [(window, lambda k=keep: k)])

    def _settle(self, replica, parts) -> None:
        """Insert every part (resolving each part's verify mask just before
        its insert: the double-buffer overlap point), union the insert
        plans, then run ONE tally launch + cascade. ``parts``: ``(window,
        resolve_keep)`` pairs."""
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
            accepted.append((plane, msg, v))

        commit_rounds: set = set()
        vote_rounds: set = set()
        for window, resolve in parts:
            t0 = time.perf_counter()
            keep = resolve()
            self.verify_seconds += time.perf_counter() - t0
            part_plan = replica.ingest_insert_window(window, keep, on_accepted)
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

        idx = np.zeros((len(accepted), 4), dtype=np.int32)
        words = np.zeros((len(accepted), 8), dtype=np.int32)
        for j, (plane, m, v) in enumerate(accepted):
            idx[j] = (0, plane, m.round, v)
            words[j] = pack_value(m.value)
        t0 = time.perf_counter()
        counts = grid.update_and_tally(
            idx, words, reset, targets, tvalid, l28_slot, l28_target,
            np.array([proc.f], dtype=np.int32),
        )
        self.tally_seconds += time.perf_counter() - t0
        self.launches += 1
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
