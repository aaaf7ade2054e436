"""The async device-work queue: commands in, futures out, one coalesced
launch per drain.

Port copy of ``hyperdrive_tpu/devsched/queue.py``. Deterministic by
construction — no wall clock, no threads, no randomness: commands resolve
in global submission order (which makes per-submitter FIFO a corollary),
and a fixed submission sequence always produces the same launch grouping
and the same results. The sim drives drains from its virtual-clock loop,
so pipelined runs replay exactly.

The scheduling model is an inference server's continuous batcher applied
to consensus: every pending command against the same launcher coalesces
into ONE device launch at the next drain, so N submitters (replicas,
heights) share one sync instead of paying one each.

Dropped from the copy, as the port's conventions say: the ``drain_point``
lint marker, the recorder (``obs``), the metrics sink (``tracer``), the
launch probe (``devtel``) and the backpressure controller seam. The
futures' ``seq`` and ``launch_id`` attribution fields went with the
probe. Added: ``submit(callback=)``, which attaches a done-callback
before the ``max_depth`` auto-drain can resolve the command (the
execution layer's speculation resolves there, see
:meth:`DeviceWorkQueue.submit`).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "DeviceFuture",
    "DeviceWorkQueue",
    "VerifyLauncher",
    "NullVerifyLauncher",
    "SpeculationMismatch",
]


class SpeculationMismatch(AssertionError):
    """A pipelined settle's speculative verdict diverged from the device's
    actual verdict at drain time.

    Speculation accepts exactly the parseable-and-signed rows; an honest
    network's signatures all verify, so a mismatch means a
    forged-but-well-formed signature was speculatively dispatched. The
    settle pipeline (``harness/sim.py`` ``_settle_speculative``) fails
    loudly with this exception: safety was never at risk (the mismatch is
    detected before commit finalization, which gates on this resolution),
    but the run aborts rather than silently diverging from the sequential
    trajectory.
    """


class CmdMeta(NamedTuple):
    """What a drain policy reads off a pending command: its submission
    sequence number, the submitting track (``origin``) and its row
    count."""

    seq: int
    origin: object
    rows: int


class DeviceFuture:
    """Handle for one submitted device command.

    Resolution happens at queue drains; ``result()`` forces a drain when
    called early (the blocking escape hatch — inside pipelined code prefer
    ``add_done_callback``)."""

    __slots__ = ("_queue", "_value", "_done", "_cancelled", "_callbacks")

    def __init__(self, queue: "DeviceWorkQueue"):
        self._queue = queue
        self._value = None
        self._done = False
        self._cancelled = False
        self._callbacks: list = []

    def done(self) -> bool:
        return self._done

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Cancel a not-yet-resolved command. Returns False if already
        resolved."""
        if self._done:
            return False
        self._cancelled = True
        self._done = True
        self._callbacks.clear()
        return True

    def add_done_callback(self, cb) -> None:
        """``cb(future)`` runs at resolution (immediately if already
        resolved). Callbacks run inside the drain, in submission order;
        they may submit further commands, which join the same drain's next
        cycle."""
        if self._done:
            if not self._cancelled:
                cb(self)
            return
        self._callbacks.append(cb)

    def result(self):
        """The command's result, forcing a queue drain if needed."""
        if not self._done:
            self._queue.drain()
        if self._cancelled:
            raise RuntimeError("command was cancelled")
        if not self._done:
            raise RuntimeError("drain did not resolve this future")
        return self._value

    def _resolve(self, value) -> None:
        self._value = value
        self._done = True
        cbs = self._callbacks
        self._callbacks = []
        for cb in cbs:
            cb(self)


class VerifyLauncher:
    """Coalesces verify commands into one ``verify_signatures`` call.

    A payload is a list of ``(pub, digest, sig)`` triples; the drain
    concatenates every pending payload into ONE batch — the verifier
    dedups, bucket-pads and chunks internally — then slices the result
    back per command. Settle windows fill a fraction of a verify bucket
    alone, so several of them in one launch do the same protocol work in
    fewer launches.
    """

    kind = "verify"

    def __init__(self, verifier):
        self.verifier = verifier

    def launch(self, payloads: list) -> list:
        items: list = []
        bounds: list = []
        for p in payloads:
            start = len(items)
            items.extend(p)
            bounds.append((start, len(items)))
        mask = self.verifier.verify_signatures(items)
        mask = mask.tolist() if hasattr(mask, "tolist") else list(mask)
        # Unsigned lanes can pass a padded launch vacuously; apply the same
        # presence filter the sync verify_batch wrappers do, so a launcher
        # verdict means exactly what a blocking verify meant.
        mask = [bool(ok) and bool(it[2]) for ok, it in zip(mask, items)]
        return [mask[a:b] for a, b in bounds]


class NullVerifyLauncher:
    """Transport-trusting launcher: accept every row, exactly
    :class:`~hyperdrive_tpu_torch.verifier.NullVerifier`'s
    ``verify_batch`` semantics, so swapping a NullVerifier deployment from
    blocking to queued flushing changes scheduling, never verdicts. No
    device, no build."""

    kind = "verify.null"

    def launch(self, payloads: list) -> list:
        return [[True] * len(p) for p in payloads]


class DeviceWorkQueue:
    """One async device-command queue.

    ``submit(launcher, payload)`` enqueues and returns a
    :class:`DeviceFuture`; nothing touches the device until :meth:`drain`
    — where pending commands group by launcher (in first-submission order)
    and each group becomes ONE ``launcher.launch`` call. ``max_depth > 0``
    bounds in-flight commands by auto-draining on the submit that reaches
    the bound (the pipeline-slot size).

    ``on_drain``: callback ``(resolved_count) -> None`` fired after every
    drain that resolved work — the sim's commit-finalization flush hooks
    here, so gated commits land the moment their settle's future does.

    ``policy``: a drain policy (:mod:`~hyperdrive_tpu_torch.devsched.
    policy`) consulted once per drain cycle to partition pending commands
    into this cycle's launches and the next cycle's. ``None`` (the
    default) drains everything, FIFO.
    """

    def __init__(self, max_depth: int = 0, policy=None):
        self.max_depth = int(max_depth)
        self.on_drain = None
        self.policy = policy
        self._pending: list = []  # (launcher, payload, future, meta)
        self._launchers: dict = {}  # id(verifier) -> launcher
        self._draining = False
        self._closed = False
        #: Lifetime counters: commands submitted, launches made, and
        #: commands that rode another command's launch.
        self.submitted = 0
        self.launches = 0
        self.coalesced = 0

    # ------------------------------------------------------------ submit

    @property
    def depth(self) -> int:
        """Commands awaiting resolution."""
        return len(self._pending)

    def verify_launcher(self, verifier):
        """The shared per-verifier launcher — commands only coalesce within
        one launcher object, so every submitter against the same verifier
        must hold the same instance (memoized here). Verifiers without a
        ``verify_signatures`` entry (NullVerifier) get the
        transport-trusting launcher."""
        key = id(verifier)
        got = self._launchers.get(key)
        if got is None:
            got = (
                VerifyLauncher(verifier)
                if hasattr(verifier, "verify_signatures")
                else NullVerifyLauncher()
            )
            self._launchers[key] = got
        return got

    def submit(self, launcher, payload, origin=None, rows=None,
               callback=None) -> DeviceFuture:
        """Enqueue one command; returns its future. Auto-drains when
        ``max_depth`` is reached (including the command just submitted),
        so a pipeline slot never grows unbounded.

        ``origin`` / ``rows`` (the submitting track and the command's lane
        count, default ``len(payload)``) feed the drain policy only.
        ``callback`` is attached to the future before that auto-drain: a
        callback attached to the returned future runs only after the
        drain's ``on_drain`` hook, which may depend on it having run."""
        if self._closed:
            raise RuntimeError("queue is closed")
        fut = DeviceFuture(self)
        if callback is not None:
            fut.add_done_callback(callback)
        meta = None
        if self.policy is not None:
            if rows is None:
                rows = len(payload) if hasattr(payload, "__len__") else 0
            meta = CmdMeta(self.submitted, origin, rows)
        self._pending.append((launcher, payload, fut, meta))
        self.submitted += 1
        if self.max_depth and len(self._pending) >= self.max_depth:
            if not self._draining:
                self.drain()
        return fut

    # ------------------------------------------------------------- drain

    def drain(self) -> int:
        """Resolve every pending command; returns how many resolved.

        Each cycle snapshots the pending list, groups it by launcher
        preserving first-submission order, runs ONE launch per group, and
        resolves the group's futures in submission order (their callbacks
        run here). Callbacks may submit more work — the loop runs until
        the queue is quiet. Re-entrant calls (a callback resolving a
        future early) are satisfied by the outer drain.
        """
        if self._draining:
            return 0
        self._draining = True
        resolved = 0
        try:
            while self._pending:
                batch = self._pending
                self._pending = []
                if self.policy is not None:
                    live = [c for c in batch if not c[2].cancelled()]
                    batch, deferred = self.policy.select(live)
                    # Deferred commands rejoin pending FIRST, so work
                    # submitted by this cycle's callbacks queues behind
                    # them — age order survives.
                    self._pending.extend(deferred)
                    if not batch:
                        continue
                groups: dict = {}
                order: list = []
                for cmd in batch:
                    if cmd[2].cancelled():
                        continue
                    key = id(cmd[0])
                    if key not in groups:
                        groups[key] = []
                        order.append(key)
                    groups[key].append(cmd)
                for key in order:
                    cmds = groups[key]
                    launcher = cmds[0][0]
                    self.launches += 1
                    self.coalesced += len(cmds) - 1
                    results = launcher.launch([c[1] for c in cmds])
                    if len(results) != len(cmds):
                        raise RuntimeError(
                            f"launcher {launcher!r} returned {len(results)} "
                            f"results for {len(cmds)} commands"
                        )
                    for (_, _, fut, _), res in zip(cmds, results):
                        if not fut.cancelled():
                            fut._resolve(res)
                        resolved += 1
        finally:
            self._draining = False
        if resolved and self.on_drain is not None:
            self.on_drain(resolved)
        return resolved

    def close(self) -> int:
        """Final drain, then reject further submits (no command may be
        silently dropped at shutdown)."""
        resolved = self.drain()
        self._closed = True
        return resolved
