"""Queue-backed flushing for the host-automaton path.

:class:`QueueFlusher` is the minimal devsched client: it plugs into the
:class:`~hyperdrive_tpu_torch.replica.Replica` ``flusher`` seam, drains
the replica's eligible window, submits its verification to the shared
:class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue`, and dispatches
the window into the automaton when the future resolves, by which point
the queue has coalesced every co-submitted window (other replicas, later
heights) into one launch. It is the no-grid sibling of
:class:`~hyperdrive_tpu_torch.tallyflush.DeviceTallyFlusher`'s queue mode:
same schedule, no device tally.

Port copy of ``hyperdrive_tpu/devsched/flusher.py``, with its
flight-recorder seam (``obs``: one ``flush.launch`` event a submitted
window). Dropped: the ``@async_scope`` lint marker. The submitted
``origin`` is the replica's journal track when ``obs`` is bound, as in
the reference, and otherwise the replica's own identity, which a drain
policy seats tenants by (the reference submits None). Added: the
``cancelled`` count of windows that :meth:`QueueFlusher.reset`
cancelled. Like the queue, a flusher is single-threaded: every replica
sharing one queue must flush and drain on one thread.
"""

from __future__ import annotations

from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = ["QueueFlusher"]


class QueueFlusher:
    """Host-automaton flush through the async device-work queue.

    ``verifier``: anything with ``verify_signatures`` (coalesced into one
    call per drain) or nothing but transport trust (NullVerifier: the
    queue substitutes the accept-all launcher). Verdicts are identical to
    the blocking flush; only the schedule moves.
    """

    def __init__(self, verifier, queue, obs=None):
        self.verifier = verifier
        self.queue = queue
        self.obs = obs if obs is not None else NULL_BOUND
        self._inflight: list = []
        #: Windows submitted / dispatched / cancelled by :meth:`reset` (the
        #: last a port addition: the windows a crash took down in flight).
        self.submitted = 0
        self.dispatched = 0
        self.cancelled = 0

    def flush(self, replica) -> None:
        """Drain the replica's queue to quiescence, one submitted window
        per pass; dispatch happens at the queue's next drain."""
        queue = self.queue
        launcher = queue.verify_launcher(self.verifier)
        while True:
            window = replica.mq.drain_window(
                replica.proc.current_height, replica.opts.verify_window
            )
            if not window:
                return
            obs = self.obs
            if obs is not NULL_BOUND:
                obs.emit(
                    "flush.launch",
                    replica.proc.current_height,
                    replica.proc.current_round,
                    len(window),
                )
            fut = queue.submit(
                launcher,
                [(m.sender, m.digest(), m.signature) for m in window],
                origin=(
                    obs.replica if obs is not NULL_BOUND
                    else replica.proc.whoami
                ),
                rows=len(window),
            )
            self._inflight.append(fut)
            self.submitted += 1

            def dispatch(f, window=window, replica=replica):
                try:
                    self._inflight.remove(f)
                except ValueError:
                    pass
                replica.dispatch_window(window, [bool(ok) for ok in f.result()])
                self.dispatched += 1
                # Dispatching may advance the height and make buffered
                # messages eligible; re-flush so they join the drain's next
                # cycle (the blocking flush loops to quiescence too).
                self.flush(replica)

            fut.add_done_callback(dispatch)

    def reset(self, replica=None) -> None:
        """Crash-restart recovery hook (``Replica.restore``): cancel the
        dead incarnation's in-flight windows, which must not dispatch on
        top of the revived replica's checkpoint."""
        self.cancelled += len(self._inflight)
        for fut in self._inflight:
            fut.cancel()
        self._inflight.clear()
