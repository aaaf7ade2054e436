"""Per-sender message queues sorted by (height, round), with bounded capacity.

Capability parity with the reference's ``mq/mq.go``: every sender gets a
dedicated queue kept in ascending (height, round) order (FIFO among equal
keys), bounded at ``max_capacity`` messages to stop far-future flooding from
exhausting memory; :meth:`MessageQueue.consume` drains everything at or below
a height through per-type callbacks, applying a sender whitelist. Queues do
no deduplication and are not safe for concurrent use (the replica serializes
access).

TPU extension: :meth:`MessageQueue.drain_window` pops up to ``window`` ready
messages *without* dispatching them, so the replica can hand the whole window
to the batched signature Verifier in one device launch and then feed the
survivors to the Process in order — the "batched drain" of SURVEY.md §7.1(4).

Port copy of ``hyperdrive_tpu/mq.py`` for the PyTorch package, whole.
"""

from __future__ import annotations

import heapq
from bisect import bisect_right
from typing import Callable, Iterable

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.types import Height, Signatory

__all__ = ["MessageQueue", "DEFAULT_MAX_CAPACITY"]

#: Default per-sender capacity (reference: mq/opt.go:19).
DEFAULT_MAX_CAPACITY = 1000

Message = Propose | Prevote | Precommit


class MessageQueue:
    """Sorted, bounded, per-sender buffering of consensus messages.

    A persistent head-heap indexes each non-empty sender queue by its head
    (height, round) key, so :meth:`consume` and :meth:`drain_window` cost
    O(eligible log senders) instead of scanning every sender — the flush
    loop runs after *every* handled message (replica/replica.go:148), so a
    full scan per flush is O(n) per message and dominates at n=256.
    Heap entries are lazily invalidated: ``_head_key`` records the key each
    sender is currently registered under; popped entries that disagree are
    stale and dropped.
    """

    __slots__ = (
        "max_capacity",
        "_queues",
        "_order",
        "_heads",
        "_head_key",
        "obs",
        "admission",
    )

    def __init__(self, max_capacity: int = DEFAULT_MAX_CAPACITY):
        self.max_capacity = int(max_capacity)
        #: Flight-recorder handle (obs/recorder.py); the owning replica
        #: rebinds it. Only the overflow branch ever touches it.
        self.obs = NULL_BOUND
        #: Optional AdmissionGate (load/backpressure.py). When set, every
        #: insert consults it before buffering — under pressure the queue
        #: sheds classified traffic instead of growing toward the far-
        #: future capacity drop. None = admit everything (the default).
        self.admission = None
        self._queues: dict[Signatory, list[Message]] = {}
        #: sender -> stable tiebreak index (queue-creation order).
        self._order: dict[Signatory, int] = {}
        #: lazy min-heap of (height, round, order, sender) head keys.
        self._heads: list[tuple[Height, int, int, Signatory]] = []
        #: sender -> the (height, round, order) its live heap entry carries.
        self._head_key: dict[Signatory, tuple[Height, int, int]] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _register_head(self, sender: Signatory) -> None:
        """(Re)register ``sender``'s current queue head in the heap."""
        q = self._queues.get(sender)
        if not q:
            self._head_key.pop(sender, None)
            return
        key = (q[0].height, q[0].round, self._order[sender])
        if self._head_key.get(sender) != key:
            self._head_key[sender] = key
            heapq.heappush(self._heads, (*key, sender))

    def _pop_eligible_sender(self, height: Height):
        """Pop the sender with the smallest head key <= ``height``; returns
        (sender, queue) or None. Discards stale entries as it goes."""
        while self._heads:
            h, r, order, sender = self._heads[0]
            if self._head_key.get(sender) != (h, r, order):
                heapq.heappop(self._heads)  # stale
                continue
            if h > height:
                return None
            heapq.heappop(self._heads)
            del self._head_key[sender]
            return sender, self._queues[sender]
        return None

    def _peek_head(self):
        """The smallest live head key (height, round, order), or None."""
        while self._heads:
            h, r, order, sender = self._heads[0]
            if self._head_key.get(sender) != (h, r, order):
                heapq.heappop(self._heads)  # stale
                continue
            return (h, r, order)
        return None

    # ------------------------------------------------------------------ insert

    def insert_propose(self, propose: Propose) -> None:
        """Assumes the sender was already authenticated and filtered
        (reference: mq/mq.go:85-86)."""
        self._insert(propose)

    def insert_prevote(self, prevote: Prevote) -> None:
        self._insert(prevote)

    def insert_precommit(self, precommit: Precommit) -> None:
        self._insert(precommit)

    def order_of(self, sender: Signatory) -> int:
        """Stable per-sender tie-break index, registered on first use.
        Shared with the replica's burst fast lane so lane and queue
        messages from one sender sort under one identity."""
        o = self._order.get(sender)
        if o is None:
            o = self._order[sender] = len(self._order)
        return o

    def _insert(self, msg: Message) -> None:
        if self.admission is not None and not self.admission.admit(msg):
            return
        q = self._queues.get(msg.sender)
        if q is None:
            q = self._queues[msg.sender] = []
            self.order_of(msg.sender)
        # Fast path: consensus traffic arrives overwhelmingly in ascending
        # (height, round) order, so most inserts are appends — skip the
        # binary search (and its per-probe key lambda) entirely.
        if not q:
            q.append(msg)
            idx = 0
        else:
            last = q[-1]
            if (last.height, last.round) <= (msg.height, msg.round):
                q.append(msg)
                idx = len(q) - 1
            else:
                # Insert after all entries with the same (height, round) so
                # equal-key messages stay FIFO (reference: sort.Search
                # semantics, mq/mq.go:117-127).
                idx = bisect_right(
                    q,
                    (msg.height, msg.round),
                    key=lambda m: (m.height, m.round),
                )
                q.insert(idx, msg)
        # Drop the far-future tail when over capacity (reference: mq/mq.go:139-142).
        if len(q) > self.max_capacity:
            if self.obs is not NULL_BOUND:
                dropped = q[self.max_capacity]
                self.obs.emit(
                    "mq.drop",
                    dropped.height,
                    dropped.round,
                    len(q) - self.max_capacity,
                )
            del q[self.max_capacity :]
        if idx == 0:
            self._register_head(msg.sender)

    # ----------------------------------------------------------------- consume

    def consume(
        self,
        height: Height,
        propose: Callable[[Propose], None],
        prevote: Callable[[Prevote], None],
        precommit: Callable[[Precommit], None],
        procs_allowed: Iterable[Signatory],
    ) -> int:
        """Dispatch and drop every queued message with height <= ``height``.

        Returns the number of messages *consumed* — including messages
        dropped by the whitelist, which still count (reference: mq/mq.go:36-66
        increments ``n`` before the whitelist check returns).
        """
        allowed = (
            procs_allowed
            if isinstance(procs_allowed, (set, frozenset, dict))
            else set(procs_allowed)
        )
        # Two-phase drain: detach every eligible prefix *before* dispatching,
        # so callbacks that reentrantly insert messages (a synchronous
        # loopback broadcaster) cannot corrupt the iteration. The Go
        # reference is immune only because broadcasts hop through a channel;
        # the synchronous driving mode must be safe on its own.
        n = 0
        batches: list[list[Message]] = []
        while True:
            popped = self._pop_eligible_sender(height)
            if popped is None:
                break
            sender, q = popped
            i = 0
            while i < len(q) and q[i].height <= height:
                i += 1
            batch = q[:i]
            del q[:i]
            self._register_head(sender)
            n += len(batch)
            if sender in allowed:
                batches.append(batch)
        for batch in batches:
            for msg in batch:
                if isinstance(msg, Propose):
                    propose(msg)
                elif isinstance(msg, Prevote):
                    prevote(msg)
                else:
                    precommit(msg)
        return n

    def drain_window(self, height: Height, window: int) -> list[Message]:
        """Pop up to ``window`` messages with height <= ``height``, in
        **global ascending (height, round) order across senders**, without
        dispatching them.

        This is the wide input for the batched TPU Verifier: the caller
        verifies the window as one launch and feeds survivors to the
        Process. Whitelisting is the caller's job (it already is for
        :meth:`consume`'s callback contract).

        Ordering contract: a capped window always contains the globally
        smallest (height, round) keys among eligible messages, merged
        across the per-sender queues (stable: FIFO within a sender, and
        senders tie-break in queue-creation order). This means the Process
        can never be fed a later round before an earlier one within a
        window — the interleave a per-message consume loop would produce —
        so batching changes *when* rules fire, never the key order votes
        arrive in.
        """
        # k-way merge over the persistent head-heap: pop the smallest-headed
        # sender, take its run of messages while they stay eligible and
        # ahead of the next-best head, then re-register its new head.
        out: list[Message] = []
        while len(out) < window:
            popped = self._pop_eligible_sender(height)
            if popped is None:
                break
            sender, q = popped
            my_order = self._order[sender]
            nxt = self._peek_head()
            i = 0
            while i < len(q) and len(out) < window and q[i].height <= height:
                if nxt is not None and (q[i].height, q[i].round, my_order) > nxt:
                    break
                out.append(q[i])
                i += 1
            del q[:i]
            self._register_head(sender)
        return out

    def has_eligible(self, height: Height) -> bool:
        """True iff some queued message has height <= ``height`` — an O(1)
        peek the burst settle uses to skip the drain/merge machinery for
        replicas with an empty backlog (the common case)."""
        head = self._peek_head()
        return head is not None and head[0] <= height

    def drain_all(self, height: Height) -> list[Message]:
        """Pop EVERY eligible message (height <= ``height``) in the same
        global ascending (height, round) order as :meth:`drain_window`.

        The burst drain: one settle pass takes a replica's whole backlog,
        so per-message heap maintenance is pure overhead — this does one
        scan over the sender queues plus one C-level sort of the eligible
        runs (timsort exploits the per-sender sortedness), which profiles
        several times faster than the k-way merge at superstep batch sizes.
        """
        runs: list[tuple[int, list[Message]]] = []
        for sender, q in self._queues.items():
            if not q or q[0].height > height:
                continue
            i = 0
            while i < len(q) and q[i].height <= height:
                i += 1
            runs.append((self._order[sender], q[:i]))
            del q[:i]
            self._register_head(sender)
        if not runs:
            return []
        if len(runs) == 1:
            return runs[0][1]
        # (h, r, sender-order, run-seq) is unique per message, so the bare
        # tuple sort never falls through to comparing messages, and it
        # reproduces drain_window's contract exactly: global (h, r) order,
        # FIFO within a sender, senders tie-broken by creation order.
        keyed = [
            (m.height, m.round, order, j, m)
            for order, run in runs
            for j, m in enumerate(run)
        ]
        keyed.sort()
        return [t[4] for t in keyed]

    # -------------------------------------------------------------------- drop

    def drop_messages_below_height(self, height: Height) -> None:
        """Forget everything below ``height`` (resync support; reference:
        mq/mq.go:70-83)."""
        for sender, q in self._queues.items():
            i = 0
            while i < len(q) and q[i].height < height:
                i += 1
            if i:
                del q[:i]
                self._register_head(sender)

    def clear(self) -> None:
        """Forget every queued message — the crash-restart revive path
        (Replica.restore): buffered messages are volatile state that
        died with the process. The ``_order`` tie-break map is kept: it
        is derived from the whitelist registration order at construction,
        not from traffic, and a restored replica must keep draining in
        the same deterministic order as the rest of the network."""
        self._queues.clear()
        self._heads.clear()
        self._head_key.clear()
