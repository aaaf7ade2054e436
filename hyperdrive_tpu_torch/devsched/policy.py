"""Tenant-aware drain policies: who rides the next coalesced launch.

Port copy of ``hyperdrive_tpu/devsched/policy.py``; the selection logic
is unchanged.

The default :class:`~hyperdrive_tpu_torch.devsched.queue.DeviceWorkQueue`
drain is FIFO-everything: every pending command coalesces into the next
launch. That is optimal for throughput — one sync covers all tenants —
but it has no answer to a firehose tenant: a shard submitting 100x
everyone else's rows makes every launch huge, and every OTHER tenant's
commit latency inherits the firehose's launch time. An inference
server meets the same problem with continuous batching plus a
fair scheduler; this module is that scheduler for the verify queue.

A policy is consulted once per drain *cycle* (the queue's
``while pending`` loop): it partitions the pending command list into
``(selected, deferred)``. Selected commands form this cycle's launches;
deferred commands rejoin the pending list and are reconsidered next
cycle — still inside the same ``drain()`` call, so nothing leaks past a
drain, the queue's drain-on-close contract is untouched, and a bounded
``capacity_rows`` turns one monster drain into a train of bounded
launches with fair seating.

Two policies:

- ``None`` / :class:`FifoDrainPolicy` — select everything, defer
  nothing: **byte-identical scheduling to the policy-less queue**
  (digest-neutral; the default).
- :class:`DeficitRoundRobin` — weighted deficit round-robin over
  per-tenant pending rows (Shreedhar & Varghese), with a starvation
  bound: a command deferred ``starve_after`` consecutive cycles is
  force-selected into the next launch regardless of deficit or
  capacity, so the worst-case wait is ``starve_after`` launches.

Deterministic by construction, like the queue itself: no wall clock, no
randomness — selection depends only on the submission sequence, so
fixed-seed runs replay byte-identically.
"""

from __future__ import annotations

__all__ = ["FifoDrainPolicy", "DeficitRoundRobin"]


def _rows(cmd) -> int:
    """Row weight of one pending command tuple (launcher, payload,
    future, meta). A queue with a policy carries the
    submitter's row count in meta; without one, payload length. Zero-row
    commands weigh 1 so deficit accounting always makes progress."""
    meta = cmd[3]
    if meta is not None:
        return max(1, int(meta.rows))
    payload = cmd[1]
    n = len(payload) if hasattr(payload, "__len__") else 1
    return max(1, n)


def _origin(cmd):
    """The submitting tenant's track id (``DeviceWorkQueue.submit``'s
    ``origin``), or None for origin-less submitters — which share one
    round-robin seat rather than bypassing fairness."""
    meta = cmd[3]
    return meta.origin if meta is not None else None


class FifoDrainPolicy:
    """Explicit spelling of the default: everything launches now.

    Exists so ``policy=FifoDrainPolicy()`` and ``policy=None`` are
    interchangeable (tests assert scheduling equality) and so callers
    can treat "which policy" as data rather than an if."""

    name = "fifo"
    starve_after = 0

    def __init__(self):
        self.deferred_total = 0
        self.forced_total = 0
        self.max_deferrals = 0
        self.last_deferred = 0
        self.last_forced = 0

    def select(self, batch):
        self.last_deferred = 0
        self.last_forced = 0
        return batch, []


class DeficitRoundRobin:
    """Weighted deficit round-robin over per-tenant pending rows.

    ``capacity_rows`` bounds the rows selected per drain cycle (the
    launch-size envelope the sync floor is amortized over);
    ``quantum_rows`` is the per-visit deficit credit (scaled by the
    tenant's ``weights`` entry, default 1); ``starve_after`` is the
    starvation bound in cycles.

    Selection each cycle:

    1. **Forced lane** — commands already deferred ``starve_after``
       times are selected first, capacity notwithstanding (the bound is
       a guarantee, not a goal).
    2. **DRR lane** — visit tenants in first-seen ring order starting
       one past last cycle's start; each visit credits the tenant's
       deficit and takes queued commands head-first while the deficit
       covers their rows and cycle capacity remains. A tenant's unspent
       deficit carries to its next visit; an emptied tenant's deficit
       resets (classic DRR — credit must not accrue while idle).
    3. Everything else defers to the next cycle and its deferral count
       rises; ``max_deferrals`` records the lifetime worst, which the
       starvation bound caps at ``starve_after``.

    Progress is guaranteed: a non-empty batch always selects at least
    one command (an over-capacity command that nothing else displaces is
    taken alone rather than spinning).
    """

    name = "drr"

    def __init__(self, capacity_rows: int = 256, quantum_rows: int = 64,
                 weights=None, starve_after: int = 4):
        if capacity_rows < 1:
            raise ValueError(f"capacity_rows must be >= 1, got {capacity_rows}")
        if quantum_rows < 1:
            raise ValueError(f"quantum_rows must be >= 1, got {quantum_rows}")
        if starve_after < 1:
            raise ValueError(f"starve_after must be >= 1, got {starve_after}")
        self.capacity_rows = int(capacity_rows)
        self.quantum_rows = int(quantum_rows)
        self.weights = dict(weights) if weights else {}
        self.starve_after = int(starve_after)
        #: Per-tenant deficit credit (rows), carried across cycles.
        self._deficit: dict = {}
        #: Tenants in first-seen order (the round-robin ring) + cursor.
        self._ring: list = []
        self._ring_pos: dict = {}
        self._cursor = 0
        #: future-id -> consecutive deferral count for pending commands.
        self._defers: dict = {}
        #: Lifetime counters.
        self.deferred_total = 0
        self.forced_total = 0
        self.max_deferrals = 0
        self.last_deferred = 0
        self.last_forced = 0

    def weight(self, origin) -> int:
        return max(1, int(self.weights.get(origin, 1)))

    def _seat(self, origin) -> None:
        if origin not in self._ring_pos:
            self._ring_pos[origin] = len(self._ring)
            self._ring.append(origin)

    def select(self, batch):
        self.last_deferred = 0
        self.last_forced = 0
        if not batch:
            return [], []
        selected: list = []
        budget = self.capacity_rows
        queues: dict = {}
        for cmd in batch:
            fid = id(cmd[2])
            if self._defers.get(fid, 0) >= self.starve_after:
                # Forced lane: the starvation bound fires.
                self._defers.pop(fid, None)
                selected.append(cmd)
                budget -= _rows(cmd)
                self.last_forced += 1
                self.forced_total += 1
                continue
            origin = _origin(cmd)
            self._seat(origin)
            queues.setdefault(origin, []).append(cmd)
        # DRR lane: ring visits from a rotating start, credit + take.
        ring = self._ring
        if ring and budget > 0:
            start = self._cursor % len(ring)
            self._cursor = (self._cursor + 1) % len(ring)
            progressed = True
            while budget > 0 and progressed:
                progressed = False
                for step in range(len(ring)):
                    origin = ring[(start + step) % len(ring)]
                    q = queues.get(origin)
                    if not q:
                        continue
                    credit = self._deficit.get(origin, 0) + (
                        self.quantum_rows * self.weight(origin)
                    )
                    while q and budget > 0:
                        need = _rows(q[0])
                        if credit < need or need > budget:
                            break
                        cmd = q.pop(0)
                        credit -= need
                        budget -= need
                        self._defers.pop(id(cmd[2]), None)
                        selected.append(cmd)
                        progressed = True
                    # Classic DRR: an emptied tenant forfeits its credit.
                    self._deficit[origin] = 0 if not q else credit
                    if budget <= 0:
                        break
        deferred: list = []
        for origin in ring:
            q = queues.get(origin)
            if q:
                deferred.extend(q)
        if not selected and deferred:
            # Progress guarantee: take the oldest submission alone
            # (an over-capacity command becomes its own launch).
            cmd = min(deferred, key=batch.index)
            deferred.remove(cmd)
            self._defers.pop(id(cmd[2]), None)
            selected.append(cmd)
        if len(deferred) > 1:
            # Re-queue in original submission order so per-tenant FIFO
            # and cross-tenant age ordering survive the detour.
            index = {id(c[2]): i for i, c in enumerate(batch)}
            deferred.sort(key=lambda c: index[id(c[2])])
        for cmd in deferred:
            fid = id(cmd[2])
            n = self._defers.get(fid, 0) + 1
            self._defers[fid] = n
            if n > self.max_deferrals:
                self.max_deferrals = n
        self.last_deferred = len(deferred)
        self.deferred_total += len(deferred)
        return selected, deferred
