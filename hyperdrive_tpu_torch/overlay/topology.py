"""Seeded binomial aggregation-tree topology (Handel, arXiv:1906.05132).

The overlay's peer structure is a *pure function* of ``(seed, epoch
anchor digest, validator set)`` — no Python ``hash()``, no process
state, no wall clock — so every replica, every process, and a replay
reconstructing the run from a dump derive byte-identical trees
(property-tested across subprocesses). Keying off the epoch anchor
digest (:mod:`hyperdrive_tpu_torch.epochs`) makes churn re-key tree positions
at every boundary for free: the anchor chains the committed boundary
value, so the epoch-e tree is unpredictable before epoch e-1 commits —
an adversary cannot pre-position around its future level assignment.

Shape (Handel / "verification-priority" style): nodes are permuted
into ranks by a seeded Fisher–Yates walk over a counter-mode SHA-256
stream; rank space is padded to ``N = 2**ceil(log2 n)``. At level
``l`` (1-based), a node's **partner half** is the sibling
``2**(l-1)``-rank block of its own within the enclosing ``2**l``
block: completing level ``l`` means holding every vote in that ``2**l``
block, after which the node's aggregate is worth sending one level up.
Contact order within a partner half is an independent seeded shuffle
per (rank, level) — Handel's VP ordering — so a withholding partner is
routed around by the next wave instead of stalling the level.

Port copy of ``hyperdrive_tpu/overlay/topology.py``, unchanged: pure
Python, so the port's trees are the JAX package's byte for byte.
"""

from __future__ import annotations

import hashlib

__all__ = ["Topology"]

_DOMAIN = b"hd-overlay-v1"
_MASK64 = (1 << 64) - 1


class _HashStream:
    """Deterministic uniform ints from counter-mode SHA-256."""

    __slots__ = ("_key", "_ctr", "_buf", "_off")

    def __init__(self, key: bytes):
        self._key = key
        self._ctr = 0
        self._buf = b""
        self._off = 0

    def _u64(self) -> int:
        if self._off >= len(self._buf):
            self._buf = hashlib.sha256(
                self._key + self._ctr.to_bytes(8, "little")
            ).digest()
            self._ctr += 1
            self._off = 0
        v = int.from_bytes(self._buf[self._off : self._off + 8], "little")
        self._off += 8
        return v

    def below(self, bound: int) -> int:
        """Uniform draw in [0, bound) via rejection sampling (unbiased,
        unlike a bare modulo)."""
        if bound <= 1:
            return 0
        limit = ((1 << 64) // bound) * bound
        while True:
            v = self._u64()
            if v < limit:
                return v % bound


class _ContactShuffle:
    """Lazily-extended seeded shuffle of one partner half.

    A node only ever walks the first ``waves * fanout`` contacts of a
    level, so the full Fisher–Yates permutation of a 2048-rank half is
    never materialized beyond the prefix actually consumed. Extending
    the prefix never re-draws: contact k is fixed the moment it is
    first read, which is what lets withhold charges name exactly the
    peers a wave contacted."""

    __slots__ = ("_pool", "_stream", "_done")

    def __init__(self, pool: list, key: bytes):
        self._pool = pool
        self._stream = _HashStream(key)
        self._done = 0

    def prefix(self, k: int) -> list:
        pool = self._pool
        k = min(k, len(pool))
        while self._done < k:
            i = self._done
            j = i + self._stream.below(len(pool) - i)
            pool[i], pool[j] = pool[j], pool[i]
            self._done += 1
        return pool[:k]

    def __len__(self) -> int:
        return len(self._pool)


class Topology:
    """One epoch's aggregation tree over ``n`` validator slots.

    ``rank[i]`` is slot i's position in the padded rank space;
    ``order[r]`` inverts it (None for padding ranks). Everything else
    is derived lazily and cached — block masks and contact shuffles
    are touched only for the (node, level) pairs a run actually
    exercises.
    """

    def __init__(self, seed: int, anchor: bytes, identities):
        ids = list(identities)
        n = len(ids)
        if n < 1:
            raise ValueError("topology needs at least one validator")
        self.n = n
        self.seed = int(seed)
        self.anchor = bytes(anchor)
        h = hashlib.sha256()
        for ident in ids:
            h.update(len(ident).to_bytes(2, "little"))
            h.update(ident)
        self.set_digest = h.digest()
        self._root = hashlib.sha256(
            _DOMAIN
            + (self.seed & _MASK64).to_bytes(8, "little")
            + self.anchor
            + self.set_digest
        ).digest()
        #: Padded rank-space size and level count: level l spans
        #: 2**l-rank blocks, so the top level is log2(N).
        self.size = 1 << (n - 1).bit_length() if n > 1 else 1
        self.levels = self.size.bit_length() - 1
        # Seeded Fisher–Yates over the REAL slots; padding ranks (>= n
        # after permutation of rank space) stay empty. Permute rank
        # assignments: slot -> rank over the full padded space so the
        # empty ranks move too (a fixed empty suffix would make the top
        # block systematically sparse).
        stream = _HashStream(self._root + b"perm")
        ranks = list(range(self.size))
        for i in range(self.size - 1, 0, -1):
            j = stream.below(i + 1)
            ranks[i], ranks[j] = ranks[j], ranks[i]
        #: slot i -> rank.
        self.rank = ranks[:n]
        #: rank -> slot (None = padding).
        self.order: list = [None] * self.size
        for slot, r in enumerate(self.rank):
            self.order[r] = slot
        self._contacts: dict = {}
        self._block_masks: dict = {}

    # ------------------------------------------------------------ identity

    def digest(self) -> bytes:
        """Commitment to the whole tree: the rank permutation under the
        derivation root. Two topologies agree iff their digests do —
        the cross-process purity property test compares exactly this."""
        h = hashlib.sha256(self._root)
        for r in self.rank:
            h.update(r.to_bytes(4, "little"))
        return h.digest()

    # ------------------------------------------------------------- queries

    def partner_half(self, slot: int, level: int) -> list:
        """The slots in ``slot``'s sibling half at ``level`` (the ranks
        it must obtain to complete the level), unshuffled, rank order."""
        r = self.rank[slot]
        low = level - 1
        base = ((r >> level) << level) | ((1 - ((r >> low) & 1)) << low)
        out = []
        for p in range(base, base + (1 << low)):
            s = self.order[p]
            if s is not None:
                out.append(s)
        return out

    def contacts(self, slot: int, level: int, k: int) -> list:
        """First ``k`` contacts of ``slot``'s level-``level`` partner
        half, in the node's seeded VP order. Stable under extension."""
        key = (slot, level)
        sh = self._contacts.get(key)
        if sh is None:
            sh = _ContactShuffle(
                self.partner_half(slot, level),
                self._root
                + b"order"
                + self.rank[slot].to_bytes(4, "little")
                + level.to_bytes(2, "little"),
            )
            self._contacts[key] = sh
        return sh.prefix(k)

    def block_mask(self, slot: int, level: int) -> int:
        """Bitmask (over slots) of the full ``2**level`` rank block
        containing ``slot`` — coverage ⊇ mask means the level is
        complete and the aggregate is ready for level + 1."""
        r = self.rank[slot] >> level
        key = (level, r)
        m = self._block_masks.get(key)
        if m is None:
            m = 0
            base = r << level
            for p in range(base, base + (1 << level)):
                s = self.order[p]
                if s is not None:
                    m |= 1 << s
            self._block_masks[key] = m
        return m

    def level_groups(self, level: int) -> list:
        """Partition of slots into ``2**level``-rank blocks — the
        natural grain for partitions that slice the tree along level
        boundaries (:meth:`FaultPlan.overlay` draws its groups here)."""
        groups: list = []
        for base in range(0, self.size, 1 << level):
            g = [
                self.order[p]
                for p in range(base, base + (1 << level))
                if self.order[p] is not None
            ]
            if g:
                groups.append(tuple(g))
        return groups
