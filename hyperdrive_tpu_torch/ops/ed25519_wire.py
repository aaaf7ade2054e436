"""Wire-format batched Ed25519 verification: point decompression on the
device (PyTorch).

Port of the JAX package's ``ops/ed25519_wire.py``. The host ships raw wire
bytes (pub, R, s, k as [B, 32] uint8 rows, 128 B a lane) instead of packed
limbs, and keeps only the cheap steps: length checks, the canonical-y and
s < L range checks, the challenge hash, byte copies. Both decompressions
run on the device, inside the wire kernel.

With a resident :class:`ValidatorTable` of the validator keys, A is
gathered by index from the table instead (decompressed and negated once on
the host), and the challenge k = SHA-512(R || A || M) mod L is computed on
the device (the ``ed25519_challenge`` kernel; plain version on
:mod:`hyperdrive_tpu_torch.ops.sha512`) from a deduped digest table or
per-lane digest rows: the host does no hashing at all.

Contents:

- the device half as plain PyTorch: :func:`limbs_from_rows`,
  :func:`nibbles_from_rows`, :func:`decompress_device`, and the plain
  versions of three hand-written CUDA kernels (:func:`wire_verify_plain`,
  :func:`semiwire_verify_plain`, and the challenge legs
  :func:`challenge` and :func:`challenge_grouped`; kernels and wrappers
  in :mod:`hyperdrive_tpu_torch.ops.ed25519_cuda`), plus
  :func:`chalwire_verify_plain`;
- :class:`ValidatorTable`, :class:`Ed25519WireHost` (the reference's
  packer: the native ``hd_pack_wire`` when it builds, else its
  pure-Python loop),
  :class:`PendingVerify` and :class:`TorchWireVerifier`, the drop-in batch
  verifier with the reference's three routes.

Semantics are bit for bit the host oracle's
(:func:`hyperdrive_tpu_torch.crypto.ed25519.verify`): the combined
square-root/division x = u*v^3*(u*v^7)^((p-5)/8) equals the oracle's
x2 = u * inv(v) path on every input because v = d*y^2 + 1 never vanishes
mod p (-1/d is a non-residue).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
from hyperdrive_tpu_torch.ops import bucketing
from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops.ed25519 import _resolve_device, verify_plain
from hyperdrive_tpu_torch.ops.sha512 import (
    challenge_scalar_device,
    limbs13_from_bytes,
)

__all__ = [
    "limbs_from_rows",
    "nibbles_from_rows",
    "decompress_device",
    "wire_verify_plain",
    "semiwire_verify_plain",
    "challenge",
    "challenge_grouped",
    "chalwire_verify_plain",
    "from_reference",
    "ValidatorTable",
    "Ed25519WireHost",
    "PendingVerify",
    "TorchWireVerifier",
]

P = host_ed.P
D_LIMBS = fe.to_limbs(host_ed.D)
SQRTM1_LIMBS = fe.to_limbs(host_ed.SQRT_M1)
_MASK255 = (1 << 255) - 1


# ------------------------------------------------------ device byte unpack


def limbs_from_rows(rows: torch.Tensor):
    """[B, 32] uint8 little-endian field encodings -> ([B, 20] int32
    13-bit limbs with bit 255 cleared, [B] int32 sign bits)."""
    sign = rows[:, 31].to(torch.int32) >> 7
    cleared = torch.cat([rows[:, :31], rows[:, 31:] & 0x7F], dim=1)
    return limbs13_from_bytes(cleared, fe.N_LIMBS), sign


def nibbles_from_rows(rows: torch.Tensor) -> torch.Tensor:
    """[B, 32] uint8 little-endian scalars -> [B, 64] int32 base-16
    digits."""
    b = rows.to(torch.int32)
    return torch.stack([b & 0xF, b >> 4], dim=-1).reshape(b.shape[0], 64)


# --------------------------------------------------- device decompression


def decompress_device(y: torch.Tensor, sign: torch.Tensor):
    """RFC 8032 x-recovery on limb tensors: solve x^2 = (y^2-1)/(d y^2+1).

    ``y``: [B, 20] limbs (bit 255 cleared; the wire packer guarantees
    y < p on prevalid lanes), ``sign``: [B] int32. Returns (x [B, 20],
    ok [B] bool), case for case the oracle's ``_recover_x``: x2 == 0 gives
    x = 0, accepted iff sign == 0; a non-residue x2 rejects; otherwise the
    root's parity is flipped to the sign bit. On y >= p it computes the
    same field arithmetic on y mod p, as the kernel does."""
    one = fe._const(fe.ONE, y).expand(y.shape)
    y2 = fe.sqr(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(fe._const(D_LIMBS, y), y2), one)
    v2 = fe.sqr(v)
    uv3 = fe.mul(u, fe.mul(v2, v))
    uv7 = fe.mul(uv3, fe.sqr(v2))
    x = fe.mul(uv3, fe.pow22523(uv7))
    vx2 = fe.mul(v, fe.sqr(x))
    ok_direct = fe.eq(vx2, u)
    ok_flip = fe.eq(vx2, fe.neg(u))
    x = fe.select(ok_flip & ~ok_direct, fe.mul(x, fe._const(SQRTM1_LIMBS, y)), x)
    ok = (ok_direct | ok_flip) & ~(fe.is_zero(x) & (sign == 1))
    parity = fe.canonical(x)[..., 0] & 1
    return fe.select(parity != sign, fe.neg(x), x), ok


# --------------------------------------------- plain versions of the kernels


def wire_verify_plain(a_rows, r_rows, s_rows, k_rows) -> torch.Tensor:
    """Batched verify straight from wire bytes (all [B, 32] uint8):
    unpack, decompress A and R, negate A, run the ladder
    (:func:`~hyperdrive_tpu_torch.ops.ed25519.verify_plain`). Returns bool
    [B], ladder & ok_A & ok_R. The plain version of the wire kernel.
    Lanes the packer marked invalid must be masked by the caller's
    ``prevalid``."""
    ay, a_sign = limbs_from_rows(a_rows)
    ry, r_sign = limbs_from_rows(r_rows)
    ax, ok_a = decompress_device(ay, a_sign)
    rx, ok_r = decompress_device(ry, r_sign)
    nax = fe.neg(ax)
    nat = fe.mul(nax, ay)
    ok = verify_plain(nax, ay, nat, rx, ry,
                      nibbles_from_rows(s_rows), nibbles_from_rows(k_rows))
    return ok & ok_a & ok_r


def semiwire_verify_plain(idx, r_rows, s_rows, k_rows,
                          tnax, tay, tnat, tvalid) -> torch.Tensor:
    """Indexed-A wire verify: gather the decompressed, negated A from the
    validator table ([V, 20] int32 each, ``tvalid`` [V] bool) by ``idx``
    ([B] int32), decompress R, run the ladder. Returns bool [B],
    ladder & ok_R & tvalid[idx]. The plain version of the semiwire
    kernel."""
    i = idx.long()
    ry, r_sign = limbs_from_rows(r_rows)
    rx, ok_r = decompress_device(ry, r_sign)
    ok = verify_plain(tnax[i], tay[i], tnat[i], rx, ry,
                      nibbles_from_rows(s_rows), nibbles_from_rows(k_rows))
    return ok & ok_r & tvalid[i]


def challenge(idx, r_rows, m_rows, trows) -> torch.Tensor:
    """The per-lane challenge leg: k rows ([B, 32] uint8) from R, the
    table's compressed A gathered by ``idx``, and per-lane digests. The
    plain version of the ``ed25519_challenge`` kernel
    (:func:`~hyperdrive_tpu_torch.ops.ed25519_cuda.challenge`)."""
    return challenge_scalar_device(r_rows, trows[idx.long()], m_rows)


def challenge_grouped(idx, r_rows, m_idx, m_uniq, trows) -> torch.Tensor:
    """The grouped challenge leg: digests arrive as a deduped table
    ``m_uniq`` ([U, 32] uint8) and a per-lane index ``m_idx`` ([B]
    uint8), gathered on the device. The plain version of the
    ``ed25519_challenge`` kernel's grouped form
    (:func:`~hyperdrive_tpu_torch.ops.ed25519_cuda.challenge_grouped`)."""
    return challenge_scalar_device(
        r_rows, trows[idx.long()], m_uniq[m_idx.long()]
    )


def chalwire_verify_plain(idx, r_rows, s_rows, m_rows,
                          tnax, tay, tnat, tvalid, trows) -> torch.Tensor:
    """Indexed-A wire verify with the challenge derived on the device: the
    challenge leg, then the semiwire ladder (two steps, k never leaves the
    device). The derived k is canonical, so verdicts equal the host-hashed
    semiwire path's."""
    k_rows = challenge(idx, r_rows, m_rows, trows)
    return semiwire_verify_plain(idx, r_rows, s_rows, k_rows,
                                 tnax, tay, tnat, tvalid)


def from_reference(rows, prevalid, device=None):
    """The JAX package's wire packer output (a tuple of numpy row arrays,
    uint8 rows and int32 indices kept as they are, and the prevalid mask)
    as this package's tensors on ``device``: ``(tensors, prevalid)``.
    Plain numpy in, so it needs nothing of the reference package."""
    dev = _resolve_device(device)
    tensors = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in rows
    )
    return tensors, torch.from_numpy(np.asarray(prevalid, dtype=bool)).to(dev)


# ------------------------------------------- validator-resident (indexed)


class ValidatorTable:
    """Device-resident decompressed validator pubkeys.

    Consensus verifies signatures from a known validator set, so each
    pubkey is decompressed and negated once on the host and the [V, 20]
    coordinate tensors are uploaded once; the indexed routes then ship an
    index per lane. Pubkeys that fail decompression occupy an invalid slot
    (their signatures reject, as the oracle does) but keep their
    compressed row, which the device challenge hashes. The first
    occurrence of a duplicate pubkey owns the index entry.

    ``bytes(32)`` is NOT an invalid encoding (y = 0 decompresses to a
    curve point): pad with a non-canonical encoding such as
    ``P.to_bytes(32, "little")``, which always fails decompression.
    ``device=None`` means ``"cuda"`` and raises without CUDA."""

    def __init__(self, pubkeys, device=None):
        device = _resolve_device(device)
        pubkeys = list(pubkeys)
        v = len(pubkeys)
        nax = np.zeros((max(v, 1), fe.N_LIMBS), dtype=np.int32)
        ay = np.zeros_like(nax)
        nat = np.zeros_like(nax)
        valid = np.zeros(max(v, 1), dtype=bool)
        rows = np.zeros((max(v, 1), 32), dtype=np.uint8)
        index: dict = {}
        for i, pub in enumerate(pubkeys):
            index.setdefault(pub, i)
            if len(pub) == 32:
                rows[i] = np.frombuffer(pub, dtype=np.uint8)
            pt = host_ed.point_decompress(pub)
            if pt is None:
                continue
            x, y = pt[0], pt[1]
            nx = (P - x) % P
            nax[i] = fe.to_limbs(nx)
            ay[i] = fe.to_limbs(y)
            nat[i] = fe.to_limbs((nx * y) % P)
            valid[i] = True
        self._install(nax, ay, nat, valid, rows, index, v, device)

    def _install(self, nax, ay, nat, valid, rows, index, n, device):
        self.device = device
        self.index = index
        self.n = n

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.nax, self.ay, self.nat = up(nax), up(ay), up(nat)
        self.valid, self.rows = up(valid), up(rows)

    @classmethod
    def from_arrays(cls, nax, ay, nat, valid, rows, device=None):
        """A table from the JAX ``ValidatorTable.arrays_chal()`` arrays as
        numpy (nax, ay, nat int32 [V, 20]; valid bool [V]; rows uint8
        [V, 32]). The index is rebuilt from the rows, first slot winning;
        an all-zero row of an invalid slot (a pubkey that was not 32 bytes
        long) is not addressable."""
        device = _resolve_device(device)
        nax, ay, nat = (np.array(a, dtype=np.int32) for a in (nax, ay, nat))
        valid = np.array(valid, dtype=bool)
        rows = np.array(rows, dtype=np.uint8)
        index: dict = {}
        for i, row in enumerate(rows):
            if valid[i] or row.any():
                index.setdefault(row.tobytes(), i)
        table = cls.__new__(cls)
        table._install(nax, ay, nat, valid, rows, index, len(rows), device)
        return table

    def arrays(self):
        return self.nax, self.ay, self.nat, self.valid

    def arrays_chal(self):
        """The :func:`chalwire_verify_plain` table arguments: coordinate
        tensors plus the resident compressed encodings."""
        return self.nax, self.ay, self.nat, self.valid, self.rows

    def upload_index(self, idx: np.ndarray) -> torch.Tensor:
        """Check ``0 <= idx < V`` on the host array, then upload it: the
        check never costs a device synchronization, and the kernel never
        reads outside the table."""
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= self.valid.shape[0]):
            raise ValueError(
                f"table index out of range [0, {self.valid.shape[0]})"
            )
        return torch.from_numpy(idx).to(self.device)


# ------------------------------------------------------------- host packer


class Ed25519WireHost:
    """Range-checks and marshals (pub, digest, sig) triples into the wire
    rows the device consumes: four [bucket, 32] uint8 arrays (A, R, s, k)
    plus the prevalid mask.

    Host work per item: length checks, canonical-y checks for A and R
    (y < p, the oracle's ``_recover_x`` rejection), the s < L malleability
    check, and k = SHA-512(R||A||M) mod L. No field exponentiation. The
    native ``hd_pack_wire`` (:mod:`hyperdrive_tpu_torch.native`) and the
    pure-Python loop produce identical rows and masks (differentially
    tested); ``use_native=False`` or ``HD_NO_NATIVE=1`` selects Python.
    :meth:`pack_wire_challenge` and :meth:`index_lanes` do no hashing and
    stay in Python."""

    def __init__(self, buckets=(64, 256, 1024, 4096), use_native: bool = True):
        self.buckets = tuple(sorted(buckets))
        self._native = None
        if use_native:
            from hyperdrive_tpu_torch import native

            self._native = native.instance()

    def bucket_for(self, n: int) -> int:
        return bucketing.bucket_for(n, self.buckets)

    def pack_wire(self, items):
        """items: iterable of (pub32, digest, sig64). Returns
        ((a_rows, r_rows, s_rows, k_rows), prevalid, n): rows are
        [bucket, 32] uint8, prevalid is bool[bucket], n the true count."""
        items = list(items)
        n = len(items)
        bsz = self.bucket_for(max(n, 1))
        a_rows = np.zeros((bsz, 32), dtype=np.uint8)
        r_rows = np.zeros_like(a_rows)
        s_rows = np.zeros_like(a_rows)
        k_rows = np.zeros_like(a_rows)
        prevalid = np.zeros(bsz, dtype=bool)
        if self._native is not None:
            prevalid[:n] = self._native.pack_wire_into(
                items, a_rows, r_rows, s_rows, k_rows
            )
            return (a_rows, r_rows, s_rows, k_rows), prevalid, n
        for i, (pub, digest, sig) in enumerate(items):
            if len(pub) != 32 or len(sig) != 64:
                continue
            if (int.from_bytes(pub, "little") & _MASK255) >= P:
                continue
            if (int.from_bytes(sig[:32], "little") & _MASK255) >= P:
                continue
            if int.from_bytes(sig[32:], "little") >= host_ed.L:
                continue
            k = host_ed.challenge_scalar(sig[:32], pub, digest)
            a_rows[i] = np.frombuffer(pub, dtype=np.uint8)
            r_rows[i] = np.frombuffer(sig[:32], dtype=np.uint8)
            s_rows[i] = np.frombuffer(sig[32:], dtype=np.uint8)
            k_rows[i] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
            prevalid[i] = True
        return (a_rows, r_rows, s_rows, k_rows), prevalid, n

    def index_lanes(self, items, table: ValidatorTable):
        """Map each item's pubkey to its table slot. Returns (idx int32
        [bucket], all_known): unknown pubkeys leave idx 0 and clear
        all_known, telling the caller to take the full wire route for the
        chunk (verdicts must never depend on table contents)."""
        idx = np.zeros(self.bucket_for(max(len(items), 1)), dtype=np.int32)
        lookup = table.index.get
        lanes = np.fromiter(
            (lookup(pub, -1) for pub, _, _ in items),
            dtype=np.int32,
            count=len(items),
        )
        all_known = bool((lanes >= 0).all()) if len(items) else True
        idx[: len(items)] = np.maximum(lanes, 0)
        return idx, all_known

    @staticmethod
    def _rows_lt(rows: np.ndarray, bound: int, mask255: bool = False):
        """Vectorized little-endian 256-bit compare: rows < bound, as four
        uint64 words most-significant first. ``mask255`` clears bit 255
        first (the sign bit is not part of y). The word view is explicitly
        little-endian ('<u8'): a native-endian view on a big-endian host
        would invert the comparison and let s >= L through prevalid."""
        w = np.ascontiguousarray(rows).view(np.dtype("<u8"))
        if mask255:
            w = w.copy()
            w[:, 3] &= 0x7FFFFFFFFFFFFFFF
        b = [(bound >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]
        lt = np.zeros(len(rows), dtype=bool)
        eq = np.ones(len(rows), dtype=bool)
        for i in (3, 2, 1, 0):
            lt |= eq & (w[:, i] < b[i])
            eq &= w[:, i] == b[i]
        return lt

    def pack_wire_challenge(self, items, table: ValidatorTable,
                            with_m: bool = True, _idx=None):
        """Challenge-on-device packing: no hashing on the host. Returns
        ((idx, r_rows, s_rows, m_rows), prevalid, n); with ``with_m=False``
        the m slot is None (the grouped format ships digests separately).

        Host work per item: length checks, canonical-y on R, s < L, and the
        table lookup (A's canonicity is a table property: invalid slots
        reject on the device through ``tvalid``). Requires every pubkey in
        the table and every digest to be 32 bytes (the device hash has a
        fixed 96-byte preimage)."""
        items = list(items)
        n = len(items)
        if any(len(d) != 32 for _, d, _ in items):
            raise ValueError("pack_wire_challenge requires 32-byte digests")
        bsz = self.bucket_for(max(n, 1))
        r_rows = np.zeros((bsz, 32), dtype=np.uint8)
        s_rows = np.zeros_like(r_rows)
        m_rows = np.zeros_like(r_rows) if with_m else None
        prevalid = np.zeros(bsz, dtype=bool)
        if _idx is not None:
            # The caller already ran index_lanes for routing.
            idx = _idx
        else:
            idx, all_known = self.index_lanes(items, table)
            if not all_known:
                raise ValueError(
                    "pack_wire_challenge requires every pubkey in the table"
                )
        if n == 0:
            return (idx, r_rows, s_rows, m_rows), prevalid, n

        wellformed = np.fromiter(
            (len(sig) == 64 for _, _, sig in items), dtype=bool, count=n
        )
        if wellformed.all():
            flat = np.frombuffer(
                b"".join(sig for _, _, sig in items), dtype=np.uint8
            ).reshape(n, 64)
            r_rows[:n] = flat[:, :32]
            s_rows[:n] = flat[:, 32:]
        else:
            for i, (_, _, sig) in enumerate(items):
                if len(sig) != 64:
                    continue
                r_rows[i] = np.frombuffer(sig[:32], dtype=np.uint8)
                s_rows[i] = np.frombuffer(sig[32:], dtype=np.uint8)
        if with_m:
            m_rows[:n] = np.frombuffer(
                b"".join(d for _, d, _ in items), dtype=np.uint8
            ).reshape(n, 32)
        prevalid[:n] = (
            wellformed
            & self._rows_lt(r_rows[:n], P, mask255=True)
            & self._rows_lt(s_rows[:n], host_ed.L)
        )
        return (idx, r_rows, s_rows, m_rows), prevalid, n

    #: Unique-digest capacity of the grouped challenge format (the per-lane
    #: digest index is one byte). Chunks above it (adversarial or
    #: synthetic: a consensus window has a handful of distinct claims)
    #: ride per-lane digest rows.
    M_GROUP_CAP = 256
    #: Bucket ladder for the unique-digest table.
    M_BUCKETS = (16, 256)

    def group_digests(self, items, bucket: int):
        """Dedup the items' digests for the grouped challenge format.

        Returns ``(m_idx, m_uniq, u)``: ``m_idx`` [bucket] uint8 lane ->
        digest-slot indices, ``m_uniq`` [m_bucket, 32] uint8 unique digest
        rows (first ``u`` live); or None when the chunk has more than
        :data:`M_GROUP_CAP` distinct digests. First-seen order assigns
        slots, so packing is deterministic."""
        cap = min(self.M_GROUP_CAP, 256)  # m_idx is uint8: hard ceiling
        slots: dict = {}
        m_idx = np.zeros(bucket, dtype=np.uint8)
        for i, (_, d, _) in enumerate(items):
            s = slots.get(d)
            if s is None:
                s = len(slots)
                if s >= cap:
                    return None
                slots[d] = s
            m_idx[i] = s
        u = len(slots)
        mb = bucketing.bucket_for(max(u, 1), self.M_BUCKETS)
        m_uniq = np.zeros((mb, 32), dtype=np.uint8)
        if u:
            m_uniq[:u] = np.frombuffer(
                b"".join(slots), dtype=np.uint8
            ).reshape(u, 32)
        return m_idx, m_uniq, u

    def pack_wire_indexed(self, items, table: ValidatorTable):
        """Indexed-A packing: like :meth:`pack_wire`, but A ships as an
        int32 index into ``table``. Requires every pubkey in the table.
        Returns ((idx, r_rows, s_rows, k_rows), prevalid, n)."""
        items = list(items)
        (_, r_rows, s_rows, k_rows), prevalid, n = self.pack_wire(items)
        idx, all_known = self.index_lanes(items, table)
        if not all_known:
            raise ValueError(
                "pack_wire_indexed requires every pubkey in the table"
            )
        return (idx, r_rows, s_rows, k_rows), prevalid, n


# --------------------------------------------------------------- verifier


class PendingVerify:
    """Verification launches enqueued but not yet materialized, the handle
    :meth:`TorchWireVerifier.verify_signatures_begin` returns. :meth:`mask`
    performs the launches' one concatenated device-to-host copy and is
    idempotent (the resolved mask is cached)."""

    __slots__ = ("_pending", "_mask")

    def __init__(self, pending):
        #: (device_result | None, prevalid, n) per enqueued chunk, in
        #: output order; None results are fully host-rejected chunks.
        self._pending = pending
        self._mask = None

    def mask(self) -> np.ndarray:
        """Block until every enqueued launch lands; bool verdicts in item
        order (``repeats`` consecutive copies when tiled)."""
        if self._mask is not None:
            return self._mask
        pending = self._pending
        devs = [d for d, _, _ in pending if d is not None]
        big = torch.cat(devs).cpu().numpy() if devs else None
        off = 0
        out = []
        for dev, prevalid, n in pending:
            if dev is None:
                out.append(prevalid[:n].copy())
                continue
            width = dev.shape[0]
            out.append((big[off : off + width] & prevalid)[:n])
            off += width
        if not out:
            self._mask = np.zeros(0, dtype=bool)
        elif len(out) == 1:
            self._mask = out[0]
        else:
            self._mask = np.concatenate(out)
        self._pending = ()
        return self._mask


class TorchWireVerifier:
    """Batch verifier over the wire path, a drop-in for
    :class:`~hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier`.

    Routes, per chunk of at most the largest bucket:

    - **grouped challenge** (69 B a lane + 32 B a distinct digest): every
      pubkey is in the resident table, every digest is 32 bytes and the
      chunk has at most ``M_GROUP_CAP`` distinct digests (every consensus
      window). The device computes k from the deduped digest table, then
      the semiwire kernel runs on -A gathered from the table (one library
      call enqueues both, ``ed25519_cuda.chal_semiwire_verify``);
    - **per-lane challenge** (100 B a lane): as grouped, with per-lane
      digest rows, above ``M_GROUP_CAP`` distinct digests;
    - **full wire** (128 B a lane): no table, a digest of another length,
      or any pubkey not in the table: the host hashes, the wire kernel
      decompresses both points. This is the routing rule, not a fallback:
      verdicts never depend on what the table holds.

    ``device=None`` means ``"cuda"`` and raises without CUDA. On a CUDA
    device every route launches its kernel; with ``device="cpu"`` every
    route runs the plain versions. The table must lie on the verifier's
    device."""

    def __init__(self, buckets=(64, 256, 1024, 4096),
                 table: "ValidatorTable | None" = None, device=None):
        from hyperdrive_tpu_torch.ops import ed25519_cuda

        self.device = _resolve_device(device)
        self.host = Ed25519WireHost(buckets=buckets)
        self._fn = ed25519_cuda.wire_verify
        self._chal_semi = ed25519_cuda.chal_semiwire_verify
        #: k rows of the challenge routes, one buffer per (lanes, stream),
        #: reused by every launch of that width on that stream; the lock
        #: keeps one thread's two launches on a buffer together.
        self._k_scratch: dict = {}
        self._k_lock = threading.Lock()
        self._check_table(table)
        self.table = table
        #: Epoch table generations: the current and the previous
        #: generation's tables stay resident, so windows on both sides of
        #: an epoch boundary launch without re-uploading either.
        self.generation = 0
        self._tables: dict = {0: table} if table is not None else {}
        #: Wire-format accounting, reset with :meth:`reset_stats`:
        #: ``lanes_*`` = real (unpadded) signatures per route,
        #: ``format_bytes`` = their per-lane field bytes on the wire
        #: (grouped: 69*n + 32*U; per-lane challenge: 100*n; full wire:
        #: 128*n). Lock-guarded: one verifier may serve several threads.
        self.stats = {
            "lanes_grouped": 0,
            "lanes_chal": 0,
            "lanes_wire": 0,
            "format_bytes": 0,
        }
        self._stats_lock = threading.Lock()

    def _check_table(self, table) -> None:
        if table is not None and table.device != self.device:
            raise ValueError(
                f"table on {table.device}, verifier on {self.device}"
            )

    def install_table(self, table, generation=None) -> None:
        """Install the next generation's table at an epoch boundary; the
        previous generation stays resident, older ones are evicted."""
        self._check_table(table)
        if generation is None:
            generation = self.generation + 1
        generation = int(generation)
        prev = self.generation
        self._tables = {g: t for g, t in self._tables.items() if g == prev}
        self._tables[generation] = table
        self.table = table
        self.generation = generation

    def set_generation(self, generation: int) -> None:
        """Select which resident table generation the next launch uses."""
        generation = int(generation)
        got = self._tables.get(generation)
        if got is None:
            raise KeyError(
                f"table generation {generation} is not resident "
                f"(have {sorted(self._tables)})"
            )
        self.table = got
        self.generation = generation

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats = {k: 0 for k in self.stats}

    def _count(self, lane_key: str, lanes: int, fbytes: int) -> None:
        with self._stats_lock:
            self.stats[lane_key] += lanes
            self.stats["format_bytes"] += fbytes

    def bytes_per_lane(self) -> float:
        """Mean wire-format bytes per real lane since the last reset (0.0
        when nothing was verified)."""
        lanes = (self.stats["lanes_grouped"] + self.stats["lanes_chal"]
                 + self.stats["lanes_wire"])
        return self.stats["format_bytes"] / lanes if lanes else 0.0

    def _upload(self, key: str, rows):
        """Host rows -> device tensors, once per packed chunk; table
        indices are range-checked on the host first."""
        head = () if key == "lanes_wire" else (self.table.upload_index(rows[0]),)
        return head + tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in rows[len(head):]
        )

    def _device_verify(self, rows):
        return self._fn(*rows)

    def _k_rows(self, lanes: int) -> torch.Tensor:
        """The k scratch for ``lanes`` on the current stream (caller holds
        ``_k_lock``)."""
        stream = (torch.cuda.current_stream(self.device).cuda_stream
                  if self.device.type == "cuda" else 0)
        buf = self._k_scratch.get((lanes, stream))
        if buf is None:
            buf = torch.empty((lanes, 32), dtype=torch.uint8, device=self.device)
            self._k_scratch[(lanes, stream)] = buf
        return buf

    def _device_verify_chal(self, rows, m_idx=None):
        idx, r_rows, s_rows, m_rows = rows
        with self._k_lock:
            return self._chal_semi(idx, r_rows, s_rows, m_rows, self.table.rows,
                                   *self.table.arrays(), self._k_rows(idx.shape[0]),
                                   m_idx=m_idx)

    def _device_verify_chal_grouped(self, rows):
        idx, r_rows, s_rows, m_idx, m_uniq = rows
        return self._device_verify_chal((idx, r_rows, s_rows, m_uniq), m_idx)

    def warmup(self) -> None:
        """Build the kernels and run every route at every bucket shape
        once, so a timed run never bills the build."""
        for b in self.host.buckets:
            z = torch.zeros((b, 32), dtype=torch.uint8, device=self.device)
            self._device_verify((z, z, z, z)).cpu()
            if self.table is not None:
                zi = torch.zeros(b, dtype=torch.int32, device=self.device)
                self._device_verify_chal((zi, z, z, z)).cpu()
                zm = torch.zeros(b, dtype=torch.uint8, device=self.device)
                for mb in self.host.M_BUCKETS:
                    zu = torch.zeros((mb, 32), dtype=torch.uint8,
                                     device=self.device)
                    self._device_verify_chal_grouped((zi, z, z, zm, zu)).cpu()

    def verify_signatures_begin(self, items, repeats: int = 1) -> PendingVerify:
        """Enqueue the verification launches for ``items`` without
        materializing the mask; :meth:`PendingVerify.mask` fetches every
        launch's verdicts in one copy.

        ``repeats > 1`` verifies that many copies of ``items`` with the
        host pack paid once: each chunk's rows are shipped once and
        re-launched per copy. ``lanes_*`` count every verified lane (n per
        copy), ``format_bytes`` each packed lane once. The mask holds
        ``repeats`` consecutive copies of the per-item verdicts."""
        items = list(items)
        cap = self.host.buckets[-1]
        pending: list = []
        packed: list = []  # (stats_key, launch, rows, prevalid, n)
        for lo in range(0, len(items), cap):
            chunk = items[lo : lo + cap]
            if self.table is not None and all(len(d) == 32 for _, d, _ in chunk):
                idx, all_known = self.host.index_lanes(chunk, self.table)
                if all_known:
                    grouped = self.host.group_digests(chunk, len(idx))
                    rows, prevalid, n = self.host.pack_wire_challenge(
                        chunk, self.table, with_m=grouped is None, _idx=idx,
                    )
                    idx, r_rows, s_rows, m_rows = rows
                    if grouped is not None:
                        m_idx, m_uniq, u = grouped
                        self._count("lanes_grouped", n, 69 * n + 32 * u)
                        packed.append((
                            "lanes_grouped", self._device_verify_chal_grouped,
                            (idx, r_rows, s_rows, m_idx, m_uniq), prevalid, n,
                        ))
                    else:
                        self._count("lanes_chal", n, 100 * n)
                        packed.append((
                            "lanes_chal", self._device_verify_chal,
                            (idx, r_rows, s_rows, m_rows), prevalid, n,
                        ))
                    continue
            rows, prevalid, n = self.host.pack_wire(chunk)
            self._count("lanes_wire", n, 128 * n)
            packed.append(("lanes_wire", self._device_verify, rows, prevalid, n))
        for rep in range(repeats):
            for j, (key, launch, rows, prevalid, n) in enumerate(packed):
                if not prevalid.any():
                    pending.append((None, prevalid, n))
                    continue
                if rep == 0:
                    rows = self._upload(key, rows)
                    packed[j] = (key, launch, rows, prevalid, n)
                else:
                    self._count(key, n, 0)
                pending.append((launch(rows), prevalid, n))
        return PendingVerify(pending)

    def verify_signatures(self, items) -> np.ndarray:
        """items: list of (pub, digest, sig); returns bool[n]. All launches
        are enqueued before the one concatenated fetch."""
        return self.verify_signatures_begin(items).mask()

    def verify_batch(self, window):
        """Verifier-protocol entry (messages with detached signatures);
        unsigned messages fail."""
        items = [(m.sender, m.digest(), m.signature) for m in window]
        unsigned = np.array([not m.signature for m in window], dtype=bool)
        ok = self.verify_signatures(items)
        return list(ok & ~unsigned)
