"""Batched Ed25519 signature verification (PyTorch).

The port of the JAX package's ``ops/ed25519_jax.py`` on the packed-input
path: checks ``[s]B == R + [k]A`` for a whole batch of votes in one launch.

Work split (host does the bit-twiddly, device does the wide math):

- **Host** (:class:`Ed25519BatchHost`): parse signatures, SHA-512
  challenge scalars, decompress A and R, range-check s, negate A, pack
  everything into int32 limb rows padded to a bucketed batch size. The
  reference's packer with its dedup fan-out, array for array: the native
  C++ packer (:mod:`hyperdrive_tpu_torch.native`, ``hd_pack_batch``) when
  it builds, the pure-Python loop otherwise (``use_native=False`` or
  ``HD_NO_NATIVE=1``).
- **Device**: the hand-written CUDA ladder
  (:mod:`hyperdrive_tpu_torch.ops.ed25519_cuda`, ``csrc/``), the port of
  the TPU kernel. :func:`verify_plain` is its plain PyTorch version — the
  reference's ``verify_kernel`` on :mod:`hyperdrive_tpu_torch.ops.fe25519`
  — which the CPU tests use and which ``chip_smoke.py`` holds the kernel
  against on the card.

Verification semantics match the host oracle
(:func:`hyperdrive_tpu_torch.crypto.ed25519.verify`) bit for bit:
malformed points, out-of-range s and wrong signatures all reject.
:class:`TorchBatchVerifier` keeps the surface the harness duck-types
(``host``, ``verify_signatures``, ``verify_batch``, ``fused_inner``).

With ``rlc=True`` each chunk is first checked by the random-linear-
combination batch equation (:func:`rlc_check`, PyTorch ops on the
Pippenger engine of :mod:`hyperdrive_tpu_torch.ops.msm`; a jnp program in
the reference, so no hand-written kernel), and a chunk whose combined
check fails re-runs through the CUDA ladder for strict per-lane verdicts.
The equation is cofactored: see :func:`rlc_check`. ``rlc="auto"``
resolves as the reference's does for its Pallas backend, whose
counterpart the CUDA ladder is: ``HD_RLC`` when set, else off. Dropped
from the reference's verifier: the metrics recorder (``obs``) and its
occupancy and MSM events.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
from hyperdrive_tpu_torch.ops import bucketing
from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops import msm

__all__ = [
    "Ed25519BatchHost",
    "TorchBatchVerifier",
    "from_reference",
    "msm_kernel",
    "rlc_check",
    "rlc_scalars",
    "verify_plain",
]

P = host_ed.P

# 2d mod p — the constant in the unified addition law.
K2D = (2 * host_ed.D) % P
K2D_LIMBS = fe.to_limbs(K2D)


# ----------------------------------------------------------- point algebra
# A point batch is a tuple (X, Y, Z, T) of [..., 20] int32 tensors. Table
# entries are stored in niels form (y+x, y-x, 2d*t [, z]). The formulas
# are the reference's _madd/_padd/_dbl; independent field operations of
# one formula run as one stacked call (elementwise, so every limb is the
# same) to keep the op count of the plain version down.


def _stack_op(op, *pairs):
    """``op`` over several same-shape operand pairs in one stacked call."""
    return op(
        torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    ).unbind(0)


def _niels_tail(a, b, c, d, need_t: bool):
    """Shared tail of the addition formulas, from their A, B, C, D."""
    e, f = _stack_op(fe.sub, (b, a), (d, c))
    g, h = _stack_op(fe.add, (d, c), (b, a))
    if need_t:
        return tuple(_stack_op(fe.mul, (e, f), (g, h), (f, g), (e, h)))
    return tuple(_stack_op(fe.mul, (e, f), (g, h), (f, g)))


def _madd(p, n, need_t: bool):
    """Extended point + affine niels entry (z2 = 1)."""
    x1, y1, z1, t1 = p
    yp2, ym2, t2d2 = n
    a, b, c = _stack_op(
        fe.mul, (fe.sub(y1, x1), ym2), (fe.add(y1, x1), yp2), (t1, t2d2)
    )
    return _niels_tail(a, b, c, fe.mul_small(z1, 2), need_t)


def _padd(p, n, need_t: bool):
    """Extended point + projective niels entry (z2 != 1)."""
    x1, y1, z1, t1 = p
    yp2, ym2, t2d2, z2 = n
    a, b, c, zz = _stack_op(
        fe.mul,
        (fe.sub(y1, x1), ym2), (fe.add(y1, x1), yp2), (t1, t2d2), (z1, z2),
    )
    return _niels_tail(a, b, c, fe.mul_small(zz, 2), need_t)


def _dbl(p3, need_t: bool):
    """Doubling on (x, y, z); the T output only when asked."""
    x1, y1, z1 = p3
    a, b, zz, s = fe.sqr(torch.stack([x1, y1, z1, fe.add(x1, y1)])).unbind(0)
    c = fe.mul_small(zz, 2)
    d = fe.neg(a)
    e = fe.sub(fe.sub(s, a), b)
    g = fe.add(d, b)
    f = fe.sub(g, c)
    h = fe.sub(d, b)
    if need_t:
        return tuple(_stack_op(fe.mul, (e, f), (g, h), (f, g), (e, h)))
    return tuple(_stack_op(fe.mul, (e, f), (g, h), (f, g)))


def _add_ext(p, q, need_t: bool):
    """Unified addition of two extended projective points (add-2008-hwcd,
    as in :func:`_padd` with the niels transform of ``q`` inlined)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    s1, s2 = _stack_op(fe.sub, (y1, x1), (y2, x2))
    p1, p2 = _stack_op(fe.add, (y1, x1), (y2, x2))
    t2d = fe.mul(t2, fe._const(K2D_LIMBS, t2))
    a, b, c, zz = _stack_op(fe.mul, (s1, s2), (p1, p2), (t1, t2d), (z1, z2))
    return _niels_tail(a, b, c, fe.mul_small(zz, 2), need_t)


def _dbl4_ext(p4):
    """Four doublings of an extended point batch, T produced on the last
    only (the Horner shift by one 4-bit window)."""
    p3 = p4[:3]
    for _ in range(3):
        p3 = _dbl(p3, need_t=False)
    return _dbl(p3, need_t=True)


# --------------------------------------------------------- B window table

_WINDOW = 4
_N_WINDOWS = 64  # 256 bits / 4


@functools.lru_cache(maxsize=None)
def _b_niels_np(entries: int = 16):
    """[v]B for v in 0..entries-1 as affine niels limbs (y+x, y-x, 2d*x*y),
    each ``[entries, 20]`` int32."""
    yp, ym, t2 = [], [], []
    pt = host_ed.IDENTITY
    for _v in range(entries):
        x, y, z, _ = pt
        zinv = pow(z, P - 2, P)
        xa, ya = (x * zinv) % P, (y * zinv) % P
        yp.append((ya + xa) % P)
        ym.append((ya - xa) % P)
        t2.append((K2D * xa * ya) % P)
        pt = host_ed.point_add(pt, host_ed.BASE)
    return (fe.to_limbs(yp), fe.to_limbs(ym), fe.to_limbs(t2))


def _recode_signed(nibbles: torch.Tensor) -> torch.Tensor:
    """[B, 64] unsigned base-16 digits -> [64, B] signed digits in [-8, 7].

    Digits >= 8 borrow 16 and carry 1 into the next position; the final
    carry is dropped. Both verified scalars are < 2^253 on packer output,
    so nothing is lost there; on other inputs the drop is what the
    reference does too, and the kernel keeps it."""
    carry = torch.zeros_like(nibbles[:, 0])
    out = []
    for i in range(_N_WINDOWS):
        d = nibbles[:, i] + carry
        ge = (d >= 8).to(torch.int32)
        out.append(d - 16 * ge)
        carry = ge
    return torch.stack(out)


def _select_signed(digit: torch.Tensor, table, shared: bool):
    """Entry [|digit|] of a 9-entry niels table, negated when the digit is
    negative (swap y+x and y-x, negate 2d*t; z passes through). Selection
    is an indexed gather: ``table`` components are ``[9, 20]`` (shared) or
    ``[B, 9, 20]`` (per signature)."""
    sign = digit < 0
    mag = digit.abs().long()
    if shared:
        sel = [comp[mag] for comp in table]
    else:
        rows = torch.arange(digit.shape[0], device=digit.device)
        sel = [comp[rows, mag] for comp in table]
    yp, ym, t2 = sel[0], sel[1], sel[2]
    out = (
        fe.select(sign, ym, yp),
        fe.select(sign, yp, ym),
        fe.select(sign, fe.neg(t2), t2),
    )
    return out if shared else (*out, sel[3])


def verify_plain(ax, ay, at, rx, ry, s_nib, k_nib) -> torch.Tensor:
    """Batched check of [s]B + [k]A' == R (A' = -A, all inputs packed) —
    the plain PyTorch version of the CUDA ladder, a port of the reference's
    ``verify_kernel``.

    Args (int32, one device): ax, ay, at ``[B, 20]`` affine extended -A;
    rx, ry ``[B, 20]`` affine R; s_nib, k_nib ``[B, 64]`` little-endian
    base-16 digits. Returns bool ``[B]``.

    Shares the reference's PRECONDITION: scalars must be < 2^253 (the
    packer guarantees it; see :func:`_recode_signed`)."""
    bsz = ax.shape[0]
    one = fe._const(fe.ONE, ax).expand(bsz, fe.N_LIMBS)
    zero = torch.zeros_like(one)
    k2d = fe._const(K2D_LIMBS, ax)

    k_signed = _recode_signed(k_nib)  # [64, B]
    s_signed = _recode_signed(s_nib)

    # Per-signature table of [0..8]A' (projective), then niels form.
    a_niels = (fe.add(ay, ax), fe.sub(ay, ax), fe.mul(at, k2d))
    pt = (zero, one, one, zero)
    entries = []
    for v in range(9):
        entries.append(pt)
        if v < 8:
            pt = _madd(pt, a_niels, need_t=True)
    sx, sy, sz, st = (
        torch.stack([e[c] for e in entries], dim=1) for c in range(4)
    )  # each [B, 9, 20]
    ta = (fe.add(sy, sx), fe.sub(sy, sx), fe.mul(st, k2d), sz)
    tb = tuple(fe._const(c, ax) for c in _b_niels_np(9))

    acc3 = (zero, one, one)
    for i in range(_N_WINDOWS):
        w = _N_WINDOWS - 1 - i
        for _ in range(_WINDOW - 1):
            acc3 = _dbl(acc3, need_t=False)
        acc4 = _dbl(acc3, need_t=True)
        acc4 = _padd(acc4, _select_signed(k_signed[w], ta, shared=False), True)
        acc3 = _madd(acc4, _select_signed(s_signed[w], tb, shared=True), False)

    px, py, pz = acc3
    return fe.eq(px, fe.mul(rx, pz)) & fe.eq(py, fe.mul(ry, pz))


# ------------------------------------------------------- MSM on ed25519
# The curve's side of the Pippenger engine (:mod:`hyperdrive_tpu_torch.ops.
# msm`): the reference's ``msm._ed25519_ops``, ``_niels_affine`` and
# ``msm_kernel``, kept here so the engine stays free of any curve.


def _identity(shape, like):
    """Identity points (0, 1, 1, 0), each component ``[*shape, 20]``, as
    broadcast views of one constant row (the engine stacks them)."""
    one = fe._const(fe.ONE, like).expand(*shape, fe.N_LIMBS)
    return (torch.zeros_like(one), one, one, torch.zeros_like(one))


def _entry_select(sign, entry):
    """Negate a niels point where ``sign``: swap the (y+x, y-x) pair,
    negate 2d*t."""
    yp, ym, t2 = entry
    return (
        fe.select(sign, ym, yp),
        fe.select(sign, yp, ym),
        fe.select(sign, fe.neg(t2), t2),
    )


#: Niels entries mixed into extended accumulators.
CURVE_OPS = msm.CurveOps(
    n_limbs=fe.N_LIMBS,
    bucket_identity=lambda shape, like: _identity((*shape, msm.N_BUCKETS + 1), like),
    entry_select=_entry_select,
    add_entry=lambda acc, entry: _madd(acc, entry, need_t=True),
    add=lambda a, b: _add_ext(a, b, need_t=True),
    window_shift=_dbl4_ext,
)


def niels_affine(px, py, pt):
    """Affine point batch -> niels components (y+x, y-x, 2d*t)."""
    return (fe.add(py, px), fe.sub(py, px), fe.mul(pt, fe._const(K2D_LIMBS, pt)))


def pack_affine(points) -> tuple:
    """Host points (extended ``(X, Y, Z, T)`` of the oracle, any Z) ->
    affine limb rows ``(px, py, pt)``, each ``[N, 20]`` int32 numpy, with
    t = x*y: the engine's inputs must have z = 1, so each point is
    normalized first."""
    xs, ys = [], []
    for x, y, z, _ in points:
        zinv = pow(z, P - 2, P)
        xs.append(x * zinv % P)
        ys.append(y * zinv % P)
    return (
        fe.to_limbs(xs).reshape(-1, fe.N_LIMBS),
        fe.to_limbs(ys).reshape(-1, fe.N_LIMBS),
        fe.to_limbs([x * y % P for x, y in zip(xs, ys)]).reshape(-1, fe.N_LIMBS),
    )


def msm_kernel(px, py, pt, digits):
    """sum_i [s_i]P_i over affine extended ed25519 points, scalars
    pre-decomposed to signed 4-bit windows.

    Args (all int32, one device):
      px, py, pt: [N, 20] affine extended coords (z = 1, t = x*y mod p;
                  :func:`pack_affine` normalizes host points)
      digits:     [W, N] signed window digits in [-8, 8], window 0 least
                  significant (:func:`_recode_signed` of nibbles)
    Returns: the sum as an extended projective point, [1, 20] x4.
    """
    return msm.msm_engine(niels_affine(px, py, pt), digits, CURVE_OPS)


def affine_of(point) -> tuple[int, int]:
    """An extended ``[1, 20]`` x4 result -> affine (x, y) ints (test and
    smoke helper: one modular inverse on the host)."""
    x, y, z = (fe.from_limbs(np.asarray(c.cpu())[0]) for c in point[:3])
    zinv = pow(z % P, P - 2, P)
    return x * zinv % P, y * zinv % P


# ------------------------------------------------- RLC batch verification
#
# The random-linear-combination equation: with per-signature random 128-bit
# z_i and m_i = z_i*k_i mod L, c = sum z_i*s_i mod L, every signature in
# the batch is valid iff (w.h.p. over z)
#
#     [8]([c]B - sum_i [z_i]R_i - sum_i [m_i]A_i) == O.
#
# The batch sum reduces through one Pippenger MSM pass instead of a ladder
# a signature. The three final doublings clear the cofactor of the
# COMBINED sum, so the relation is the cofactored one: a crafted signature
# that is valid cofactored but invalid under the strict cofactorless check
# (it needs a small-order torsion point; honest signers never make one) is
# accepted here where the ladder and the host oracle reject it. That is
# the divergence the batch-verification literature accepts ("Taming the
# many EdDSAs": batch verify == cofactored single verify); rlc=False keeps
# the strict per-signature semantics and stays the default.


def rlc_check(ax, ay, at, rx, ry, m_nib, z_nib, c_nib) -> torch.Tensor:
    """Batched RLC check: does [8]([c]B + sum([z_i](-R_i) + [m_i](-A_i)))
    vanish? The port of the reference's ``rlc_kernel``.

    Args (int32, one device):
      ax, ay, at: [B, 20] affine extended coords of -A (as the ladder's)
      rx, ry:     [B, 20] affine coords of R (negated here)
      m_nib:      [B, 64] nibbles of m_i = z_i*k_i mod L (zero for invalid
                  lanes, which then contribute the identity)
      z_nib:      [B, 64] nibbles of z_i (only the low 32 are nonzero)
      c_nib:      [1, 64] nibbles of c = sum z_i*s_i mod L
    Returns: bool [] — True iff the whole batch verifies (cofactored).

    Two MSMs share one bucket accumulation
    (:func:`hyperdrive_tpu_torch.ops.msm.msm_window_sums`): sum [m_i](-A_i)
    over 64 signed windows and sum [z_i](-R_i) over 33 (z is 128-bit; one
    window absorbs the recode carry). Their window sums and the window's
    fixed-base entry [c_w]B (the 16-entry niels table, unsigned digits)
    add per window, and one Horner join makes the total: the same group
    element as the reference's two MSM joins plus its [c]B walk."""
    half = msm.ED25519_HALF_WINDOWS
    m_digits = _recode_signed(m_nib)  # [64, B]
    z_digits = _recode_signed(z_nib)[:half]  # [33, B]
    nrx = fe.neg(rx)
    s_a, s_r = msm.msm_window_sums(
        [
            (niels_affine(ax, ay, at), m_digits),
            (niels_affine(nrx, ry, fe.mul(nrx, ry)), z_digits),
        ],
        CURVE_OPS,
    )
    low = _add_ext(tuple(c[:half] for c in s_a), s_r, need_t=True)
    wsums = tuple(torch.cat([lo, c[half:]]) for lo, c in zip(low, s_a))
    cd = c_nib[0].long()  # [64] unsigned digits
    tb = tuple(fe._const(comp, ax)[cd] for comp in _b_niels_np())
    wsums = _madd(wsums, tb, need_t=True)
    total = msm.horner(wsums, CURVE_OPS)
    # Cofactor-clear the combined sum: three doublings annihilate every
    # 8-torsion component, from R and A alike.
    p3 = total[:3]
    for _ in range(3):
        p3 = _dbl(p3, need_t=False)
    sx, sy, sz = p3
    # Projective identity: X == 0 and Y == Z.
    return (fe.is_zero(sx) & fe.eq(sy, sz))[0]


# ------------------------------------------------------------- host packer


def _nibbles(x: int) -> np.ndarray:
    return np.array([(x >> (4 * i)) & 0xF for i in range(64)], dtype=np.int32)


def _nibbles_from_rows(rows: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 little-endian scalars -> [B, 64] int32 base-16 digits."""
    out = np.empty((rows.shape[0], 64), dtype=np.int32)
    out[:, 0::2] = rows & 0xF
    out[:, 1::2] = rows >> 4
    return out


def _ints_from_nibbles(nib: np.ndarray) -> list[int]:
    """[B, 64] int32 nibbles -> per-row little-endian integers."""
    rows = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8).tobytes()
    return [
        int.from_bytes(rows[i * 32 : (i + 1) * 32], "little")
        for i in range(nib.shape[0])
    ]


def rlc_scalars(s_nib, k_nib, prevalid, binder: bytes):
    """Host half of the RLC equation: derive the per-lane random weights
    and the combined scalars :func:`rlc_check` consumes (the reference's
    function, copied: numpy and hashlib, outputs equal array for array).

    ``binder`` must commit to the whole batch content (pubs, digests,
    signatures) BEFORE the weights are derived — Fiat-Shamir style — so a
    signer cannot craft signatures that cancel under known weights.
    Returns (m_nib [B,64], z_nib [B,64], c_nib [1,64]); invalid lanes get
    zero digits and contribute the identity on the device.
    """
    bsz = prevalid.shape[0]
    seed = hashlib.sha256(b"hd-rlc-v3" + binder).digest()
    s_ints = _ints_from_nibbles(s_nib)
    k_ints = _ints_from_nibbles(k_nib)
    L = host_ed.L
    m_rows = np.zeros((bsz, 32), dtype=np.uint8)
    z_rows = np.zeros((bsz, 32), dtype=np.uint8)
    c = 0
    for i in range(bsz):
        if not prevalid[i]:
            continue
        # Plain 128-bit weights: torsion is cleared by rlc_check's final
        # cofactor doublings, not by weight structure.
        zi = int.from_bytes(
            hashlib.sha512(seed + i.to_bytes(4, "little")).digest()[:16],
            "little",
        )
        m_rows[i] = np.frombuffer(
            ((zi * k_ints[i]) % L).to_bytes(32, "little"), dtype=np.uint8
        )
        z_rows[i] = np.frombuffer(zi.to_bytes(32, "little"), dtype=np.uint8)
        c = (c + zi * s_ints[i]) % L
    c_rows = np.frombuffer(c.to_bytes(32, "little"), dtype=np.uint8)
    return (
        _nibbles_from_rows(m_rows),
        _nibbles_from_rows(z_rows),
        _nibbles_from_rows(c_rows[None, :]),
    )


def rlc_binder(chunk, generation: int = 0) -> bytes:
    """The batch transcript the RLC weights commit to: every (pub,
    digest, sig) length-framed so the byte stream parses uniquely, with
    the ``hd-gen`` frame of the pubkey-table generation first when it is
    nonzero (the reference's binder, byte for byte)."""
    binder = b"".join(
        len(p).to_bytes(2, "little")
        + p
        + len(d).to_bytes(4, "little")
        + d
        + len(s).to_bytes(2, "little")
        + s
        for p, d, s in chunk
    )
    if generation:
        binder = b"hd-gen" + int(generation).to_bytes(8, "little") + binder
    return binder


def _dedup_scan(items):
    """One pass over (pub, digest, sig) triples: returns (uniq, inv) with
    items[i] == uniq[inv[i]]."""
    index: dict = {}
    uniq: list = []
    inv = np.empty(len(items), dtype=np.int32)
    for i, it in enumerate(items):
        j = index.get(it)
        if j is None:
            j = index[it] = len(uniq)
            uniq.append(it)
        inv[i] = j
    return uniq, inv


class Ed25519BatchHost:
    """Parses/packs (pubkey, digest, signature) triples for the kernel,
    padded up to the next size in ``buckets``.

    Packing runs through the native runtime when it is available (point
    decompression is one field exponentiation per point and dominates the
    host cost), with the pure-Python loop as the always-available path;
    both produce identical arrays and masks (differentially tested)."""

    def __init__(self, buckets=(64, 256, 1024, 4096), use_native: bool = True):
        self.buckets = tuple(sorted(buckets))
        self._native = None
        if use_native:
            from hyperdrive_tpu_torch import native

            self._native = native.instance()

    def bucket_for(self, n: int) -> int:
        return bucketing.bucket_for(n, self.buckets)

    def pack(self, items, _scan=None):
        """items: iterable of (pub32, digest, sig64).

        Returns (arrays, prevalid, n): arrays feed the ladder, prevalid
        marks host-side rejections (bad point/range) as False, n is the
        true batch size before padding. Majority-duplicate batches pack
        each distinct triple once and fan the rows out by index.
        """
        items = list(items)
        n = len(items)
        uniq, inv = _scan if _scan is not None else _dedup_scan(items)
        if n and 2 * len(uniq) <= n:
            arrays_u, prevalid_u, nu = self.pack(uniq)
            bsz = self.bucket_for(max(n, 1))
            out = []
            for a in arrays_u:
                o = np.zeros((bsz,) + a.shape[1:], dtype=a.dtype)
                o[:n] = a[:nu][inv]
                out.append(o)
            prevalid = np.zeros(bsz, dtype=bool)
            prevalid[:n] = prevalid_u[:nu][inv]
            return tuple(out), prevalid, n

        bsz = self.bucket_for(max(n, 1))
        ax = np.zeros((bsz, fe.N_LIMBS), dtype=np.int32)
        ay = np.zeros_like(ax)
        at = np.zeros_like(ax)
        rx = np.zeros_like(ax)
        ry = np.zeros_like(ax)
        s_nib = np.zeros((bsz, 64), dtype=np.int32)
        k_nib = np.zeros((bsz, 64), dtype=np.int32)
        prevalid = np.zeros(bsz, dtype=bool)

        if self._native is not None:
            prevalid[:n] = self._native.pack_into(
                items, ax, ay, at, rx, ry, s_nib, k_nib
            )
            return (ax, ay, at, rx, ry, s_nib, k_nib), prevalid, n

        for i, (pub, digest, sig) in enumerate(items):
            if len(pub) != 32 or len(sig) != 64:
                continue
            a_pt = host_ed.point_decompress(pub)
            if a_pt is None:
                continue
            r_pt = host_ed.point_decompress(sig[:32])
            if r_pt is None:
                continue
            s = int.from_bytes(sig[32:], "little")
            if s >= host_ed.L:
                continue
            k = host_ed.challenge_scalar(sig[:32], pub, digest)
            # Negate A (x -> p - x): the ladder computes [s]B + [k](-A).
            nax = (P - a_pt[0]) % P
            nay = a_pt[1]
            ax[i] = fe.to_limbs(nax)
            ay[i] = fe.to_limbs(nay)
            at[i] = fe.to_limbs((nax * nay) % P)
            rx[i] = fe.to_limbs(r_pt[0])
            ry[i] = fe.to_limbs(r_pt[1])
            s_nib[i] = _nibbles(s)
            k_nib[i] = _nibbles(k)
            prevalid[i] = True

        return (ax, ay, at, rx, ry, s_nib, k_nib), prevalid, n


def _resolve_device(device) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return dev


def from_reference(arrays, prevalid, device=None):
    """The JAX package's packer output (``Ed25519BatchHost.pack``: seven
    numpy arrays and the prevalid mask) as this package's tensors on
    ``device``: ``(tensors, prevalid)``. Plain numpy in, so it needs
    nothing of the reference package."""
    dev = _resolve_device(device)
    tensors = tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        for a in arrays
    )
    return tensors, torch.from_numpy(np.asarray(prevalid, dtype=bool)).to(dev)


class TorchBatchVerifier:
    """Drop-in batch verifier that verifies a whole settle window in one
    kernel launch per chunk.

    ``device=None`` means ``"cuda"`` and raises without CUDA; tests pass
    ``device="cpu"``, where the same calls run :func:`verify_plain`.
    ``rlc=True`` checks each chunk with one :func:`rlc_check` first and
    re-runs a chunk whose combined check fails through the ladder
    (``rlc_fallbacks`` counts them, ``rlc_calls`` the checks);
    ``rlc="auto"`` is ``HD_RLC`` when set, else off.
    """

    def __init__(self, buckets=(64, 256, 1024, 4096), rlc="auto", device=None):
        if rlc == "auto":
            env = os.environ.get("HD_RLC")
            rlc = env is not None and env not in ("0", "")
        if rlc not in (True, False):
            raise ValueError(f"rlc must be 'auto', False or True, not {rlc!r}")
        from hyperdrive_tpu_torch.ops import ed25519_cuda

        self.device = _resolve_device(device)
        self.host = Ed25519BatchHost(buckets=buckets)
        self.rlc = bool(rlc)
        self._kernel = ed25519_cuda.verify
        #: Digest of the last RLC chunk's length-framed transcript (the
        #: binder): the batch-verify binding that quorum certificates
        #: fold in. b"" until the first RLC chunk verifies.
        self.last_transcript = b""
        #: Epoch table generation installed by the caller. When nonzero it
        #: is framed into the RLC binder, and so into last_transcript.
        self.generation = 0
        #: RLC chunks checked, and those that fell back to the ladder.
        self.rlc_calls = 0
        self.rlc_fallbacks = 0

    def _to_device(self, arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def fused_inner(self, batch: int):
        """The batch-verify callable ((ax..k_nib) tensors -> bool[B]) for
        composition with other device work on the same tensors."""
        return self._kernel

    def set_generation(self, generation: int) -> None:
        self.generation = int(generation)

    def warmup(self) -> None:
        """Build the kernel and run every bucket shape once (and the RLC
        check, when on), so a timed run never bills the build."""
        for b in self.host.buckets:
            z = torch.zeros((b, fe.N_LIMBS), dtype=torch.int32, device=self.device)
            zn = torch.zeros((b, 64), dtype=torch.int32, device=self.device)
            self._kernel(z, z, z, z, z, zn, zn).cpu()
            if self.rlc:
                bool(rlc_check(z, z, z, z, z, zn, zn, zn[:1]))

    def verify_signatures(self, items) -> np.ndarray:
        """items: list of (pub, digest, sig); returns bool[n].

        Windows beyond the largest bucket are chunked at that size, all
        chunks are enqueued before the first result is fetched, and a
        multi-chunk batch comes back in one device-to-host copy."""
        items = list(items)
        if not items:
            return np.zeros(0, dtype=bool)
        cap = bucketing.launch_target(self.host.buckets)
        pending = []
        if self.rlc:
            return self._verify_rlc(items, cap)
        for lo in range(0, len(items), cap):
            chunk = items[lo : lo + cap]
            scan = _dedup_scan(chunk)
            if 2 * len(scan[0]) <= len(chunk):
                pending.append(self._verify_chunk_deduped(chunk, scan))
                continue
            arrays, prevalid, n = self.host.pack(chunk, _scan=scan)
            if not prevalid.any():
                pending.append((None, prevalid, n))
                continue
            pending.append((self._kernel(*self._to_device(arrays)), prevalid, n))

        devs = [d for d, _, _ in pending if d is not None]
        if len(devs) > 1:
            big = torch.cat(devs).cpu().numpy()
            off = 0
            out = []
            for dev, prevalid, n in pending:
                if dev is None:
                    out.append(prevalid[:n].copy())
                    continue
                width = dev.shape[0]
                out.append((big[off : off + width] & prevalid)[:n])
                off += width
            return np.concatenate(out)
        out = []
        for dev, prevalid, n in pending:
            if dev is None:
                out.append(prevalid[:n].copy())  # all lanes malformed
            else:
                out.append((dev.cpu().numpy() & prevalid)[:n])
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _verify_rlc(self, items, cap) -> np.ndarray:
        """The RLC schedule: every chunk's combined check is enqueued
        first; then each verdict is read, and a chunk whose check failed
        re-runs through the ladder for its strict per-lane mask."""
        pending = []
        for lo in range(0, len(items), cap):
            chunk = items[lo : lo + cap]
            arrays, prevalid, n = self.host.pack(chunk)
            if not prevalid.any():
                pending.append((None, None, prevalid, n))
                continue
            binder = rlc_binder(chunk, self.generation)
            m_nib, z_nib, c_nib = rlc_scalars(arrays[5], arrays[6], prevalid, binder)
            self.last_transcript = hashlib.sha256(binder).digest()
            tensors = self._to_device(arrays)
            ok = rlc_check(*tensors[:5], *self._to_device((m_nib, z_nib, c_nib)))
            self.rlc_calls += 1
            pending.append((ok, tensors, prevalid, n))
        out = []
        for ok, tensors, prevalid, n in pending:
            if ok is None:
                out.append(prevalid[:n].copy())  # all lanes malformed
            elif bool(ok):
                out.append(prevalid[:n].copy())
            else:
                self.rlc_fallbacks += 1
                mask = self._kernel(*tensors).cpu().numpy()
                out.append((mask & prevalid)[:n])
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _verify_chunk_deduped(self, chunk, scan):
        """Duplicate-heavy chunk: pack each distinct triple once, ship the
        unique rows plus an expansion index, gather on the device and run
        the full ladder on every lane. Returns a ``pending`` entry."""
        uniq, inv = scan
        arrays_u, prevalid_u, nu = self.host.pack(uniq)
        prevalid = np.zeros(self.host.bucket_for(len(chunk)), dtype=bool)
        prevalid[: len(chunk)] = prevalid_u[inv]
        if not prevalid.any():
            # Every lane malformed: rejection is already decided here.
            return (None, prevalid, len(chunk))
        inv_p = np.zeros(prevalid.shape[0], dtype=np.int64)
        inv_p[: len(chunk)] = inv
        idx = torch.from_numpy(inv_p).to(self.device)
        rows = [t[idx] for t in self._to_device(arrays_u)]
        return (self._kernel(*rows), prevalid, len(chunk))

    def verify_batch(self, window):
        """Verifier-protocol entry: messages with detached signatures.
        Signatures pass through unchanged — a wrong-length signature is
        rejected by the packer, never replaced by zeros — and unsigned
        messages fail (parity with HostVerifier)."""
        items = [(msg.sender, msg.digest(), msg.signature) for msg in window]
        unsigned = np.array([not msg.signature for msg in window], dtype=bool)
        ok = self.verify_signatures(items)
        return list(ok & ~unsigned)
