"""BLS12-381 G1 point arithmetic and aggregation (PyTorch ops + one kernel).

The device side of the BLS aggregate path: complete projective point
arithmetic over :mod:`.fp381` limb tensors, plugged into the
curve-free Pippenger engine of :mod:`.msm`, plus the committee-bitmask
aggregation the quorum-certificate path launches.

Representation: a point batch is three ``[..., 30]`` int32
Montgomery-domain limb tensors (X, Y, Z) — **complete projective**
coordinates with the Renes–Costello–Batina a = 0 formulas (b3 = 3*4 =
12). Identity, doubling and generic addition take the same branch-free
sequence, so identity-padded lanes, bitmask-deselected committee slots
and bucket trash need no special cases. The identity is (0 : 1 : 0)
(Montgomery-encoded 1).

Port of the JAX package's ``ops/g1.py``, limb for limb in :func:`padd`,
:func:`pdbl` and :func:`aggregate_kernel`:

- :func:`aggregate_kernel` — sigma = sum_{i in mask} P_i, written with
  the batch axis out (``[B, N, 30]``, or ``[N, 30]`` unbatched): the
  reference's ``aggregate_kernel`` and its ``vmap`` in
  ``make_batched_aggregate_fn`` in one function. It is the plain version
  of the hand-written ``g1_aggregate`` kernel (``csrc/g1_aggregate.cu``,
  :mod:`.g1_cuda`), and :func:`g1_aggregate` is the launch: a CUDA tensor
  runs the kernel or raises, a CPU tensor runs this function.
  :func:`aggregate_points` and :class:`G1SumLauncher` go through it.
- :func:`g1_msm_kernel` — general scalar MSM over the shared engine
  (:func:`.msm.msm_engine` with :data:`G1_OPS`), PyTorch ops; its
  window sums are reshaped as the port's engine reshapes them, so its
  limbs differ from the reference's, its group element does not.

The reference's jit factories (``make_aggregate_fn``,
``make_batched_aggregate_fn``) have no counterpart: PyTorch runs
eagerly. :class:`G1SumLauncher` submits to the port's
:class:`~hyperdrive_tpu_torch.devsched.queue.DeviceWorkQueue`, whose
``submit`` takes no ``generation=``.

Host-side pack/unpack helpers convert between the affine Python-int
points of :mod:`hyperdrive_tpu_torch.crypto.bls` and the device layout.
Value-bound note: the formulas chain at most three adds or one
mul_small(12) between Montgomery multiplies, so every mul operand stays
below 2^388.2 against the CIOS accumulator's 2^403 capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdrive_tpu_torch.ops import fp381 as fp
from hyperdrive_tpu_torch.ops import g1_cuda
from hyperdrive_tpu_torch.ops import limbs as _limbs
from hyperdrive_tpu_torch.ops import msm

__all__ = [
    "padd",
    "pdbl",
    "identity_rows",
    "G1_OPS",
    "g1_msm_kernel",
    "aggregate_kernel",
    "g1_aggregate",
    "aggregate_points",
    "G1SumLauncher",
    "G1_WINDOWS",
    "recode_scalars",
    "pack_points",
    "unpack_points",
    "from_reference",
]

#: b3 = 3 * b for y^2 = x^3 + 4.
B3 = 12

#: Signed 4-bit windows covering the 255-bit BLS12-381 scalar field
#: (one extra bit of headroom for the recode carry).
G1_WINDOWS = msm.windows_for_bits(256)  # 64


# ----------------------------------------------------------- point formulas


def padd(p, q):
    """Complete projective addition (Renes–Costello–Batina, a = 0).
    Branch-free: correct for identity, equal and opposite inputs alike."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = fp.mul(x1, x2)
    t1 = fp.mul(y1, y2)
    t2 = fp.mul(z1, z2)
    t3 = fp.mul(fp.add(x1, y1), fp.add(x2, y2))
    t3 = fp.sub(t3, fp.add(t0, t1))
    t4 = fp.mul(fp.add(y1, z1), fp.add(y2, z2))
    t4 = fp.sub(t4, fp.add(t1, t2))
    x3 = fp.mul(fp.add(x1, z1), fp.add(x2, z2))
    y3 = fp.sub(x3, fp.add(t0, t2))
    t0 = fp.add(fp.add(t0, t0), t0)  # 3*X1X2
    t2 = fp.mul_small(t2, B3)
    z3 = fp.add(t1, t2)
    t1 = fp.sub(t1, t2)
    y3 = fp.mul_small(y3, B3)
    x3 = fp.sub(fp.mul(t3, t1), fp.mul(t4, y3))
    y3 = fp.add(fp.mul(t1, z3), fp.mul(y3, t0))
    z3 = fp.add(fp.mul(z3, t4), fp.mul(t0, t3))
    return (x3, y3, z3)


def pdbl(p):
    """Complete projective doubling (a = 0)."""
    x, y, z = p
    t0 = fp.mul(y, y)
    z3 = fp.add(fp.add(fp.add(t0, t0), fp.add(t0, t0)),
                fp.add(fp.add(t0, t0), fp.add(t0, t0)))  # 8*Y^2
    t1 = fp.mul(y, z)
    t2 = fp.mul_small(fp.mul(z, z), B3)
    x3 = fp.mul(t2, z3)
    y3 = fp.add(t0, t2)
    z3 = fp.mul(t1, z3)
    t1 = fp.add(t2, t2)
    t2 = fp.add(t1, t2)
    t0 = fp.sub(t0, t2)
    y3 = fp.add(x3, fp.mul(t0, y3))
    x3 = fp.mul_small(fp.mul(t0, fp.mul(x, y)), 2)
    return (x3, y3, z3)


def identity_rows(shape, like: torch.Tensor):
    """Identity points (0 : 1 : 0), Montgomery domain: each component
    ``[*shape, 30]`` on ``like``'s device (the reference takes a row
    count)."""
    one = _limbs.const(fp.ONE, like).expand(*shape, fp.N_LIMBS)
    zero = torch.zeros_like(one)
    return (zero, one, zero)


# -------------------------------------------------------------- curve bundle


def _entry_select(sign, entry):
    x, y, z = entry
    return (x, fp.select(sign, fp.neg(y), y), z)


def _window_shift(acc):
    for _ in range(msm.WINDOW_BITS):
        acc = pdbl(acc)
    return acc


#: G1 on the Pippenger engine: projective entries into projective buckets.
G1_OPS = msm.CurveOps(
    n_limbs=fp.N_LIMBS,
    bucket_identity=lambda shape, like: identity_rows((*shape, msm.N_BUCKETS + 1), like),
    entry_select=_entry_select,
    add_entry=padd,
    add=padd,
    window_shift=_window_shift,
)


def g1_msm_kernel(px, py, pz, digits):
    """sum_i [s_i]P_i over projective G1 points via the shared Pippenger
    engine. ``digits``: [W, N] signed 4-bit windows (see
    :func:`recode_scalars`). Returns a projective point, [1, 30] x3.

    Padding lanes are free (zero digits land in the trash bucket), and
    identity *points* are also free — complete formulas again."""
    return msm.msm_engine((px, py, pz), digits, G1_OPS)


# ------------------------------------------------------------- aggregation


def aggregate_kernel(px, py, pz, mask):
    """Committee-bitmask aggregation: sum of P_i where mask_i != 0, the
    plain version of the ``g1_aggregate`` kernel.

    Args (int32, one device): px, py, pz ``[..., N, 30]`` projective
    Montgomery coords; mask ``[..., N]`` (0/1). N need not be a power of
    two: an odd level folds its last lane into the last merged lane with
    one extra add. Returns ``[..., 1, 30]`` x3.

    Deselected lanes become the identity (free under complete addition),
    then a halving tree of batched adds reduces log2(N) levels: lane i
    of a level of n lanes is lane i plus lane i + n // 2 of the level
    above."""
    m = mask != 0
    ident = identity_rows(px.shape[:-1], px)
    pt = tuple(fp.select(m, c, e) for c, e in zip((px, py, pz), ident))
    n = px.shape[-2]
    while n > 1:
        h = n // 2
        merged = padd(tuple(c[..., :h, :] for c in pt),
                      tuple(c[..., h : 2 * h, :] for c in pt))
        if n % 2:
            last = padd(tuple(c[..., h - 1 : h, :] for c in merged),
                        tuple(c[..., n - 1 : n, :] for c in pt))
            merged = tuple(torch.cat([c[..., : h - 1, :], d], dim=-2)
                           for c, d in zip(merged, last))
        pt = merged
        n = h
    return pt


def g1_aggregate(px, py, pz, mask):
    """The masked G1 sum of each committee of a batch: px, py, pz int32
    ``[B, N, 30]`` (Montgomery limbs, any signed redundant form within the
    fp381 invariant), mask int32 ``[B, N]``, N >= 1 -> ``[B, 1, 30]`` x3.

    A CUDA tensor launches the ``g1_aggregate`` kernel (one block a
    committee) on the current stream without synchronizing, limb for limb
    :func:`aggregate_kernel`, which CPU tensors run. No fallback from one
    to the other."""
    device = g1_cuda.check_aggregate(px, py, pz, mask)
    if device.type == "cpu":
        return aggregate_kernel(px, py, pz, mask)
    return g1_cuda.aggregate(px, py, pz, mask)


def aggregate_points(points, width: "int | None" = None, device=None):
    """Host convenience around :func:`g1_aggregate`: aggregate a list of
    affine host points (``(x, y)`` tuples / None) on ``device`` (None:
    the card) and return the affine sum (or None).

    ``width`` pads the launch to a fixed lane count (identity rows) so
    callers with a varying live set — a certifier seeing different
    quorum sizes per commit — launch one shape per committee width."""
    n = len(points)
    if width is None:
        width = max(n, 1)
    if n > width:
        raise ValueError(f"{n} points exceed launch width {width}")
    mask = np.zeros((1, width), dtype=np.int32)
    mask[0, :n] = 1
    coords = pack_points(list(points) + [None] * (width - n))
    px, py, pz, m = from_reference(
        tuple(c[None] for c in coords) + (mask,), device
    )
    rx, ry, rz = g1_aggregate(px, py, pz, m)
    return unpack_points(rx[0], ry[0], rz[0])[0]


class G1SumLauncher:
    """DeviceWorkQueue launcher for masked G1 sums (bitmask-weighted point
    sums; the overlay's per-level merges in the JAX package).

    A payload is a list of affine host points; the drain stacks every
    pending payload into ONE batched ``g1_aggregate`` launch at a fixed
    lane width on ``device`` (None: the card). Results come back as affine
    host points (None = identity). Submitted without a generation (the
    port's queue has none)."""

    kind = "bls.g1sum"

    def __init__(self, width: int, device=None):
        self.width = int(width)
        self.device = device
        #: Lifetime lane accounting.
        self.launched = 0
        self.rows = 0

    def launch(self, payloads: list) -> list:
        width = self.width
        masks = np.zeros((len(payloads), width), dtype=np.int32)
        stacks = []
        for b, pts in enumerate(payloads):
            pts = list(pts)
            if len(pts) > width:
                raise ValueError(
                    f"{len(pts)} points exceed launch width {width}"
                )
            masks[b, : len(pts)] = 1
            stacks.append(pack_points(pts + [None] * (width - len(pts))))
        coords = tuple(np.stack([s[c] for s in stacks]) for c in range(3))
        px, py, pz, m = from_reference(coords + (masks,), self.device)
        rx, ry, rz = g1_aggregate(px, py, pz, m)
        self.launched += 1
        self.rows += len(payloads)
        return unpack_points(rx[:, 0], ry[:, 0], rz[:, 0])


# ------------------------------------------------------------- host packing


def recode_scalars(vals) -> np.ndarray:
    """Python ints (< 2^255) -> [64, N] signed window digits in [-8, 8],
    window 0 least significant (host side: BLS scalars originate on the
    host)."""
    vals = [int(v) for v in vals]
    if any(v < 0 or v >= 1 << 255 for v in vals):
        raise ValueError("scalar out of range")
    nib = np.array(
        [[(v >> (4 * i)) & 0xF for i in range(G1_WINDOWS)] for v in vals],
        dtype=np.int32,
    )  # [N, W]
    digits = np.zeros((G1_WINDOWS, len(vals)), dtype=np.int32)
    carry = np.zeros(len(vals), dtype=np.int32)
    for i in range(G1_WINDOWS):
        d = nib[:, i] + carry
        carry = (d > 8).astype(np.int32)
        digits[i] = d - 16 * carry
    if carry.any():
        raise ValueError("scalar recode overflow")
    return digits


def pack_points(points) -> tuple:
    """Affine host points (list of (x, y) int tuples or None) -> projective
    Montgomery limb arrays (numpy, [N, 30] x3). None packs as the
    identity."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return (
        np.asarray(fp.to_mont(xs)),
        np.asarray(fp.to_mont(ys)),
        np.asarray(fp.to_mont(zs)),
    )


def unpack_points(px, py, pz):
    """Projective points (tensors, copied to the host, or arrays) ->
    affine host points ((x, y) or None). Accepts [N, 30] x3 (returns a
    list) or [30] x3 (returns one)."""
    X = fp.from_mont(px)
    Y = fp.from_mont(py)
    Z = fp.from_mont(pz)
    single = not isinstance(X, list)
    if single:
        X, Y, Z = [X], [Y], [Z]
    out = []
    p = fp.P_INT
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, p)
        out.append((x * zi % p, y * zi % p))
    return out[0] if single else out


def from_reference(arrays, device=None) -> tuple:
    """The JAX package's numpy int32 arrays (packed coordinates, masks,
    digits) as tensors on ``device`` (None: the card)."""
    return tuple(fp.from_reference(a, device) for a in arrays)
