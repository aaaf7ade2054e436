"""Pippenger multi-scalar multiplication (PyTorch ops).

Computes Q = sum_i [s_i]P_i for a whole batch of points: the reduction
engine behind the RLC batch equation
(:func:`hyperdrive_tpu_torch.ops.ed25519.rlc_check`), and the engine the
BLS12-381 aggregate path will reuse through :class:`CurveOps`.

Port of the JAX package's ``ops/msm.py``: the same geometry
(:func:`plan_groups`, :func:`msm_plan`, :func:`windows_for_bits`, the
64/33 ed25519 window counts), the same :class:`CurveOps` seam and the same
sum, in the curve's own field arithmetic. The reference's program
is jnp, not a Pallas kernel, so this is PyTorch ops, run eagerly. Its loop
nest (W windows x g serial lane steps of one-hot contractions) would cost
hundreds of thousands of small launches a call here, so the engine is
reshaped, with the same arithmetic:

1. **Bucket accumulation, every window at once.** Lanes fold into G
   independent groups of g lanes; each (window, group) owns 8 buckets
   (|digit| = 1..8) plus a trash slot 0 for a zero digit or a padding
   lane. The g lane steps stay serial, but each step is one
   ``[W, G]``-wide mixed addition for all windows of all the MSMs of the
   call (:func:`msm_window_sums` takes several point sets: the RLC's A
   and R sums share one accumulation), reading the target bucket with
   ``gather`` and writing it back with ``scatter_``, where the reference
   contracts a one-hot.
2. **Group combine**: a halving tree over the group axis, batched over W.
3. **Bucket reduce**: the suffix-sum identity
   sum_v v*S_v = sum_v (S_8 + ... + S_v), batched over W.
4. **Window join** (:func:`horner`): the W window sums fold high to low
   by Horner, 4 doublings and one addition a window.

The ed25519 glue (the reference's ``_ed25519_ops``, ``_niels_affine`` and
``msm_kernel``) lives beside ``rlc_check`` in
:mod:`hyperdrive_tpu_torch.ops.ed25519`, so this engine imports no curve.
Dropped: the observability notes on the plan (``verify.msm.*`` events);
:func:`msm_plan`, which fed them, is kept for parity with the reference
and has no caller in the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = [
    "msm_engine",
    "msm_window_sums",
    "horner",
    "plan_groups",
    "msm_plan",
    "windows_for_bits",
    "CurveOps",
    "WINDOW_BITS",
    "ED25519_FULL_WINDOWS",
    "ED25519_HALF_WINDOWS",
]

#: Signed window width in bits; digits live in [-8, 8].
WINDOW_BITS = 4

#: Signed 4-bit windows: |digit| <= 8, bucket values 1..8 plus the
#: write-only trash slot at index 0 (digit 0 / padding lanes land there).
N_BUCKETS = 1 << (WINDOW_BITS - 1)


def windows_for_bits(bits: int, window_bits: int = WINDOW_BITS) -> int:
    """Window count covering a ``bits``-wide scalar with signed digits.

    Signed recoding needs the top digit's carry headroom, so callers
    quote the scalar bound's bit width (e.g. 253 for clamped ed25519
    scalars, 255 for the BLS12-381 group order, 129 for half-width RLC
    coefficients including their carry bit)."""
    return -(-bits // window_bits)


#: The ed25519 RLC geometry: full-width scalars are < 2^253 (recode
#: precondition), half-width Fiat-Shamir coefficients are < 2^128 plus
#: one carry bit.
ED25519_FULL_WINDOWS = windows_for_bits(253)  # 64
ED25519_HALF_WINDOWS = windows_for_bits(129)  # 33


def plan_groups(n: int) -> tuple[int, int]:
    """(G, g): group count and per-group serial depth for an n-lane MSM.

    G is a power of two so the combine tree halves cleanly; g ~ 64 keeps
    the per-window combine overhead (~72/g muls per lane) near 1 mul
    while G stays wide enough to fill the vector units. Small batches
    floor at G = 8 — narrower groups would serialize the whole program.
    """
    g_target = max(1, n // 64)
    G = 8
    while G * 2 <= min(1024, g_target):
        G *= 2
    if n < 8:
        G = 1
    g = -(-n // G)  # ceil
    return G, g


def msm_plan(n: int, windows: int, curve: str = "ed25519") -> dict:
    """Static launch geometry: window count, bucket occupancy denominator,
    and the reduction depth (combine-tree levels + bucket suffix chain)."""
    G, g = plan_groups(n)
    depth = (G - 1).bit_length() + (N_BUCKETS - 1)
    padded = G * g
    return {
        "curve": curve,
        "windows": windows,
        "groups": G,
        "group_size": g,
        "buckets": N_BUCKETS,
        "reduction_depth": depth,
        # Lanes the [G, g] fold actually walks vs the n requested.
        "padded_lanes": padded,
        "lane_occupancy_pct": int(round(100 * n / max(padded, 1))),
    }


# ------------------------------------------------------------- curve bundle


@dataclass(frozen=True)
class CurveOps:
    """The arithmetic a curve plugs into the Pippenger engine.

    Accumulators and entries are tuples of ``[..., n_limbs]`` int32
    tensors of one shape; the engine never inspects their arity, so mixed
    representations (ed25519: niels entries into extended accumulators)
    cost nothing.

    Attributes:
      n_limbs:         limbs per field element (20 for fe25519)
      bucket_identity: (batch shape, like tensor) -> identity buckets,
                       each component ``[*shape, N_BUCKETS + 1, L]``
      entry_select:    (sign mask, entry) -> entry or its negation
      add_entry:       (acc, entry) -> acc   (mixed add)
      add:             (acc, acc) -> acc     (full add)
      window_shift:    acc -> acc  (WINDOW_BITS doublings)

    The reference's ``bucket_identity`` takes a group count; this one
    takes the whole batch shape and a tensor whose device it uses. The
    reference's ``acc_identity`` has no field here: the Horner join starts
    from the top window's sum, not from the identity.
    """

    n_limbs: int
    bucket_identity: Callable
    entry_select: Callable
    add_entry: Callable
    add: Callable
    window_shift: Callable


# ------------------------------------------------------------------ engine


def _accumulate(entries, digits, set_of_row, G: int, g: int, ops: CurveOps):
    """Bucket accumulation of every window row at once: fold g lanes into
    each (row, group)'s 9-slot bucket array (slot 0 = trash).

    ``entries``: ``[E, S, G, g, L]`` (E entry components of S point
    sets); ``digits``: ``[R, G, g]`` signed, one row a window of some
    set; ``set_of_row``: ``[R]`` the set each row reads. Returns buckets
    ``[C, R, G, 9, L]`` (C accumulator components)."""
    R = digits.shape[0]
    L = ops.n_limbs
    buckets = torch.stack(ops.bucket_identity((R, G), digits))
    C = buckets.shape[0]
    single = entries.shape[1] == 1
    for j in range(g):
        d = digits[:, :, j]  # [R, G]
        idx = d.abs().long()[None, :, :, None, None].expand(C, R, G, 1, L)
        cur = buckets.gather(3, idx).squeeze(3)  # [C, R, G, L]
        ent = entries[:, :, :, j]  # [E, S, G, L]
        ent = ent.expand(-1, R, -1, -1) if single else ent[:, set_of_row]
        new = ops.add_entry(
            tuple(cur.unbind(0)), ops.entry_select(d < 0, tuple(ent.unbind(0)))
        )
        buckets.scatter_(3, idx, torch.stack(new)[:, :, :, None, :])
    return buckets


def _combine_groups(buckets, ops: CurveOps):
    """Halving tree over the group axis: ``[C, R, G, 9, L]`` ->
    ``[C, R, 8, L]`` (the trash slot is dropped before the first level)."""
    comps = tuple(c[:, :, 1:] for c in buckets.unbind(0))  # [R, G, 8, L]
    m = comps[0].shape[1]
    while m > 1:
        h = m // 2
        comps = ops.add(
            tuple(c[:, :h] for c in comps), tuple(c[:, h:m] for c in comps)
        )
        m = h
    return tuple(c[:, 0] for c in comps)


def _bucket_reduce(buckets8, ops: CurveOps):
    """sum_v v*S_v via suffix sums, batched over rows: runtot = S_8 + ... +
    S_v accumulates into the window sum with 2*(buckets-1) additions.
    ``buckets8``: components ``[R, 8, L]`` -> window sums ``[R, L]``."""

    def slot(v):
        return tuple(c[:, v - 1] for c in buckets8)

    runtot = slot(N_BUCKETS)
    wsum = runtot
    for v in range(N_BUCKETS - 1, 0, -1):
        runtot = ops.add(runtot, slot(v))
        wsum = ops.add(wsum, runtot)
    return wsum


def msm_window_sums(sets, ops: CurveOps):
    """Per-window sums of one or more MSMs over the same lane count.

    ``sets``: ``(entries, digits)`` pairs: ``entries`` a tuple of ``[N,
    L]`` int32 entry components (the same N and arity in every set),
    ``digits`` ``[W_s, N]`` signed window digits, window 0 least
    significant. Returns, per set, the window sums
    sum_i [digit_{w,i}] P_i as accumulator components ``[W_s, L]``:
    the MSM of the set is their Horner join (:func:`horner`).

    Padding lanes are free: a zero digit routes its (arbitrary) point to
    the trash bucket, so callers pad with anything shape-compatible."""
    n = sets[0][0][0].shape[0]
    G, g = plan_groups(n)
    pad = G * g - n
    ents, digs, rows = [], [], []
    for s, (entries, digits) in enumerate(sets):
        ent = torch.stack(entries)  # [E, N, L]
        if pad:
            ent = torch.nn.functional.pad(ent, (0, 0, 0, pad))
            digits = torch.nn.functional.pad(digits, (0, pad))
        ents.append(ent.reshape(ent.shape[0], G, g, ops.n_limbs))
        digs.append(digits.reshape(-1, G, g))
        rows.append(torch.full((digits.shape[0],), s, dtype=torch.long))
    entries = torch.stack(ents, dim=1)  # [E, S, G, g, L]
    digits = torch.cat(digs)  # [R, G, g]
    set_of_row = torch.cat(rows).to(digits.device)
    buckets = _accumulate(entries, digits, set_of_row, G, g, ops)
    wsums = _bucket_reduce(_combine_groups(buckets, ops), ops)  # [R, L]
    out, lo = [], 0
    for _, d in sets:
        w = d.shape[0]
        out.append(tuple(c[lo : lo + w] for c in wsums))
        lo += w
    return out


def horner(wsums, ops: CurveOps):
    """Join window sums (components ``[W, L]``, window 0 least
    significant) into sum_w 16^w T_w: start from the top window, then
    per window below it WINDOW_BITS doublings and one addition. Returns
    accumulator components ``[1, L]``."""
    w = wsums[0].shape[0]
    acc = tuple(c[w - 1 : w] for c in wsums)
    for i in range(w - 2, -1, -1):
        acc = ops.add(ops.window_shift(acc), tuple(c[i : i + 1] for c in wsums))
    return acc


def msm_engine(entries, digits, ops: CurveOps):
    """sum_i [s_i]P_i for any curve: ``entries`` a tuple of ``[N, L]``
    components, ``digits`` ``[W, N]`` signed window digits in [-8, 8]
    (window 0 least significant). Returns the sum in the curve's
    accumulator representation, batch 1."""
    return horner(msm_window_sums([(entries, digits)], ops)[0], ops)
