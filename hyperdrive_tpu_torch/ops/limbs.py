"""Shared limb-arithmetic core for big-field arithmetic on int32 tensors.

A field element is a vector of **13-bit limbs in int32**, value =
sum(l_i * 2^(13 i)), on tensors shaped ``[..., n_limbs]``. A limb product
fits in 26 bits, so a column accumulating ~30 products stays inside
int32.

Port of the JAX package's ``ops/limbs.py``, limb for limb: what the
BLS12-381 base field (:mod:`.fp381`) needs.

- limb packing/unpacking between Python ints and int32 arrays, for any
  limb count (:func:`to_limbs`, :func:`from_limbs`, vectorized
  :func:`to_limbs_flat`; host side, numpy);
- the sequential scan carry (:func:`carry_scan`) and the vectorized
  carry passes (:func:`carry_pass`, :func:`carry_pass_keep_top`), all
  signed-safe: torch's ``>>`` on int32 is arithmetic (floor division)
  and ``&`` gives the non-negative residue, as in XLA;
- a Montgomery-CIOS multiplier (:class:`Montgomery`,
  :func:`make_montgomery`) for moduli with no pseudo-Mersenne structure.

The reference's ``lax.scan`` and ``lax.fori_loop`` are Python loops here;
int32 products wrap silently as XLA's do, and the bound walk in
:class:`Montgomery` is what keeps every column under 2^31. Not ported:
``fold_carry_out`` and ``make_sub_bias``, which serve the ed25519 field
only (the port's ``ops/fe25519.py`` keeps its own copies).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "LIMB_BITS",
    "LIMB_MASK",
    "to_limbs",
    "from_limbs",
    "to_limbs_flat",
    "carry_scan",
    "carry_pass",
    "carry_pass_keep_top",
    "Montgomery",
    "make_montgomery",
    "const",
]

#: Limb radix shared by every device field: 13 bits in an int32 lane.
LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1


# ----------------------------------------------------------------- packing


def to_limbs_flat(vals, n_limbs: int) -> np.ndarray:
    """[n] Python ints -> [n, n_limbs] int32 limbs, vectorized through a
    byte buffer + unpackbits. Values must lie in [0, 2^(13 * n_limbs))."""
    n = len(vals)
    total_bits = n_limbs * LIMB_BITS
    nbytes = (total_bits + 7) // 8
    try:
        buf = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    except OverflowError:
        raise ValueError("value out of limb range") from None
    u = np.frombuffer(buf, dtype=np.uint8).reshape(n, nbytes)
    spare = 8 * nbytes - total_bits
    if spare and (u[:, -1] >> (8 - spare)).any():
        raise ValueError("value out of limb range")
    bits = np.unpackbits(u, axis=1, bitorder="little")[:, :total_bits]
    weights = (1 << np.arange(LIMB_BITS, dtype=np.int32)).astype(np.int32)
    return (
        bits.reshape(n, n_limbs, LIMB_BITS).astype(np.int32) * weights
    ).sum(axis=2, dtype=np.int32)


def to_limbs(x, n_limbs: int) -> np.ndarray:
    """Python int(s) -> int32 limb array. Accepts a single int (-> shape
    [n_limbs]) or any nested sequence of ints (-> shape [..., n_limbs]).
    Values must lie in [0, 2^(13 * n_limbs))."""
    if isinstance(x, int):
        if not 0 <= x < 1 << (LIMB_BITS * n_limbs):
            raise ValueError("value out of limb range")
        return np.array(
            [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)],
            dtype=np.int32,
        )
    x = list(x)
    if x and isinstance(x[0], int):
        if any(v < 0 for v in x):
            raise ValueError("value out of limb range")
        return to_limbs_flat(x, n_limbs)
    return np.stack([to_limbs(v, n_limbs) for v in x])


def from_limbs(limbs) -> "int | list":
    """Inverse of :func:`to_limbs` (host side; accepts tensors, which are
    copied to the host). Signed-safe: negative limbs contribute
    negatively, so redundant signed representations round-trip to their
    exact integer value."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    a = np.asarray(limbs)
    if a.ndim == 1:
        return sum(int(a[i]) << (LIMB_BITS * i) for i in range(a.shape[0]))
    return [from_limbs(row) for row in a]


_CONSTS: dict = {}


def const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A module constant as an int32 tensor on ``like``'s device, copied
    there once (a copy per call would stall the card's queue)."""
    key = (id(arr), like.device)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = (
            arr, torch.as_tensor(arr, dtype=torch.int32, device=like.device)
        )
    return hit[1]


# ----------------------------------------------------------------- carries


def carry_scan(x: torch.Tensor):
    """One full sequential carry pass: limbs -> [0, 2^13), returning
    ``(limbs, carry_out_of_top)``. Works for signed inputs (arithmetic
    shift = floor division), so it also serves as the borrow-propagating
    comparison primitive (carry < 0 iff the value is negative)."""
    cols = []
    carry = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        c = x[..., i] + carry
        cols.append(c & LIMB_MASK)
        carry = c >> LIMB_BITS
    return torch.stack(cols, dim=-1), carry


def carry_pass(x: torch.Tensor):
    """One vectorized carry pass: every limb's carry moved up one position
    in a single shift. Returns ``(limbs, carry_out_of_top)``."""
    c = x >> LIMB_BITS
    shifted = torch.nn.functional.pad(c[..., :-1], (1, 0))
    return (x & LIMB_MASK) + shifted, c[..., -1]


def carry_pass_keep_top(x: torch.Tensor) -> torch.Tensor:
    """Vectorized carry pass for fields with *no* carry-out fold
    (Montgomery representation): limbs below the top are masked to
    [0, 2^13) with carries shifted up one position; the top limb stays
    unmasked and absorbs the final carry."""
    low = x[..., :-1]
    c = low >> LIMB_BITS
    out = torch.cat([low & LIMB_MASK, x[..., -1:]], dim=-1)
    out[..., 1:] += c
    return out


# -------------------------------------------------------------- Montgomery


class Montgomery:
    """Montgomery-CIOS multiplication over 13-bit int32 limbs for a
    modulus with no pseudo-Mersenne structure.

    R = 2^(13 n). Values live in the Montgomery domain (x̄ = x*R mod p);
    :meth:`mul` computes ā*b̄/R = (a*b)*R — the domain is closed under
    products. Conversion in/out happens host-side via :meth:`encode` /
    :meth:`decode`.

    The CIOS loop interleaves reduction into the product: per outer step
    i it accumulates a_i * b and m_i * p into a running (n+1)-limb
    accumulator t, where m_i = (t_0 * n0') mod 2^13 zeroes t's low limb
    (n0' = -p^{-1} mod 2^13), then divides by 2^13 via a one-limb shift.
    One vectorized carry pass per step keeps every column inside int32:

    - operand limbs (signed) have magnitude <= ~2^13.01 after a pass, so
      the per-column step adds |a_i*b_j| + m*p_j <= 2*8193^2 ~= 1.35e8;
    - the accumulator limb steady state is |t_j| <= 8192 + 1.35e8/2^13
      ~= 2.5e4, keeping columns < 1.4e8 << 2^31.

    Signed operands are handled for free (arithmetic shifts are floor
    divisions; m is computed from the masked low limb, a correct residue
    for negative t_0 too), so the field layer above needs no subtraction
    bias.
    """

    def __init__(self, p_int: int, n_limbs: int):
        base = 1 << LIMB_BITS
        if p_int % 2 == 0:
            raise ValueError("Montgomery requires an odd modulus")
        if p_int >= 1 << (LIMB_BITS * n_limbs):
            raise ValueError("modulus exceeds limb capacity")
        self.p_int = p_int
        self.n_limbs = n_limbs
        self.r_int = 1 << (LIMB_BITS * n_limbs)
        self.r_mod_p = self.r_int % p_int
        self.r_inv = pow(self.r_int, -1, p_int)
        self.n0p = (-pow(p_int, -1, base)) % base
        self.p_limbs = to_limbs(p_int, n_limbs)

    # -- host-side domain conversion

    def encode(self, x: int) -> int:
        """Standard -> Montgomery domain (host int)."""
        return (x % self.p_int) * self.r_mod_p % self.p_int

    def decode(self, x: int) -> int:
        """Montgomery -> standard domain (host int). Accepts the signed
        redundant values :func:`from_limbs` produces."""
        return x * self.r_inv % self.p_int

    # -- device program

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """CIOS product ā*b̄/R on [..., n_limbs] int32 tensors (batch
        shapes broadcast). Operand contract: |value| < 2^(13 n - 2) with
        limb magnitudes <= ~2^13.2 (what :func:`carry_pass` outputs).
        Output value is bounded by |a*b|/R + p with limbs <= ~2^13.01
        after the two closing passes.

        Each step is the reference's: the low n accumulator limbs take
        a_i * b, then m * p; the shift moves the top slot down into limb
        n - 1 and adds limb 0's exact carry to the new limb 0; one pass
        leaves its last carry in the top slot. (Sums are regrouped, which
        int32 addition, wrapping or not, leaves bit for bit the same.)"""
        n = self.n_limbs
        a, b = torch.broadcast_tensors(a, b)
        p = const(self.p_limbs, a)
        lo = torch.zeros_like(a)
        top = torch.zeros_like(a[..., 0])
        for i in range(n):
            s = torch.addcmul(lo, a[..., i : i + 1], b)
            m = ((s[..., 0] & LIMB_MASK) * self.n0p) & LIMB_MASK
            s += m[..., None] * p
            # s_0 is now a multiple of 2^13: shift one limb down, exact.
            sh = torch.cat([s[..., 1:], top[..., None]], dim=-1)
            sh[..., 0] += s[..., 0] >> LIMB_BITS
            c = sh >> LIMB_BITS
            lo = sh & LIMB_MASK
            lo[..., 1:] += c[..., :-1]
            top = c[..., -1]
        # The top slot is exactly zero once limbs settle; the closing
        # passes leave the top limb unmasked (no fold exists).
        return carry_pass_keep_top(carry_pass_keep_top(lo))


def make_montgomery(p_int: int, n_limbs: int) -> Montgomery:
    """Build the Montgomery context for (modulus, limb count)."""
    return Montgomery(p_int, n_limbs)
