"""GF(2^255 - 19) arithmetic on int32 limb tensors (PyTorch).

Limb for limb the arithmetic of the JAX package's ``ops/fe25519.py``: a
field element is **20 limbs of 13 bits** in int32, value =
sum(l_i * 2^(13 i)), on tensors shaped ``[..., 20]`` (any batch prefix).

- A limb product is < 2^26 and a schoolbook column sums at most 20 of
  them. Public results keep their limbs in [0, ``SLACK_MAX`` = 9,400], so
  the worst column is 20 * SLACK_MAX^2 = 1.767e9 < 2^31: int32 never
  overflows. This argument holds only for the 20 x 13 layout with the same
  subtraction bias ``_SUB_BIAS``, which is why both are kept as they are.
- 2^260 = 608 (mod p), so columns 20..39 of a product fold back into
  columns 0..19 with one multiply by 608; bits 255..259 fold with 19
  (2^255 = 19 mod p), keeping every public result under value < 2^256.

torch's int32 multiply wraps just as XLA's does; right shift on int32 is
arithmetic, so ``c >> 13`` is a floor division and ``c & 0x1FFF`` the
non-negative residue. This is the field of the CUDA kernels' plain
versions; the kernels themselves run on 8 x 32-bit limbs
(``csrc/fe25519_w32.cuh``), convert these 13-bit limb rows by value, and
take their constants from the same integers. ``inv`` is not ported: the
wire path decompresses through :func:`pow22523`, and the validator table
decompresses on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "N_LIMBS",
    "LIMB_BITS",
    "LIMB_MASK",
    "P_INT",
    "SLACK_MAX",
    "to_limbs",
    "from_limbs",
    "add",
    "sub",
    "neg",
    "mul",
    "sqr",
    "mul_small",
    "pow22523",
    "canonical",
    "eq",
    "is_zero",
    "select",
    "ZERO",
    "ONE",
]

N_LIMBS = 20
LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1

P_INT = 2**255 - 19
#: 2^260 mod p — the fold factor for columns >= 20.
FOLD_260 = 608
#: 2^255 mod p — the fold factor for bits >= 255 inside limb 19.
FOLD_255 = 19
#: Bit position of 2^255 inside limb 19 (19 * 13 = 247; 255 - 247 = 8).
TOP_SHIFT = 8
TOP_MASK = (1 << TOP_SHIFT) - 1

#: Invariant slack: public results have limbs in [0, SLACK_MAX] (see the
#: bound walk of the JAX package's ``fe25519._reduce_cols``).
SLACK_MAX = 9_400


# ----------------------------------------------------------------- packing


def to_limbs(x, n_limbs: int = N_LIMBS) -> np.ndarray:
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
    return np.stack([to_limbs(v, n_limbs) for v in x]).astype(np.int32)


def from_limbs(limbs) -> "int | list":
    """Inverse of :func:`to_limbs` (accepts tensors and arrays). Signed-safe:
    redundant signed representations round-trip to their exact value."""
    a = limbs.cpu().numpy() if isinstance(limbs, torch.Tensor) else np.asarray(limbs)
    if a.ndim == 1:
        return sum(int(a[i]) << (LIMB_BITS * i) for i in range(a.shape[0]))
    return [from_limbs(row) for row in a]


def make_sub_bias(p_int: int, n_limbs: int, slack_max: int) -> np.ndarray:
    """A multiple of ``p_int`` whose (redundant) limb decomposition
    dominates any invariant-satisfying operand limb-wise, so ``a + bias -
    b`` has every limb non-negative before carrying (the JAX package's
    ``limbs.make_sub_bias``)."""
    for c in range(40, 4096):
        v = c * p_int
        d = [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs - 1)]
        d.append(v >> (LIMB_BITS * (n_limbs - 1)))
        m = [d[0] + (1 << LIMB_BITS)]
        m += [d[i] + (1 << LIMB_BITS) - 1 for i in range(1, n_limbs - 1)]
        m.append(d[n_limbs - 1] - 1)
        if all(slack_max <= mi < (1 << 16) for mi in m):
            if sum(mi << (LIMB_BITS * i) for i, mi in enumerate(m)) != v:
                raise AssertionError("subtraction bias does not encode c*p")
            return np.array(m, dtype=np.int32)
    raise AssertionError("no subtraction bias found")


_SUB_BIAS = make_sub_bias(P_INT, N_LIMBS, SLACK_MAX)

ZERO = to_limbs(0)
ONE = to_limbs(1)
P_LIMBS = to_limbs(P_INT)


_CONSTS: dict = {}


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A module constant as an int32 tensor on ``like``'s device, copied
    there once (a copy per call would stall the card's queue)."""
    key = (id(arr), like.device)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = (
            arr, torch.as_tensor(arr, dtype=torch.int32, device=like.device)
        )
    return hit[1]


# ------------------------------------------------------------------ carries


def _carry(x: torch.Tensor):
    """Sequential carry scan (limbs.carry_scan): limbs -> [0, 2^13),
    returning ``(limbs, carry_out_of_top)``; signed-safe."""
    cols = []
    carry = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        c = x[..., i] + carry
        cols.append(c & LIMB_MASK)
        carry = c >> LIMB_BITS
    return torch.stack(cols, dim=-1), carry


def _pass(x: torch.Tensor):
    """One vectorized carry pass (limbs.carry_pass)."""
    c = x >> LIMB_BITS
    shifted = torch.nn.functional.pad(c[..., :-1], (1, 0))
    return (x & LIMB_MASK) + shifted, c[..., -1]


def _add_limb(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """x with ``v`` added to limb ``i`` (functional, no aliasing)."""
    return torch.cat([x[..., :i], (x[..., i] + v)[..., None], x[..., i + 1 :]], dim=-1)


def _fold_carry_out(x: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """Fold the 2^260 carry-out into limb 0 (x608), then one micro ripple
    (limbs.fold_carry_out)."""
    c0 = x[..., 0] + carry * FOLD_260
    x1 = x[..., 1] + (c0 >> LIMB_BITS)
    return torch.cat(
        [(c0 & LIMB_MASK)[..., None], x1[..., None], x[..., 2:]], dim=-1
    )


def _fold_top(x: torch.Tensor) -> torch.Tensor:
    """Fold bits 255..259 back via x19 -> 19 * (x19 >> 8)."""
    hi = x[..., N_LIMBS - 1] >> TOP_SHIFT
    c0 = x[..., 0] + hi * FOLD_255
    x1 = x[..., 1] + (c0 >> LIMB_BITS)
    top = x[..., N_LIMBS - 1] & TOP_MASK
    return torch.cat(
        [
            (c0 & LIMB_MASK)[..., None],
            x1[..., None],
            x[..., 2 : N_LIMBS - 1],
            top[..., None],
        ],
        dim=-1,
    )


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Carry + top-fold: limbs in [0, 2^13), value < 2^256."""
    x, carry = _carry(x)
    x = _fold_carry_out(x, carry)
    return _fold_top(x)


def _pass_fold(x: torch.Tensor) -> torch.Tensor:
    """Carry pass, folding the 2^260 carry-out back into limb 0 (x608)."""
    x, c = _pass(x)
    return _add_limb(x, 0, c * FOLD_260)


# ---------------------------------------------------------------- operators


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod-ish p: normalized, value < 2^256."""
    x, c = _pass(a + b)
    return _fold_top(_fold_carry_out(x, c))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod-ish p via the limb-dominating bias: every pre-carry limb
    of ``a + bias - b`` is non-negative, so one pass normalizes."""
    x, c = _pass(a + (_const(_SUB_BIAS, a) - b))
    return _fold_top(_fold_carry_out(x, c))


def neg(a: torch.Tensor) -> torch.Tensor:
    x, c = _pass(_const(_SUB_BIAS, a) - a)
    return _fold_top(_fold_carry_out(x, c))


def _reduce_cols(cols: torch.Tensor) -> torch.Tensor:
    """Shared tail of :func:`mul`/:func:`sqr`: 39 product columns (each <=
    20 * SLACK_MAX^2 < 2^31) -> 20 invariant limbs, value < 2^256."""
    cols, c1 = _pass(cols)
    low = cols[..., :N_LIMBS]
    high = cols[..., N_LIMBS:]  # columns 20..38 fold x608 into 0..18
    low = low + torch.cat(
        [high * FOLD_260, (c1 * FOLD_260)[..., None]], dim=-1
    )
    low = _pass_fold(low)
    low = _pass_fold(low)
    return _fold_top(low)


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 39 schoolbook columns sum_{i+j=k} a_i b_j: the [.., 20, 20]
    outer product, each row i shifted right by i (pad to 40, flatten, cut
    to 20 * 39, reshape), summed over rows."""
    prod = a[..., :, None] * b[..., None, :]
    batch = prod.shape[:-2]
    flat = torch.nn.functional.pad(prod, (0, N_LIMBS)).reshape(*batch, -1)
    skew = flat[..., : N_LIMBS * (2 * N_LIMBS - 1)].reshape(
        *batch, N_LIMBS, 2 * N_LIMBS - 1
    )
    return skew.sum(dim=-2, dtype=torch.int32)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product with modular folding. Inputs must satisfy the
    invariant (limbs <= SLACK_MAX); the output does too."""
    a, b = torch.broadcast_tensors(a, b)
    return _reduce_cols(_columns(a, b))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Squaring. The reference accumulates a_i * (a_i, 2a_{i+1}, ...) per
    row; its columns are exactly the columns of a * a, so the limbs out
    are identical."""
    return _reduce_cols(_columns(a, a))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant (k < 2^17 keeps products in int32)."""
    if not 0 <= k < (1 << 17):
        raise ValueError("constant too large for int32 limb products")
    x = _pass_fold(a * k)
    x = _pass_fold(x)
    x = _pass_fold(x)
    return _fold_top(x)


def _nsqr(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sqr(x)
    return x


def pow22523(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3), the exponent of the combined
    square-root/division step of point decompression (RFC 8032 §5.1.3):
    x = u*v^3 * (u*v^7)^((p-5)/8). The reference's addition chain, 251
    squarings and 11 multiplications, so the limbs out are its limbs."""
    z2 = sqr(a)
    z9 = mul(a, _nsqr(z2, 2))
    z11 = mul(z2, z9)
    z_5_0 = mul(z9, sqr(z11))
    z_10_0 = mul(_nsqr(z_5_0, 5), z_5_0)
    z_20_0 = mul(_nsqr(z_10_0, 10), z_10_0)
    z_40_0 = mul(_nsqr(z_20_0, 20), z_20_0)
    z_50_0 = mul(_nsqr(z_40_0, 10), z_10_0)
    z_100_0 = mul(_nsqr(z_50_0, 50), z_50_0)
    z_200_0 = mul(_nsqr(z_100_0, 100), z_100_0)
    z_250_0 = mul(_nsqr(z_200_0, 50), z_50_0)
    return mul(_nsqr(z_250_0, 2), a)  # 2^252 - 3


# ------------------------------------------------------------- canonical


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """Subtract p if x >= p."""
    t, borrow = _carry(x - _const(P_LIMBS, x))  # borrow < 0 iff x < p
    return torch.where((borrow < 0)[..., None], x, t)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the unique representative in [0, p)."""
    x = _normalize(x)  # value < 2^256 < 2p + eps
    return _cond_sub_p(_cond_sub_p(x))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality (handles redundant representations)."""
    return (canonical(a) == canonical(b)).all(dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Per element: a == 0 mod p."""
    return (canonical(a) == 0).all(dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field-element select: mask ? a : b (mask shaped [...])."""
    return torch.where(mask[..., None], a, b)
