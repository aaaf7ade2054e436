"""GF(p) arithmetic for the BLS12-381 base field on int32 limb tensors.

Port of the JAX package's ``ops/fp381.py`` as PyTorch ops, limb for limb:
a field element is **30 limbs of 13 bits** in int32 (capacity 390 bits)
on tensors shaped ``[..., 30]`` (any batch prefix).

p_381 has no pseudo-Mersenne structure (2^390 mod p is a full-width
constant), so values live in the **Montgomery domain** (x̄ = x·R mod p,
R = 2^390) and multiplication is CIOS with the reduction interleaved
into the schoolbook product (:class:`.limbs.Montgomery`). Two
consequences shape the API:

- **Signed redundancy, no subtraction bias.** Montgomery reduction is
  indifferent to sign, so ``sub`` is a plain limb subtraction plus one
  carry pass, and intermediate values are signed with the invariant
  **|value| < 2^389.5** (top limb below 2^12.5). Each ``mul`` contracts
  the magnitude back below |a·b|/R + p ~ 2^388.6, so chains of up to
  8x-scaling add/sub between muls stay inside the invariant — the G1
  complete-addition formulas (:mod:`.g1`) peak at 8·Y^2 ~ 2^389.2.
- **Domain conversion is host-side.** :func:`to_mont`/:func:`from_mont`
  are Python int multiplies at pack/unpack time (numpy arrays); the
  device never materializes R^2. :func:`canonical` drops to the standard
  domain on the device via a Montgomery multiply by 1 (x̄·1/R = x), which
  also squeezes the value into [0, p] for the conditional subtract.

Int32 safety (the bound walk the CIOS pass depends on): operand limbs
after a pass have magnitude <= 2^13 + eps; each CIOS step adds one
a_i*b_j product and one m*p_j product per column (<= 2 * 8193^2 ~=
1.35e8) onto an accumulator limb whose steady state is <= 8192 +
1.35e8/2^13 ~= 2.5e4 — columns stay < 1.4e8 << 2^31. Never widen the
limbs to int64: the limbs would differ from the reference's.

The Python-int reference for every operation is the host oracle
(:mod:`hyperdrive_tpu_torch.crypto.bls`). Added: :func:`from_reference`
(the JAX package's numpy limb arrays as tensors on a device).
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdrive_tpu_torch.ops import limbs as _limbs

__all__ = [
    "N_LIMBS",
    "LIMB_BITS",
    "LIMB_MASK",
    "P_INT",
    "MONT",
    "to_mont",
    "from_mont",
    "to_limbs",
    "from_limbs",
    "add",
    "sub",
    "neg",
    "mul",
    "sqr",
    "mul_small",
    "canonical",
    "eq",
    "is_zero",
    "select",
    "from_reference",
    "resolve_device",
    "ZERO",
    "ONE",
]

N_LIMBS = 30
LIMB_BITS = _limbs.LIMB_BITS
LIMB_MASK = _limbs.LIMB_MASK

#: The BLS12-381 base field prime (381 bits).
P_INT = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)

#: Montgomery context: R = 2^390, n0' = -p^{-1} mod 2^13, CIOS program.
MONT = _limbs.make_montgomery(P_INT, N_LIMBS)


def to_limbs(x) -> np.ndarray:
    """Python int(s) in [0, 2^390) -> int32 limb array [..., 30]. Raw
    limb packing — no domain conversion (see :func:`to_mont`)."""
    return _limbs.to_limbs(x, N_LIMBS)


def from_limbs(limbs) -> "int | list":
    """Inverse of :func:`to_limbs` (host side, signed-safe; tensors are
    copied to the host)."""
    return _limbs.from_limbs(limbs)


def to_mont(x) -> np.ndarray:
    """Host pack: Python int(s) -> Montgomery-domain limb array. Accepts
    a single int or any nested sequence (mirrors :func:`to_limbs`)."""
    if isinstance(x, int):
        return to_limbs(MONT.encode(x))
    x = list(x)
    if x and isinstance(x[0], int):
        return to_limbs([MONT.encode(v) for v in x])
    return np.stack([to_mont(v) for v in x])


def from_mont(limbs) -> "int | list":
    """Host unpack: Montgomery-domain limbs (any redundant signed
    representation; tensors are copied to the host) -> canonical Python
    int(s) in [0, p)."""
    v = from_limbs(limbs)
    if isinstance(v, int):
        return MONT.decode(v)

    def walk(t):
        return MONT.decode(t) if isinstance(t, int) else [walk(u) for u in t]

    return walk(v)


ZERO = to_limbs(0)
#: 1 in the Montgomery domain (R mod p).
ONE = to_mont(1)
_ONE_STD = to_limbs(1)
_P_LIMBS = to_limbs(P_INT)


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the BLS12-381 "
            "ops on the CPU"
        )
    return dev


def from_reference(limbs, device=None) -> torch.Tensor:
    """The JAX package's limb arrays (numpy int32 ``[..., 30]``, e.g. from
    its ``to_mont``) as an int32 tensor on ``device`` (None: the card)."""
    arr = np.ascontiguousarray(limbs, dtype=np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))


# ---------------------------------------------------------------- operators


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (domain-agnostic). One carry pass; the top limb absorbs the
    carry-out unmasked (the value bound keeps it tiny)."""
    return _limbs.carry_pass_keep_top(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, signed — no bias needed (see module docstring)."""
    return _limbs.carry_pass_keep_top(a - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _limbs.carry_pass_keep_top(-a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product ā·b̄/R (= the Montgomery form of a·b)."""
    return MONT.mul(a, b)


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Montgomery squaring. CIOS gains nothing from symmetry, so this is
    :func:`mul`."""
    return MONT.mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small non-negative constant. Scalars act directly
    in the Montgomery domain (k·x̄ = Montgomery form of k·x). k < 2^17
    keeps limb products inside int32; two passes restore the limb
    bound."""
    if not 0 <= k < (1 << 17):
        raise ValueError("constant too large for int32 limb products")
    x = _limbs.carry_pass_keep_top(a * k)
    return _limbs.carry_pass_keep_top(x)


# ------------------------------------------------------------- canonical


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """Subtract p if x >= p (branch-free select; x in [0, p] after
    :func:`canonical`'s squeeze, so one round suffices)."""
    t, borrow = _limbs.carry_scan(x - _limbs.const(_P_LIMBS, x))
    return torch.where((borrow < 0)[..., None], x, t)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Montgomery-domain x̄ -> the unique standard-domain representative
    of x in [0, p). A Montgomery multiply by 1 computes x̄/R = x while
    squeezing the value into [0, p]; a scan carry then a single
    conditional subtract finish."""
    std = MONT.mul(x, _limbs.const(_ONE_STD, x))
    std, _ = _limbs.carry_scan(std)
    return _cond_sub_p(std)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality across redundant signed representations."""
    return torch.all(canonical(a) == canonical(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field-element select: mask ? a : b (mask shaped [...])."""
    return torch.where(mask[..., None], a, b)
