"""Device-side Ed25519 challenge scalars: SHA-512 + mod-L reduction (PyTorch).

Port of the JAX package's ``ops/sha512_jax.py``, and the plain version of
the ``ed25519_challenge`` kernel (``csrc/ed25519_challenge.cu``, wrappers
in :mod:`hyperdrive_tpu_torch.ops.ed25519_cuda`): the challenge leg k =
SHA-512(R || A || M) mod L of the wire verifier's challenge routes
(:mod:`hyperdrive_tpu_torch.ops.ed25519_wire`). The CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card; the card's path
does not use it.

- A batched single-block SHA-512 (messages <= 111 bytes; the challenge
  preimage R||A||M is exactly 96) over int64 words, one word per lane. int64
  addition wraps mod 2^64 and the bitwise operators do not care about the
  sign, so only the right shift needs care: torch's ``>>`` on int64 is
  arithmetic, so every logical shift and rotate masks off the copied sign
  bits. Constants >= 2^63 are written as their negative int64 value. The 80
  rounds are a Python loop over [B] tensors.
- The reference's base-2^13 limb reduction of the 512-bit digest to the
  CANONICAL scalar k < L (two delta-folds using 2^252 = -delta mod L, then
  three conditional subtracts), in int32 limb for limb, so k is byte for
  byte the host's :func:`hyperdrive_tpu_torch.crypto.ed25519.challenge_scalar`.

Every function takes and returns tensors on one device; nothing is copied
between host and device apart from the reduction's constants, uploaded
once per device.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
from hyperdrive_tpu_torch.ops import fe25519 as fe

__all__ = [
    "sha512_cat",
    "sc_reduce_limbs",
    "challenge_scalar_device",
    "limbs13_from_bytes",
    "bytes_from_limbs13",
]

L = host_ed.L
_LIMB_BITS = fe.LIMB_BITS
_LIMB_MASK = fe.LIMB_MASK
#: delta = L - 2^252: the fold constant (2^252 = -delta mod L). 125 bits
#: -> 10 limbs of 13.
_DELTA = L - (1 << 252)
_DELTA_LIMBS = fe.to_limbs(_DELTA, 10)
_L_LIMBS = fe.to_limbs(L, 20)
_2L_LIMBS = fe.to_limbs(2 * L, 20)


# ------------------------------------------------------------- SHA-512


def _i64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


# FIPS 180-4 round constants and initial hash value.
_K = [_i64(k) for k in (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)]
_H0 = [_i64(h) for h in (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)]


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 words (0 < n < 64)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def sha512_cat(parts) -> torch.Tensor:
    """Batched SHA-512 over the concatenation of ``parts`` (each [B, w_i]
    uint8); total width <= 111 bytes so the padded message is a single
    1024-bit block. Returns the digest as [B, 64] uint8."""
    data = torch.cat(list(parts), dim=1)
    bsz, nbytes = data.shape
    if nbytes > 111:
        raise ValueError("single-block SHA-512 requires <= 111 bytes")
    # The padded block: data, the 0x80 byte, zeros, and the 128-bit
    # big-endian bit length (8 * nbytes < 2^16, so two bytes).
    block = torch.zeros((bsz, 128), dtype=torch.int64, device=data.device)
    block[:, :nbytes] = data
    block[:, nbytes] = 0x80
    block[:, 126] = (8 * nbytes) >> 8
    block[:, 127] = (8 * nbytes) & 0xFF
    b = block.view(bsz, 16, 8)
    words = b[..., 0] << 56
    for j in range(1, 8):
        words = words | (b[..., j] << (56 - 8 * j))
    w = list(words.unbind(1))
    for t in range(16, 80):
        x15, x2 = w[t - 15], w[t - 2]
        s0 = _rotr(x15, 1) ^ _rotr(x15, 8) ^ _shr(x15, 7)
        s1 = _rotr(x2, 19) ^ _rotr(x2, 61) ^ _shr(x2, 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)

    state = [torch.full((bsz,), h, dtype=torch.int64, device=data.device)
             for h in _H0]
    a, b_, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = g ^ (e & (f ^ g))
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b_) | (c & (a | b_))
        h, g, f, e = g, f, e, d + t1
        d, c, b_, a = c, b_, a, t1 + s0 + maj

    out = torch.stack(
        [v + h0 for v, h0 in zip((a, b_, c, d, e, f, g, h), _H0)], dim=1
    )
    shifts = torch.arange(56, -1, -8, device=data.device)
    return ((out[..., None] >> shifts) & 0xFF).reshape(bsz, 64).to(torch.uint8)


# ------------------------------------------------- base-2^13 scalar limbs


def limbs13_from_bytes(rows: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """[B, W] uint8 little-endian -> [B, n_limbs] int32 13-bit limbs, with
    no bit-255 masking (callers reduce, they don't interpret mod p)."""
    b = torch.nn.functional.pad(rows.to(torch.int32), (0, 2))
    bit = torch.arange(n_limbs, device=rows.device) * _LIMB_BITS
    byte, off = bit >> 3, (bit & 7).to(torch.int32)
    v = b[:, byte] | (b[:, byte + 1] << 8) | (b[:, byte + 2] << 16)
    return (v >> off) & _LIMB_MASK


def bytes_from_limbs13(limbs: torch.Tensor, n_bytes: int = 32) -> torch.Tensor:
    """[B, n] int32 13-bit limbs -> [B, n_bytes] uint8 little-endian. Limb
    li+1 contributes to byte i only when the byte straddles two limbs; when
    it does not, its shift (>= 8) puts it above the byte's mask."""
    lp = torch.nn.functional.pad(limbs, (0, 1))
    bit = torch.arange(n_bytes, device=limbs.device) * 8
    li, off = bit // _LIMB_BITS, (bit % _LIMB_BITS).to(torch.int32)
    v = (lp[:, li] >> off) | (lp[:, li + 1] << (_LIMB_BITS - off))
    return (v & 0xFF).to(torch.uint8)


def _mul_const(x: torch.Tensor, const: np.ndarray) -> torch.Tensor:
    """Schoolbook [B, n] limbs x m-limb constant -> [B, n+m-1] raw column
    sums (no carries): the [B, n, m] outer product, row i shifted right by
    i (pad, flatten, cut, reshape), summed over rows. Each product < 2^26
    and a column sums at most 10 of them, so int32 never overflows."""
    n, m = x.shape[-1], len(const)
    prod = x[:, :, None] * fe._const(const, x)[None, None, :]
    flat = torch.nn.functional.pad(prod, (0, n)).reshape(x.shape[0], -1)
    skew = flat[:, : n * (n + m - 1)].reshape(x.shape[0], n, n + m - 1)
    return skew.sum(dim=1, dtype=torch.int32)


def _carry(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """Sequential signed carry propagation into ``n_out`` 13-bit limbs.
    Arithmetic >> floor-divides, so negative columns borrow correctly; the
    caller guarantees the total fits n_out limbs and is non-negative."""
    out = []
    carry = torch.zeros_like(cols[:, 0])
    n = cols.shape[-1]
    for i in range(n_out):
        v = cols[:, i] + carry if i < n else carry
        out.append(v & _LIMB_MASK)
        carry = v >> _LIMB_BITS
    return torch.stack(out, dim=-1)


def _split252(limbs: torch.Tensor, n_high: int):
    """Split value = low + 2^252 * high. Bit 252 sits at limb 19, offset 5
    (19*13 = 247). Returns (low [B, 20] < 2^252, high [B, n_high])."""
    n = limbs.shape[-1]
    lp = torch.nn.functional.pad(limbs, (0, max(0, 20 + n_high - n)))
    low = torch.cat([lp[:, :19], lp[:, 19:20] & 0x1F], dim=-1)
    high = ((lp[:, 19 : 19 + n_high] >> 5)
            | ((lp[:, 20 : 20 + n_high] & 0x1F) << 8)) & _LIMB_MASK
    return low, high


def _cond_sub(limbs: torch.Tensor, const: np.ndarray) -> torch.Tensor:
    """limbs - const if that does not underflow, else limbs unchanged."""
    out = []
    borrow = torch.zeros_like(limbs[:, 0])
    for i in range(limbs.shape[-1]):
        v = limbs[:, i] - int(const[i]) - borrow
        out.append(v & _LIMB_MASK)
        borrow = -(v >> _LIMB_BITS)  # v >= -2^13, so >>13 is -1 or 0
    sub = torch.stack(out, dim=-1)
    return torch.where((borrow == 1)[:, None], limbs, sub)


def sc_reduce_limbs(h_limbs: torch.Tensor) -> torch.Tensor:
    """[B, 40] 13-bit limbs of a 512-bit value -> [B, 20] limbs of the
    CANONICAL residue mod L (the reference's fold bounds: 2^512 ->
    delta*2^260 < 2^385 -> delta*2^133 < 2^258 -> delta*2^6 < 2^131, then
    a - c_low + d_low - e + 2L < 4.2 L, then subtracts of 2L, L, L)."""
    a, b = _split252(h_limbs, 21)
    c = _carry(_mul_const(b, _DELTA_LIMBS), 31)
    c_low, c_high = _split252(c, 12)
    d = _carry(_mul_const(c_high, _DELTA_LIMBS), 22)
    d_low, d_high = _split252(d, 3)
    e = _carry(_mul_const(d_high, _DELTA_LIMBS), 20)
    k = _carry(a - c_low + d_low - e + fe._const(_2L_LIMBS, a)[None, :], 20)
    k = _cond_sub(k, _2L_LIMBS)
    k = _cond_sub(k, _L_LIMBS)
    return _cond_sub(k, _L_LIMBS)


def challenge_scalar_device(r_rows, a_rows, m_rows) -> torch.Tensor:
    """k = SHA-512(R || A || M) mod L on the inputs' device. Inputs are
    [B, 32] uint8 wire encodings; returns [B, 32] uint8 little-endian
    canonical k."""
    digest = sha512_cat((r_rows, a_rows, m_rows))
    return bytes_from_limbs13(sc_reduce_limbs(limbs13_from_bytes(digest, 40)))
