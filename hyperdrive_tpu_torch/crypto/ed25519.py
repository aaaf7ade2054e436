"""Pure-Python Ed25519 (RFC 8032), the framework's host verification path.

This is the correctness oracle: the TPU batch verifier
(:mod:`hyperdrive_tpu_torch.ops.ed25519`) must agree with this implementation
bit-for-bit on accept/reject, which is enforced by differential tests.

Implementation notes:
- Extended homogeneous coordinates (X, Y, Z, T) on the twisted Edwards
  curve -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19).
- Scalar multiplication is plain double-and-add on Python ints — this is a
  host correctness path, not the throughput path (that is the TPU's job).
- All helpers needed by the device path (decompression, scalar reduction,
  the challenge hash) are exported so the host<->device packing shares one
  definition of every quantity.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "P",
    "L",
    "D",
    "BASE",
    "sha512",
    "secret_expand",
    "public_key_from_seed",
    "sign",
    "verify",
    "point_compress",
    "point_decompress",
    "challenge_scalar",
    "scalar_from_bytes",
    "point_add",
    "point_double",
    "scalar_mult",
    "point_equal",
    "IDENTITY",
]

# Field prime and group order.
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493

# Curve constant d = -121665/121666 mod p.
D = (-121665 * pow(121666, P - 2, P)) % P

# sqrt(-1) mod p, used in decompression.
SQRT_M1 = pow(2, (P - 1) // 4, P)


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


# ------------------------------------------------------------ point algebra
# Points are (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.

IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    """Unified addition (complete for a = -1 twisted Edwards)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % P
    b = ((y1 + x1) * (y2 + x2)) % P
    c = (2 * t1 * t2 * D) % P
    dd = (2 * z1 * z2) % P
    e = b - a
    f = dd - c
    g = dd + c
    h = b + a
    return ((e * f) % P, (g * h) % P, (f * g) % P, (e * h) % P)


def point_double(p):
    return point_add(p, p)


def scalar_mult(s: int, p):
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


def point_equal(p, q) -> bool:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


# Base point: y = 4/5 mod p, x recovered with even parity.
def _base_point():
    y = (4 * pow(5, P - 2, P)) % P
    x = _recover_x(y, 0)
    return (x, y, 1, (x * y) % P)


def _recover_x(y: int, sign: int):
    """Solve x^2 = (y^2 - 1) / (d y^2 + 1); None if no root exists."""
    if y >= P:
        return None
    x2 = ((y * y - 1) * pow(D * y * y + 1, P - 2, P)) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = (x * SQRT_M1) % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


BASE = _base_point()


# ------------------------------------------------------------- wire formats


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x = (x * zinv) % P
    y = (y * zinv) % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(data: bytes):
    """Decompress 32 bytes to an extended point, or None if invalid."""
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y = enc & ((1 << 255) - 1)
    sign = enc >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, (x * y) % P)


def scalar_from_bytes(data: bytes) -> int:
    return int.from_bytes(data, "little")


def challenge_scalar(r_bytes: bytes, pub: bytes, msg: bytes) -> int:
    """k = SHA-512(R || A || M) mod L — shared by sign, host verify, and the
    device packing path."""
    return scalar_from_bytes(sha512(r_bytes + pub + msg)) % L


# ------------------------------------------------------------------ keypath


def secret_expand(seed: bytes) -> tuple[int, bytes]:
    """Expand a 32-byte seed into the clamped scalar and the prefix."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = sha512(seed)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key_from_seed(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return point_compress(scalar_mult(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signature: R (32B) || s (32B little-endian)."""
    a, prefix = secret_expand(seed)
    pub = point_compress(scalar_mult(a, BASE))
    r = scalar_from_bytes(sha512(prefix + msg)) % L
    r_point = scalar_mult(r, BASE)
    r_bytes = point_compress(r_point)
    k = challenge_scalar(r_bytes, pub, msg)
    s = (r + k * a) % L
    return r_bytes + int.to_bytes(s, 32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Check [s]B == R + [k]A. Returns False on any malformed input."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    a_point = point_decompress(pub)
    if a_point is None:
        return False
    r_bytes = sig[:32]
    r_point = point_decompress(r_bytes)
    if r_point is None:
        return False
    s = scalar_from_bytes(sig[32:])
    if s >= L:
        return False
    k = challenge_scalar(r_bytes, pub, msg)
    sb = scalar_mult(s, BASE)
    rka = point_add(r_point, scalar_mult(k, a_point))
    return point_equal(sb, rka)
