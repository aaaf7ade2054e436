"""Shamir secret sharing over GF(2^255 - 19) (host reference path).

The framework's MPC-payload capability (BASELINE.md config 5): committed
values can carry k-of-n secret-shared payloads which replicas reconstruct
per committed block. The field is the same GF(2^255-19) the signature
kernels use, so the device path (:mod:`hyperdrive_tpu_torch.ops.shamir`)
reuses the limb arithmetic; this module is the bignum oracle it is tested
against.

Payload blocks are 31 bytes: every 31-byte string is < 2^248 < p, so
packing is injective and padding-free.

Port copy of the JAX package's ``crypto/shamir.py``, byte for byte in its
outputs (bundles, shares, payloads), with the bundle codec's
``shamir.bundle`` wire registration.
"""

from __future__ import annotations

import hashlib

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.crypto.ed25519 import P

__all__ = [
    "BLOCK_BYTES",
    "split_block",
    "reconstruct_block",
    "lagrange_coeffs_at_zero",
    "split_payload",
    "unpad_payload",
    "reconstruct_payload",
    "encode_share_bundle",
    "decode_share_bundle",
]

BLOCK_BYTES = 31


def _poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def _det_coeff(tag: bytes, i: int) -> int:
    """Deterministic coefficient derivation (keeps the harness seedable)."""
    return int.from_bytes(hashlib.sha512(tag + i.to_bytes(4, "little")).digest(), "little") % P


def split_block(secret: int, k: int, n: int, tag: bytes = b"") -> list[tuple[int, int]]:
    """Split ``secret`` (< p) into n shares, any k of which reconstruct.

    Shares are (x, y) with x = 1..n. Coefficients derive deterministically
    from ``tag`` so tests and scenario replays are reproducible; pass a
    random tag for real secrecy.
    """
    if not 0 <= secret < P:
        raise ValueError("secret out of field range")
    if not 1 <= k <= n:
        raise ValueError("need 1 <= k <= n")
    coeffs = [secret] + [_det_coeff(tag, i) for i in range(1, k)]
    return [(x, _poly_eval(coeffs, x)) for x in range(1, n + 1)]


def lagrange_coeffs_at_zero(xs: list[int]) -> list[int]:
    """lambda_i = prod_{j != i} x_j / (x_j - x_i) mod p — the interpolation
    weights at 0 for the given share x-coordinates. Host-computed once per
    share-set; the device program applies them across many blocks."""
    lams = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = (num * xj) % P
            den = (den * (xj - xi)) % P
        lams.append((num * pow(den, P - 2, P)) % P)
    return lams


def reconstruct_block(shares: list[tuple[int, int]]) -> int:
    """Interpolate the secret from k (x, y) shares."""
    xs = [x for x, _ in shares]
    lams = lagrange_coeffs_at_zero(xs)
    return sum(lam * y for lam, (_, y) in zip(lams, shares)) % P


# ------------------------------------------------------- byte-payload API


def split_payload(payload: bytes, k: int, n: int, tag: bytes = b"") -> list[list[tuple[int, int]]]:
    """Split an arbitrary byte payload into per-block share lists.

    The payload is chunked into 31-byte blocks (the final block keeps its
    true length via a standard 0x80 pad)."""
    padded = payload + b"\x80"
    padded += b"\x00" * ((-len(padded)) % BLOCK_BYTES)
    blocks = [
        int.from_bytes(padded[i : i + BLOCK_BYTES], "little")
        for i in range(0, len(padded), BLOCK_BYTES)
    ]
    return [
        split_block(b, k, n, tag=tag + i.to_bytes(4, "little"))
        for i, b in enumerate(blocks)
    ]


def unpad_payload(out: bytes) -> bytes:
    """Strip the 0x80 padding — shared by the host and device paths so the
    two can never desynchronize."""
    end = out.rstrip(b"\x00")
    if not end.endswith(b"\x80"):
        raise ValueError("invalid payload padding")
    return end[:-1]


def reconstruct_payload(block_shares: list[list[tuple[int, int]]]) -> bytes:
    """Inverse of :func:`split_payload` given >= k shares per block."""
    out = b"".join(
        reconstruct_block(shares).to_bytes(BLOCK_BYTES, "little")
        for shares in block_shares
    )
    return unpad_payload(out)


# ----------------------------------------------------- wire bundle format
#
# The byte encoding a Propose's ``payload`` field carries: every replica
# receives the full n-share bundle and any k shares reconstruct at commit
# (BASELINE config 5). x-coordinates are implicit (split_payload always
# emits x = 1..n in order), so the bundle is just the y-value matrix.


@wire_codec(tag="shamir.bundle", max_bytes=1 << 20)
def encode_share_bundle(block_shares: list[list[tuple[int, int]]]) -> bytes:
    """[blocks][n] (x, y) shares -> bytes: u32 blocks, u32 n, then y values
    as 32-byte little-endian rows, block-major."""
    blocks = len(block_shares)
    n = len(block_shares[0]) if blocks else 0
    parts = [blocks.to_bytes(4, "little"), n.to_bytes(4, "little")]
    for shares in block_shares:
        if len(shares) != n or [x for x, _ in shares] != list(range(1, n + 1)):
            raise ValueError("bundle blocks must carry shares x = 1..n in order")
        parts.extend(y.to_bytes(32, "little") for _, y in shares)
    return b"".join(parts)


@wire_codec(tag="shamir.bundle", max_bytes=1 << 20)
def decode_share_bundle(data: bytes) -> list[list[tuple[int, int]]]:
    """Inverse of :func:`encode_share_bundle`; raises ValueError on any
    malformed input (never crashes — proposal payloads are attacker-
    controlled bytes)."""
    if len(data) < 8:
        raise ValueError("bundle too short")
    blocks = int.from_bytes(data[0:4], "little")
    n = int.from_bytes(data[4:8], "little")
    if blocks > 1 << 20 or n > 1 << 20 or len(data) != 8 + 32 * blocks * n:
        raise ValueError("bundle size mismatch")
    out = []
    off = 8
    for _ in range(blocks):
        shares = []
        for x in range(1, n + 1):
            y = int.from_bytes(data[off : off + 32], "little")
            if y >= P:
                raise ValueError("share value out of field range")
            shares.append((x, y))
            off += 32
        out.append(shares)
    return out
