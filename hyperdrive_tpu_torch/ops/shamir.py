"""Batched Shamir reconstruction on the device (PyTorch ops).

Reconstructs many payload blocks at once: the Lagrange weights depend only
on *which* k shares answered (host-computed once per share-set,
:func:`hyperdrive_tpu_torch.crypto.shamir.lagrange_coeffs_at_zero`); the
device then computes ``secret_b = sum_i lambda_i * y_{i,b}`` for every
block b — k field multiplies and adds over the whole block batch, on the
same GF(2^255-19) limbs as the plain verify ladder
(:mod:`hyperdrive_tpu_torch.ops.fe25519`).

Port of the JAX package's ``ops/shamir.py``. The reference's
``reconstruct_kernel`` is a jnp program, not a Pallas kernel, so here it
is PyTorch ops (no hand-written kernel), on whichever device its tensors
lie. Differences: the block axis is chunked so that one call's field
product intermediate stays bounded (:data:`CHUNK_ELEMS`); each
:class:`BatchReconstructor` lives on one ``device`` (the card unless the
caller passes ``device="cpu"``) and counts its device calls
(``launches``). Dropped: the ``device_fetch`` analysis annotation, the
jit cache (PyTorch runs eagerly) and with it ``warmup``, and
``AdaptiveReconstructor.recalibrate``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hyperdrive_tpu_torch.crypto import shamir as host_shamir
from hyperdrive_tpu_torch.ops import fe25519 as fe

__all__ = [
    "CHUNK_ELEMS",
    "reconstruct_kernel",
    "from_reference",
    "BatchReconstructor",
    "AdaptiveReconstructor",
]

#: Bound on the int32 elements of one chunk's schoolbook intermediate
#: (``fe.mul`` builds a [k, chunk, 20, 40] tensor): 2^24 elements, 64 MiB.
#: At k = 171 a chunk is 122 blocks, so 1,024 blocks run in 9 chunks; an
#: unchunked call would build 560 MB there.
CHUNK_ELEMS = 1 << 24


def _chunk_blocks(k: int) -> int:
    return max(1, CHUNK_ELEMS // (k * fe.N_LIMBS * 2 * fe.N_LIMBS))


def reconstruct_kernel(y_shares: torch.Tensor, lams: torch.Tensor) -> torch.Tensor:
    """secrets[b] = sum_i lams[i] * y_shares[i, b]  (canonical form).

    Args (int32, one device):
      y_shares: [k, B, 20] — share values per contributing share i and
        block b.
      lams:     [k, 20] — Lagrange weights at zero.
    Returns: [B, 20] canonical field elements.

    One broadcast field multiply and one RAW limb sum over the share axis:
    normalized limbs are <= SLACK_MAX, so k summands stay below 2^31 while
    k * SLACK_MAX < 2^31 (any k < 228,000), and no per-share normalization
    is needed; then one ``canonical``. The block axis runs in chunks of
    at most :func:`_chunk_blocks` blocks."""
    k = y_shares.shape[0]
    if k * fe.SLACK_MAX >= 1 << 31:
        raise ValueError("k too large for the raw-sum reduction")
    w = lams[:, None, :]
    step = _chunk_blocks(k)
    out = []
    for lo in range(0, y_shares.shape[1], step):
        prods = fe.mul(y_shares[:, lo : lo + step], w)  # [k, chunk, 20]
        out.append(prods.sum(dim=0, dtype=torch.int32))
    acc = out[0] if len(out) == 1 else torch.cat(out)
    return fe.canonical(acc)


def _limbs_of_ints(values) -> np.ndarray:
    """Ints in [0, 2^256) -> [N, 20] int32 limbs, equal to
    ``fe.to_limbs`` row for row (bit unpacking in numpy in place of a
    Python loop per limb: the k x B share matrix is 175,104 values at
    k = 171, B = 1,024)."""
    raw = b"".join(v.to_bytes(32, "little") for v in values)
    bits = np.unpackbits(
        np.frombuffer(raw, dtype=np.uint8).reshape(-1, 32), axis=1,
        bitorder="little",
    )
    bits = np.pad(bits, ((0, 0), (0, fe.N_LIMBS * fe.LIMB_BITS - 256)))
    weights = np.int32(1) << np.arange(fe.LIMB_BITS, dtype=np.int32)
    return (bits.reshape(-1, fe.N_LIMBS, fe.LIMB_BITS) * weights).sum(
        axis=-1, dtype=np.int32
    )


def _ints_of_limbs(limbs: np.ndarray) -> list[int]:
    """[N, 20] canonical limbs (each in [0, 2^13)) -> ints."""
    bits = (limbs[..., None] >> np.arange(fe.LIMB_BITS)) & 1
    rows = np.packbits(
        bits.reshape(limbs.shape[0], -1)[:, :256].astype(np.uint8), axis=1,
        bitorder="little",
    )
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def _resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the "
            "reconstruction's PyTorch ops on the CPU"
        )
    return dev


def from_reference(y_limbs, lam_limbs, device=None):
    """The reference's ``reconstruct_kernel`` inputs (numpy int32 limbs:
    shares ``[k, B, 20]`` and weights ``[k, 20]``) as tensors on
    ``device``: ``(y_shares, lams)``. Plain numpy in."""
    dev = _resolve_device(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        for a in (y_limbs, lam_limbs)
    )


def _sorted_validated(per_block_shares):
    """Sort each block's shares by x and demand ONE contributor set across
    all blocks (one set of Lagrange weights covers the whole batch —
    mismatched sets raise instead of corrupting). Returns
    (sorted_blocks, xs tuple). Shared by the device and host legs so the
    validation can never diverge."""
    sorted_blocks = [sorted(shares) for shares in per_block_shares]
    xs = tuple(x for x, _ in sorted_blocks[0])
    for i, shares in enumerate(sorted_blocks):
        if tuple(x for x, _ in shares) != xs:
            raise ValueError(
                f"block {i} has share x-coordinates "
                f"{[x for x, _ in shares]} != {list(xs)}; all blocks "
                "must come from the same contributor set"
            )
    return sorted_blocks, xs


def _cache_put(cache: dict, key, value, bound: int = 64):
    """Bounded FIFO insert (churning contributor sets must not pin
    weights forever)."""
    if len(cache) >= bound:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


class BatchReconstructor:
    """Host wrapper: packs shares, runs :func:`reconstruct_kernel` on
    ``device``, unpacks bytes. ``launches`` counts the calls that ran it."""

    def __init__(self, device=None):
        self.device = _resolve_device(device)
        # Lagrange weights depend only on the contributor set, which is
        # stable across commits in steady state; the cache keeps them on
        # the device (k modular inverses each on the host otherwise).
        self._lam_cache: dict[tuple, torch.Tensor] = {}
        self.launches = 0

    def reconstruct_blocks(self, xs: list[int], y_blocks: list[list[int]]) -> list[int]:
        """xs: the k share x-coordinates; y_blocks: [k][B] share values.

        Returns the B reconstructed block secrets as ints.
        """
        key = tuple(xs)
        lams = self._lam_cache.get(key)
        if lams is None:
            lams = _cache_put(
                self._lam_cache,
                key,
                torch.from_numpy(
                    fe.to_limbs(host_shamir.lagrange_coeffs_at_zero(xs))
                ).to(self.device),
            )
        k, b = len(y_blocks), len(y_blocks[0])
        y = _limbs_of_ints(v for row in y_blocks for v in row)
        y = torch.from_numpy(y.reshape(k, b, fe.N_LIMBS)).to(self.device)
        self.launches += 1
        return _ints_of_limbs(reconstruct_kernel(y, lams).cpu().numpy())

    def reconstruct_payload_shares(self, per_block_shares) -> bytes:
        """per_block_shares: list over blocks of k (x, y) tuples from the
        same k contributors per block. Device-batched equivalent of
        :func:`hyperdrive_tpu_torch.crypto.shamir.reconstruct_payload`;
        shares are sorted by x per block, and mismatched contributor sets
        raise instead of corrupting."""
        if not per_block_shares:
            return b""
        sorted_blocks, xs = _sorted_validated(per_block_shares)
        y_blocks = [
            [shares[i][1] for shares in sorted_blocks]
            for i in range(len(xs))
        ]
        secrets = self.reconstruct_blocks(list(xs), y_blocks)
        out = b"".join(
            s.to_bytes(host_shamir.BLOCK_BYTES, "little") for s in secrets
        )
        return host_shamir.unpad_payload(out)


class AdaptiveReconstructor:
    """Routes each reconstruction to the host or the device by block
    count: the host leg for commit-sized payloads, the device for wide
    batches. The break-even is measured, not guessed: the first batch at
    least ``calibrate_at`` blocks wide is timed through BOTH paths (their
    outputs cross-checked; a disagreement raises rather than routing on
    speed), and the solved crossover routes everything after. Until then,
    the provisional ``crossover_blocks`` routes.

    ``device``: the device leg, a :class:`BatchReconstructor` (by default
    one on the card). Both legs give identical outputs, so routing is a
    pure performance decision.
    """

    def __init__(self, device: "BatchReconstructor | None" = None,
                 crossover_blocks: int = 512, calibrate_at: int = 512):
        self.device = device if device is not None else BatchReconstructor()
        self.crossover_blocks = int(crossover_blocks)
        self.calibrate_at = int(calibrate_at)
        self.calibrated = False
        #: Calibration record once measured — keys ``host_blocks_per_s``,
        #: ``device_blocks_per_s``, ``device_overhead_s`` (one call's
        #: time for a single block, seconds).
        self.rates = None
        # Host-side Lagrange weight cache, mirroring the device's: the
        # per-block reconstruct_payload recomputes k modular inverses for
        # every block, which would dominate the host leg's time.
        self._host_lams: dict[tuple, list] = {}

    def host_reconstruct(self, per_block_shares) -> bytes:
        """The cached-weight host leg (public: benchmarks time it)."""
        sorted_blocks, xs = _sorted_validated(per_block_shares)
        lams = self._host_lams.get(xs)
        if lams is None:
            lams = _cache_put(
                self._host_lams,
                xs,
                host_shamir.lagrange_coeffs_at_zero(list(xs)),
            )
        p = host_shamir.P
        out = b"".join(
            (
                sum(lam * y for lam, (_, y) in zip(lams, shares)) % p
            ).to_bytes(host_shamir.BLOCK_BYTES, "little")
            for shares in sorted_blocks
        )
        return host_shamir.unpad_payload(out)

    @staticmethod
    def _median_time(fn, reps: int = 3):
        out = None
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2], out

    def _calibrate(self, per_block_shares) -> bytes:
        # The single-block overhead probe must be a decodable payload on
        # its own: only the LAST block carries the 0x80 padding.
        one = per_block_shares[-1:]
        self.device.reconstruct_payload_shares(per_block_shares)  # warm
        self.device.reconstruct_payload_shares(one)
        t_dev_full, out_dev = self._median_time(
            lambda: self.device.reconstruct_payload_shares(per_block_shares)
        )
        t_dev_one, _ = self._median_time(
            lambda: self.device.reconstruct_payload_shares(one)
        )
        t_host, out_host = self._median_time(
            lambda: self.host_reconstruct(per_block_shares)
        )
        if out_dev != out_host:
            raise RuntimeError(
                "host and device reconstruction disagree during "
                "calibration — refusing to route on performance while "
                "correctness differs"
            )
        b = len(per_block_shares)
        host_rate = b / t_host if t_host > 0 else float("inf")
        dev_per_block = max(t_dev_full - t_dev_one, 0.0) / max(b - 1, 1)
        dev_rate = b / t_dev_full if t_dev_full > 0 else float("inf")
        denom = 1.0 / host_rate - dev_per_block
        self.crossover_blocks = (
            int(t_dev_one / denom) + 1 if denom > 0 else 1 << 30
        )
        self.rates = {
            "host_blocks_per_s": host_rate,
            "device_blocks_per_s": dev_rate,
            "device_overhead_s": t_dev_one,
        }
        self.calibrated = True
        return out_dev

    def reconstruct_payload_shares(self, per_block_shares) -> bytes:
        per_block_shares = list(per_block_shares)
        if not per_block_shares:
            return b""
        if (
            not self.calibrated
            and len(per_block_shares) >= self.calibrate_at
        ):
            return self._calibrate(per_block_shares)
        if len(per_block_shares) >= self.crossover_blocks:
            return self.device.reconstruct_payload_shares(per_block_shares)
        return self.host_reconstruct(per_block_shares)
