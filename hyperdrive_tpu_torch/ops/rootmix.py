"""The chained state-root reduction, host side (numpy).

The execution layer's root chain replaces a per-block host
``sha256(state)`` hop with a fixed-shape uint32 reduction over the
packed ledger leaves, chained height to height with a 32-bit mix
finalizer:

  digest_k(state) = sum_i words(state)_i * M[i, k]        (mod 2^32)
  root_h          = fmix(root_{h-1} * C1 + digest + h * C2 + k)

``words`` splits each account's 8-byte little-endian signed packing
into (lo, hi) uint32 pairs — hi is the int32 sign extension — so the
reduction covers exactly the bytes ``exec.ledger.pack_state`` would
have hashed. ``M`` is a deterministic per-shape odd-constant matrix
and ``fmix`` the lowbias32 finalizer pair.

Port copy of the JAX package's ``ops/rootmix.py`` (which imports no
JAX; the port keeps its own copy). This is the NUMPY twin: the host
reference executor and checkpoint verification chain through these
functions; ``ops/ledger.py`` computes the identical arithmetic in
PyTorch ops inside the device apply step. Both wrap mod 2^32
bit-identically, which is the whole parity contract.

The reduction is linear-algebraic, NOT a cryptographic hash: the
genesis root stays sha256 and the running chain is re-derived from
fetched state at checkpoints (``HostLedgerExecutor.host_verify``).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "ROOT_WORDS",
    "mix_matrix",
    "state_digest_np",
    "fold_root_np",
    "root_bytes",
    "root_words",
]

#: The running root is 8 little-endian uint32 words = 32 bytes, so a
#: commit record is the 32-byte value plus 32 root bytes.
ROOT_WORDS = 8

_M32 = 0xFFFFFFFF

#: Chain-fold multipliers (golden-ratio / murmur-family odd constants)
#: and the lowbias32 finalizer pair. Shared by the numpy and PyTorch
#: twins.
FOLD_PREV = 0x9E3779B1
FOLD_HEIGHT = 0x85EBCA77
FMIX_A = 0x7FEB352D
FMIX_B = 0x846CA68B


@functools.lru_cache(maxsize=8)
def mix_matrix(n_words: int) -> np.ndarray:
    """The per-shape multiplier matrix M[n_words, ROOT_WORDS]: odd
    deterministic uint32 constants from a splitmix-style sequence, so
    every state word feeds every root word. Pure function of the word
    count — both executors derive the identical matrix for one account
    width."""
    out = np.empty(n_words * ROOT_WORDS, dtype=np.uint32)
    for i in range(n_words * ROOT_WORDS):
        z = (i * 0x9E3779B9 + 0x243F6A88) & _M32
        z ^= z >> 16
        z = (z * 0x21F0AAAD) & _M32
        z ^= z >> 15
        z = (z * 0x735A2D97) & _M32
        z ^= z >> 15
        out[i] = z | 1
    return out.reshape(n_words, ROOT_WORDS)


def _state_words(balances, stakes) -> np.ndarray:
    """int32 state -> interleaved (lo, hi) uint32 words, mirroring the
    8-byte-LE signed packing word-for-word (hi = sign extension)."""

    def words(v):
        v = np.asarray(v, dtype=np.int32)
        lo = v.astype(np.uint32)
        hi = (v >> 31).astype(np.uint32)
        return np.stack([lo, hi], axis=1).reshape(-1)

    return np.concatenate([words(balances), words(stakes)])


def state_digest_np(balances, stakes) -> np.ndarray:
    """Host twin of the device digest: uint32[ROOT_WORDS]."""
    w = _state_words(balances, stakes)
    m = mix_matrix(w.shape[0])
    return (w[:, None] * m).sum(axis=0, dtype=np.uint32)


def fold_root_np(prev_words, height: int, digest_words) -> np.ndarray:
    """Chain ``digest_words`` into ``prev_words`` at ``height`` (host
    twin of the device fold — identical mod-2^32 arithmetic)."""
    r = np.asarray(prev_words, dtype=np.uint32)
    d = np.asarray(digest_words, dtype=np.uint32)
    k = np.arange(ROOT_WORDS, dtype=np.uint32)
    # Scalar term in Python ints: numpy warns on scalar uint overflow
    # (array ops wrap silently, which is what the rest relies on).
    hterm = np.uint32((height * FOLD_HEIGHT) & _M32)
    x = (r * np.uint32(FOLD_PREV) + d + hterm + k).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(FMIX_A)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(FMIX_B)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def root_bytes(words) -> bytes:
    """uint32[ROOT_WORDS] -> the canonical 32-byte little-endian root."""
    return np.asarray(words, dtype=np.uint32).astype("<u4").tobytes()


def root_words(root: bytes) -> np.ndarray:
    """32-byte root -> uint32[ROOT_WORDS] (the chain-fold input form)."""
    return np.frombuffer(root, dtype="<u4").copy()
