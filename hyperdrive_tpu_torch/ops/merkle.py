"""Merkleized account state: incremental hash tree + inclusion proofs.

A binary hash tree over the ledger's 8-byte-LE account leaves, built as
log-depth fixed-shape reductions (leaves padded to a power of two, every
level one elementwise combine), so each committed root supports
O(log n) per-account inclusion proofs. The perf core is the
**incremental update**: a block apply marks the dirty leaves straight
from its scatter targets (sender and recipient columns — pad rows point
at account 0, and recomputing a clean leaf is idempotent, so no mask is
needed) and recomputes only the touched root-paths, O(k log n) work in
place of the O(n) rebuild, inside the same step as the block apply and
the chain fold (``ops/ledger.py``).

Node arithmetic is NODE_WORDS uint32 lanes through the lowbias32
finalizer, mod 2^32, shared bit-identically by the NUMPY twin here (host
reference executor, light clients) and the PyTorch twin (``*_torch``)
the device step runs. Like the root chain it feeds (``fold_merkle`` ->
``fold_root``), this is linear-algebraic, NOT a cryptographic hash.

Port of the JAX package's ``ops/merkle.py``: the numpy twin is a copy;
the jnp twin becomes PyTorch ops on whichever device its tensors lie.
PyTorch has few uint32 ops (fewer on CUDA), so every uint32 word is held
in an int64 tensor in ``[0, 2^32)`` and every wrapping product goes
through :func:`mul32`, which splits its second factor into 16-bit
halves so no partial product leaves signed int64. The tree is a tuple
of int64 ``[p >> d, NODE_WORDS]`` levels. Every function here is out of
place — it never writes a tensor it was given — so a caller may keep a
tree as a rollback snapshot by reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hyperdrive_tpu_torch.ops.rootmix import (
    FMIX_A,
    FMIX_B,
    ROOT_WORDS,
    fold_root_np,
    root_bytes,
    root_words,
)

__all__ = [
    "NODE_WORDS",
    "MerkleProof",
    "tree_depth",
    "leaf_count",
    "build_tree_np",
    "update_tree_np",
    "merkle_root_np",
    "merkle_bytes",
    "fold_merkle_np",
    "prove_np",
    "fold_path_np",
    "verify_inclusion",
    "mul32",
    "sign_words",
    "build_tree_torch",
    "update_tree_torch",
    "fold_merkle_torch",
    "resolve_device",
    "from_reference",
]

_M32 = 0xFFFFFFFF

#: Every tree node is 4 little-endian uint32 words = 16 bytes, half the
#: chain-root width: a depth-17 proof (131072 accounts) is 272 bytes of
#: siblings.
NODE_WORDS = 4

#: Leaf/combine multipliers (murmur3 c1/c2 and finalizer-family odd
#: constants, disjoint from the rootmix chain-fold set so a leaf can
#: never alias a fold term). Shared by the numpy and PyTorch twins.
LEAF_FOLD = 0xCC9E2D51
LEAF_IDX = 0x1B873593
SIB_LEFT = 0x85EBCA6B
SIB_RIGHT = 0xC2B2AE35
MERKLE_FOLD = 0x27D4EB2F


def leaf_count(accounts: int) -> int:
    """Leaves are padded to the next power of two (min 1) so every
    level halves exactly — the fixed-shape ladder of the build."""
    return 1 if accounts <= 1 else 1 << (accounts - 1).bit_length()


def tree_depth(accounts: int) -> int:
    """Number of combine levels (== sibling-path length) for a ledger
    of ``accounts`` accounts."""
    return (leaf_count(accounts) - 1).bit_length()


# ------------------------------------------------------------- numpy twin


def _fmix_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(FMIX_A)).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = (x * np.uint32(FMIX_B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return x


def leaf_words_np(idx, balances, stakes) -> np.ndarray:
    """Leaf nodes for accounts ``idx``: the (lo, hi) uint32 words of the
    8-byte-LE signed balance and stake (hi = sign extension, exactly the
    ``pack_state`` bytes) salted by account index and lane, finalized.
    Returns uint32[K, NODE_WORDS]."""
    idx = np.asarray(idx, dtype=np.uint32)
    b = np.asarray(balances, dtype=np.int32)
    s = np.asarray(stakes, dtype=np.int32)
    w = np.stack(
        [
            b.astype(np.uint32),
            (b >> 31).astype(np.uint32),
            s.astype(np.uint32),
            (s >> 31).astype(np.uint32),
        ],
        axis=-1,
    )
    k = np.arange(NODE_WORDS, dtype=np.uint32)
    return _fmix_np(
        w * np.uint32(LEAF_FOLD) + idx[:, None] * np.uint32(LEAF_IDX) + k
    )


def combine_np(left, right) -> np.ndarray:
    """Parent nodes from child pairs — position-asymmetric (left and
    right multiply by different constants) so a swapped sibling can
    never reproduce the parent. uint32[K, NODE_WORDS] each side."""
    left = np.asarray(left, dtype=np.uint32)
    right = np.asarray(right, dtype=np.uint32)
    k = np.arange(NODE_WORDS, dtype=np.uint32)
    return _fmix_np(
        left * np.uint32(SIB_LEFT) + right * np.uint32(SIB_RIGHT) + k
    )


def build_tree_np(balances, stakes) -> list:
    """Full O(n) rebuild: list of levels, leaves first, uint32
    [p >> d, NODE_WORDS] each, root level last ([1, NODE_WORDS]).
    Pad leaves are real leaves of zero-balance zero-stake accounts at
    their padded index — deterministic and never dirtied."""
    b = np.asarray(balances, dtype=np.int32)
    s = np.asarray(stakes, dtype=np.int32)
    p = leaf_count(b.shape[0])
    if p != b.shape[0]:
        b = np.pad(b, (0, p - b.shape[0]))
        s = np.pad(s, (0, p - s.shape[0]))
    levels = [leaf_words_np(np.arange(p, dtype=np.uint32), b, s)]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(combine_np(cur[0::2], cur[1::2]))
    return levels


def update_tree_np(tree: list, balances, stakes, dirty_idx) -> list:
    """Incremental O(k log n) update IN PLACE: recompute the dirty
    leaves from post-block state and walk only the touched root-paths
    up. Duplicate / already-clean indices are idempotent (a clean leaf
    recomputes to itself), so callers pass raw scatter targets.
    Returns ``tree`` for chaining."""
    idx = np.unique(np.asarray(dirty_idx, dtype=np.int64))
    b = np.asarray(balances, dtype=np.int32)
    s = np.asarray(stakes, dtype=np.int32)
    tree[0][idx] = leaf_words_np(idx.astype(np.uint32), b[idx], s[idx])
    for d in range(1, len(tree)):
        idx = np.unique(idx >> 1)
        child = tree[d - 1]
        tree[d][idx] = combine_np(child[2 * idx], child[2 * idx + 1])
    return tree


def merkle_root_np(tree) -> np.ndarray:
    """uint32[NODE_WORDS] — the tree's root node."""
    return np.asarray(tree[-1][0], dtype=np.uint32)


def merkle_bytes(words) -> bytes:
    """uint32[NODE_WORDS] -> the canonical 16-byte little-endian form."""
    return np.asarray(words, dtype=np.uint32).astype("<u4").tobytes()


def fold_merkle_np(digest_words, merkle_words) -> np.ndarray:
    """Chain the Merkle root into the state digest BEFORE the height
    fold: digest'_k = fmix(digest_k * C + merkle_{k mod 4} + k). Both
    executors fold this way, so ``root_h`` commits the tree and the
    flat digest together and a light client can rebind a proof to the
    certificate chain with O(1) extra witness words."""
    d = np.asarray(digest_words, dtype=np.uint32)
    m = np.asarray(merkle_words, dtype=np.uint32)
    k = np.arange(ROOT_WORDS, dtype=np.uint32)
    return _fmix_np(d * np.uint32(MERKLE_FOLD) + m[k % NODE_WORDS] + k)


def prove_np(tree, account: int) -> tuple:
    """O(log n) sibling path for ``account``, leaf level upward: a
    tuple of NODE_WORDS-int tuples, one per level below the root."""
    sibs = []
    i = int(account)
    for d in range(len(tree) - 1):
        sibs.append(tuple(int(w) for w in tree[d][i ^ 1]))
        i >>= 1
    return tuple(sibs)


def fold_path_np(leaf, account: int, siblings) -> np.ndarray:
    """Walk a sibling path from ``leaf`` back to the Merkle root —
    the light-client side of :func:`prove_np`. uint32[NODE_WORDS]."""
    cur = np.asarray(leaf, dtype=np.uint32).reshape(1, NODE_WORDS)
    i = int(account)
    for sib in siblings:
        sib = np.asarray(sib, dtype=np.uint32).reshape(1, NODE_WORDS)
        cur = combine_np(cur, sib) if i % 2 == 0 else combine_np(sib, cur)
        i >>= 1
    return cur[0]


@dataclass(frozen=True)
class MerkleProof:
    """Everything a stateless client needs to check one account against
    a trusted chained root: the claimed height, the previous chained
    root and post-block state digest as O(1) witness words, and the
    O(log n) sibling path. The client recomputes

      root'_h = fold_root(prev_root, h, fold_merkle(digest, path(leaf)))

    and compares against the certificate-chain root — zero trust in
    the serving replica."""

    height: int
    account: int
    balance: int
    stake: int
    prev_root: bytes  # 32 bytes — root_{h-1}
    digest: tuple  # ROOT_WORDS ints — post-block state digest
    siblings: tuple  # depth × NODE_WORDS-int tuples, leaf level first


#: Paths longer than this are rejected before any arithmetic — 2^64
#: accounts bounds every honest tree, so an attacker can't stall a
#: client with a mile-long forged path.
MAX_DEPTH = 64


def verify_inclusion(root: bytes, account: int, balance: int, stake: int,
                     proof: MerkleProof) -> bool:
    """True iff ``proof`` binds (account, balance, stake) into the
    trusted chained root ``root``. Detects stale roots (old-height
    witness against a fresh root), forged siblings, truncated paths,
    and wrong-leaf values — each perturbs the recomputed fold."""
    if (
        not isinstance(proof, MerkleProof)
        or proof.height < 1
        or account < 0
        or len(proof.prev_root) != 32
        or len(proof.digest) != ROOT_WORDS
        or len(proof.siblings) > MAX_DEPTH
        or account >> len(proof.siblings)
    ):
        return False
    leaf = leaf_words_np(
        np.asarray([account], dtype=np.uint32), [balance], [stake]
    )[0]
    mroot = fold_path_np(leaf, account, proof.siblings)
    folded = fold_merkle_np(
        np.asarray(proof.digest, dtype=np.uint32), mroot
    )
    r = fold_root_np(root_words(proof.prev_root), proof.height, folded)
    return root_bytes(r) == root


# ----------------------------------------------------------- PyTorch twin
#
# uint32 words live in int64 tensors in [0, 2^32); every function below
# mirrors the numpy twin mod 2^32 bit-for-bit. Kept in one module so a
# constant can never drift between the twins.


def mul32(a, b):
    """``(a * b) mod 2^32`` for uint32 words held in int64: ``a`` a
    tensor, ``b`` a tensor or a Python int, both in ``[0, 2^32)``.

    ``a * b`` itself can reach 2^64 and overflow signed int64, so ``b``
    is split into 16-bit halves: ``a * b_lo < 2^48``, and of
    ``a * b_hi < 2^48`` only the low 16 bits survive the shift by 16,
    so every intermediate stays below 2^49."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def sign_words(v: torch.Tensor):
    """int32 values -> their 8-byte-LE signed packing as (lo, hi) uint32
    words in int64: ``lo`` the two's-complement low word, ``hi`` the
    sign extension (0, or 0xFFFFFFFF for a negative value)."""
    lo = v.to(torch.int64) & _M32
    hi = (v >> 31).to(torch.int64) & _M32
    return lo, hi


def _fmix_torch(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, FMIX_A)
    x = x ^ (x >> 15)
    x = mul32(x, FMIX_B)
    return x ^ (x >> 16)


def _lanes(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _leaf_words_torch(idx, balances, stakes):
    """int64 account indices, int32 state -> int64 [K, NODE_WORDS]."""
    b_lo, b_hi = sign_words(balances)
    s_lo, s_hi = sign_words(stakes)
    w = torch.stack([b_lo, b_hi, s_lo, s_hi], dim=-1)
    x = (
        mul32(w, LEAF_FOLD)
        + mul32(idx[:, None], LEAF_IDX)
        + _lanes(NODE_WORDS, w.device)
    ) & _M32
    return _fmix_torch(x)


def _combine_torch(left, right):
    x = (
        mul32(left, SIB_LEFT)
        + mul32(right, SIB_RIGHT)
        + _lanes(NODE_WORDS, left.device)
    ) & _M32
    return _fmix_torch(x)


def build_tree_torch(balances: torch.Tensor, stakes: torch.Tensor) -> tuple:
    """Full rebuild: log-depth fixed-shape strided combines over int32
    state. Returns the tuple of int64 levels, leaves first."""
    a = balances.shape[0]
    p = leaf_count(a)
    if p != a:
        balances = torch.nn.functional.pad(balances, (0, p - a))
        stakes = torch.nn.functional.pad(stakes, (0, p - a))
    levels = [_leaf_words_torch(_lanes(p, balances.device), balances, stakes)]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(_combine_torch(cur[0::2], cur[1::2]))
    return tuple(levels)


def update_tree_torch(tree, balances, stakes, dirty_idx) -> tuple:
    """Incremental update: one [K] leaf scatter plus one [K]
    gather-combine-scatter per level, O(k log n). Duplicate dirty
    indices write identical values (each recomputed from the same
    post-block state), so the result is deterministic without a dedup
    pass. Out of place: returns a new tuple of levels and leaves
    ``tree`` as it was."""
    idx = dirty_idx.to(torch.int64)
    levels = [
        tree[0].index_put(
            (idx,), _leaf_words_torch(idx, balances[idx], stakes[idx])
        )
    ]
    for d in range(1, len(tree)):
        idx = idx // 2
        child = levels[-1]
        levels.append(
            tree[d].index_put(
                (idx,), _combine_torch(child[2 * idx], child[2 * idx + 1])
            )
        )
    return tuple(levels)


def fold_merkle_torch(digest_words, merkle_words):
    """Device twin of :func:`fold_merkle_np` on int64 words."""
    k = _lanes(ROOT_WORDS, digest_words.device)
    x = (
        mul32(digest_words, MERKLE_FOLD) + merkle_words[k % NODE_WORDS] + k
    ) & _M32
    return _fmix_torch(x)


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises. A CUDA
    device comes back with its index, so it compares equal to the
    ``.device`` of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the ledger "
                "and Merkle steps' PyTorch ops on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def from_reference(levels, device=None) -> tuple:
    """The JAX package's tree (uint32 numpy levels, e.g. from
    ``build_tree_np`` or a fetched ``build_tree_jax``) as this module's
    tuple of int64 levels on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.asarray(lvl, dtype=np.uint32).astype(np.int64)).to(dev)
        for lvl in levels
    )
