"""Batched transaction apply, state digest, Merkle update and root fold.

A block is four dense int32 vectors (kind, sender, recipient, amount)
plus the signature mask, and the apply is one order-independent program:

  1. segment-sum the per-sender outflows (balance outflow for TRANSFER/
     STAKE, stake outflow for UNSTAKE) with one scatter-add,
  2. gather each tx's sender solvency back (block-atomic per sender:
     a sender whose *total* asks exceed its funds has ALL its txs in
     the block rejected — order-independence is what makes the
     vectorized form bit-identical to any serial schedule),
  3. scatter-add the applied deltas into balances/stakes.

Everything is int32. Callers bound amounts (``exec.ExecutionConfig
.amount_cap``) and seed balances so that worst-case per-block flow —
``txs_per_block * amount_cap`` — stays far below 2^31; the exec layer
asserts this bound host-side, the step does not re-check. Shapes are
padded to the ``TX_BUCKETS`` ladder; pad rows carry ``sig_ok=0`` and
``amount=0`` and are algebraically inert.

Port of the JAX package's ``ops/ledger.py``. Its jnp programs
(``apply_block_jax``, ``apply_block_chain*_jax``) become PyTorch ops
(``*_torch``) on whichever device their tensors lie, run eagerly (no
jit). The uint32 state digest and root fold are computed on uint32
words held in int64 tensors in ``[0, 2^32)``, every wrapping product
through :func:`~hyperdrive_tpu_torch.ops.merkle.mul32` (16-bit halves of
the second factor), and the digest's sum over the ``[4A, 8]`` products
as an int64 sum masked to 32 bits (each term below 2^32, so 4A terms
stay exact while 4A < 2^31). Every step is out of place: it never writes
a tensor it was given, so an executor keeps its state as a rollback
snapshot by reference. The host wrapper :func:`apply_block` takes a
``device`` (None: the card) in place of the jit cache.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hyperdrive_tpu_torch.ops import merkle
from hyperdrive_tpu_torch.ops.bucketing import bucket_for
from hyperdrive_tpu_torch.ops.merkle import mul32, resolve_device, sign_words
from hyperdrive_tpu_torch.ops.rootmix import (
    FMIX_A,
    FMIX_B,
    FOLD_HEIGHT,
    FOLD_PREV,
    ROOT_WORDS,
    mix_matrix,
)

__all__ = [
    "TX_BUCKETS",
    "KIND_TRANSFER",
    "KIND_STAKE",
    "KIND_UNSTAKE",
    "ROOT_WORDS",
    "apply_block_torch",
    "apply_block",
    "pad_block",
    "mix_tensor",
    "apply_block_chain_torch",
    "apply_block_chain_cols_torch",
    "apply_block_chain_merkle_cols_torch",
    "pack_block_cols",
    "from_reference",
]

_M32 = 0xFFFFFFFF

#: Padded-launch ladder for the tx axis: every power of four plus the 32k
#: rung (the JAX package's end-to-end bench's mid block size).
TX_BUCKETS = (256, 1024, 4096, 16384, 32768, 65536)

#: Transaction kinds. TRANSFER moves balance sender->recipient; STAKE
#: converts sender balance into sender stake; UNSTAKE converts sender
#: stake back into sender balance. Recipient is ignored for kinds 1/2.
KIND_TRANSFER = 0
KIND_STAKE = 1
KIND_UNSTAKE = 2


def apply_block_torch(balances, stakes, kind, sender, recipient, amount, sig_ok):
    """One block of transactions against the ledger, order-independent.

    Args (tensors on one device):
      balances, stakes: [A] int32 — pre-block state.
      kind, sender, recipient, amount: [T] int32 — the block, padded.
      sig_ok: [T] bool — signature verified AND row is a real tx.

    Returns ``(new_balances, new_stakes, applied)`` where ``applied`` is
    the [T] bool mask of transactions that actually executed (signature
    good AND the sender could cover its block-total outflows).
    """
    a = balances.shape[0]
    amt = amount * sig_ok.to(torch.int32)
    is_transfer = (kind == KIND_TRANSFER).to(torch.int32)
    is_stake = (kind == KIND_STAKE).to(torch.int32)
    is_unstake = (kind == KIND_UNSTAKE).to(torch.int32)
    snd = sender.to(torch.int64)

    # Both passes are ONE scatter-add each over a concatenated [2A]
    # account axis (balances in [:A], stakes in [A:]).
    # 1. Per-sender asks, summed over the whole block: a tx asks from its
    #    sender's balance for TRANSFER/STAKE, its stake for UNSTAKE.
    asks = torch.zeros(2 * a, dtype=balances.dtype, device=balances.device)
    asks.index_add_(0, snd + a * is_unstake.to(torch.int64), amt)

    # 2. Block-atomic solvency: every tx of an overdrawn sender dies.
    sender_ok = (balances >= asks[:a]) & (stakes >= asks[a:])
    applied = sig_ok & sender_ok[snd]
    aamt = amount * applied.to(torch.int32)

    # 3. Applied deltas: the sender's balance moves -a for TRANSFER/STAKE
    #    and +a for UNSTAKE, its stake +a for STAKE and -a for UNSTAKE,
    #    and only TRANSFER credits the recipient.
    new = torch.cat([balances, stakes]).index_add(
        0,
        torch.cat([snd, recipient.to(torch.int64), a + snd]),
        torch.cat([
            aamt * (is_unstake - is_transfer - is_stake),
            aamt * is_transfer,
            aamt * (is_stake - is_unstake),
        ]),
    )
    return new[:a], new[a:], applied


# --------------------------------------------------------------------------
# Device-resident state root: the PyTorch twin of ops/rootmix.py — state
# words, digest reduction and chain fold wrap mod 2^32 exactly as the
# numpy host twin does.


def mix_tensor(n_words: int, device) -> torch.Tensor:
    """:func:`~hyperdrive_tpu_torch.ops.rootmix.mix_matrix` as an int64
    ``[n_words, ROOT_WORDS]`` tensor on ``device``, built once per width
    and device and shared by every executor there (at 65,536 accounts it
    is 16 MiB). The device is resolved first, so ``"cuda"`` and
    ``"cuda:0"`` share one copy."""
    return _mix_tensor(n_words, resolve_device(device))


@functools.lru_cache(maxsize=8)
def _mix_tensor(n_words: int, device: torch.device) -> torch.Tensor:
    m = mix_matrix(n_words).astype(np.int64)
    return torch.from_numpy(m).to(device)


def _state_words_torch(balances, stakes):
    def words(v):
        lo, hi = sign_words(v)
        return torch.stack([lo, hi], dim=1).reshape(-1)

    return torch.cat([words(balances), words(stakes)])


def _state_digest_torch(balances, stakes, mix):
    w = _state_words_torch(balances, stakes)
    return mul32(w[:, None], mix).sum(dim=0) & _M32


def _fold_root_torch(root_words, height: int, digest_words):
    k = torch.arange(ROOT_WORDS, dtype=torch.int64, device=root_words.device)
    x = (
        mul32(root_words, FOLD_PREV)
        + digest_words
        + ((height * FOLD_HEIGHT) & _M32)
        + k
    ) & _M32
    x = x ^ (x >> 16)
    x = mul32(x, FMIX_A)
    x = x ^ (x >> 15)
    x = mul32(x, FMIX_B)
    return x ^ (x >> 16)


def apply_block_chain_torch(
    balances, stakes, root_words, height,
    kind, sender, recipient, amount, sig_ok, mix,
):
    """Apply one block AND fold the new state into the running root, all
    on the device.

    Args beyond :func:`apply_block_torch`:
      root_words: [ROOT_WORDS] int64 — the running chained root.
      height: int — the height being applied.
      mix: [4*A, ROOT_WORDS] int64 — :func:`mix_tensor` for this width.

    Returns ``(new_balances, new_stakes, applied_count, new_root)``
    where ``applied_count`` is a device int64 scalar (not fetched here:
    the executor materializes it per window).
    """
    new_bal, new_stk, applied = apply_block_torch(
        balances, stakes, kind, sender, recipient, amount, sig_ok
    )
    digest = _state_digest_torch(new_bal, new_stk, mix)
    new_root = _fold_root_torch(root_words, height, digest)
    return new_bal, new_stk, applied.sum(), new_root


def apply_block_chain_cols_torch(balances, stakes, root_words, height, cols, mix):
    """:func:`apply_block_chain_torch` taking the block as ONE packed
    [5, T] int32 matrix (kind, sender, recipient, amount, sig_ok rows —
    :func:`pack_block_cols`): one host-to-device copy a block."""
    return apply_block_chain_torch(
        balances, stakes, root_words, height,
        cols[0], cols[1], cols[2], cols[3], cols[4] != 0, mix,
    )


def apply_block_chain_merkle_cols_torch(
    balances, stakes, root_words, tree, height, cols, mix
):
    """The Merkleized step: apply one packed block, update the hash tree
    from the block's own scatter targets, and fold digest + Merkle root
    into the running chained root.

    Args beyond :func:`apply_block_chain_cols_torch`:
      tree: tuple of int64 [p >> d, NODE_WORDS] levels
            (:func:`~hyperdrive_tpu_torch.ops.merkle.build_tree_torch`).

    Returns ``(new_bal, new_stk, count, new_root, digest, new_tree)`` —
    ``digest`` is the post-block state digest (the proof witness),
    ``new_tree`` the updated level tuple; the Merkle root is
    ``new_tree[-1][0]``.

    The dirty set is the sender and recipient columns verbatim — pad
    rows point at account 0 and rejected rows leave state unchanged, so
    their leaf recomputations are idempotent. When the block touches at
    least as many lanes as the tree has leaves (``2 * T >= leaves``),
    the full log-depth rebuild replaces the per-path scatters; the
    choice is made on shapes, in Python.
    """
    new_bal, new_stk, applied = apply_block_torch(
        balances, stakes, cols[0], cols[1], cols[2], cols[3], cols[4] != 0,
    )
    digest = _state_digest_torch(new_bal, new_stk, mix)
    if 2 * cols.shape[1] >= tree[0].shape[0]:
        new_tree = merkle.build_tree_torch(new_bal, new_stk)
    else:
        dirty = torch.cat([cols[1], cols[2]])
        new_tree = merkle.update_tree_torch(tree, new_bal, new_stk, dirty)
    folded = merkle.fold_merkle_torch(digest, new_tree[-1][0])
    new_root = _fold_root_torch(root_words, height, folded)
    return new_bal, new_stk, applied.sum(), new_root, digest, new_tree


def pack_block_cols(kind, sender, recipient, amount, sig_ok=None,
                    bucket: int | None = None) -> np.ndarray:
    """Pack a block into the [5, bucket] int32 matrix
    :func:`apply_block_chain_cols_torch` consumes — rows (kind, sender,
    recipient, amount, sig_ok as 0/1), pad columns inert (sig_ok=0,
    amount=0). ``sig_ok=None`` admits every real row (the unsigned
    semantics)."""
    n = len(kind)
    b = bucket if bucket is not None else bucket_for(max(n, 1), TX_BUCKETS)
    out = np.zeros((5, b), dtype=np.int32)
    out[0, :n] = kind
    out[1, :n] = sender
    out[2, :n] = recipient
    out[3, :n] = amount
    if sig_ok is None:
        out[4, :n] = 1
    else:
        out[4, :n] = np.asarray(sig_ok, dtype=np.int32)
    return out


def pad_block(kind, sender, recipient, amount, sig_ok, bucket: int | None = None):
    """Pad host tx arrays up the ``TX_BUCKETS`` ladder.

    Pad rows are ``sig_ok=False, amount=0, sender=recipient=0`` — inert
    through the step. Returns the five padded np arrays.
    """
    n = len(kind)
    b = bucket if bucket is not None else bucket_for(max(n, 1), TX_BUCKETS)
    pad = b - n

    def _p(a, dtype):
        a = np.asarray(a, dtype=dtype)
        return np.pad(a, (0, pad)) if pad else a

    return (
        _p(kind, np.int32),
        _p(sender, np.int32),
        _p(recipient, np.int32),
        _p(amount, np.int32),
        _p(sig_ok, bool),
    )


def apply_block(balances, stakes, kind, sender, recipient, amount, sig_ok,
                device=None):
    """Host-convenience wrapper: pad to the ladder, run
    :func:`apply_block_torch` on ``device`` (None: the card), slice the
    applied mask back to the true length. State arrays round-trip as
    np.int32; inputs may be lists or arrays."""
    dev = resolve_device(device)
    n = len(kind)
    cols = pad_block(kind, sender, recipient, amount, sig_ok)
    state = [np.asarray(balances, dtype=np.int32), np.asarray(stakes, dtype=np.int32)]
    nb, ns, applied = apply_block_torch(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in state + list(cols))
    )
    return nb.cpu().numpy(), ns.cpu().numpy(), applied.cpu().numpy()[:n]


def from_reference(balances, stakes, root_words, tree, cols, device=None):
    """The JAX package's step inputs as numpy — int32 state, uint32 root
    words, uint32 tree levels, the [5, T] int32 columns — as the
    tensors :func:`apply_block_chain_merkle_cols_torch` takes, on
    ``device`` (None: the card): ``(balances, stakes, root_words, tree,
    cols)``."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))).to(dev)

    return (
        put(balances, np.int32),
        put(stakes, np.int32),
        put(np.asarray(root_words, dtype=np.uint32), np.int64),
        merkle.from_reference(tree, dev),
        put(cols, np.int32),
    )
