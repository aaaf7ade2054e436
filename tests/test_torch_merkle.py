"""The port's Merkle state (``hyperdrive_tpu_torch/ops/merkle.py``) against
the JAX package's ``ops/merkle.py``.

- the uint32 helpers the PyTorch twin is built on: ``mul32`` (int64 words
  with the second factor split into 16-bit halves) and ``sign_words`` (the
  int32 sign word) at their edges, against numpy's wrapping uint32;
- ``build_tree_torch`` against ``build_tree_jax`` and the numpy twin at 1,
  5, 64 and 1,000 accounts (pad leaves included), ``update_tree_torch``
  against ``update_tree_jax`` with duplicate and pad-row targets (and out
  of place), ``fold_merkle_torch`` against ``fold_merkle_jax``;
- the copied numpy twin and ``verify_inclusion``: an honest proof passes
  and four forgeries (wrong balance, wrong sibling, swapped sibling, wrong
  root) fail, each verdict equal to the JAX function's.

Every comparison is exact: tree words, roots and verdicts are integers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hyperdrive_tpu.ops import merkle as ref_merkle
from hyperdrive_tpu.ops import rootmix as ref_rootmix
from hyperdrive_tpu_torch.ops import merkle, rootmix

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

EDGES = (0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF)


def _state(n, seed=23):
    rng = np.random.default_rng(seed)
    bal = rng.integers(-1000, 100_000, size=n, dtype=np.int32)
    stk = rng.integers(-50, 500, size=n, dtype=np.int32)
    return bal, stk


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _same_levels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), np.asarray(w, dtype=np.uint32).astype(np.int64))


# ------------------------------------------------------- uint32 helpers


@pytest.mark.parametrize("a", EDGES)
def test_mul32_wraps_like_uint32_at_the_edges(a):
    b = np.array(EDGES + (0x9E3779B1, 0x846CA68B), dtype=np.uint32)
    want = (np.uint32(a) * b).astype(np.int64)
    at = torch.full((b.size,), a, dtype=torch.int64)
    bt = torch.from_numpy(b.astype(np.int64))
    assert np.array_equal(merkle.mul32(at, bt).numpy(), want)
    for c in (0, 0xFFFFFFFF, 0x80000000, merkle.LEAF_FOLD):
        got = merkle.mul32(bt, c).numpy()
        assert np.array_equal(got, (b * np.uint32(c)).astype(np.int64))


def test_sign_words_and_fmix_match_numpy_at_the_edges():
    v = np.array([0, 1, -1, 2**31 - 1, -(2**31), -2, 12345, -12345], dtype=np.int32)
    lo, hi = merkle.sign_words(torch.from_numpy(v))
    assert np.array_equal(lo.numpy(), v.astype(np.uint32).astype(np.int64))
    assert np.array_equal(hi.numpy(), (v >> 31).astype(np.uint32).astype(np.int64))
    assert hi.numpy().tolist() == [0, 0, 0xFFFFFFFF, 0, 0xFFFFFFFF, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    x = np.array(EDGES, dtype=np.uint32)
    got = merkle._fmix_torch(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, ref_merkle._fmix_np(x).astype(np.int64))
    assert np.array_equal(got, np.asarray(ref_merkle._fmix_jax(jnp.asarray(x))).astype(np.int64))


def test_constants_and_numpy_twin_equal_the_reference():
    for name in ("NODE_WORDS", "LEAF_FOLD", "LEAF_IDX", "SIB_LEFT", "SIB_RIGHT",
                 "MERKLE_FOLD", "MAX_DEPTH"):
        assert getattr(merkle, name) == getattr(ref_merkle, name)
    for name in ("ROOT_WORDS", "FOLD_PREV", "FOLD_HEIGHT", "FMIX_A", "FMIX_B"):
        assert getattr(rootmix, name) == getattr(ref_rootmix, name)
    for accounts in (1, 2, 5, 64, 1000, 65_536):
        assert merkle.leaf_count(accounts) == ref_merkle.leaf_count(accounts)
        assert merkle.tree_depth(accounts) == ref_merkle.tree_depth(accounts)
    bal, stk = _state(37)
    for got, want in zip(merkle.build_tree_np(bal, stk), ref_merkle.build_tree_np(bal, stk)):
        assert np.array_equal(got, want)


# ------------------------------------------------------------- the tree


@pytest.mark.parametrize("accounts", [1, 5, 64, 1000])
def test_build_tree_matches_reference(accounts):
    bal, stk = _state(accounts, seed=accounts)
    got = merkle.build_tree_torch(*_tensors(bal, stk))
    # One jit per tree shape (at most 1,024 leaves): eager jnp would
    # compile every op of every level on its own.
    want = jax.jit(ref_merkle.build_tree_jax)(jnp.asarray(bal), jnp.asarray(stk))
    _same_levels(got, [np.asarray(w) for w in want])
    _same_levels(got, ref_merkle.build_tree_np(bal, stk))
    assert len(got) == ref_merkle.tree_depth(accounts) + 1


@pytest.mark.parametrize("accounts", [5, 64, 1000])
def test_update_tree_with_duplicate_and_pad_targets_matches_reference(accounts):
    bal, stk = _state(accounts, seed=accounts + 1)
    tree_np = ref_merkle.build_tree_np(bal, stk)
    rng = np.random.default_rng(accounts)
    # Raw scatter targets: duplicates, and the pad rows' account 0.
    dirty = np.concatenate([
        rng.integers(0, accounts, 7), [accounts - 1, accounts - 1, 0, 0, 0],
    ]).astype(np.int32)
    bal[dirty] += 9
    stk[dirty[::2]] -= 3  # some stakes turn negative: the sign word moves
    before = merkle.from_reference(tree_np, "cpu")
    kept = [lvl.clone() for lvl in before]
    got = merkle.update_tree_torch(before, *_tensors(bal, stk, dirty))
    want = jax.jit(ref_merkle.update_tree_jax)(
        tuple(jnp.asarray(lvl) for lvl in tree_np),
        jnp.asarray(bal), jnp.asarray(stk), jnp.asarray(dirty),
    )
    _same_levels(got, [np.asarray(w) for w in want])
    _same_levels(got, ref_merkle.build_tree_np(bal, stk))
    # Out of place: the tree it was given is a valid rollback snapshot.
    for b, k in zip(before, kept):
        assert torch.equal(b, k)


def test_fold_merkle_matches_reference():
    rng = np.random.default_rng(5)
    for digest in (np.zeros(8, np.uint32), np.full(8, 0xFFFFFFFF, np.uint32),
                   rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)):
        mroot = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
        got = merkle.fold_merkle_torch(*_tensors(digest.astype(np.int64), mroot.astype(np.int64)))
        want = ref_merkle.fold_merkle_jax(jnp.asarray(digest), jnp.asarray(mroot))
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        assert np.array_equal(got.numpy(), ref_merkle.fold_merkle_np(digest, mroot).astype(np.int64))


def test_from_reference_puts_uint32_levels_on_the_device():
    bal, stk = _state(10)
    levels = ref_merkle.build_tree_np(bal, stk)
    got = merkle.from_reference(levels, "cpu")
    assert isinstance(got, tuple) and all(g.device.type == "cpu" for g in got)
    _same_levels(got, levels)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            merkle.from_reference(levels)


# -------------------------------------------------------------- proofs


def _chained(bal, stk, height=3):
    """A port tree, its proof witness and the trusted chained root."""
    tree = [lvl.numpy().astype(np.uint32) for lvl in merkle.build_tree_torch(*_tensors(bal, stk))]
    digest = rootmix.state_digest_np(bal, stk)
    prev = b"\x5a" * 32
    folded = merkle.fold_merkle_np(digest, merkle.merkle_root_np(tree))
    root = rootmix.root_bytes(rootmix.fold_root_np(rootmix.root_words(prev), height, folded))
    return tree, prev, tuple(int(w) for w in digest), root


def _variants():
    def wrong_sibling(p):
        sibs = list(p.siblings)
        sibs[1] = tuple((w + 1) & 0xFFFFFFFF for w in sibs[1])
        return dataclasses.replace(p, siblings=tuple(sibs))

    def swapped_sibling(p):
        sibs = list(p.siblings)
        sibs[0], sibs[1] = sibs[1], sibs[0]
        return dataclasses.replace(p, siblings=tuple(sibs))

    return {
        "honest": lambda p, root: (p, root, p.account, p.balance),
        "wrong_balance": lambda p, root: (p, root, p.account, p.balance + 1),
        "wrong_sibling": lambda p, root: (wrong_sibling(p), root, p.account, p.balance),
        "swapped_sibling": lambda p, root: (swapped_sibling(p), root, p.account, p.balance),
        "wrong_root": lambda p, root: (p, bytes([root[0] ^ 1]) + root[1:], p.account, p.balance),
    }


@pytest.mark.parametrize("variant", list(_variants()))
def test_verify_inclusion_verdicts_match_reference(variant):
    bal, stk = _state(16)
    tree, prev, digest, root = _chained(bal, stk)
    account = 6
    siblings = merkle.prove_np(tree, account)
    assert siblings == ref_merkle.prove_np(ref_merkle.build_tree_np(bal, stk), account)
    proof = merkle.MerkleProof(
        height=3, account=account, balance=int(bal[account]), stake=int(stk[account]),
        prev_root=prev, digest=digest, siblings=siblings,
    )
    p, r, acct, balance = _variants()[variant](proof, root)
    got = merkle.verify_inclusion(r, acct, balance, p.stake, p)
    ref_proof = ref_merkle.MerkleProof(**dataclasses.asdict(p))
    assert got == ref_merkle.verify_inclusion(r, acct, balance, p.stake, ref_proof)
    assert got is (variant == "honest")
