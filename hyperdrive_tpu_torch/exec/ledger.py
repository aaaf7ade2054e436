"""Deterministic tx blocks, the host reference executor, root chaining.

Everything here is host code and bit-deterministic. A height's block is
a pure function of ``(config.seed, height)`` — never of committed
values or delivery order — so a laggard resyncing straight to height H
executes the identical blocks every up-to-date replica executed, and a
replay re-derives the whole ledger trajectory from the config ints
alone.

State roots chain like the commit chain itself:

  root_0   = sha256("exec-genesis" || pack(balances) || pack(stakes))
  root_h   = fold(root_{h-1}, h,
                  fold_merkle(digest(state_h), merkle(state_h)))

where ``digest`` is the fixed-shape uint32 reduction over the packed
state leaves, ``merkle`` the account hash tree's root (ops/merkle.py,
updated incrementally from the block's own scatter targets), and
``fold`` the per-height chain mix — all defined ONCE in ops/ with
bit-identical numpy (host) and PyTorch (device) twins, so the device
executor keeps the running root AND the hash tree ON DEVICE between
heights (no per-block host hash hop) and still chains byte-equal to
the host reference. Because ``root_h`` commits the Merkle root,
``prove(account)`` yields an O(log n) inclusion proof any stateless
client can check against the certificate chain
(``verify_inclusion``). ``pack`` stays 8-byte little-endian signed per
account (the word split mirrors it lo/hi), the root stays 32 bytes,
and the genesis root stays sha256. The reduction is linear-algebraic,
not cryptographic: integrity of the running chain is re-derived
host-side at checkpoints (``host_verify``).

Speculative pipelining: ``speculate(h, guess)`` applies height
``h`` under a guessed admission mask while the real verification is
still in flight; ``resolve(h, true_mask)`` either confirms the height
or ROLLS BACK — restoring state to the pre-speculation snapshot
bit-identically, recording every discarded root (``discarded_roots``:
none may appear in a committed value), and re-applying under
the true mask. A rolled-back root can therefore never appear in a
committed value: commits only read roots after resolution.

Apply semantics are ORDER-INDEPENDENT and block-atomic per sender: a
sender whose summed asks (balance asks for TRANSFER/STAKE, stake asks
for UNSTAKE) exceed its pre-block funds has every transaction in that
block rejected. That is what makes the vectorized device form
(ops/ledger.py: segment-sum → solvency gather → scatter-add) exactly
equal to any serial schedule of the same block.

Port of the JAX package's ``exec/ledger.py``, with its ``obs=`` hook and
``exec.*`` / ``merkle.*`` events. Dropped: the executors' ``device``
flag (:class:`~hyperdrive_tpu_torch.exec.device.DeviceLedgerExecutor`
.device is its torch device; the host executor's ``exec.apply`` says
``dev=0`` as the reference's does). Added: :data:`EXEC_ORIGIN`, the
submitting-track tag of the JAX package's ``obs/devtel.py``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from hyperdrive_tpu_torch.devsched.queue import VerifyLauncher
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.ops.merkle import (
    MerkleProof,
    build_tree_np,
    fold_merkle_np,
    merkle_bytes,
    merkle_root_np,
    prove_np,
    tree_depth,
    update_tree_np,
    verify_inclusion,
)
from hyperdrive_tpu_torch.ops.rootmix import (
    fold_root_np,
    root_bytes,
    root_words,
    state_digest_np,
)

__all__ = [
    "KIND_TRANSFER",
    "KIND_STAKE",
    "KIND_UNSTAKE",
    "EXEC_ORIGIN",
    "TxBlock",
    "BlockSource",
    "HostLedgerExecutor",
    "ProofBasis",
    "ExecApplyLauncher",
]

#: Transaction kinds — must match ops/ledger.py (the device step keeps
#: its own copies so ops/ stays importable without this package).
KIND_TRANSFER = 0
KIND_STAKE = 1
KIND_UNSTAKE = 2

#: The ``origin`` the execution layer submits its signature rows under
#: on the device-work queue (the JAX package's ``obs/devtel.py``
#: constant: votes come from replica indices >= 0, exec rows from -3).
EXEC_ORIGIN = -3

_INT32_MAX = 2**31 - 1

#: "no mask supplied" sentinel for ``_step`` (None is a real mask value:
#: the unsigned everything-admitted semantics).
_UNSET = object()


def pack_state(values) -> bytes:
    """Account vector -> bytes, 8-byte little-endian signed per entry.
    The ONE packing both executors must agree on for root equality."""
    return b"".join(int(v).to_bytes(8, "little", signed=True) for v in values)


class TxBlock:
    """One height's transactions as dense columns. The NUMPY arrays are
    the native layout (the device executor pads them straight into
    tensors); the Python-list views the host executor walks are
    materialized lazily on first access, so a device-executor run never
    pays the array->list conversion at all."""

    __slots__ = (
        "height", "digest", "_np", "_py", "_sig_items", "_cols",
    )

    def __init__(self, height, kind, sender, recipient, amount, digest):
        self.height = height
        #: Content digest: what the exec proposer's value commits to.
        self.digest = digest
        #: (kind, sender, recipient, amount) as int32 numpy columns —
        #: the device step's native dtype, so padding is a copy, not
        #: a cast (accounts and amount_cap are int32-bounded by config
        #: validation).
        self._np = tuple(
            np.asarray(c, dtype=np.int32)
            for c in (kind, sender, recipient, amount)
        )
        self._py = None
        self._sig_items = None
        #: Device-padded column cache (DeviceLedgerExecutor): the
        #: array->tensor copy is block MATERIALIZATION, shared by every
        #: executor on the source and device like the columns
        #: themselves, and evicted with the block by the source's LRU.
        self._cols = None

    def _lists(self):
        py = self._py
        if py is None:
            py = self._py = tuple(c.tolist() for c in self._np)
        return py

    @property
    def kind(self):
        return self._lists()[0]

    @property
    def sender(self):
        return self._lists()[1]

    @property
    def recipient(self):
        return self._lists()[2]

    @property
    def amount(self):
        return self._lists()[3]

    def __len__(self) -> int:
        return len(self._np[0])


#: STAKE-vs-UNSTAKE split point on the stake lane: a uint32 draw below
#: this threshold (~0.6 * 2^32) stakes, above it unstakes — biased
#: toward STAKE so validator weights drift and elections have
#: something to read.
_STAKE_BIAS = int(0.6 * 2**32)


class BlockSource:
    """Deterministic per-height workload, shared by every replica.

    ``block(h)`` derives height h's transactions from a keyed
    ``shake_256`` stream expanded into dense numpy columns in one pass
    (the per-tx Python RNG loop this replaced was ~87% of pipelined
    e2e wall time at 16k-tx blocks); every ``stake_every``-th tx is a
    STAKE/UNSTAKE on a validator stake account (``stake_accounts``
    wide, biased toward STAKE so validator weights drift and epoch
    elections have something to read). ``value(h)`` is the 32-byte
    proposal value committing to the block. With ``sign_txs`` each tx
    carries a real Ed25519 signature from its sender's deterministic
    account key; ``bad_sig_every`` corrupts every K-th one.

    ``spec_epoch`` tags cache entries with the open speculation window
    (the sim bumps it when a window closes): entries touched in the
    CURRENT epoch are pinned against LRU eviction, so a rollback that
    replays a window height hits the cached block — padded device
    columns included — instead of re-materializing it. ``hits`` /
    ``misses`` / ``evictions`` count the cache's behavior for tests.
    """

    #: Blocks cached per source; sim runs walk heights forward and
    #: bench blocks are large, so a short LRU covers re-reads (the n
    #: replicas' executors share one source) without pinning 64k-tx
    #: columns for every committed height. Entries of the open
    #: speculation epoch are pinned (rollback replays them), so the
    #: cache can transiently exceed this by the window depth.
    CACHE = 8

    def __init__(self, config: ExecutionConfig):
        self.config = config
        #: height -> [spec_epoch_last_touched, TxBlock]
        self._cache: dict[int, list] = {}
        self._values: dict[int, bytes] = {}
        self._ring = None
        self.spec_epoch = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _content_digest(self, height: int) -> bytes:
        """The block's content digest WITHOUT materializing the block:
        the columns are a pure function of ``(key, config shape)``, so
        the digest binds the derivation key plus every config field
        that shapes content — identical commitment, none of the
        hash-over-columns cost (which proposal values for not-yet-
        executed heights would otherwise pay in full)."""
        cfg = self.config
        key = hashlib.sha256(
            b"exec-block-%d-%d" % (cfg.seed, height)
        ).digest()
        return hashlib.sha256(
            b"exec-txs" + key
            + b"%d-%d-%d-%d-%d" % (
                cfg.accounts, cfg.txs_per_block, cfg.stake_every,
                cfg.stake_accounts, cfg.amount_cap,
            )
        ).digest()

    def block(self, height: int) -> TxBlock:
        ent = self._cache.get(height)
        if ent is not None:
            ent[0] = self.spec_epoch
            self.hits += 1
            return ent[1]
        self.misses += 1
        cfg = self.config
        key = hashlib.sha256(
            b"exec-block-%d-%d" % (cfg.seed, height)
        ).digest()
        t = cfg.txs_per_block
        w = np.frombuffer(
            hashlib.shake_256(b"exec-cols" + key).digest(16 * t),
            dtype="<u4",
        ).reshape(t, 4)
        stake_lane = cfg.stake_every > 0 and cfg.stake_accounts > 0
        kind = np.zeros(t, dtype=np.int64)
        sender = w[:, 1].astype(np.int64) % cfg.accounts
        recipient = w[:, 2].astype(np.int64) % cfg.accounts
        if stake_lane:
            lane = np.zeros(t, dtype=bool)
            lane[:: cfg.stake_every] = True
            kind[lane] = np.where(
                w[lane, 0] < np.uint32(_STAKE_BIAS),
                KIND_STAKE, KIND_UNSTAKE,
            )
            sender[lane] = w[lane, 1].astype(np.int64) % cfg.stake_accounts
            recipient[lane] = sender[lane]
        amount = 1 + w[:, 3].astype(np.int64) % cfg.amount_cap
        blk = TxBlock(
            height, kind, sender, recipient, amount,
            self._content_digest(height),
        )
        if len(self._cache) >= self.CACHE:
            # Evict oldest-first, but never an entry of the OPEN
            # speculation epoch — a rollback may replay it.
            for k in list(self._cache):
                if self._cache[k][0] != self.spec_epoch:
                    del self._cache[k]
                    self.evictions += 1
                    if len(self._cache) < self.CACHE:
                        break
        self._cache[height] = [self.spec_epoch, blk]
        return blk

    def value(self, height: int) -> bytes:
        """The proposal value for ``height`` — commits to the block
        content via its content digest (round-independent: retries
        re-propose the same block). Derived WITHOUT materializing the
        block: a pipelined proposer asks for values heights ahead of
        execution, and at 64k-tx blocks each materialization is
        milliseconds of column synthesis the value never needed."""
        v = self._values.get(height)
        if v is None:
            v = hashlib.sha256(
                b"exec-value" + self._content_digest(height)
            ).digest()
            while len(self._values) >= 4096:
                self._values.pop(next(iter(self._values)))
            self._values[height] = v
        return v

    def keyring(self):
        """Deterministic per-account Ed25519 keys (sign_txs mode)."""
        if self._ring is None:
            from hyperdrive_tpu_torch.crypto.keys import KeyRing

            self._ring = KeyRing.deterministic(
                self.config.accounts, namespace=b"exec-%d" % self.config.seed
            )
        return self._ring

    def sig_items(self, block: TxBlock) -> list:
        """The block's ``(pub, digest, sig)`` verifier triples, cached
        on the block. Only meaningful with ``sign_txs``."""
        if block._sig_items is not None:
            return block._sig_items
        cfg = self.config
        ring = self.keyring()
        bad = cfg.bad_sig_every
        sender = block.sender
        items = []
        for t in range(len(block)):
            kp = ring[sender[t]]
            digest = hashlib.sha256(
                b"exec-tx" + block.digest
                + t.to_bytes(4, "little")
            ).digest()
            sig = kp.sign_digest(digest)
            if bad and (t + 1) % bad == 0:
                # Deterministically corrupted lane: the mask must
                # reject it on every replica and both executors.
                sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
            items.append((kp.public, digest, sig))
        block._sig_items = items
        return items


class HostLedgerExecutor:
    """The reference executor: one ledger, blocks applied in height
    order with pure-Python two-pass semantics. ``advance_to(h)``
    applies every missing block in ``(height, h]`` (resync gaps catch
    up deterministically) and returns the chained root at ``h``;
    re-asking a settled height returns the cached root (crash-restore
    re-commits).

    ``masks`` is an optional SHARED ``height -> [bool]`` dict the sim's
    devsched launcher path fills (ExecApplyLauncher futures resolve
    into it); absent an entry, sign_txs blocks are verified host-side —
    same signatures, same verdict, so launcher and fallback paths are
    digest-identical.
    """

    def __init__(
        self,
        config: ExecutionConfig,
        genesis_stakes=(),
        source: BlockSource | None = None,
        masks: dict | None = None,
        obs=NULL_BOUND,
    ):
        cfg = config
        self.config = cfg
        self.source = source if source is not None else BlockSource(cfg)
        gs = list(genesis_stakes)
        if len(gs) > cfg.accounts:
            raise ValueError(
                f"{len(gs)} genesis stakes exceed {cfg.accounts} accounts"
            )
        gs += [0] * (cfg.accounts - len(gs))
        if any(s < 0 or s > _INT32_MAX for s in gs):
            raise ValueError("genesis stakes must fit int32")
        self._init_state([cfg.initial_balance] * cfg.accounts, gs)
        #: Last applied height; 0 = genesis (heights are 1-based).
        self.height = 0
        self.genesis_root = hashlib.sha256(
            b"exec-genesis" + self._state_bytes()
        ).digest()
        self.root = self.genesis_root
        #: The running root as uint32 words — the chain-fold input form
        #: (``root`` is its byte rendering; the device executor keeps
        #: the live copy on device and mirrors here at sync).
        self._root_words = root_words(self.genesis_root)
        #: height -> chained root, for every applied height.
        self.roots: dict[int, bytes] = {}
        self.applied_total = 0
        self.rejected_total = 0
        self.masks = masks
        self.obs = obs
        self._verifier = None
        # Cumulative int32 headroom: every block can move at most
        # txs_per_block * amount_cap units into one account.
        self._flow = cfg.initial_balance
        #: Open speculative heights: height -> [guess_mask, snapshot].
        #: Insertion order is height order (speculation only stacks).
        self._spec: dict[int, list] = {}
        #: Per-height applied counts for the OPEN window only, so a
        #: rollback can unwind the counters exactly.
        self._applied_at: dict[int, int] = {}
        #: Every root a rollback ever discarded: none may appear in a
        #: committed value.
        self.discarded_roots: set[bytes] = set()
        self.spec_confirmed = 0
        self.spec_rolled_back = 0
        #: Deepest single rollback (heights unwound in one mismatch).
        self.spec_rollback_depth = 0

    # ---- state representation (overridden by the device executor)

    def _init_state(self, balances, stakes):
        self.balances = balances
        self.stakes = stakes
        #: The account hash tree (ops/merkle.py numpy twin), updated
        #: in place along the dirty root-paths each block.
        self._tree = build_tree_np(balances, stakes)
        #: Post-block state digest of the last applied height — the
        #: O(1) witness words a proof carries (None until height 1).
        self._last_digest = None

    def _state_bytes(self) -> bytes:
        return pack_state(self.balances) + pack_state(self.stakes)

    def _apply_block(self, blk: TxBlock, ok) -> int:
        bal, stk = self.balances, self.stakes
        kind, sender, recipient, amount = blk._lists()
        out_bal: dict[int, int] = {}
        out_stk: dict[int, int] = {}
        for t in range(len(kind)):
            if ok is not None and not ok[t]:
                continue
            s, a = sender[t], amount[t]
            if kind[t] == KIND_UNSTAKE:
                out_stk[s] = out_stk.get(s, 0) + a
            else:
                out_bal[s] = out_bal.get(s, 0) + a
        # Solvency is a statement about the PRE-block snapshot (the
        # block-atomic rule): freeze the verdict per sender before any
        # mutation, or mid-block balances would re-order-couple the txs.
        sender_ok = {
            s: bal[s] >= out_bal.get(s, 0) and stk[s] >= out_stk.get(s, 0)
            for s in set(out_bal) | set(out_stk)
        }
        applied = 0
        for t in range(len(kind)):
            if ok is not None and not ok[t]:
                continue
            s = sender[t]
            if not sender_ok.get(s, True):
                continue
            k, a = kind[t], amount[t]
            if k == KIND_TRANSFER:
                bal[s] -= a
                bal[recipient[t]] += a
            elif k == KIND_STAKE:
                bal[s] -= a
                stk[s] += a
            else:
                stk[s] -= a
                bal[s] += a
            applied += 1
        return applied

    # ---- speculation hooks (overridden by the device executor)

    def _snapshot(self):
        """Pre-height state capture for rollback. Host: list copies
        (the tree's dirty-set snapshot rides along level by level).
        Device: tensor references (free; its steps are out of place)."""
        return (list(self.balances), list(self.stakes),
                self.root, self._root_words,
                [lvl.copy() for lvl in self._tree], self._last_digest)

    def _restore(self, snap) -> None:
        self.balances = list(snap[0])
        self.stakes = list(snap[1])
        self.root = snap[2]
        self._root_words = snap[3]
        # Copy again: the restored tree mutates in place from here, and
        # the snapshot may be re-read (a re-speculated window can roll
        # back twice against the same capture).
        self._tree = [lvl.copy() for lvl in snap[4]]
        self._last_digest = snap[5]

    def sync(self) -> None:
        """Materialize any device-pending roots/counters host-side.
        No-op on the host executor."""

    def _apply_chain(self, h: int, blk: TxBlock, ok):
        """Apply one block AND fold the new state into the running
        root. Returns the applied count, or None when the count is
        device-pending (materialized at :meth:`sync`)."""
        applied = self._apply_block(blk, ok)
        d = state_digest_np(self.balances, self.stakes)
        # Dirty set = the block's scatter targets verbatim (rejected
        # rows recompute clean leaves idempotently — same rule as the
        # device step, so the trees stay bit-identical).
        dirty = np.concatenate([blk._np[1], blk._np[2]])
        update_tree_np(self._tree, self.balances, self.stakes, dirty)
        folded = fold_merkle_np(d, merkle_root_np(self._tree))
        self._root_words = fold_root_np(self._root_words, h, folded)
        self.root = root_bytes(self._root_words)
        self.roots[h] = self.root
        self._last_digest = d
        return applied

    # ---- the public surface

    def advance_to(self, height: int) -> bytes:
        """Root at ``height``, applying any missing blocks up to it.

        Crosses an open speculation window only if every window height
        up to ``height`` is exact (unsigned guess): those are confirmed
        in passing, while a still-guessed height raises — commits must
        resolve speculation before they can read its root."""
        if self._spec and height >= min(self._spec):
            self.confirm_to(height)
        if height <= self.height:
            if height == 0:
                return self.genesis_root
            r = self.roots.get(height)
            if r is None:
                self.sync()
                r = self.roots[height]
            return r
        for h in range(self.height + 1, height + 1):
            self._step(h)
        self.sync()
        return self.root

    def _step(self, h: int, ok=_UNSET) -> None:
        cfg = self.config
        self._flow += cfg.txs_per_block * cfg.amount_cap
        if self._flow > _INT32_MAX:
            raise OverflowError(
                "cumulative block flow exceeds int32 headroom — lower "
                "amount_cap/initial_balance or widen the state"
            )
        blk = self.source.block(h)
        if ok is _UNSET:
            ok = self._mask_for(h, blk)
        applied = self._apply_chain(h, blk, ok)
        self.height = h
        if applied is None:
            return
        self.applied_total += applied
        self.rejected_total += len(blk) - applied
        if h in self._spec:
            self._applied_at[h] = applied
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "exec.apply", h, -1,
                "txs=%d applied=%d dev=0" % (len(blk), applied),
            )
            self.obs.emit("exec.root", h, -1, self.root[:8].hex())
            self.obs.emit(
                "merkle.root", h, -1,
                merkle_bytes(merkle_root_np(self._tree))[:8].hex(),
            )
            self.obs.emit(
                "merkle.update", h, -1,
                "targets=%d depth=%d full=0"
                % (2 * len(blk), tree_depth(self.config.accounts)),
            )

    # ---- speculative pipelining

    def speculate(self, height: int, guess=None) -> None:
        """Apply ``height`` NOW under a guessed admission mask (None =
        exact: every tx admitted, the unsigned semantics), snapshotting
        the pre-height state so :meth:`resolve` can roll back on a
        mismatch. Speculation stacks strictly upward."""
        if height != self.height + 1:
            raise ValueError(
                f"speculate({height}) out of order at height {self.height}"
            )
        snap = self._snapshot()
        self._spec[height] = [guess, snap]
        self._step(height, ok=guess)
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "exec.spec.speculate", height, -1,
                "signed=%d" % int(guess is not None),
            )

    def resolve(self, height: int, true_mask) -> bool:
        """Settle the LOWEST open speculation against the verified
        mask: confirm if the guess was right, otherwise roll back and
        re-apply (the later window heights re-speculate under their
        original guesses). Returns True on confirm."""
        ent = self._spec.get(height)
        if ent is None:
            raise KeyError(f"height {height} is not speculative")
        if height != min(self._spec):
            raise RuntimeError(
                f"resolve({height}) below open speculation at "
                f"{min(self._spec)}"
            )
        guess = ent[0]
        if guess is None or list(guess) == list(true_mask):
            self._confirm(height)
            return True
        self._rollback(height, true_mask)
        return False

    def confirm_to(self, height: int) -> None:
        """Confirm every exact (unsigned-guess) speculation up to
        ``height``; a still-guessed height in range raises."""
        for h in sorted(self._spec):
            if h > height:
                break
            if self._spec[h][0] is not None:
                raise RuntimeError(
                    f"confirm_to({height}): height {h} still awaits "
                    "signature verification"
                )
            self._confirm(h)

    def _confirm(self, height: int) -> None:
        self._spec.pop(height)
        self._applied_at.pop(height, None)
        self.spec_confirmed += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit("exec.spec.confirm", height, -1, "")

    def _rollback(self, height: int, true_mask) -> None:
        """The mismatch path: unwind state, root, and counters to the
        pre-``height`` snapshot bit-identically, record every discarded
        root, re-apply ``height`` under the TRUE mask (final), then
        re-speculate the rest of the window. A discarded root can never
        reach a committed value: commits only read roots through
        :meth:`advance_to`/:meth:`resolve`, both of which refuse
        unresolved guesses."""
        cfg = self.config
        self.sync()
        top = self.height
        depth = top - height + 1
        later = [
            (h, self._spec[h][0]) for h in sorted(self._spec) if h > height
        ]
        snap = self._spec.pop(height)[1]
        popped = []
        for h in range(height, top + 1):
            rb = self.roots.pop(h, None)
            if rb is not None:
                popped.append((h, rb))
            a = self._applied_at.pop(h, None)
            if a is not None:
                self.applied_total -= a
                self.rejected_total -= cfg.txs_per_block - a
            self._flow -= cfg.txs_per_block * cfg.amount_cap
            self._spec.pop(h, None)
        self._restore(snap)
        self.height = height - 1
        self.spec_rolled_back += 1
        self.spec_rollback_depth = max(self.spec_rollback_depth, depth)
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "exec.spec.rollback", height, -1, "depth=%d" % depth
            )
        self._step(height, ok=[bool(v) for v in true_mask])
        for h, g in later:
            self.speculate(h, g)
        # A guessed mask can differ from the true one yet settle to the
        # IDENTICAL state (the mis-admitted lane died to block-atomic
        # solvency either way): only a root the re-settled chain
        # actually replaced counts as discarded — those are the bytes
        # the no-leak invariant bans from every committed value.
        self.sync()
        for h, rb in popped:
            if self.roots.get(h) != rb:
                self.discarded_roots.add(rb)

    def host_verify(self) -> bytes:
        """Checkpoint re-derivation (ROBUSTNESS.md state-root
        doctrine): fetch the live state host-side, recompute the last
        chain fold with the numpy twin, and require it to equal the
        running root. Raises on mismatch; returns the verified root."""
        self.sync()
        if self.height == 0:
            want = self.genesis_root
        else:
            prev = (
                self.roots[self.height - 1]
                if self.height > 1 else self.genesis_root
            )
            d = state_digest_np(self.balances, self.stakes)
            # Full O(n) tree rebuild from fetched state: the
            # incrementally-maintained Merkle root must equal it, and
            # the chain fold must re-derive byte-for-byte.
            full = merkle_root_np(build_tree_np(self.balances, self.stakes))
            tree, _ = self._proof_materials()
            if merkle_bytes(full) != merkle_bytes(merkle_root_np(tree)):
                raise AssertionError(
                    f"incremental Merkle root diverged from full rebuild "
                    f"at height {self.height}"
                )
            want = root_bytes(
                fold_root_np(
                    root_words(prev), self.height, fold_merkle_np(d, full)
                )
            )
        if want != self.root:
            raise AssertionError(
                f"state-root checkpoint mismatch at height {self.height}"
            )
        return self.root

    # ---- inclusion proofs (the trustless read path)

    def _proof_materials(self):
        """(tree levels as numpy, last digest as numpy) — the device
        executor overrides to materialize its on-device copies."""
        return self._tree, self._last_digest

    def prove(self, account: int) -> MerkleProof:
        """O(log n) inclusion proof for ``account`` at the current
        settled height: leaf values, sibling path, and the O(1) chain
        witness (previous root + state digest) a stateless client
        needs to check it against a certificate-chain root with
        :meth:`verify_inclusion`. Proofs serve SETTLED chain only —
        an open speculation window refuses (its root could roll
        back)."""
        self.sync()
        if self._spec:
            raise RuntimeError(
                "prove() with an open speculation window — resolve "
                "speculation first (a speculative root may roll back)"
            )
        h = self.height
        if h < 1:
            raise ValueError("no applied height to prove against")
        if not 0 <= account < self.config.accounts:
            raise ValueError(
                f"account {account} outside 0..{self.config.accounts - 1}"
            )
        tree, digest = self._proof_materials()
        prev = self.roots[h - 1] if h > 1 else self.genesis_root
        return MerkleProof(
            height=h,
            account=account,
            balance=int(self.balances[account]),
            stake=int(self.stakes[account]),
            prev_root=prev,
            digest=tuple(int(w) for w in digest),
            siblings=prove_np(tree, account),
        )

    def proof_basis(self) -> "ProofBasis":
        """Freeze the current settled height into a :class:`ProofBasis`
        — an O(n) copy a proof-serving path (the JAX package's
        ``parallel/service.py``) takes ONCE per accepted certificate, so
        queries never touch the live executor (which may be speculated
        ahead of the last certified height by the time a query lands)."""
        self.sync()
        if self._spec:
            raise RuntimeError(
                "proof_basis() with an open speculation window — "
                "resolve speculation first"
            )
        h = self.height
        if h < 1:
            raise ValueError("no applied height to serve proofs from")
        tree, digest = self._proof_materials()
        prev = self.roots[h - 1] if h > 1 else self.genesis_root
        return ProofBasis(
            height=h,
            accounts=self.config.accounts,
            prev_root=prev,
            digest=tuple(int(w) for w in digest),
            tree=[np.array(lvl, copy=True) for lvl in tree],
            balances=[int(v) for v in self.balances],
            stakes=[int(v) for v in self.stakes],
        )

    #: The client-side check, re-exported so light clients and tests
    #: reach it without importing ops/ directly.
    verify_inclusion = staticmethod(verify_inclusion)

    def _mask_for(self, h: int, blk: TxBlock):
        if not self.config.sign_txs:
            return None
        if self.masks is not None:
            m = self.masks.get(h)
            if m is not None:
                return m
        if self._verifier is None:
            from hyperdrive_tpu_torch.verifier import HostVerifier

            self._verifier = HostVerifier()
        mask = self._verifier.verify_signatures(self.source.sig_items(blk))
        return [bool(v) for v in mask]

    def election_stakes(self, n: int) -> tuple:
        """What the epoch election reads at a boundary: the first ``n``
        stake accounts, floored so weight can hit the floor but a pool
        member never leaves candidacy (ROBUSTNESS.md)."""
        floor = self.config.stake_floor
        return tuple(int(self.stakes[i]) + floor for i in range(n))


class ProofBasis:
    """A frozen proof-serving snapshot of ONE settled height: the tree,
    leaf values, and O(1) chain witness (previous root + state digest),
    copied out of an executor by :meth:`HostLedgerExecutor.proof_basis`.
    Serving a proof from a basis is pure numpy indexing — O(log n), no
    executor locks, no interaction with speculation — so the service
    port can answer read storms while the executor runs ahead."""

    __slots__ = ("height", "accounts", "prev_root", "digest", "tree",
                 "balances", "stakes")

    def __init__(self, *, height, accounts, prev_root, digest, tree,
                 balances, stakes):
        self.height = height
        self.accounts = accounts
        self.prev_root = prev_root
        self.digest = digest
        self.tree = tree
        self.balances = balances
        self.stakes = stakes

    def prove(self, account: int) -> MerkleProof:
        """O(log n) inclusion proof for ``account`` at this basis's
        height — same shape :meth:`HostLedgerExecutor.prove` returns,
        minus any dependence on live executor state."""
        if not 0 <= account < self.accounts:
            raise ValueError(
                f"account {account} outside 0..{self.accounts - 1}"
            )
        return MerkleProof(
            height=self.height,
            account=account,
            balance=self.balances[account],
            stake=self.stakes[account],
            prev_root=self.prev_root,
            digest=self.digest,
            siblings=prove_np(self.tree, account),
        )


class ExecApplyLauncher(VerifyLauncher):
    """The ``exec.apply`` device-queue command: a block's tx-signature
    triples, coalesced by the SAME drain that carries vote verifies —
    grouped separately by launcher identity, so one drain cycle issues
    the vote launch and the exec launch back to back, and the block's
    admission mask resolves with the settle futures it shares a slot
    with. Mutation itself doesn't ride the queue: it is one call on the
    executor at commit time, already a single step."""

    kind = "exec.apply"
