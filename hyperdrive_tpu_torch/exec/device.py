"""The device executor: ledger state as int32 tensors on one device, the
block apply + state digest + Merkle update + root fold as ONE step of
PyTorch ops (``ops/ledger.py`` ``apply_block_chain_merkle_cols_torch``).

Root-identical to :class:`~hyperdrive_tpu_torch.exec.ledger
.HostLedgerExecutor` by construction — the device fold is the bit-exact
PyTorch twin of the numpy reduction in ``ops/rootmix.py`` and
``ops/merkle.py``.

Between heights NOTHING leaves the device: the running root rides as an
int64[8] tensor of uint32 words and per-height applied counts as int64
scalars, queued on ``_pending`` and materialized in one host copy per
pipeline window (:meth:`sync` — called by ``advance_to`` before a root
is read, and by rollback before counters unwind).

Port of the JAX package's ``exec/device.py``. Differences: the
executor lives on ``device`` (None: the card; it raises without CUDA
and never falls back to the host executor); and because PyTorch tensors
are mutable where JAX arrays are not, every step is computed out of
place (no tensor the executor holds is ever written), which is what
keeps a speculation snapshot — a tuple of tensor references, as in the
reference — valid through a double rollback. The ``obs=`` hook and its
``exec.apply`` / ``exec.root`` / ``merkle.*`` events at :meth:`sync` are
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor, TxBlock
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.ops import ledger as ops_ledger
from hyperdrive_tpu_torch.ops import merkle
from hyperdrive_tpu_torch.ops.rootmix import root_bytes

__all__ = ["DeviceLedgerExecutor"]


class DeviceLedgerExecutor(HostLedgerExecutor):
    """Ledger state lives on ``device`` between blocks; each height is
    one padded step (apply + digest + Merkle update + chain fold, pad
    rows inert) whose outputs — new state, new root, applied count —
    stay on the device until :meth:`sync`."""

    def __init__(self, config, genesis_stakes=(), source=None, masks=None,
                 obs=NULL_BOUND, device=None):
        self.device = merkle.resolve_device(device)
        super().__init__(config, genesis_stakes, source=source, masks=masks,
                         obs=obs)

    def _init_state(self, balances, stakes):
        def put(v):
            return torch.from_numpy(np.asarray(v, dtype=np.int32)).to(self.device)

        self._dbal = put(balances)
        self._dstk = put(stakes)
        #: Device-resident running root (int64[8] of uint32 words);
        #: created lazily at the first apply (genesis root is a host
        #: sha256).
        self._droot = None
        #: Heights applied but not yet materialized host-side:
        #: (height, root_words_tensor, applied_count_scalar).
        self._pending: list = []
        self._dmix = ops_ledger.mix_tensor(4 * self.config.accounts, self.device)
        #: Device-resident account hash tree (tuple of int64 levels) and
        #: the last post-block state digest, both updated inside the
        #: same step as the apply.
        self._dtree = None
        self._ddigest = None

    def _mask_for(self, h: int, blk: TxBlock):
        """A ``sign_txs`` height's admission mask, from ``masks`` only on
        a card: the host executor's fallback (verify the block on the
        CPU) would leave the card idle while its state waits there, so a
        CUDA executor without the height's mask raises. ``Simulation``
        fills ``masks`` through its batch verifier."""
        if (
            self.config.sign_txs
            and self.device.type != "cpu"
            and (self.masks is None or self.masks.get(h) is None)
        ):
            raise RuntimeError(
                f"no admission mask for sign_txs height {h}: a device "
                f"executor on {self.device} does not verify signatures on "
                "the host — pass masks= with each height's verdicts"
            )
        return super()._mask_for(h, blk)

    def _state_bytes(self) -> bytes:
        bal = self._dbal.cpu().numpy().astype("<i8")
        stk = self._dstk.cpu().numpy().astype("<i8")
        return bal.tobytes() + stk.tobytes()

    def _device_cols(self, blk: TxBlock) -> torch.Tensor:
        # The block as ONE packed [5, bucket] int32 tensor (kind, sender,
        # recipient, amount, sig_ok rows), cached ON the block: the copy
        # is block materialization, shared by every executor of the
        # source on this device and freed with the block by the source's
        # LRU (speculation-epoch entries are pinned, so rollback replays
        # hit it). The cached sig_ok row is the no-signature mask (real
        # rows 1, pad rows 0); signed runs repack per call.
        cols = blk._cols
        if cols is None or cols.device != self.device:
            cols = blk._cols = torch.from_numpy(
                ops_ledger.pack_block_cols(*blk._np)
            ).to(self.device)
        return cols

    def _ensure_chain(self) -> None:
        if self._droot is None:
            self._droot = torch.from_numpy(
                self._root_words.astype(np.int64)
            ).to(self.device)
        if self._dtree is None:
            self._dtree = merkle.build_tree_torch(self._dbal, self._dstk)

    def _apply_chain(self, h: int, blk: TxBlock, ok):
        if ok is not None:
            cols = torch.from_numpy(
                ops_ledger.pack_block_cols(*blk._np, sig_ok=ok)
            ).to(self.device)
        else:
            cols = self._device_cols(blk)
        self._ensure_chain()
        full = 2 * cols.shape[1] >= self._dtree[0].shape[0]
        (
            self._dbal, self._dstk, count, self._droot,
            self._ddigest, self._dtree,
        ) = ops_ledger.apply_block_chain_merkle_cols_torch(
            self._dbal, self._dstk, self._droot, self._dtree, h, cols,
            self._dmix,
        )
        self._pending.append(
            (h, self._droot, count, self._dtree[-1][0], full)
        )
        return None  # counters/roots materialize at sync()

    # ---- speculation hooks: snapshots are tensor references, which
    # stay valid because no step writes a tensor in place.

    def _snapshot(self):
        self._ensure_chain()
        return (self._dbal, self._dstk, self._droot,
                self._dtree, self._ddigest)

    def _restore(self, snap) -> None:
        (self._dbal, self._dstk, self._droot,
         self._dtree, self._ddigest) = snap

    def sync(self) -> None:
        """One host copy materializes every pending height's root and
        applied count — the only inter-height host hop the device path
        pays, once per pipeline window."""
        if not self._pending:
            return
        # One row a height: the 8 root words, the applied count, the 4
        # Merkle root words.
        fetched = torch.cat([
            torch.stack([p[1] for p in self._pending]),
            torch.stack([p[2] for p in self._pending])[:, None],
            torch.stack([p[3] for p in self._pending]),
        ], dim=1).cpu().numpy()
        t = self.config.txs_per_block
        depth = merkle.tree_depth(self.config.accounts)
        for (h, _, _, _, full), row in zip(self._pending, fetched):
            rb = root_bytes(row[:8].astype(np.uint32))
            self.roots[h] = rb
            c = int(row[8])
            self.applied_total += c
            self.rejected_total += t - c
            if h in self._spec:
                self._applied_at[h] = c
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "exec.apply", h, -1,
                    "txs=%d applied=%d dev=1" % (t, c),
                )
                self.obs.emit("exec.root", h, -1, rb[:8].hex())
                self.obs.emit(
                    "merkle.root", h, -1,
                    merkle.merkle_bytes(row[9:])[:8].hex(),
                )
                self.obs.emit(
                    "merkle.update", h, -1,
                    "targets=%d depth=%d full=%d"
                    % (2 * t, depth, int(full)),
                )
        self._pending.clear()
        self._root_words = fetched[-1, :8].astype(np.uint32)
        self.root = root_bytes(self._root_words)

    def _proof_materials(self):
        """Materialize the on-device tree and digest for proof serving —
        a read-path fetch, never on the apply path."""
        return (
            [lvl.cpu().numpy().astype(np.uint32) for lvl in self._dtree],
            self._ddigest.cpu().numpy().astype(np.uint32),
        )

    # Host views for election_stakes / proofs / debugging: materialize on
    # read.
    @property
    def balances(self):
        return self._dbal.cpu().numpy()

    @property
    def stakes(self):
        return self._dstk.cpu().numpy()
