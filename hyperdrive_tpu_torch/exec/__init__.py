"""Execution layer: a deterministic replicated account/stake ledger.

Every committed height carries a deterministic transaction block;
applying it is one padded step of PyTorch ops (``ops/ledger.py`` —
signature checks ride the batch-verify drain through
:class:`ExecApplyLauncher` or the vote launcher itself, balance and
stake mutations are one segment-sum/scatter-add program), and the
resulting state root is chained into the commit value, so the commit
digest covers the world state, not just the agreed bytes.

Port of the JAX package's ``exec/``: ``ledger.py`` (blocks, the host
reference executor, proofs) and ``device.py`` (the device executor, on
the card unless the caller passes ``device="cpu"``), and the CLI
``python -m hyperdrive_tpu_torch.exec`` (``parity``/``prove``).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "ExecutionConfig",
    "BlockSource",
    "HostLedgerExecutor",
    "ExecApplyLauncher",
    "DeviceLedgerExecutor",
]


@dataclass(frozen=True)
class ExecutionConfig:
    """One execution-layer deployment, fully determined by these ints,
    so a run re-derives the identical ledger trajectory with no stored
    state.

    ``accounts`` is the ledger width; accounts ``0..stake_accounts-1``
    double as the validator stake accounts the epoch elections read
    (the sim pins ``stake_accounts = n``). ``stake_every`` routes every
    K-th transaction to the stake lane (STAKE/UNSTAKE on a validator
    account); 0 disables stake churn. ``sign_txs`` attaches real
    Ed25519 signatures per transaction (checked through the batch
    verifier / devsched drain); ``bad_sig_every`` corrupts every K-th
    signature so the mask visibly rejects lanes. ``stake_floor`` is the
    election-time floor added to every ledger stake, so full unstaking
    reduces weight but never ejects a pool member from candidacy.
    ``device`` selects the device executor over the host reference
    executor (root-identical either way).
    """

    accounts: int = 64
    txs_per_block: int = 32
    stake_every: int = 4
    stake_accounts: int = 0
    seed: int = 0
    amount_cap: int = 128
    initial_balance: int = 1_000_000
    sign_txs: bool = False
    bad_sig_every: int = 0
    stake_floor: int = 1
    device: bool = False

    def __post_init__(self):
        if self.accounts < 1:
            raise ValueError("accounts must be >= 1")
        if self.txs_per_block < 1:
            raise ValueError("txs_per_block must be >= 1")
        if self.amount_cap < 1:
            raise ValueError("amount_cap must be >= 1")
        if self.stake_accounts < 0 or self.stake_accounts > self.accounts:
            raise ValueError("stake_accounts must be in [0, accounts]")
        if self.stake_floor < 0:
            raise ValueError("stake_floor must be >= 0")
        # int32 headroom: one block's worst-case inflow into a single
        # account on top of the seeded balance must not wrap. The
        # executor re-asserts the cumulative bound as blocks land.
        if (
            self.initial_balance + self.txs_per_block * self.amount_cap
            >= 2**31
        ):
            raise ValueError(
                "initial_balance + txs_per_block * amount_cap must stay "
                "below 2**31 (int32 device state)"
            )

    def as_ints(self) -> tuple:
        """The eleven fields as ints, in declaration order (the JAX
        package's record-trailer encoding)."""
        return (
            self.accounts,
            self.txs_per_block,
            self.stake_every,
            self.stake_accounts,
            self.seed,
            self.amount_cap,
            self.initial_balance,
            int(self.sign_txs),
            self.bad_sig_every,
            self.stake_floor,
            int(self.device),
        )

    @classmethod
    def from_ints(cls, vals) -> "ExecutionConfig":
        vals = tuple(int(v) for v in vals)
        if len(vals) != 11:
            raise ValueError(
                f"execution trailer has {len(vals)} fields, expected 11"
            )
        return cls(
            accounts=vals[0],
            txs_per_block=vals[1],
            stake_every=vals[2],
            stake_accounts=vals[3],
            seed=vals[4],
            amount_cap=vals[5],
            initial_balance=vals[6],
            sign_txs=bool(vals[7]),
            bad_sig_every=vals[8],
            stake_floor=vals[9],
            device=bool(vals[10]),
        )


def __getattr__(name):
    # Lazy re-exports: ``exec.ledger`` imports ExecutionConfig from here.
    if name in ("BlockSource", "HostLedgerExecutor", "ExecApplyLauncher"):
        from hyperdrive_tpu_torch.exec import ledger

        return getattr(ledger, name)
    if name == "DeviceLedgerExecutor":
        from hyperdrive_tpu_torch.exec import device

        return device.DeviceLedgerExecutor
    raise AttributeError(name)
