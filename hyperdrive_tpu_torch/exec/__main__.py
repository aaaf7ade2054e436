"""Execution-layer smokes: device apply vs host reference parity.

Usage::

    python -m hyperdrive_tpu_torch.exec parity [--blocks H] [--accounts A]
        [--txs T] [--seed S] [--pipelined]
    python -m hyperdrive_tpu_torch.exec prove [--blocks H] [--accounts A]
        [--txs T] [--seed S]

Runs the SAME deterministic block workload through
:class:`~hyperdrive_tpu_torch.exec.ledger.HostLedgerExecutor` (pure-Python
two-pass reference) and :class:`~hyperdrive_tpu_torch.exec.device
.DeviceLedgerExecutor` (one padded segment-sum/scatter-add launch per
block, ops/ledger.py) and demands byte-equal chained state roots at
EVERY height — three legs:

  1. unsigned transfers + stake churn (the sim/chaos configuration),
  2. signed transactions with a deterministically corrupted lane every
     8th tx (the admission mask must reject identically on both),
  3. an insolvency-heavy leg (tiny balances) hammering the
     block-atomic sender-solvency rule where vectorized and serial
     semantics would first diverge if they could.

``prove`` is the Merkle proof-serving smoke: both executor classes
advance the same chain, every sampled account's inclusion proof must be
bit-identical across host and device, survive the wire codec
byte-for-byte, and verify against the chained root — and all four
forged-proof variants (stale previous root, forged sibling, truncated
path, wrong leaf) must fail verification on both.

``--pipelined`` adds a fourth leg exercising the speculative pipeline
end to end: every leg's config is replayed through speculate/resolve —
including a forced wrong-guess rollback per window — and the resulting
root chain must be byte-equal to the sequential ``advance_to`` chain,
with ``host_verify`` re-deriving the final fold from fetched state on
both executors (the state-root checkpoint doctrine, ROBUSTNESS.md).

Exit 1 on any root mismatch. Shapes are tiny. Both subcommands run the
device executor on ``--device``: the card by default, ``cpu`` for the
plain PyTorch steps; without CUDA they exit non-zero unless ``--device
cpu`` is given.

Port of the JAX package's ``exec/__main__.py``: the same subcommands,
flags and lines. Deliberate differences: the ``--device`` option; no
compilation-cache environment defaults (nothing here is jitted); no
runtime sanitizer (``HD_SANITIZE``; the port drops the lint hooks); and
the signed legs' admission. A device executor on the card verifies no
signature on the host, so each signed leg verifies its blocks with a
``TorchBatchVerifier`` on ``--device`` (row 1, ``ed25519_verify``), one
call a block as ``Simulation`` does for its executors, and hands the
same ``masks`` to the host and the device executor: both apply one
admission. Since one mask feeds both sides, ``parity`` first holds it to
the workload itself: it must reject exactly the corrupted lanes (every
``bad_sig_every``-th) and admit every other, or the run fails. The two
signed legs share one config, so they share those masks. The
reference's host executor verifies with its ``HostVerifier``, which
gives the same verdicts.
"""

from __future__ import annotations

import argparse
import sys

from hyperdrive_tpu_torch.utils.cli import add_device_arg, require_device


def _signed_masks(cfg, blocks: int, verifier) -> "dict | None":
    """``height -> [bool]`` admission masks of a ``sign_txs`` config's
    first ``blocks`` blocks, one ``verifier`` call a block (None for an
    unsigned config)."""
    from hyperdrive_tpu_torch.exec.ledger import BlockSource

    if not cfg.sign_txs:
        return None
    src = BlockSource(cfg)
    return {
        h: [bool(b) for b in verifier.verify_signatures(src.sig_items(src.block(h)))]
        for h in range(1, blocks + 1)
    }


def _leg(name: str, cfg, genesis_stakes, blocks: int, device,
         masks=None) -> int:
    from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
    from hyperdrive_tpu_torch.exec.ledger import BlockSource, HostLedgerExecutor

    src = BlockSource(cfg)
    host = HostLedgerExecutor(cfg, genesis_stakes, source=src, masks=masks)
    dev = DeviceLedgerExecutor(cfg, genesis_stakes, source=src, masks=masks,
                               device=device)
    if host.genesis_root != dev.genesis_root:
        print(f"FAIL {name}: genesis roots differ", file=sys.stderr)
        return 1
    for h in range(1, blocks + 1):
        hr = host.advance_to(h)
        dr = dev.advance_to(h)
        if hr != dr:
            print(
                f"FAIL {name}: root mismatch at height {h}: "
                f"host={hr.hex()[:16]} device={dr.hex()[:16]}",
                file=sys.stderr,
            )
            return 1
    if host.applied_total != dev.applied_total:
        print(
            f"FAIL {name}: applied counts differ "
            f"({host.applied_total} != {dev.applied_total})",
            file=sys.stderr,
        )
        return 1
    print(
        f"ok {name}: {blocks} blocks, roots identical, "
        f"applied={host.applied_total} rejected={host.rejected_total}"
    )
    return 0


def _pipelined_leg(name: str, cfg, genesis_stakes, blocks: int, device,
                   masks=None) -> int:
    """Speculative-pipeline parity: each executor class speculates a
    window per height — first with a deliberately WRONG guess (forcing
    a rollback) where the block has rows to mis-admit, then resolves
    with the true mask — and the settled chain must equal the
    sequential reference chain byte for byte. ``masks``: a signed
    config's verified admission masks (:func:`_signed_masks`)."""
    from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
    from hyperdrive_tpu_torch.exec.ledger import BlockSource, HostLedgerExecutor

    src = BlockSource(cfg)
    ref = HostLedgerExecutor(cfg, genesis_stakes, source=src, masks=masks)
    seq = [ref.advance_to(h) for h in range(1, blocks + 1)]

    if cfg.sign_txs:
        def true_mask(h):
            return list(masks[h])
    else:
        def true_mask(h):
            return [True] * cfg.txs_per_block

    rollbacks = 0
    for cls, kw in ((HostLedgerExecutor, {}),
                    (DeviceLedgerExecutor, {"device": device})):
        ex = cls(cfg, genesis_stakes, source=src, masks=masks, **kw)
        for h in range(1, blocks + 1):
            m = true_mask(h)
            guess = list(m)
            if h % 2 and any(guess):
                # Force a mismatch: flip one admitted lane.
                guess[guess.index(True)] = False
            ex.speculate(h, guess)
            if not ex.resolve(h, m):
                rollbacks += 1
        got = [ex.advance_to(h) for h in range(1, blocks + 1)]
        if got != seq:
            bad = next(h for h in range(blocks) if got[h] != seq[h])
            print(
                f"FAIL {name}: pipelined root diverges from sequential "
                f"at height {bad + 1} ({cls.__name__})",
                file=sys.stderr,
            )
            return 1
        if ex.applied_total != ref.applied_total:
            print(
                f"FAIL {name}: pipelined applied count "
                f"{ex.applied_total} != {ref.applied_total} "
                f"({cls.__name__})",
                file=sys.stderr,
            )
            return 1
        if ex.discarded_roots & set(seq):
            print(
                f"FAIL {name}: a rolled-back root equals a committed "
                f"root ({cls.__name__})",
                file=sys.stderr,
            )
            return 1
        ex.host_verify()
    print(
        f"ok {name}: {blocks} blocks pipelined == sequential, "
        f"{rollbacks} forced rollbacks, checkpoints verified"
    )
    return 0


def parity(args) -> int:
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    device = require_device(args.device)
    signed = ExecutionConfig(
        accounts=min(args.accounts, 16),
        txs_per_block=min(args.txs, 24),
        stake_every=4,
        stake_accounts=4,
        seed=args.seed + 1,
        sign_txs=True,
        bad_sig_every=8,
    )
    masks = _signed_masks(signed, min(args.blocks, 3),
                         TorchBatchVerifier(device=device))
    for h, mask in masks.items():
        # sig_items corrupts exactly every bad_sig_every-th lane.
        want = [(t + 1) % signed.bad_sig_every != 0 for t in range(len(mask))]
        if mask != want:
            print(
                f"FAIL exec-signed: the verifier's admission mask at height "
                f"{h} is {mask}, want {want}",
                file=sys.stderr,
            )
            return 1
    rc = 0
    rc |= _leg(
        "exec-apply",
        ExecutionConfig(
            accounts=args.accounts,
            txs_per_block=args.txs,
            stake_every=3,
            stake_accounts=min(4, args.accounts),
            seed=args.seed,
        ),
        (5, 9, 2, 7),
        args.blocks,
        device,
    )
    rc |= _leg("exec-signed", signed, (3, 3, 3, 3), min(args.blocks, 3),
               device, masks)
    rc |= _leg(
        "exec-insolvent",
        ExecutionConfig(
            accounts=args.accounts,
            txs_per_block=args.txs,
            stake_every=2,
            stake_accounts=min(4, args.accounts),
            seed=args.seed + 2,
            amount_cap=64,
            initial_balance=40,
        ),
        (1, 0, 2, 0),
        args.blocks,
        device,
    )
    if getattr(args, "pipelined", False):
        rc |= _pipelined_leg(
            "exec-pipelined",
            ExecutionConfig(
                accounts=args.accounts,
                txs_per_block=args.txs,
                stake_every=3,
                stake_accounts=min(4, args.accounts),
                seed=args.seed,
            ),
            (5, 9, 2, 7),
            args.blocks,
            device,
        )
        rc |= _pipelined_leg("exec-pipelined-signed", signed, (3, 3, 3, 3),
                             min(args.blocks, 3), device, masks)
    return rc


def prove(args) -> int:
    """Proof-serving smoke: host/device proof parity, codec roundtrip,
    chained-root verification, and the four forged variants all
    rejected — the CI vehicle for the trustless-read surface."""
    import dataclasses

    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
    from hyperdrive_tpu_torch.exec.ledger import BlockSource, HostLedgerExecutor
    from hyperdrive_tpu_torch.parallel.service import (
        STATUS_COMMITTED,
        decode_proof,
        encode_proof,
    )

    cfg = ExecutionConfig(
        accounts=args.accounts,
        txs_per_block=args.txs,
        stake_every=3,
        stake_accounts=min(4, args.accounts),
        seed=args.seed,
    )
    device = require_device(args.device)
    src = BlockSource(cfg)
    host = HostLedgerExecutor(cfg, source=src)
    dev = DeviceLedgerExecutor(cfg, source=src, device=device)
    for ex in (host, dev):
        ex.advance_to(args.blocks)
    if host.root != dev.root:
        print("FAIL prove: host/device root mismatch", file=sys.stderr)
        return 1
    root = host.roots[args.blocks]
    sample = sorted({0, args.accounts // 2, args.accounts - 1})
    for account in sample:
        hp, dp = host.prove(account), dev.prove(account)
        if hp != dp:
            print(
                f"FAIL prove: host/device proof mismatch for account "
                f"{account}",
                file=sys.stderr,
            )
            return 1
        _, _, wired = decode_proof(
            encode_proof(1, STATUS_COMMITTED, hp)
        )
        if wired != hp:
            print(
                f"FAIL prove: proof frame for account {account} did "
                f"not roundtrip the wire codec",
                file=sys.stderr,
            )
            return 1
        if not host.verify_inclusion(
            root, account, wired.balance, wired.stake, wired
        ):
            print(
                f"FAIL prove: honest proof for account {account} "
                f"failed verification",
                file=sys.stderr,
            )
            return 1
    victim = host.prove(sample[-1])
    forgeries = {
        "stale-root": dataclasses.replace(
            victim, prev_root=b"\x01" * 32
        ),
        "forged-sibling": dataclasses.replace(
            victim, siblings=((1, 2, 3, 4),) + victim.siblings[1:]
        ),
        "truncated-path": dataclasses.replace(
            victim, siblings=victim.siblings[:-1]
        ),
        "wrong-leaf": dataclasses.replace(
            victim, balance=victim.balance + 1
        ),
    }
    for name, bad in forgeries.items():
        if host.verify_inclusion(
            root, bad.account, bad.balance, bad.stake, bad
        ):
            print(
                f"FAIL prove: {name} forgery verified", file=sys.stderr
            )
            return 1
    print(
        f"ok prove: {args.blocks} blocks, {len(sample)} accounts "
        f"host==device, codec roundtrip, root verification, "
        f"{len(forgeries)} forgeries rejected "
        f"(depth={len(victim.siblings)})"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyperdrive_tpu_torch.exec")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "parity",
        help="device batched apply vs host reference executor: chained "
        "state roots must be byte-equal at every height",
    )
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--accounts", type=int, default=32)
    p.add_argument("--txs", type=int, default=48)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument(
        "--pipelined", action="store_true",
        help="add the speculative-pipeline legs: forced-rollback "
        "speculate/resolve chains must equal the sequential chains, "
        "host_verify checkpoints included",
    )
    add_device_arg(p)
    p.set_defaults(fn=parity, label="parity")

    p = sub.add_parser(
        "prove",
        help="Merkle proof-serving smoke: host/device proof parity, "
        "wire-codec roundtrip, chained-root verification, all four "
        "forged variants rejected",
    )
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--accounts", type=int, default=32)
    p.add_argument("--txs", type=int, default=24)
    p.add_argument("--seed", type=int, default=7)
    add_device_arg(p)
    p.set_defaults(fn=prove, label="prove")

    args = ap.parse_args(argv)
    rc = args.fn(args)
    if rc == 0:
        print(f"exec {args.label} ok")
    else:
        print(f"exec {args.label} FAILED", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
