"""The chaos soak CLI.

Usage::

    python -m hyperdrive_tpu_torch.chaos soak [--scenarios N] [--seed S]
        [--n N_REPLICAS] [--target H] [--out DIR] [--replay-every K]
        [--pipelined-every K] [--certs-every K] [--bls-certs-every K]
        [--churn-every K] [--overload-every K] [--overlay-every K]
        [--tenants-every K] [--exec-every K] [--exec-pipeline-every K]
        [--proofs-every K] [--fuzz-frames-every K] [--metrics-every K]
        [--campaign-every K] [--dump-ok DIR] [--keep-going] [--device D]
    python -m hyperdrive_tpu_torch.chaos replay DUMP.bin [--device D]

``soak`` runs N seeded scenarios — each a fresh
:meth:`~hyperdrive_tpu_torch.chaos.plan.FaultPlan.seeded` draw (partition of
up to f replicas with a heal, one crash-restart, a few lossy links) —
under the :class:`~hyperdrive_tpu_torch.chaos.monitor.InvariantMonitor`. Any
violation dumps the ScenarioRecord, the obs journal, and the victims'
checkpoints into ``--out`` and exits 1; the printed ``replay`` command
reproduces the failure message-for-message. Every ``--replay-every``-th
passing scenario is also replayed from its own record as a determinism
self-check.

Scenarios run unsigned (values are opaque digests; signature checking is
orthogonal to fault handling). The BLS certificates of ``--bls-certs-every``
are minted and light-client checked on the pure-Python host reference
(:mod:`..crypto.bls`). HD_SANITIZE=1 in the environment arms the runtime
sanitizer on every replica and flusher; CI runs the soak that way.

Port of the JAX package's ``chaos/__main__.py``: the same subcommands,
flags, lines, dumps and exit codes for the same argv; a port dump replays
here and in the reference, and so does a reference dump. Deliberate
differences:

- ``--device`` (the card by default, ``cpu`` for the plain versions) on
  ``soak`` and ``replay``. Three legs reach the port's device work, which
  the reference's host classes do on the host: ``--exec-pipeline-every``
  verifies its forged transaction signatures with the sim's verifier
  (``TorchBatchVerifier`` on the card, row 1, ``ed25519_verify``),
  ``--bls-certs-every``'s overlay leg folds its BLS partial aggregates
  through a ``G1SumLauncher`` behind a device queue on the card (row 5,
  ``g1_aggregate``), and ``--exec-every`` builds its executors through the
  execution layer, which resolves the device. Only when one of them is on
  (or ``replay`` meets an execution record) is ``--device`` resolved: a
  CUDA device without CUDA then ends the command with exit code 1 and a
  message, never a fallback. Every other leg runs on a host without CUDA.
- ``reproduce:`` lines name ``python -m hyperdrive_tpu_torch.chaos`` (and
  ``...campaign``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import sys

from hyperdrive_tpu_torch.chaos.monitor import InvariantMonitor, InvariantViolation
from hyperdrive_tpu_torch.chaos.plan import FaultPlan
from hyperdrive_tpu_torch.harness.sim import ScenarioRecord, Simulation
from hyperdrive_tpu_torch.utils.cli import add_device_arg, require_device

#: Spread scenario seeds so adjacent indices explore unrelated plans.
_SEED_STRIDE = 9973


def _build(scen_seed: int, n: int, target: int, pipelined: bool = False,
           certificates: bool = False, bls_certificates: bool = False,
           load=None):
    plan = FaultPlan.seeded(scen_seed, n)
    extra = {}
    if certificates:
        extra["certificates"] = True
    if bls_certificates:
        extra["bls_certificates"] = True
    if load is not None:
        extra["load"] = load
    if pipelined:
        # Queue-backed settle path: every replica flushes through one
        # shared async device-work queue (a QueueFlusher over a
        # NullVerifier), so faults land with coalesced settles in
        # flight. Still unsigned and host only: only the schedule moves.
        from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
        from hyperdrive_tpu_torch.verifier import NullVerifier

        queue = DeviceWorkQueue(max_depth=8)
        extra = dict(
            devsched=queue,
            flusher_for=lambda i, validators: QueueFlusher(
                NullVerifier(), queue
            ),
        )
    sim = Simulation(
        n=n,
        target_height=target,
        seed=scen_seed,
        timeout=1.0,
        # The reference harness paces deliveries at 1 ms
        # (replica_test.go:291); partitions need the pacing to engage.
        delivery_cost=1e-3,
        chaos=plan,
        observe=True,
        **extra,
    )
    return plan, sim


def _build_churn(scen_seed: int, n: int, target: int):
    """An epoch-churn scenario: short epochs with a ~25% membership
    swap + one key rotation per boundary, under a churn-shaped fault
    plan (partition spanning a boundary, crash-restore inside it,
    laggards rejoining under rotated keys). Certificates are on so the
    epoch-proof chain is minted and the monitor can verify it
    end-to-end; the target guarantees >= 3 boundary crossings."""
    from hyperdrive_tpu_torch.epochs import EpochConfig

    plan = FaultPlan.churn(scen_seed, n)
    epoch_length = 2
    committee = max(3, (3 * n) // 4)
    target = max(target, 3 * epoch_length + 1)
    sim = Simulation(
        n=n,
        target_height=target,
        seed=scen_seed,
        timeout=1.0,
        delivery_cost=1e-3,
        chaos=plan,
        observe=True,
        certificates=True,
        epochs=EpochConfig(
            epoch_length=epoch_length,
            committee_size=committee,
            rekey_per_epoch=1,
        ),
    )
    return plan, sim


def _build_exec_churn(scen_seed: int, n: int, target: int, device=None):
    """An execution-churn scenario: stake-churn transactions mutate the
    replicated ledger while short epochs elect committees FROM that
    stake, under the churn fault plan (partition spanning a boundary,
    crash-restore inside it, laggards rejoining under rotated keys).
    The monitor's exec invariants are armed — state-root agreement at
    every committed height plus commit/ledger binding — and the leg
    adds a record-replay determinism self-check that must reproduce the
    identical root-extended chain from the dump alone. Host executors,
    built by the execution layer on ``device``."""
    from hyperdrive_tpu_torch.epochs import EpochConfig
    from hyperdrive_tpu_torch.exec import ExecutionConfig

    plan = FaultPlan.churn(scen_seed, n)
    epoch_length = 2
    committee = max(3, (3 * n) // 4)
    target = max(target, 3 * epoch_length + 1)
    sim = Simulation(
        n=n,
        target_height=target,
        seed=scen_seed,
        timeout=1.0,
        delivery_cost=1e-3,
        chaos=plan,
        observe=True,
        certificates=True,
        epochs=EpochConfig(
            epoch_length=epoch_length,
            committee_size=committee,
            rekey_per_epoch=1,
        ),
        execution=ExecutionConfig(
            accounts=max(2 * n, 16),
            txs_per_block=64,
            stake_every=2,
            seed=scen_seed,
        ),
        device=device,
    )
    return plan, sim


def _build_exec_pipeline(scen_seed: int, n: int, target: int,
                         speculate: bool, device=None):
    """A speculative-execution-pipeline scenario: signed
    transaction blocks with forged-but-well-formed signatures (every
    K-th sig byte-flipped, still 64 bytes — so the well-formedness
    guess ADMITS the lane and verification then rejects it) applied
    speculatively through a shared devsched queue, under the churn
    fault plan's partition + crash-restore — faults land inside open
    speculation windows. Every resolved window mismatches, so the
    rollback path runs constantly; the monitor's no-rolled-back-root-
    committed invariant is armed with real discarded roots to audit.
    ``speculate=False`` builds the sequential settle-then-execute twin
    (same config, no queue) the digest cross-check holds the pipelined
    chain to. Host executors and the QueueFlusher's NullVerifier settle
    the votes; the transaction signatures are verified on ``device`` (the
    sim's ``TorchBatchVerifier`` on the card, the host verifier with
    ``device="cpu"``)."""
    from hyperdrive_tpu_torch.exec import ExecutionConfig

    plan = FaultPlan.churn(scen_seed, n)
    extra = {}
    if speculate:
        from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
        from hyperdrive_tpu_torch.verifier import NullVerifier

        queue = DeviceWorkQueue(max_depth=8)
        extra = dict(
            devsched=queue,
            flusher_for=lambda i, validators: QueueFlusher(
                NullVerifier(), queue
            ),
            exec_speculate=True,
        )
    sim = Simulation(
        n=n,
        target_height=target,
        seed=scen_seed,
        timeout=1.0,
        delivery_cost=1e-3,
        chaos=plan,
        observe=True,
        execution=ExecutionConfig(
            accounts=max(2 * n, 16),
            txs_per_block=12,
            stake_every=4,
            seed=scen_seed,
            sign_txs=True,
            bad_sig_every=5,
        ),
        device=device,
        **extra,
    )
    return plan, sim


def _build_overlay(scen_seed: int, n: int, target: int):
    """An aggregation-overlay scenario: the full tree-slicing fault
    family (partition cutting a level block, Byzantine contributors
    withholding/garbling frames, an interior-node crash-restore) on top
    of the overlay dissemination path. The monitor's overlay invariants
    are armed: commit safety, no honest peer still demoted at run end,
    and never-starve (exhausted windows must have engaged the ranked
    fallback)."""
    from hyperdrive_tpu_torch.overlay import OverlayConfig

    plan, faults = FaultPlan.overlay(scen_seed, n)
    sim = Simulation(
        n=n,
        target_height=target,
        seed=scen_seed,
        timeout=1.0,
        delivery_cost=1e-3,
        chaos=plan,
        observe=True,
        overlay=OverlayConfig(faults=faults),
    )
    return plan, faults, sim


def _bls_overlay_probe(scen_seed: int, args, device) -> int:
    """The overlay leg of the BLS spot-check: the tree-slicing fault
    family with real BLS partial aggregates riding every frame (folded
    through a G1SumLauncher on the card, on the host with
    ``device="cpu"``), held to the armed monitor plus a
    digest-neutrality cross-check, then a DETERMINISTIC merge-level
    probe — replay a real frame with its aggregate corrupted and
    require the runtime to charge the contributor and refuse the merge
    before any coverage (or batch verify) happens. Returns the count of
    organically-rejected Byzantine aggregates."""
    from hyperdrive_tpu_torch.overlay import OverlayConfig, OverlayFrame

    on = args.n if args.n else 8
    plan, faults = FaultPlan.overlay(scen_seed, on)
    fsim = Simulation(
        n=on, target_height=args.target, seed=scen_seed, timeout=1.0,
        delivery_cost=1e-3, chaos=plan, observe=True,
        overlay=OverlayConfig(faults=faults, bls_partials=True),
        device=device,
    )
    fmon = InvariantMonitor(fsim)
    fresult = fsim.run(max_steps=args.max_steps)
    fmon.check_final(fresult)
    bsim = Simulation(
        n=on, target_height=args.target, seed=scen_seed, timeout=1.0,
        delivery_cost=1e-3,
    )
    bresult = bsim.run(max_steps=args.max_steps)
    csim = Simulation(
        n=on, target_height=args.target, seed=scen_seed, timeout=1.0,
        delivery_cost=1e-3, overlay=OverlayConfig(bls_partials=True),
        device=device,
    )
    cresult = csim.run(max_steps=args.max_steps)
    if (cresult.commit_digest(up_to=args.target)
            != bresult.commit_digest(up_to=args.target)):
        raise InvariantViolation(
            "bls-overlay",
            "BLS-partial overlay chain diverges from all-to-all baseline",
        )
    rt = fsim._overlay
    src, slot, st, to = 0, None, None, None
    for sl, s in rt._slots.items():
        if not s.bls:
            continue
        r = next(
            (i for i in range(on)
             if (s.all_mask & ~s.cov[i]) and i != src), None,
        )
        if r is not None:
            slot, st, to = sl, s, r
            break
        if slot is None:
            # Fallback target if every slot fully propagated: the
            # reject/charge half of the probe still runs; only the
            # coverage-unchanged half becomes vacuous.
            slot, st, to = sl, s, 1
    if slot is None:
        raise InvariantViolation(
            "bls-overlay", "faulted run produced no BLS partials"
        )
    mask = st.all_mask
    good = rt._bls_masked_sum(st, mask, 0, 0)
    bad = bytes([good[0] ^ 0x01]) + good[1:]
    rejects = rt.bls_partial_rejects
    invalid = rt.scores.charges["invalid"]
    cov = st.cov[to]
    rt.on_frame(to, OverlayFrame(src, slot, 0, mask, agg=bad))
    if rt.bls_partial_rejects != rejects + 1:
        raise InvariantViolation(
            "bls-overlay", "corrupted aggregate survived the merge check"
        )
    if rt.scores.charges["invalid"] != invalid + 1:
        raise InvariantViolation(
            "bls-overlay", "merge-level reject did not charge the sender"
        )
    if st.cov[to] != cov:
        raise InvariantViolation(
            "bls-overlay", "coverage merged despite a corrupted aggregate"
        )
    if mask & ~cov:
        rt.on_frame(to, OverlayFrame(src, slot, 0, mask, agg=good))
        if st.cov[to] == cov:
            raise InvariantViolation(
                "bls-overlay", "honest aggregate failed to merge after probe"
            )
    return rejects


def _tenant_service_probe(scen_seed: int) -> dict:
    """The multi-tenant serving fault family (host only): three tenants
    share one continuously-batching ShardVerifyService under a
    DeficitRoundRobin drain policy while (a) one tenant firehoses the
    queue with wide windows and deep inflight, and (b) another drops
    off the drive loop for a seeded partition window. Invariants:

    - the WITNESS tenant (neither overloaded nor partitioned) and the
      healed partitioned tenant commit chains byte-identical to clean
      solo runs on dedicated services — a neighbor's overload or outage
      must never move a third tenant's digests;
    - the fairness starvation bound holds
      (:meth:`InvariantMonitor.check_tenant_fairness`) AND was actually
      exercised — a leg whose firehose never forced a deferral proves
      nothing.
    """
    from hyperdrive_tpu_torch.devsched import DeficitRoundRobin
    from hyperdrive_tpu_torch.parallel.service import (
        ShardVerifyService,
        TenantShard,
    )
    from hyperdrive_tpu_torch.verifier import NullVerifier

    rng = random.Random(scen_seed * _SEED_STRIDE + 7)
    heights = 12
    policy = DeficitRoundRobin(
        capacity_rows=16, quantum_rows=4, starve_after=3
    )
    svc = ShardVerifyService(NullVerifier(), max_depth=0, policy=policy)
    fire = TenantShard(
        "firehose", n_validators=16, target_height=heights, sign=False
    ).attach_local(svc)
    part = TenantShard(
        "partitioned", n_validators=4, target_height=heights, sign=False
    ).attach_local(svc)
    wit = TenantShard(
        "witness", n_validators=4, target_height=heights, sign=False
    ).attach_local(svc)
    p0 = rng.randrange(1, 5)
    p1 = p0 + rng.randrange(3, 9)
    step = 0
    while not (fire.done and part.done and wit.done):
        fire.pump(max_inflight=8)
        if not (p0 <= step < p1):
            part.pump(max_inflight=1)
        wit.pump(max_inflight=1)
        svc.drain()
        step += 1
        if step > 10_000:
            raise InvariantViolation(
                "tenant-liveness",
                f"tenants stalled: firehose={len(fire.commits)} "
                f"partitioned={len(part.commits)} "
                f"witness={len(wit.commits)} of {heights}",
            )
    InvariantMonitor.check_tenant_fairness(policy)
    if not policy.deferred_total:
        raise InvariantViolation(
            "tenant-fairness",
            "firehose never forced a deferral — the leg did not "
            "exercise the drain policy",
        )
    for shard, nv in ((part, 4), (wit, 4)):
        solo_svc = ShardVerifyService(NullVerifier(), max_depth=0)
        solo = TenantShard(
            shard.name, n_validators=nv, target_height=heights,
            sign=False,
        ).attach_local(solo_svc)
        while not solo.done:
            solo.pump(max_inflight=1)
            solo_svc.drain()
        if shard.commit_digest() != solo.commit_digest():
            raise InvariantViolation(
                "tenant-digest",
                f"tenant {shard.name} diverged from its clean solo run "
                f"under a neighbor's overload/partition",
            )
        if shard.rejected:
            raise InvariantViolation(
                "tenant-digest",
                f"tenant {shard.name} had {shard.rejected} rejected "
                f"commits under a neighbor's faults",
            )
    return {
        "deferred": policy.deferred_total,
        "forced": policy.forced_total,
        "max_deferrals": policy.max_deferrals,
        "launches": svc.queue.launches,
        "partition": (p0, p1),
    }


def _proof_probe(scen_seed: int) -> dict:
    """The proof-serving fault family (host only): a seeded
    HostLedgerExecutor advances a short chain, then

    - a handful of inclusion proofs must survive the wire codec
      byte-for-byte AND verify against the chained root a light client
      already trusts (an honest proof that fails to verify is a
      liveness violation for every reader);
    - all four adversarial mutations — stale previous root, forged
      sibling, truncated path, wrong leaf value — must FAIL
      verification. A forgery that verifies is the one violation the
      trustless-read doctrine can never absorb.
    """
    import dataclasses

    from hyperdrive_tpu_torch.exec import (
        BlockSource,
        ExecutionConfig,
        HostLedgerExecutor,
    )
    from hyperdrive_tpu_torch.parallel.service import (
        STATUS_COMMITTED,
        decode_proof,
        encode_proof,
    )

    rng = random.Random(scen_seed * _SEED_STRIDE + 13)
    accounts = rng.choice((16, 32, 64))
    target = rng.randrange(3, 7)
    cfg = ExecutionConfig(
        accounts=accounts, txs_per_block=16, stake_every=3,
        stake_accounts=accounts // 4, seed=scen_seed % 10_000,
        amount_cap=16, initial_balance=500,
    )
    ex = HostLedgerExecutor(cfg, source=BlockSource(cfg))
    ex.advance_to(target)
    basis = ex.proof_basis()
    root = ex.roots[target]
    served = 0
    for account in sorted(rng.sample(range(accounts), 5)):
        proof = basis.prove(account)
        rid, status, wired = decode_proof(
            encode_proof(served + 1, STATUS_COMMITTED, proof)
        )
        if wired != proof or rid != served + 1:
            raise InvariantViolation(
                "proof-codec",
                f"proof frame for account {account} did not roundtrip "
                f"the wire codec losslessly",
            )
        if not ex.verify_inclusion(
            root, account, wired.balance, wired.stake, wired
        ):
            raise InvariantViolation(
                "proof-serve",
                f"honest proof for account {account} failed "
                f"verification at height {target}",
            )
        served += 1
    victim = basis.prove(rng.randrange(accounts))
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
        if ex.verify_inclusion(
            root, bad.account, bad.balance, bad.stake, bad
        ):
            raise InvariantViolation(
                "proof-forgery",
                f"{name} forgery VERIFIED at height {target} "
                f"(account {bad.account}, {accounts} accounts)",
            )
    return {
        "height": target,
        "accounts": accounts,
        "served": served,
        "depth": len(victim.siblings),
        "forgeries": len(forgeries),
    }


def _wire_fuzz_probe(scen_seed: int) -> dict:
    """The Byzantine-bytes fault family (host only): a real
    :class:`~hyperdrive_tpu_torch.transport.TcpNode` behind a
    :class:`~hyperdrive_tpu_torch.chaos.ChaosProxy` with ``fuzz_every`` armed,
    fed a burst of signed prevote frames where every 3rd payload arrives
    mutated (seeded truncate / extend / bitflip / tag-smash, length
    header recomputed so the corruption lands in the DECODE path).
    Invariants:

    - every CLEAN frame still delivers — a garbage frame must never
      take honest traffic down with it (FIFO link, so clean deliveries
      can only be missing if a mutant killed the read loop);
    - a final clean frame sent after the burst delivers on the SAME
      connection — the read loop survived every mutant without
      desyncing or crashing its thread;
    - every frame the target counted as malformed was one the proxy
      fuzzed (honest frames never misparse), and the fuzzer never broke
      framing (``oversize_frames`` stays zero: the corruption is the
      payload's, not the length prefix's).

    Runs with whatever ``HD_SANITIZE`` the environment sets — CI arms
    it, so mutants also cross the HDS005 budget accounting.
    """
    import socket
    import time

    from hyperdrive_tpu_torch.chaos.proxy import ChaosProxy
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.messages import Prevote
    from hyperdrive_tpu_torch.transport import TcpNode, encode_frame

    received: list = []

    class _Sink:
        def propose(self, m, stop=None):
            received.append(m)

        prevote = precommit = timeout = propose

    def _await(pred, deadline_s=10.0):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.01)
        return pred()

    frames, fuzz_every = 60, 3
    ring = KeyRing.deterministic(1, namespace=b"wirefuzz")

    def _frame(height: int) -> bytes:
        return encode_frame(ring[0].sign_message(
            Prevote(height=height, round=0, value=b"\x07" * 32,
                    sender=ring[0].public)
        ))

    node = TcpNode()
    node.add_replica(_Sink())
    node.start()
    proxy = ChaosProxy(
        "127.0.0.1", node.port, seed=scen_seed, fuzz_every=fuzz_every
    ).start()
    try:
        with socket.create_connection(("127.0.0.1", proxy.port)) as s:
            for h in range(1, frames + 1):
                s.sendall(_frame(h))
            if not _await(lambda: proxy.forwarded >= frames):
                raise InvariantViolation(
                    "wire-fuzz",
                    f"proxy forwarded {proxy.forwarded}/{frames} frames",
                )
            if proxy.fuzzed != frames // fuzz_every:
                raise InvariantViolation(
                    "wire-fuzz",
                    f"fuzz cadence missed: {proxy.fuzzed} mutations for "
                    f"{frames} frames at every {fuzz_every}",
                )
            clean = frames - proxy.fuzzed
            if not _await(lambda: len(received) >= clean):
                raise InvariantViolation(
                    "wire-fuzz",
                    f"only {len(received)} of {clean} clean frames "
                    "delivered — a garbage frame took honest traffic "
                    "down with it",
                )
            # frames+1 is not a multiple of fuzz_every, so the survivor
            # frame crosses the proxy unmutated.
            before = len(received)
            s.sendall(_frame(frames + 1))
            if not _await(lambda: len(received) > before):
                raise InvariantViolation(
                    "wire-fuzz",
                    "read loop dead after the fuzz burst: a clean "
                    "frame no longer delivers",
                )
        if node.oversize_frames:
            raise InvariantViolation(
                "wire-fuzz",
                f"fuzzer broke framing: target counted "
                f"{node.oversize_frames} oversize frames",
            )
        if node.malformed_frames > proxy.fuzzed:
            raise InvariantViolation(
                "wire-fuzz",
                f"{node.malformed_frames} malformed frames exceed the "
                f"{proxy.fuzzed} mutations — an honest frame misparsed",
            )
        return {
            "frames": frames + 1,
            "fuzzed": proxy.fuzzed,
            "malformed": node.malformed_frames,
            "delivered": len(received),
        }
    finally:
        proxy.stop()
        node.stop()


def _metrics_probe(scen_seed: int) -> dict:
    """The live-metrics fault family (host only): a real
    :class:`~hyperdrive_tpu_torch.parallel.service.ServicePort` serving
    remote tenants over real sockets, scraped over TAG_METRICS.
    Invariants:

    - a scrape after real traffic answers STATUS_COMMITTED with valid
      Prometheus exposition text (every non-comment line parses as
      ``name{labels} value``) that already carries the commit-latency
      histogram the tenant's own submits fed;
    - shed ORDERING (the metrics-plane doctrine): with the admission
      floor forced to SHED_LOW_PRIORITY, the scrape answers
      STATUS_SHED while a second tenant's consensus submits — run
      under the SAME floor — all still commit. The observability
      plane sheds strictly before any consensus class, and no submit
      row is shed while the scrape is;
    - pressure released, the retried scrape serves again (scrapes are
      flow-controlled reads, never lost), and the SLO burn-rate
      checks (obs/slo.py) evaluate over the run's registry snapshot
      and journal: finality_p99 and shed_rate must both be MEASURED
      (a missing signal is not evidence of health) and finality must
      hold its ceiling on an unloaded local run.
    """
    import re
    import threading
    import time

    from hyperdrive_tpu_torch.load.backpressure import SHED_LOW_PRIORITY
    from hyperdrive_tpu_torch.obs.metrics import Registry
    from hyperdrive_tpu_torch.obs.recorder import Recorder
    from hyperdrive_tpu_torch.obs.slo import evaluate_slos
    from hyperdrive_tpu_torch.parallel.service import (
        RemoteServiceClient,
        STATUS_COMMITTED,
        STATUS_SHED,
        ShardVerifyService,
        TenantShard,
    )
    from hyperdrive_tpu_torch.verifier import NullVerifier

    rng = random.Random(scen_seed * _SEED_STRIDE + 29)
    target = rng.randrange(3, 6)
    rec = Recorder(threadsafe=True)
    obs = rec.scoped(-1)
    svc = ShardVerifyService(
        NullVerifier(), max_depth=0, registry=Registry(), obs=obs
    )
    port = svc.remote_port(obs=obs)

    def _run_tenant(name: str, heights: int):
        client = RemoteServiceClient(*port.address)
        shard = TenantShard(name, target_height=heights, sign=False)
        shard.attach_remote(client)
        t = threading.Thread(target=shard.run_remote, daemon=True)
        t.start()
        deadline = time.monotonic() + 10.0
        while not shard.done and time.monotonic() < deadline:
            port.pump()
            svc.drain()
            time.sleep(0.001)
        t.join(timeout=5.0)
        if not shard.done or shard.rejected:
            raise InvariantViolation(
                "metrics-liveness",
                f"tenant {name} stalled (done={shard.done} "
                f"rejected={shard.rejected}) — consensus traffic did "
                f"not survive the probe's load profile",
            )
        return client

    def _scrape(client):
        fut = client.metrics()
        deadline = time.monotonic() + 5.0
        while not fut.done() and time.monotonic() < deadline:
            port.pump()
            svc.drain()
            time.sleep(0.001)
        return fut.metrics_result(timeout=1.0)

    prom_line = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$"
    )
    clients = []
    try:
        clients.append(_run_tenant(f"mx-{scen_seed % 977}", target))
        status, text = _scrape(clients[0])
        if status != STATUS_COMMITTED or not text:
            raise InvariantViolation(
                "metrics-serve",
                f"unloaded scrape refused (status={status}) — the "
                f"metrics plane failed with zero pressure on the gate",
            )
        for line in text.splitlines():
            if line and not line.startswith("#") and \
                    not prom_line.match(line):
                raise InvariantViolation(
                    "metrics-format",
                    f"scrape line is not Prometheus exposition "
                    f"text: {line!r}",
                )
        if "hd_tenant_commit_latency" not in text:
            raise InvariantViolation(
                "metrics-serve",
                "scrape is missing the commit-latency histogram the "
                "tenant's own traffic fed",
            )
        port.controller.floor = SHED_LOW_PRIORITY
        port.controller.poll()
        status2, text2 = _scrape(clients[0])
        if status2 != STATUS_SHED or text2 is not None:
            raise InvariantViolation(
                "metrics-shed-order",
                f"scrape under SHED_LOW_PRIORITY answered "
                f"status={status2} — metrics must be the FIRST class "
                f"shed, before any consensus frame queues behind them",
            )
        # The ordering half: under the SAME floor that just shed the
        # scrape, a fresh tenant's consensus submits must all commit.
        clients.append(_run_tenant(f"my-{scen_seed % 977}", 2))
        if port.remote_sheds:
            raise InvariantViolation(
                "metrics-shed-order",
                f"{port.remote_sheds} consensus submits shed at the "
                f"floor that sheds metrics — the shed order inverted",
            )
        port.controller.floor = 0
        for _ in range(port.controller.hysteresis):
            port.controller.poll()
        status3, text3 = _scrape(clients[0])
        if status3 != STATUS_COMMITTED or not text3:
            raise InvariantViolation(
                "metrics-serve",
                f"scrape after pressure release refused "
                f"(status={status3}) — sheds must be retryable, "
                f"never a lost read",
            )
        slos = evaluate_slos(
            snapshot=svc.registry.snapshot(),
            events=rec.snapshot(), obs=obs,
        )
        by_name = {r.name: r for r in slos}
        for needed in ("finality_p99", "shed_rate"):
            if needed not in by_name:
                raise InvariantViolation(
                    "metrics-slo",
                    f"{needed} was not measured — its input signal "
                    f"went missing from a run that produced it",
                )
        if not by_name["finality_p99"].ok:
            raise InvariantViolation(
                "metrics-slo",
                f"finality_p99 burned "
                f"{by_name['finality_p99'].burn:.2f}x its budget on "
                f"an unloaded local run",
            )
        return {
            "target": target,
            "serves": port.metrics_serves,
            "sheds": port.metrics_sheds,
            "bytes": len(text3),
            "slos": len(slos),
            "breaches": sum(1 for r in slos if not r.ok),
        }
    finally:
        for client in clients:
            client.close()
        port.close()
        svc.close()


def _dump_failure(out: str, scen_seed: int, sim, err) -> str:
    os.makedirs(out, exist_ok=True)
    base = os.path.join(out, f"chaos_seed_{scen_seed}")
    sim.record.dump(base + ".bin")
    sim.obs.save(base + ".journal.json")
    sim._ckpt_store.dump(base + ".ckpt")
    with open(base + ".txt", "w") as fh:
        fh.write(f"seed={scen_seed}\nviolation={err}\n")
    return base


#: The soak legs that reach the port's device work (module docstring).
_DEVICE_LEGS = ("bls_certs_every", "exec_every", "exec_pipeline_every")


def soak(args) -> int:
    dev = None
    if any(getattr(args, leg) for leg in _DEVICE_LEGS):
        dev = require_device(args.device)
    rng = random.Random(args.seed)
    failures = 0
    churn_dumped = False
    overlay_dumped = False
    for k in range(args.scenarios):
        scen_seed = args.seed + k * _SEED_STRIDE
        n = args.n if args.n else rng.choice([4, 7])
        plan, sim = _build(scen_seed, n, args.target)
        monitor = InvariantMonitor(sim)
        try:
            result = sim.run(max_steps=args.max_steps)
            monitor.check_final(result)
            if args.replay_every and k % args.replay_every == 0:
                replayed = Simulation.replay(sim.record)
                if replayed.commits != result.commits:
                    raise InvariantViolation(
                        "replay", "replayed commits diverge from live run"
                    )
            if args.certs_every and k % args.certs_every == 0:
                # Re-run the same plan with quorum certificates minted
                # at every commit: partitions, crashes, and heals must
                # not bend the chain (digest-identical to the baseline
                # run), every surviving certificate must match the
                # committed value it proves, and each must still pass
                # its O(1) re-verification.
                _, csim = _build(
                    scen_seed, n, args.target, certificates=True
                )
                cmon = InvariantMonitor(csim)
                cresult = csim.run(max_steps=args.max_steps)
                cmon.check_final(cresult)
                if cresult.commit_digest() != result.commit_digest():
                    raise InvariantViolation(
                        "certificates",
                        "certificate-carrying chain diverges from baseline",
                    )
                for i, certifier in enumerate(csim.certifiers):
                    for ch, cert in certifier.certs.items():
                        v = cresult.commits[i].get(ch)
                        if (
                            v is not None
                            and cert.value_digest
                            != hashlib.sha256(v).digest()
                        ):
                            raise InvariantViolation(
                                "certificates",
                                f"certificate digest mismatch at "
                                f"height {ch}",
                            )
                        if not certifier.verify(cert):
                            raise InvariantViolation(
                                "certificates",
                                f"certificate failed O(1) re-verify at "
                                f"height {ch}",
                            )
            if args.bls_certs_every and k % args.bls_certs_every == 0:
                # BLS-bound certificates: re-run the same
                # plan with aggregate-signature minting on. The chain
                # must stay digest-identical to the baseline (the
                # aggregate changes the certificate, never the
                # agreement), every surviving certificate must carry
                # the 48-byte aggregate and re-verify its binding, and
                # one sampled certificate per run must pass the full
                # LIGHT-CLIENT pairing check — committee pubkeys only,
                # zero transcript trust. A second, faulted overlay run
                # rides along with real BLS partials on every frame: a
                # deterministic merge-level probe corrupts a real
                # frame's aggregate and the runtime must charge the
                # contributor and refuse the merge BEFORE any batch
                # verify.
                from hyperdrive_tpu_torch.certificates import (
                    verify_bls_certificate,
                )

                _, bcsim = _build(
                    scen_seed, n, args.target, bls_certificates=True
                )
                bcmon = InvariantMonitor(bcsim)
                bcresult = bcsim.run(max_steps=args.max_steps)
                bcmon.check_final(bcresult)
                if bcresult.commit_digest() != result.commit_digest():
                    raise InvariantViolation(
                        "bls-certs",
                        "BLS-certificate chain diverges from baseline",
                    )
                sampled = 0
                for certifier in bcsim.certifiers:
                    pks = certifier.bls_pubkeys()
                    for ch, cert in certifier.certs.items():
                        if len(cert.agg_sig) != 48:
                            raise InvariantViolation(
                                "bls-certs",
                                f"certificate at height {ch} carries no "
                                f"aggregate signature",
                            )
                        if not certifier.verify(cert):
                            raise InvariantViolation(
                                "bls-certs",
                                f"BLS certificate failed binding "
                                f"re-verify at height {ch}",
                            )
                    if certifier.certs and not sampled:
                        # One pairing per run: the light-client path is
                        # O(seconds) on the host reference, so the soak
                        # samples the newest certificate rather than
                        # paying n * heights pairings per scenario.
                        ch = max(certifier.certs)
                        if not verify_bls_certificate(
                            certifier.certs[ch], pks,
                            quorum=2 * ((n - 1) // 3) + 1,
                        ):
                            raise InvariantViolation(
                                "bls-certs",
                                f"light-client verify rejected the "
                                f"certificate at height {ch}",
                            )
                        sampled += 1
                if not sampled:
                    raise InvariantViolation(
                        "bls-certs", "run minted no BLS certificates"
                    )
                rejects = _bls_overlay_probe(scen_seed, args, dev)
                print(
                    f"ok bls seed={scen_seed} n={n} "
                    f"certs=48B-agg light-client=ok "
                    f"overlay-rejects={rejects} merge-probe=ok"
                )
            if args.pipelined_every and k % args.pipelined_every == 0:
                # Re-run the same plan with settles pipelined through
                # the shared device-work queue: the monitor must stay
                # clean and the agreed chain byte-identical.
                _, psim = _build(scen_seed, n, args.target, pipelined=True)
                pmon = InvariantMonitor(psim)
                presult = psim.run(max_steps=args.max_steps)
                pmon.check_final(presult)
                if presult.commit_digest() != result.commit_digest():
                    raise InvariantViolation(
                        "pipelined",
                        "pipelined chain diverges from sequential",
                    )
            if args.overload_every and k % args.overload_every == 0:
                # The overload fault family: re-run the SAME
                # plan with an open-loop duplicate storm + the admission
                # spine pinned in the behavior-neutral band. The loaded
                # run must commit the identical chain — injected
                # duplicates consume no steps/clock/rng, and the gate
                # sheds only classes the Process ignores anyway — and
                # must actually have shed something (the storm is not
                # allowed to be a no-op) while never shedding outside
                # the admission vocabulary.
                _, profile = FaultPlan.overload(scen_seed, n)
                _, osim = _build(scen_seed, n, args.target, load=profile)
                omon = InvariantMonitor(osim)
                oresult = osim.run(max_steps=args.max_steps)
                omon.check_final(oresult)
                if oresult.commit_digest() != result.commit_digest():
                    raise InvariantViolation(
                        "overload",
                        "overloaded chain diverges from unloaded run",
                    )
                osnap = osim.overload_snapshot()
                # Guaranteed-shed prey only: vote duplicates at
                # un-advanced heights (proposal dups and behind-the-
                # commit-edge votes are admitted/filtered by doctrine).
                if osnap["injected_sheddable"] and not osnap["shed"]:
                    raise InvariantViolation(
                        "overload",
                        "sheddable storm injected but admission shed nothing",
                    )
                bad = set(osnap["shed"]) - {"duplicate", "stale_height"}
                if bad:
                    raise InvariantViolation(
                        "overload",
                        f"behavior-neutral run shed classes {sorted(bad)}",
                    )
                shed_str = ",".join(
                    f"{c}:{n_}" for c, n_ in sorted(osnap["shed"].items())
                ) or "-"
                print(
                    f"ok overload seed={scen_seed} n={n} "
                    f"injected={osnap['injected']} shed={shed_str}"
                )
            if args.tenants_every and k % args.tenants_every == 0:
                # The multi-tenant serving fault family:
                # overload on one tenant + a partition on another must
                # not move a third tenant's digests, and the DRR
                # starvation bound must hold while being exercised.
                tstats = _tenant_service_probe(scen_seed)
                print(
                    f"ok tenants seed={scen_seed} "
                    f"deferred={tstats['deferred']} "
                    f"forced={tstats['forced']} "
                    f"max_deferrals={tstats['max_deferrals']} "
                    f"launches={tstats['launches']} "
                    f"partition={tstats['partition'][0]}.."
                    f"{tstats['partition'][1]}"
                )
            if args.proofs_every and k % args.proofs_every == 0:
                # The proof-serving fault family: honest
                # proofs must roundtrip the wire codec and verify
                # against the chained root; the four forged-proof
                # variants must all fail verification.
                pstats = _proof_probe(scen_seed)
                print(
                    f"ok proofs seed={scen_seed} "
                    f"height={pstats['height']} "
                    f"accounts={pstats['accounts']} "
                    f"served={pstats['served']} "
                    f"depth={pstats['depth']} "
                    f"forgeries-rejected={pstats['forgeries']}"
                )
        except (InvariantViolation, AssertionError) as err:
            failures += 1
            base = _dump_failure(args.out, scen_seed, sim, err)
            print(
                f"FAIL seed={scen_seed} n={n} {err}\n"
                f"  dumped {base}.bin (+ journal, checkpoints)\n"
                f"  reproduce: python -m hyperdrive_tpu_torch.chaos replay "
                f"{base}.bin",
                file=sys.stderr,
            )
            if not args.keep_going:
                return 1
            continue
        print(
            f"ok seed={scen_seed} n={n} heights<= {max(result.heights)} "
            f"steps={result.steps} crashes={len(monitor.crashes)} "
            f"heals={len(monitor.heals)}"
        )
        if args.churn_every and k % args.churn_every == 0:
            # Every Kth scenario additionally runs the epoch-churn
            # family: dynamic validator sets under the same seed's
            # hostility, with the monitor's epoch invariants armed
            # (no fork across switches, retired keys out of every
            # whitelist, union proof chain verifying end-to-end) and a
            # record-replay determinism self-check.
            cn = args.n if args.n else 8
            zplan, zsim = _build_churn(scen_seed, cn, args.target)
            zmon = InvariantMonitor(zsim)
            try:
                zresult = zsim.run(max_steps=args.max_steps)
                zmon.check_final(zresult)
                if not zmon.epoch_switches:
                    raise InvariantViolation(
                        "epoch-liveness",
                        "churn run never crossed an epoch boundary",
                    )
                zreplayed = Simulation.replay(zsim.record)
                if zreplayed.commits != zresult.commits:
                    raise InvariantViolation(
                        "replay",
                        "churn replay diverges from live run",
                    )
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                base = _dump_failure(args.out, scen_seed, zsim, err)
                print(
                    f"FAIL churn seed={scen_seed} n={cn} {err}\n"
                    f"  dumped {base}.bin (+ journal, checkpoints)\n"
                    f"  reproduce: python -m hyperdrive_tpu_torch.chaos "
                    f"replay {base}.bin",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            print(
                f"ok churn seed={scen_seed} n={cn} "
                f"epoch={zsim.epoch} switches={len(zmon.epoch_switches)} "
                f"stale_votes={sum(r.stale_votes for r in zsim.replicas)}"
            )
            if args.dump_ok and not churn_dumped:
                os.makedirs(args.dump_ok, exist_ok=True)
                okbase = os.path.join(
                    args.dump_ok, f"churn_seed_{scen_seed}.bin"
                )
                zsim.record.dump(okbase)
                churn_dumped = True
                print(f"  dumped passing churn record: {okbase}")
        if args.overlay_every and k % args.overlay_every == 0:
            # Every Kth scenario additionally runs the aggregation-
            # overlay fault family: tree-slicing partition +
            # Byzantine contributors + interior crash on the overlay
            # dissemination path, with the monitor's overlay invariants
            # armed and a record-replay determinism self-check (overlay
            # records hold plain per-message deliveries, so they replay
            # with no overlay wiring at all). A second, fault-free pair
            # checks DIGEST NEUTRALITY: the same seed through a clean
            # overlay must commit the byte-identical chain the
            # all-to-all baseline commits — aggregation changes the
            # transport, never the agreed values.
            on = args.n if args.n else 8
            yplan, yfaults, ysim = _build_overlay(
                scen_seed, on, args.target
            )
            ymon = InvariantMonitor(ysim)
            try:
                yresult = ysim.run(max_steps=args.max_steps)
                ymon.check_final(yresult)
                yreplayed = Simulation.replay(ysim.record)
                if yreplayed.commits != yresult.commits:
                    raise InvariantViolation(
                        "replay",
                        "overlay replay diverges from live run",
                    )
                from hyperdrive_tpu_torch.overlay import OverlayConfig

                bsim = Simulation(
                    n=on, target_height=args.target, seed=scen_seed,
                    timeout=1.0, delivery_cost=1e-3,
                )
                bresult = bsim.run(max_steps=args.max_steps)
                # Clean overlay, no faults: Byzantine withholding can
                # legitimately push a height into an extra round (the
                # fallback costs virtual time), so chain equality is
                # only an invariant of the aggregation mechanism
                # itself, not of adversarial timing. The faulted leg
                # above is held to the monitor's fork/digest checks.
                vsim = Simulation(
                    n=on, target_height=args.target, seed=scen_seed,
                    timeout=1.0, delivery_cost=1e-3,
                    overlay=OverlayConfig(),
                )
                vresult = vsim.run(max_steps=args.max_steps)
                if (vresult.commit_digest(up_to=args.target)
                        != bresult.commit_digest(up_to=args.target)):
                    raise InvariantViolation(
                        "overlay",
                        "overlay chain diverges from all-to-all baseline",
                    )
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                base = _dump_failure(args.out, scen_seed, ysim, err)
                print(
                    f"FAIL overlay seed={scen_seed} n={on} {err}\n"
                    f"  dumped {base}.bin (+ journal, checkpoints)\n"
                    f"  reproduce: python -m hyperdrive_tpu_torch.chaos "
                    f"replay {base}.bin",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            ysnap = ysim.overlay_snapshot()
            print(
                f"ok overlay seed={scen_seed} n={on} "
                f"frames={ysnap['frames']} "
                f"fallbacks={ysnap['fallback_engaged']} "
                f"demoted={ysnap['scores']['demoted']} "
                f"byz={ysnap['byzantine']} neutrality=ok"
            )
            if args.dump_ok and not overlay_dumped:
                os.makedirs(args.dump_ok, exist_ok=True)
                okbase = os.path.join(
                    args.dump_ok, f"overlay_seed_{scen_seed}.bin"
                )
                ysim.record.dump(okbase)
                overlay_dumped = True
                print(f"  dumped passing overlay record: {okbase}")
        if args.exec_every and k % args.exec_every == 0:
            # Every Kth scenario additionally runs the execution-churn
            # family: stake-churn transactions feeding
            # stake-driven elections across epoch boundaries under
            # partition + crash-restore, with the monitor's exec
            # invariants armed (state-root agreement network-wide,
            # commit/ledger binding) and a record-replay determinism
            # self-check on the root-extended chain.
            en = args.n if args.n else 8
            xplan, xsim = _build_exec_churn(
                scen_seed, en, args.target, device=dev
            )
            xmon = InvariantMonitor(xsim)
            try:
                xresult = xsim.run(max_steps=args.max_steps)
                xmon.check_final(xresult)
                if not xmon.epoch_switches:
                    raise InvariantViolation(
                        "epoch-liveness",
                        "exec-churn run never crossed an epoch boundary",
                    )
                if not sum(e.applied_total for e in xsim.executors):
                    raise InvariantViolation(
                        "exec-root",
                        "exec-churn run applied no transactions — the "
                        "leg did not exercise the ledger",
                    )
                xreplayed = Simulation.replay(xsim.record, device=dev)
                if xreplayed.commits != xresult.commits:
                    raise InvariantViolation(
                        "replay",
                        "exec-churn replay diverges from live run "
                        "(root-extended commits)",
                    )
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                base = _dump_failure(args.out, scen_seed, xsim, err)
                print(
                    f"FAIL exec seed={scen_seed} n={en} {err}\n"
                    f"  dumped {base}.bin (+ journal, checkpoints)\n"
                    f"  reproduce: python -m hyperdrive_tpu_torch.chaos "
                    f"replay {base}.bin",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            print(
                f"ok exec seed={scen_seed} n={en} epoch={xsim.epoch} "
                f"applied={sum(e.applied_total for e in xsim.executors)} "
                f"rejected={sum(e.rejected_total for e in xsim.executors)} "
                f"roots={len(xsim.executors[0].roots)} root-agreement=ok"
            )
        if args.fuzz_frames_every and k % args.fuzz_frames_every == 0:
            # Every Kth scenario additionally runs the Byzantine-bytes
            # probe: a real TcpNode behind a frame-fuzzing
            # proxy — every 3rd payload mutated, length header intact —
            # must deliver all clean traffic, survive every mutant
            # without a read-loop crash, and never misparse an honest
            # frame.
            try:
                wstats = _wire_fuzz_probe(scen_seed)
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                print(
                    f"FAIL wire-fuzz seed={scen_seed} {err}",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            print(
                f"ok wire-fuzz seed={scen_seed} "
                f"frames={wstats['frames']} fuzzed={wstats['fuzzed']} "
                f"malformed={wstats['malformed']} "
                f"delivered={wstats['delivered']}"
            )
        if args.metrics_every and k % args.metrics_every == 0:
            # Every Kth scenario additionally runs the live-metrics
            # probe: a real ServicePort scraped over
            # TAG_METRICS mid-soak — the scrape must serve valid
            # Prometheus text carrying the tenant-fed commit-latency
            # histogram, shed FIRST under a forced admission floor
            # while consensus submits run under the same floor all
            # still commit, serve again once pressure releases, and
            # the SLO burn-rate checks must both measure and hold.
            try:
                mstats = _metrics_probe(scen_seed)
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                print(
                    f"FAIL metrics seed={scen_seed} {err}",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            print(
                f"ok metrics seed={scen_seed} "
                f"heights={mstats['target']} "
                f"serves={mstats['serves']} sheds={mstats['sheds']} "
                f"bytes={mstats['bytes']} slos={mstats['slos']} "
                f"breaches={mstats['breaches']}"
            )
        if args.exec_pipeline_every and k % args.exec_pipeline_every == 0:
            # Every Kth scenario additionally runs the speculative-
            # pipeline family: forged-but-well-formed tx
            # signatures force a rollback on every resolved window
            # while churn faults (partition + crash-restore) land
            # inside open windows. Armed invariants: no rolled-back
            # root in any committed value (monitor), digest equality
            # with the sequential settle-then-execute twin, and a
            # record-replay self-check on the root-extended chain.
            pn = args.n if args.n else 7
            _, ssim = _build_exec_pipeline(
                scen_seed, pn, args.target, speculate=True, device=dev
            )
            smon = InvariantMonitor(ssim)
            try:
                sres = ssim.run(max_steps=args.max_steps)
                smon.check_final(sres)
                rolled = sum(
                    e.spec_rolled_back for e in ssim._exec_unique
                )
                discarded: set = set()
                for e in ssim._exec_unique:
                    discarded |= e.discarded_roots
                if not rolled or not discarded:
                    raise InvariantViolation(
                        "exec-rollback",
                        "speculative leg resolved no rollbacks — the "
                        "forged signatures did not exercise the unwind "
                        "path",
                    )
                _, qsim = _build_exec_pipeline(
                    scen_seed, pn, args.target, speculate=False, device=dev
                )
                qmon = InvariantMonitor(qsim)
                qres = qsim.run(max_steps=args.max_steps)
                qmon.check_final(qres)
                if sres.commit_digest() != qres.commit_digest():
                    raise InvariantViolation(
                        "exec-rollback",
                        "speculative pipeline chain diverges from the "
                        "sequential settle-then-execute run",
                    )
                sreplayed = Simulation.replay(ssim.record, device=dev)
                if sreplayed.commits != sres.commits:
                    raise InvariantViolation(
                        "replay",
                        "speculative-pipeline replay diverges from "
                        "live run (root-extended commits)",
                    )
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                base = _dump_failure(args.out, scen_seed, ssim, err)
                print(
                    f"FAIL exec-pipeline seed={scen_seed} n={pn} {err}\n"
                    f"  dumped {base}.bin (+ journal, checkpoints)\n"
                    f"  reproduce: python -m hyperdrive_tpu_torch.chaos "
                    f"replay {base}.bin",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            print(
                f"ok exec-pipeline seed={scen_seed} n={pn} "
                f"rollbacks={rolled} discarded={len(discarded)} "
                f"max_depth="
                f"{max(e.spec_rollback_depth for e in ssim._exec_unique)} "
                f"seq-digest=ok replay=ok"
            )
        if args.campaign_every and k % args.campaign_every == 0:
            # Every Kth scenario additionally runs the attack-campaign
            # family (campaign/): a budgeted validator-set-capture
            # attempt ground through the real ledger + epoch schedule,
            # judged by the monitor's trajectory proportionality bound,
            # then round-tripped through its CampaignRecord dump — the
            # replay-from-dump must re-derive the identical trajectory
            # digest with zero stored state beyond the config.
            import tempfile

            from hyperdrive_tpu_torch.campaign import CampaignConfig
            from hyperdrive_tpu_torch.campaign.record import CampaignRecord
            from hyperdrive_tpu_torch.campaign.runner import (
                replay_campaign,
                run_campaign,
            )

            ccfg = CampaignConfig(
                family="capture", seed=scen_seed, validators=128,
                committee_size=16, attackers=4, sybils=8,
            )
            clive = None
            try:
                clive = run_campaign(ccfg)
                if clive.violations:
                    kind, detail = clive.violations[0]
                    raise InvariantViolation(kind, detail)
                with tempfile.TemporaryDirectory() as td:
                    cpath = os.path.join(td, "campaign.bin")
                    clive.record.dump(cpath)
                    loaded = CampaignRecord.load_file(cpath)
                    same, cfresh = replay_campaign(loaded)
                if not same:
                    raise InvariantViolation(
                        "replay",
                        "campaign replay-from-dump diverges from the "
                        f"live run ({cfresh.digest[:8].hex()} vs "
                        f"{clive.digest[:8].hex()})",
                    )
            except (InvariantViolation, AssertionError) as err:
                failures += 1
                os.makedirs(args.out, exist_ok=True)
                cbase = os.path.join(
                    args.out, f"campaign_seed_{scen_seed}"
                )
                if clive is not None:
                    clive.record.dump(cbase + ".bin")
                with open(cbase + ".txt", "w") as fh:
                    fh.write(f"seed={scen_seed}\nviolation={err}\n")
                print(
                    f"FAIL campaign seed={scen_seed} {err}\n"
                    f"  dumped {cbase}.bin\n"
                    f"  reproduce: python -m hyperdrive_tpu_torch.campaign "
                    f"replay {cbase}.bin",
                    file=sys.stderr,
                )
                if not args.keep_going:
                    return 1
                continue
            print(
                f"ok campaign seed={scen_seed} family=capture "
                f"epochs={ccfg.epochs} "
                f"seats={clive.summary['seats_total']} "
                f"passive={clive.summary['passive_total']} "
                f"digest={clive.digest[:8].hex()} replay=ok"
            )
    if failures:
        print(f"soak FAILED: {failures}/{args.scenarios}", file=sys.stderr)
        return 1
    print(f"soak ok: {args.scenarios} scenarios, 0 violations")
    return 0


def replay(args) -> int:
    record = ScenarioRecord.load(args.dump)
    extra = {}
    if record.epochs is not None:
        # Epoch records replay with certificates on so the transition
        # proofs are re-minted from the recorded deliveries and the
        # light-client chain walk can run from the dump alone.
        extra["certificates"] = True
    if record.execution is not None:
        # An execution record rebuilds its executors through the
        # execution layer, which runs on --device.
        extra["device"] = require_device(args.device)
    result = Simulation.replay(record, **extra)
    result.assert_safety()
    print(
        f"replayed seed={record.seed} n={record.n} "
        f"target={record.target_height}: completed={result.completed} "
        f"steps={result.steps} lifecycle_ops={len(record.lifecycle)} "
        f"digest={result.commit_digest()[:16]}"
    )
    if record.epochs is not None:
        from hyperdrive_tpu_torch.epochs import verify_epoch_chain

        sim = result.sim
        covered: dict = {}
        for c in sim.certifiers:
            for e, pr in getattr(c, "proofs", {}).items():
                covered.setdefault(e, pr)
        missing = sorted(set(range(1, sim.epoch + 1)) - set(covered))
        if missing:
            print(f"epoch chain BROKEN: no proof for epochs {missing}",
                  file=sys.stderr)
            return 1
        proofs = [covered[e] for e in sorted(covered)]
        hops = verify_epoch_chain(
            sim.epoch_schedule.signatories(0), proofs
        )
        print(f"epoch chain ok: {hops} transitions verified from genesis")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyperdrive_tpu_torch.chaos")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("soak", help="run N seeded chaos scenarios")
    p.add_argument("--scenarios", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument(
        "--n", type=int, default=0, help="replica count (0 = mix of 4 and 7)"
    )
    p.add_argument("--target", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=500_000)
    p.add_argument("--out", default="chaos_failures")
    p.add_argument(
        "--replay-every",
        type=int,
        default=5,
        help="determinism self-check cadence (0 = off)",
    )
    p.add_argument(
        "--pipelined-every",
        type=int,
        default=4,
        help="re-run every Kth plan with devsched-pipelined settles and "
        "cross-check the commit digest (0 = off)",
    )
    p.add_argument(
        "--certs-every",
        type=int,
        default=4,
        help="re-run every Kth plan with quorum certificates enabled and "
        "cross-check chain digests + certificate integrity (0 = off)",
    )
    p.add_argument(
        "--bls-certs-every",
        type=int,
        default=0,
        help="re-run every Kth plan with BLS aggregate-signature "
        "certificates (digest parity, binding re-verify, one sampled "
        "light-client pairing check) plus a faulted BLS-partial overlay "
        "run with a deterministic merge-level corruption probe (0 = off)",
    )
    p.add_argument(
        "--overload-every",
        type=int,
        default=4,
        help="re-run every Kth plan under an open-loop duplicate storm "
        "with behavior-neutral admission and cross-check the commit "
        "digest against the unloaded run (0 = off)",
    )
    p.add_argument(
        "--tenants-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as a multi-tenant serving "
        "scenario (a firehose tenant + a partitioned tenant sharing one "
        "continuously-batching verify service with a third, unfaulted "
        "tenant; digest isolation + the DRR starvation bound; 0 = off)",
    )
    p.add_argument(
        "--churn-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as an epoch-churn scenario "
        "(dynamic validator set + key rotation under chaos; 0 = off)",
    )
    p.add_argument(
        "--overlay-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as an aggregation-overlay "
        "scenario (tree-slicing partition + Byzantine contributors on "
        "the overlay path, plus a digest-neutrality cross-check against "
        "the all-to-all baseline; 0 = off)",
    )
    p.add_argument(
        "--exec-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as an execution-churn "
        "scenario (stake-churn transactions driving stake-elected "
        "epochs under partition + crash-restore, with state-root "
        "agreement armed and a root-extended replay self-check; "
        "0 = off)",
    )
    p.add_argument(
        "--exec-pipeline-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as a speculative-"
        "execution-pipeline scenario (forged-but-well-formed tx "
        "signatures forcing rollbacks inside churn faults, the "
        "no-rolled-back-root-committed invariant armed, digest parity "
        "with the sequential twin, and a record-replay self-check; "
        "0 = off)",
    )
    p.add_argument(
        "--proofs-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as a proof-serving "
        "probe (host executor: honest inclusion proofs must "
        "roundtrip the wire codec and verify against the chained "
        "root, and all four forged-proof variants must fail "
        "verification; 0 = off)",
    )
    p.add_argument(
        "--fuzz-frames-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as a Byzantine-bytes "
        "probe (real TcpNode behind a frame-fuzzing proxy mutating "
        "every 3rd payload; clean traffic must all deliver, the read "
        "loop must survive every mutant, and honest frames must never "
        "misparse; 0 = off)",
    )
    p.add_argument(
        "--metrics-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as a live-metrics probe "
        "(host-only ServicePort scraped over TAG_METRICS: valid "
        "Prometheus exposition text, metrics shed FIRST under a "
        "forced admission floor while consensus submits under the "
        "same floor all commit, and the SLO burn-rate checks measure "
        "and hold; 0 = off)",
    )
    p.add_argument(
        "--campaign-every",
        type=int,
        default=0,
        help="additionally run every Kth seed as an attack-campaign "
        "scenario (host only: a budgeted validator-set-capture attempt "
        "through the real ledger and epoch schedule, the trajectory "
        "proportionality bound armed, and a replay-from-dump digest "
        "identity self-check through the CampaignRecord codec; "
        "0 = off)",
    )
    p.add_argument(
        "--dump-ok",
        default="",
        help="dump the first PASSING churn scenario's record here (the "
        "CI epoch-proof-chain replay smoke consumes it)",
    )
    p.add_argument("--keep-going", action="store_true")
    add_device_arg(p)
    p.set_defaults(fn=soak)

    p = sub.add_parser("replay", help="replay a dumped ScenarioRecord")
    p.add_argument("dump")
    add_device_arg(p)
    p.set_defaults(fn=replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
