"""The three campaign families: storm, capture, coincidence.

Port copy of the JAX package's ``campaign/families.py``. Each engine is a
deterministic function ``run(config, verifier, registry, obs) ->
summary dict`` over the
real subsystems: the admission gate and reputation table
(load/backpressure.py), the host ledger executor (exec/ledger.py), the
epoch schedule (epochs.py), the aggregation topology and contribution
scores (overlay/), never simplified stand-ins. The summary is the
campaign's full observable trajectory; its canonical-JSON sha256
(record.summary_digest) is the replay-identity digest, so every number
that matters lands in the summary and every number in the summary is a
pure function of the config.

The batch verifier is the one difference from the reference, which builds
a ``HostVerifier`` in the storm and coincidence engines: here the caller
hands one in, and :func:`batch_verifier` makes the default, a
``TorchBatchVerifier`` on the card (the ``ed25519_verify`` kernel, one
launch a wave) or a ``HostVerifier`` for ``device="cpu"``. Every verdict,
and so the summary, is the same either way. The ledger executor stays the
host one, as the reference chose. The ``registry`` and ``obs`` hooks are
the reference's: every ``campaign.*`` event and count, and the gates' and
controllers' ``admission.*`` ones.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from hyperdrive_tpu_torch.campaign import CampaignConfig
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.epochs import _EPOCH_TAG, EpochSchedule, elect_committee
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.exec.ledger import (
    KIND_STAKE,
    KIND_TRANSFER,
    KIND_UNSTAKE,
    BlockSource,
    HostLedgerExecutor,
    TxBlock,
)
from hyperdrive_tpu_torch.load.backpressure import (
    AdmissionGate,
    BackpressureController,
    SignerReputation,
    _peer_label,
)
from hyperdrive_tpu_torch.messages import Prevote
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.overlay.score import ContributionScores
from hyperdrive_tpu_torch.overlay.topology import Topology

__all__ = [
    "batch_verifier",
    "run_storm",
    "run_capture",
    "run_coincidence",
    "ENGINES",
]


def batch_verifier(device=None):
    """The storm and coincidence engines' default batch verifier on
    ``device``: a ``TorchBatchVerifier`` on the card (``None`` means the
    card and raises without CUDA), the reference's ``HostVerifier`` on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        from hyperdrive_tpu_torch.verifier import HostVerifier

        return HostVerifier()
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    return TorchBatchVerifier(device=dev)


def _stream(tag: bytes, *parts: int):
    """Keyed deterministic byte stream for campaign draws (the
    epochs.py ``_draw`` idiom, widened to a shake stream)."""
    key = tag + b"".join(int(p).to_bytes(8, "little") for p in parts)
    return hashlib.shake_256(key)


# --------------------------------------------------------------- storm


def _forge(sig: bytes) -> bytes:
    """Well-formed but invalid: correct length, correct structure,
    fails batch verify — the exec layer's bad_sig_every corruption."""
    return bytes([sig[0] ^ 0xFF]) + sig[1:]


def run_storm(
    cfg: CampaignConfig, verifier, registry=None, obs=NULL_BOUND
) -> dict:
    """Signed-vote storm against one admission gate.

    Per wave: every honest committee signer emits ``wave_votes``
    properly-signed prevotes; every attacker emits ``wave_votes *
    attack_rate`` forged ones. All frames pass the gate's cheap checks
    (fresh keys, well-formed), admitted rows batch through the real
    Ed25519 verifier, and per-signer verdicts feed back through
    ``note_verify``. With the reputation loop on, attackers demote
    after their first wave and shed at the gate from then on — the
    post-verify cost curve in the summary is the loop's receipt.
    """
    k, a = cfg.committee_size, cfg.attackers
    ring = KeyRing.deterministic(
        k, namespace=b"campaign-storm-%d" % cfg.seed
    )
    honest = [ring[i].public for i in range(a, k)]
    attackers = [ring[j].public for j in range(a)]
    rep = (
        SignerReputation(registry=registry, obs=obs)
        if cfg.reputation
        else None
    )
    honest_rows = (k - a) * cfg.wave_votes
    storm_rows = honest_rows + a * cfg.wave_votes * cfg.attack_rate
    # Depth thresholds scaled to the workload: an honest-only wave sits
    # below SHED_LOW_PRIORITY, a full storm wave sits above it, and
    # CRITICAL_ONLY stays out of reach — the storm must degrade
    # admission, not black out honest prevotes.
    ctrl = BackpressureController(
        depth_low_priority=honest_rows * 2,
        depth_critical=storm_rows * 4,
        hysteresis=2,
        registry=registry,
        obs=obs,
    )
    gate = AdmissionGate(
        ctrl, reputation=rep, registry=registry, obs=obs
    )
    waves = []
    if obs is not NULL_BOUND:
        obs.emit("campaign.family", -1, -1, "storm")
    for w in range(cfg.waves):
        height = w + 1
        value = _stream(b"campaign-storm-value", cfg.seed, w).digest(32)
        frames = []
        for i in range(a, k):
            for r in range(cfg.wave_votes):
                msg = Prevote(height, r, value, ring[i].public)
                frames.append(
                    (r, i, msg.with_signature(
                        ring[i].sign_digest(msg.digest())
                    ))
                )
        for j in range(a):
            for r in range(cfg.wave_votes * cfg.attack_rate):
                msg = Prevote(height, r, value, ring[j].public)
                frames.append(
                    (r, j, msg.with_signature(
                        _forge(ring[j].sign_digest(msg.digest()))
                    ))
                )
        # Interleave by round so attack traffic rides WITH honest
        # traffic through the gate, not after it.
        frames.sort(key=lambda f: (f[0], f[1]))
        offered0, admitted0 = gate.offered, gate.admitted
        shed_rep0 = gate.shed.get("reputation", 0)
        batch = []
        for _, signer, msg in frames:
            if gate.admit(msg, peer=msg.sender):
                batch.append(
                    (msg.sender, msg.digest(), msg.signature)
                )
        # The admitted window IS the device queue: depth escalates the
        # controller exactly as a DeviceWorkQueue submit burst would.
        ctrl.note_depth(len(batch))
        mask = verifier.verify_signatures(batch)
        per_signer: dict = {}
        for (sender, _, _), ok in zip(batch, mask):
            good, bad = per_signer.get(sender, (0, 0))
            per_signer[sender] = (
                (good + 1, bad) if ok else (good, bad + 1)
            )
        failed = 0
        attacker_rows_verified = 0
        aset = set(attackers)
        for sender, (good, bad) in per_signer.items():
            if sender in aset:
                attacker_rows_verified += good + bad
            if good:
                gate.note_verify(sender, True, good)
            if bad:
                failed += bad
                gate.note_verify(sender, False, bad)
        ctrl.note_drain(len(batch), 0.0)
        if rep is not None:
            # One committed height per wave: the per-commit amnesty.
            rep.rehabilitate(1)
        waves.append({
            "wave": w,
            "offered": gate.offered - offered0,
            "admitted": gate.admitted - admitted0,
            "verified_rows": len(batch),
            "failed_rows": failed,
            "attacker_rows_verified": attacker_rows_verified,
            "shed_reputation": gate.shed.get("reputation", 0)
            - shed_rep0,
            "level": ctrl.level,
        })
        if obs is not NULL_BOUND:
            obs.emit(
                "campaign.wave", height, -1,
                "rows=%d failed=%d level=%d"
                % (len(batch), failed, ctrl.level),
            )
    snap = gate.snapshot()
    return {
        "family": "storm",
        "seed": cfg.seed,
        "reputation": bool(cfg.reputation),
        "honest": sorted(_peer_label(p) for p in honest),
        "attackers": sorted(_peer_label(p) for p in attackers),
        "honest_rows": honest_rows,
        "waves": waves,
        "gate": {
            "offered": snap["offered"],
            "admitted": snap["admitted"],
            "shed": dict(sorted(snap["shed"].items())),
            "level": snap["level"],
            "verify_failed": {
                _peer_label(p): rows
                for p, rows in sorted(
                    snap["verify_failed_by_peer"].items(),
                    key=lambda kv: _peer_label(kv[0]),
                )
            },
            "demoted": (
                sorted(_peer_label(p) for p in rep.demoted)
                if rep is not None
                else []
            ),
            "demotions": rep.demotions if rep is not None else 0,
        },
    }


# -------------------------------------------------------------- capture


class _CampaignSource(BlockSource):
    """BlockSource with adversary plan overlays: boundary heights with
    a registered plan serve the planned block (base columns + appended
    adversary rows); every other height passes through untouched, so
    the honest background workload is bit-identical to a plain run."""

    def __init__(self, config: ExecutionConfig):
        super().__init__(config)
        self.plans: dict[int, TxBlock] = {}

    def block(self, height: int) -> TxBlock:
        planned = self.plans.get(height)
        if planned is not None:
            return planned
        return super().block(height)


def _planned_block(
    base: TxBlock, rows, epoch: int, cand: int
) -> TxBlock:
    """Base block + adversary rows appended, as a fresh TxBlock. The
    digest binds the base content and the plan identity (not used for
    state — sign_txs is off on campaign ledgers — but keeps blocks
    distinguishable in obs detail and cache keys)."""
    kind, sender, recipient, amount = (c.copy() for c in base._np)
    if rows:
        ak = np.array([r[0] for r in rows], dtype=np.int32)
        asnd = np.array([r[1] for r in rows], dtype=np.int32)
        arcp = np.array([r[2] for r in rows], dtype=np.int32)
        aamt = np.array([r[3] for r in rows], dtype=np.int32)
        kind = np.concatenate([kind, ak])
        sender = np.concatenate([sender, asnd])
        recipient = np.concatenate([recipient, arcp])
        amount = np.concatenate([amount, aamt])
    digest = hashlib.sha256(
        b"campaign-plan" + base.digest
        + epoch.to_bytes(8, "little") + cand.to_bytes(8, "little")
    ).digest()
    return TxBlock(base.height, kind, sender, recipient, amount, digest)


def _grind_plan(cfg: CampaignConfig, epoch: int, cand: int) -> list:
    """Candidate ``cand``'s adversary rows for the epoch boundary.

    Candidate 0 is the null plan (the passive baseline the grinder
    must beat). Others are stake-conserving rotations and delegation
    churn among the sybils: each UNSTAKE is paired with an equal STAKE
    on another sybil, so total adversary stake never changes — the
    only degree of freedom being ground is the election seed, exactly
    the attack surface the proportionality bound must absorb."""
    if cand == 0:
        return []
    s = cfg.sybils
    draws = np.frombuffer(
        _stream(
            b"campaign-grind", cfg.seed, epoch, cand
        ).digest(16 * s),
        dtype="<u4",
    ).reshape(s, 4)
    rows = []
    for i in range(s):
        src = int(draws[i, 0]) % s
        dst = int(draws[i, 1]) % s
        if src == dst:
            dst = (dst + 1) % s
        amt = 1 + int(draws[i, 2]) % 16
        if draws[i, 3] & 1:
            # Rotation: move stake weight between sybils.
            rows.append((KIND_UNSTAKE, src, src, amt))
            rows.append((KIND_STAKE, dst, dst, amt))
        else:
            # Delegation churn: shuffle balances (the STAKE headroom)
            # without touching current weight.
            rows.append((KIND_TRANSFER, src, dst, amt))
    return rows


def _genesis_stakes(cfg: CampaignConfig) -> list:
    """Per-account genesis stakes: every honest validator holds
    ``_HONEST_STAKE``; the adversary's total is sized so its share of
    the pool is exactly ``budget_milli`` (integer arithmetic, the
    remainder parked on sybil 0)."""
    n, s = cfg.validators, cfg.sybils
    honest_total = _HONEST_STAKE * (n - s)
    adv_total = honest_total * cfg.budget_milli // (
        1000 - cfg.budget_milli
    )
    per_sybil = adv_total // s
    stakes = [per_sybil] * s + [_HONEST_STAKE] * (n - s)
    stakes[0] += adv_total - per_sybil * s
    return stakes


_HONEST_STAKE = 1000


def run_capture(
    cfg: CampaignConfig, verifier=None, registry=None, obs=NULL_BOUND
) -> dict:
    """Validator-set capture across ``cfg.epochs`` consecutive epochs.

    Each epoch boundary, the adversary probes ``grind_width`` candidate
    boundary blocks through the real executor (snapshot / apply /
    restore — the speculation machinery's own primitives), predicts
    the resulting election with the exact transition_at anchor
    derivation, commits the best candidate through the live
    ``advance_to`` + ``transition_at`` path, and the trajectory records
    realized seats against realized stake share. The monitor's
    proportionality check is the verdict.

    Capture verifies no signature: ``verifier`` is there for the engines'
    common signature and is not used."""
    cfg.validate()
    n, k, s = cfg.validators, cfg.committee_size, cfg.sybils
    exec_cfg = ExecutionConfig(
        accounts=n,
        txs_per_block=32,
        stake_every=3,
        stake_accounts=n,
        seed=cfg.seed,
        amount_cap=32,
        stake_floor=1,
    )
    source = _CampaignSource(exec_cfg)
    ex = HostLedgerExecutor(
        exec_cfg, genesis_stakes=_genesis_stakes(cfg), source=source
    )
    sched = EpochSchedule(
        ex.election_stakes(n), k, cfg.epoch_length, cfg.seed
    )
    seed8 = sched.seed.to_bytes(8, "little")
    if obs is not NULL_BOUND:
        obs.emit("campaign.family", -1, -1, "capture")
    trajectory = []
    for epoch in range(1, cfg.epochs + 1):
        boundary = epoch * cfg.epoch_length
        ex.advance_to(boundary - 1)
        base = BlockSource.block(source, boundary)
        prev_anchor = sched.anchor(epoch - 1)
        epoch8 = epoch.to_bytes(8, "little")
        snap = ex._snapshot()
        best_cand, best_seats, passive_seats = 0, -1, 0
        for cand in range(cfg.grind_width):
            blk = _planned_block(
                base, _grind_plan(cfg, epoch, cand), epoch, cand
            )
            ex._apply_chain(boundary, blk, None)
            # The exact transition_at derivation, run ahead of time:
            # candidate root -> anchor -> election. Any drift here and
            # the grinder would be probing a different lottery than
            # the one the schedule runs.
            anchor = hashlib.sha256(
                _EPOCH_TAG + b"anchor" + seed8 + epoch8
                + prev_anchor + hashlib.sha256(ex.root).digest()
            ).digest()
            members = elect_committee(
                ex.election_stakes(n), k, anchor + b"elect"
            )
            seats = sum(1 for i in members if i < s)
            ex._restore(snap)
            ex.roots.pop(boundary, None)
            if cand == 0:
                passive_seats = seats
            if seats > best_seats:
                best_cand, best_seats = cand, seats
        source.plans[boundary] = _planned_block(
            base, _grind_plan(cfg, epoch, best_cand), epoch, best_cand
        )
        root = ex.advance_to(boundary)
        stakes_now = ex.election_stakes(n)
        tr = sched.transition_at(boundary, root, stakes=stakes_now)
        seats = sum(1 for v in tr.committee if v.index < s)
        adv_stake = sum(stakes_now[:s])
        trajectory.append({
            "epoch": epoch,
            "seats": seats,
            "passive_seats": passive_seats,
            "committee": k,
            "adv_stake": adv_stake,
            "total_stake": sum(stakes_now),
            "candidate": best_cand,
            "root": root[:8].hex(),
        })
        if obs is not NULL_BOUND:
            obs.emit(
                "campaign.grind", boundary, -1,
                "cand=%d seats=%d passive=%d"
                % (best_cand, best_seats, passive_seats),
            )
            obs.emit(
                "campaign.epoch", boundary, -1,
                "e=%d seats=%d/%d" % (epoch, seats, k),
            )
        if registry is not None:
            registry.count("campaign.epochs")
            registry.count("campaign.adv_seats", seats)
    return {
        "family": "capture",
        "seed": cfg.seed,
        "validators": n,
        "sybils": s,
        "budget_milli": cfg.budget_milli,
        "grind_width": cfg.grind_width,
        "trajectory": trajectory,
        "seats_total": sum(t["seats"] for t in trajectory),
        "passive_total": sum(t["passive_seats"] for t in trajectory),
        "final_root": trajectory[-1]["root"],
    }


# ---------------------------------------------------------- coincidence


def run_coincidence(
    cfg: CampaignConfig, verifier, registry=None, obs=NULL_BOUND
) -> dict:
    """Everything at once: the capture loop, a per-epoch signature
    storm through a shared admission gate, and a partition slicing the
    epoch's aggregation tree along a level boundary, with overlay
    contribution scores charging the silenced slots exactly as live
    observers would. Safety currency stays the same — proportionality
    over the trajectory, never-starve under the slice, and no honest
    peer left permanently demoted after the heal runway."""
    cfg.validate()
    n, k, s = cfg.validators, cfg.committee_size, cfg.sybils
    exec_cfg = ExecutionConfig(
        accounts=n,
        txs_per_block=32,
        stake_every=3,
        stake_accounts=n,
        seed=cfg.seed,
        amount_cap=32,
        stake_floor=1,
    )
    source = _CampaignSource(exec_cfg)
    ex = HostLedgerExecutor(
        exec_cfg, genesis_stakes=_genesis_stakes(cfg), source=source
    )
    sched = EpochSchedule(
        ex.election_stakes(n), k, cfg.epoch_length, cfg.seed
    )
    seed8 = sched.seed.to_bytes(8, "little")
    ring = KeyRing.deterministic(
        n, namespace=b"campaign-coin-%d" % cfg.seed
    )
    rep = (
        SignerReputation(registry=registry, obs=obs)
        if cfg.reputation
        else None
    )
    honest_rows = (k - s) * cfg.wave_votes
    ctrl = BackpressureController(
        depth_low_priority=honest_rows * 2,
        depth_critical=(honest_rows + k * cfg.wave_votes
                        * cfg.attack_rate) * 4,
        hysteresis=2,
        registry=registry,
        obs=obs,
    )
    gate = AdmissionGate(
        ctrl, reputation=rep, registry=registry, obs=obs
    )
    scores = ContributionScores(n)
    if obs is not NULL_BOUND:
        obs.emit("campaign.family", -1, -1, "coincidence")
    trajectory = []
    overlay_epochs = []
    storm_epochs = []
    for epoch in range(1, cfg.epochs + 1):
        boundary = epoch * cfg.epoch_length
        ex.advance_to(boundary - 1)
        base = BlockSource.block(source, boundary)
        prev_anchor = sched.anchor(epoch - 1)
        epoch8 = epoch.to_bytes(8, "little")
        snap = ex._snapshot()
        best_cand, best_seats, passive_seats = 0, -1, 0
        for cand in range(cfg.grind_width):
            blk = _planned_block(
                base, _grind_plan(cfg, epoch, cand), epoch, cand
            )
            ex._apply_chain(boundary, blk, None)
            anchor = hashlib.sha256(
                _EPOCH_TAG + b"anchor" + seed8 + epoch8
                + prev_anchor + hashlib.sha256(ex.root).digest()
            ).digest()
            members = elect_committee(
                ex.election_stakes(n), k, anchor + b"elect"
            )
            seats = sum(1 for i in members if i < s)
            ex._restore(snap)
            ex.roots.pop(boundary, None)
            if cand == 0:
                passive_seats = seats
            if seats > best_seats:
                best_cand, best_seats = cand, seats
        source.plans[boundary] = _planned_block(
            base, _grind_plan(cfg, epoch, best_cand), epoch, best_cand
        )
        root = ex.advance_to(boundary)
        stakes_now = ex.election_stakes(n)
        tr = sched.transition_at(boundary, root, stakes=stakes_now)
        committee = tr.committee
        seats = sum(1 for v in committee if v.index < s)
        trajectory.append({
            "epoch": epoch,
            "seats": seats,
            "passive_seats": passive_seats,
            "committee": k,
            "adv_stake": sum(stakes_now[:s]),
            "total_stake": sum(stakes_now),
            "candidate": best_cand,
            "root": root[:8].hex(),
        })
        # ---- signature storm, this epoch's committee as signers.
        value = _stream(
            b"campaign-coin-value", cfg.seed, epoch
        ).digest(32)
        frames = []
        for slot, v in enumerate(committee):
            kp = ring[v.index]
            if v.index < s:
                for r in range(cfg.wave_votes * cfg.attack_rate):
                    msg = Prevote(boundary, r, value, kp.public)
                    frames.append((r, slot, msg.with_signature(
                        _forge(kp.sign_digest(msg.digest()))
                    )))
            else:
                for r in range(cfg.wave_votes):
                    msg = Prevote(boundary, r, value, kp.public)
                    frames.append((r, slot, msg.with_signature(
                        kp.sign_digest(msg.digest())
                    )))
        frames.sort(key=lambda f: (f[0], f[1]))
        batch = []
        for _, _, msg in frames:
            if gate.admit(msg, peer=msg.sender):
                batch.append(
                    (msg.sender, msg.digest(), msg.signature)
                )
        ctrl.note_depth(len(batch))
        mask = verifier.verify_signatures(batch)
        per_signer: dict = {}
        for (sender, _, _), ok in zip(batch, mask):
            good, bad = per_signer.get(sender, (0, 0))
            per_signer[sender] = (
                (good + 1, bad) if ok else (good, bad + 1)
            )
        failed = 0
        for sender, (good, bad) in per_signer.items():
            if good:
                gate.note_verify(sender, True, good)
            if bad:
                failed += bad
                gate.note_verify(sender, False, bad)
        ctrl.note_drain(len(batch), 0.0)
        storm_epochs.append({
            "epoch": epoch,
            "verified_rows": len(batch),
            "failed_rows": failed,
            "shed_reputation": gate.shed.get("reputation", 0),
            "level": ctrl.level,
        })
        # ---- partition: slice the epoch's aggregation tree along a
        # level boundary; the silenced group's slots are charged
        # "withheld" once per in-epoch height, exactly as their
        # observers would under a real slice.
        topo = Topology(
            cfg.seed, sched.anchor(epoch),
            [v.signatory for v in committee],
        )
        level = max(1, topo.levels - 2)
        groups = topo.level_groups(level)
        pick = int.from_bytes(
            _stream(b"campaign-slice", cfg.seed, epoch).digest(8),
            "little",
        ) % len(groups)
        sliced = set(groups[pick])
        windows_exhausted = 0
        fallback_engaged = 0
        for slot in range(len(committee)):
            if slot in sliced:
                continue
            contacts = topo.contacts(slot, 1, 2)
            if contacts and all(c in sliced for c in contacts):
                # Every level-1 contact is dark: the retry windows
                # exhaust and the ranked direct-gossip fallback MUST
                # engage (the never-starve doctrine) — modeled here,
                # asserted by the monitor.
                windows_exhausted += 1
                fallback_engaged += 1
        for _ in range(cfg.epoch_length):
            for slot in range(len(committee)):
                idx = committee[slot].index
                if slot in sliced:
                    scores.charge(idx, "withheld")
                else:
                    scores.credit_coverage(idx, 1)
            scores.rehabilitate(1)
            if rep is not None:
                rep.rehabilitate(1)
        overlay_epochs.append({
            "epoch": epoch,
            "sliced": len(sliced),
            "windows_exhausted": windows_exhausted,
            "fallback_engaged": fallback_engaged,
            "demoted": len(scores.demoted),
        })
        if obs is not NULL_BOUND:
            obs.emit(
                "campaign.partition", boundary, -1,
                "level=%d sliced=%d" % (level, len(sliced)),
            )
            obs.emit(
                "campaign.epoch", boundary, -1,
                "e=%d seats=%d/%d" % (epoch, seats, k),
            )
    # Heal runway: the slice lifts, amnesty plus fresh contribution
    # credit repay any honest debt (O(depth/heal_rate) heights — the
    # score floor is -64, each runway height repays 3).
    runway = (-ContributionScores(1).floor) // 3 + 3
    for _ in range(runway):
        for idx in range(n):
            scores.credit_coverage(idx, 1)
        scores.rehabilitate(1)
    if obs is not NULL_BOUND:
        obs.emit(
            "campaign.heal", -1, -1, "runway=%d" % runway
        )
    honest_demoted = sorted(
        idx for idx in scores.demoted if idx >= s
    )
    return {
        "family": "coincidence",
        "seed": cfg.seed,
        "validators": n,
        "sybils": s,
        "budget_milli": cfg.budget_milli,
        "grind_width": cfg.grind_width,
        "reputation": bool(cfg.reputation),
        "trajectory": trajectory,
        "storm": storm_epochs,
        "overlay": overlay_epochs,
        "honest_demoted_final": honest_demoted,
        "seats_total": sum(t["seats"] for t in trajectory),
        "final_root": trajectory[-1]["root"],
    }


ENGINES = {
    "storm": run_storm,
    "capture": run_capture,
    "coincidence": run_coincidence,
}
