"""The port's epochs (dynamic validator sets) against the JAX package's.

``hyperdrive_tpu_torch.epochs`` is a copy of the reference module: the
stake-weighted election, the schedule's transitions (committees, joins,
leaves, re-keys, anchors), the digests and identities must equal the
JAX functions' on the same inputs, and the epoch proofs of an n = 8
epoch simulation must marshal to the same bytes. The simulation itself
(lock-step, unsigned, certificates on) must commit the JAX run's chain in
the same steps, its record must replay to the same commits, and the
replica's retired-key filter must drop the JAX replica's stale votes, in
both buffering paths. The
tolerance is exact equality.
"""

import dataclasses

import pytest
import torch

from hyperdrive_tpu import epochs as ref_epochs
from hyperdrive_tpu.codec import Writer as RefWriter
from hyperdrive_tpu.harness.sim import ScenarioRecord as RefScenarioRecord
from hyperdrive_tpu.harness.sim import Simulation as RefSimulation
from hyperdrive_tpu.messages import Prevote as RefPrevote
from hyperdrive_tpu.messages import Propose as RefPropose
from hyperdrive_tpu.exec import ExecutionConfig as RefExecutionConfig
from hyperdrive_tpu.overlay import OverlayConfig as RefOverlayConfig
from hyperdrive_tpu_torch import epochs
from hyperdrive_tpu_torch.codec import Reader, Writer
from hyperdrive_tpu_torch.epochs import (
    EpochChainError,
    EpochConfig,
    EpochSchedule,
    marshal_epoch_proof,
    unmarshal_epoch_proof,
    verify_epoch_chain,
)
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.harness import ScenarioRecord, Simulation
from hyperdrive_tpu_torch.messages import Prevote, Propose
from hyperdrive_tpu_torch.overlay import OverlayConfig

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

V = bytes(range(32))


@pytest.mark.parametrize("stakes,k,material", [
    ((3, 1, 4, 1, 5, 9, 2, 6), 5, b"material"),
    ((100,) + (1,) * 11, 3, b"m7"),
    ((0, 1, 1, 1), 3, b"z3"),
    ((10,) * 48, 12, b"sybil"),
])
def test_election_and_digests_match_jax(stakes, k, material):
    assert epochs.elect_committee(stakes, k, material) == ref_epochs.elect_committee(
        stakes, k, material)
    assert epochs._draw(material, 5, 97) == ref_epochs._draw(material, 5, 97)
    sigs = [epochs.default_signatory(i, g, namespace=material) for i in range(4) for g in (0, 2)]
    assert sigs == [ref_epochs.default_signatory(i, g, namespace=material)
                    for i in range(4) for g in (0, 2)]
    assert epochs.set_digest(sigs) == ref_epochs.set_digest(sigs)
    assert epochs.transition_digest(3, sigs[0], sigs[1]) == ref_epochs.transition_digest(
        3, sigs[0], sigs[1])
    assert epochs.genesis_anchor(len(stakes)) == ref_epochs.genesis_anchor(len(stakes))


def test_election_refusals():
    with pytest.raises(ValueError, match="exceeds"):
        epochs.elect_committee((1, 0, 1), 3, b"m")
    with pytest.raises(ValueError, match="positive"):
        epochs._draw(b"m", 0, 0)


def test_schedule_boundaries_and_rotations_match_jax():
    stakes = (5, 3, 8, 1, 2, 7, 4, 6, 9, 1)
    kw = dict(rekey_per_epoch=2)
    sched = EpochSchedule(stakes, 7, 3, 42, **kw)
    ref = ref_epochs.EpochSchedule(stakes, 7, 3, 42, **kw)
    assert [sched.epoch_of(h) for h in range(1, 10)] == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert [sched.is_boundary(h) for h in range(1, 7)] == [False, False, True] * 2
    assert sched.boundary_height(2) == 9
    assert sched.signatories(0) == ref.signatories(0)
    override = (1,) * 10
    for e, h in ((1, 3), (2, 6), (3, 9)):
        st = override if e == 2 else None
        tr = sched.transition_at(h, bytes([e]) * 32, stakes=st)
        want = ref.transition_at(h, bytes([e]) * 32, stakes=st)
        assert dataclasses.asdict(tr) == dataclasses.asdict(want)
        assert len(tr.rekeyed) == 2 and len(tr.retired) == 2
        assert sched.anchor(e) == ref.anchor(e) and sched.f(e) == 7 // 3
        # Idempotent per boundary value.
        assert sched.transition_at(h, bytes([e]) * 32) is tr
    assert [sched.generation_of(i) for i in range(10)] == [
        ref.generation_of(i) for i in range(10)]
    with pytest.raises(ValueError, match="fork"):
        sched.transition_at(9, b"\xee" * 32)
    with pytest.raises(ValueError, match="not an epoch boundary"):
        sched.transition_at(10, V)
    with pytest.raises(ValueError, match="out of order"):
        sched.transition_at(15, V)
    with pytest.raises(KeyError):
        sched.transition(9)
    with pytest.raises(ValueError, match="committee_size"):
        EpochSchedule(stakes, 2, 3, 1)


def _epoch_kw(n=8, target=8, seed=3):
    return dict(n=n, target_height=target, seed=seed, certificates=True)


_CFG = dict(epoch_length=2, committee_size=6, rekey_per_epoch=1)


def _union_proofs(sim):
    covered = {}
    for c in sim.certifiers:
        for e, pr in c.proofs.items():
            covered.setdefault(e, pr)
    return [covered[e] for e in sorted(covered)]


@pytest.fixture(scope="module")
def epoch_runs():
    sim = Simulation(epochs=EpochConfig(**_CFG), **_epoch_kw())
    ref = RefSimulation(epochs=ref_epochs.EpochConfig(**_CFG), **_epoch_kw())
    return sim, sim.run(), ref, ref.run()


def test_epoch_sim_matches_jax(epoch_runs):
    sim, got, ref, want = epoch_runs
    assert got.completed and sim.epoch == ref.epoch >= 3
    assert got.commit_digest() == want.commit_digest()
    assert (got.steps, got.heights, got.virtual_time) == (want.steps, want.heights,
                                                          want.virtual_time)
    assert got.cert_digests == want.cert_digests
    assert sim._identity == ref._identity and sim._retired == ref._retired
    assert got.record.epochs == want.record.epochs == (2, 6, 1, 3, (1,) * 8)


def test_epoch_proofs_match_jax_and_verify(epoch_runs):
    sim, _, ref, _ = epoch_runs
    proofs, ref_proofs = _union_proofs(sim), _union_proofs(ref)
    assert [p.epoch for p in proofs] == list(range(1, sim.epoch + 1))
    w, rw = Writer(), RefWriter()
    for p in proofs:
        marshal_epoch_proof(p, w)
    for p in ref_proofs:
        ref_epochs.marshal_epoch_proof(p, rw)
    assert w.data() == rw.data()
    genesis = sim.epoch_schedule.signatories(0)
    assert verify_epoch_chain(genesis, proofs) == len(proofs)
    r = Reader(w.data())
    back = [unmarshal_epoch_proof(r) for _ in proofs]
    assert back == proofs and verify_epoch_chain(genesis, back) == len(proofs)


def test_epoch_chain_rejects_tampering(epoch_runs):
    sim, _, _, _ = epoch_runs
    proofs = _union_proofs(sim)
    genesis = sim.epoch_schedule.signatories(0)
    bad = list(proofs)
    bad[0] = dataclasses.replace(bad[0], next_set_digest=bytes(32))
    with pytest.raises(EpochChainError, match="next-set digest"):
        verify_epoch_chain(genesis, bad)
    with pytest.raises(EpochChainError, match="not consecutive"):
        verify_epoch_chain(genesis, [proofs[0], *proofs[2:]])
    with pytest.raises(EpochChainError, match="prev-set digest"):
        verify_epoch_chain([bytes(32)] * len(genesis), proofs)
    cert = dataclasses.replace(proofs[0].cert, binding=bytes(32))
    with pytest.raises(EpochChainError, match="binding"):
        verify_epoch_chain(genesis, [dataclasses.replace(proofs[0], cert=cert)])
    cert = dataclasses.replace(proofs[0].cert, signers=bytes(len(proofs[0].cert.signers)))
    with pytest.raises(EpochChainError, match="quorum"):
        verify_epoch_chain(genesis, [dataclasses.replace(proofs[0], cert=cert)])


def test_epoch_record_replays_identically(epoch_runs, tmp_path):
    sim, got, _, want = epoch_runs
    path = str(tmp_path / "epochs.bin")
    sim.record.dump(path)
    rec = ScenarioRecord.load(path)
    assert rec.epochs == got.record.epochs
    replayed = Simulation.replay(rec, certificates=True)
    assert replayed.commits == got.commits and replayed.completed
    assert replayed.sim.epoch == sim.epoch
    into_jax = RefSimulation.replay(RefScenarioRecord.load(path), certificates=True)
    assert into_jax.commits == want.commits


def test_stale_generation_vote_rejected():
    # The same votes to replica 0 of the port's and the JAX epoch sim,
    # under the same retired map: the same stale counts after each.
    seen = []
    for sim, P in ((Simulation(epochs=EpochConfig(**_CFG), **_epoch_kw(seed=13)), Prevote),
                   (RefSimulation(epochs=ref_epochs.EpochConfig(**_CFG),
                                  **_epoch_kw(seed=13)), RefPrevote)):
        r = sim.replicas[0]
        assert r.retired is sim._retired
        old = sim.signatories[1]
        r.retired = {old: 3}
        counts = []
        # At or past the retirement bound: dropped, counted, never
        # buffered. Below it the old key still counts: a laggard
        # finishing the boundary height keeps its quorum.
        for h in (5, 7, 2):
            r.handle(P(height=h, round=0, value=V, sender=old))
            counts.append(r.stale_votes)
        seen.append(counts)
    assert seen[0] == seen[1] == [1, 2, 2]


def test_stale_filter_in_burst_buffering():
    seen = []
    for sim, P, Pp in ((Simulation(n=4, target_height=2, seed=1, burst=True), Prevote, Propose),
                       (RefSimulation(n=4, target_height=2, seed=1, burst=True), RefPrevote,
                        RefPropose)):
        r = sim.replicas[0]
        old = sim.signatories[2]
        r.retired = {old: 2}
        r.handle_burst([P(height=1, round=0, value=V, sender=old),
                        P(height=2, round=0, value=V, sender=old),
                        Pp(height=3, round=0, valid_round=-1, value=V, sender=old)])
        seen.append((r.stale_votes, len(r._lane)))
    assert seen[0] == seen[1] == (2, 1)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(burst=True), ValueError, "lock-step"),
    (dict(sign=True), ValueError, "unsigned"),
    (dict(payload_bytes=62), ValueError, "payload"),
    (dict(signatories=[bytes(32)] * 8), ValueError, "signatory function"),
    # An overlay needs the whole pool in the committee; elections read
    # stake accounts 0..n-1, so fewer accounts than replicas is refused
    # (by the executors' genesis stakes, before the reference's own check).
    (dict(overlay=OverlayConfig(), delivery_cost=1e-3), ValueError, "committee_size"),
    (dict(execution=ExecutionConfig(accounts=4, txs_per_block=4, stake_every=0)),
     ValueError, "accounts"),
], ids=["burst", "sign", "payload", "signatories", "overlay", "execution"])
def test_epoch_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        Simulation(n=8, target_height=2, epochs=EpochConfig(**_CFG), device="cpu", **kw)
    ref = dict(kw)
    if "overlay" in ref:
        ref["overlay"] = RefOverlayConfig()
    if "execution" in ref:
        ref["execution"] = RefExecutionConfig(accounts=4, txs_per_block=4, stake_every=0)
    if exc is ValueError:
        with pytest.raises(exc, match=match):
            RefSimulation(n=8, target_height=2, epochs=ref_epochs.EpochConfig(**_CFG), **ref)
