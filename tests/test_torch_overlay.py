"""The port's aggregation overlay against the JAX package's.

Each case drives the same seeded scenario through the JAX package's
``Simulation(overlay=...)`` and the port's (``device="cpu"``: a signed run
verifies through ``HostVerifier``, BLS partial merges fold on the host
unless a queue is passed) and requires the same commits, the same step
count and the same overlay accounting (frames by kind, verify rows,
scores, demotions, topology digest). Everything compared is an integer,
a byte string or a boolean: the tolerance is exact equality.

Left for later slices, with the subsystems they need: the JAX file's
chaos cases (the fault-plan family, honest recovery after a partition
heals, the invariant monitor) and the ``obs report`` decoder.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from hyperdrive_tpu.chaos.plan import FaultPlan
from hyperdrive_tpu.epochs import EpochConfig as RefEpochConfig
from hyperdrive_tpu.epochs import genesis_anchor as ref_genesis_anchor
from hyperdrive_tpu.harness.sim import ScenarioRecord as RefScenarioRecord
from hyperdrive_tpu.harness.sim import Simulation as RefSimulation
from hyperdrive_tpu.overlay import OverlayConfig as RefOverlayConfig
from hyperdrive_tpu.overlay import OverlayFaults as RefOverlayFaults
from hyperdrive_tpu.overlay import Topology as RefTopology
from hyperdrive_tpu_torch.devsched import DeviceWorkQueue
from hyperdrive_tpu_torch.epochs import EpochConfig, genesis_anchor
from hyperdrive_tpu_torch.harness.sim import ScenarioRecord, Simulation
from hyperdrive_tpu_torch.overlay import (
    CHARGE_WEIGHTS,
    ContributionScores,
    OverlayConfig,
    OverlayFaults,
    OverlayFrame,
    Topology,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _identities(seed, n):
    return [hashlib.sha256(b"sim-replica-%d-%d" % (seed, i)).digest() for i in range(n)]


def _pair(overlay=None, faults=None, epochs=None, **kw):
    """The same scenario in both packages; ``overlay`` is a dict of
    OverlayConfig fields (None: all-to-all), ``faults`` of OverlayFaults
    fields, ``epochs`` of EpochConfig fields."""
    out = []
    for Sim, Cfg, Faults, Epochs, extra in (
        (RefSimulation, RefOverlayConfig, RefOverlayFaults, RefEpochConfig, {}),
        (Simulation, OverlayConfig, OverlayFaults, EpochConfig, dict(device="cpu")),
    ):
        args = dict(kw, **extra)
        if overlay is not None:
            cfg = dict(overlay)
            if faults is not None:
                cfg["faults"] = Faults(**faults)
            args["overlay"] = Cfg(**cfg)
        if epochs is not None:
            args["epochs"] = Epochs(**epochs)
        sim = Sim(**args)
        out.append((sim, sim.run(max_steps=200_000)))
    return out


def _same_run(pair):
    (ref, rres), (sim, res) = pair
    assert res.completed == rres.completed
    assert res.steps == rres.steps
    assert res.commits == rres.commits
    assert res.virtual_time == rres.virtual_time
    if ref._overlay is not None:
        assert sim.overlay_snapshot() == ref.overlay_snapshot()
    return sim, res


# ---------------------------------------------------------------- topology


def test_topology_is_pure_function_of_seed_anchor_and_set():
    ids = _identities(3, 12)
    a = Topology(3, genesis_anchor(3), ids)
    b = Topology(3, genesis_anchor(3), list(ids))
    assert a.digest() == b.digest() and a.rank == b.rank
    assert a.digest() == RefTopology(3, ref_genesis_anchor(3), ids).digest()
    assert Topology(4, genesis_anchor(3), ids).digest() != a.digest()
    assert Topology(3, genesis_anchor(4), ids).digest() != a.digest()
    assert Topology(3, genesis_anchor(3), ids[:-1]).digest() != a.digest()


_PROBE = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
from hyperdrive_tpu_torch.epochs import EpochConfig, genesis_anchor
from hyperdrive_tpu_torch.harness.sim import Simulation
from hyperdrive_tpu_torch.overlay import OverlayConfig, OverlayFaults, Topology
ids = [hashlib.sha256(b"sim-replica-%d-%d" % (7, i)).digest() for i in range(9)]
sim = Simulation(n=8, seed=77, target_height=4, delivery_cost=1e-3, device="cpu",
                 epochs=EpochConfig(epoch_length=2, committee_size=8, rekey_per_epoch=2),
                 overlay=OverlayConfig(faults=OverlayFaults(byzantine=(5,), garbage_rate=0.4)))
res = sim.run()
print(json.dumps({"topo": Topology(7, genesis_anchor(7), ids).digest().hex(),
                  "digest": res.commit_digest(), "steps": res.steps,
                  "snap": sim.overlay_snapshot()}))
"""


def test_topology_and_runs_identical_across_processes():
    # Nothing process-local (hash randomization, dict order, id()) may
    # reach the tree or the run: a fresh interpreter under another
    # PYTHONHASHSEED gives the same topology digest, and the same
    # Byzantine epoch-rekeying overlay run, as this one and the JAX package.
    ids = _identities(7, 9)
    local = Topology(7, genesis_anchor(7), ids).digest().hex()
    assert local == RefTopology(7, ref_genesis_anchor(7), ids).digest().hex()
    env = dict(os.environ, PYTHONHASHSEED="12345")
    out = json.loads(subprocess.run(
        [sys.executable, "-c", _PROBE, ROOT], capture_output=True, text=True,
        check=True, env=env, timeout=120,
    ).stdout.splitlines()[-1])
    assert out["topo"] == local
    (_, rres), (sim, res) = _pair(
        n=8, seed=77, target_height=4, delivery_cost=1e-3, overlay={},
        faults=dict(byzantine=(5,), garbage_rate=0.4),
        epochs=dict(epoch_length=2, committee_size=8, rekey_per_epoch=2))
    assert out["digest"] == res.commit_digest() == rres.commit_digest()
    assert out["steps"] == res.steps == rres.steps
    assert out["snap"] == json.loads(json.dumps(sim.overlay_snapshot()))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 16])
def test_topology_structure_matches_jax(n):
    ids = _identities(11, n)
    t = Topology(11, genesis_anchor(11), ids)
    r = RefTopology(11, ref_genesis_anchor(11), ids)
    assert t.rank == r.rank and t.digest() == r.digest()
    assert sorted(t.rank) == sorted(set(t.rank))
    assert t.size >= n and t.size == 1 << max(0, t.levels)
    for lvl in range(1, t.levels + 1):
        groups = t.level_groups(lvl)
        assert groups == r.level_groups(lvl)
        seen = set()
        for g in groups:
            assert not (seen & set(g))
            seen |= set(g)
        assert seen == set(range(n))
        for node in range(n):
            assert t.block_mask(node, lvl) == r.block_mask(node, lvl)
            assert list(t.contacts(node, lvl, 4)) == list(r.contacts(node, lvl, 4))


def test_topology_contacts_prefix_stable():
    t = Topology(5, genesis_anchor(5), _identities(5, 16))
    short = list(t.contacts(0, 3, 2))
    assert list(t.contacts(0, 3, 6))[:2] == short


# ----------------------------------------------------------------- scoring


def test_scores_charge_demote_recover_cycle():
    events = []
    s = ContributionScores(
        4,
        on_demote=lambda p, sc, cls: events.append(("demote", p, cls)),
        on_recover=lambda p, sc: events.append(("recover", p)),
    )
    for _ in range(2):
        s.charge(1, "invalid")
    assert s.is_demoted(1) and events[0] == ("demote", 1, "invalid")
    assert s.ranked()[-1] == 1
    s.credit_coverage(1, 3)
    assert not s.is_demoted(1) and ("recover", 1) in events
    assert s.charges["invalid"] == 2


def test_scores_clamp_at_floor_and_weights_match_vocabulary():
    s = ContributionScores(2, floor=-10)
    for _ in range(50):
        s.charge(0, "invalid")
    assert s.scores[0] == -10
    assert set(CHARGE_WEIGHTS) == {"invalid", "stale_generation", "duplicate", "withheld"}


def test_scores_rehabilitate_pulls_toward_zero_and_recovers():
    s = ContributionScores(3)
    for _ in range(4):
        s.charge(2, "invalid")
    s.credit_coverage(0, 5)
    assert s.is_demoted(2)
    s.rehabilitate(10)
    assert s.scores[2] == -14 and s.is_demoted(2)
    s.rehabilitate(10)
    assert s.scores[2] == -4 and not s.is_demoted(2)
    assert s.scores[0] == 0
    s.rehabilitate(10)
    assert s.scores[0] == 0


# -------------------------------------------------------------- validation


@pytest.mark.parametrize("cfg", [
    dict(fanout=0), dict(max_waves=0), dict(level_window=0.0), dict(heal_rate=-1),
], ids=["fanout", "max_waves", "level_window", "heal_rate"])
def test_config_validation_errors(cfg):
    with pytest.raises(ValueError):
        OverlayConfig(**cfg).validate(8)
    with pytest.raises(ValueError):
        RefOverlayConfig(**cfg).validate(8)


@pytest.mark.parametrize("faults", [
    dict(byzantine=(0, 1, 2)), dict(byzantine=(9,)), dict(garbage_rate=1.5),
], ids=["over_f", "out_of_range", "garbage_rate"])
def test_fault_validation_errors(faults):
    with pytest.raises(ValueError):
        OverlayFaults(**faults).validate(8)


@pytest.mark.parametrize("kw,match", [
    (dict(delivery_cost=0.0), "delivery_cost"),
    (dict(delivery_cost=1e-3, drop_rate=0.1), "drop/reorder"),
    (dict(delivery_cost=1e-3, reorder=True), "drop/reorder"),
    (dict(delivery_cost=1e-3, burst=True), "lock-step"),
    (dict(delivery_cost=1e-3, verifier_for=lambda i: None), "verifier_for"),
], ids=["no_pacing", "drop", "reorder", "burst", "verifier_for"])
def test_overlay_run_refusals_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        Simulation(n=8, target_height=2, overlay=OverlayConfig(), device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        RefSimulation(n=8, target_height=2, overlay=RefOverlayConfig(), **kw)


def test_overlay_requires_full_committee_with_epochs():
    for Sim, Cfg, Ep in ((Simulation, OverlayConfig, EpochConfig),
                         (RefSimulation, RefOverlayConfig, RefEpochConfig)):
        with pytest.raises(ValueError, match="committee_size"):
            Sim(n=8, target_height=4, delivery_cost=1e-3,
                epochs=Ep(epoch_length=2, committee_size=6), overlay=Cfg())


# ----------------------------------------------------- digest neutrality


@pytest.mark.parametrize("n", [8, 16])
def test_overlay_matches_jax_and_all_to_all(n):
    sim, res = _same_run(_pair(n=n, seed=23, target_height=4, delivery_cost=1e-3,
                               overlay={}))
    base = Simulation(n=n, seed=23, target_height=4, delivery_cost=1e-3, device="cpu").run()
    assert res.completed and res.commit_digest(up_to=4) == base.commit_digest(up_to=4)
    snap = sim.overlay_snapshot()
    assert snap["frames"] > 0 and snap["scores"]["demoted"] == []
    assert sim._sched is None  # unsigned, no BLS: no queue at all


def test_overlay_neutral_under_byzantine_contributors():
    sim, res = _same_run(_pair(
        n=16, seed=31, target_height=4, delivery_cost=1e-3, overlay={},
        faults=dict(byzantine=(2, 9), withhold_levels=(1,), garbage_rate=0.5)))
    base = Simulation(n=16, seed=31, target_height=4, delivery_cost=1e-3, device="cpu").run()
    assert res.commit_digest(up_to=4) == base.commit_digest(up_to=4)
    snap = sim.overlay_snapshot()
    assert snap["frames_garbage"] > 0 and snap["frames_withheld"] > 0
    assert set(snap["scores"]["demoted"]) <= {2, 9}
    assert snap["honest_demoted"] == []


def test_overlay_replay_from_dump_needs_no_overlay_wiring(tmp_path):
    (ref, rres), (sim, res) = _pair(
        n=8, seed=45, target_height=4, delivery_cost=1e-3, overlay={},
        faults=dict(byzantine=(5,), garbage_rate=0.4))
    assert res.completed and res.commits == rres.commits
    res.record.dump(tmp_path / "port")
    rres.record.dump(tmp_path / "jax")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert Simulation.replay(sim.record).commits == res.commits
    assert Simulation.replay(ScenarioRecord.load(tmp_path / "jax")).commits == res.commits


def test_overlay_dump_is_byte_identical_to_jax(tmp_path):
    # The n = 16 unsigned run of the overlay bench's seed: frames and ticks
    # are never recorded, constituent votes are plain (to, vote) tuples.
    (_, rres), (_, res) = _pair(n=16, seed=29, target_height=2, delivery_cost=1e-3,
                                overlay={})
    res.record.dump(tmp_path / "port")
    rres.record.dump(tmp_path / "jax")
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "jax").read_bytes()
    assert res.steps == rres.steps and len(res.record.messages) < res.steps


def test_overlay_coalesced_ingest_matches_jax_and_per_message():
    sim, res = _same_run(_pair(n=8, seed=52, target_height=4, delivery_cost=1e-3,
                               overlay=dict(coalesce_ingest=True)))
    plain = Simulation(n=8, seed=52, target_height=4, delivery_cost=1e-3, device="cpu",
                       overlay=OverlayConfig()).run()
    assert res.completed and res.commit_digest(up_to=4) == plain.commit_digest(up_to=4)


def test_signed_overlay_verifies_each_vote_exactly_once():
    n, h = 8, 3
    sim, res = _same_run(_pair(n=n, seed=61, target_height=h, delivery_cost=1e-3,
                               sign=True, overlay={}))
    base = Simulation(n=n, seed=61, target_height=h, delivery_cost=1e-3, sign=True,
                      device="cpu").run()
    assert res.commit_digest(up_to=h) == base.commit_digest(up_to=h)
    snap = sim.overlay_snapshot()
    assert 0 < snap["verify_rows"] <= 2 * n * (h + 1) + n
    # One shared verifier behind the queue; the drain after every submit
    # makes launches equal submissions, and replicas verify nothing.
    q = sim._sched
    assert q.launches == q.submitted > 0 and q.coalesced == 0
    assert all(r.verifier is None for r in sim.replicas)


# ------------------------------------------------------------------ epochs


def test_overlay_rekeys_at_epoch_boundaries():
    epochs = dict(epoch_length=2, committee_size=8, rekey_per_epoch=2)
    sim, res = _same_run(_pair(n=8, seed=77, target_height=6, delivery_cost=1e-3,
                               overlay={}, epochs=epochs))
    base = Simulation(n=8, seed=77, target_height=6, delivery_cost=1e-3, device="cpu",
                      epochs=EpochConfig(**epochs)).run()
    assert res.completed and res.commit_digest(up_to=6) == base.commit_digest(up_to=6)
    assert sim.overlay_snapshot()["rekeys"] >= 2 and sim.epoch >= 2


# ------------------------------------------------------------ laggard sweep


def test_swept_resyncs_are_recorded_and_replay_in_both_packages(tmp_path):
    # A sweep every 64 steps with no tolerated lag resyncs the wavefront's
    # stragglers: each resync is an OP_RESYNC op at its delivery position,
    # and either package replays either dump to the same commits.
    (ref, rres), (sim, res) = _pair(
        n=8, seed=45, target_height=4, delivery_cost=1e-3, overlay={},
        faults=dict(byzantine=(5,), garbage_rate=0.4), catchup_every=64, catchup_lag=0)
    assert res.completed and res.commits == rres.commits
    ops = res.record.lifecycle
    assert ops == rres.record.lifecycle and len(ops) > 0
    assert {op[0] for op in ops} == {ScenarioRecord.OP_RESYNC}
    res.record.dump(tmp_path / "port")
    rres.record.dump(tmp_path / "jax")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    port_again = Simulation.replay(ScenarioRecord.load(tmp_path / "jax"))
    jax_again = RefSimulation.replay(RefScenarioRecord.load(tmp_path / "port"))
    assert port_again.commits == jax_again.commits == res.commits


# ------------------------------------------------------------ BLS partials


def test_overlay_bls_partials_digest_neutral():
    sim, res = _same_run(_pair(n=4, target_height=3, seed=11, timeout=1.0,
                               delivery_cost=1e-3, overlay=dict(bls_partials=True)))
    base = Simulation(n=4, target_height=3, seed=11, timeout=1.0, delivery_cost=1e-3,
                      device="cpu").run(max_steps=200_000)
    assert res.commit_digest(up_to=3) == base.commit_digest(up_to=3)
    snap = sim.overlay_snapshot()
    assert snap["bls_partials"] is True and snap["bls_partials_attached"] > 0
    assert snap["bls_partial_rejects"] == 0
    # A CPU run without a queue folds on the host.
    assert sim._overlay._bls_launcher is None


def test_overlay_bls_corrupted_aggregate_charged_at_merge():
    # The overlay faults of the JAX package's chaos family for (11, 8),
    # without the partitions and crashes: garblers send their real coverage
    # under a corrupted aggregate, which the receiver's recomputed masked
    # sum catches before any merge. Then a probe replays a real frame with
    # one flipped aggregate byte.
    _, faults = FaultPlan.overlay(11, 8)
    sim, res = _same_run(_pair(
        n=8, target_height=3, seed=11, timeout=1.0, delivery_cost=1e-3,
        overlay=dict(bls_partials=True),
        faults=dict(byzantine=faults.byzantine, withhold_levels=faults.withhold_levels,
                    garbage_rate=faults.garbage_rate, stale_rate=faults.stale_rate)))
    rt = sim._overlay
    assert res.completed and rt.bls_partial_rejects > 0
    slot, st = next((sl, s) for sl, s in rt._slots.items() if s.bls)
    mask = st.all_mask
    good = rt._bls_masked_sum(st, mask, 0, 0)
    bad = bytes([good[0] ^ 0x01]) + good[1:]
    to = next((i for i in range(1, 8) if mask & ~st.cov[i]), 1)
    cov, rejects = st.cov[to], rt.bls_partial_rejects
    invalid = rt.scores.charges["invalid"]
    rt.on_frame(to, OverlayFrame(0, slot, 0, mask, agg=bad))
    assert rt.bls_partial_rejects == rejects + 1
    assert rt.scores.charges["invalid"] == invalid + 1
    assert st.cov[to] == cov
    if mask & ~cov:
        rt.on_frame(to, OverlayFrame(0, slot, 0, mask, agg=good))
        assert st.cov[to] != cov


def test_overlay_bls_launcher_on_a_cpu_queue_matches_the_host_fold():
    # The merges through the G1SumLauncher's plain version (a CPU queue)
    # equal the host fold and the JAX run, launch for merge: the drain
    # after each submit keeps launches = submissions. The run is cut at a
    # step bound (about 80 ms a plain merge on one core).
    kw = dict(n=4, target_height=3, seed=11, timeout=1.0, delivery_cost=1e-3)
    q = DeviceWorkQueue()
    dev = Simulation(device="cpu", devsched=q, overlay=OverlayConfig(bls_partials=True), **kw)
    host = Simulation(device="cpu", overlay=OverlayConfig(bls_partials=True), **kw)
    ref = RefSimulation(overlay=RefOverlayConfig(bls_partials=True), **kw)
    got = [s.run(max_steps=12) for s in (dev, host, ref)]
    assert got[0].commits == got[1].commits == got[2].commits
    assert dev.overlay_snapshot() == host.overlay_snapshot() == ref.overlay_snapshot()
    assert dev.record.messages == host.record.messages
    launcher = dev._overlay._bls_launcher
    assert launcher is not None and launcher.device.type == "cpu"
    assert launcher.launched == q.launches == q.submitted > 0
