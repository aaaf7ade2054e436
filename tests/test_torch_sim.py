"""The PyTorch port's burst-mode network against the JAX package's.

Same seed, same arguments: the port's ``Simulation`` verifying every settle
through ``TorchBatchVerifier`` on the CPU (the CUDA kernel's plain version)
must commit the same chain in the same number of delivery steps to the
same final heights as the reference ``Simulation`` with its host verifier.
With ``device_tally=True`` the counts come from the port's vote grid on the
CPU, every one checked against the host counters (``CheckedTallyView``).
"""

import numpy as np
import pytest
import torch

from hyperdrive_tpu.chaos import FaultPlan as RefFaultPlan
from hyperdrive_tpu.chaos import Partition as RefPartition
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.messages import Prevote as RefPrevote
from hyperdrive_tpu.ops.votegrid import CheckedTallyView as RefCheckedTallyView
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch import native
from hyperdrive_tpu_torch.chaos import FaultPlan, Partition
from hyperdrive_tpu_torch.crypto import ed25519 as port_ed
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.messages import Prevote
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
from hyperdrive_tpu_torch.verifier import HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

ARGS = dict(n=4, target_height=3, sign=True, burst=True, dedup_verify=True,
            small_window_host=False)


def _reference(seed):
    return RefSimulation(seed=seed, batch_verifier=RefHostVerifier(), **ARGS).run()


@pytest.mark.parametrize("seed", [1, 7])
def test_device_verified_network_matches_reference(seed):
    sim = Simulation(
        seed=seed,
        batch_verifier=TorchBatchVerifier(device="cpu", buckets=(64,)),
        **ARGS,
    )
    ref_ring = RefKeyRing.deterministic(4, namespace=b"sim-%d" % seed)
    assert sim.signatories == ref_ring.signatories
    got = sim.run()
    want = _reference(seed)
    assert got.completed and want.completed
    got.assert_safety()
    assert got.commit_digest(up_to=3) == want.commit_digest(up_to=3)
    assert got.steps == want.steps
    assert got.heights == want.heights
    # Every settle pass went through the batch verifier, votes included.
    assert sim.vote_settles >= 3 and sim.settle_passes > sim.vote_settles
    assert sim.verified_sigs > 0


@pytest.mark.parametrize("seed", [1, 7])
def test_host_baseline_and_default_routing_match_reference(seed, monkeypatch):
    if native.available():
        # The port signs and host-verifies natively: the oracle's signer
        # and verifier are never called.
        def refuse(*args):
            raise AssertionError("pure-Python oracle called with native loaded")

        monkeypatch.setattr(port_ed, "sign", refuse)
        monkeypatch.setattr(port_ed, "verify", refuse)
    host = Simulation(seed=seed, batch_verifier=HostVerifier(), **ARGS).run()
    args = dict(ARGS, small_window_host=None)
    routed = Simulation(seed=seed, device="cpu", **args)
    assert isinstance(routed.batch_verifier, TorchBatchVerifier)
    assert routed._small_win_host is not None
    want = _reference(seed)
    for got in (host, routed.run()):
        assert got.commit_digest(up_to=3) == want.commit_digest(up_to=3)
        assert (got.steps, got.heights) == (want.steps, want.heights)


def test_unported_options_are_refused():
    with pytest.raises(NotImplementedError):
        Simulation(n=4, target_height=1, burst=True, tally_mesh=object())
    with pytest.raises(NotImplementedError, match="observe"):
        Simulation(n=4, target_height=1, burst=True, observe=True)
    # Chaos is ported: a plan with a partition needs delivery pacing, the
    # reference's ValueError in both packages.
    for sim_cls, plan_cls, part_cls in ((Simulation, FaultPlan, Partition),
                                        (RefSimulation, RefFaultPlan, RefPartition)):
        plan = plan_cls(partitions=(part_cls(at=0.1, heal=1.0, groups=((0,),)),))
        with pytest.raises(ValueError, match="delivery_cost"):
            sim_cls(n=4, target_height=1, burst=False, chaos=plan)
    with pytest.raises(ValueError):
        Simulation(n=4, target_height=1, burst=True, small_window_host=True)
    # Unsigned burst mode runs with no verifier at all.
    res = Simulation(n=4, target_height=2, seed=3, burst=True).run()
    want = RefSimulation(n=4, target_height=2, seed=3, burst=True).run()
    assert res.commit_digest(up_to=2) == want.commit_digest(up_to=2)
    with pytest.raises(ValueError, match="device_tally requires burst"):
        Simulation(n=4, target_height=1, burst=False, device_tally=True)
    with pytest.raises(ValueError, match="same device"):
        Simulation(n=4, target_height=1, burst=True, sign=True,
                   dedup_verify=True, device_tally=True, device="cpu",
                   batch_verifier=TorchBatchVerifier(device="meta"))


class _Checks:
    """A ``tally_check`` that keeps every CheckedTallyView it makes."""

    def __init__(self):
        self.views = []

    def __call__(self, view, proc):
        v = CheckedTallyView(view, proc)
        self.views.append(v)
        return v

    @property
    def hits(self) -> int:
        return sum(v.hits for v in self.views)


def _same_run(got, want, height):
    assert got.completed and want.completed
    got.assert_safety()
    assert got.commit_digest(up_to=height) == want.commit_digest(up_to=height)
    assert (got.steps, got.heights) == (want.steps, want.heights)


def test_device_tally_unsigned_network_matches_reference():
    kw = dict(n=7, target_height=5, seed=91, burst=True)
    checks = _Checks()
    sim = Simulation(**kw, device_tally=True, tally_check=checks, device="cpu")
    got = sim.run()
    want = RefSimulation(**kw, device_tally=True,
                         tally_check=RefCheckedTallyView).run()
    _same_run(got, want, 5)
    assert got.commits == want.commits
    assert checks.hits > 0
    # No verifier: every settle pass inserts, then tallies in its own launch.
    assert sim.tally_launches == sim.settle_passes > sim.vote_settles > 0
    assert sim.fused_settles == sim.host_routed_settles == 0


def test_device_tally_fused_signed_network_matches_reference():
    args = dict(ARGS, small_window_host=None)
    checks = _Checks()
    sim = Simulation(seed=1, device="cpu", device_tally=True,
                     tally_check=checks,
                     batch_verifier=TorchBatchVerifier(device="cpu", buckets=(64,)),
                     **args)
    assert sim._fused_ok
    _same_run(sim.run(), _reference(1), 3)
    assert checks.hits > 0
    # Every vote-bearing settle verified, merged and tallied in one call;
    # the propose settles (one signature) went to the host verifier.
    assert sim.fused_settles == sim.vote_settles > 0
    assert sim.tally_launches == 0


def test_device_tally_two_launch_signed_network_matches_reference():
    checks = _Checks()
    sim = Simulation(seed=7, device="cpu", device_tally=True,
                     tally_check=checks, batch_verifier=HostVerifier(), **ARGS)
    assert not sim._fused_ok
    _same_run(sim.run(), _reference(7), 3)
    assert checks.hits > 0
    assert sim.tally_launches == sim.settle_passes
    assert sim.fused_settles == 0


@pytest.mark.parametrize("threshold", [3, 5])
def test_fused_min_window_routes_and_poisons(threshold):
    # n = 4: vote windows hold 4 messages, propose windows 1. Threshold 3
    # fuses every vote settle and routes the propose settles to the host;
    # threshold 5 routes every settle to the host and poisons the grid.
    kw = dict(n=4, target_height=3, seed=83, sign=True, burst=True)
    checks = _Checks()
    sim = Simulation(**kw, device="cpu", dedup_verify=True, device_tally=True,
                     fused_min_window=threshold, tally_check=checks,
                     batch_verifier=TorchBatchVerifier(device="cpu", buckets=(16, 64)))
    _same_run(sim.run(), RefSimulation(**kw).run(), 3)
    assert sim.host_routed_settles > 0
    if threshold == 3:
        assert sim.fused_settles == sim.vote_settles > 0
        assert sim.host_routed_settles == sim.settle_passes - sim.vote_settles
        assert checks.hits > 0
    else:
        assert sim.host_routed_settles == sim.settle_passes
        assert sim.fused_settles == sim.tally_launches == 0
        assert all(d == sim.vote_grid.all_slots() for d in sim._grid_dirty)
        assert not bool(sim.vote_grid._present.any())


def test_route_hysteresis_disengages_the_grid():
    kw = dict(n=4, target_height=3, seed=83, sign=True, burst=True)
    sim = Simulation(**kw, device="cpu", dedup_verify=True, device_tally=True,
                     fused_min_window=5, route_hysteresis=4,
                     batch_verifier=HostVerifier())
    _same_run(sim.run(), RefSimulation(**kw).run(), 3)
    assert not sim._grid_engaged
    assert sim.host_routed_settles == sim.settle_passes
    sim._reengage_grid()
    assert sim._grid_engaged
    assert all(d == sim.vote_grid.all_slots() for d in sim._grid_dirty)


def test_device_tally_negative_round_vote_is_not_scattered():
    # Vote inserts accept negative rounds; a slot of -1 must not flatten
    # into a neighboring lane's slot R-1 as a phantom vote.
    kw = dict(n=4, target_height=3, seed=111, burst=True, device_tally=True)
    sim = Simulation(**kw, tally_check=CheckedTallyView, device="cpu")
    ref = RefSimulation(**kw, tally_check=RefCheckedTallyView)
    value = b"\x77" * 32
    sim.replicas[1].handle(Prevote(height=1, round=-1, value=value,
                                   sender=sim.signatories[3]))
    ref.replicas[1].handle(RefPrevote(height=1, round=-1, value=value,
                                      sender=ref.signatories[3]))
    sim._settle()
    ref._settle()
    assert -1 in sim.replicas[1].proc.state.prevote_logs
    assert not bool(sim.vote_grid._present.any())
    assert np.array_equal(sim.vote_grid._present.numpy(),
                          np.asarray(ref.vote_grid._present))
    _same_run(sim.run(), ref.run(), 3)
