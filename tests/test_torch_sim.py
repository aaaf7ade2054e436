"""The PyTorch port's burst-mode network against the JAX package's.

Same seed, same arguments: the port's ``Simulation`` verifying every settle
through ``TorchBatchVerifier`` on the CPU (the CUDA kernel's plain version)
must commit the same chain in the same number of delivery steps to the
same final heights as the reference ``Simulation`` with its host verifier.
"""

import pytest

from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.verifier import HostVerifier

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
def test_host_baseline_and_default_routing_match_reference(seed):
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
        Simulation(n=4, target_height=1, burst=True, device_tally=True)
    with pytest.raises(NotImplementedError):
        Simulation(n=4, target_height=1, burst=False)
    with pytest.raises(ValueError):
        Simulation(n=4, target_height=1, burst=True, small_window_host=True)
    # Unsigned burst mode runs with no verifier at all.
    res = Simulation(n=4, target_height=2, seed=3, burst=True).run()
    want = RefSimulation(n=4, target_height=2, seed=3, burst=True).run()
    assert res.commit_digest(up_to=2) == want.commit_digest(up_to=2)
