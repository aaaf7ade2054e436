"""The port's burst-mode delivery against the JAX package's.

Same seed, same arguments, n = 4 and 7: the port's ``Simulation`` must
commit the same chain (``commit_digest``) in the same number of delivery
steps to the same final heights as the JAX ``Simulation``, on every route
of the burst loop: the columnar settle (the default) and the object path,
the shared superstep and the per-delivery one, per-message dispatch
(``batch_ingest=False``), every adversary (``reorder``, ``drop_rate``,
``kill_at_step``, ``offline``, Byzantine proposers and validators,
``delivery_cost``), device tallies checked by ``CheckedTallyView`` under
reorder, and the double-buffered redundant settle (``pipeline_verify``)
on and off. ``AdaptiveVerifier`` is held to ``HostVerifier``'s verdicts.
The tolerance is exact equality: digests, step counts and verdicts.
"""

import numpy as np
import pytest
import torch

from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.messages import Propose as RefPropose
from hyperdrive_tpu.ops.votegrid import CheckedTallyView as RefCheckedTallyView
from hyperdrive_tpu.types import INVALID_ROUND as REF_INVALID_ROUND
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.messages import Propose
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
from hyperdrive_tpu_torch.replica import Replica
from hyperdrive_tpu_torch.types import INVALID_ROUND
from hyperdrive_tpu_torch.verifier import AdaptiveVerifier, HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)


def _same(got, want, height):
    got.assert_safety()
    assert got.completed == want.completed
    assert got.commit_digest(up_to=height) == want.commit_digest(up_to=height)
    assert (got.steps, got.heights) == (want.steps, want.heights)
    assert got.alive == want.alive


def _pair(kw, port_kw=None, ref_kw=None, height=3):
    sim = Simulation(**kw, **(port_kw or {}))
    ref = RefSimulation(**kw, **(ref_kw or {}))
    got, want = sim.run(), ref.run()
    _same(got, want, height)
    assert sim.caught == ref.caught
    return sim, ref, got


class _Count:
    """Counts the calls of one Replica method while it is installed."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        orig = getattr(Replica, name)

        def counted(rep, *args, **kwargs):
            self.calls += 1
            return orig(rep, *args, **kwargs)

        monkeypatch.setattr(Replica, name, counted)


SIGNED = dict(sign=True, burst=True, dedup_verify=True)
HOST = (dict(batch_verifier=HostVerifier()), dict(batch_verifier=RefHostVerifier()))


@pytest.mark.parametrize("n,seed", [(4, 5), (7, 2)])
@pytest.mark.parametrize("knobs", [
    {}, dict(columnar_ingest=False), dict(shared_superstep=False),
    dict(shared_superstep=False, columnar_ingest=False), dict(batch_ingest=False),
], ids=["default", "objects", "per_delivery", "per_delivery_objects", "per_message"])
def test_delivery_routes_match_jax(n, seed, knobs, monkeypatch):
    cols = _Count(monkeypatch, "dispatch_window_cols")
    kw = dict(n=n, target_height=3, seed=seed, **SIGNED, **knobs)
    sim, _, _ = _pair(kw, *HOST)
    # The columnar path is the default and serves the shared lockstep
    # windows; the object path and per-delivery windows never take it.
    assert sim.batch_ingest == knobs.get("batch_ingest", True)
    assert sim._shared_mode == knobs.get("shared_superstep", True)
    assert (cols.calls > 0) == (sim._shared_mode and sim.columnar_ingest)


def _out_of_turn(mod, ring, sigs, invalid_round):
    """A signed round-0 proposal for height 1 from a replica out of turn
    (the scheduled proposer is signatory 1)."""
    return ring[2].sign_message(mod(height=1, round=0, valid_round=invalid_round,
                                    value=b"\x5a" * 32, sender=sigs[2]))


#: Two proposers of junk values (heights 1 and 3, round 0); validators
#: 2, 4 and 5 refuse the first, so height 1 commits in round 1, and
#: height 3 commits the second junk value.
_JUNK = b"\x13" * 32
_BYZ = dict(byzantine_proposer={1: lambda h, r: _JUNK, 3: lambda h, r: b"\x31" * 32},
            byzantine_validator={i: (lambda h, r, v: v != _JUNK) for i in (2, 4, 5)})


@pytest.mark.parametrize("adversary", [
    dict(reorder=True),
    dict(drop_rate=0.1),
    # Both draws interleaved: a shuffle a superstep, then a drop draw a
    # delivery; a draw out of place moves the drops.
    dict(reorder=True, drop_rate=0.05),
    dict(offline={6}, reorder=True, timeout=2.0, delivery_cost=0.001),
    dict(kill_at_step={2: 100, 4: 200}),
    dict(kill_at_step={2: 100, 4: 200}, shared_superstep=False),
    dict(offline={5, 6}, delivery_cost=0.001),
    dict(offline={5, 6}, delivery_cost=0.001, shared_superstep=False),
    _BYZ,
    dict(_BYZ, shared_superstep=False),
], ids=["reorder", "drop", "reorder_drop", "offline_reorder", "kill", "kill_per_delivery", "offline",
        "offline_per_delivery", "byzantine", "byzantine_per_delivery"])
def test_adversaries_match_jax(adversary):
    kw = dict(n=7, target_height=3, seed=9, **SIGNED, **adversary)
    sim = Simulation(**kw, batch_verifier=HostVerifier())
    ref = RefSimulation(**kw, batch_verifier=RefHostVerifier())
    if "byzantine_proposer" in adversary:
        # An out-of-turn proposal enters the network beside the Byzantine
        # proposers' junk values; every live replica catches it, as in JAX.
        for s, mod, inv in ((sim, Propose, INVALID_ROUND),
                            (ref, RefPropose, REF_INVALID_ROUND)):
            msg = _out_of_turn(mod, s.ring, s.signatories, inv)
            if s._shared_mode:
                s.queue.append((-1, msg))
            else:
                s.queue.extend((i, msg) for i in range(7))
    got, want = sim.run(max_steps=200_000), ref.run(max_steps=200_000)
    _same(got, want, 3)
    assert sim.caught == ref.caught
    if "byzantine_proposer" in adversary:
        assert ("out_of_turn", 0) in sim.caught
        assert got.commits[0][3] == b"\x31" * 32 and got.commits[0][1] != _JUNK
    if "kill_at_step" in adversary:
        assert got.alive == [True, True, False, True, False, True, True]
    if "offline" in adversary:
        assert not any(got.commits[i] for i in adversary["offline"])
    if adversary.get("delivery_cost"):
        assert got.virtual_time == want.virtual_time > 0


class _Checks:
    """A ``tally_check`` that keeps every CheckedTallyView it makes."""

    def __init__(self, cls):
        self.cls = cls
        self.views = []

    def __call__(self, view, proc):
        self.views.append(self.cls(view, proc))
        return self.views[-1]

    @property
    def hits(self) -> int:
        return sum(v.hits for v in self.views)


@pytest.mark.parametrize("fused_min_window", [0, 3])
def test_device_tally_under_reorder_matches_jax(fused_min_window):
    kw = dict(n=7, target_height=3, seed=4, reorder=True, device_tally=True,
              fused_min_window=fused_min_window, **SIGNED)
    checks, ref_checks = _Checks(CheckedTallyView), _Checks(RefCheckedTallyView)
    sim, _, _ = _pair(kw, dict(batch_verifier=HostVerifier(), tally_check=checks,
                               device="cpu"),
                      dict(batch_verifier=RefHostVerifier(), tally_check=ref_checks))
    assert checks.hits > 0 and checks.hits == ref_checks.hits
    assert not sim._fused_ok and sim.fused_settles == 0
    # Per-delivery windows: every settle the router did not keep on the
    # host inserted, then tallied in its own launch.
    assert sim.tally_launches + sim.host_routed_settles == sim.settle_passes
    assert (sim.host_routed_settles > 0) == (fused_min_window > 0)


class _Pending:
    def __init__(self, mask):
        self._mask = mask

    def mask(self):
        return np.asarray(self._mask, dtype=bool)


class _Ladder:
    def __init__(self, buckets):
        self.buckets = buckets


class _Grouped:
    """A host verifier with a bucket ladder (so the pipelined settle sizes
    its replica groups) and, with ``begin``, the async entry point; logs
    (items, repeats) for every call."""

    def __init__(self, inner, buckets, begin):
        self.inner = inner
        self.host = _Ladder(buckets)
        self.calls = []
        if begin:
            self.verify_signatures_begin = self._begin

    def verify_signatures(self, items):
        self.calls.append((len(items), 1))
        return self.inner.verify_signatures(items)

    def _begin(self, items, repeats=1):
        self.calls.append((len(items), repeats))
        return _Pending(list(self.inner.verify_signatures(items)) * repeats)


@pytest.mark.parametrize("begin", [True, False], ids=["begin", "group_by_group"])
@pytest.mark.parametrize("pipeline_verify", [None, False])
@pytest.mark.parametrize("reorder", [False, True])
def test_redundant_pipeline_verify_matches_jax(begin, pipeline_verify, reorder):
    # n = 7 and a 16-lane ladder: a 7-message vote window makes groups of
    # two replicas, 2 + 2 + 2 + 1: the group size does not divide n.
    kw = dict(n=7, target_height=3, seed=6, sign=True, burst=True, reorder=reorder,
              pipeline_verify=pipeline_verify)
    port_v = _Grouped(HostVerifier(), (16,), begin)
    ref_v = _Grouped(RefHostVerifier(), (16,), begin)
    sim, _, _ = _pair(kw, dict(batch_verifier=port_v), dict(batch_verifier=ref_v))
    assert port_v.calls == ref_v.calls
    assert sim.verified_sigs == sum(n * r for n, r in port_v.calls)
    repeats = {r for _, r in port_v.calls}
    if pipeline_verify is None and begin and not reorder:
        assert {1, 2} <= repeats and (7, 2) in port_v.calls and (7, 1) in port_v.calls
    else:
        assert repeats == {1}
    if pipeline_verify is False:
        # One call a settle pass.
        assert len(port_v.calls) == sim.settle_passes


def test_knobs_take_the_reference_defaults_and_errors():
    sim = Simulation(n=4, target_height=1, burst=True)
    assert (sim.batch_ingest, sim.columnar_ingest, sim._shared_mode,
            sim._pipeline_verify) == (True, True, True, True)
    assert not Simulation(n=4, target_height=1, burst=True, reorder=True)._shared_mode
    for kw in (dict(burst=True, reorder=True, shared_superstep=True),
               dict(burst=True, drop_rate=0.1, shared_superstep=True),
               dict(burst=False, batch_ingest=True),
               dict(burst=True, batch_ingest=False, columnar_ingest=True),
               dict(burst=True, batch_ingest=False, device_tally=True)):
        with pytest.raises(ValueError):
            Simulation(n=4, target_height=1, **kw)
        with pytest.raises(ValueError):
            RefSimulation(n=4, target_height=1, **kw)
    # Lock-step delivery and its knobs are ported (the lock-step tests
    # hold them to the JAX runs); in burst mode the per-replica seams,
    # epochs, the overlay, chaos and load raise the reference's ValueError; the laggard
    # sweep's knobs are accepted, as in the reference.
    for kw in (dict(verifier_for=lambda i: None), dict(flusher_for=lambda i, s: None),
               dict(epochs=object()), dict(overlay=object()), dict(chaos=object()),
               dict(load=object())):
        with pytest.raises(ValueError):
            Simulation(n=4, target_height=1, burst=True, **kw)
        with pytest.raises(ValueError):
            RefSimulation(n=4, target_height=1, burst=True, **kw)
    for kw in (dict(burst=False), dict(signatories=[b"\x01" * 32] * 4),
               dict(record=False), dict(catchup_every=4), dict(catchup_lag=2)):
        kw.setdefault("burst", True)
        Simulation(n=4, target_height=1, **kw)
    # The sharded grid is ported: a validator count that does not divide
    # over the mesh's 'val' axis raises the reference's ValueError in both
    # packages (a 1 x 2 mesh: the check comes before any collective).
    import types

    from hyperdrive_tpu.parallel import make_mesh as ref_make_mesh

    two = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("hr", "val"))
    with pytest.raises(ValueError, match="divide evenly"):
        Simulation(n=5, target_height=1, burst=True, device_tally=True, tally_mesh=two,
                   device="cpu")
    import jax

    with pytest.raises(ValueError, match="divide evenly"):
        RefSimulation(n=5, target_height=1, burst=True, device_tally=True,
                      tally_mesh=ref_make_mesh(devices=jax.devices()[:2], hr=1))
    # The recorder's options are ported: observe keeps a ring of the
    # default size, obs_capacity alone keeps recording off.
    sim = Simulation(n=4, target_height=1, burst=True, observe=True)
    assert sim.obs.capacity == 65536 and sim.run().completed and sim.obs.total
    sim = Simulation(n=4, target_height=1, burst=True, obs_capacity=16)
    assert sim.run().completed and len(sim.obs) == 0


def _items(n_items):
    from hyperdrive_tpu_torch.crypto.keys import KeyRing

    ring = KeyRing.deterministic(4, namespace=b"adaptive")
    items = []
    for j in range(n_items):
        d = bytes([j]) * 32
        items.append((ring.signatories[j % 4], d, ring[j % 4].sign_digest(d)))
    items[3] = (items[3][0], items[3][1], bytes(64))  # forged
    items[5] = (items[5][0], items[5][1], items[5][2][:10])  # wrong length
    return items


class _Counting:
    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def verify_signatures(self, items):
        self.calls += 1
        return self.inner.verify_signatures(items)


def test_adaptive_verifier_on_cpu_legs(monkeypatch):
    # One call times every leg once (the plain ladder costs ~0.7 s a call
    # on the CPU): the routing contract, not the rates, is under test.
    orig = AdaptiveVerifier._median_time
    monkeypatch.setattr(AdaptiveVerifier, "_median_time",
                        staticmethod(lambda fn, reps=3: orig(fn, 1)))
    items = _items(8)
    want = [bool(b) for b in HostVerifier().verify_signatures(items)]
    assert want == [bool(b) for b in RefHostVerifier().verify_signatures(items)]
    assert want.count(False) == 2
    host = _Counting(HostVerifier())
    av = AdaptiveVerifier(device=TorchBatchVerifier(device="cpu", buckets=(16,)),
                          host=host, calibrate_at=8)
    assert [bool(b) for b in av.verify_signatures(items)] == want
    assert av.calibrated and set(av.rates) == {
        "host_sigs_per_s", "device_sigs_per_s", "device_overhead_s"}
    assert all(v > 0 for v in av.rates.values())
    # Below the measured crossover a window stays on the host leg.
    av.crossover = 4
    calls = host.calls
    assert [bool(b) for b in av.verify_signatures(items[:3])] == want[:3]
    assert host.calls == calls + 1
    assert av.verify_batch([]) == []


def test_adaptive_verifier_refuses_disagreeing_legs_and_needs_the_card():
    class Liar:
        def verify_signatures(self, items):
            return [True] * len(items)

    av = AdaptiveVerifier(device=Liar(), host=HostVerifier(), calibrate_at=4)
    with pytest.raises(RuntimeError, match="disagree"):
        av.verify_signatures(_items(6))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            AdaptiveVerifier()
