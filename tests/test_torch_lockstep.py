"""The port's lock-step delivery against the JAX package's.

Same seed, same arguments: the port's ``Simulation(burst=False)`` (the
default) must commit the same chain (``commit_digest``) in the same
number of delivery steps, at the same virtual time, to the same final
heights, catching the same misbehaviour, as the JAX ``Simulation``: with
reorder, drops and kills in one run (the reorder swap and the drop draw
share one random stream, so a draw out of place moves everything),
offline replicas, a Byzantine proposer, signed votes verified by every
replica's own ``HostVerifier`` (the default with ``device="cpu"``; on the
card the default is a ``TorchBatchVerifier`` a replica), a card verifier
per replica
(``verifier_for``, here ``TorchBatchVerifier(device="cpu")``: its kernel's
plain version), and replicas flushing through one shared
``DeviceWorkQueue`` (``devsched=``, ``flusher_for=``), where the queue's
submitted / launches / coalesced counts must equal the JAX run's too.
Execution runs under lock-step delivery, with and without speculation on
the injected queue. The tolerance is exact equality throughout.
"""

import pytest
import torch

from hyperdrive_tpu.chaos import FaultPlan as RefFaultPlan
from hyperdrive_tpu.devsched import DeviceWorkQueue as RefQueue
from hyperdrive_tpu.devsched import QueueFlusher as RefQueueFlusher
from hyperdrive_tpu.exec import ExecutionConfig as RefExecutionConfig
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.load import LoadProfile as RefLoadProfile
from hyperdrive_tpu.overlay import OverlayConfig as RefOverlayConfig
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu.verifier import NullVerifier as RefNullVerifier
from hyperdrive_tpu_torch.chaos import FaultPlan
from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
from hyperdrive_tpu_torch.devsched.__main__ import main as devsched_main
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.load import LoadProfile
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.overlay import OverlayConfig
from hyperdrive_tpu_torch.verifier import HostVerifier, NullVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

#: BASELINE config 2's network (``benches/run_all.py``): 16 replicas,
#: seed 1002, 20 s timeouts, 1 ms a delivery; cut to 20 heights.
CONFIG2 = dict(n=16, target_height=20, seed=1002, timeout=20.0, delivery_cost=0.001)


def _same(got, want, sim, ref):
    got.assert_safety()
    assert got.completed == want.completed
    assert got.commit_digest() == want.commit_digest()
    assert (got.steps, got.heights, got.alive) == (want.steps, want.heights, want.alive)
    assert got.virtual_time == want.virtual_time
    assert sim.caught == ref.caught


def _pair(kw, port_kw=None, ref_kw=None):
    sim = Simulation(**kw, **(port_kw or {}))
    ref = RefSimulation(**kw, **(ref_kw or {}))
    got, want = sim.run(), ref.run()
    _same(got, want, sim, ref)
    return sim, ref, got


@pytest.mark.parametrize("kw", [
    dict(n=7, target_height=3, seed=5),
    # The three adversaries together: the reorder swap (one randrange a
    # delivery) before the drop draw, then the kill.
    dict(n=7, target_height=3, seed=2, reorder=True, drop_rate=0.05,
         kill_at_step={2: 100}),
    # n = 4 loses its slack with the kill: the drops then stall it, at
    # the same step and virtual time as the reference.
    dict(n=4, target_height=3, seed=8, reorder=True, drop_rate=0.1,
         kill_at_step={3: 40}, timeout=2.0),
    dict(n=7, target_height=3, seed=4, offline={5, 6}, timeout=2.0, delivery_cost=0.001),
    # Three validators refuse the junk value, so it never gathers 2f+1
    # prevotes and its rounds time out.
    dict(n=7, target_height=3, seed=4, byzantine_proposer={1: lambda h, r: b"\x13" * 32},
         byzantine_validator={i: (lambda h, r, v: v != b"\x13" * 32) for i in (2, 4, 5)}),
], ids=["plain", "reorder_drop_kill", "reorder_drop_kill_n4", "offline", "byzantine"])
def test_lockstep_matches_jax(kw):
    sim, _, got = _pair(kw)
    assert not sim.burst and got.completed == (kw["n"] == 7)
    dead = [i for i, a in enumerate(got.alive) if not a]
    assert dead == sorted(set(kw.get("kill_at_step", {})) | kw.get("offline", set()))
    assert len(got.record.messages) <= got.steps


def test_signed_lockstep_per_replica_host_verifiers():
    sim, _, got = _pair(dict(n=4, target_height=3, seed=5, sign=True), dict(device="cpu"))
    verifiers = [r.verifier for r in sim.replicas]
    assert all(type(v) is HostVerifier for v in verifiers)
    assert len({id(v) for v in verifiers}) == 4
    assert got.completed


def test_signed_lockstep_default_verifiers_are_on_the_card(monkeypatch):
    # The default device is the card: a TorchBatchVerifier a replica,
    # which raises where there is no CUDA. A flusher owns the flush, so
    # with flusher_for no default verifier is built at all.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(n=4, target_height=1, seed=5, sign=True)
    q = DeviceWorkQueue(max_depth=8)
    sim = Simulation(n=4, target_height=1, seed=5, sign=True, devsched=q,
                     flusher_for=lambda i, v: QueueFlusher(HostVerifier(), q))
    assert all(r.verifier is None and r.flusher is not None for r in sim.replicas)


def test_verifier_for_card_verifier_matches_jax():
    # Replica 0 verifies every window it flushes through the packed
    # verifier (the plain ladder here: about 1 s a call on one core, so
    # one replica and one height); the others through host verifiers.
    calls = []

    class Counted(TorchBatchVerifier):
        def verify_signatures(self, items):
            calls.append(len(items))
            return super().verify_signatures(items)

    card = Counted(buckets=(1,), device="cpu")
    kw = dict(n=4, target_height=1, seed=5, sign=True)
    sim, _, got = _pair(
        kw,
        dict(verifier_for=lambda i: card if i == 0 else HostVerifier()),
        dict(verifier_for=lambda i: RefHostVerifier()),
    )
    assert sim.replicas[0].verifier is card and got.completed
    assert calls and all(n == 1 for n in calls)


def test_lockstep_queue_flusher_digest_parity():
    # JAX tests/test_devsched.py's lock-step leg: unsigned replicas
    # flushing through one shared queue commit the blocking run's chain,
    # with coalescing, and the counts equal the JAX run's.
    kw = dict(n=4, target_height=8, seed=31, timeout=1.0, delivery_cost=1e-3)
    seq = Simulation(**kw).run()
    q, rq = DeviceWorkQueue(max_depth=8), RefQueue(max_depth=8)
    pipe, ref, got = _pair(
        kw,
        dict(devsched=q, flusher_for=lambda i, v: QueueFlusher(NullVerifier(), q)),
        dict(devsched=rq, flusher_for=lambda i, v: RefQueueFlusher(RefNullVerifier(), rq)),
    )
    assert seq.commit_digest() == got.commit_digest()
    assert q.coalesced > 0 and q.depth == 0
    flushers = [r.flusher for r in pipe.replicas]
    assert sum(f.dispatched for f in flushers) == sum(f.submitted for f in flushers)
    assert (q.submitted, q.launches, q.coalesced) == (rq.submitted, rq.launches, rq.coalesced)


def test_config2_queue_flushers_coalesce_like_jax():
    # One verifier object shared by every flusher: the queue merges their
    # commands into one launch a drain (8,960 submitted, 1,120 launches at
    # depth 8 on the reference).
    q, rq = DeviceWorkQueue(max_depth=8), RefQueue(max_depth=8)
    nv, rnv = NullVerifier(), RefNullVerifier()
    _, _, got = _pair(
        CONFIG2,
        dict(devsched=q, flusher_for=lambda i, v: QueueFlusher(nv, q)),
        dict(devsched=rq, flusher_for=lambda i, v: RefQueueFlusher(rnv, rq)),
    )
    assert (got.steps, got.commit_digest()[:16]) == (10480, "43d6ecfa0a44321d")
    assert (q.submitted, q.launches, q.coalesced) == (rq.submitted, rq.launches, rq.coalesced)
    assert (q.submitted, q.launches, q.coalesced) == (8960, 1120, 7840)


@pytest.mark.parametrize("speculate", [False, True], ids=["plain", "speculate"])
def test_execution_under_lockstep_matches_jax(speculate):
    cfg = dict(accounts=16, txs_per_block=12, seed=3, sign_txs=speculate,
               bad_sig_every=5 if speculate else 0)
    kw = dict(n=4, target_height=4, seed=7)
    port_kw = dict(execution=ExecutionConfig(**cfg), device="cpu")
    ref_kw = dict(execution=RefExecutionConfig(**cfg))
    if speculate:
        q, rq = DeviceWorkQueue(max_depth=8), RefQueue(max_depth=8)
        port_kw.update(devsched=q, exec_speculate=True,
                       flusher_for=lambda i, v: QueueFlusher(NullVerifier(), q))
        ref_kw.update(devsched=rq, exec_speculate=True,
                      flusher_for=lambda i, v: RefQueueFlusher(RefNullVerifier(), rq))
    sim = Simulation(**kw, **port_kw)
    if speculate:
        # The blocks' signatures ride the queue's exec.apply launcher, on
        # ``device``: the host verifier on the CPU, as the reference's.
        assert type(sim._exec_launcher.verifier) is HostVerifier
    ref = RefSimulation(**kw, **ref_kw)
    got, want = sim.run(), ref.run()
    _same(got, want, sim, ref)
    assert all(len(v) == 64 for c in got.commits for v in c.values())
    assert got.record.execution == want.record.execution
    if speculate:
        assert (q.submitted, q.launches) == (rq.submitted, rq.launches)
        assert sim._exec_unique[0].spec_rolled_back == ref._exec_unique[0].spec_rolled_back


@pytest.mark.parametrize("kw,match", [
    (dict(batch_verifier=HostVerifier()), "batch_verifier requires burst"),
    (dict(burst=True, verifier_for=lambda i: HostVerifier()), "verifier_for"),
    (dict(burst=True, flusher_for=lambda i, v: None), "lock-step"),
    (dict(pipeline_heights=True, sign=True), "burst mode"),
    (dict(sign=True, signatories=[bytes(32)] * 4), "keyring"),
    (dict(exec_speculate=True), "execution="),
], ids=["batch_verifier", "verifier_for", "flusher_for", "pipeline", "signatories",
        "exec_speculate"])
def test_lockstep_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        Simulation(n=4, target_height=2, **kw)


@pytest.mark.parametrize("opt", ["tally_mesh", "observe", "obs_capacity", "chaos", "load",
                                 "overlay", "catchup_every", "catchup_lag"])
def test_unported_subsystems_refused_with_reason(opt):
    # The recorder's options, chaos, load, the overlay, the laggard sweep
    # and the sharded grid are ported: the recorder's and the mesh's cases
    # run both packages; every case checks the reference's ValueErrors
    # (chaos or an overlay in burst mode, load without delivery pacing, a
    # sweep every 0 steps, a negative lag, device tallies in lock-step),
    # raised by both packages.
    lifted = {
        "chaos": (dict(chaos=FaultPlan(), burst=True), dict(chaos=RefFaultPlan(), burst=True),
                  "lock-step"),
        "load": (dict(load=LoadProfile(rate=10.0)), dict(load=RefLoadProfile(rate=10.0)),
                 "delivery_cost"),
        "overlay": (dict(overlay=OverlayConfig(), burst=True, delivery_cost=1e-3),
                    dict(overlay=RefOverlayConfig(), burst=True, delivery_cost=1e-3),
                    "lock-step"),
        "catchup_every": (dict(catchup_every=0), dict(catchup_every=0), ">= 1"),
        "catchup_lag": (dict(catchup_lag=-1), dict(catchup_lag=-1), ">= 0"),
    }
    if opt in ("observe", "obs_capacity"):
        # The flight recorder is ported: observe journals the run as the
        # reference does, obs_capacity alone leaves recording off.
        kw = {opt: True if opt == "observe" else 16}
        got = Simulation(n=4, target_height=1, device="cpu", **kw)
        ref = RefSimulation(n=4, target_height=1, **kw)
        got.run()
        ref.run()
        assert len(got.obs) == len(ref.obs) and (len(got.obs) > 0) == (opt == "observe")
        assert got.obs.digest() == ref.obs.digest()
        return
    if opt == "tally_mesh":
        # The sharded grid is ported. Without device tallies both packages
        # ignore the mesh (the lock-step run equals the JAX run); device
        # tallies in lock-step raise the reference's ValueError in both.
        got = Simulation(n=4, target_height=2, device="cpu", tally_mesh=object()).run()
        ref = RefSimulation(n=4, target_height=2, tally_mesh=object()).run()
        assert (got.commit_digest(up_to=2), got.steps) == (ref.commit_digest(up_to=2),
                                                           ref.steps)
        lifted[opt] = (dict(device_tally=True, tally_mesh=object()),
                       dict(device_tally=True, tally_mesh=object()), "burst=True")
    kw, ref_kw, match = lifted[opt]
    with pytest.raises(ValueError, match=match):
        Simulation(n=4, target_height=2, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        RefSimulation(n=4, target_height=2, **ref_kw)


def test_devsched_parity_cli(capsys):
    assert devsched_main(["parity"]) == 0
    out = capsys.readouterr().out
    assert "ok burst" in out and "ok lockstep" in out and "parity ok: 2 legs" in out
