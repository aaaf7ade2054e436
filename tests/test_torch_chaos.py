"""The port's chaos engine against the JAX package's.

Every case of the JAX package's ``tests/test_chaos.py`` but the two soak
CLI cases (the CLI is not ported yet) runs on the port, held to the JAX
run of the same seeded inputs: the plans of every family field for field,
chaos runs (digest, steps, final heights and ``record.lifecycle``), the
lifecycle trailer's dump byte for byte, replay with crash and restore,
the monitor's violations, the proxy (with the bandwidth throttle of
``tests/test_transport.py``), pipelined chaos on ``QueueFlusher``s, and
certificates through a partition heal; then a signed n = 4 chaos run on
``HostVerifier`` flushers, the overlay chaos cases of
``tests/test_overlay.py`` and the epoch chaos cases of
``tests/test_epochs.py``. The JAX side runs with ``observe=False``
wherever a run is compared (the recorder is not ported). The tolerance
is exact equality throughout.
"""

import dataclasses
import hashlib
import socket
import threading
import time

import pytest
import torch

from hyperdrive_tpu.chaos import CrashRestart as RefCrashRestart
from hyperdrive_tpu.chaos import FaultPlan as RefFaultPlan
from hyperdrive_tpu.chaos import InvariantMonitor as RefInvariantMonitor
from hyperdrive_tpu.chaos import LinkFault as RefLinkFault
from hyperdrive_tpu.chaos import Partition as RefPartition
from hyperdrive_tpu.devsched import DeviceWorkQueue as RefQueue
from hyperdrive_tpu.devsched import QueueFlusher as RefQueueFlusher
from hyperdrive_tpu.epochs import EpochConfig as RefEpochConfig
from hyperdrive_tpu.harness.sim import ScenarioRecord as RefScenarioRecord
from hyperdrive_tpu.harness.sim import Simulation as RefSimulation
from hyperdrive_tpu.overlay import OverlayConfig as RefOverlayConfig
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu.verifier import NullVerifier as RefNullVerifier
from hyperdrive_tpu_torch import chaos
from hyperdrive_tpu_torch.chaos import (
    ChaosProxy,
    CrashRestart,
    FaultPlan,
    InvariantMonitor,
    InvariantViolation,
    LinkFault,
    Partition,
)
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
from hyperdrive_tpu_torch.epochs import EpochConfig
from hyperdrive_tpu_torch.harness.deploy import commits_digest, run_local_replicas
from hyperdrive_tpu_torch.harness.sim import ScenarioRecord, Simulation, _ChaosEnvelope
from hyperdrive_tpu_torch.messages import Prevote, Timeout
from hyperdrive_tpu_torch.overlay import OverlayConfig
from hyperdrive_tpu_torch.transport import TcpNode, encode_frame
from hyperdrive_tpu_torch.types import MessageType
from hyperdrive_tpu_torch.verifier import HostVerifier, NullVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

PORT = dict(FaultPlan=FaultPlan, LinkFault=LinkFault, Partition=Partition,
            CrashRestart=CrashRestart)
REF = dict(FaultPlan=RefFaultPlan, LinkFault=RefLinkFault, Partition=RefPartition,
           CrashRestart=RefCrashRestart)


def _acceptance_plan(m, heal=2.5, links=True):
    """The JAX package's acceptance scenario: replicas 5 and 6 cut off,
    6 crashed at step 420 and restored 300 steps later, one faulty link."""
    return m["FaultPlan"](
        partitions=(m["Partition"](at=0.3, heal=heal, groups=((5, 6),)),),
        crashes=(m["CrashRestart"](replica=6, crash_at_step=420,
                                   restart_after_steps=300),),
        links=(m["LinkFault"](src=0, dst=3, drop=0.05, duplicate=0.05, delay=0.1,
                              delay_min=0.01, delay_max=0.1),) if links else (),
    )


def _pair(plan_fn, n=7, target=10, seed=2024, ref_kw=None, monitor=True, **kw):
    """The same chaos scenario on the port and on the JAX package; both
    monitored. Returns ((sim, result, monitor) for the port, for JAX)."""
    out = []
    for cls, mon_cls, m, extra in ((Simulation, InvariantMonitor, PORT, dict(device="cpu")),
                                   (RefSimulation, RefInvariantMonitor, REF,
                                    dict(observe=False, **(ref_kw or {})))):
        args = dict(timeout=1.0, delivery_cost=1e-3)
        args.update(kw)
        args.update(extra)
        sim = cls(n=n, target_height=target, seed=seed, chaos=plan_fn(m), **args)
        mon = mon_cls(sim) if monitor else None
        res = sim.run(max_steps=500_000)
        out.append((sim, res, mon))
    return out


def _same_run(port, ref):
    (sim, res, _), (rsim, rres, _) = port, ref
    res.assert_safety()
    assert res.completed == rres.completed
    assert res.commit_digest() == rres.commit_digest()
    assert (res.steps, res.heights) == (rres.steps, rres.heights)
    assert res.commits == rres.commits
    assert sim.record.lifecycle == rsim.record.lifecycle


# ----------------------------------------------------------- acceptance


def test_partition_crash_restore_heal_equals_jax(tmp_path):
    port, ref = _pair(_acceptance_plan)
    _same_run(port, ref)
    sim, result, monitor = port
    assert result.completed
    monitor.check_final(result)
    assert [v for v, _ in monitor.crashes] == [6] and monitor.restores and monitor.heals
    assert monitor.restores == ref[2].restores
    assert monitor.commit_rounds_after_heal == ref[2].commit_rounds_after_heal
    assert max(monitor.commit_rounds_after_heal) <= 12
    for i in range(sim.n):
        for h, v in result.commits[i].items():
            assert monitor.chain[h] == v
    # The lifecycle trailer rides the dump, byte for byte the JAX one.
    path, ref_path = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    sim.record.dump(path)
    ref[0].record.dump(ref_path)
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    loaded = ScenarioRecord.load(path)
    kinds = {k for k, _, _, _ in loaded.lifecycle}
    assert {ScenarioRecord.OP_CRASH, ScenarioRecord.OP_RESTORE} <= kinds
    # Replay re-derives the victim's checkpoints: the live run's commits.
    assert Simulation.replay(loaded).commits == result.commits
    assert Simulation.replay(ScenarioRecord.load(ref_path)).commits == result.commits


def test_chaos_lifecycle_reaches_the_monitor():
    def plan(m):
        return m["FaultPlan"](
            partitions=(m["Partition"](at=0.2, heal=1.8, groups=((3,),)),),
            crashes=(m["CrashRestart"](replica=3, crash_at_step=150,
                                       restart_after_steps=200),))

    port, ref = _pair(plan, n=4, target=6, seed=11)
    _same_run(port, ref)
    mon = port[2]
    assert port[1].completed and mon.crashes and mon.restores and mon.heals
    assert (mon.crashes, mon.restores, mon.heals) == (ref[2].crashes, ref[2].restores,
                                                      ref[2].heals)


def test_same_plan_same_seed_is_bit_deterministic():
    def plan(m):
        return m["FaultPlan"](
            links=(m["LinkFault"](src=0, dst=2, drop=0.1, duplicate=0.1),
                   m["LinkFault"](src=3, dst=1, delay=0.2, delay_min=0.01,
                                  delay_max=0.05)),
            partitions=(m["Partition"](at=0.4, heal=1.6, groups=((2,),)),))

    runs = [_pair(plan, n=4, target=6, seed=99, monitor=False) for _ in range(2)]
    _same_run(*runs[0])
    assert runs[0][0][1].commits == runs[1][0][1].commits
    assert runs[0][0][1].steps == runs[1][0][1].steps


def test_crash_before_any_checkpoint_restarts_from_genesis():
    def plan(m):
        return m["FaultPlan"](crashes=(m["CrashRestart"](replica=2, crash_at_step=1,
                                                         restart_after_steps=120),))

    port, ref = _pair(plan, n=4, target=5, seed=5)
    _same_run(port, ref)
    assert port[1].completed and port[2].restores
    port[2].check_final(port[1])


def test_delayed_copy_survives_clock_pruning():
    # A delayed delivery rides the virtual clock as a _ChaosEnvelope; the
    # pruner drops only timeouts of heights every live replica has left.
    sim = Simulation(n=4, target_height=2, seed=1, chaos=FaultPlan(), device="cpu")
    for r in sim.replicas:
        r.proc.state.current_height = 5
    stale = Timeout(message_type=MessageType.PREVOTE, height=1, round=0)
    env = _ChaosEnvelope(Prevote(height=1, round=0, value=b"\x07" * 32,
                                 sender=sim.signatories[0]))
    sim.clock.schedule(0.5, stale, 0)
    sim.clock.schedule(0.1, env, 1)
    sim._prune_clock()
    assert sim.clock.pending() == 1 and sim.clock.fire_next() == (env, 1)


# ------------------------------------------------------------ plan DSL


def _fields(x):
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def test_plan_families_equal_jax():
    for seed in range(40):
        for n in (4, 7, 16):
            a = FaultPlan.seeded(seed, n)
            assert a == FaultPlan.seeded(seed, n)
            assert _fields(a) == _fields(RefFaultPlan.seeded(seed, n))
            assert _fields(FaultPlan.churn(seed, n)) == _fields(RefFaultPlan.churn(seed, n))
    for seed, n in ((77, 4), (1002, 16)):
        p, prof = FaultPlan.overload(seed, n)
        rp, rprof = RefFaultPlan.overload(seed, n)
        assert _fields(p) == _fields(rp) and _fields(prof) == _fields(rprof)
    for seed, n in ((9, 16), (19951, 8), (3, 32)):
        p, faults = FaultPlan.overlay(seed, n)
        rp, rfaults = RefFaultPlan.overlay(seed, n)
        assert _fields(p) == _fields(rp) and _fields(faults) == _fields(rfaults)
    assert chaos.__all__ == ["LinkFault", "Partition", "CrashRestart", "FaultPlan",
                             "InvariantMonitor", "InvariantViolation", "ChaosProxy"]


BAD_PLANS = [
    lambda m: m["FaultPlan"](links=(m["LinkFault"](src=0, dst=9),)),
    lambda m: m["FaultPlan"](links=(m["LinkFault"](src=0, dst=1, drop=1.5),)),
    lambda m: m["FaultPlan"](links=(m["LinkFault"](src=0, dst=1, delay_min=0.5,
                                                   delay_max=0.1),)),
    lambda m: m["FaultPlan"](partitions=(m["Partition"](at=2.0, heal=1.0, groups=()),)),
    lambda m: m["FaultPlan"](partitions=(m["Partition"](at=0.0, heal=1.0,
                                                        groups=((9,),)),)),
    lambda m: m["FaultPlan"](partitions=(m["Partition"](at=0.0, heal=1.0,
                                                        groups=((1,), (1, 2))),)),
    lambda m: m["FaultPlan"](crashes=(m["CrashRestart"](replica=0, crash_at_step=5),
                                      m["CrashRestart"](replica=0, crash_at_step=9))),
    lambda m: m["FaultPlan"](crashes=(m["CrashRestart"](replica=1, crash_at_step=0),)),
    lambda m: m["FaultPlan"](crashes=(m["CrashRestart"](replica=1, crash_at_step=5,
                                                        restart_after_steps=0),)),
]


@pytest.mark.parametrize("idx", range(len(BAD_PLANS)))
def test_faultplan_validate_rejects(idx):
    for m in (PORT, REF):
        with pytest.raises(ValueError):
            BAD_PLANS[idx](m).validate(4)


def test_chaos_refusals():
    part = (Partition(at=0.1, heal=1.0, groups=((0,),)),)
    ref_part = (RefPartition(at=0.1, heal=1.0, groups=((0,),)),)
    with pytest.raises(ValueError, match="lock-step"):
        Simulation(n=4, target_height=3, seed=1, burst=True, chaos=FaultPlan())
    with pytest.raises(ValueError, match="lock-step"):
        RefSimulation(n=4, target_height=3, seed=1, burst=True, chaos=RefFaultPlan())
    with pytest.raises(ValueError, match="delivery_cost"):
        Simulation(n=4, target_height=3, seed=1, chaos=FaultPlan(partitions=part))
    with pytest.raises(ValueError, match="delivery_cost"):
        RefSimulation(n=4, target_height=3, seed=1, chaos=RefFaultPlan(partitions=ref_part))


# ------------------------------------------------------------- monitor


def test_monitor_raises_on_fork_and_round_bound():
    sim = Simulation(n=4, target_height=3, seed=1, chaos=FaultPlan(), device="cpu")
    monitor = InvariantMonitor(sim)
    monitor._commit(0, 1, b"\xaa" * 32)
    with pytest.raises(InvariantViolation, match="fork") as ei:
        monitor._commit(1, 1, b"\xbb" * 32)
    assert ei.value.kind == "fork" and isinstance(ei.value, AssertionError)
    monitor._commit(2, 1, b"\xaa" * 32)  # agreement is never a fork
    sim = Simulation(n=4, target_height=3, seed=1, chaos=FaultPlan(), device="cpu")
    monitor = InvariantMonitor(sim, max_rounds_after_heal=0)
    monitor.note_heal(0.5)
    assert monitor._await_heal_commit == {0, 1, 2, 3}
    with pytest.raises(InvariantViolation, match="liveness"):
        monitor._commit(0, 1, b"\xcc" * 32)


def test_monitor_flags_stalled_run():
    results = []
    for cls, plan, kw in ((Simulation, FaultPlan(), dict(device="cpu")),
                          (RefSimulation, RefFaultPlan(), dict(observe=False))):
        sim = cls(n=4, target_height=3, seed=3, offline={2, 3}, chaos=plan, **kw)
        monitor = (InvariantMonitor if cls is Simulation else RefInvariantMonitor)(sim)
        res = sim.run(max_steps=20_000)
        assert not res.completed
        with pytest.raises(AssertionError, match="liveness"):
            monitor.check_final(res)
        results.append((res.steps, res.heights))
    assert results[0] == results[1]


def test_static_campaign_checks():
    class Policy:
        starve_after, max_deferrals = 4, 5

    for mon in (InvariantMonitor, RefInvariantMonitor):
        with pytest.raises(AssertionError, match="tenant-fairness"):
            mon.check_tenant_fairness(Policy())
        row = dict(committee=10, adv_stake=1, total_stake=4, seats=3)
        mon.check_campaign_proportionality([row] * 4, grind_width=8)
        with pytest.raises(AssertionError, match="proportionality"):
            mon.check_campaign_proportionality([dict(row, seats=10)] * 4)
        storm = dict(gate=dict(shed={"duplicate": 3, "reputation": 2},
                               verify_failed={7: 2}, demoted=[7], demotions=1),
                     honest=[0, 1], attackers=[7], reputation=True, honest_rows=4,
                     waves=[dict(attacker_rows_verified=0, admitted=5)])
        mon.check_storm_hygiene(storm)
        with pytest.raises(AssertionError, match="storm-attribution"):
            mon.check_storm_hygiene(dict(storm, gate=dict(storm["gate"],
                                                          verify_failed={0: 1})))
        mon.check_campaign_economy(dict(overlay=[dict(epoch=1, windows_exhausted=2,
                                                      fallback_engaged=1)]))
        with pytest.raises(AssertionError, match="campaign-demotion"):
            mon.check_campaign_economy(dict(honest_demoted_final=[3]))


def test_lifecycle_trailer_dump_equals_jax(tmp_path):
    dumps = []
    for cls in (ScenarioRecord, RefScenarioRecord):
        rec = cls(seed=7, n=4, f=1, target_height=5)
        rec.signatories = [bytes([i]) * 32 for i in range(4)]
        rec.lifecycle = [(cls.OP_CRASH, 10, 2, 0), (cls.OP_RESTORE, 40, 2, 3),
                         (cls.OP_RESYNC, 55, 1, 4)]
        path = str(tmp_path / f"{cls.__module__}.bin")
        rec.dump(path)
        assert ScenarioRecord.load(path).lifecycle == rec.lifecycle
        with open(path, "rb") as fh:
            dumps.append(fh.read())
    assert dumps[0] == dumps[1]


# -------------------------------------------------------- chaos proxy


def _signed_prevote():
    ring = KeyRing.deterministic(1, namespace=b"chaosprox")
    return ring[0].sign_message(Prevote(height=1, round=0, value=b"\x07" * 32,
                                        sender=ring[0].public))


class _Sink:
    def __init__(self):
        self.got = []

    def propose(self, m, stop=None):
        self.got.append(m)

    prevote = precommit = propose


def _sink_node():
    node = TcpNode()
    sink = _Sink()
    node.add_replica(sink)
    node.start()
    return node, sink.got


def _await(predicate, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def test_proxy_forwards_then_blackholes_then_heals():
    node, received = _sink_node()
    proxy = ChaosProxy("127.0.0.1", node.port).start()
    try:
        frame = encode_frame(_signed_prevote())
        with socket.create_connection(("127.0.0.1", proxy.port)) as s:
            s.sendall(frame)
            assert _await(lambda: len(received) == 1)
            proxy.partition()
            assert proxy.partitioned
            s.sendall(frame)
            assert _await(lambda: proxy.dropped == 1)
            assert len(received) == 1  # black-holed, connection alive
            proxy.heal()
            s.sendall(frame)
            assert _await(lambda: len(received) == 2)
        # The proxy counts a frame only after upstream.sendall returns,
        # so the sink can hold it before the count moves.
        assert _await(lambda: proxy.forwarded == 2)
    finally:
        proxy.stop()
        node.stop()


@pytest.mark.parametrize("fault", ["drop", "duplicate"])
def test_proxy_drop_and_duplicate(fault):
    node, received = _sink_node()
    proxy = ChaosProxy("127.0.0.1", node.port, seed=4, **{fault: 1.0}).start()
    try:
        frame = encode_frame(_signed_prevote())
        with socket.create_connection(("127.0.0.1", proxy.port)) as s:
            if fault == "drop":
                for _ in range(5):
                    s.sendall(frame)
                assert _await(lambda: proxy.dropped == 5)
                assert proxy.forwarded == 0 and received == []
            else:
                s.sendall(frame)
                assert _await(lambda: len(received) == 2)
                assert _await(lambda: proxy.forwarded == 2)
    finally:
        proxy.stop()
        node.stop()


def test_proxy_fuzz_mutates_on_cadence_and_keeps_framing():
    node, received = _sink_node()
    proxy = ChaosProxy("127.0.0.1", node.port, seed=7, fuzz_every=3).start()
    try:
        frame = encode_frame(_signed_prevote())
        with socket.create_connection(("127.0.0.1", proxy.port)) as s:
            for _ in range(12):
                s.sendall(frame)
            assert _await(lambda: proxy.forwarded == 12)
            assert proxy.fuzzed == 4
            assert _await(lambda: len(received) >= 8)
            assert len(received) <= 12
            before = len(received)
            s.sendall(frame)
            assert _await(lambda: len(received) > before)
        assert node.oversize_frames == 0
        assert node.malformed_frames <= proxy.fuzzed
    finally:
        proxy.stop()
        node.stop()
    for bad in (dict(fuzz_every=-1), dict(bandwidth_bps=-1.0)):
        with pytest.raises(ValueError):
            ChaosProxy("127.0.0.1", 1, **bad)


def test_chaos_proxy_bandwidth_throttle_pays_serialization_delay():
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    frame = encode_frame(Prevote(height=1, round=0, value=b"\x05" * 32,
                                 sender=b"\x01" * 32))
    received, done = [], threading.Event()

    def read_side():
        conn, _ = srv.accept()
        with conn:
            got = b""
            while len(got) < 3 * len(frame):
                chunk = conn.recv(4096)
                if not chunk:
                    break
                got += chunk
            received.append(got)
            done.set()

    threading.Thread(target=read_side, daemon=True).start()
    bps = len(frame) * 8.0 * 20  # ~50 ms a frame
    try:
        with ChaosProxy("127.0.0.1", srv.getsockname()[1], bandwidth_bps=bps) as proxy:
            t0 = time.monotonic()
            with socket.create_connection(("127.0.0.1", proxy.port)) as s:
                for _ in range(3):
                    s.sendall(frame)
                assert done.wait(10.0)
            elapsed = time.monotonic() - t0
            # The proxy counts a frame only after upstream.sendall
            # returns: the reader can hold every byte before the count.
            assert _await(lambda: proxy.forwarded == 3)
            assert received[0] == frame * 3
            expected = 3 * len(frame) * 8.0 / bps
            assert abs(proxy.throttled_s - expected) < 1e-9
            assert elapsed >= expected * 0.9
    finally:
        srv.close()


def test_transparent_proxy_consensus_smoke():
    # Four single-replica nodes over loopback sockets, every inbound frame
    # to node 3 through a faultless proxy: all four commit one chain.
    ring = KeyRing.deterministic(4, namespace=b"tcp-demo")
    nodes = [TcpNode() for _ in range(4)]
    proxy = ChaosProxy("127.0.0.1", nodes[3].port).start()
    ports = [n.port for n in nodes[:3]] + [proxy.port]
    try:
        for a in range(4):
            for b in range(4):
                if a != b:
                    nodes[a].add_peer("127.0.0.1", ports[b])
        results, errors = [None] * 4, []

        def drive(i):
            try:
                results[i] = run_local_replicas(nodes[i], ring, (i,), 3, deadline_s=60.0)
            except Exception as e:  # pragma: no cover - failure report
                errors.append((i, e))

        drivers = [threading.Thread(target=drive, args=(i,), daemon=True) for i in range(4)]
        for t in drivers:
            t.start()
        for t in drivers:
            t.join(timeout=90.0)
        assert not errors, errors
        assert len({commits_digest(r, up_to=3) for r in results}) == 1
        assert proxy.forwarded > 0
    finally:
        proxy.stop()
        for n in nodes:
            n.stop()


# ------------------------------------------- pipelined settle under chaos


def _queued(verifier_cls, ref):
    """``flusher_for`` kwargs: every replica a QueueFlusher on one verifier
    behind one queue of depth 8."""
    queue = (RefQueue if ref else DeviceWorkQueue)(max_depth=8)
    v = verifier_cls()
    flusher = RefQueueFlusher if ref else QueueFlusher
    return queue, dict(devsched=queue, flusher_for=lambda i, s: flusher(v, queue))


def _queued_pair(plan_fn, verifier, **kw):
    q, port_kw = _queued(verifier[0], False)
    rq, ref_kw = _queued(verifier[1], True)
    port, ref = _pair(plan_fn, ref_kw=ref_kw, **port_kw, **kw)
    assert (q.submitted, q.launches, q.coalesced) == (rq.submitted, rq.launches, rq.coalesced)
    return port, ref, q


def test_pipelined_settle_survives_crash_restart_and_partition():
    port, ref, q = _queued_pair(lambda m: _acceptance_plan(m, links=False),
                                (NullVerifier, RefNullVerifier))
    _same_run(port, ref)
    sim, result, monitor = port
    assert result.completed
    monitor.check_final(result)
    assert monitor.crashes and monitor.restores and monitor.heals
    assert q.coalesced > 0 and q.depth == 0
    flushers = [r.flusher for r in sim.replicas]
    assert all(not f._inflight for f in flushers)
    assert sum(f.dispatched for f in flushers) <= sum(f.submitted for f in flushers)
    base = Simulation(n=7, target_height=10, seed=2024, timeout=1.0, delivery_cost=1e-3,
                      chaos=_acceptance_plan(PORT, links=False)).run(max_steps=500_000)
    assert result.commit_digest() == base.commit_digest()


def test_pipelined_chaos_digest_parity_across_seeded_plans():
    for seed in (7, 7 + 9973):
        port, ref, _ = _queued_pair(lambda m, s=seed: m["FaultPlan"].seeded(s, 7),
                                    (NullVerifier, RefNullVerifier), seed=seed)
        _same_run(port, ref)
        port[2].check_final(port[1])
        seq = Simulation(n=7, target_height=10, seed=seed, timeout=1.0, delivery_cost=1e-3,
                         chaos=FaultPlan.seeded(seed, 7)).run(max_steps=500_000)
        assert port[1].commit_digest() == seq.commit_digest()


def test_signed_chaos_on_host_verifier_flushers_equals_jax():
    port, ref, q = _queued_pair(lambda m: m["FaultPlan"].seeded(3, 4),
                                (HostVerifier, RefHostVerifier), n=4, target=5, seed=3,
                                sign=True)
    _same_run(port, ref)
    port[2].check_final(port[1])
    assert q.launches < q.submitted


def test_certificate_commits_survive_partition_heal():
    port, ref = _pair(lambda m: _acceptance_plan(m, heal=2.0, links=False),
                      certificates=True)
    _same_run(port, ref)
    sim, result, monitor = port
    assert result.completed
    monitor.check_final(result)
    assert [c.chain_digest() for c in sim.certifiers] == [
        c.chain_digest() for c in ref[0].certifiers]
    minted = 0
    for i, certifier in enumerate(sim.certifiers):
        for h, cert in certifier.certs.items():
            v = result.commits[i].get(h)
            if v is not None:
                assert cert.value_digest == hashlib.sha256(v).digest()
            assert cert.signer_count() >= 2 * sim.f + 1 and certifier.verify(cert)
            minted += 1
    assert minted > 0


# ------------------------------------------------- overlay and epochs


def test_overlay_chaos_honest_peers_recover_after_heal():
    p, faults = FaultPlan.overlay(19951, 8)
    rp, rfaults = RefFaultPlan.overlay(19951, 8)
    runs = []
    for cls, mon_cls, plan, cfg, kw in (
            (Simulation, InvariantMonitor, p, OverlayConfig(faults=faults), {}),
            (RefSimulation, RefInvariantMonitor, rp, RefOverlayConfig(faults=rfaults),
             dict(observe=False))):
        sim = cls(n=8, seed=19951, target_height=8, timeout=1.0, delivery_cost=1e-3,
                  chaos=plan, overlay=cfg, **kw)
        mon = mon_cls(sim)
        res = sim.run(max_steps=500_000)
        mon.check_final(res)
        runs.append((sim, res, mon))
    _same_run(*runs)
    sim, result, _ = runs[0]
    snap = sim.overlay_snapshot()
    assert snap["honest_demoted"] == [] and snap["scores"]["demotions"] > 0
    assert snap == runs[1][0].overlay_snapshot()
    assert Simulation.replay(sim.record).commits == result.commits


def test_checkpoint_restore_across_epoch_boundary():
    victim = 5
    runs = []
    for cls, mon_cls, m, cfg, kw in (
            (Simulation, InvariantMonitor, PORT, EpochConfig, dict(device="cpu")),
            (RefSimulation, RefInvariantMonitor, REF, RefEpochConfig, dict(observe=False))):
        plan = m["FaultPlan"](crashes=(m["CrashRestart"](replica=victim, crash_at_step=400,
                                                         restart_after_steps=3000),))
        sim = cls(8, 10, seed=17, chaos=plan, delivery_cost=1e-3, certificates=True,
                  epochs=cfg(epoch_length=2, committee_size=6, rekey_per_epoch=1), **kw)
        mon = mon_cls(sim)
        res = sim.run(max_steps=400_000)
        mon.check_final(res)
        runs.append((sim, res, mon))
    _same_run(*runs)
    sim, _, mon = runs[0]
    assert mon.crashes and mon.restores == runs[1][2].restores
    assert mon.restores[0][1] > sim.epoch_schedule.boundary_height(0)
    assert sim.replicas[victim].proc.whoami == sim._identity[victim]
    assert sim.caught == runs[1][0].caught


def test_catchup_sweep_bounds_rejoin_latency():
    def run(cls, m, every, **kw):
        plan = m["FaultPlan"](partitions=(m["Partition"](at=0.5, heal=1.5, groups=((3,),),
                                                         resync_on_heal=False),))
        res = cls(8, 8, seed=23, delivery_cost=1e-3, chaos=plan, catchup_every=every,
                  **kw).run(max_steps=400_000)
        assert res.completed
        return res.steps, res.commit_digest()

    tight, loose = run(Simulation, PORT, 64), run(Simulation, PORT, 1024)
    assert tight[0] <= loose[0]
    assert tight == run(RefSimulation, REF, 64, observe=False)
    assert loose == run(RefSimulation, REF, 1024, observe=False)
