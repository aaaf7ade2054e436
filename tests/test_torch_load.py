"""The port's ``load/`` package against the JAX package's.

Every case of the JAX package's ``tests/test_load.py`` runs on both
packages with the same seeded inputs: arrival lists, the
``LoadRuntime`` caps, the controller's hysteresis and floor, the queue
feeding the controller, the gate's shed, fairness, query and accounting
cases, the signer reputation and ``note_verify``, the loaded n = 4
simulation (digest and ``overload_snapshot``), the overload family and
the escalating profile; then the two admission cases of
``tests/test_transport.py`` on the port's ``TcpNode`` (without the
registry). The tolerance is exact equality throughout: the port's
numbers, levels and counters must be the JAX package's.
"""

import dataclasses
import socket
from types import SimpleNamespace

import pytest
import torch

import hyperdrive_tpu.chaos.plan as ref_plan
import hyperdrive_tpu.devsched as ref_devsched
import hyperdrive_tpu.harness.sim as ref_sim
import hyperdrive_tpu.load as ref_load
import hyperdrive_tpu.load.backpressure as ref_bp
import hyperdrive_tpu.load.frames as ref_frames
import hyperdrive_tpu.load.generator as ref_gen
import hyperdrive_tpu.messages as ref_msgs
import hyperdrive_tpu.verifier as ref_verifier
import hyperdrive_tpu_torch.chaos.plan as plan
import hyperdrive_tpu_torch.devsched as devsched
import hyperdrive_tpu_torch.harness.sim as sim
import hyperdrive_tpu_torch.load as load
import hyperdrive_tpu_torch.load.backpressure as bp
import hyperdrive_tpu_torch.load.frames as frames
import hyperdrive_tpu_torch.load.generator as gen
import hyperdrive_tpu_torch.messages as msgs
import hyperdrive_tpu_torch.verifier as verifier
from hyperdrive_tpu_torch.transport import _PEER_QUEUE, TcpNode

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

PORT = SimpleNamespace(load=load, bp=bp, gen=gen, msgs=msgs, frames=frames,
                       devsched=devsched, sim=sim, plan=plan, verifier=verifier,
                       kw=dict(device="cpu"))
REF = SimpleNamespace(load=ref_load, bp=ref_bp, gen=ref_gen, msgs=ref_msgs,
                      frames=ref_frames, devsched=ref_devsched, sim=ref_sim,
                      plan=ref_plan, verifier=ref_verifier, kw={})


def _both(case):
    """Run ``case`` on the port and on the JAX package; the results must
    be equal. Returns the port's."""
    got = case(PORT)
    assert got == case(REF)
    return got


def _pv(m, sender=b"\x01", height=5, round_=0, value=b"\x07"):
    return m.msgs.Prevote(height=height, round=round_, value=value * 32,
                          sender=sender * 32)


def _pinned(m, level):
    ctrl = m.bp.BackpressureController()
    ctrl.floor = level
    ctrl.poll()
    return ctrl


def test_exports_match_the_reference():
    assert set(load.__all__) >= set(ref_load.__all__)
    for name in ref_load.__all__:
        assert hasattr(load, name)
    assert bp.SHED_CLASSES == ref_bp.SHED_CLASSES
    assert bp.LEVEL_NAMES == ref_bp.LEVEL_NAMES
    assert bp.REPUTATION_WEIGHTS == ref_bp.REPUTATION_WEIGHTS
    assert (bp.ACCEPT, bp.SHED_DUPLICATES, bp.SHED_LOW_PRIORITY, bp.CRITICAL_ONLY) == (
        ref_bp.ACCEPT, ref_bp.SHED_DUPLICATES, ref_bp.SHED_LOW_PRIORITY,
        ref_bp.CRITICAL_ONLY)


# ---------------------------------------------------------------- schedules


def test_arrival_lists_equal_the_reference():
    def case(m):
        a = m.load.PoissonSchedule(2000.0, seed=9).arrivals(0.5)
        b = m.load.PoissonSchedule(2000.0, seed=9).arrivals(0.5)
        c = m.load.PoissonSchedule(2000.0, seed=10).arrivals(0.5)
        burst = m.load.BurstSchedule(3200.0, burst=32, seed=4).arrivals(0.25)
        jit = m.load.BurstSchedule(800.0, burst=8, seed=4, jitter=0.5).arrivals(0.25)
        return a, b, c, burst, jit

    a, b, c, burst, jit = _both(case)
    assert a == b and a != c
    assert all(0.0 <= t < 0.5 for t in a) and a == sorted(a)
    assert 700 <= len(a) <= 1300
    assert len(burst) % 32 == 0 and len(set(burst)) == len(burst) // 32
    assert jit == sorted(jit)
    for bad in (dict(rate=0.0), dict(rate=1.0, burst=0), dict(rate=1.0, jitter=1.0)):
        for m in (PORT, REF):
            with pytest.raises(ValueError):
                m.load.BurstSchedule(**bad)


def test_load_runtime_caps_and_carries_excess():
    def case(m):
        rt = m.gen.LoadRuntime(m.load.LoadProfile(rate=1000.0, seed=3, amp_cap=16))
        dues = [rt.due(1.0)]
        while dues[-1]:
            dues.append(rt.due(1.0))
        rt2 = m.gen.LoadRuntime(m.load.LoadProfile(rate=1000.0, seed=3, stop=0.5))
        return dues, rt.offered, rt2.due(0.75)

    dues, offered, after_stop = _both(case)
    assert dues[0] == 16 and all(k <= 16 for k in dues)
    assert sum(dues) == offered and 800 <= offered <= 1200
    assert after_stop == 0


# --------------------------------------------------------------- controller


def test_controller_hysteresis_and_floor():
    def case(m):
        ctrl = m.bp.BackpressureController(hysteresis=3)
        levels = [ctrl.level]
        for act in ("d8", "d300", "d0", "p", "p"):
            if act == "p":
                ctrl.poll()
            else:
                ctrl.note_depth(int(act[1:]))
            levels.append(ctrl.level)
        pinned = _pinned(m, m.bp.SHED_DUPLICATES)
        floor = []
        for _ in range(10):
            floor.append(pinned.poll())
        pinned.note_peer_occupancy(0.95)
        floor.append(pinned.level)
        return levels, ctrl.transitions, floor

    levels, transitions, floor = _both(case)
    assert levels == [bp.ACCEPT, bp.SHED_DUPLICATES, bp.CRITICAL_ONLY,
                      bp.CRITICAL_ONLY, bp.CRITICAL_ONLY, bp.ACCEPT]
    assert transitions == 3
    assert floor == [bp.SHED_DUPLICATES] * 10 + [bp.CRITICAL_ONLY]


def test_device_queue_feeds_controller_signals():
    def case(m):
        clock = [0.0]
        queue = m.devsched.DeviceWorkQueue(max_depth=64)
        ctrl = m.bp.BackpressureController(hysteresis=1, time_fn=lambda: clock[0])
        ctrl.watch(queue)
        launcher = m.devsched.NullVerifyLauncher()
        for _ in range(8):
            queue.submit(launcher, [b"x"])
        at_depth = ctrl.level
        queue.drain()
        ctrl.poll()
        return queue.controller is ctrl, at_depth, ctrl.level, ctrl._drain_s

    watched, at_depth, after, drain_s = _both(case)
    assert watched and at_depth == bp.SHED_DUPLICATES
    assert after == bp.ACCEPT and drain_s == 0.0


# --------------------------------------------------------------------- gate


def _gate_dup_stale(m):
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.SHED_DUPLICATES), height_fn=lambda: 5)
    pv = _pv(m)
    got = [gate.admit(pv), gate.admit(pv), gate.admit(_pv(m, height=3)),
           gate.admit(_pv(m, value=b"\x08"))]
    return got, gate.snapshot()


def _gate_never_shed(m):
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.CRITICAL_ONLY), height_fn=lambda: 5)
    pp = m.msgs.Propose(height=5, round=0, valid_round=-1, value=b"\x07" * 32,
                        sender=b"\x01" * 32, payload=b"")
    pc = m.msgs.Precommit(height=5, round=0, value=b"\x07" * 32, sender=b"\x01" * 32)
    got = [gate.admit(pp), gate.admit(pp), gate.admit(object()), gate.admit(pc),
           gate.admit(_pv(m))]
    return got, gate.snapshot()


def _gate_fairness(m):
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.SHED_LOW_PRIORITY), fair_window=8,
                              fair_share=0.25)
    hog, meek = ("10.0.0.1", 1), ("10.0.0.2", 2)
    got = [gate.admit(_pv(m, value=bytes([i])), peer=hog) for i in range(6)]
    got.append(gate.admit(_pv(m, sender=b"\x02", value=bytes([99])), peer=meek))
    return got, gate.snapshot()


def _gate_query(m):
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.SHED_DUPLICATES), height_fn=lambda: 5)
    got = [gate.admit(m.frames.QueryFrame(account=3)) for _ in range(2)]
    snaps = [gate.snapshot()]
    for level in (m.bp.SHED_LOW_PRIORITY, m.bp.CRITICAL_ONLY):
        gate = m.bp.AdmissionGate(_pinned(m, level), height_fn=lambda: 5)
        got += [gate.admit(m.frames.QueryFrame(account=3)), gate.admit(object()),
                gate.admit(m.msgs.Precommit(height=5, round=0, value=b"\x07" * 32,
                                            sender=b"\x01" * 32))]
        snaps.append(gate.snapshot())
    return got, snaps


def _gate_query_accounting(m):
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.SHED_LOW_PRIORITY), height_fn=lambda: 5)
    for i in range(4):
        gate.admit(m.frames.QueryFrame(account=i))
    gate.admit(_pv(m, value=b"\x08"))
    quiet = m.bp.AdmissionGate(_pinned(m, m.bp.ACCEPT))
    got = [quiet.admit(m.frames.QueryFrame(account=0)) for _ in range(8)]
    return got + [quiet._mem == {}], gate.snapshot()


def _gate_accounting(m):
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.SHED_DUPLICATES), height_fn=lambda: 5)
    pv = _pv(m)
    got = [gate.admit(x) for x in (pv, pv, _pv(m, height=1), _pv(m, value=b"\x09"))]
    return got, gate.snapshot()


GATE_CASES = {
    "dup_stale": (_gate_dup_stale, [True, False, False, True],
                  {"duplicate": 1, "stale_height": 1}),
    "never_shed": (_gate_never_shed, [True, True, True, True, False], {"panic": 1}),
    "fairness": (_gate_fairness, [True, True] + [False] * 4 + [True],
                 {"low_priority": 4}),
    "query": (_gate_query, [True, True] + [False, True, True] * 2, None),
    "query_accounting": (_gate_query_accounting, [True] * 9, {"query": 4}),
    "accounting": (_gate_accounting, [True, False, False, True],
                   {"duplicate": 1, "stale_height": 1}),
}


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_gate_cases(name):
    case, want, shed = GATE_CASES[name]
    got, snap = _both(case)
    assert got == want
    for s in snap if isinstance(snap, list) else [snap]:
        assert s["offered"] == s["admitted"] + sum(s["shed"].values())
    if shed is not None:
        assert snap["shed"] == shed
    else:
        assert [s["shed"] for s in snap] == [{}, {"query": 1}, {"query": 1}]


# --------------------------------------------------------------- reputation


def _rep_demote_amnesty(m):
    rep = m.bp.SignerReputation()
    peer = b"\x05" * 32
    trace = [rep.charge(peer), rep.is_demoted(peer), rep.charge(peer), rep.is_demoted(peer)]
    for _ in range(5):
        rep.rehabilitate(1)
        trace.append(rep.is_demoted(peer))
    for _ in range(50):
        rep.charge(peer)
    return trace, rep.scores[peer], rep.snapshot()


def _rep_credit(m):
    rep = m.bp.SignerReputation()
    peer = b"\x06" * 32
    rep.charge(peer)
    rep.charge(peer)
    trace = [rep.credit(peer, rows=4), rep.is_demoted(peer), rep.credit(peer, rows=1),
             rep.is_demoted(peer), rep.credit(peer, rows=100)]
    return trace, rep.snapshot()


def _rep_note_verify(m):
    rep = m.bp.SignerReputation()
    gate = m.bp.AdmissionGate(_pinned(m, m.bp.ACCEPT), reputation=rep, height_fn=lambda: 5)
    forger = b"\x04" * 32
    trace = [gate.admit(_pv(m, sender=b"\x04"), peer=forger)]
    gate.note_verify(forger, False, 2)
    trace += [rep.is_demoted(forger), gate.admit(_pv(m, sender=b"\x04", value=b"\x09"),
                                                 peer=forger)]
    pp = m.msgs.Propose(height=5, round=0, valid_round=-1, value=b"\x07" * 32,
                        sender=forger, payload=b"")
    pc = m.msgs.Precommit(height=5, round=0, value=b"\x07" * 32, sender=forger)
    trace += [gate.admit(pp, peer=forger), gate.admit(pc, peer=forger)]
    gate.note_verify(forger, True, 12)
    trace += [rep.is_demoted(forger),
              gate.admit(_pv(m, sender=b"\x04", value=b"\x0a"), peer=forger)]
    return trace, gate.snapshot()


@pytest.mark.parametrize("name", ["demote_amnesty", "credit", "note_verify"])
def test_reputation(name):
    got = _both({"demote_amnesty": _rep_demote_amnesty, "credit": _rep_credit,
                 "note_verify": _rep_note_verify}[name])
    if name == "demote_amnesty":
        trace, floor, snap = got
        assert trace == [-6, False, -12, True, True, True, True, True, False]
        assert floor == -64 and snap["demotions"] == 2 and snap["recoveries"] == 1
    elif name == "credit":
        trace, _ = got
        assert trace == [-8, True, -7, False, 0]
    else:
        trace, snap = got
        assert trace == [True, True, False, True, True, False, True]
        assert snap["shed"] == {"reputation": 1}
        assert snap["verify_failed_by_peer"] == {b"\x04" * 32: 2}
        assert snap["shed_by_peer"] == {b"\x04" * 32: 1}


# ---------------------------------------------------------------- sim storm


def _loaded(m, load_profile=None, **kw):
    extra = {} if load_profile is None else {"load": load_profile}
    s = m.sim.Simulation(n=4, target_height=4, seed=17, timeout=1.0, delivery_cost=1e-3,
                         **extra, **kw, **m.kw)
    res = s.run()
    return s, res


def test_loaded_sim_commits_the_reference_chain():
    def case(m):
        _, base = _loaded(m)
        s, res = _loaded(m, m.load.LoadProfile(rate=4000.0, seed=17))
        return (base.commit_digest(), res.commit_digest(), res.steps,
                len(s.record.messages), s.overload_snapshot())

    base, digest, _, _, snap = _both(case)
    assert digest == base
    assert snap["injected"] > 0 and 0 < snap["injected_sheddable"] <= snap["injected"]
    assert snap["shed"] and set(snap["shed"]) <= {"duplicate", "stale_height"}
    assert snap["offered"] == snap["admitted"] + sum(snap["shed"].values())


def test_overload_family_and_profile_validation():
    def case(m):
        p, profile = m.plan.FaultPlan.overload(77, 4)
        return (p == m.plan.FaultPlan.seeded(77, 4), dataclasses.astuple(profile),
                dataclasses.astuple(m.load.LoadProfile.seeded(1002)))

    same, profile, seeded = _both(case)
    assert same and profile[7] and profile[6] <= bp.SHED_DUPLICATES
    for bad in (dict(rate=0.0), dict(rate=100.0, burst=0),
                dict(rate=100.0, start=2.0, stop=1.0), dict(rate=1.0, amp_cap=0)):
        for m in (PORT, REF):
            with pytest.raises(ValueError):
                m.load.LoadProfile(**bad).validate()


def test_load_refusals():
    for kw, match in ((dict(burst=True), "lock-step"), (dict(delivery_cost=0.0), "delivery_cost")):
        for m in (PORT, REF):
            args = dict(n=4, target_height=2, delivery_cost=1e-3)
            args.update(kw)
            with pytest.raises(ValueError, match=match):
                m.sim.Simulation(load=m.load.LoadProfile(rate=10.0), **args)


def test_escalating_profile_equals_the_reference():
    # pin=False couples the controller to the device-work queue on the
    # virtual clock: the level trajectory is deterministic, and the
    # port's equals the JAX run's.
    def case(m):
        queue = m.devsched.DeviceWorkQueue(max_depth=96)
        s = m.sim.Simulation(
            n=4, target_height=3, seed=29, timeout=1.0, delivery_cost=1e-3,
            devsched=queue,
            flusher_for=lambda i, v: m.devsched.QueueFlusher(m.verifier.NullVerifier(),
                                                             queue),
            load=dataclasses.replace(m.load.LoadProfile(rate=6000.0, seed=29), pin=False),
            **m.kw)
        res = s.run()
        res.assert_safety()
        return (res.completed, res.commit_digest(), res.steps, s.overload_snapshot(),
                queue.controller is s.load_controller,
                (queue.submitted, queue.launches, queue.coalesced))

    completed, _, _, snap, watched, _ = _both(case)
    assert completed and watched
    assert snap["offered"] == snap["admitted"] + sum(snap["shed"].values())


# ----------------------------------------------------------------- transport


class _Sink:
    def __init__(self):
        self.prevotes = []

    def propose(self, msg, stop):
        pass

    def prevote(self, msg, stop):
        self.prevotes.append(msg)

    def precommit(self, msg, stop):
        pass


def test_wire_admission_gates_ingress_but_not_own_broadcasts():
    ctrl = bp.BackpressureController(threadsafe=True)
    ctrl.floor = bp.SHED_DUPLICATES
    ctrl.poll()
    gate = bp.AdmissionGate(ctrl, threadsafe=True)
    node = TcpNode(admission=gate)
    sink = _Sink()
    node.add_replica(sink)
    try:
        pv = msgs.Prevote(height=1, round=0, value=b"\x05" * 32, sender=b"\x01" * 32)
        peer = ("127.0.0.1", 7)
        node._deliver(pv, peer=peer)
        node._deliver(pv, peer=peer)
        assert len(sink.prevotes) == 1
        assert gate.shed == {"duplicate": 1}
        node.broadcast(pv)  # local: never gated
        assert len(sink.prevotes) == 2
    finally:
        node.stop()


def test_backlog_overflow_sheds_new_prevotes_under_pressure():
    ctrl = bp.BackpressureController(threadsafe=True)
    ctrl.floor = bp.SHED_LOW_PRIORITY
    ctrl.poll()
    gate = bp.AdmissionGate(ctrl, threadsafe=True)
    node = TcpNode(admission=gate)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    try:
        node.add_peer("127.0.0.1", dead_port)
        pv = msgs.Prevote(height=1, round=0, value=b"\x05" * 32, sender=b"\x01" * 32)
        for _ in range(_PEER_QUEUE + 4):
            node.broadcast(pv)
        key = ("127.0.0.1", dead_port)
        assert node.dropped_frames == {key: 4}
        # The queue still holds the OLDEST frames (nothing evicted), and
        # the full backlog was fed back as occupancy.
        assert node._peer_queues[key].qsize() == _PEER_QUEUE
        assert ctrl._occupancy == 1.0 and ctrl.level == bp.CRITICAL_ONLY
    finally:
        node.stop()
