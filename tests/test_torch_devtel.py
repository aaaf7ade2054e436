"""The port's device-launch telemetry (``obs/devtel.py``) on its device-work
queue, against the JAX package's on the same submissions.

Both packages' queues run the same seeded commands on stub launchers
under an injected fake clock, so launch records, journals and registry
digests must be equal byte for byte. Then the port alone: the fetch probe
timing a sync inside a launch, a launcher that raises still sealing its
record and the probe, lanes from the verifier's bucket ladder, the
inert default, and ``TorchBatchVerifier(obs=)`` journaling its occupancy
and its mask copy on the CPU.
"""

import random

import pytest
import torch

from hyperdrive_tpu.devsched import DeviceWorkQueue as RefQueue
from hyperdrive_tpu.obs.devtel import DeviceTelemetry as RefTelemetry
from hyperdrive_tpu.obs.metrics import Registry as RefRegistry
from hyperdrive_tpu.obs.recorder import Recorder as RefRecorder
from hyperdrive_tpu_torch.analysis import annotations
from hyperdrive_tpu_torch.analysis.annotations import device_fetch
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.devsched import DeficitRoundRobin, DeviceWorkQueue
from hyperdrive_tpu_torch.obs import EVENT_KINDS, Recorder, Registry
from hyperdrive_tpu_torch.obs.devtel import (
    EXEC_ORIGIN,
    NULL_DEVTEL,
    DeviceTelemetry,
    NullDeviceTelemetry,
)
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

torch.set_num_threads(1)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class EchoLauncher:
    def __init__(self, kind):
        self.kind = kind

    def launch(self, payloads):
        return [list(p) for p in payloads]


def _probed(queue_cls, tel_cls, reg_cls, rec_cls, policy=None):
    clock = FakeClock()
    rec = rec_cls(capacity=512, time_fn=clock)
    tel = tel_cls(recorder=rec, registry=reg_cls(time_fn=clock), time_fn=clock)
    kw = {"devtel": tel, "obs": rec.scoped(-2)}
    if policy is not None:
        kw["policy"] = policy
    return queue_cls(**kw), tel, rec, clock


def _drive(q, clock, seed):
    """Seeded submissions: two launchers, table generations, origins
    (replicas, the sim track, the exec track), drains at random points."""
    rng = random.Random(seed)
    launchers = [EchoLauncher("verify"), EchoLauncher("exec")]
    futs = []
    for _ in range(60):
        clock.now += rng.choice((0.0, 0.001, 0.01))
        payload = list(range(rng.randrange(1, 9)))
        futs.append(q.submit(
            rng.choice(launchers), payload, rng.choice((0, 0, 1)),
            origin=rng.choice((0, 1, 2, -1, EXEC_ORIGIN, None)), rows=len(payload),
        ))
        if rng.random() < 0.2:
            clock.now += 0.005
            q.drain()
    q.drain()
    return [(f.seq, f.launch_id, f.result()) for f in futs]


def test_probed_queue_records_journal_and_registry_equal_jax():
    got_q, got_tel, got_rec, got_clock = _probed(
        DeviceWorkQueue, DeviceTelemetry, Registry, Recorder)
    ref_q, ref_tel, ref_rec, ref_clock = _probed(
        RefQueue, RefTelemetry, RefRegistry, RefRecorder)
    assert _drive(got_q, got_clock, 7) == _drive(ref_q, ref_clock, 7)
    assert [r.as_dict() for r in got_tel.records] == [r.as_dict() for r in ref_tel.records]
    assert got_rec.digest() == ref_rec.digest()
    assert got_tel.registry.digest() == ref_tel.registry.digest()
    snap = got_tel.registry.snapshot()
    assert snap["counters"]["devtel.launches"] == got_q.launches
    assert snap["counters"]["devtel.launch.gen_splits"] > 0
    assert snap["counters"]["devtel.fused.launches"] > 0
    assert {e.kind for e in got_rec.snapshot()} <= EVENT_KINDS


def test_probed_queue_under_a_drain_policy_equals_jax():
    from hyperdrive_tpu.devsched import DeficitRoundRobin as RefDeficitRoundRobin

    got_q, got_tel, got_rec, got_clock = _probed(
        DeviceWorkQueue, DeviceTelemetry, Registry, Recorder,
        DeficitRoundRobin(capacity_rows=8, quantum_rows=4))
    ref_q, ref_tel, ref_rec, ref_clock = _probed(
        RefQueue, RefTelemetry, RefRegistry, RefRecorder,
        RefDeficitRoundRobin(capacity_rows=8, quantum_rows=4))
    assert _drive(got_q, got_clock, 8) == _drive(ref_q, ref_clock, 8)
    assert got_rec.digest() == ref_rec.digest()
    assert got_tel.registry.digest() == ref_tel.registry.digest()
    assert any(e.kind == "tenant.drain.deferred" for e in got_rec.snapshot())


def test_fetch_probe_counts_and_times_a_sync_inside_a_launch():
    clock = FakeClock()
    tel = DeviceTelemetry(registry=Registry(time_fn=clock), time_fn=clock)

    class FetchingLauncher:
        kind = "fetching"

        def launch(self, payloads):
            clock.now += 0.25
            device_fetch(torch.tensor([1, 2, 3]), why="test sync")
            clock.now += 0.5
            return [list(p) for p in payloads]

    q = DeviceWorkQueue(devtel=tel)
    q.submit(FetchingLauncher(), [7], origin=0, rows=1)
    begin = tel.fetch_begin

    def slow_begin(why):
        begin(why)
        clock.now += 0.125

    tel.fetch_begin = slow_begin
    q.drain()
    [lr] = tel.records
    assert lr.syncs == 1
    assert lr.t_sync == pytest.approx(0.125)
    assert lr.t_dispatch == pytest.approx(0.75)
    assert lr.wall == pytest.approx(lr.t_pack + lr.t_dispatch + lr.t_sync + lr.t_unpack)
    device_fetch([1], why="outside a launch")
    assert tel.records[-1].syncs == 1 and annotations._fetch_probe is None


def test_launcher_exception_seals_the_record_and_the_probe():
    clock = FakeClock()
    rec = Recorder(capacity=64, time_fn=clock)
    tel = DeviceTelemetry(recorder=rec, registry=Registry(time_fn=clock), time_fn=clock)
    q = DeviceWorkQueue(devtel=tel)

    class Boom:
        kind = "boom"

        def launch(self, payloads):
            raise RuntimeError("device fell over")

    q.submit(Boom(), [1], origin=0, rows=1)
    with pytest.raises(RuntimeError, match="fell over"):
        q.drain()
    assert len(tel.records) == 1
    assert any(e.kind == "sched.launch.end" for e in rec.snapshot())
    assert annotations._fetch_probe is None and annotations._tapped is False


def test_lanes_come_from_the_verifiers_bucket_ladder_and_null_is_inert():
    clock = FakeClock()
    tel = DeviceTelemetry(registry=Registry(time_fn=clock), time_fn=clock)
    q = DeviceWorkQueue(devtel=tel)

    class Host:
        buckets = (4, 8, 16)

    class LadderedVerifier:
        host = Host()

        def verify_signatures(self, items):
            return [True] * len(items)

    q.submit(q.verify_launcher(LadderedVerifier()),
             [(b"\x00" * 32, b"\x01" * 32, b"\x02" * 64)] * 5, origin=0, rows=5)
    q.drain()
    [lr] = tel.records
    assert (lr.rows, lr.lanes, lr.occupancy_pct) == (5, 8, 62)
    plain = DeviceWorkQueue()
    assert plain.devtel is NULL_DEVTEL and isinstance(NULL_DEVTEL, NullDeviceTelemetry)
    fut = plain.submit(EchoLauncher("echo"), [1, 2])
    plain.drain()
    assert fut.seq is None and fut.launch_id is None


def test_torch_verifier_journals_occupancy_and_its_mask_copy():
    ring = KeyRing.deterministic(4, namespace=b"devtel")
    items = []
    for j in range(5):
        d = bytes([j]) * 32
        items.append((ring.signatories[j % 4], d, ring[j % 4].sign_digest(d)))
    items[2] = (items[2][0], items[2][1], bytes(64))  # forged
    rec = Recorder(capacity=64)
    verifier = TorchBatchVerifier(device="cpu", obs=rec.scoped(-1))
    annotations.set_fetch_observer(lambda why: rec.emit("fetch.sync", -1, -1, -1, why))
    try:
        mask = verifier.verify_signatures(items)
    finally:
        annotations.set_fetch_observer(None)
    assert mask.tolist() == [True, True, False, True, True]
    assert [(e.kind, e.detail) for e in rec.snapshot()] == [
        ("verify.occupancy.rows", 5),
        ("verify.occupancy.lanes", 64),
        ("verify.occupancy.pct", 8),
        ("fetch.sync", "chunk verify mask"),
    ]
