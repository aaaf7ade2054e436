"""The port's record/replay log against the JAX package's.

``ScenarioRecord``'s v7 wire format is the reference's byte for byte: the
port's dump of BASELINE config 2's network (20 heights, lock-step,
unsigned) equals the JAX dump, and dumps cross-load: a JAX dump replays
in the port, and a port dump in the JAX package, to the same commits and
heights, for lock-step, burst and execution-trailer records. Older
format versions load, malformed headers raise ``SerdeError``, equal
deliveries are interned but deliveries that differ only in signature stay
distinct objects, ``record=False`` records nothing, and the
broadcast-compact ``RecordedMessages`` behaves as the flat list it
stands for. The tolerance is exact equality.
"""

import hashlib

import pytest
import torch

from hyperdrive_tpu.chaos import CrashRestart as RefCrashRestart
from hyperdrive_tpu.chaos import FaultPlan as RefFaultPlan
from hyperdrive_tpu.codec import Reader as RefReader
from hyperdrive_tpu.codec import Writer as RefWriter
from hyperdrive_tpu.exec import ExecutionConfig as RefExecutionConfig
from hyperdrive_tpu.harness.sim import ScenarioRecord as RefScenarioRecord
from hyperdrive_tpu.harness.sim import Simulation as RefSimulation
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.chaos import CrashRestart, FaultPlan
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.harness import ScenarioRecord, Simulation
from hyperdrive_tpu_torch.harness.sim import RecordedMessages
from hyperdrive_tpu_torch.messages import Prevote, marshal_message
from hyperdrive_tpu_torch.verifier import HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

CONFIG2 = dict(n=16, target_height=20, seed=1002, timeout=20.0, delivery_cost=0.001)


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_config2_dump_is_byte_identical_to_jax(tmp_path):
    got = Simulation(**CONFIG2).run()
    want = RefSimulation(**CONFIG2).run()
    got.record.dump(str(tmp_path / "port.bin"))
    want.record.dump(str(tmp_path / "jax.bin"))
    data = _bytes(tmp_path / "port.bin")
    assert data == _bytes(tmp_path / "jax.bin")
    assert (len(data), hashlib.sha256(data).hexdigest()[:16]) == (937123, "c436b3d9b3d06ea6")
    assert got.record.bursts == [] and got.record.batch_ingest is False
    assert len(got.record.messages) == got.steps == 10480


_HOST = (dict(batch_verifier=HostVerifier()), dict(batch_verifier=RefHostVerifier()))


@pytest.mark.parametrize("mode", ["lockstep", "burst", "execution"])
def test_dumps_cross_load_and_replay(mode, tmp_path):
    kw = dict(n=4, target_height=3, seed=5)
    port_kw, ref_kw = {}, {}
    replay_port, replay_ref = {}, {}
    if mode == "lockstep":
        # Signed, with every replica's own verifier on the CPU: a
        # HostVerifier, as the reference's.
        kw.update(sign=True, reorder=True, timeout=2.0)
        port_kw = replay_port = dict(device="cpu")
    elif mode == "burst":
        kw.update(sign=True, burst=True, dedup_verify=True)
        port_kw, ref_kw = _HOST
        replay_port, replay_ref = dict(sign=True, **_HOST[0]), dict(sign=True, **_HOST[1])
    else:
        cfg = dict(accounts=16, txs_per_block=8, seed=2)
        port_kw = dict(execution=ExecutionConfig(**cfg), device="cpu")
        ref_kw = dict(execution=RefExecutionConfig(**cfg))
        replay_port = dict(device="cpu")
    got = Simulation(**kw, **port_kw).run()
    want = RefSimulation(**kw, **ref_kw).run()
    assert got.commit_digest() == want.commit_digest()
    got.record.dump(str(tmp_path / "port.bin"))
    want.record.dump(str(tmp_path / "jax.bin"))
    assert _bytes(tmp_path / "port.bin") == _bytes(tmp_path / "jax.bin")
    into_port = Simulation.replay(ScenarioRecord.load(str(tmp_path / "jax.bin")), **replay_port)
    into_jax = RefSimulation.replay(
        RefScenarioRecord.load(str(tmp_path / "port.bin")), **replay_ref
    )
    for res in (into_port, into_jax):
        assert res.commits == want.commits and res.heights == want.heights
    assert into_port.sim.replicas and into_port.record.messages == got.record.messages
    assert (into_port.sim.burst, bool(got.record.bursts)) == (mode == "burst",) * 2
    if mode == "execution":
        assert into_port.record.execution == got.record.execution is not None


@pytest.mark.parametrize("version", [2, 4])
def test_old_versions_load(version):
    # A hand-built dump of an older version: the header, one signatory,
    # one delivery; v3 added the burst sizes, v4 the batch_ingest flag.
    msg = Prevote(height=1, round=0, value=b"\x01" * 32, sender=b"\x07" * 32)
    w = Writer()
    w.u32(ScenarioRecord.MAGIC)
    w.u32(version)
    w.u64(9)
    w.u32(4)
    w.u32(1)
    w.i64(3)
    w.u32(1)
    w.bytes32(b"\x07" * 32)
    w.u32(1)
    w.u32(2)
    marshal_message(msg, w)
    if version >= 3:
        w.u32(2)
        w.u32(3)
        w.u32(4)
    if version >= 4:
        w.bool(True)
    data = w.data()
    for got in (ScenarioRecord.unmarshal(Reader(data)),
                RefScenarioRecord.unmarshal(RefReader(data))):
        assert (got.seed, got.n, got.f, got.target_height) == (9, 4, 1, 3)
        assert got.signatories == [b"\x07" * 32]
        assert [(to, m.sender, m.value) for to, m in got.messages] == [(2, msg.sender, msg.value)]
        assert got.bursts == ([3, 4] if version >= 3 else [])
        # Batched ingestion did not exist before v4: older dumps replay by
        # per-message dispatch.
        assert got.batch_ingest is (version >= 4)
        assert got.lifecycle == [] and got.epochs is None and got.execution is None


@pytest.mark.parametrize("patch,match", [
    (lambda w: w.u32(0x1234), "not a scenario dump"),
    (lambda w: (w.u32(ScenarioRecord.MAGIC), w.u32(8)), "version 8"),
    (lambda w: (w.u32(ScenarioRecord.MAGIC), w.u32(7), w.u64(1), w.u32(4), w.u32(1),
                w.i64(3), w.u32((1 << 20) + 1)), "signatory count"),
    (lambda w: (w.u32(ScenarioRecord.MAGIC), w.u32(7), w.u64(1), w.u32(4), w.u32(1),
                w.i64(3), w.u32(0), w.u32((1 << 24) + 1)), "message count"),
    (lambda w: (w.u32(ScenarioRecord.MAGIC), w.u32(7), w.u64(1)), "underflow"),
], ids=["magic", "version", "signatories", "messages", "truncated"])
def test_malformed_headers_raise(patch, match):
    w = Writer()
    patch(w)
    with pytest.raises(SerdeError, match=match):
        ScenarioRecord.unmarshal(Reader(w.data()))


def test_interning_keeps_signatures_apart():
    ring = KeyRing.deterministic(2, namespace=b"intern")
    base = Prevote(height=1, round=0, value=b"\x05" * 32, sender=ring[0].public)
    good = ring[0].sign_message(base)
    forged = ring[1].sign_message(base)
    assert good == forged and good.signature != forged.signature
    rec = ScenarioRecord(seed=1, n=2, f=0, target_height=1, signatories=ring.signatories,
                         messages=[(0, good), (1, good), (0, forged), (1, forged)])
    w = Writer()
    rec.marshal(w)
    back = ScenarioRecord.unmarshal(Reader(w.data())).messages
    # One object per (message, signature): the shared broadcast keeps its
    # identity for the dedup verification, the forged twin stays apart.
    assert back[0][1] is back[1][1] and back[2][1] is back[3][1]
    assert back[0][1] is not back[2][1]
    assert [m.signature for _, m in back] == [good.signature] * 2 + [forged.signature] * 2
    verdicts = HostVerifier().verify_batch([m for _, m in back])
    assert list(map(bool, verdicts)) == [True, True, False, False]


@pytest.mark.parametrize("burst", [False, True], ids=["lockstep", "burst"])
def test_record_false_records_nothing(burst):
    kw = dict(n=4, target_height=2, seed=3, burst=burst)
    off = Simulation(record=False, **kw).run()
    on = Simulation(**kw).run()
    assert off.record is None and len(on.record.messages) > 0
    assert off.commit_digest() == on.commit_digest() and off.steps == on.steps
    assert bool(on.record.bursts) == burst


def test_recorded_messages_list_compatibility():
    # JAX tests/test_harness.py's list-compatibility check.
    log = RecordedMessages()
    log.append((3, "t0"))
    log.append_broadcast("b0", [0, 1, 2])
    log.append((1, "t1"))
    expect = [(3, "t0"), (0, "b0"), (1, "b0"), (2, "b0"), (1, "t1")]
    assert len(log) == 5
    assert log == expect and not log != expect
    assert log[1] == (0, "b0")
    assert log[1:4] == expect[1:4]
    assert list(log) == expect
    log.append_broadcast("b1", [2, 0])
    log.append((0, "t2"))
    expect += [(2, "b1"), (0, "b1"), (0, "t2")]
    assert len(log) == 8
    assert log == expect
    other = RecordedMessages()
    for to, m in expect:
        other.append((to, m))
    assert log == other


def test_chaos_lifecycle_record_refused():
    # Chaos is ported: a record with crash and restore operations is no
    # longer refused but replayed, the victim's checkpoints re-derived. The
    # same n = 4 run in both packages gives the same record bytes, and each
    # package's replay of it gives the live run's commits.
    plans = (FaultPlan(crashes=(CrashRestart(replica=1, crash_at_step=60,
                                             restart_after_steps=80),)),
             RefFaultPlan(crashes=(RefCrashRestart(replica=1, crash_at_step=60,
                                                   restart_after_steps=80),)))
    live = Simulation(n=4, target_height=4, seed=1, delivery_cost=1e-3,
                      chaos=plans[0]).run()
    ref = RefSimulation(n=4, target_height=4, seed=1, delivery_cost=1e-3,
                        chaos=plans[1], observe=False).run()
    w, rw = Writer(), RefWriter()
    live.record.marshal(w)
    ref.record.marshal(rw)
    assert w.data() == rw.data()
    rec = ScenarioRecord.unmarshal(Reader(w.data()))
    kinds = [op[0] for op in rec.lifecycle]
    assert ScenarioRecord.OP_CRASH in kinds and ScenarioRecord.OP_RESTORE in kinds
    assert live.completed and live.commits == ref.commits
    assert Simulation.replay(rec).commits == live.commits
    assert RefSimulation.replay(RefScenarioRecord.unmarshal(RefReader(w.data()))).commits \
        == live.commits
