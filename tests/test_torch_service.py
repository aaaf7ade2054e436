"""The port's multi-tenant verify service against the JAX package's.

Modelled on ``tests/test_service.py``: every wire codec byte for byte on
seeded values and every decode error word for word; tenant digests across
a shared service, dedicated services, the JAX run and a remote tenant
over localhost TCP; certificate bytes; watermark retirement and track
ids; execution roots, proof queries and the four forged-proof variants;
rotation mid-serve; the v15 result-frame back-compat; a stamped request
served like an unstamped one; admission sheds; the dropped hooks. Tenants
verify on ``NullVerifier`` or ``HostVerifier`` (the card leg is
``chip_smoke.py``'s ``phase_service``). Every wait has a deadline of 5 s
and every socket is closed in ``finally``. Exact equality throughout.
"""

import contextlib
import dataclasses
import struct
import threading
import time

import numpy as np
import pytest
import torch

from hyperdrive_tpu.certificates import marshal_certificate as ref_marshal_certificate
from hyperdrive_tpu.codec import SerdeError as RefSerdeError
from hyperdrive_tpu.codec import Writer as RefWriter
from hyperdrive_tpu.exec import ExecutionConfig as RefExecutionConfig
from hyperdrive_tpu.exec.ledger import HostLedgerExecutor as RefHostLedgerExecutor
from hyperdrive_tpu.obs.merge import merge_journals as ref_merge_journals
from hyperdrive_tpu.obs.metrics import Registry as RefRegistry
from hyperdrive_tpu.obs.recorder import Recorder as RefRecorder
from hyperdrive_tpu.obs.tracectx import TraceSource as RefTraceSource
from hyperdrive_tpu.obs.tracectx import encode_stamp as ref_encode_stamp
from hyperdrive_tpu.obs.tracectx import split_frame as ref_split_frame
from hyperdrive_tpu.ops.merkle import MerkleProof as RefMerkleProof
from hyperdrive_tpu.parallel import service as ref
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu.verifier import NullVerifier as RefNullVerifier
from hyperdrive_tpu_torch import parallel
from hyperdrive_tpu_torch.certificates import marshal_certificate
from hyperdrive_tpu_torch.codec import SerdeError, Writer
from hyperdrive_tpu_torch.devsched import DeficitRoundRobin
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor
from hyperdrive_tpu_torch.load.backpressure import (
    CRITICAL_ONLY,
    SHED_DUPLICATES,
    SHED_LOW_PRIORITY,
    BackpressureController,
)
from hyperdrive_tpu_torch.obs import tracectx
from hyperdrive_tpu_torch.obs.devtel import DeviceTelemetry
from hyperdrive_tpu_torch.obs.merge import merge_journals
from hyperdrive_tpu_torch.obs.metrics import Registry
from hyperdrive_tpu_torch.obs.recorder import Recorder
from hyperdrive_tpu_torch.obs.tracectx import TraceSource
from hyperdrive_tpu_torch.ops.merkle import MAX_DEPTH, MerkleProof, verify_inclusion
from hyperdrive_tpu_torch.parallel import service
from hyperdrive_tpu_torch.parallel.service import (
    STATUS_COMMITTED,
    STATUS_NO_STATE,
    STATUS_SHED,
    STATUS_UNKNOWN_TENANT,
    RemoteServiceClient,
    ShardVerifyService,
    TenantShard,
)
from hyperdrive_tpu_torch.utils.trace import Tracer
from hyperdrive_tpu_torch.verifier import HostVerifier, NullVerifier

torch.set_num_threads(1)

DEADLINE = 5.0


def _service(**kw):
    return ShardVerifyService(NullVerifier(), max_depth=0, **kw)


def _ref_service(**kw):
    return ref.ShardVerifyService(RefNullVerifier(), max_depth=0, **kw)


def _drive(svc, shards, max_inflight=2, rounds=10_000):
    for _ in range(rounds):
        if all(s.done for s in shards):
            return
        for s in shards:
            s.pump(max_inflight=max_inflight)
        svc.drain()
    raise AssertionError("tenants did not finish")


def _pump_until(port, n=1):
    """Handle ``n`` parked requests (the reader threads deliver them
    asynchronously), failing after the deadline."""
    t0 = time.monotonic()
    handled = 0
    while handled < n:
        handled += port.pump()
        if time.monotonic() - t0 > DEADLINE:
            raise AssertionError(f"port handled {handled}/{n} requests")
        if handled < n:
            time.sleep(0.001)
    return handled


@contextlib.contextmanager
def _remote(svc, **port_kw):
    """A port on the service and one connected client, both closed (and
    the queue closed) on the way out."""
    port = svc.remote_port(**port_kw)
    client = None
    try:
        client = RemoteServiceClient(*port.address)
        yield port, client
    finally:
        if client is not None:
            client.close()
        port.close()
        svc.close()


def _run_remote(port, svc, remote):
    """Drive ``remote.run_remote`` on a thread while this thread serves
    the port, all inside the deadline."""
    t = threading.Thread(target=remote.run_remote, kwargs={"timeout": DEADLINE},
                         daemon=True)
    t.start()
    end = time.monotonic() + DEADLINE
    while t.is_alive() and time.monotonic() < end:
        port.pump()
        svc.drain()
        time.sleep(0.001)
    t.join(DEADLINE)
    assert not t.is_alive() and remote.done and remote.rejected == 0


def _exec_cfgs(seed=5):
    kw = dict(accounts=16, txs_per_block=8, stake_every=3, stake_accounts=4, seed=seed)
    return ExecutionConfig(**kw), RefExecutionConfig(**kw)


def _cert_bytes(cert, marshal=marshal_certificate, writer=Writer):
    w = writer()
    marshal(cert, w)
    return w.data()


# ------------------------------------------------------------- the wire


def _seeded_values(seed=17):
    rng = np.random.default_rng(seed)

    def b(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    sigs = [b(32) for _ in range(5)]
    rows = [(b(32), b(64)) for _ in range(7)]
    mask = [bool(x) for x in rng.integers(0, 2, 7)]
    proof = dict(height=int(rng.integers(1, 1 << 40)), account=int(rng.integers(0, 1 << 31)),
                 balance=int(rng.integers(-(1 << 40), 1 << 40)),
                 stake=int(rng.integers(-(1 << 40), 1 << 40)), prev_root=b(32),
                 digest=tuple(int(x) for x in rng.integers(0, 1 << 32, 8)),
                 siblings=tuple(tuple(int(x) for x in rng.integers(0, 1 << 32, 4))
                                for _ in range(5)))
    return sigs, rows, mask, proof, b(32), b(32)


def _encodings(mod, proof_cls):
    """Every encoder on seeded values: ``(frame, decoder name)`` pairs."""
    sigs, rows, mask, proof, value, root = _seeded_values()
    p = proof_cls(**proof)
    return [
        (mod.encode_hello("tenant-ü", sigs, 1), "decode_request"),
        (mod.encode_hello("t", sigs, 2, t0=1234.5), "decode_request"),
        (mod.encode_hello_ack(1.25, 2.5, 77), "decode_hello_ack"),
        (mod.encode_submit(9, 3, 1, value, rows, generation=2), "decode_request"),
        (mod.encode_submit((1 << 64) - 1, -1, 0, value, []), "decode_request"),
        (mod.encode_result(5, mod.STATUS_COMMITTED, 7, mask), "decode_result"),
        (mod.encode_result(5, mod.STATUS_COMMITTED, 7, mask, root=root), "decode_result"),
        (mod.encode_result(6, mod.STATUS_SHED, 0, ()), "decode_result"),
        (mod.encode_result(6, mod.STATUS_NO_QUORUM, 9, mask), "decode_result"),
        (mod.encode_query(11, 7), "decode_request"),
        (mod.encode_metrics_request(12), "decode_request"),
        (mod.encode_metrics_reply(12, mod.STATUS_COMMITTED, "hd_up 1\n"),
         "decode_metrics_reply"),
        (mod.encode_metrics_reply(13, mod.STATUS_SHED, "ignored"), "decode_metrics_reply"),
        (mod.encode_proof(8, mod.STATUS_COMMITTED, p), "decode_proof"),
        (mod.encode_proof(4, mod.STATUS_NO_STATE), "decode_proof"),
    ]


def _plain(decoded):
    return tuple(dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x
                 for x in decoded)


def test_every_encoder_writes_the_reference_bytes_and_decodes_back():
    got = _encodings(service, MerkleProof)
    assert got == _encodings(ref, RefMerkleProof)
    for frame, decoder in got:
        decoded = getattr(service, decoder)(frame)
        assert _plain(decoded) == _plain(getattr(ref, decoder)(frame))
    assert service.decode_hello_ack(got[2][0]) == (1.25, 2.5, 77)
    assert (service.TAG_QUERY, service.TAG_METRICS) == (ref.TAG_QUERY, ref.TAG_METRICS)
    assert service.STATUS_NAMES == ref.STATUS_NAMES


def _malformed():
    def w(*ops):
        out = Writer()
        for op, v in ops:
            getattr(out, op)(v)
        return out.data()

    good = service.encode_submit(1, 1, 0, b"\x11" * 32, [(b"\x22" * 32, b"\x01" * 64)])
    head = [("u8", 2), ("u64", 1), ("i64", 1), ("i64", 0), ("bytes32", b"\x00" * 32),
            ("u32", 0)]
    proof_head = [("u8", 4), ("u64", 1), ("u8", 0), ("i64", 1), ("u32", 0), ("i64", 0),
                  ("i64", 0), ("bytes32", b"\x00" * 32)]
    return {
        "request": [
            b"", b"\xff\x00junk", good[:-10], good + b"\x00",
            w(*head, ("u32", 1 << 20)),
            w(*head, ("u32", 1), ("bytes32", b"\x00" * 32), ("raw", b"\x00" * 97)),
            w(("u8", 1), ("raw", b"n" * 257), ("u32", 0), ("u32", 0)),
            w(("u8", 1), ("raw", b"n"), ("u32", 0), ("u32", 5000)),
            service.encode_hello("t", [b"\x01" * 32], 0) + b"\x00" * 9,
            service.encode_query(1, 2) + b"\x00", service.encode_metrics_request(1) + b"\x00",
            b"\x04\x00",
        ],
        "result": [
            b"\x03\x00", b"\x01" + b"\x00" * 20,
            w(("u8", 3), ("u64", 1), ("u8", 0), ("u32", 70_000)),
            w(("u8", 3), ("u64", 1), ("u8", 0), ("u32", 9), ("raw", b"\x00")),
            service.encode_result(9, STATUS_COMMITTED, 5, [True] * 5, root=b"\x42" * 8),
            service.encode_result(9, STATUS_COMMITTED, 5, [True] * 5) + b"\x00",
            w(("u8", 3), ("u64", 1), ("u8", 0), ("u32", 0), ("raw", b""), ("raw", b""),
              ("raw", b"\x00" * 5)),
        ],
        "proof": [
            b"\x03", service.encode_proof(4, STATUS_NO_STATE) + b"\x00",
            w(*proof_head, ("raw", b"\x00" * 32), ("u32", MAX_DEPTH + 1), ("raw", b"")),
            w(*proof_head, ("raw", b"\x00" * 31), ("u32", 0), ("raw", b"")),
            w(*proof_head, ("raw", b"\x00" * 32), ("u32", 2), ("raw", b"\x00" * 16)),
        ],
        "hello_ack": [b"\x02" + b"\x00" * 20, service.encode_hello_ack(1, 2, 3) + b"\x00"],
        "metrics_reply": [
            b"\x05\x00", service.encode_metrics_reply(1, STATUS_SHED) + b"\x00",
            service.encode_metrics_reply(1, STATUS_COMMITTED, "x") + b"\x00",
        ],
    }


@pytest.mark.parametrize("kind", ["request", "result", "proof", "hello_ack", "metrics_reply"])
def test_malformed_frames_raise_the_reference_errors(kind):
    decode = getattr(service, "decode_" + kind)
    ref_decode = getattr(ref, "decode_" + kind)
    for frame in _malformed()[kind]:
        with pytest.raises(RefSerdeError) as want:
            ref_decode(frame)
        with pytest.raises(SerdeError) as got:
            decode(frame)
        assert str(got.value) == str(want.value), frame


def _v15_encode_result(req_id, status, nrows, mask, root=b""):
    """The result-frame encoder as the v15-era client and server shipped
    it, frozen in struct calls (no code shared with the live codec)."""
    bitmap = bytearray(-(-nrows // 8)) if nrows else bytearray()
    for i, ok in enumerate(mask or ()):
        if ok:
            bitmap[i >> 3] |= 1 << (i & 7)
    out = struct.pack("<B", 3) + struct.pack("<Q", req_id)
    out += struct.pack("<B", status) + struct.pack("<I", nrows)
    out += struct.pack("<I", len(bitmap)) + bytes(bitmap)
    out += struct.pack("<I", len(root)) + bytes(root)
    out += struct.pack("<I", 0)  # no certificate tail
    return out


def test_result_frame_back_compat_with_v15():
    mask = [True, False, True, False, True]
    live = service.encode_result(5, STATUS_COMMITTED, 5, mask, root=b"\x42" * 32)
    frozen = _v15_encode_result(5, STATUS_COMMITTED, 5, mask, root=b"\x42" * 32)
    assert live == frozen
    assert service.decode_result(frozen) == (5, STATUS_COMMITTED, mask, None, b"\x42" * 32)
    assert service.encode_result(9, STATUS_SHED, 3, ()) == _v15_encode_result(
        9, STATUS_SHED, 3, ())


def test_stamp_strip_equals_the_reference_split():
    # The service splits stamps with obs.tracectx's split_frame (its
    # private copy is gone), the reference's split to the byte.
    assert service.split_trace_frame is tracectx.split_frame
    assert service.TRACE_MAGIC == tracectx.TRACE_MAGIC == 0x54
    payload = service.encode_query(3, 4)
    for frame in (ref_encode_stamp(7, 9, 11) + payload, payload, b"\x54\x00", b""):
        assert tracectx.split_frame(frame) == ref_split_frame(frame)
    assert tracectx.split_frame(ref_encode_stamp(7, 9, 11) + payload) == ((7, 9, 11), payload)


# ------------------------------------------------------- local serving


def test_shared_dedicated_and_reference_digests_agree():
    def shards(mod, svc, sign):
        return [mod.TenantShard(f"t{i}", target_height=4, sign=sign).attach_local(svc)
                for i in range(3)]

    shared = ShardVerifyService(HostVerifier(), max_depth=0,
                                policy=DeficitRoundRobin(capacity_rows=8, quantum_rows=4))
    signed = shards(service, shared, True)
    _drive(shared, signed)
    want = ref.ShardVerifyService(RefHostVerifier(), max_depth=0)
    ref_signed = shards(ref, want, True)
    _drive(want, ref_signed)
    assert [s.commit_digest() for s in signed] == [s.commit_digest() for s in ref_signed]
    assert shared.queue.launches < shared.queue.submitted
    for s in signed:
        solo_svc = _service()
        solo = TenantShard(s.name, target_height=4, sign=False).attach_local(solo_svc)
        _drive(solo_svc, [solo])
        assert solo.commit_digest() == s.commit_digest()
        assert not s.rejected and len(s.commit_latencies) == 4


def test_certificates_equal_the_reference_bytes():
    svc, want = _service(), _ref_service()
    a = TenantShard("c", n_validators=7, target_height=3, sign=False).attach_local(svc)
    b = ref.TenantShard("c", n_validators=7, target_height=3, sign=False).attach_local(want)
    _drive(svc, [a])
    _drive(want, [b])
    for h in (1, 2, 3):
        got = _cert_bytes(svc.certificates["c"][h])
        assert got == _cert_bytes(want.certificates["c"][h], ref_marshal_certificate, RefWriter)
        frame = service.encode_result(h, STATUS_COMMITTED, 7, [True] * 7,
                                      svc.certificates["c"][h])
        assert frame == ref.encode_result(h, STATUS_COMMITTED, 7, [True] * 7,
                                          want.certificates["c"][h])
        assert a.certifier.verify(service.decode_result(frame)[3])
    forged = dataclasses.replace(svc.certificates["c"][1], value_digest=b"\x13" * 32)
    assert not svc.accept_certificate("c", a.certifier, forged)
    assert svc.certificates["c"][1] is not forged


def test_watermark_retirement_bounds_state_and_equals_the_reference():
    keep = 32
    svc, want = _service(cert_keep=keep), _ref_service(cert_keep=keep)
    shard = TenantShard("soak", target_height=10_000, sign=False).attach_local(svc)
    ref_shard = ref.TenantShard("soak", target_height=10_000, sign=False).attach_local(want)
    peak = 0
    while not shard.done:
        shard.pump(max_inflight=8)
        svc.drain()
        peak = max(peak, len(svc.certificates["soak"]))
    _drive(want, [ref_shard], max_inflight=8)
    assert svc.watermarks["soak"] == 10_000 and shard.rejected == 0
    assert peak <= keep + 8 and len(svc.certificates["soak"]) <= keep
    assert svc.retired_certs == want.retired_certs >= 10_000 - keep - 8
    assert sorted(svc.certificates["soak"]) == sorted(want.certificates["soak"])
    assert shard.commit_digest() == ref_shard.commit_digest()
    assert len(svc.tenants) == 1 and len(svc.tenant_ids) == 1


def test_retire_tenant_never_reuses_track_ids():
    svc = _service(cert_keep=4)
    _drive(svc, [TenantShard("a", target_height=2, sign=False).attach_local(svc)])
    tid_a = svc.tenant_ids["a"]
    assert svc.retire_tenant("a") == 2
    assert "a" not in svc.certificates and "a" not in svc.watermarks
    _drive(svc, [TenantShard("a", target_height=1, sign=False).attach_local(svc)])
    assert svc.tenant_ids["a"] != tid_a
    assert svc.retired_certs == 2


def test_execution_roots_speculation_and_rotation():
    cfg, ref_cfg = _exec_cfgs()
    svc = _service()
    shard = TenantShard("led", target_height=4, sign=False, execution=cfg).attach_local(svc)
    plain = TenantShard("plain", target_height=4, sign=False).attach_local(svc)
    _drive(svc, [shard, plain])
    host, want = HostLedgerExecutor(cfg), RefHostLedgerExecutor(ref_cfg)
    for h in range(1, 5):
        assert shard.state_roots[h] == host.advance_to(h) == want.advance_to(h)
    ex = svc.executors["led"]
    assert (ex.spec_confirmed, ex.spec_rolled_back, ex._spec) == (4, 0, {})
    assert ex.applied_total == want.applied_total and plain.state_roots == {}
    signed = dataclasses.replace(cfg, sign_txs=True)
    svc.attach_execution("signed", signed)
    assert svc.speculate_height("signed", 1) is False

    class Generations(NullVerifier):
        def __init__(self):
            self.generations = []

        def set_generation(self, g):
            self.generations.append(g)

    def serve(rotate_at):
        verifier = Generations()
        svc = ShardVerifyService(verifier, max_depth=0)
        s = TenantShard("rot", target_height=6, sign=False,
                        execution=_exec_cfgs(seed=3)[0]).attach_local(svc)
        while not s.done:
            if rotate_at is not None and len(s.commits) >= rotate_at:
                svc.rotate(generation=1)
                s.generation, rotate_at = 1, None
            s.pump(max_inflight=1)
            svc.drain()
        return s, verifier.generations

    rotated, gens = serve(3)
    baseline, none = serve(None)
    assert gens == [1] and none == [] and rotated.generation == 1
    assert rotated.state_roots == baseline.state_roots
    assert sorted(rotated.state_roots) == list(range(1, 7))
    assert rotated.commit_digest() == baseline.commit_digest()


# ------------------------------------------------------- remote serving


def test_remote_tenant_digest_roots_and_coalescing():
    cfg, ref_cfg = _exec_cfgs(seed=9)
    svc = _service()
    svc.attach_execution("rx", cfg)
    with _remote(svc) as (port, client):
        local = TenantShard("local", target_height=1, sign=False).attach_local(svc)
        remote = TenantShard("rx", target_height=3, sign=False).attach_remote(client)
        fut, _, _ = remote._remote_submit(1)
        remote.next_height = 2
        _pump_until(port, n=2)  # hello + submit
        local.pump(max_inflight=1)
        assert svc.drain() == 2
        assert svc.queue.launches == 1 and svc.queue.coalesced == 1
        status, mask, cert = fut.result(DEADLINE)
        assert status == STATUS_COMMITTED and all(mask)
        assert remote.certifier.verify(cert)
        remote.commits[1], remote.state_roots[1] = remote.value_at(1), fut.root
        _run_remote(port, svc, remote)
        assert port.inflight == 0 and svc.watermarks["rx"] == 3
        want = RefHostLedgerExecutor(ref_cfg)
        for h in range(1, 4):
            assert remote.state_roots[h] == want.advance_to(h)
    solo_svc = _ref_service()
    solo = ref.TenantShard("rx", target_height=3, sign=False).attach_local(solo_svc)
    _drive(solo_svc, [solo])
    assert remote.commit_digest() == solo.commit_digest()


def _query(port, svc, client, account):
    fut = client.query(account)
    end = time.monotonic() + DEADLINE
    while not fut.done() and time.monotonic() < end:
        port.pump()
        svc.drain()
        time.sleep(0.001)
    return fut.proof_result(timeout=DEADLINE)


def test_remote_query_proof_and_forged_variants():
    cfg, ref_cfg = _exec_cfgs(seed=7)
    svc = _service()
    svc.attach_execution("rx", cfg)
    with _remote(svc) as (port, client):
        remote = TenantShard("rx", target_height=3, sign=False)
        client.hello("rx", remote.ring.signatories, remote.f)
        status, proof = _query(port, svc, client, 0)
        assert (status, proof) == (STATUS_NO_STATE, None)
        remote.certifier = svc.certifier(remote.ring.signatories, remote.f)
        remote.client = client
        _run_remote(port, svc, remote)
        status, proof = _query(port, svc, client, 5)
        assert status == STATUS_COMMITTED and port.remote_queries == 1
        want = RefHostLedgerExecutor(ref_cfg)
        want.advance_to(3)
        ref_proof = want.proof_basis().prove(5)
        assert dataclasses.astuple(proof) == dataclasses.astuple(ref_proof)
        trusted = remote.state_roots[proof.height]
        assert remote.verify_balance(proof, trusted) and len(proof.siblings) == 4
        for bad in (
            dataclasses.replace(proof, prev_root=b"\x00" * 32),
            dataclasses.replace(proof, siblings=((1, 2, 3, 4),) + proof.siblings[1:]),
            dataclasses.replace(proof, siblings=proof.siblings[:-1]),
            dataclasses.replace(proof, balance=proof.balance + 1),
        ):
            assert not verify_inclusion(trusted, 5, bad.balance, bad.stake, bad)
        port.controller.floor = SHED_LOW_PRIORITY
        port.controller.poll()
        assert _query(port, svc, client, 2) == (STATUS_SHED, None)
        assert port.query_sheds == 1
        port.controller.floor = 0
        for _ in range(port.controller.hysteresis):
            port.controller.poll()
        status, proof = _query(port, svc, client, 2)
        assert status == STATUS_COMMITTED
        assert remote.verify_balance(proof, remote.state_roots[proof.height])


def test_critical_shed_answers_busy_and_the_resubmit_commits():
    svc = _service()
    controller = BackpressureController()
    controller.watch(svc.queue)
    controller.floor = CRITICAL_ONLY
    with _remote(svc, controller=controller) as (port, client):
        remote = TenantShard("shed", target_height=1, sign=False).attach_remote(client)
        fut, _, _ = remote._remote_submit(1)
        _pump_until(port, n=2)
        status, _, cert = fut.result(DEADLINE)
        assert status == STATUS_SHED and cert is None and port.remote_sheds == 1
        assert svc.queue.depth == 0 and svc.tenants == {}
        controller.floor = 0
        for _ in range(controller.hysteresis):
            controller.poll()
        fut2, _, _ = remote._remote_submit(1)
        _pump_until(port, n=1)
        svc.drain()
        status, mask, cert = fut2.result(DEADLINE)
        assert status == STATUS_COMMITTED and all(mask) and remote.certifier.verify(cert)
        # A replay of the committed height sheds as stale at SHED_DUPLICATES.
        controller.floor = SHED_DUPLICATES
        fut3, _, _ = remote._remote_submit(1)
        _pump_until(port, n=1)
        assert fut3.result(DEADLINE)[0] == STATUS_SHED and svc.watermarks["shed"] == 1


def test_stamped_request_is_served_like_an_unstamped_one():
    svc = _service()
    with _remote(svc) as (port, client):
        shard = TenantShard("st", target_height=2, sign=False)
        client._send(ref_encode_stamp(3, 1) + service.encode_hello(
            "st", shard.ring.signatories, shard.f))
        futs = []
        for h, stamp in ((1, ref_encode_stamp(3, 2, 1)), (2, b"")):
            fut = service.RemoteFuture()
            with client._pending_lock:
                client._pending[h] = fut
            client._send(stamp + service.encode_submit(h, h, 0, shard.value_at(h),
                                                       shard.window(h)))
            futs.append(fut)
        client._send(b"\xee\xeejunk")
        _pump_until(port, n=4)
        svc.drain()
        certs = [f.result(DEADLINE)[2] for f in futs]
        assert [f.status for f in futs] == [STATUS_COMMITTED] * 2
        assert port.bad_frames == 1 and svc.watermarks["st"] == 2
        solo_svc = _service()
        solo = TenantShard("st", target_height=2, sign=False).attach_local(solo_svc)
        _drive(solo_svc, [solo])
        assert [_cert_bytes(c) for c in certs] == [
            _cert_bytes(solo_svc.certificates["st"][h]) for h in (1, 2)]


def _scrape_after_unknown_tenant(svc, mod):
    """An unknown tenant's submit, its hello, then a metrics scrape:
    ``(submit status, scrape answer)``."""
    with _remote(svc) as (port, client):
        shard = mod.TenantShard("ghost", target_height=1, sign=False)
        fut = client.submit(1, 0, shard.value_at(1), shard.window(1))
        _pump_until(port, n=1)
        status, mask, cert = fut.result(DEADLINE)
        assert cert is None and not any(mask)
        client.hello("ghost", shard.ring.signatories, shard.f)
        scrape = client.metrics()
        _pump_until(port, n=2)
        return status, scrape.metrics_result(DEADLINE)


def test_unknown_tenant_metrics_and_dropped_hooks():
    # Without a registry a scrape answers STATUS_NO_STATE; with one (the
    # hooks refused until ROADMAP item 4b) it answers the registry's
    # Prometheus text, the JAX service's text to the byte.
    status, answer = _scrape_after_unknown_tenant(_service(), service)
    assert status == STATUS_UNKNOWN_TENANT and answer == (STATUS_NO_STATE, None)
    got = _scrape_after_unknown_tenant(_service(registry=Registry()), service)
    want = _scrape_after_unknown_tenant(
        _ref_service(registry=RefRegistry()), ref)
    assert got == want and got[1][0] == STATUS_COMMITTED
    assert "hd_service_queue_launches 0" in got[1][1].splitlines()
    assert "hd_service_metrics_serves 0" in got[1][1].splitlines()
    # The service hands its hooks to its queue and its certifiers.
    rec, tel, tracer = Recorder(time_fn=lambda: 0.0), DeviceTelemetry(), Tracer()
    reg = Registry()
    svc = ShardVerifyService(NullVerifier(), obs=rec.scoped(-1), tracer=tracer,
                             devtel=tel, registry=reg)
    try:
        assert (svc.queue.obs, svc.queue.tracer, svc.queue.devtel) == (
            svc.obs, tracer, tel)
        assert svc.registry is reg
        sig = b"\x01" * 32
        cert = svc.certifier([sig], 0, obs=rec.scoped(4)).observe_commit(1, 0, b"v", [sig])
        assert [(e.replica, e.kind, e.detail) for e in rec.snapshot()] == [
            (4, "cert.emit", cert.value_digest.hex()[:16])]
    finally:
        svc.close()


def test_traced_remote_tenant_and_latency_equal_across_packages():
    # A JAX tenant with a trace source against a traced port service with
    # every hook: stamped answers, trace.recv on both ends, the clock
    # offset from the hello echo, and the merged journals of both
    # processes pair every span. The tenant's digest is the JAX run's,
    # and each tenant's verify and commit latency lands in the registry.
    svc_rec, cli_rec = Recorder(threadsafe=True), RefRecorder(threadsafe=True)
    reg = Registry()
    svc = ShardVerifyService(NullVerifier(), max_depth=0, obs=svc_rec.scoped(-1),
                             devtel=DeviceTelemetry(registry=reg), registry=reg)
    port = svc.remote_port(trace=TraceSource(1, obs=svc_rec.scoped(-1)))
    client = None
    try:
        client = ref.RemoteServiceClient(
            *port.address, obs=cli_rec.scoped(-1),
            trace=RefTraceSource(2, obs=cli_rec.scoped(-1)))
        local = TenantShard("local", target_height=2, sign=False).attach_local(svc)
        remote = ref.TenantShard("rx", target_height=3, sign=False).attach_remote(client)
        _run_remote(port, svc, remote)
        _drive(svc, [local])
    finally:
        if client is not None:
            client.close()
        port.close()
        svc.close()
    solo_svc = _ref_service()
    solo = ref.TenantShard("rx", target_height=3, sign=False).attach_local(solo_svc)
    _drive(solo_svc, [solo])
    assert remote.commit_digest() == solo.commit_digest()
    assert 1 in client.clock_offsets
    journals = []
    for origin, rec in ((1, svc_rec), (2, cli_rec)):
        kinds = [e.kind for e in rec.snapshot()]
        assert kinds.count("trace.send") == kinds.count("trace.recv") > 0
        journals.append(rec.journal(meta={"origin": origin}))
    assert "trace.offset" in {e.kind for e in cli_rec.snapshot()}
    assert {"service.remote.submit", "service.remote.resolve", "cert.emit"} <= {
        e.kind for e in svc_rec.snapshot()}
    merged = merge_journals(journals)
    assert merged == ref_merge_journals(journals) and merged["meta"]["orphans"] == []
    hist = reg.snapshot()["histograms"]
    tids = svc.tenant_ids
    assert hist["tenant.verify.latency"].keys() == {str(tids["rx"]), str(tids["local"])}
    assert hist["tenant.commit.latency"].keys() == {"rx", str(tids["rx"]), str(tids["local"])}
    assert hist["tenant.commit.latency"]["rx"]["count"] == 3


def test_parallel_package_exports():
    assert parallel.ShardVerifyService is ShardVerifyService
    assert parallel.TenantShard is TenantShard
    assert parallel.__all__ == [
        "RemoteServiceClient", "ServicePort", "ShardVerifyService", "TenantShard"]
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        parallel.make_mesh
    with pytest.raises(AttributeError):
        parallel.meteor
