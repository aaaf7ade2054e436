"""The multi-tenant verify service: continuous batching as a deployment.

Port copy of the JAX package's ``parallel/service.py``. M independent
shard-consensus instances (each its own committee, its own chain) funnel
verify/tally windows into ONE
:class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue`: inference-server
continuous batching applied to consensus. The drain loop coalesces
whatever is pending across ALL tenants into the next launch, so the
launch and sync cost is paid once a drain for every instance instead of
once a shard (PAPERS.md "ACE Runtime" makes the serving-system framing,
arXiv:2302.00418 shows verify throughput is the binding resource). With a
``TorchBatchVerifier`` every drain is one ``ed25519_verify`` launch on the
card.

Three layers, all host-side (the device enters only through whatever
verifier the caller hands in):

- :class:`ShardVerifyService`: the shared verifier + queue + per-tenant
  accounting (certificates, watermarks, tenant track ids). The drain
  policy seam (devsched/policy.py) rides the queue, so a firehose tenant
  cannot monopolize launch occupancy.
- :class:`ServicePort` / :class:`RemoteServiceClient`: cross-process
  batching over the transport's length-framed TCP machinery: replicas in
  OTHER processes ship packed precommit windows to the host that owns
  the device queue and get their futures resolved by certificate frames
  back (O(1) proof, not 2f+1 signatures). Ingress reuses the
  admission/backpressure doctrine from ``load/``: duplicate and
  stale-height windows shed at pressure, CRITICAL_ONLY turns submits
  away with a busy status, and nothing is ever silently dropped: every
  request is answered.
- :class:`TenantShard`: one instance's drive loop: sign a window,
  submit (locally or through a client), count the quorum, mint/verify
  the certificate, record the commit. The same class runs both sides of
  the wire, which is what makes local-vs-remote digest parity a single
  assertion.

Every frame is byte for byte the reference's, and a malformed frame raises
the same :class:`~hyperdrive_tpu_torch.codec.SerdeError`. The hooks are
the reference's: the recorder (``obs``), the metrics sink (``tracer``),
the launch probe (``devtel``) with the per-tenant latency histograms it
feeds, the metrics registry (``registry``, which answers a metrics
scrape) and the causal trace source (``trace``: stamped answers and
requests, ``trace.recv`` marks, the hello-ack's origin and the client's
clock-offset estimate). The sixteen ``@wire_codec`` registrations of
the service frames and every decoder's budget reader
(``maybe_wire_reader``: HDS005 under ``HD_SANITIZE``) are the
reference's. The ``serve`` and ``tenant`` CLI is
``python -m hyperdrive_tpu_torch.parallel``.
"""

from __future__ import annotations

import hashlib
import queue as queue_mod
import socket
import struct
import threading
import time

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.analysis.sanitizer import maybe_wire_reader
from hyperdrive_tpu_torch.certificates import (
    marshal_certificate,
    unmarshal_certificate,
)
from hyperdrive_tpu_torch.codec import SerdeError, Writer
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.messages import Precommit
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND
from hyperdrive_tpu_torch.obs.tracectx import (
    TRACE_MAGIC,
    note_recv as note_trace_recv,
    split_frame as split_trace_frame,
)
from hyperdrive_tpu_torch.ops.merkle import MAX_DEPTH, MerkleProof
from hyperdrive_tpu_torch.transport import _LEN, _MAX_FRAME, _recv_exact

__all__ = [
    "ShardVerifyService",
    "ServicePort",
    "RemoteServiceClient",
    "RemoteFuture",
    "TenantShard",
    "STATUS_COMMITTED",
    "STATUS_NO_QUORUM",
    "STATUS_SHED",
    "STATUS_UNKNOWN_TENANT",
    "STATUS_NO_STATE",
    "TAG_QUERY",
    "TAG_METRICS",
    "encode_query",
    "encode_proof",
    "decode_proof",
    "encode_metrics_request",
    "encode_metrics_reply",
    "decode_metrics_reply",
    "encode_hello_ack",
    "decode_hello_ack",
]

# ------------------------------------------------------------ wire format
#
# Same 4-byte little-endian length framing as transport.py, distinct
# payload tags (this port speaks windows and certificates, not consensus
# envelopes). All payloads go through codec.Writer/Reader so adversarial
# bytes raise SerdeError instead of crashing the port.

TAG_HELLO = 1
TAG_SUBMIT = 2
TAG_RESULT = 3
#: Proof query (request) / proof answer (response) — the trustless read
#: path. Result frames keep TAG_RESULT byte-for-byte, so a v15-era
#: client and this port interoperate on the submit path unchanged
#: (tests/test_service.py pins the cross-version roundtrip).
TAG_QUERY = 4
#: Live-metrics scrape (request) / Prometheus snapshot (response) — the
#: observability read path. Classed WITH proof queries at the admission
#: gate (first-shed at SHED_LOW_PRIORITY), so a scrape storm can never
#: displace consensus traffic.
TAG_METRICS = 5

STATUS_COMMITTED = 0
STATUS_NO_QUORUM = 1
STATUS_SHED = 2
STATUS_UNKNOWN_TENANT = 3
#: Query answered before the tenant's first certificate landed (no
#: settled basis to prove against yet) — retryable, like SHED.
STATUS_NO_STATE = 4

STATUS_NAMES = ("committed", "no_quorum", "shed", "unknown_tenant",
                "no_state")

#: Committee width cap for HELLO (matches the certificate bitmap cap).
_MAX_SIGNATORIES = 4096
#: Rows per submitted window — far above any committee's 2f+1 burst.
_MAX_ROWS = 65536
#: Tenant-name cap for HELLO: a name is an identifier, not a payload.
_MAX_NAME = 256
#: Widest per-row detached signature (Ed25519 64, BLS G2 96).
_MAX_ROW_SIG = 96


@wire_codec(tag="service.hello", max_bytes=1 << 18)
def encode_hello(name: str, signatories, f: int, t0: float = 0.0) -> bytes:
    """``t0`` (optional trailing f64) is the client's wall-clock send
    stamp: the port echoes it back in the hello-ack so the client can
    estimate the server's clock offset NTP-style (``obs merge`` aligns
    per-process journals on those estimates). Pre-echo clients simply
    omit it — :func:`decode_request` reads 0.0 and the ack degrades to
    a no-offset handshake."""
    w = Writer()
    w.u8(TAG_HELLO)
    w.raw(name.encode("utf-8"))
    w.u32(int(f))
    w.u32(len(signatories))
    for s in signatories:
        w.bytes32(s)
    if t0:
        w.f64(float(t0))
    return w.data()


@wire_codec(tag="service.hello.ack", max_bytes=64)
def encode_hello_ack(t0: float, t1: float, origin: int) -> bytes:
    """The port's answer to HELLO: the client's echoed send stamp, the
    server's own receive stamp, and the server's trace origin id. From
    ``(t0, t1, t3=now)`` the client estimates the server clock offset
    as ``t1 - (t0 + t3) / 2`` — half the round trip cancels out."""
    w = Writer()
    w.u8(TAG_HELLO)
    w.f64(float(t0))
    w.f64(float(t1))
    w.u32(int(origin))
    return w.data()


@wire_codec(tag="service.hello.ack", max_bytes=64)
def decode_hello_ack(payload: bytes):
    """Client-side decode: ``(t0, t1, origin)``."""
    r = maybe_wire_reader("service.hello.ack", payload)
    if r.u8() != TAG_HELLO:
        raise SerdeError("expected a hello-ack frame")
    t0 = r.f64()
    t1 = r.f64()
    origin = r.u32()
    if not r.done():
        raise SerdeError("trailing bytes after hello-ack frame")
    return t0, t1, origin


@wire_codec(tag="service.submit", max_bytes=_MAX_FRAME)
def encode_submit(req_id: int, height: int, round: int, value: bytes,
                  rows, generation: int = 0) -> bytes:
    """``rows``: signed :class:`~hyperdrive_tpu_torch.messages.Precommit`s (or
    bare ``(sender, signature)`` pairs) for ONE (height, round, value)
    window. The digest is recomputed server-side from the header, so the
    wire carries 32 + ~68 bytes per row, not the whole envelope."""
    w = Writer()
    w.u8(TAG_SUBMIT)
    w.u64(req_id)
    w.i64(height)
    w.i64(round)
    w.bytes32(value)
    w.u32(int(generation))
    w.u32(len(rows))
    for row in rows:
        if isinstance(row, tuple):
            sender, sig = row
        else:
            sender, sig = row.sender, row.signature
        w.bytes32(sender)
        w.raw(sig)
    return w.data()


@wire_codec(tag="service.result", max_bytes=_MAX_FRAME)
def encode_result(req_id: int, status: int, nrows: int, mask,
                  cert=None, root=None) -> bytes:
    """``root`` (32 bytes or None) rides between the mask and the
    certificate tail: a serving host with an execution ledger attached
    for the tenant stamps the committed frame with the chained state
    root its executor derived at that height, so the O(1) certificate
    answer vouches for ledger state, not just the agreed value."""
    w = Writer()
    w.u8(TAG_RESULT)
    w.u64(req_id)
    w.u8(int(status))
    w.u32(int(nrows))
    bitmap = bytearray(-(-nrows // 8)) if nrows else bytearray()
    for i, ok in enumerate(mask or ()):
        if ok:
            bitmap[i >> 3] |= 1 << (i & 7)
    w.raw(bytes(bitmap))
    w.raw(root or b"")
    if cert is not None:
        cw = Writer()
        marshal_certificate(cert, cw)
        w.raw(cw.data())
    else:
        w.raw(b"")
    return w.data()


@wire_codec(tag="service.query", max_bytes=64)
def encode_query(req_id: int, account: int) -> bytes:
    """A stateless client's proof request: ONE account id. The answer
    (:func:`encode_proof`) is self-contained — the client needs nothing
    but the certificate-chain root it already trusts."""
    w = Writer()
    w.u8(TAG_QUERY)
    w.u64(req_id)
    w.u32(int(account))
    return w.data()


@wire_codec(tag="service.metrics", max_bytes=64)
def encode_metrics_request(req_id: int) -> bytes:
    """A live-metrics scrape: request the Registry's Prometheus
    snapshot over the service port. Carries nothing but the request id
    — the cheapest frame in the protocol, and the first one shed."""
    w = Writer()
    w.u8(TAG_METRICS)
    w.u64(req_id)
    return w.data()


@wire_codec(tag="service.metrics.reply", max_bytes=1 << 18)
def encode_metrics_reply(req_id: int, status: int, text: str = "") -> bytes:
    """ONE metrics answer: the rendered Prometheus exposition text (or
    an empty body for refusals). The 256 KiB budget bounds what a
    Byzantine server can make a scraper buffer."""
    w = Writer()
    w.u8(TAG_METRICS)
    w.u64(req_id)
    w.u8(int(status))
    if status == STATUS_COMMITTED:
        w.raw(text.encode("utf-8"))
    return w.data()


@wire_codec(tag="service.metrics.reply", max_bytes=1 << 18)
def decode_metrics_reply(payload: bytes):
    """Client-side decode: ``(req_id, status, text_or_None)``."""
    r = maybe_wire_reader("service.metrics.reply", payload)
    if r.u8() != TAG_METRICS:
        raise SerdeError("expected a metrics reply frame")
    req_id = r.u64()
    status = r.u8()
    if status != STATUS_COMMITTED:
        if not r.done():
            raise SerdeError("trailing bytes after metrics status")
        return req_id, status, None
    text = r.raw().decode("utf-8", "replace")
    if not r.done():
        raise SerdeError("trailing bytes after metrics reply")
    return req_id, status, text


@wire_codec(tag="service.proof", max_bytes=4096)
def encode_proof(req_id: int, status: int, proof=None) -> bytes:
    """ONE proof frame: leaf values, the O(1) chain witness (previous
    root + state digest), and the O(log n) sibling path — everything
    :func:`~hyperdrive_tpu_torch.ops.merkle.verify_inclusion` needs against a
    trusted root, with zero trust in the serving replica. Non-committed
    statuses carry no body."""
    w = Writer()
    w.u8(TAG_QUERY)
    w.u64(req_id)
    w.u8(int(status))
    if status != STATUS_COMMITTED:
        return w.data()
    w.i64(proof.height)
    w.u32(proof.account)
    w.i64(proof.balance)
    w.i64(proof.stake)
    w.bytes32(proof.prev_root)
    w.raw(struct.pack("<8I", *proof.digest))
    w.u32(len(proof.siblings))
    w.raw(b"".join(struct.pack("<4I", *sib) for sib in proof.siblings))
    return w.data()


@wire_codec(tag="service.proof", max_bytes=4096)
def decode_proof(payload: bytes):
    """Client-side decode: ``(req_id, status, proof_or_None)``. Raises
    SerdeError on malformed bytes, trailing garbage, or a path deeper
    than MAX_DEPTH — a Byzantine server cannot make the client loop or
    allocate unboundedly."""
    r = maybe_wire_reader("service.proof", payload)
    if r.u8() != TAG_QUERY:
        raise SerdeError("expected a proof frame")
    req_id = r.u64()
    status = r.u8()
    if status != STATUS_COMMITTED:
        if not r.done():
            raise SerdeError("trailing bytes after proof status")
        return req_id, status, None
    height = r.i64()
    account = r.u32()
    balance = r.i64()
    stake = r.i64()
    prev_root = r.bytes32()
    digest_raw = r.raw()
    if len(digest_raw) != 32:
        raise SerdeError(
            f"proof digest must be 32 bytes, got {len(digest_raw)}"
        )
    depth = r.u32()
    if depth > MAX_DEPTH:
        raise SerdeError(f"proof path deeper than {MAX_DEPTH}: {depth}")
    sib_raw = r.raw()
    if len(sib_raw) != 16 * depth:
        raise SerdeError("sibling bytes disagree with the path depth")
    proof = MerkleProof(
        height=height,
        account=account,
        balance=balance,
        stake=stake,
        prev_root=prev_root,
        digest=struct.unpack("<8I", digest_raw),
        siblings=tuple(
            struct.unpack_from("<4I", sib_raw, 16 * i)
            for i in range(depth)
        ),
    )
    if not r.done():
        raise SerdeError("trailing bytes after proof frame")
    return req_id, status, proof


#: First frame byte -> budget family for the shared request decoder:
#: each request kind is charged against ITS OWN registered budget, so a
#: 256 KiB hello cannot hide behind the wider submit allowance.
_REQUEST_FAMILIES = {
    TAG_HELLO: "service.hello",
    TAG_SUBMIT: "service.submit",
    TAG_QUERY: "service.query",
    TAG_METRICS: "service.metrics",
}


@wire_codec(tag="service.hello", max_bytes=1 << 18)
@wire_codec(tag="service.submit", max_bytes=_MAX_FRAME)
@wire_codec(tag="service.query", max_bytes=64)
@wire_codec(tag="service.metrics", max_bytes=64)
def decode_request(payload: bytes):
    """Server-side decode: ``("hello", name, f, signatories, t0)``,
    ``("submit", req_id, height, round, value, generation, rows)`` with
    ``rows`` as ``(sender, signature)`` pairs,
    ``("query", req_id, account)``, or ``("metrics", req_id)``. Raises
    SerdeError on anything malformed, over the width caps, or carrying
    trailing garbage — a truncated or padded frame is rejected typed,
    never half-decoded."""
    if not payload:
        raise SerdeError("empty service frame")
    family = _REQUEST_FAMILIES.get(payload[0])
    if family is None:
        raise SerdeError(f"unknown service frame tag: {payload[0]}")
    r = maybe_wire_reader(family, payload)
    tag = r.u8()
    if tag == TAG_HELLO:
        name_raw = r.raw()
        if len(name_raw) > _MAX_NAME:
            raise SerdeError(f"tenant name too long: {len(name_raw)}")
        name = name_raw.decode("utf-8", "replace")
        f = r.u32()
        n = r.u32()
        if n > _MAX_SIGNATORIES:
            raise SerdeError(f"committee too wide: {n}")
        sigs = [r.bytes32() for _ in range(n)]
        # Pre-echo hellos end here; echo-era clients append their
        # wall-clock send stamp (the offset-estimation seed).
        t0 = 0.0 if r.done() else r.f64()
        if not r.done():
            raise SerdeError("trailing bytes after hello frame")
        return ("hello", name, f, sigs, t0)
    if tag == TAG_SUBMIT:
        req_id = r.u64()
        height = r.i64()
        rnd = r.i64()
        value = r.bytes32()
        generation = r.u32()
        n = r.u32()
        if n > _MAX_ROWS:
            raise SerdeError(f"window too wide: {n} rows")
        rows = []
        for _ in range(n):
            sender = r.bytes32()
            sig = r.raw()
            if len(sig) > _MAX_ROW_SIG:
                raise SerdeError(f"row signature too wide: {len(sig)}")
            rows.append((sender, sig))
        if not r.done():
            raise SerdeError("trailing bytes after submit frame")
        return ("submit", req_id, height, rnd, value, generation, rows)
    if tag == TAG_METRICS:
        req = ("metrics", r.u64())
        if not r.done():
            raise SerdeError("trailing bytes after metrics frame")
        return req
    req = ("query", r.u64(), r.u32())
    if not r.done():
        raise SerdeError("trailing bytes after query frame")
    return req


@wire_codec(tag="service.result", max_bytes=_MAX_FRAME)
def decode_result(payload: bytes):
    """Client-side decode:
    ``(req_id, status, mask, cert_or_None, root_or_None)``. The bitmap
    must be exactly ``ceil(n/8)`` wide (the canonical encoding) and the
    frame must end where the certificate tail ends."""
    r = maybe_wire_reader("service.result", payload)
    if r.u8() != TAG_RESULT:
        raise SerdeError("expected a result frame")
    req_id = r.u64()
    status = r.u8()
    n = r.u32()
    if n > _MAX_ROWS:
        raise SerdeError(f"result mask too wide: {n} rows")
    bitmap = r.raw()
    if len(bitmap) != -(-n // 8):
        raise SerdeError("result bitmap width disagrees with its row count")
    mask = [bool(bitmap[i >> 3] >> (i & 7) & 1) for i in range(n)]
    root = r.raw() or None
    if root is not None and len(root) != 32:
        raise SerdeError(f"state root must be 32 bytes, got {len(root)}")
    cert_bytes = r.raw()
    cert = unmarshal_certificate(
        maybe_wire_reader("cert.quorum", cert_bytes)
    ) if cert_bytes else None
    if not r.done():
        raise SerdeError("trailing bytes after result frame")
    return req_id, status, mask, cert, root


# ---------------------------------------------------------------- service


class ShardVerifyService:
    """One verifier + one async device-work queue, shared by every
    replica a host runs: the multi-tenant batching seam.

    A host that runs many replicas (one per shard/tenant it serves) must
    NOT let each of them launch its own verify — per-launch sync cost
    multiplied by tenant count is exactly the bill devsched exists to
    split. Every tenant submits into the same
    :class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue`, so windows from
    all of them coalesce into ONE launch per drain: the sync floor is
    paid once per pipeline slot per HOST, not per replica.

    ``policy`` installs a tenant-aware drain policy
    (:class:`~hyperdrive_tpu_torch.devsched.DeficitRoundRobin`) on the queue;
    the default keeps the digest-neutral FIFO drain. ``cert_keep``
    bounds per-tenant certificate retention: entries more than
    ``cert_keep`` heights below the tenant's committed-height watermark
    are retired on accept, so a long-running service stays O(tenants),
    not O(heights). ``remote_port()`` opens the cross-process submit
    path (:class:`ServicePort`).

    The service is deliberately mesh-agnostic: it batches the *launch
    schedule*, not the launch itself.
    """

    def __init__(self, verifier, queue=None, max_depth: int = 8,
                 obs=None, tracer=None, devtel=None, policy=None,
                 cert_keep=None, registry=None):
        from hyperdrive_tpu_torch.devsched import DeviceWorkQueue

        #: Optional metrics :class:`~hyperdrive_tpu_torch.obs.metrics.
        #: Registry` — the live metrics plane: when set, the remote
        #: port answers TAG_METRICS scrapes with its rendered
        #: Prometheus snapshot (admission-gated with the read path).
        self.registry = registry

        self.verifier = verifier
        self.queue = (
            queue
            if queue is not None
            else DeviceWorkQueue(max_depth=max_depth, obs=obs,
                                 tracer=tracer, devtel=devtel,
                                 policy=policy)
        )
        if devtel is not None:
            # An externally-built queue adopts the service's probe (the
            # same late-binding the sim applies to its queue).
            self.queue.devtel = devtel
        if policy is not None and self.queue.policy is None:
            self.queue.policy = policy
        self.obs = obs if obs is not None else self.queue.obs
        self._launcher = self.queue.verify_launcher(verifier)
        #: Commands submitted per tenant key (observability).
        self.tenants: dict = {}
        #: Tenant key -> small stable int track id (first-submit order):
        #: what the launch probe records as each command's origin, so
        #: journal events and registry labels agree on the tenant axis.
        #: Ids are never reused, even after :meth:`retire_tenant` — a
        #: revived tenant must not inherit a dead one's track.
        self.tenant_ids: dict = {}
        self._next_tid = 0
        #: tenant -> {height -> QuorumCertificate}: O(1) commit proofs
        #: accepted through :meth:`accept_certificate`. A proof that
        #: fails the certifier's check never lands here.
        self.certificates: dict = {}
        #: tenant -> highest committed height accepted (the retirement
        #: watermark; also the remote port's stale-height reference).
        self.watermarks: dict = {}
        self.cert_keep = None if cert_keep is None else int(cert_keep)
        self.retired_certs = 0
        #: tenant -> HostLedgerExecutor (see :meth:`attach_execution`).
        self.executors: dict = {}
        #: tenant -> {height -> 32-byte chained state root}.
        self.state_roots: dict = {}
        #: tenant -> :class:`~hyperdrive_tpu_torch.exec.ledger.ProofBasis`:
        #: the frozen snapshot proof queries answer from, refreshed in
        #: :meth:`accept_certificate` whenever the executor sits exactly
        #: at the certified height with no open speculation. Queries
        #: never touch the live executor — it may be speculated ahead
        #: of the last certificate by the time a query lands.
        self.proof_bases: dict = {}

    def _tenant_id(self, tenant) -> int:
        tid = self.tenant_ids.get(tenant)
        if tid is None:
            tid = self.tenant_ids[tenant] = self._next_tid
            self._next_tid += 1
        return tid

    def certifier(self, signatories, f, obs=None):
        """A :class:`~hyperdrive_tpu_torch.certificates.Certifier` for one
        tenant, transcript-bound to this service's shared launcher — its
        certificates commit to the coalesced launch that verified the
        quorum, whichever tenants co-submitted into it."""
        from hyperdrive_tpu_torch.certificates import Certifier

        return Certifier(
            signatories, f,
            transcript_source=lambda: self._launcher.last_transcript,
            obs=obs,
        )

    def attach_execution(self, tenant, config, genesis_stakes=()):
        """Give ``tenant`` a replicated ledger on this host: every
        certificate accepted for it advances a deterministic
        :class:`~hyperdrive_tpu_torch.exec.ledger.HostLedgerExecutor` and
        records the chained state root, so the O(1) certificate frame a
        shard gets back can vouch for ledger state, not just the
        committed value. The host executor is deliberate, as in the
        reference: the device executor derives the same roots, so the
        root is the same either route. Returns the executor (tests read
        ``roots`` off it directly)."""
        from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor

        ex = HostLedgerExecutor(config, genesis_stakes=genesis_stakes)
        self.executors[tenant] = ex
        self.state_roots[tenant] = {}
        return ex

    def speculate_height(self, tenant, height: int) -> bool:
        """Tenant windows ride the speculative pipeline: apply
        ``height``'s block at SUBMIT time under the exact unsigned
        guess, so by the time the quorum certificate lands,
        :meth:`accept_certificate`'s ``advance_to`` is a cached read —
        the window's verify latency and its block apply overlap instead
        of stacking. Exact speculation cannot mismatch (there is no
        guessed mask to be wrong), so the rollback machinery stays out
        of the serving path; signed-tx configs are excluded because
        their admission mask is only known after verification. Only the
        strictly-next height speculates — out-of-order or duplicate
        submits are a no-op (``advance_to`` still catches any gap).
        Returns True when the height was speculatively applied."""
        ex = self.executors.get(tenant)
        if (
            ex is None
            or ex.config.sign_txs
            or height != ex.height + 1
        ):
            return False
        ex.speculate(height, None)
        return True

    def accept_certificate(self, tenant, certifier, cert) -> bool:
        """Cross-tenant commit-proof exchange: re-verify ``cert`` in
        O(1) against ``certifier`` (quorum weight + binding; no
        signatures re-checked, no vote set re-gossiped) and register it
        under ``tenant`` on success. This replaces shipping the 2f+1
        precommits a remote shard would otherwise need to trust the
        commit."""
        from hyperdrive_tpu_torch.obs.devtel import NULL_DEVTEL

        devtel = self.queue.devtel
        t0 = devtel.now() if devtel is not NULL_DEVTEL else 0.0
        ok = certifier.verify(cert)
        if devtel is not NULL_DEVTEL:
            # Per-tenant commit latency: the O(1) proof re-check that
            # finalizes a remote shard's commit locally. Rejected proofs
            # land in their own histogram — a forged or stale cert must
            # not pollute the committed-path p95/p99.
            devtel.tenant_latency(
                self._tenant_id(tenant),
                devtel.now() - t0,
                "commit" if ok else "commit_rejected",
            )
        if not ok:
            return False
        certs = self.certificates.setdefault(tenant, {})
        certs[cert.height] = cert
        ex = self.executors.get(tenant)
        if ex is not None:
            # Pin the root the frame will carry. When the height rode
            # the speculative pipeline (speculate_height at submit),
            # this confirms-in-passing and reads the cached root; a gap
            # or a non-speculative tenant is caught up deterministically
            # from the block source.
            self.state_roots[tenant][cert.height] = ex.advance_to(
                cert.height
            )
            if ex.height == cert.height and not ex._spec:
                # Freeze the newly-certified height for proof serving.
                # When the executor already ran ahead (pipelined
                # speculation), the basis simply lags one certificate —
                # clients verify against the trusted root at the
                # proof's own height, so a lagging basis is still a
                # sound answer.
                self.proof_bases[tenant] = ex.proof_basis()
        wm = self.watermarks.get(tenant, 0)
        if cert.height > wm:
            wm = self.watermarks[tenant] = cert.height
        if self.cert_keep is not None:
            floor = wm - self.cert_keep
            if floor > 0:
                stale = [h for h in certs if h <= floor]
                for h in stale:
                    del certs[h]
                if stale:
                    self.retired_certs += len(stale)
                    if self.obs is not NULL_BOUND:
                        self.obs.emit(
                            "service.tenant.retire", wm,
                            self._tenant_id(tenant), len(stale),
                        )
        return True

    def retire_tenant(self, tenant) -> int:
        """Drop every table entry for a departed tenant; returns how
        many certificates were released. The tenant's track id is
        retired with it (never reused)."""
        released = len(self.certificates.pop(tenant, ()))
        self.tenants.pop(tenant, None)
        tid = self.tenant_ids.pop(tenant, None)
        self.watermarks.pop(tenant, None)
        self.proof_bases.pop(tenant, None)
        if released:
            self.retired_certs += released
        if tid is not None and self.obs is not NULL_BOUND:
            self.obs.emit("service.tenant.retire", -1, tid, released)
        return released

    def submit(self, tenant, items, generation: int = 0):
        """Enqueue one tenant's verify batch; returns its
        :class:`~hyperdrive_tpu_torch.devsched.DeviceFuture`. ``tenant`` is an
        opaque accounting key (replica id, shard id). ``generation``
        tags the batch with its epoch pubkey-table generation
        (epochs.py): tenants on different generations — mid-rotation,
        some tenants already switched — still share the queue, but
        their windows coalesce per generation, never into a mixed-key
        launch."""
        self.tenants[tenant] = self.tenants.get(tenant, 0) + 1
        tid = self._tenant_id(tenant)
        fut = self.queue.submit(
            self._launcher, items, generation,
            origin=tid, rows=len(items),
        )
        from hyperdrive_tpu_torch.obs.devtel import NULL_DEVTEL

        devtel = self.queue.devtel
        if devtel is not NULL_DEVTEL:
            # Per-tenant verify latency: submit -> resolution, on the
            # probe's (injectable) clock, into a labeled mergeable
            # histogram (tenant.verify.latency{label=<tid>}).
            t0 = devtel.now()

            def _observe(f, devtel=devtel, t0=t0, tid=tid):
                devtel.tenant_latency(tid, devtel.now() - t0, "verify")

            fut.add_done_callback(_observe)
        return fut

    def rotate(self, generation: int, table=None) -> None:
        """Propagate an epoch rotation to the shared verifier: installs
        ``table`` when the verifier holds resident state
        (:meth:`~hyperdrive_tpu_torch.ops.ed25519_wire.TorchWireVerifier.
        install_table` double-buffers it) and records the generation on
        transcript-binding verifiers. Tenants then pass ``generation``
        to :meth:`submit`; in-flight commands keep their old tag."""
        if table is not None and hasattr(self.verifier, "install_table"):
            self.verifier.install_table(table, generation)
        elif hasattr(self.verifier, "set_generation"):
            self.verifier.set_generation(generation)

    def flusher(self, validators, **kwargs):
        """A queue-backed :class:`~hyperdrive_tpu_torch.tallyflush.
        DeviceTallyFlusher` for one tenant replica. Every flusher built
        here shares this service's queue (and verifier), which is the
        whole point: co-located replicas' flush windows coalesce."""
        from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher

        return DeviceTallyFlusher(
            self.verifier, validators, queue=self.queue, **kwargs
        )

    def remote_port(self, host: str = "127.0.0.1", port: int = 0,
                    controller=None, obs=None, trace=None) -> "ServicePort":
        """Open the cross-process submit path: replicas in other
        processes connect a :class:`RemoteServiceClient` here and their
        windows coalesce into the same launches as local tenants'."""
        return ServicePort(
            self, host=host, port=port, controller=controller, obs=obs,
            trace=trace,
        )

    def drain(self) -> int:
        """Resolve every tenant's pending commands (one coalesced
        launch); the host event loop's idle hook."""
        return self.queue.drain()

    def close(self) -> int:
        return self.queue.close()


# ----------------------------------------------------------- tenant shard


class TenantShard:
    """One shard-consensus instance's drive loop against a service.

    Deliberately smaller than a full :class:`~hyperdrive_tpu_torch.harness.
    sim.Simulation`: the serving benchmark measures the VERIFY/COMMIT
    data path (window → coalesced launch → quorum → certificate), so the
    shard models exactly that — a deterministic committee
    (``KeyRing.deterministic`` under a per-tenant namespace) emitting
    one full precommit window per height. ``sign=False`` swaps real
    Ed25519 signatures for fixed nonzero bytes (the NullVerifier /
    chaos leg, crypto-free).

    ``commit_digest()`` is the cross-run equality handle: the same
    canonical fold the sim's ``SimulationResult.commit_digest`` uses,
    over this tenant's committed (height, value) pairs — shared-service
    vs per-tenant-queue vs remote-over-TCP runs must all agree on it.
    """

    def __init__(self, name: str, n_validators: int = 4, f=None,
                 target_height: int = 8, sign: bool = True,
                 time_fn=None, execution=None):
        self.name = str(name)
        #: Optional :class:`~hyperdrive_tpu_torch.exec.ExecutionConfig`:
        #: attach_local registers it with the service so committed
        #: certificate frames carry the tenant's chained state root.
        self.execution = execution
        self.ring = KeyRing.deterministic(
            n_validators, namespace=b"tenant/" + self.name.encode()
        )
        self.f = (n_validators - 1) // 3 if f is None else int(f)
        self.target_height = int(target_height)
        self.sign = bool(sign)
        self.time_fn = time_fn if time_fn is not None else time.perf_counter
        self.certifier = None
        self.service = None
        self.client = None
        self.generation = 0
        #: height -> committed value (32 bytes), in acceptance order.
        self.commits: dict = {}
        #: height -> 32-byte state root the committed frame carried
        #: (execution-attached tenants only).
        self.state_roots: dict = {}
        #: Per-commit submit->finalize latency (seconds on time_fn).
        self.commit_latencies: list = []
        self.rejected = 0
        self.shed_retries = 0
        self.next_height = 1
        self._inflight = 0

    # ---------------------------------------------------------- windows

    def value_at(self, height: int) -> bytes:
        return hashlib.sha256(
            f"{self.name}:{height}".encode()
        ).digest()

    def window(self, height: int) -> list:
        """The full committee's signed precommits for ``height``."""
        value = self.value_at(height)
        rows = []
        for kp in self.ring.pairs:
            pc = Precommit(
                height=height, round=0, value=value, sender=kp.public
            )
            rows.append(
                kp.sign_message(pc) if self.sign
                else pc.with_signature(b"\x01" * 64)
            )
        return rows

    @property
    def done(self) -> bool:
        return len(self.commits) >= self.target_height

    @property
    def inflight(self) -> int:
        return self._inflight

    def commit_digest(self) -> str:
        h = hashlib.sha256()
        for height in sorted(self.commits):
            h.update(int(height).to_bytes(8, "little"))
            h.update(self.commits[height])
        return h.hexdigest()

    # ------------------------------------------------------- local drive

    def attach_local(self, service: ShardVerifyService,
                     generation: int = 0) -> "TenantShard":
        self.service = service
        self.generation = int(generation)
        self.certifier = service.certifier(self.ring.signatories, self.f)
        if self.execution is not None:
            service.attach_execution(self.name, self.execution)
        return self

    def pump(self, max_inflight: int = 2) -> int:
        """Submit up to ``max_inflight`` outstanding height windows into
        the attached local service; commits finalize inside the queue's
        drain via done-callbacks. Returns how many windows were
        submitted. The caller owns the drain cadence (that IS the
        continuous-batching knob)."""
        submitted = 0
        while (
            self.next_height <= self.target_height
            and self._inflight < max_inflight
        ):
            height = self.next_height
            self.next_height += 1
            self._inflight += 1
            value = self.value_at(height)
            rows = self.window(height)
            items = [(pc.sender, pc.digest(), pc.signature) for pc in rows]
            t0 = self.time_fn()
            fut = self.service.submit(self.name, items, self.generation)
            # Execution-attached tenants ride the speculative pipeline:
            # the height's block applies now, overlapping the window's
            # verify, and the certificate accept reads the cached root.
            self.service.speculate_height(self.name, height)
            fut.add_done_callback(
                lambda f, height=height, value=value, rows=rows, t0=t0:
                self._finalize(f, height, value, rows, t0)
            )
            submitted += 1
        return submitted

    def _finalize(self, fut, height, value, rows, t0) -> None:
        self._inflight -= 1
        mask = fut.result()
        signers = [pc.sender for pc, ok in zip(rows, mask) if ok]
        if len(set(signers)) < 2 * self.f + 1:
            self.rejected += 1
            return
        cert = self.certifier.observe_commit(height, 0, value, signers)
        if self.service.accept_certificate(self.name, self.certifier, cert):
            self.commits[height] = value
            root = self.service.state_roots.get(self.name, {}).get(height)
            if root is not None:
                self.state_roots[height] = root
            self.commit_latencies.append(self.time_fn() - t0)
        else:
            self.rejected += 1

    # ------------------------------------------------------ remote drive

    def attach_remote(self, client: "RemoteServiceClient",
                      generation: int = 0) -> "TenantShard":
        """Bind to a service in ANOTHER process: introduces the
        committee over the wire, and builds a local certifier — its
        :meth:`~hyperdrive_tpu_torch.certificates.Certifier.verify` is fully
        self-contained (binding recomputation, no transcript state), so
        server-minted certificates finalize here in O(1)."""
        from hyperdrive_tpu_torch.certificates import Certifier

        self.client = client
        self.generation = int(generation)
        self.certifier = Certifier(self.ring.signatories, self.f)
        client.hello(self.name, self.ring.signatories, self.f)
        return self

    @staticmethod
    def verify_balance(proof, trusted_root: bytes) -> bool:
        """The light-client check: does ``proof`` bind its (account,
        balance, stake) leaf into ``trusted_root`` — a chained state
        root this shard already holds from its own certificate chain?
        Pure recomputation (ops/merkle.py ``verify_inclusion``); the
        serving replica is trusted for nothing."""
        from hyperdrive_tpu_torch.ops.merkle import verify_inclusion

        return verify_inclusion(
            trusted_root, proof.account, proof.balance, proof.stake,
            proof,
        )

    def run_remote(self, max_inflight: int = 4, timeout: float = 30.0,
                   max_shed_retries: int = 1024) -> None:
        """Drive every height through the attached client. Keeps
        ``max_inflight`` windows on the wire so the serving host can
        coalesce them with other tenants' work; a shed (busy) answer
        re-submits the same height — backpressure is flow control here,
        never data loss."""
        pending: dict = {}
        while not self.done:
            while (
                self.next_height <= self.target_height
                and len(pending) < max_inflight
            ):
                height = self.next_height
                self.next_height += 1
                pending[height] = self._remote_submit(height)
            if not pending:
                break
            height = min(pending)
            fut, value, t0 = pending.pop(height)
            status, mask, cert = fut.result(timeout)
            if status == STATUS_SHED:
                self.shed_retries += 1
                if self.shed_retries > max_shed_retries:
                    raise RuntimeError(
                        f"tenant {self.name}: height {height} shed "
                        f"{max_shed_retries} times"
                    )
                pending[height] = self._remote_submit(height)
                continue
            if (
                status == STATUS_COMMITTED
                and cert is not None
                and cert.height == height
                and self.certifier.verify(cert)
            ):
                self.commits[height] = value
                if fut.root is not None:
                    self.state_roots[height] = fut.root
                self.commit_latencies.append(self.time_fn() - t0)
            else:
                self.rejected += 1

    def _remote_submit(self, height: int):
        value = self.value_at(height)
        rows = self.window(height)
        t0 = self.time_fn()
        fut = self.client.submit(
            height, 0, value, rows, generation=self.generation
        )
        return (fut, value, t0)


# ------------------------------------------------------------ server port


class _RemoteConn:
    """One accepted connection's state: socket, bounded sender queue,
    and — after HELLO — the tenant identity, its certifier, and its
    admission gate."""

    __slots__ = (
        "sock", "outbox", "tenant", "f", "certifier", "gate",
        "send_drops", "closed",
    )

    def __init__(self, sock):
        self.sock = sock
        self.outbox = queue_mod.Queue(maxsize=4096)
        self.tenant = None
        self.f = 0
        self.certifier = None
        self.gate = None
        self.send_drops = 0
        self.closed = False


class ServicePort:
    """The cross-process submit path of one :class:`ShardVerifyService`.

    Socket I/O runs on daemon threads (an accept loop plus one
    reader/sender pair per connection — the transport.py shape), but
    every decision touches the service on the owner's drive loop:
    readers park decoded requests in an inbox, and :meth:`pump` —
    called from the same thread that drains the queue — admits,
    submits, and resolves. The queue's single-writer discipline is
    preserved by construction.

    Admission reuses the ``load/`` doctrine verbatim: a
    :class:`~hyperdrive_tpu_torch.load.backpressure.BackpressureController`
    watching the shared queue sets the level, and each tenant's
    :class:`~hyperdrive_tpu_torch.load.backpressure.AdmissionGate` sheds
    duplicate/stale precommit rows at SHED_DUPLICATES and above (the
    gate's ``height_fn`` is the tenant's committed watermark, so replays
    of finalized heights classify stale). At CRITICAL_ONLY the port
    answers ``STATUS_SHED`` without touching the queue — the client
    retries, so overload is flow control, not loss.
    """

    def __init__(self, service: ShardVerifyService,
                 host: str = "127.0.0.1", port: int = 0,
                 controller=None, obs=None, trace=None):
        from hyperdrive_tpu_torch.load.backpressure import BackpressureController

        self.service = service
        self.obs = obs if obs is not None else service.obs
        #: Optional :class:`~hyperdrive_tpu_torch.obs.tracectx.TraceSource`:
        #: when set, every answer frame carries a causal stamp and the
        #: hello-ack advertises this origin id for offset estimation.
        #: Inbound stamped requests are stripped + marked ``trace.recv``
        #: regardless (stamp recognition costs one byte compare).
        self.trace = trace
        if controller is None:
            controller = BackpressureController()
            controller.watch(service.queue)
        self.controller = controller
        self._inbox: queue_mod.Queue = queue_mod.Queue()
        self._conns: list = []
        self._lock = threading.Lock()
        self._closed = False
        #: Remote windows submitted into the queue and not yet resolved.
        self.inflight = 0
        #: Lifetime counters (tests / the serve report).
        self.remote_submits = 0
        self.remote_resolves = 0
        self.remote_sheds = 0
        self.remote_queries = 0
        self.query_sheds = 0
        self.metrics_serves = 0
        self.metrics_sheds = 0
        self.bad_frames = 0
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        self._srv = srv
        self.address = srv.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="svcport-accept", daemon=True
        )
        self._accept_thread.start()

    # --------------------------------------------------------- io threads

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _RemoteConn(sock)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._read_loop, args=(conn,),
                name="svcport-read", daemon=True,
            ).start()
            threading.Thread(
                target=self._send_loop, args=(conn,),
                name="svcport-send", daemon=True,
            ).start()

    def _read_loop(self, conn: _RemoteConn) -> None:
        sock = conn.sock
        try:
            while True:
                header = _recv_exact(sock, _LEN.size)
                if header is None:
                    return
                (n,) = _LEN.unpack(header)
                if n > _MAX_FRAME:
                    return
                payload = _recv_exact(sock, n)
                if payload is None:
                    return
                self._inbox.put((conn, payload))
        except OSError:
            return
        finally:
            conn.closed = True

    def _send_loop(self, conn: _RemoteConn) -> None:
        while True:
            frame = conn.outbox.get()
            if frame is None:
                return
            try:
                conn.sock.sendall(frame)
            except OSError:
                conn.closed = True
                return

    def _send(self, conn: _RemoteConn, payload: bytes) -> None:
        if self.trace is not None:
            payload = self.trace.stamp(payload)
        try:
            conn.outbox.put_nowait(_LEN.pack(len(payload)) + payload)
        except queue_mod.Full:
            conn.send_drops += 1

    # -------------------------------------------------------- drive loop

    def pump(self, max_requests: int = 64) -> int:
        """Process up to ``max_requests`` parked requests on the
        caller's (drive-loop) thread. Submitted windows resolve at the
        next queue drain, whose done-callbacks send the certificate
        frames back. Returns how many requests were handled."""
        handled = 0
        while handled < max_requests:
            try:
                conn, payload = self._inbox.get_nowait()
            except queue_mod.Empty:
                break
            handled += 1
            try:
                ctx = None
                if payload and payload[0] == TRACE_MAGIC:
                    ctx, payload = split_trace_frame(payload)
                req = decode_request(payload)
            except SerdeError:
                self.bad_frames += 1
                continue
            if ctx is not None and self.obs is not NULL_BOUND:
                note_trace_recv(
                    self.obs, ctx,
                    req[2] if req[0] == "submit" else -1,
                )
            if req[0] == "hello":
                self._handle_hello(conn, *req[1:])
            elif req[0] == "query":
                self._handle_query(conn, *req[1:])
            elif req[0] == "metrics":
                self._handle_metrics(conn, *req[1:])
            else:
                self._handle_submit(conn, *req[1:])
        return handled

    def _handle_hello(self, conn, name, f, signatories,
                      t0: float = 0.0) -> None:
        from hyperdrive_tpu_torch.load.backpressure import AdmissionGate

        conn.tenant = name
        conn.f = int(f)
        # The port's obs handle rides into the certifier so cert.emit
        # marks land in the journal at the minted height — the
        # critical-path report's "cert" milestone.
        conn.certifier = self.service.certifier(
            signatories, f, obs=self.obs
        )
        watermarks = self.service.watermarks
        conn.gate = AdmissionGate(
            self.controller,
            height_fn=lambda name=name: watermarks.get(name, 0) + 1,
        )
        # Echo handshake: hand back the client's send stamp plus our
        # own wall-clock so it can place this process on its offset
        # graph. Answered for every hello — a pre-echo client's read
        # loop drops the unexpected frame as a typed decode miss.
        origin = self.trace.origin if self.trace is not None else 0
        self._send(
            conn, encode_hello_ack(t0, time.time(), origin)
        )

    def _handle_metrics(self, conn, req_id) -> None:
        """One TAG_METRICS request → ONE Prometheus-text frame (or a
        status-only refusal). Scrapes ride the tenant's admission gate
        classed WITH proof queries: at SHED_LOW_PRIORITY and above the
        port answers STATUS_SHED without rendering anything — the
        observability plane is the first load shed, never a reason
        consensus traffic queues."""
        from hyperdrive_tpu_torch.load.frames import MetricsFrame

        if conn.tenant is None:
            self._send(
                conn,
                encode_metrics_reply(req_id, STATUS_UNKNOWN_TENANT),
            )
            return
        self.controller.poll()
        if not conn.gate.admit(MetricsFrame(), peer=conn.tenant):
            self.metrics_sheds += 1
            if self.obs is not NULL_BOUND:
                self.obs.emit("metrics.shed", -1, -1, conn.tenant)
            self._send(conn, encode_metrics_reply(req_id, STATUS_SHED))
            return
        registry = self.service.registry
        if registry is None:
            self._send(
                conn, encode_metrics_reply(req_id, STATUS_NO_STATE)
            )
            return
        from hyperdrive_tpu_torch.obs.metrics import to_prometheus

        # Refresh the service-posture gauges at scrape time so every
        # answer reflects live state (a pull-model scrape, not a stale
        # copy). Commit latency lands in the registry on each resolve.
        registry.set_gauge("service.queue.depth",
                           self.service.queue.depth)
        registry.set_gauge("service.queue.launches",
                           self.service.queue.launches)
        registry.set_gauge("service.queue.coalesced",
                           self.service.queue.coalesced)
        registry.set_gauge("service.remote.submits", self.remote_submits)
        registry.set_gauge("service.remote.resolves",
                           self.remote_resolves)
        registry.set_gauge("service.remote.sheds", self.remote_sheds)
        registry.set_gauge("service.metrics.serves", self.metrics_serves)
        registry.set_gauge("service.metrics.sheds", self.metrics_sheds)
        text = to_prometheus(registry.snapshot())
        self.metrics_serves += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit("metrics.serve", -1, -1, len(text))
        self._send(
            conn, encode_metrics_reply(req_id, STATUS_COMMITTED, text)
        )

    def _handle_query(self, conn, req_id, account) -> None:
        """One TAG_QUERY request → ONE proof frame (or a status-only
        refusal). Queries ride the tenant's admission gate as the
        ``query`` shed class: at SHED_LOW_PRIORITY and above the port
        answers STATUS_SHED without touching any ledger state, so a
        read storm degrades reads first and never queues ahead of
        certificates. Serving itself reads the frozen
        :class:`~hyperdrive_tpu_torch.exec.ledger.ProofBasis` — O(log n)
        numpy indexing, no executor locks, no speculation hazard."""
        from hyperdrive_tpu_torch.load.frames import QueryFrame

        if conn.tenant is None:
            self._send(conn, encode_proof(req_id, STATUS_UNKNOWN_TENANT))
            return
        self.controller.poll()
        if not conn.gate.admit(QueryFrame(account=account),
                               peer=conn.tenant):
            self.query_sheds += 1
            if self.obs is not NULL_BOUND:
                self.obs.emit("proof.shed", -1, -1, conn.tenant)
            self._send(conn, encode_proof(req_id, STATUS_SHED))
            return
        basis = self.service.proof_bases.get(conn.tenant)
        if basis is None or not 0 <= account < basis.accounts:
            self._send(conn, encode_proof(req_id, STATUS_NO_STATE))
            return
        payload = encode_proof(
            req_id, STATUS_COMMITTED, basis.prove(account)
        )
        self.remote_queries += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "proof.serve", basis.height, -1,
                "account=%d bytes=%d" % (account, len(payload)),
            )
        self._send(conn, payload)

    def _handle_submit(self, conn, req_id, height, rnd, value,
                       generation, rows) -> None:
        from hyperdrive_tpu_torch.load.backpressure import CRITICAL_ONLY

        if conn.tenant is None:
            self._send(
                conn,
                encode_result(req_id, STATUS_UNKNOWN_TENANT, len(rows), ()),
            )
            return
        if self.controller.poll() >= CRITICAL_ONLY:
            # Panic level: answer busy without touching the queue. The
            # client re-submits — certificates/windows are never lost,
            # merely deferred (the load/ doctrine's never-drop-quorum
            # rule, expressed as flow control).
            self.remote_sheds += 1
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "service.remote.shed", height, rnd, conn.tenant
                )
            self._send(
                conn, encode_result(req_id, STATUS_SHED, len(rows), ())
            )
            return
        precommits = [
            Precommit(
                height=height, round=rnd, value=value, sender=sender,
                signature=sig,
            )
            for sender, sig in rows
        ]
        admitted_idx = [
            i for i, pc in enumerate(precommits)
            if conn.gate.admit(pc, peer=conn.tenant)
        ]
        if rows and not admitted_idx:
            # Every row shed (duplicate window / stale height): busy-
            # answer so the client backs off and retries or moves on.
            self.remote_sheds += 1
            if self.obs is not NULL_BOUND:
                self.obs.emit(
                    "service.remote.shed", height, rnd, conn.tenant
                )
            self._send(
                conn, encode_result(req_id, STATUS_SHED, len(rows), ())
            )
            return
        items = [
            (precommits[i].sender, precommits[i].digest(),
             precommits[i].signature)
            for i in admitted_idx
        ]
        self.remote_submits += 1
        self.inflight += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "service.remote.submit", height, rnd, len(items)
            )
        t_sub = time.time()
        fut = self.service.submit(conn.tenant, items, generation)
        fut.add_done_callback(
            lambda f, conn=conn, req_id=req_id, height=height, rnd=rnd,
            value=value, rows=rows, admitted_idx=admitted_idx,
            t_sub=t_sub:
            self._resolve(
                f, conn, req_id, height, rnd, value, rows, admitted_idx,
                t_sub,
            )
        )

    def _resolve(self, fut, conn, req_id, height, rnd, value, rows,
                 admitted_idx, t_sub=None) -> None:
        """Queue-drain callback: fold the launch verdict back into a
        full-window mask, mint the certificate if the quorum stands,
        and answer with ONE O(1) certificate frame — never the 2f+1
        signatures."""
        self.inflight -= 1
        verdict = [] if fut.cancelled() else fut.result()
        mask = [False] * len(rows)
        for i, ok in zip(admitted_idx, verdict):
            mask[i] = bool(ok)
        signers = [rows[i][0] for i in range(len(rows)) if mask[i]]
        status = STATUS_NO_QUORUM
        cert = None
        if len(set(signers)) >= 2 * conn.f + 1:
            cert = conn.certifier.observe_commit(height, rnd, value, signers)
            if self.service.accept_certificate(
                conn.tenant, conn.certifier, cert
            ):
                status = STATUS_COMMITTED
            else:
                cert = None
        self.remote_resolves += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "service.remote.resolve", height, rnd,
                STATUS_NAMES[status],
            )
        # The finality-SLO source: per-tenant submit→certificate wall
        # time, same histogram name the device-telemetry leg uses so
        # slo.evaluate_slos reads one series either way.
        registry = self.service.registry
        if (registry is not None and t_sub is not None
                and status == STATUS_COMMITTED):
            registry.observe(
                "tenant.commit.latency", time.time() - t_sub,
                label=conn.tenant,
            )
        root = None
        if status == STATUS_COMMITTED:
            root = self.service.state_roots.get(
                conn.tenant, {}
            ).get(height)
        self._send(
            conn,
            encode_result(req_id, status, len(rows), mask, cert,
                          root=root),
        )

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.outbox.put_nowait(None)
            except queue_mod.Full:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass


# ----------------------------------------------------------- client side


class RemoteFuture:
    """Resolution handle for one remote window: a thread event the
    client's reader sets when the certificate frame lands."""

    __slots__ = ("_event", "status", "mask", "cert", "root", "proof",
                 "text")

    def __init__(self):
        self._event = threading.Event()
        self.status = None
        self.mask = None
        self.cert = None
        #: 32-byte chained state root the committed frame carried, or
        #: None (execution-attached tenants only). Deliberately outside
        #: :meth:`result`'s tuple so root-less deployments keep their
        #: 3-tuple unpack.
        self.root = None
        #: :class:`~hyperdrive_tpu_torch.ops.merkle.MerkleProof` for a
        #: TAG_QUERY request (None on submit futures and refusals).
        self.proof = None
        #: Prometheus exposition text for a TAG_METRICS request (None
        #: on every other future and on refusals).
        self.text = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float = 30.0):
        """``(status, mask, cert_or_None)``; raises TimeoutError if the
        serving host never answers (a closed port fails loudly, it does
        not hang the tenant forever)."""
        if not self._event.wait(timeout):
            raise TimeoutError("remote verify window timed out")
        return self.status, self.mask, self.cert

    def proof_result(self, timeout: float = 30.0):
        """``(status, proof_or_None)`` for a TAG_QUERY request."""
        if not self._event.wait(timeout):
            raise TimeoutError("remote proof query timed out")
        return self.status, self.proof

    def metrics_result(self, timeout: float = 30.0):
        """``(status, text_or_None)`` for a TAG_METRICS request."""
        if not self._event.wait(timeout):
            raise TimeoutError("remote metrics scrape timed out")
        return self.status, self.text


class RemoteServiceClient:
    """One remote tenant's connection to a :class:`ServicePort`.

    ``submit`` is async (returns a :class:`RemoteFuture`); a daemon
    reader thread resolves futures as result frames arrive, so a tenant
    can keep several windows on the wire — which is exactly what lets
    the serving host coalesce them with other tenants' work."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 obs=None, trace=None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        #: Flight-recorder handle for ``trace.recv`` / ``trace.offset``
        #: marks (the reader thread emits, so bind a threadsafe
        #: Recorder) and :class:`~hyperdrive_tpu_torch.obs.tracectx.
        #: TraceSource` for stamping outbound requests.
        self.obs = obs if obs is not None else NULL_BOUND
        self.trace = trace
        #: server trace-origin id -> estimated clock offset (seconds,
        #: ``server_clock - local_clock``) from the hello-ack echo.
        self.clock_offsets: dict = {}
        self._send_lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._pending: dict = {}
        self._next_req = 1
        self._reader = threading.Thread(
            target=self._read_loop, name="svcclient-read", daemon=True
        )
        self._reader.start()

    def hello(self, name: str, signatories, f: int) -> None:
        self._send(encode_hello(name, signatories, f, t0=time.time()))

    def submit(self, height: int, round: int, value: bytes, rows,
               generation: int = 0) -> RemoteFuture:
        fut = RemoteFuture()
        with self._pending_lock:
            req_id = self._next_req
            self._next_req += 1
            self._pending[req_id] = fut
        self._send(
            encode_submit(req_id, height, round, value, rows, generation)
        )
        return fut

    def query(self, account: int) -> RemoteFuture:
        """Request an O(log n) inclusion proof for ``account`` at the
        tenant's latest certified height. Resolve with
        :meth:`RemoteFuture.proof_result`; STATUS_SHED / STATUS_NO_STATE
        answers are retryable, exactly like shed submits."""
        fut = RemoteFuture()
        with self._pending_lock:
            req_id = self._next_req
            self._next_req += 1
            self._pending[req_id] = fut
        self._send(encode_query(req_id, account))
        return fut

    def metrics(self) -> RemoteFuture:
        """Scrape the serving host's metrics Registry: one TAG_METRICS
        request → the rendered Prometheus snapshot. Resolve with
        :meth:`RemoteFuture.metrics_result`; STATUS_SHED answers are
        retryable — and by doctrine the FIRST thing shed under load."""
        fut = RemoteFuture()
        with self._pending_lock:
            req_id = self._next_req
            self._next_req += 1
            self._pending[req_id] = fut
        self._send(encode_metrics_request(req_id))
        return fut

    def _send(self, payload: bytes) -> None:
        if self.trace is not None:
            payload = self.trace.stamp(payload)
        frame = _LEN.pack(len(payload)) + payload
        with self._send_lock:
            self.sock.sendall(frame)

    def _read_loop(self) -> None:
        try:
            while True:
                header = _recv_exact(self.sock, _LEN.size)
                if header is None:
                    return
                (n,) = _LEN.unpack(header)
                if n > _MAX_FRAME:
                    return
                payload = _recv_exact(self.sock, n)
                if payload is None:
                    return
                try:
                    if payload and payload[0] == TRACE_MAGIC:
                        ctx, payload = split_trace_frame(payload)
                        if self.obs is not NULL_BOUND:
                            note_trace_recv(self.obs, ctx)
                    text = None
                    if payload and payload[0] == TAG_QUERY:
                        req_id, status, proof = decode_proof(payload)
                        mask = cert = root = None
                    elif payload and payload[0] == TAG_HELLO:
                        self._note_offset(*decode_hello_ack(payload))
                        continue
                    elif payload and payload[0] == TAG_METRICS:
                        req_id, status, text = decode_metrics_reply(
                            payload
                        )
                        mask = cert = root = proof = None
                    else:
                        req_id, status, mask, cert, root = decode_result(
                            payload
                        )
                        proof = None
                except SerdeError:
                    continue
                with self._pending_lock:
                    fut = self._pending.pop(req_id, None)
                if fut is not None:
                    fut.status = status
                    fut.mask = mask
                    fut.cert = cert
                    fut.root = root
                    fut.proof = proof
                    fut.text = text
                    fut._event.set()
        except OSError:
            return

    def _note_offset(self, t0: float, t1: float, origin: int) -> None:
        """Fold one hello-ack echo into the offset table: NTP-style,
        ``offset ≈ t1 - (t0 + t3) / 2`` — the server's receive stamp
        against the midpoint of the round trip. A pre-echo server (t0
        never stamped) or an untraced port (origin 0) contributes
        nothing."""
        if not t0 or not origin:
            return
        t3 = time.time()
        offset = t1 - (t0 + t3) / 2.0
        self.clock_offsets[origin] = offset
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "trace.offset", -1, -1, f"{origin}:{offset:.6f}"
            )

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
