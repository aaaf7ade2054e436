"""Aggregate quorum certificates: constant-size commit proofs.

Once 2f+1 precommits for a value have been verified, re-gossiping those
2f+1 signatures (64 bytes each — ~11 KB at n=256) to prove the commit is
waste: the quorum is a fact the verifier already established in one
batched launch. A :class:`QuorumCertificate` compresses the proof to a
constant-size record — height, round, value digest, signer bitmap, and a
binding to the batch-verification transcript that established the quorum
— that the settle path and
:class:`~hyperdrive_tpu_torch.tallyflush.DeviceTallyFlusher` carry and
re-verify in O(1).

Trust model — two tiers. The *binding* is an integrity commitment, not
an aggregate signature: it proves the certificate's fields are exactly
what the emitting replica committed after its verifier's batched launch
accepted the 2f+1 precommits (the RLC transcript digest from
``TorchBatchVerifier.last_transcript`` rides inside it). Tampering with
any field breaks the binding, but trusting it means trusting the emitting
seam. The optional **BLS aggregate signature** (``agg_sig``, 48 bytes
compressed G1) drops that residual trust: each counted signer's BLS
partial over the canonical commit message (:func:`bls_commit_message`) is
aggregated — on the card by the ``g1_aggregate`` kernel
(:func:`~hyperdrive_tpu_torch.ops.g1.aggregate_points`), or on the host —
and a light client holding only the committee's public keys re-verifies
the quorum with :func:`verify_bls_certificate`: one pairing product, no
transcript trust, no vote-set gossip.

Wire format (codec.py, canonical):

    u64 height | u32 round | bytes32 value_digest |
    raw bitmap (u32 length prefix) | bytes32 transcript | bytes32 binding |
    raw agg_sig (empty or 48 B)

116 bytes + n/8 for the signer bitmap (+48 when the BLS aggregate rides
along): 148/196 B at n=256.

Port copy of the JAX package's ``certificates.py``, byte for byte on the
wire, in the binding and in the aggregate signature, with the recorder
(``obs``) and its ``cert.emit``/``cert.verify``/``bls.cert.agg`` events,
and the codec's ``cert.quorum`` wire registration.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.crypto import bls
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = [
    "QuorumCertificate",
    "Certifier",
    "marshal_certificate",
    "unmarshal_certificate",
    "certificate_size",
    "bls_commit_message",
    "verify_bls_certificate",
]

#: Domain separator for the binding hash (versioned: a format change must
#: not collide with old bindings). Certificates without a BLS aggregate
#: keep the v1 tag; the aggregate-carrying form commits to the extra field
#: under its own tag.
_BINDING_TAG = b"hd-qc-v1"
_BINDING_TAG_BLS = b"hd-qc-v2-bls"

#: Domain separator for the message BLS partials sign: only (height,
#: round, value_digest), so a light client can recompute it from the
#: certificate alone.
_BLS_MSG_TAG = b"hd-bls-commit-v1"


def bls_commit_message(height: int, round: int, value_digest: bytes) -> bytes:
    """The canonical byte string a committee member BLS-signs to endorse
    one committed (height, round, value). Same-message across the
    committee, which is what makes rogue-key-safe *same-message*
    aggregation applicable (every signer is a whitelisted identity with
    a deterministically derived key)."""
    return (
        _BLS_MSG_TAG
        + int(height).to_bytes(8, "little")
        + int(round).to_bytes(4, "little")
        + bytes(value_digest)
    )


@dataclass(frozen=True)
class QuorumCertificate:
    """One committed (height, round, value) plus the quorum that proved it.

    ``value_digest`` is sha256 of the committed value. ``signers`` is the
    bitmap of precommit signatories in whitelist order; ``transcript``
    binds the batch-verification launch that established the quorum
    (b"" * 32 when the verifier exposes none). ``binding`` commits to
    every other field; :meth:`Certifier.verify` recomputes it.
    """

    height: int
    round: int
    value_digest: bytes
    signers: bytes
    transcript: bytes
    binding: bytes
    #: Compressed BLS12-381 G1 aggregate signature over
    #: :func:`bls_commit_message` (48 bytes), or b"" on the
    #: transcript-bound-only path.
    agg_sig: bytes = b""

    def signer_count(self) -> int:
        return sum(bin(b).count("1") for b in self.signers)


def _binding(height, round, value_digest, signers, transcript,
             agg_sig: bytes = b"") -> bytes:
    h = hashlib.sha256()
    if agg_sig:
        h.update(_BINDING_TAG_BLS)
    else:
        h.update(_BINDING_TAG)
    h.update(int(height).to_bytes(8, "little"))
    h.update(int(round).to_bytes(4, "little"))
    h.update(value_digest)
    h.update(len(signers).to_bytes(2, "little"))
    h.update(signers)
    h.update(transcript)
    if agg_sig:
        h.update(agg_sig)
    return h.digest()


@wire_codec(tag="cert.quorum", max_bytes=8192)
def marshal_certificate(cert: QuorumCertificate, w: Writer) -> None:
    w.u64(cert.height)
    w.u32(cert.round)
    w.bytes32(cert.value_digest)
    w.raw(cert.signers)
    w.bytes32(cert.transcript)
    w.bytes32(cert.binding)
    w.raw(cert.agg_sig)


@wire_codec(tag="cert.quorum", max_bytes=8192)
def unmarshal_certificate(r: Reader) -> QuorumCertificate:
    height = r.u64()
    rnd = r.u32()
    value_digest = r.bytes32()
    signers = r.raw()
    if len(signers) > 4096:
        raise SerdeError(f"signer bitmap too wide: {len(signers)} bytes")
    transcript = r.bytes32()
    binding = r.bytes32()
    agg_sig = r.raw()
    if len(agg_sig) not in (0, 48):
        raise SerdeError(f"bad aggregate signature length: {len(agg_sig)}")
    return QuorumCertificate(
        height=height,
        round=rnd,
        value_digest=value_digest,
        signers=signers,
        transcript=transcript,
        binding=binding,
        agg_sig=agg_sig,
    )


def certificate_size(n_validators: int, with_bls: bool = False) -> int:
    """Marshalled bytes for an n-validator certificate. ``with_bls`` adds
    the 48-byte aggregate-signature field the BLS path carries."""
    w = Writer()
    marshal_certificate(
        QuorumCertificate(
            height=0,
            round=0,
            value_digest=bytes(32),
            signers=bytes(-(-n_validators // 8)),
            transcript=bytes(32),
            binding=bytes(32),
            agg_sig=bytes(48) if with_bls else b"",
        ),
        w,
    )
    return len(w.data())


def verify_bls_certificate(cert: QuorumCertificate, pubkeys,
                           quorum: "int | None" = None) -> bool:
    """Light-client verification: accept the certificate on the strength
    of its BLS aggregate alone — no transcript, no binding, no trust in
    the emitting replica.

    ``pubkeys``: the committee's G2 public keys in whitelist order, as
    96-byte compressed blobs or affine Fp2 pairs. The signer bitmap
    selects which keys participate; ``quorum`` (default: reject nothing
    on weight — pass 2f+1 to enforce) gates the signer count. One
    pairing product regardless of committee size."""
    if len(cert.agg_sig) != 48 or len(cert.value_digest) != 32:
        return False
    if len(cert.signers) != -(-len(pubkeys) // 8):
        return False
    if quorum is not None and cert.signer_count() < quorum:
        return False
    try:
        sig = bls.g1_decompress(cert.agg_sig)
    except Exception:
        return False
    selected = []
    for i, pk in enumerate(pubkeys):
        if not cert.signers[i >> 3] >> (i & 7) & 1:
            continue
        if isinstance(pk, (bytes, bytearray)):
            try:
                pk = bls.g2_decompress(bytes(pk))
            except Exception:
                return False
        selected.append(pk)
    # Trailing bits past the committee width must be clear.
    for i in range(len(pubkeys), 8 * len(cert.signers)):
        if cert.signers[i >> 3] >> (i & 7) & 1:
            return False
    if not selected:
        return False
    msg = bls_commit_message(cert.height, cert.round, cert.value_digest)
    return bls.verify_aggregate_same_message(selected, msg, sig)


class Certifier:
    """Per-replica certificate emitter + O(1) re-verifier.

    Plugs into the :class:`~hyperdrive_tpu_torch.process.Process` commit
    seam: when L49 fires with 2f+1 precommits, the process hands over the
    signer set and the certifier mints the certificate, binding the
    verifier's last batch transcript (``transcript_source``: a callable
    returning bytes — e.g. ``lambda: verifier.last_transcript`` — or None
    for transcript-less paths). Emitted certificates are kept per height
    (``certs``) and surfaced through the ``cert.emit`` / ``cert.verify``
    obs events.
    """

    def __init__(self, signatories, f: int, transcript_source=None,
                 obs=None, bls_keyring=None, bls_aggregate_fn=None):
        self.signatories = list(signatories)
        self._pos = {s: i for i, s in enumerate(self.signatories)}
        self.f = int(f)
        self.transcript_source = transcript_source
        self.obs = obs if obs is not None else NULL_BOUND
        #: Optional BLS committee keyring: signatory identity ->
        #: :class:`~hyperdrive_tpu_torch.crypto.bls.BlsKeyPair`. When set,
        #: emitted certificates carry the 48-byte aggregate signature.
        #: (Harness shortcut: partials that would ride on precommit
        #: messages in a deployment are computed here from the shared
        #: deterministic keyring — same bytes either way.)
        self.bls_keyring = bls_keyring
        #: Aggregation backend: callable(list of affine G1 partials) ->
        #: affine G1 aggregate. Defaults to the host fold; the sim
        #: injects the ``g1_aggregate`` kernel here.
        self._bls_aggregate_fn = bls_aggregate_fn
        #: height -> QuorumCertificate, in emission order.
        self.certs: dict = {}
        #: Verification outcomes.
        self.verified = 0
        self.rejected = 0

    def bls_pubkeys(self):
        """The committee's compressed G2 public keys in whitelist order
        (what a light client needs for :func:`verify_bls_certificate`),
        or None when no keyring is installed."""
        if self.bls_keyring is None:
            return None
        return [self.bls_keyring[s].pk_bytes for s in self.signatories]

    # ------------------------------------------------------------- emission

    def observe_commit(self, height, round, value, signers):
        """Mint the certificate for one committed (height, round, value).

        ``signers``: the precommit signatories counted toward the 2f+1
        quorum (whitelist members; unknown signatories are ignored —
        they were never counted by the grid either)."""
        bitmap = bytearray(-(-len(self.signatories) // 8))
        for s in signers:
            i = self._pos.get(s)
            if i is not None:
                bitmap[i >> 3] |= 1 << (i & 7)
        transcript = b""
        if self.transcript_source is not None:
            transcript = self.transcript_source() or b""
        if len(transcript) != 32:
            transcript = hashlib.sha256(transcript).digest() if transcript \
                else bytes(32)
        value_digest = hashlib.sha256(value).digest()
        signers_b = bytes(bitmap)
        agg_sig = self._bls_aggregate(height, round, value_digest, signers_b)
        cert = QuorumCertificate(
            height=int(height),
            round=int(round),
            value_digest=value_digest,
            signers=signers_b,
            transcript=transcript,
            binding=_binding(
                height, round, value_digest, signers_b, transcript, agg_sig
            ),
            agg_sig=agg_sig,
        )
        self.certs[int(height)] = cert
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "cert.emit", int(height), int(round),
                cert.value_digest.hex()[:16],
            )
        return cert

    def _bls_aggregate(self, height, round, value_digest,
                       signers_b: bytes) -> bytes:
        """Aggregate the counted signers' BLS partials over the commit
        message. Returns the 48-byte compressed aggregate, or b"" when
        no keyring is installed or a counted signer has no key (an
        aggregate that disagrees with the bitmap would be worse than
        none)."""
        if self.bls_keyring is None:
            return b""
        counted = []
        for i, s in enumerate(self.signatories):
            if signers_b[i >> 3] >> (i & 7) & 1:
                kp = self.bls_keyring.get(s)
                if kp is None:
                    return b""
                counted.append(kp)
        if not counted:
            return b""
        msg = bls_commit_message(height, round, value_digest)
        partials = [kp.sign(msg) for kp in counted]
        if self._bls_aggregate_fn is not None:
            agg = self._bls_aggregate_fn(partials)
        else:
            agg = bls.aggregate_signatures(partials)
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "bls.cert.agg", int(height), len(partials),
                "device" if self._bls_aggregate_fn is not None else "host",
            )
        return bls.g1_compress(agg)

    # ----------------------------------------------------------- re-verify

    def verify(self, cert: QuorumCertificate) -> bool:
        """O(1) acceptance: quorum weight, bitmap width, and binding
        integrity — no signature is re-checked and no vote set is
        re-gossiped. Emits ``cert.verify`` with the outcome."""
        ok = (
            len(cert.signers) == -(-len(self.signatories) // 8)
            and cert.signer_count() >= 2 * self.f + 1
            and len(cert.value_digest) == 32
            and cert.binding
            == _binding(
                cert.height, cert.round, cert.value_digest, cert.signers,
                cert.transcript, cert.agg_sig,
            )
        )
        if ok:
            self.verified += 1
        else:
            self.rejected += 1
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "cert.verify", cert.height, cert.round,
                "ok" if ok else "reject",
            )
        return ok

    # ------------------------------------------------------------- rotation

    def rotate(self, signatories, f: int, bls_keyring=None) -> None:
        """Epoch hot-swap: install the next committee's whitelist order and
        quorum threshold. Emitted certificates are kept — the chain stays
        continuous across the transition; only bitmap indexing for NEW
        emissions follows the new order. When a keyring is installed and
        none is supplied for the new committee, keys are re-derived
        deterministically from the identities (the same construction every
        component uses), so BLS emission survives churn."""
        self.signatories = list(signatories)
        self._pos = {s: i for i, s in enumerate(self.signatories)}
        self.f = int(f)
        if bls_keyring is not None:
            self.bls_keyring = bls_keyring
        elif self.bls_keyring is not None:
            for s in self.signatories:
                if s not in self.bls_keyring:
                    self.bls_keyring[s] = bls.bls_keypair_from_identity(s)

    # ------------------------------------------------------------- chaining

    def certificate_for(self, height):
        return self.certs.get(int(height))

    def chain_digest(self) -> str:
        """Canonical digest over the emitted certificate chain — the
        cross-replica / pipelined-vs-sequential equality handle (the
        certificate sibling of ``SimulationResult.commit_digest``)."""
        h = hashlib.sha256()
        for height in sorted(self.certs):
            c = self.certs[height]
            h.update(int(height).to_bytes(8, "little"))
            h.update(c.value_digest)
            h.update(c.signers)
        return h.hexdigest()

    def reset(self) -> None:
        """Crash-restart hook: a revived replica re-emits from its
        checkpoint; stale certificates must not survive the restore."""
        self.certs.clear()
