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

Trust model: the *binding* is an integrity commitment, not an aggregate
signature. It proves the certificate's fields are exactly what the
emitting replica committed after its verifier's batched launch accepted
the 2f+1 precommits (the RLC transcript digest from
``TorchBatchVerifier.last_transcript`` rides inside it). Tampering with
any field breaks the binding, but trusting it means trusting the emitting
seam.

Wire format (codec.py, canonical):

    u64 height | u32 round | bytes32 value_digest |
    raw bitmap (u32 length prefix) | bytes32 transcript | bytes32 binding |
    raw agg_sig (empty or 48 B)

116 bytes + n/8 for the signer bitmap: 148 B at n=256.

Port copy of the JAX package's ``certificates.py``, byte for byte on the
wire and in the binding. Dropped: the ``wire_codec`` analysis annotation
and the metrics recorder (``obs``, the ``cert.emit``/``cert.verify``
events). Not ported yet (the BLS12-381 slice), and refused with
``NotImplementedError``: a BLS keyring or aggregation backend on
:class:`Certifier` and :func:`verify_bls_certificate`. The ``agg_sig``
field, its v2 binding and its wire slot are kept, so certificates that
carry an aggregate still decode and bind.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer

__all__ = [
    "QuorumCertificate",
    "Certifier",
    "marshal_certificate",
    "unmarshal_certificate",
    "certificate_size",
    "bls_commit_message",
    "verify_bls_certificate",
]

_LATER = "not ported to the PyTorch package yet (the BLS12-381 slice)"

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
    one committed (height, round, value)."""
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
    #: Compressed BLS12-381 G1 aggregate signature (48 bytes), or b"" on
    #: the transcript-bound-only path (the only one this package mints).
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


def marshal_certificate(cert: QuorumCertificate, w: Writer) -> None:
    w.u64(cert.height)
    w.u32(cert.round)
    w.bytes32(cert.value_digest)
    w.raw(cert.signers)
    w.bytes32(cert.transcript)
    w.bytes32(cert.binding)
    w.raw(cert.agg_sig)


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
    """Light-client verification of a certificate's BLS aggregate: not
    ported yet."""
    raise NotImplementedError(f"BLS certificate verification is {_LATER}")


class Certifier:
    """Per-replica certificate emitter + O(1) re-verifier.

    Plugs into the :class:`~hyperdrive_tpu_torch.process.Process` commit
    seam: when L49 fires with 2f+1 precommits, the process hands over the
    signer set and the certifier mints the certificate, binding the
    verifier's last batch transcript (``transcript_source``: a callable
    returning bytes — e.g. ``lambda: verifier.last_transcript`` — or None
    for transcript-less paths). Emitted certificates are kept per height
    (``certs``).
    """

    def __init__(self, signatories, f: int, transcript_source=None,
                 bls_keyring=None, bls_aggregate_fn=None):
        if bls_keyring is not None or bls_aggregate_fn is not None:
            raise NotImplementedError(f"BLS aggregate certificates are {_LATER}")
        self.signatories = list(signatories)
        self._pos = {s: i for i, s in enumerate(self.signatories)}
        self.f = int(f)
        self.transcript_source = transcript_source
        #: height -> QuorumCertificate, in emission order.
        self.certs: dict = {}
        #: Verification outcomes.
        self.verified = 0
        self.rejected = 0

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
        cert = QuorumCertificate(
            height=int(height),
            round=int(round),
            value_digest=value_digest,
            signers=signers_b,
            transcript=transcript,
            binding=_binding(height, round, value_digest, signers_b, transcript),
        )
        self.certs[int(height)] = cert
        return cert

    # ----------------------------------------------------------- re-verify

    def verify(self, cert: QuorumCertificate) -> bool:
        """O(1) acceptance: quorum weight, bitmap width, and binding
        integrity — no signature is re-checked and no vote set is
        re-gossiped."""
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
        return ok

    # ------------------------------------------------------------- rotation

    def rotate(self, signatories, f: int, bls_keyring=None) -> None:
        """Epoch hot-swap: install the next committee's whitelist order and
        quorum threshold. Emitted certificates are kept — the chain stays
        continuous across the transition; only bitmap indexing for NEW
        emissions follows the new order."""
        if bls_keyring is not None:
            raise NotImplementedError(f"BLS aggregate certificates are {_LATER}")
        self.signatories = list(signatories)
        self._pos = {s: i for i, s in enumerate(self.signatories)}
        self.f = int(f)

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
