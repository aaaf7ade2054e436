"""The PyTorch port's quorum certificates against the JAX package's.

- the wire codec: the port marshals every certificate to the JAX
  package's bytes and each side decodes the other's; truncated and
  oversize blobs raise ``SerdeError``; the size is flat in n;
- ``Certifier``: the same certificates (binding bytes included) for the
  same commits, O(1) re-verification, every forgery rejected, transcript
  widening and chain digests as the JAX certifier's;
- the seams: ``Simulation(certificates=True)`` chain digests equal the
  JAX run's (``HostVerifier``, transcript b""), pipelined equal
  sequential, an ``rlc=True`` run binds its verifier's transcripts;
  ``DeviceTallyFlusher`` binds the transcript, re-verifies every minted
  certificate and resets as the JAX flusher does;
- what stays unported (BLS keyrings and aggregates, ``bls_certificates``,
  epoch certifiers) is refused.

Bytes, digests and verdicts: every comparison is exact.
"""

import hashlib
import random

import pytest
import torch

from hyperdrive_tpu.certificates import Certifier as RefCertifier
from hyperdrive_tpu.certificates import QuorumCertificate as RefQuorumCertificate
from hyperdrive_tpu.certificates import marshal_certificate as ref_marshal
from hyperdrive_tpu.certificates import unmarshal_certificate as ref_unmarshal
from hyperdrive_tpu.codec import Reader as RefReader
from hyperdrive_tpu.codec import Writer as RefWriter
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.certificates import (
    Certifier,
    QuorumCertificate,
    bls_commit_message,
    certificate_size,
    marshal_certificate,
    unmarshal_certificate,
    verify_bls_certificate,
)
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.verifier import HostVerifier

from test_torch_tallyflush import JAX, PORT, SIGS, _handle_all, _Run

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)


def _mk(cls=Certifier, n=7, f=2, transcript=b"\x5a" * 32):
    return cls(
        [bytes([i]) * 32 for i in range(n)],
        f,
        transcript_source=(lambda: transcript) if transcript else None,
    )


def _wire(cert, writer=Writer, marshal=marshal_certificate):
    w = writer()
    marshal(cert, w)
    return w.data()


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("agg", [False, True])
def test_wire_bytes_match_reference(agg):
    rng = random.Random(int(agg))
    for _ in range(32):
        n = rng.randint(1, 1024)
        fields = dict(
            height=rng.randint(0, 2**63 - 1),
            round=rng.randint(0, 2**31 - 1),
            value_digest=rng.randbytes(32),
            signers=rng.randbytes(-(-n // 8)),
            transcript=rng.randbytes(32),
            binding=rng.randbytes(32),
            agg_sig=rng.randbytes(48) if agg else b"",
        )
        cert = QuorumCertificate(**fields)
        blob = _wire(cert)
        assert blob == _wire(RefQuorumCertificate(**fields), RefWriter, ref_marshal)
        r = Reader(blob)
        assert unmarshal_certificate(r) == cert and r.done()
        assert ref_unmarshal(RefReader(blob)).__dict__ == cert.__dict__


def test_truncated_and_oversize_blobs_reject():
    blob = _wire(_mk().observe_commit(3, 1, b"value", []))
    for cut in (0, 1, len(blob) // 2, len(blob) - 1):
        with pytest.raises(SerdeError):
            unmarshal_certificate(Reader(blob[:cut]))
    w = Writer()
    w.u64(1)
    w.u32(0)
    w.bytes32(bytes(32))
    w.raw(bytes(8192))  # a bitmap wider than any validator set sized for
    w.bytes32(bytes(32))
    w.bytes32(bytes(32))
    with pytest.raises(SerdeError):
        unmarshal_certificate(Reader(w.data()))
    bad_agg = blob[:-4] + (5).to_bytes(4, "little") + bytes(5)
    with pytest.raises(SerdeError):
        unmarshal_certificate(Reader(bad_agg))


def test_size_is_constant_in_validator_count():
    s256, s512, s1024 = (certificate_size(n) for n in (256, 512, 1024))
    assert s256 == 148
    assert s512 - s256 == 256 // 8 and s1024 - s512 == 512 // 8
    assert certificate_size(256, with_bls=True) == s256 + 48


# -------------------------------------------------------------- emit/verify


def test_emission_equals_reference_and_verifies():
    port, ref = _mk(), _mk(RefCertifier)
    sigs = port.signatories
    for h, (rnd, value, signers) in enumerate(
        [(2, b"block-nine", sigs[:5]), (0, b"v", [b"\xee" * 32, sigs[0]]),
         (1, b"all", sigs)], start=9,
    ):
        got = port.observe_commit(h, rnd, value, signers)
        want = ref.observe_commit(h, rnd, value, signers)
        assert _wire(got) == _wire(want, RefWriter, ref_marshal)
        assert got.value_digest == hashlib.sha256(value).digest()
        assert port.verify(got) == ref.verify(want)
    assert port.certificate_for(9).signer_count() == 5
    assert port.certificate_for(10).signer_count() == 1  # unknown signer ignored
    assert (port.verified, port.rejected) == (ref.verified, ref.rejected) == (2, 1)
    assert port.chain_digest() == ref.chain_digest()
    assert bls_commit_message(3, 1, b"\x07" * 32) == (
        b"hd-bls-commit-v1" + (3).to_bytes(8, "little") + (1).to_bytes(4, "little")
        + b"\x07" * 32)


def test_forged_certificates_reject():
    c = _mk()
    sigs = c.signatories
    cert = c.observe_commit(4, 0, b"honest", sigs[:5])

    def forged(**kw):
        fields = dict(cert.__dict__)
        fields.update(kw)
        return QuorumCertificate(**fields)

    assert c.verify(cert)
    for kw in (dict(height=cert.height + 1), dict(round=cert.round + 1),
               dict(value_digest=b"\x01" * 32), dict(transcript=b"\x02" * 32),
               dict(signers=bytes([0xFF])), dict(agg_sig=bytes(48))):
        assert not c.verify(forged(**kw)), kw
    thin = c.observe_commit(5, 0, b"thin", sigs[:4])  # below 2f + 1
    assert not c.verify(thin)
    other = Certifier([bytes([i]) * 32 for i in range(20)], 2)
    assert not c.verify(other.observe_commit(4, 0, b"honest", other.signatories[:7]))
    assert (c.verified, c.rejected) == (1, 8)


def test_transcript_widening_chain_order_reset_and_rotation():
    for cls in (Certifier, RefCertifier):
        c = _mk(cls, transcript=None)
        c.transcript_source = lambda: b"short"
        assert c.observe_commit(1, 0, b"v", c.signatories[:5]).transcript == (
            hashlib.sha256(b"short").digest())
        c.transcript_source = lambda: b""
        assert c.observe_commit(2, 0, b"v", c.signatories[:5]).transcript == bytes(32)
    a, b = _mk(), _mk()
    sigs = a.signatories
    a.observe_commit(1, 0, b"one", sigs[:5])
    a.observe_commit(2, 0, b"two", sigs[:5])
    b.observe_commit(2, 0, b"two", sigs[:5])
    b.observe_commit(1, 0, b"one", sigs[:5])
    assert a.chain_digest() == b.chain_digest()
    b.observe_commit(3, 0, b"three", sigs[:5])
    assert a.chain_digest() != b.chain_digest()
    b.reset()
    assert not b.certs
    a.rotate(list(reversed(sigs)), 2)
    cert = a.observe_commit(3, 0, b"three", sigs[:1])
    assert cert.signers == bytes([0x40]) and a.certificate_for(1) is not None


def test_unported_bls_parts_refuse():
    sigs = [bytes([i]) * 32 for i in range(4)]
    with pytest.raises(NotImplementedError):
        Certifier(sigs, 1, bls_keyring={})
    with pytest.raises(NotImplementedError):
        Certifier(sigs, 1, bls_aggregate_fn=lambda parts: None)
    with pytest.raises(NotImplementedError):
        Certifier(sigs, 1).rotate(sigs, 1, bls_keyring={})
    cert = Certifier(sigs, 1).observe_commit(1, 0, b"v", sigs)
    with pytest.raises(NotImplementedError):
        verify_bls_certificate(cert, [bytes(96)] * 4)
    for opt in (dict(bls_certificates=True), dict(bls_certificates="device"),
                dict(epochs=object())):
        with pytest.raises(NotImplementedError):
            Simulation(n=4, target_height=1, burst=True, certificates=True, **opt)


# ----------------------------------------------------------- consensus seams

ARGS = dict(target_height=4, sign=True, burst=True, dedup_verify=True,
            small_window_host=False, certificates=True)


@pytest.mark.parametrize("n,seed", [(4, 1), (7, 11)])
def test_sim_chain_digests_match_reference(n, seed):
    ref = RefSimulation(n=n, seed=seed, batch_verifier=RefHostVerifier(), **ARGS)
    want = ref.run()
    sim = Simulation(n=n, seed=seed, batch_verifier=HostVerifier(), **ARGS)
    got = sim.run()
    assert got.completed and got.commit_digest() == want.commit_digest()
    assert got.cert_digests == want.cert_digests and len(set(got.cert_digests)) == 1
    for i, certifier in enumerate(sim.certifiers):
        assert set(certifier.certs) == set(ref.certifiers[i].certs)
        for h, cert in certifier.certs.items():
            assert _wire(cert) == _wire(ref.certifiers[i].certs[h], RefWriter, ref_marshal)
            assert cert.value_digest == hashlib.sha256(got.commits[i][h]).digest()
            assert cert.transcript == bytes(32)  # HostVerifier: no transcript
            assert certifier.verify(cert)


def test_pipelined_certificates_equal_sequential():
    kw = dict(ARGS, n=4, seed=7)
    seq = Simulation(batch_verifier=HostVerifier(), **kw).run()
    pipe = Simulation(batch_verifier=HostVerifier(), pipeline_heights=True, **kw).run()
    assert seq.completed and pipe.completed
    assert seq.commit_digest() == pipe.commit_digest()
    assert seq.cert_digests == pipe.cert_digests


def test_rlc_run_binds_the_verifiers_transcripts():
    host = Simulation(n=4, seed=3, batch_verifier=HostVerifier(),
                      **dict(ARGS, target_height=2)).run()
    bv = TorchBatchVerifier(buckets=(16,), rlc=True, device="cpu")
    sim = Simulation(n=4, seed=3, batch_verifier=bv, **dict(ARGS, target_height=2))
    got = sim.run()
    assert got.commit_digest() == host.commit_digest()
    # Chain digests cover heights, values and signers, not transcripts.
    assert got.cert_digests == host.cert_digests
    assert bv.rlc_calls >= 2 and bv.rlc_fallbacks == 0
    certs = sim.certifiers[0].certs
    assert certs and all(c.transcript not in (bytes(32), b"") for c in certs.values())
    assert all(sim.certifiers[0].verify(c) for c in certs.values())


def test_tallyflush_binds_transcript_and_reverifies_as_reference():
    runs = []
    for pkg, cls in ((PORT, Certifier), (JAX, RefCertifier)):
        certifier = cls(list(SIGS), 1)
        run = _Run(pkg, certifier=certifier)
        assert run.fl.certifier is certifier
        assert certifier.transcript_source is not None
        assert certifier.transcript_source() == b""
        runs.append((run, certifier))
    _handle_all([run for run, _ in runs], 3)
    (port, pc), (ref, rc) = runs
    assert port.commits == ref.commits and set(port.commits) == {1, 2, 3}
    assert (pc.verified, pc.rejected) == (rc.verified, rc.rejected) == (3, 0)
    assert pc.chain_digest() == rc.chain_digest()
    for h in (1, 2, 3):
        assert _wire(pc.certs[h]) == _wire(rc.certs[h], RefWriter, ref_marshal)
    # A bound source is kept; reset clears the chain with the flusher.
    own = Certifier(list(SIGS), 1, transcript_source=lambda: b"x")
    _Run(PORT, certifier=own)
    assert own.transcript_source() == b"x"
    port.fl.reset()
    assert not pc.certs
