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
- BLS certificates: with a committee keyring the port mints the JAX
  certifier's aggregate signature, binding and bytes, folded on the host
  or by the plain ``g1_aggregate`` path; ``rotate`` re-derives churned
  keys; ``verify_bls_certificate`` accepts the light-client check and
  rejects a forged message, a wrong signer set and malformed fields;
  ``Simulation(bls_certificates=True | "device")`` commits the JAX sim's
  digest and certificate chains (both sides in burst mode, the port's
  only delivery);
- what stays unported (epochs, and with them epoch certifiers) is
  refused.

Bytes, digests and verdicts: every comparison is exact.
"""

import dataclasses
import hashlib
import random

import pytest
import torch

from hyperdrive_tpu.certificates import Certifier as RefCertifier
from hyperdrive_tpu.certificates import QuorumCertificate as RefQuorumCertificate
from hyperdrive_tpu.certificates import marshal_certificate as ref_marshal
from hyperdrive_tpu.certificates import unmarshal_certificate as ref_unmarshal
from hyperdrive_tpu.crypto import bls as ref_bls
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
from hyperdrive_tpu_torch.crypto import bls
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops import g1
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
    # BLS certificates are ported; epochs (and EpochCertifier) are not.
    with pytest.raises(NotImplementedError):
        Simulation(n=4, target_height=1, burst=True, certificates=True,
                   epochs=object())


# ------------------------------------------------------------ BLS aggregate

BLS_IDS = [bytes([i]) * 32 for i in range(7)]


@pytest.fixture(scope="module")
def keyrings():
    """The same committee keyring from the port's oracle and the JAX
    package's."""
    return ({s: bls.bls_keypair_from_identity(s) for s in BLS_IDS},
            {s: ref_bls.bls_keypair_from_identity(s) for s in BLS_IDS})


def _device_fold(parts):
    return g1.aggregate_points(parts, width=8, device="cpu")


@pytest.mark.parametrize("fold", ["host", "plain_device"])
def test_bls_certificate_matches_reference(keyrings, fold):
    mine, ref = keyrings
    fn = _device_fold if fold == "plain_device" else None
    c = Certifier(BLS_IDS, 2, transcript_source=lambda: b"\x5a" * 32,
                  bls_keyring=dict(mine), bls_aggregate_fn=fn)
    rc = RefCertifier(BLS_IDS, 2, transcript_source=lambda: b"\x5a" * 32,
                      bls_keyring=dict(ref))
    assert c.bls_pubkeys() == rc.bls_pubkeys()
    for h, signers in ((3, BLS_IDS[:5]), (4, BLS_IDS[1:])):
        cert = c.observe_commit(h, 1, b"block-%d" % h, signers)
        want = rc.observe_commit(h, 1, b"block-%d" % h, signers)
        assert len(cert.agg_sig) == 48
        assert (cert.agg_sig, cert.binding) == (want.agg_sig, want.binding)
        assert _wire(cert) == _wire(want, RefWriter, ref_marshal)
        assert c.verify(cert)
    assert c.chain_digest() == rc.chain_digest()
    # No keyring, or a counted signer without a key: no aggregate.
    assert Certifier(BLS_IDS, 2).observe_commit(1, 0, b"v", BLS_IDS).agg_sig == b""
    partial = {s: mine[s] for s in BLS_IDS[:3]}
    assert Certifier(BLS_IDS, 2, bls_keyring=partial).observe_commit(
        1, 0, b"v", BLS_IDS[:4]).agg_sig == b""


def test_bls_rotate_matches_reference(keyrings):
    mine, ref = keyrings
    c = Certifier(BLS_IDS, 2, bls_keyring=dict(mine))
    rc = RefCertifier(BLS_IDS, 2, bls_keyring=dict(ref))
    new_ids = BLS_IDS[2:] + [bytes([99]) * 32]
    c.rotate(new_ids, f=2)
    rc.rotate(new_ids, f=2)
    assert c.bls_pubkeys() == rc.bls_pubkeys()
    cert = c.observe_commit(4, 0, b"block-four", new_ids[:5])
    assert _wire(cert) == _wire(rc.observe_commit(4, 0, b"block-four", new_ids[:5]),
                                RefWriter, ref_marshal)
    # An explicit keyring replaces the installed one.
    swapped = {s: mine[BLS_IDS[0]] for s in new_ids}
    c.rotate(new_ids, f=2, bls_keyring=swapped)
    assert c.bls_keyring is swapped
    assert c.bls_pubkeys() == [mine[BLS_IDS[0]].pk_bytes] * len(new_ids)


def test_verify_bls_certificate(keyrings):
    mine, _ = keyrings
    c = Certifier(BLS_IDS, 2, bls_keyring=dict(mine))
    cert = c.observe_commit(3, 1, b"block-three", BLS_IDS[:5])
    pks = c.bls_pubkeys()
    assert verify_bls_certificate(cert, pks, quorum=5)
    # The same aggregate over another message (a forged height), and over
    # another signer set of the same size: the pairing rejects both.
    assert not verify_bls_certificate(dataclasses.replace(cert, height=4), pks)
    moved = bytearray(cert.signers)
    moved[0] ^= 0b1000001  # drop signer 0, claim signer 6
    assert not verify_bls_certificate(dataclasses.replace(cert, signers=bytes(moved)), pks)
    # Rejected before any pairing: quorum, widths, trailing bits, no key.
    assert not verify_bls_certificate(cert, pks, quorum=6)
    assert not verify_bls_certificate(dataclasses.replace(cert, agg_sig=b""), pks)
    assert not verify_bls_certificate(cert, pks + [pks[0]] * 2)
    trailing = dataclasses.replace(cert, signers=bytes([cert.signers[0] | 0x80]))
    assert not verify_bls_certificate(trailing, pks)
    assert not verify_bls_certificate(dataclasses.replace(cert, signers=b"\x00"), pks)
    assert not verify_bls_certificate(cert, pks[:4] + [b"\x01" * 96] + pks[5:])
    # Affine G2 keys are taken as they are.
    assert verify_bls_certificate(cert, [mine[s].pk for s in BLS_IDS], quorum=5)
    assert certificate_size(256, with_bls=True) == certificate_size(256) + 48


@pytest.fixture(scope="module")
def ref_bls_run():
    ref = RefSimulation(n=4, target_height=3, seed=5, timeout=1.0, burst=True,
                        bls_certificates=True)
    return ref, ref.run(max_steps=100_000)


@pytest.mark.parametrize("mode", [True, "device"])
def test_sim_bls_certificates_match_reference(ref_bls_run, mode):
    ref, want = ref_bls_run
    sim = Simulation(n=4, target_height=3, seed=5, timeout=1.0, burst=True,
                     bls_certificates=mode, device="cpu")
    got = sim.run(max_steps=100_000)
    assert got.completed and got.commit_digest() == want.commit_digest()
    assert got.cert_digests == want.cert_digests
    minted = 0
    for i, certifier in enumerate(sim.certifiers):
        assert set(certifier.certs) == set(ref.certifiers[i].certs)
        for h, cert in certifier.certs.items():
            assert len(cert.agg_sig) == 48
            assert _wire(cert) == _wire(ref.certifiers[i].certs[h], RefWriter, ref_marshal)
            minted += 1
    assert minted >= 3 * 4


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
