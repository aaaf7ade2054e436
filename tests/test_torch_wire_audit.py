"""The port's wire registry and decode seams against the JAX package's.

1. **Closure.** The port's ``@wire_codec`` registry equals the
   reference's: the same tags with the same ``max_bytes``, versions,
   roles and endpoint names, and the same budget-only declarations
   (``overlay.partial``). Every decode seam of the port reads through
   ``maybe_wire_reader`` with a registered tag.
2. **Differential decode.** One honest frame per family and a seeded
   corpus of its mutations (truncate, extend, bitflip) go through both
   packages' decoders with ``HD_SANITIZE=1``. Each frame must give the
   same outcome in both: the same typed error (``SerdeError``,
   ``ValueError``, or ``SanitizerError`` with its rule) with the same
   message, or a value that re-encodes to the same bytes.
"""

from __future__ import annotations

import importlib
import inspect
import random
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

#: Mutations per family: a few of each kind, well under a second a family.
N_MUTATIONS = 24

#: Modules that register wire families at import (both packages).
REGISTERING = ("messages", "process", "state", "epochs", "certificates",
               "crypto.shamir", "harness.sim", "transport", "obs.tracectx",
               "parallel.service", "campaign.record", "overlay.runtime")


def _pkg(root: str) -> SimpleNamespace:
    mods = {m: importlib.import_module(f"{root}.{m}") for m in REGISTERING}
    ns = SimpleNamespace(root=root, **{m.replace(".", "_"): v for m, v in mods.items()})
    ns.ann = importlib.import_module(f"{root}.analysis.annotations")
    ns.san = importlib.import_module(f"{root}.analysis.sanitizer")
    ns.codec = importlib.import_module(f"{root}.codec")
    ns.types = importlib.import_module(f"{root}.types")
    ns.merkle = importlib.import_module(f"{root}.ops.merkle")
    ns.ckpt = importlib.import_module(f"{root}.utils.checkpoint")
    ns.campaign = importlib.import_module(f"{root}.campaign")
    return ns


REF = _pkg("hyperdrive_tpu")
PORT = _pkg("hyperdrive_tpu_torch")


def _registry(pk):
    return {
        tag: sorted((s.max_bytes, s.version, s.role, s.name, s.module.split(".", 1)[1])
                    for s in specs)
        for tag, specs in pk.ann.WIRE_CODECS.items()
    }


def test_registry_equals_the_reference():
    port, ref = _registry(PORT), _registry(REF)
    assert port == ref
    assert sum(map(len, port.values())) == 36 and len(port) == 22
    assert PORT.ann.WIRE_BUDGETS == REF.ann.WIRE_BUDGETS == {"overlay.partial": 1 << 20}
    for tag in set(port) | set(PORT.ann.WIRE_BUDGETS):
        assert PORT.ann.wire_budget_for(tag) == REF.ann.wire_budget_for(tag) is not None


#: The port's decode seams: (function, the tags it names).
SEAMS = [
    (PORT.transport.TcpNode._read_loop, {"msg.envelope"}),
    (PORT.transport.FlightRecorder.load, {"msg.envelope", "flight.record"}),
    (PORT.harness_sim.ScenarioRecord.load, {"scenario.record"}),
    (PORT.ckpt.restore_bytes, {"process.checkpoint"}),
    (PORT.obs_tracectx.decode_stamp, {"trace.ctx"}),
    (PORT.parallel_service.decode_hello_ack, {"service.hello.ack"}),
    (PORT.parallel_service.decode_metrics_reply, {"service.metrics.reply"}),
    (PORT.parallel_service.decode_proof, {"service.proof"}),
    (PORT.parallel_service.decode_request, set()),  # tag from _REQUEST_FAMILIES
    (PORT.parallel_service.decode_result, {"service.result", "cert.quorum"}),
    (PORT.campaign_record.CampaignRecord.load, {"campaign.record"}),
]


def test_every_seam_decodes_through_a_registered_tag(monkeypatch, tmp_path):
    import re

    for fn, tags in SEAMS:
        src = inspect.getsource(fn)
        named = set(re.findall(r'maybe_wire_reader\(\s*"([^"]+)"', src))
        assert named == tags, fn.__qualname__
        assert "maybe_wire_reader(" in src
        # Only the checkpoint's fixed header stays a plain Reader, as in
        # the reference; its payload goes through the budget reader.
        plain = len(re.findall(r"(?<![\w.])Reader\(", src))
        assert plain == (fn is PORT.ckpt.restore_bytes), fn.__qualname__
        for tag in tags:
            assert PORT.ann.wire_budget_for(tag) is not None
    for tag in PORT.parallel_service._REQUEST_FAMILIES.values():
        assert PORT.ann.wire_budget_for(tag) is not None
    assert "wire_charge(" in inspect.getsource(PORT.overlay_runtime.OverlayRuntime.on_frame)
    # At run time, every budget a seam opens names a registered family.
    monkeypatch.setenv("HD_SANITIZE", "1")
    opened = []
    real = PORT.san.WireBudget

    class Recording(real):
        __slots__ = ()

        def __init__(self, tag, obs=None):
            opened.append(tag)
            super().__init__(tag, obs)

    monkeypatch.setattr(PORT.san, "WireBudget", Recording)
    for tag in FAMILIES:
        decode, _, seeds = _table(PORT, tag, tmp_path)
        decode(seeds[0])
    # The Shamir bundle decodes its own bytes in both packages (no seam).
    assert set(opened) == set(FAMILIES) - {"shamir.bundle"}


# ------------------------------------------------------------ the families


def _obj_bytes(pk, obj, rem=None):
    w = pk.codec.Writer() if rem is None else pk.codec.Writer(rem=rem)
    obj.marshal(w)
    return w.data()


def _fn_bytes(pk, fn, obj):
    w = pk.codec.Writer()
    fn(obj, w)
    return w.data()


def _values(pk):
    m = pk.messages
    propose = m.Propose(height=7, round=2, valid_round=1, value=b"\x11" * 32,
                        sender=b"\x22" * 32, payload=b"xyz", signature=b"\x33" * 64)
    prevote = m.Prevote(height=7, round=2, value=b"\x11" * 32,
                        sender=b"\x22" * 32, signature=b"\x44" * 64)
    precommit = m.Precommit(height=7, round=2, value=b"\x11" * 32,
                            sender=b"\x22" * 32, signature=b"\x55" * 64)
    timeout = m.Timeout(message_type=pk.types.MessageType.PREVOTE, height=7, round=2)
    cert = pk.certificates.QuorumCertificate(
        height=7, round=2, value_digest=b"\x66" * 32, signers=b"\x0b",
        transcript=b"\x77" * 32, binding=b"\x88" * 32, agg_sig=b"")
    proof = pk.merkle.MerkleProof(height=7, account=5, balance=100, stake=10,
                                  prev_root=b"\xbb" * 32, digest=tuple(range(8)),
                                  siblings=((0, 1, 2, 3), (4, 5, 6, 7)))
    return SimpleNamespace(propose=propose, prevote=prevote, precommit=precommit,
                           timeout=timeout, cert=cert, proof=proof)


def _table(pk, tag, tmp=None):
    """(decode: bytes -> value, reencode: value -> bytes, seed frames) for
    ``tag`` in package ``pk``; decode goes through the package's seam."""
    v = _values(pk)
    m, svc = pk.messages, pk.parallel_service
    if tag.startswith("msg.") and tag != "msg.envelope":
        cls = {"msg.propose": m.Propose, "msg.prevote": m.Prevote,
               "msg.precommit": m.Precommit, "msg.timeout": m.Timeout}[tag]
        obj = getattr(v, tag[4:])
        return (lambda b: cls.unmarshal(pk.san.maybe_wire_reader(tag, b)),
                lambda o: _obj_bytes(pk, o), [_obj_bytes(pk, obj)])
    if tag == "msg.envelope":
        return (lambda b: m.unmarshal_message(pk.san.maybe_wire_reader(tag, b)),
                lambda o: _fn_bytes(pk, m.marshal_message, o),
                [_fn_bytes(pk, m.marshal_message, v.prevote)])
    if tag == "cert.quorum":
        c = pk.certificates
        return (lambda b: c.unmarshal_certificate(pk.san.maybe_wire_reader(tag, b)),
                lambda o: _fn_bytes(pk, c.marshal_certificate, o),
                [_fn_bytes(pk, c.marshal_certificate, v.cert)])
    if tag == "epoch.proof":
        e = pk.epochs
        proof = e.EpochProof(epoch=3, prev_set_digest=b"\x99" * 32,
                             next_set_digest=b"\xaa" * 32,
                             next_signatories=(b"\x01" * 32, b"\x02" * 32), cert=v.cert)
        return (lambda b: e.unmarshal_epoch_proof(pk.san.maybe_wire_reader(tag, b)),
                lambda o: _fn_bytes(pk, e.marshal_epoch_proof, o),
                [_fn_bytes(pk, e.marshal_epoch_proof, proof)])
    if tag == "shamir.bundle":
        sh = pk.crypto_shamir
        return (sh.decode_share_bundle, sh.encode_share_bundle,
                [sh.encode_share_bundle([[(1, 5), (2, 9)], [(1, 3), (2, 4)]])])
    if tag == "trace.ctx":
        tc = pk.obs_tracectx
        return (tc.decode_stamp, lambda o: tc.encode_stamp(*o),
                [tc.encode_stamp(3, 512, (2 << 32) | 41)])
    if tag in ("service.hello", "service.submit", "service.query", "service.metrics"):
        def reencode(req):
            kind = req[0]
            if kind == "hello":
                return svc.encode_hello(req[1], req[3], req[2], t0=req[4])
            if kind == "submit":
                return svc.encode_submit(req[1], req[2], req[3], req[4], req[6],
                                         generation=req[5])
            if kind == "metrics":
                return svc.encode_metrics_request(req[1])
            return svc.encode_query(req[1], req[2])
        seed = {
            "service.hello": svc.encode_hello("tenant-a", [b"\x01" * 32, b"\x02" * 32], 0,
                                              t0=12345.625),
            "service.submit": svc.encode_submit(9, 7, 2, b"\x11" * 32,
                                                [(b"\x22" * 32, b"\x33" * 64)]),
            "service.query": svc.encode_query(9, 5),
            "service.metrics": svc.encode_metrics_request(9),
        }[tag]
        return svc.decode_request, reencode, [seed]
    if tag == "service.hello.ack":
        return (svc.decode_hello_ack, lambda o: svc.encode_hello_ack(*o),
                [svc.encode_hello_ack(12345.625, 12345.75, 7)])
    if tag == "service.metrics.reply":
        return (svc.decode_metrics_reply,
                lambda o: svc.encode_metrics_reply(o[0], o[1], o[2] or ""),
                [svc.encode_metrics_reply(9, svc.STATUS_COMMITTED,
                                          "# TYPE hd_x counter\nhd_x 1\n")])
    if tag == "service.result":
        return (svc.decode_result,
                lambda o: svc.encode_result(o[0], o[1], len(o[2]), o[2], cert=o[3],
                                            root=o[4]),
                [svc.encode_result(9, svc.STATUS_COMMITTED, 3, [True, False, True],
                                   cert=v.cert, root=b"\xcc" * 32)])
    if tag == "service.proof":
        return (svc.decode_proof, lambda o: svc.encode_proof(*o),
                [svc.encode_proof(9, svc.STATUS_COMMITTED, v.proof)])
    if tag == "campaign.record":
        rec_mod = pk.campaign_record
        cfg = pk.campaign.CampaignConfig(
            family="storm", seed=7, validators=64, committee_size=16, epochs=4,
            epoch_length=2, attackers=4, waves=3, wave_votes=2, attack_rate=4,
            sybils=8, budget_milli=200, grind_width=2)
        rec = rec_mod.CampaignRecord.capture(
            cfg, {"family": "storm", "waves": [[3, 48, 0, 0]], "violations": []})
        return (rec_mod.CampaignRecord.load, lambda o: _obj_bytes(pk, o, rem=1 << 20),
                [_obj_bytes(pk, rec, rem=1 << 20)])
    if tag == "state.checkpoint":
        st = pk.state
        return (lambda b: st.State.unmarshal(pk.san.maybe_wire_reader(tag, b, rem=1 << 28)),
                lambda o: _obj_bytes(pk, o), [_obj_bytes(pk, st.State())])
    if tag == "process.checkpoint":
        def decode(data):
            proc = pk.process.Process(whoami=b"\x01" * 32, f=1)
            pk.ckpt.restore_bytes(proc, data)
            return pk.ckpt.checkpoint_bytes(proc)
        return decode, lambda d: d, [
            pk.ckpt.checkpoint_bytes(pk.process.Process(whoami=b"\x01" * 32, f=1))]
    if tag == "scenario.record":
        sim = pk.harness_sim
        rec = sim.ScenarioRecord(seed=1, n=4, f=1, target_height=2)
        rec.signatories = [bytes([i + 1]) * 32 for i in range(4)]
        rec.messages = [(0, v.prevote), (1, v.timeout)]
        rec.bursts = [2]
        rec.batch_ingest = False

        def decode(b):
            p = tmp / f"{pk.root}.scenario.bin"
            p.write_bytes(b)
            return sim.ScenarioRecord.load(str(p))
        return decode, lambda r: _obj_bytes(pk, r, rem=1 << 30), [
            _obj_bytes(pk, rec, rem=1 << 30)]
    if tag == "flight.record":
        fr = pk.transport.FlightRecorder

        def decode(b):
            p = tmp / f"{pk.root}.flight.bin"
            p.write_bytes(b)
            return fr.load(str(p))

        def reencode(msgs):
            out = fr()
            for msg in msgs:
                out.record(msg)
            return b"".join(out.frames)
        reset = importlib.import_module(f"{pk.root}.replica").ResetHeight(
            8, (b"\x01" * 32, b"\x02" * 32))
        return decode, reencode, [reencode([v.prevote, reset, v.precommit])]
    raise KeyError(tag)


FAMILIES = sorted(REF.ann.WIRE_CODECS)


def _mutations(tag: str, seeds, n: int):
    """Seeded stream: per index a seed frame and one of truncate / extend
    with junk / bitflip."""
    for i in range(n):
        rng = random.Random(f"torch-wire-fuzz:{tag}:{i}")
        base = seeds[rng.randrange(len(seeds))]
        kind = i % 3
        if kind == 0:
            yield base[: rng.randrange(len(base))]
        elif kind == 1:
            yield base + bytes(rng.randrange(256) for _ in range(1 + rng.randrange(16)))
        else:
            pos = rng.randrange(len(base))
            mutated = bytearray(base)
            mutated[pos] ^= 1 << rng.randrange(8)
            yield bytes(mutated)


def _outcome(pk, decode, reencode, frame):
    typed = (pk.codec.SerdeError, ValueError, pk.san.SanitizerError)
    try:
        value = decode(frame)
    except typed as e:
        return (type(e).__name__, getattr(e, "rule", None), str(e))
    return ("ok", reencode(value))


@pytest.mark.parametrize("tag", FAMILIES)
def test_mutants_decode_alike_in_both_packages(tag, tmp_path, monkeypatch):
    monkeypatch.setenv("HD_SANITIZE", "1")
    ref = _table(REF, tag, tmp_path)
    port = _table(PORT, tag, tmp_path)
    assert port[2] == ref[2], "the honest frames differ"
    for decode, reencode, seeds in (ref, port):
        assert reencode(decode(seeds[0])) == seeds[0]
    kinds = set()
    for frame in _mutations(tag, ref[2], N_MUTATIONS):
        want = _outcome(REF, ref[0], ref[1], frame)
        got = _outcome(PORT, port[0], port[1], frame)
        assert got == want, (tag, frame.hex())
        kinds.add(want[0])
    # A flight log tolerates a torn tail by contract (the recorder was
    # killed mid-write), so its mutants may all decode to a prefix.
    assert kinds - {"ok"} or tag == "flight.record", "no mutant was refused"
