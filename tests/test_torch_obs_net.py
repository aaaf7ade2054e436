"""The port's cross-process observability (``obs/tracectx``, ``obs/merge``,
``obs/benchdiff`` and the traced ``TcpNode``) against the JAX package's.

Modelled on ``tests/test_trace_merge.py`` and ``tests/test_benchdiff.py``:
the same seeded stamps, journals and bench artifacts go through both
packages, compared by bytes, merged journals, merged digests, Perfetto
events, critical-path summaries and bench-diff verdicts. A traced port
``TcpNode`` and a traced JAX ``TcpNode`` exchange stamped frames over
localhost, and both packages' merges of their journals pair every
``trace.recv`` with its ``trace.send``. Host code only; every wait has a
5 s deadline.
"""

import copy
import json
import random
import time

import pytest
import torch

from hyperdrive_tpu.codec import SerdeError as RefSerdeError
from hyperdrive_tpu.messages import Prevote as RefPrevote
from hyperdrive_tpu.obs import benchdiff as ref_benchdiff
from hyperdrive_tpu.obs import merge as ref_merge
from hyperdrive_tpu.obs import perfetto as ref_perfetto
from hyperdrive_tpu.obs import recorder as ref_recorder
from hyperdrive_tpu.obs import report as ref_report
from hyperdrive_tpu.obs import tracectx as ref_tracectx
from hyperdrive_tpu.obs.metrics import Registry as RefRegistry
from hyperdrive_tpu.transport import TcpNode as RefTcpNode
from hyperdrive_tpu_torch import obs
from hyperdrive_tpu_torch.codec import SerdeError
from hyperdrive_tpu_torch.messages import Prevote
from hyperdrive_tpu_torch.obs import benchdiff, merge, perfetto, recorder, report, tracectx
from hyperdrive_tpu_torch.obs.metrics import Registry
from hyperdrive_tpu_torch.transport import TcpNode

torch.set_num_threads(1)

DEADLINE = 5.0


# ------------------------------------------------------------ stamp codec


@pytest.mark.parametrize("seed", range(4))
def test_stamp_bytes_decode_and_split_equal_jax(seed):
    rng = random.Random(seed)
    origin = rng.randrange(1, 1 << 32)
    seq = rng.randrange(1 << 64)
    parent = tracectx.span_id(rng.randrange(1, 1 << 20), rng.randrange(1 << 40))
    assert parent == ref_tracectx.span_id(parent >> 32, parent & 0xFFFFFFFF)
    stamp = tracectx.encode_stamp(origin, seq, parent)
    assert stamp == ref_tracectx.encode_stamp(origin, seq, parent)
    assert len(stamp) == tracectx.STAMP_LEN == ref_tracectx.STAMP_LEN
    assert stamp[0] == tracectx.TRACE_MAGIC == ref_tracectx.TRACE_MAGIC
    assert tracectx.decode_stamp(stamp) == ref_tracectx.decode_stamp(stamp) == (
        origin, seq, parent)
    body = bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
    for payload in (stamp + body, body, b"", b"\x54" + stamp[1:8], b"\x01" + stamp):
        assert tracectx.split_frame(payload) == ref_tracectx.split_frame(payload)


def test_stamp_rejects_like_jax():
    stamp = tracectx.encode_stamp(1, 1)
    for bad in (b"\x00" + stamp[1:], stamp + b"\x00", stamp[:-1]):
        with pytest.raises(SerdeError) as got:
            tracectx.decode_stamp(bad)
        with pytest.raises(RefSerdeError) as want:
            ref_tracectx.decode_stamp(bad)
        assert str(got.value) == str(want.value)


def test_trace_source_stamps_and_journals_like_jax():
    journals = []
    for rec_mod, ctx in ((recorder, tracectx), (ref_recorder, ref_tracectx)):
        rec = rec_mod.Recorder(time_fn=lambda: 0.0)
        src = ctx.TraceSource(4, obs=rec.scoped(-1))
        frames = [src.stamp(b"payload", height=7), src.stamp(b"x", parent=9, round_=2)]
        ctx.note_recv(rec.scoped(2), (9, 3, 0), 5, 1)
        ctx.note_recv(rec.scoped(2), None)
        with pytest.raises(ValueError):
            ctx.TraceSource(0)
        journals.append((frames, rec.digest(), [tuple(e) for e in rec.snapshot()]))
    assert journals[0] == journals[1]
    frames, _, events = journals[0]
    assert tracectx.split_frame(frames[0]) == ((4, 1, 0), b"payload")
    assert [e[4:] for e in events] == [("trace.send", "4:1"), ("trace.send", "4:2"),
                                       ("trace.recv", "9:3")]


# ---------------------------------------------------- synthetic journals


def _journal(origin, events):
    return {
        "version": 1,
        "capacity": 65536,
        "total": len(events),
        "dropped": 0,
        "events": [list(ev) for ev in events],
        "meta": {"origin": origin},
    }


def _two_process_run(skew=0.0, drop_sender=False, wrong_offset=False):
    """The reference test's hand-built exchange: the server (origin 1)
    commits height 1 after the client (origin 2) submits; the client's
    clock runs ``skew`` seconds ahead."""
    server = [
        (10.000, -1, 1, -1, "trace.recv", "2:1"),
        (10.001, -1, 1, 0, "service.remote.submit", 4),
        (10.003, -1, 1, 0, "cert.emit", None),
        (10.004, -1, 1, 0, "service.remote.resolve", "committed"),
        (10.005, -1, -1, -1, "trace.send", "1:1"),
    ]
    offset = "1:5.0" if wrong_offset else f"1:{-skew:.6f}"
    client = [
        (9.998 + skew, -1, -1, -1, "trace.send", "2:1"),
        (9.999 + skew, -1, -1, -1, "trace.offset", offset),
        (10.006 + skew, -1, -1, -1, "trace.recv", "1:1"),
        (10.007 + skew, -1, 1, -1, "commit", None),
    ]
    if drop_sender:
        server = [ev for ev in server if ev[4] != "trace.send"]
    return [_journal(1, server), _journal(2, client)]


def _seeded_mesh(seed, procs=3):
    """``procs`` journals of seeded traffic: each process stamps frames to
    the others, some lost (orphans), with offsets between them."""
    rng = random.Random(seed)
    events = {o: [] for o in range(1, procs + 1)}
    seqs = {o: 0 for o in events}
    skew = {o: rng.uniform(-2.0, 2.0) for o in events}
    t = 0.0
    for _ in range(60):
        t += rng.choice((0.0, 0.001, 0.01))
        a, b = rng.sample(sorted(events), 2)
        seqs[a] += 1
        key = f"{a}:{seqs[a]}"
        h = rng.randrange(1, 5)
        if rng.random() > 0.1:
            events[a].append((t + skew[a], -1, h, 0, "trace.send", key))
        events[b].append((t + skew[b] + rng.uniform(-0.02, 0.05), rng.randrange(4), h, 0,
                          "trace.recv", key))
        if rng.random() < 0.2:
            events[b].append((t + skew[b], -1, -1, -1, "trace.offset",
                              f"{a}:{skew[a] - skew[b] + rng.uniform(-0.01, 0.01):.6f}"))
        if rng.random() < 0.3:
            events[a].append((t + skew[a], rng.randrange(4), h, 0, "commit", "ab" * 4))
    return [_journal(o, sorted(evs)) for o, evs in sorted(events.items())]


_MERGES = {
    "flat": lambda: _two_process_run(),
    "skewed": lambda: _two_process_run(skew=5.0),
    "clamped": lambda: _two_process_run(skew=5.0, wrong_offset=True),
    "orphan": lambda: _two_process_run(drop_sender=True),
    "mesh1": lambda: _seeded_mesh(1),
    "mesh2": lambda: _seeded_mesh(2, procs=4),
    "unstamped": lambda: [{**j, "meta": {}} for j in _seeded_mesh(3)],
}


@pytest.mark.parametrize("case", sorted(_MERGES))
def test_merged_journal_digest_and_views_equal_jax(case):
    got = merge.merge_journals(_MERGES[case]())
    want = ref_merge.merge_journals(_MERGES[case]())
    assert got == want
    assert merge.merged_digest(got) == ref_merge.merged_digest(want)
    assert merge.merged_digest(merge.merge_journals(_MERGES[case]())) == merge.merged_digest(got)
    events = [ref_recorder.Event(tuple(ev)) for ev in got["events"]]
    assert {ev.pid for ev in events} == set(got["meta"]["origins"])
    assert perfetto.to_trace_events(events) == ref_perfetto.to_trace_events(events)
    assert report.critical_path_summary(events) == ref_report.critical_path_summary(events)
    if case == "orphan":
        assert got["meta"]["orphans"] == ["2<-1:1"]
    if case == "skewed":
        assert got["meta"]["offsets"]["2"] == pytest.approx(-5.0)
    if case == "clamped":
        ts = {ev[4]: ev[0] for ev in got["events"] if ev[5] == "2:1"}
        assert ts["trace.recv"] >= ts["trace.send"]


def test_merge_offsets_duplicates_and_saved_bytes_equal_jax(tmp_path):
    journals = {
        1: [],
        2: [(0.0, -1, -1, -1, "trace.offset", "1:-3.0")],
        3: [(0.0, -1, -1, -1, "trace.offset", "2:1.0"), (0.0, -1, -1, -1, "trace.offset",
                                                          "x:bad")],
        4: [],
    }
    assert merge.estimate_offsets(journals) == ref_merge.estimate_offsets(journals)
    assert merge.estimate_offsets(journals)[3] == pytest.approx(-2.0)
    dup = _two_process_run()
    dup[1]["meta"]["origin"] = 1
    with pytest.raises(ValueError, match="duplicate"):
        merge.merge_journals(dup)
    with pytest.raises(ValueError, match="duplicate"):
        ref_merge.merge_journals(copy.deepcopy(dup))
    merged = merge.merge_journals(_seeded_mesh(5))
    merge.save_merged(merged, tmp_path / "port.json")
    ref_merge.save_merged(ref_merge.merge_journals(_seeded_mesh(5)), tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    loaded = recorder.load_journal(tmp_path / "ref.json")
    assert loaded["meta"]["merged"] is True
    assert merge.merged_digest(loaded) == ref_merge.merged_digest(
        ref_recorder.load_journal(tmp_path / "port.json"))


# ------------------------------------------------------------ benchdiff

ARTIFACT = {
    "benchdiff_gate": ["consensus.block_wall_s", "verify.speedup"],
    "consensus": {
        "block_wall_s": [0.010, 0.011, 0.010, 0.012, 0.010, 0.011],
        "heights_per_s": 95.0,
    },
    "verify": {"speedup": [3.0, 3.1, 2.9, 3.0], "rows": 4096},
    "meta": {"seed": 7},
}

_LEAVES = ("wall_s", "latency_ms", "per_s", "speedup", "rate", "rows", "count",
           "wait_us", "throughput", "seconds", "depth")


def _artifact(rng, depth=0):
    node = {}
    for _ in range(rng.randrange(2, 6)):
        key = rng.choice(_LEAVES) + ("_%d" % rng.randrange(3) if rng.random() < 0.3 else "")
        r = rng.random()
        if r < 0.25 and depth < 2:
            node[key] = _artifact(rng, depth + 1)
        elif r < 0.55:
            base = rng.uniform(0.001, 100.0)
            node[key] = [base * rng.uniform(0.9, 1.1) for _ in range(rng.randrange(1, 8))]
        elif r < 0.6:
            node[key] = [{"x_s": rng.uniform(1, 2)}, {"y": True}]
        elif r < 0.65:
            node[key] = 0
        else:
            node[key] = rng.choice((rng.uniform(0.001, 100.0), rng.randrange(1, 1000)))
    return node


def _mutate(rng, node):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out[k] = _mutate(rng, v)
        elif isinstance(v, list) and v and all(isinstance(x, float) for x in v):
            f = rng.choice((1.0, 0.5, 1.03, 1.5, 2.0))
            out[k] = [x * f for x in v] if rng.random() < 0.9 else v[:2]
        elif isinstance(v, (int, float)) and rng.random() < 0.5:
            out[k] = v * rng.choice((0.7, 1.0, 1.05, 1.4)) if v else rng.choice((0, 1.0))
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("seed", range(5))
def test_benchdiff_verdicts_equal_jax(seed):
    rng = random.Random(seed)
    old = _artifact(rng)
    new = _mutate(rng, old)
    paths = [p for p, _ in ref_benchdiff._walk(old)]
    gates = rng.sample(paths, min(len(paths), 2)) if paths else []
    old["benchdiff_gate"] = gates
    for kw in ({}, {"threshold": 0.2}, {"gates": gates[:1]}, {"gates": []}):
        got = benchdiff.compare(old, new, **kw)
        want = ref_benchdiff.compare(old, new, **kw)
        assert got == want
        assert benchdiff.render(got) == ref_benchdiff.render(want)


def test_benchdiff_gates_noise_and_cli_equal_jax(tmp_path, capsys):
    slow = copy.deepcopy(ARTIFACT)
    slow["consensus"]["block_wall_s"] = [v * 1.6 for v in slow["consensus"]["block_wall_s"]]
    scaled = copy.deepcopy(ARTIFACT)
    scaled["consensus"]["heights_per_s"] *= 0.5
    scaled["verify"]["rows"] = 0
    for new in (copy.deepcopy(ARTIFACT), slow, scaled):
        got = benchdiff.compare(ARTIFACT, new)
        assert got == ref_benchdiff.compare(ARTIFACT, new)
    assert benchdiff.compare(ARTIFACT, slow)["failed"]
    assert not benchdiff.compare(ARTIFACT, scaled)["failed"]
    for path in ("wall_s", "speedup", "block_count", "per_sec"):
        assert benchdiff._direction(path) == ref_benchdiff._direction(path)
    (tmp_path / "old.json").write_text(json.dumps(ARTIFACT))
    (tmp_path / "new.json").write_text(json.dumps(slow))
    outs = []
    for mod in (benchdiff, ref_benchdiff):
        for as_json in (False, True):
            rc = mod.main(tmp_path / "old.json", tmp_path / "new.json", as_json=as_json)
            outs.append((rc, capsys.readouterr().out))
    assert outs[:2] == outs[2:] and outs[0][0] == 1 and "FAIL" in outs[0][1]
    assert obs.benchdiff_compare is benchdiff.compare


# --------------------------------------------------- traced TCP nodes


def _wait(cond):
    end = time.monotonic() + DEADLINE
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out")
        time.sleep(0.005)


def test_traced_nodes_interoperate_and_merge_across_packages():
    # A port node (origin 1) and a JAX node (origin 2) stamp every frame;
    # each strips the other's stamps and marks trace.recv, so both
    # packages' merges pair every span.
    recs = [recorder.Recorder(threadsafe=True), ref_recorder.Recorder(threadsafe=True)]
    regs = [Registry(), RefRegistry()]
    port = TcpNode(obs=recs[0].scoped(-1), registry=regs[0],
                   trace=tracectx.TraceSource(1, obs=recs[0].scoped(-1)))
    jax = RefTcpNode(obs=recs[1].scoped(-1), registry=regs[1],
                     trace=ref_tracectx.TraceSource(2, obs=recs[1].scoped(-1)))
    nodes = (port, jax)
    try:
        port.add_peer("127.0.0.1", jax.port)
        jax.add_peer("127.0.0.1", port.port)
        for node in nodes:
            node.start()
        for h in (1, 2, 3):
            port.broadcast(Prevote(h, 0, b"\x01" * 32, b"\x02" * 32))
            jax.broadcast(RefPrevote(h, 0, b"\x01" * 32, b"\x02" * 32))

        def recvs(rec):
            return [e for e in rec.snapshot() if e.kind == "trace.recv"]

        _wait(lambda: all(len(recvs(r)) == 3 for r in recs))
    finally:
        for node in nodes:
            node.stop()
    journals = []
    for origin, rec in ((1, recs[0]), (2, recs[1])):
        sends = [e for e in rec.snapshot() if e.kind == "trace.send"]
        assert [e.detail for e in sends] == [f"{origin}:{s}" for s in (1, 2, 3)]
        assert [e.height for e in sends] == [1, 2, 3]
        assert sorted(e.height for e in recvs(rec)) == [1, 2, 3]
        journals.append(rec.journal(meta={"origin": origin}))
    got = merge.merge_journals(journals)
    want = ref_merge.merge_journals(journals)
    assert got == want and got["meta"]["orphans"] == []
    assert merge.merged_digest(got) == ref_merge.merged_digest(want)
    pairs = {}
    for ev in got["events"]:
        if ev[4] in ("trace.send", "trace.recv"):
            pairs.setdefault(ev[5], []).append(ev[4])
    assert len(pairs) == 6
    assert all(sorted(v) == ["trace.recv", "trace.send"] for v in pairs.values())
