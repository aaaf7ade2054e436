"""The port's observability (``hyperdrive_tpu_torch/obs``, ``utils/trace``,
the device-fetch tap) against the JAX package's.

The same seeded inputs go through both packages: the recorder's journal
(digest, saved bytes, a journal loaded across packages), the tracer's and
the registry's snapshots, digests and Prometheus text, the Perfetto trace
events, every report summary and table, the SLO verdicts, and observed
simulations on both delivery modes (lock-step, burst, pipelined burst),
compared by journal digest and metrics-snapshot digest. The JAX sides run
on the host (``HostVerifier``, n <= 16): nothing here jits.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.obs import metrics as ref_metrics
from hyperdrive_tpu.obs import perfetto as ref_perfetto
from hyperdrive_tpu.obs import recorder as ref_recorder
from hyperdrive_tpu.obs import report as ref_report
from hyperdrive_tpu.obs import slo as ref_slo
from hyperdrive_tpu.utils import trace as ref_trace
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch import obs
from hyperdrive_tpu_torch.analysis import annotations
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.obs import metrics, perfetto, recorder, report, slo
from hyperdrive_tpu_torch.utils import trace
from hyperdrive_tpu_torch.verifier import HostVerifier

torch.set_num_threads(1)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


# ------------------------------------------------------------- recorder


def _fill(rec_mod, seed, capacity=48):
    """A seeded journal of 64 events in a ring of ``capacity``."""
    rng = random.Random(seed)
    clock = FakeClock()
    rec = rec_mod.Recorder(capacity=capacity, time_fn=clock)
    kinds = sorted(rec_mod.EVENT_KINDS)
    for _ in range(64):
        clock.now += rng.choice((0.0, 0.001, 0.25))
        detail = rng.choice((None, rng.randrange(1000), "why-%d" % rng.randrange(9)))
        if rng.random() < 0.5:
            rec.emit(rng.choice(kinds), rng.randrange(-3, 4), rng.randrange(5),
                     rng.randrange(3), detail)
        else:
            rec.scoped(rng.randrange(4)).emit(rng.choice(kinds), rng.randrange(5),
                                              rng.randrange(3), detail)
    return rec


def test_recorder_journal_bytes_digest_and_cross_load(tmp_path):
    assert obs.EVENT_KINDS == ref_recorder.EVENT_KINDS
    assert recorder.JOURNAL_VERSION == ref_recorder.JOURNAL_VERSION
    got, want = _fill(recorder, 5), _fill(ref_recorder, 5)
    assert (got.total, got.dropped, len(got)) == (want.total, want.dropped, len(want))
    assert got.dropped == 16
    assert got.digest() == want.digest()
    got.save(tmp_path / "port.json", meta={"origin": 7})
    want.save(tmp_path / "ref.json", meta={"origin": 7})
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    # Each package loads the other's journal.
    a = recorder.load_journal(tmp_path / "ref.json")
    b = ref_recorder.load_journal(tmp_path / "port.json")
    assert [tuple(e) for e in a["events"]] == [tuple(e) for e in b["events"]]
    assert a["events"][0].kind == b["events"][0].kind and a["meta"] == {"origin": 7}
    # The disabled handles stay inert and shared.
    assert recorder.NULL_RECORDER.scoped(3) is recorder.NULL_BOUND
    recorder.NULL_BOUND.emit("commit", 1, 0)
    assert len(recorder.NULL_RECORDER) == 0
    with pytest.raises(ValueError):
        recorder.Recorder(capacity=0)


# ------------------------------------------------------ tracer, registry


def _trace_ops(mod, seed):
    rng = random.Random(seed)
    clock = FakeClock()
    t = mod.Tracer(time_fn=clock, threadsafe=bool(seed % 2))
    for _ in range(300):
        name = rng.choice(("a.count", "b.count", "c.lat", "d.lat"))
        if name.endswith("count"):
            t.count(name, rng.randrange(1, 4))
        elif rng.random() < 0.5:
            t.observe(name, rng.random() * 10 ** rng.randrange(-6, 3))
        else:
            with t.span(name):
                clock.now += rng.random()
    return t


def test_tracer_snapshot_and_render_equal_jax():
    for seed in (1, 2):
        got, want = _trace_ops(trace, seed), _trace_ops(ref_trace, seed)
        assert got.snapshot() == want.snapshot()
        assert got.render() == want.render()
    assert trace.NULL_TRACER.snapshot() == {"counters": {}, "histograms": {}}
    h = trace.Histogram(max_samples=4)
    for v in range(10):
        h.observe(float(v))
    assert h._samples == [8.0, 9.0, 6.0, 7.0] and h.quantile(1.0) == 9.0


def _registry_ops(mod, tmod, seed):
    rng = random.Random(seed)
    clock = FakeClock()
    reg = mod.Registry(time_fn=clock)
    other = mod.Registry(time_fn=clock)
    for r in (reg, other):
        for _ in range(120):
            op = rng.randrange(4)
            name = rng.choice(("x.count", "y.lat", "z.gauge"))
            # A series is labeled or not for its whole life.
            label = None
            if rng.random() < 0.4:
                label, name = "t%d" % rng.randrange(3), name + ".by"
            if op == 0:
                r.count("c." + name, rng.randrange(1, 5), label=label)
            elif op == 1:
                r.observe("h." + name, rng.random(), label=label)
            elif op == 2:
                r.set_gauge("g." + name, rng.randrange(100))
            else:
                with r.span("s." + name, label=label):
                    clock.now += rng.random()
    reg.merge(other)
    tr = _trace_ops(tmod, seed)
    reg.absorb_tracer(tr)
    return reg


def test_registry_snapshot_digest_and_prometheus_equal_jax():
    got = _registry_ops(metrics, trace, 3)
    want = _registry_ops(ref_metrics, ref_trace, 3)
    assert got.snapshot() == want.snapshot()
    assert got.digest() == want.digest()
    assert metrics.to_prometheus(got.snapshot()) == ref_metrics.to_prometheus(want.snapshot())
    a, b = trace.Histogram(), trace.Histogram()
    for v in (1e-5, 0.2, 3.0):
        a.observe(v)
        b.observe(v * 2)
    merged = metrics.merge_histograms(a, b)
    assert merged.total == 6 and merged.counts == [x + y for x, y in zip(a.counts, b.counts)]
    assert metrics.histogram_stats(merged)["count"] == 6
    with pytest.raises(ValueError):
        metrics.merge_histograms(a, trace.Histogram(buckets=(1.0,)))


# ------------------------------------------------------ observed sims

_SIMS = {
    # The reference's observed acceptance run (tests/test_obs.py).
    "lockstep": (dict(n=4, target_height=3, seed=91, timeout=20.0, delivery_cost=0.001),
                 None),
    "burst": (dict(n=4, target_height=3, seed=5, sign=True, burst=True,
                   dedup_verify=True), "host"),
    "pipelined": (dict(n=4, target_height=4, seed=5, sign=True, burst=True,
                       dedup_verify=True, pipeline_heights=True, pipeline_depth=3),
                  "host"),
    "tally": (dict(n=4, target_height=3, seed=5, burst=True, device_tally=True), None),
}

#: The reference's vote grid keeps f on the device and fetches it with the
#: counts; the port's f stays on the host, so that fetch has no
#: counterpart (ROADMAP Queue C). Every other event is the reference's.
_NO_COUNTERPART = "f rides the count fetch"


def _sims(case):
    kw, verifier = _SIMS[case]
    ref_kw = dict(kw, observe=True)
    kw = dict(kw, observe=True, device="cpu")
    if verifier:
        ref_kw["batch_verifier"] = RefHostVerifier()
        kw["batch_verifier"] = HostVerifier()
    ref = RefSimulation(**ref_kw)
    got = Simulation(**kw)
    return got, got.run(), ref, ref.run()


@pytest.fixture(scope="module")
def observed():
    return {case: _sims(case) for case in _SIMS}


@pytest.mark.parametrize("case", sorted(_SIMS))
def test_observed_sim_journal_and_metrics_equal_jax(observed, case):
    got, res, ref, ref_res = observed[case]
    assert res.completed and res.commit_digest() == ref_res.commit_digest()
    want = [e for e in ref.obs.snapshot() if e.detail != _NO_COUNTERPART]
    assert (got.obs.snapshot(), got.obs.dropped) == (want, ref.obs.dropped)
    skipped = len(ref.obs) - len(want)
    assert (skipped > 0) == (case == "tally")
    if not skipped:
        assert got.obs.digest() == ref.obs.digest()
    snap = got.metrics_snapshot()
    ref_snap = ref.metrics_snapshot()
    ref_snap["gauges"]["obs.recorder.total"] -= skipped
    assert snap == ref_snap
    if not skipped:
        assert got.registry.digest() == ref.registry.digest()
    # The gauge is read before the snapshot journals its own mark.
    assert snap["gauges"]["obs.recorder.total"] == got.obs.total - 1
    kinds = {e.kind for e in got.obs.snapshot()}
    assert kinds <= obs.EVENT_KINDS
    assert {"round.start", "commit", "metrics.snapshot"} <= kinds
    if case == "pipelined":
        assert {"sched.launch.begin", "sched.launch.end", "settle.speculative"} <= kinds
        assert [r.as_dict() for r in got.devtel.records] == [
            r.as_dict() for r in ref.devtel.records]
        assert snap["counters"]["devtel.launches"] == got._sched.launches


def test_observed_run_commits_the_unobserved_chain(observed):
    for case in ("lockstep", "pipelined"):
        got, res, _, _ = observed[case]
        kw, verifier = _SIMS[case]
        plain = Simulation(**kw, device="cpu",
                           **({"batch_verifier": HostVerifier()} if verifier else {}))
        assert plain.obs is recorder.NULL_RECORDER
        assert plain.replicas[0].obs is recorder.NULL_BOUND
        assert plain.replicas[0].proc.obs is recorder.NULL_BOUND
        unobserved = plain.run()
        assert len(plain.obs) == 0
        assert unobserved.commit_digest() == res.commit_digest()
        assert unobserved.steps == res.steps
        # The tracer is on either way and counts the same run (read off
        # the tracer: a snapshot of ``got`` would journal a mark into the
        # shared fixture's recorder).
        assert plain.metrics_snapshot()["counters"]["replica.commits"] == (
            got.tracer.counters["replica.commits"].value)


def test_trace_events_and_export_equal_jax(observed, tmp_path):
    for case in ("lockstep", "pipelined"):
        got, _, ref, _ = observed[case]
        events = got.obs.snapshot()
        assert perfetto.to_trace_events(events) == ref_perfetto.to_trace_events(
            ref.obs.snapshot())
        doc = obs.export(events, tmp_path / f"{case}.json")
        assert json.loads((tmp_path / f"{case}.json").read_text()) == doc
    device = [e for e in doc["traceEvents"] if e.get("tid") == obs.DEVICE_TID]
    assert any(e.get("ph") == "X" for e in device)


# ------------------------------------------------------- report, SLOs

#: Detail shapes the report's decoders parse, by kind family.
_DETAILS = (
    None, 0, 3, 17, "x", "lvl=2:new=5", "lvl=1:peer=3", "peer=2:lvl=0",
    "txs=12 applied=10 dev=1", "txs=4 applied=4 dev=0", "depth=3", "bytes=96",
    "targets=4 depth=5 full=1", "targets=2 depth=3 full=0", "rows=8 of=3/4",
    "a=1 b=2/3", "e2 min=1 max=9", "storm", "dup:3", "t1",
)


def _journal(seed, base_events):
    """The observed run's events with a seeded tail of every kind the
    report decodes (in time order), so each summary has rows."""
    rng = random.Random(seed)
    kinds = sorted(ref_recorder.EVENT_KINDS)
    events = list(base_events)
    ts = events[-1].ts if events else 0.0
    for _ in range(400):
        ts += rng.choice((0.0, 0.002, 0.05))
        kind = rng.choice(kinds)
        # The overload families carry counts.
        numeric = kind.split(".")[0] in ("load", "admission", "wire", "transport")
        events.append(ref_recorder.Event((
            ts, rng.randrange(-3, 4), rng.randrange(1, 5), rng.randrange(3), kind,
            rng.randrange(9) if numeric else rng.choice(_DETAILS),
        )))
    return events


def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the two packages must fail alike
        return ("raised", type(e).__name__)


def test_every_report_summary_and_table_equals_jax(observed):
    _, _, ref, _ = observed["pipelined"]
    lock = observed["lockstep"][2].obs.snapshot()
    names = [n for n in ref_report.__all__] + ["campaign_summary", "render_campaign_table"]
    assert sorted(names) == sorted(set(report.__all__) | {"campaign_summary",
                                                          "render_campaign_table"})
    for events in (lock, ref.obs.snapshot(), _journal(11, lock), _journal(12, [])):
        for name in names:
            if name.startswith("render_"):
                continue
            summary = name
            got = _call(getattr(report, summary), events)
            want = _call(getattr(ref_report, summary), events)
            assert got == want, summary
            table = {"anatomy": "render_table"}.get(
                summary, summary.replace("_summary", "").join(("render_", "_table")))
            if got[0] == "ok" and table in names:
                assert _call(getattr(report, table), got[1]) == _call(
                    getattr(ref_report, table), want[1]), table
    rows = report.anatomy(lock)
    assert rows and "propose" in report.render_table(rows)


def test_evaluate_slos_equals_jax(observed):
    got_sim, _, ref_sim, _ = observed["pipelined"]
    reg = metrics.Registry()
    ref_reg = ref_metrics.Registry()
    for v in (0.2, 0.4, 1.8):
        for r in (reg, ref_reg):
            r.observe("tenant.commit.latency", v, label="a")
            r.observe("tenant.commit.latency", v / 4, label="b")
    events = _journal(13, ref_sim.obs.snapshot())
    for objectives in (None, {"finality_p99": 0.5, "shed_rate": 0.9, "rollback_rate": 0.0}):
        rec = recorder.Recorder(capacity=16, time_fn=lambda: 0.0)
        ref_rec = ref_recorder.Recorder(capacity=16, time_fn=lambda: 0.0)
        got = slo.evaluate_slos(reg.snapshot(), events, objectives, obs=rec.scoped(-1))
        want = ref_slo.evaluate_slos(ref_reg.snapshot(), events, objectives,
                                     obs=ref_rec.scoped(-1))
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
        assert got and rec.digest() == ref_rec.digest()
    assert slo.DEFAULT_OBJECTIVES == ref_slo.DEFAULT_OBJECTIVES


# -------------------------------------------------- fetch tap, package


def test_device_fetch_taps_and_untapped_copy():
    t = torch.arange(6, dtype=torch.int32)
    out = annotations.device_fetch(t, why="plain")
    assert isinstance(out, np.ndarray) and out.tolist() == list(range(6))
    assert annotations.device_fetch([1, 2], why="list").tolist() == [1, 2]
    heard, probed = [], []

    class Probe:
        def fetch_begin(self, why):
            probed.append(("begin", why))

        def fetch_end(self, why):
            probed.append(("end", why))

    annotations.set_fetch_observer(heard.append)
    annotations.set_fetch_probe(Probe())
    try:
        assert annotations.device_fetch(t, why="mask").sum() == 15
    finally:
        annotations.set_fetch_observer(None)
        annotations.set_fetch_probe(None)
    assert heard == ["mask"] and probed == [("begin", "mask"), ("end", "mask")]
    assert annotations._tapped is False
    annotations.device_fetch(t, why="after")
    assert heard == ["mask"]


def test_later_names_raise_with_the_roadmap_item():
    # The names ROADMAP Queue A item 4b ported (they raised until then)
    # are the modules' own, and the package exports the reference's names.
    from hyperdrive_tpu import obs as ref_obs
    from hyperdrive_tpu_torch.obs import benchdiff, merge, tracectx

    assert obs.merge_journals is merge.merge_journals
    assert obs.encode_stamp is tracectx.encode_stamp
    assert obs.benchdiff_compare is benchdiff.compare
    assert obs.TraceSource is tracectx.TraceSource
    assert obs.__all__ == ref_obs.__all__
    with pytest.raises(AttributeError):
        obs.no_such_name  # noqa: B018
    assert set(obs.__all__) <= set(dir(obs))
