"""Uniform metrics registry: counters, gauges, mergeable histograms.

The Tracer (utils/trace.py) grew ad-hoc per-subsystem counters and
histograms; this module is the one registry every surface exports
through — the simulator's ``metrics_snapshot()``, the bench artifacts,
and the device-telemetry probe (obs/devtel.py) all speak :meth:`Registry.snapshot`. Three shapes only:

- **counter** — monotone int (``Counter``, shared with the tracer).
- **gauge** — last-write-wins scalar (queue depth, occupancy).
- **histogram** — the tracer's fixed-bucket :class:`~hyperdrive_tpu_torch.
  utils.trace.Histogram`, extended here with :func:`merge_histograms`
  so per-replica / per-tenant histograms aggregate losslessly at the
  bucket level (sample windows concatenate, recent-biased).

Labels are a single optional dimension (``observe(name, v,
label=...)``): the metric NAME stays a static literal — HD005 polices
that — while the label carries the per-tenant / per-replica key, so
the registry never unbounds on interpolated names.

Determinism contract: a registry timed by the sim's VirtualClock
snapshots to byte-identical JSON across fixed-seed runs
(:meth:`Registry.digest`), exactly like the flight recorder's journal.
Everything here is stdlib-only — no jax import, safe for analysis
tooling and pure-host deployments.

Port copy of ``hyperdrive_tpu/obs/metrics.py``, whole; a registry
snapshot and its ``digest()`` equal the reference's for the same series.
"""

from __future__ import annotations

import hashlib
import json
import time

from hyperdrive_tpu_torch.utils.trace import Counter, Histogram

__all__ = [
    "Gauge",
    "Registry",
    "merge_histograms",
    "histogram_stats",
    "to_prometheus",
]

#: Quantiles every histogram snapshot reports, in snapshot key order.
QUANTILES = ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))


class Gauge:
    """A last-write-wins scalar (depth, occupancy %, table generation)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


def merge_histograms(a: Histogram, b: Histogram) -> Histogram:
    """A new histogram holding both inputs' observations.

    Bucket counts, totals and sums add exactly; the bounded sample
    windows concatenate and keep the most recent ``max_samples`` (the
    same recent bias a single histogram's ring overwrite has), so
    quantiles over the merge stay exact within the retained window.
    Bucket ladders must agree — mixing ladders would mis-bin counts.
    """
    if a.buckets != b.buckets:
        raise ValueError("cannot merge histograms with different buckets")
    out = Histogram(buckets=a.buckets, max_samples=a._max_samples)
    out.counts = [x + y for x, y in zip(a.counts, b.counts)]
    out.total = a.total + b.total
    out.sum = a.sum + b.sum
    out._samples = (list(a._samples) + list(b._samples))[-out._max_samples:]
    return out


def histogram_stats(h: Histogram) -> dict:
    """The snapshot row for one histogram: count/sum/mean + quantiles."""
    row = {"count": h.total, "sum": h.sum, "mean": h.mean}
    for q, key in QUANTILES:
        row[key] = h.quantile(q)
    return row


class Registry:
    """Named counters, gauges, and histograms with one label dimension.

    ``time_fn`` feeds :meth:`span` timing; the sim injects its virtual
    clock so spans (and therefore snapshots) are deterministic, while
    standalone deployments default to ``time.perf_counter``.

    The registry is single-writer by design (the sim and the device
    queue are single-threaded); cross-thread aggregation composes via
    :meth:`merge` on thread-local registries instead of a hot-path lock.
    """

    def __init__(self, time_fn=None):
        self._time = time_fn or time.perf_counter
        self.counters: dict = {}      # name -> Counter | {label: Counter}
        self.gauges: dict = {}        # name -> Gauge
        self.histograms: dict = {}    # name -> Histogram | {label: Histogram}
        #: Names whose value dict is keyed by label (one level).
        self._labeled: set = set()

    # ---------------------------------------------------------- recording

    def now(self) -> float:
        return self._time()

    def count(self, name: str, n: int = 1, label=None) -> None:
        table = self.counters
        if label is not None:
            self._labeled.add(name)
            table = table.setdefault(name, {})
            name = label
        c = table.get(name)
        if c is None:
            c = table[name] = Counter()
        c.inc(n)

    def set_gauge(self, name: str, v) -> None:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        g.set(v)

    def observe(self, name: str, v: float, label=None) -> None:
        table = self.histograms
        if label is not None:
            self._labeled.add(name)
            table = table.setdefault(name, {})
            name = label
        h = table.get(name)
        if h is None:
            h = table[name] = Histogram()
        h.observe(v)

    def span(self, name: str, label=None):
        """Context manager timing a block into histogram ``name``."""
        return _Span(self, name, label)

    # -------------------------------------------------------- aggregation

    def absorb_tracer(self, tracer, overwrite: bool = True) -> None:
        """Adopt a Tracer's counters and histograms by reference.

        This is the absorb seam: a sim's ``sim.*`` / ``replica.*``
        tracer series appear in the registry snapshot without copying —
        the registry holds the SAME Counter/Histogram objects, so later
        tracer updates are visible too. Existing registry entries of the
        same name are replaced when ``overwrite`` (the tracer is the
        source of truth for its own names).
        """
        for name, c in tracer.counters.items():
            if overwrite or name not in self.counters:
                self.counters[name] = c
        for name, h in tracer.histograms.items():
            if overwrite or name not in self.histograms:
                self.histograms[name] = h

    def merge(self, other: "Registry") -> None:
        """Fold ``other`` into this registry (cross-replica/tenant
        aggregation): counters add, gauges last-write-win, histograms
        merge at the bucket level."""
        for name, c in other.counters.items():
            if isinstance(c, dict):
                self._labeled.add(name)
                mine = self.counters.setdefault(name, {})
                for label, lc in c.items():
                    got = mine.get(label)
                    if got is None:
                        got = mine[label] = Counter()
                    got.inc(lc.value)
            else:
                got = self.counters.get(name)
                if got is None or isinstance(got, dict):
                    got = self.counters[name] = Counter()
                got.inc(c.value)
        for name, g in other.gauges.items():
            self.set_gauge(name, g.value)
        for name, h in other.histograms.items():
            if isinstance(h, dict):
                self._labeled.add(name)
                mine = self.histograms.setdefault(name, {})
                for label, lh in h.items():
                    mine[label] = (
                        merge_histograms(mine[label], lh)
                        if label in mine else lh
                    )
            else:
                got = self.histograms.get(name)
                self.histograms[name] = (
                    merge_histograms(got, h)
                    if isinstance(got, Histogram) else h
                )

    # ---------------------------------------------------------- reporting

    def snapshot(self) -> dict:
        """JSON-ready view: sorted names, labeled series nested."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self.counters, key=str):
            c = self.counters[name]
            if isinstance(c, dict):
                out["counters"][name] = {
                    str(k): c[k].value for k in sorted(c, key=str)
                }
            else:
                out["counters"][name] = c.value
        for name in sorted(self.gauges, key=str):
            out["gauges"][name] = self.gauges[name].value
        for name in sorted(self.histograms, key=str):
            h = self.histograms[name]
            if isinstance(h, dict):
                out["histograms"][name] = {
                    str(k): histogram_stats(h[k]) for k in sorted(h, key=str)
                }
            else:
                out["histograms"][name] = histogram_stats(h)
        return out

    def digest(self) -> str:
        """sha256 of the canonical snapshot JSON — the determinism
        check: two fixed-seed sim runs must agree byte-for-byte."""
        blob = json.dumps(
            self.snapshot(), separators=(",", ":"), sort_keys=True
        ).encode()
        return hashlib.sha256(blob).hexdigest()


class _Span:
    __slots__ = ("_reg", "_name", "_label", "_t0")

    def __init__(self, reg, name, label):
        self._reg = reg
        self._name = name
        self._label = label

    def __enter__(self):
        self._t0 = self._reg.now()
        return self

    def __exit__(self, *exc):
        self._reg.observe(
            self._name, self._reg.now() - self._t0, label=self._label
        )
        return False


# ------------------------------------------------------------ prometheus


def _prom_name(name: str) -> str:
    return "hd_" + "".join(
        ch if ch.isalnum() or ch == "_" else "_" for ch in name
    )


def _prom_label(label) -> str:
    return str(label).replace("\\", "\\\\").replace('"', '\\"')


def to_prometheus(snapshot: dict) -> str:
    """Render a :meth:`Registry.snapshot` dict as Prometheus text
    exposition format (counters, gauges, and summary-style histograms
    with quantile labels). Pure function of the snapshot, so a saved
    JSON snapshot re-renders without the live registry."""
    lines: list = []
    for name, v in snapshot.get("counters", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        if isinstance(v, dict):
            for label, lv in v.items():
                lines.append(f'{pn}{{label="{_prom_label(label)}"}} {lv}')
        else:
            lines.append(f"{pn} {v}")
    for name, v in snapshot.get("gauges", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    for name, v in snapshot.get("histograms", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        rows = v.items() if "count" not in v else [(None, v)]
        for label, stats in rows:
            sel = f'label="{_prom_label(label)}",' if label is not None else ""
            for _, qkey in QUANTILES:
                lines.append(
                    f'{pn}{{{sel}quantile="{qkey[1:]}"}} {stats[qkey]}'
                )
            base = f'{{label="{_prom_label(label)}"}}' if label is not None else ""
            lines.append(f"{pn}_sum{base} {stats['sum']}")
            lines.append(f"{pn}_count{base} {stats['count']}")
    return "\n".join(lines) + "\n"
