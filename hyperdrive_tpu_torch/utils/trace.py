"""Tracing and metrics: counters, latency histograms, spans, profiler hook.

- :class:`Counter` / :class:`Histogram` — cheap process-local metrics.
- :class:`Tracer` — a named registry of both, with ``span()`` context
  timing, injectable everywhere a reference Options struct carried a
  logger. The :data:`NULL_TRACER` singleton makes every call a no-op so
  un-instrumented hot paths pay one attribute check.
- :func:`profile` — wraps ``torch.profiler`` so the CUDA activity of a
  block (kernels, copies, syncs) lands as a Chrome trace in a directory.

Time sources are injectable: the deterministic harness passes its
VirtualClock so round latencies are measured in simulated seconds, exactly
reproducible across record/replay.

Port copy of ``hyperdrive_tpu/utils/trace.py``, whole, except
:func:`profile`, which traces with ``torch.profiler`` instead of
``jax.profiler``.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

__all__ = ["Counter", "Histogram", "Tracer", "NullTracer", "NULL_TRACER", "profile"]


class Counter:
    """A monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with exact quantiles over a bounded sample.

    Buckets follow a log-ish layout suited to latencies (seconds) and batch
    sizes. The most recent ``max_samples`` raw observations are kept for
    exact quantile queries; bucket counts never drop.
    """

    __slots__ = ("buckets", "counts", "total", "sum", "_samples", "_max_samples")

    DEFAULT_BUCKETS = (
        1e-6, 1e-5, 1e-4, 1e-3, 3e-3,
        1e-2, 3e-2, 0.1, 0.3, 1.0,
        3.0, 10.0, 30.0, 100.0, 1000.0,
    )

    def __init__(self, buckets=DEFAULT_BUCKETS, max_samples: int = 4096):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0
        self.sum = 0.0
        self._samples: list[float] = []
        self._max_samples = max_samples

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.total += 1
        self.sum += v
        if len(self._samples) < self._max_samples:
            self._samples.append(v)
        else:
            # Reservoir-less ring overwrite: cheap, recent-biased. This
            # observation is number ``total`` (post-increment), so it
            # lands in slot ``total - 1`` — keeping the retained window
            # exactly the most recent ``max_samples`` observations. (The
            # previous ``total % max`` indexing lagged the write slot by
            # one, so the oldest sample survived a full extra lap.)
            self._samples[(self.total - 1) % self._max_samples] = v

    def quantile(self, q: float) -> float:
        """Exact quantile over the retained sample window (0 if empty)."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(q * (len(s) - 1))))
        return s[idx]

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0


class Tracer:
    """Named registry of counters and histograms with span timing.

    ``time_fn`` defaults to ``time.perf_counter``; the simulator injects its
    virtual clock so traces are deterministic.
    """

    def __init__(self, time_fn: Optional[Callable[[], float]] = None,
                 threadsafe: bool = True):
        self.counters: dict[str, Counter] = {}
        self.histograms: dict[str, Histogram] = {}
        self._time = time_fn or time.perf_counter
        # One tracer is typically shared by many replicas, and replicas may
        # run on their own threads (Replica.run): updates lock by default.
        # A single-threaded caller (the simulator) passes threadsafe=False:
        # the per-call lock acquisition is the dominant cost of counting on
        # the hot path, and the GIL already serializes one-thread use.
        self._lock = threading.Lock() if threadsafe else None

    # ------------------------------------------------------------- recording

    def count(self, name: str, n: int = 1) -> None:
        lock = self._lock
        if lock is None:
            c = self.counters.get(name)
            if c is None:
                c = self.counters[name] = Counter()
            c.inc(n)
            return
        with lock:
            c = self.counters.get(name)
            if c is None:
                c = self.counters[name] = Counter()
            c.inc(n)

    def observe(self, name: str, v: float) -> None:
        lock = self._lock
        if lock is None:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram()
            h.observe(v)
            return
        with lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram()
            h.observe(v)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time a block into histogram ``name`` (seconds)."""
        t0 = self._time()
        try:
            yield
        finally:
            self.observe(name, self._time() - t0)

    def now(self) -> float:
        return self._time()

    # ------------------------------------------------------------- reporting

    def snapshot(self) -> dict:
        """A JSON-friendly view of everything recorded."""
        out: dict = {"counters": {}, "histograms": {}}
        for name, c in sorted(self.counters.items()):
            out["counters"][name] = c.value
        for name, h in sorted(self.histograms.items()):
            out["histograms"][name] = {
                "count": h.total,
                "mean": h.mean,
                "p50": h.quantile(0.50),
                "p95": h.quantile(0.95),
                "p99": h.quantile(0.99),
            }
        return out

    def render(self) -> str:
        """Human-readable table of the snapshot."""
        snap = self.snapshot()
        lines = []
        if snap["counters"]:
            width = max(len(k) for k in snap["counters"])
            lines.append("counters:")
            for k, v in snap["counters"].items():
                lines.append(f"  {k:<{width}}  {v}")
        if snap["histograms"]:
            lines.append("histograms (count / mean / p50 / p95 / p99):")
            width = max(len(k) for k in snap["histograms"])
            for k, h in snap["histograms"].items():
                lines.append(
                    f"  {k:<{width}}  {h['count']:>8}  {h['mean']:.6g}  "
                    f"{h['p50']:.6g}  {h['p95']:.6g}  {h['p99']:.6g}"
                )
        return "\n".join(lines)


class NullTracer(Tracer):
    """All recording is a no-op; reporting returns empty structures."""

    def __init__(self):
        super().__init__(time_fn=lambda: 0.0)

    def count(self, name: str, n: int = 1) -> None:
        pass

    def observe(self, name: str, v: float) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        yield


#: Shared no-op tracer — the default everywhere a tracer is injectable.
NULL_TRACER = NullTracer()


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write it as a Chrome trace,
    ``trace.json`` in ``log_dir`` (created if missing), which
    chrome://tracing and ui.perfetto.dev load. The path written is
    ``profile.last_path`` afterwards. Runs that raise inside the block
    write nothing."""
    import os

    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    profile.last_path = path


profile.last_path = None
