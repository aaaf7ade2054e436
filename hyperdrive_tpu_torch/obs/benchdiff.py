"""Perf-regression sentinel: diff two bench JSON artifacts.

:func:`compare` walks two bench artifacts in parallel, pairs up every
numeric leaf and numeric series, and decides — with noise bounds derived from the data itself —
whether NEW regressed relative to OLD. Exit status is nonzero iff a
*gated* metric regressed, so CI can pin a committed baseline and fail
the build on a real slowdown without flaking on runner jitter.

Three design points keep the sentinel honest:

**Medians over means.** A per-block series (``block_wall_s`` etc.)
compares by median, which a single GC pause or cold-start outlier
cannot move. Scalars compare directly but get wider default bounds.

**Noise bounds from the series.** The tolerance for a series is
``max(threshold, NOISE_K * MAD/median)`` — the artifact's own run-to-run
scatter (median absolute deviation) sets the floor, so a naturally
noisy metric doesn't page and a rock-stable one is held tight.

**Machine-portable gates.** Absolute numbers differ across runners, so
hard failure is reserved for paths the artifact itself nominates under
a top-level ``benchdiff_gate`` list (dotted paths, NEW's list wins).
Everything else is reported informationally. Ratio-style metrics
(speedups, relative throughput) make the best gates because they
divide the runner's speed out.

Port copy of ``hyperdrive_tpu/obs/benchdiff.py``, whole (pure host
code: the same inputs give the same verdict). Its ``python -m`` CLI
face waits for ROADMAP Queue A item 6; :func:`main` is its body.

Direction is inferred from the metric name: throughput-like names
(``per_s``, ``speedup``, ``rate``, ``throughput``, ``ops``) are
higher-is-better; time-like names (``wall``, ``latency``, ``_s``,
``seconds``, ``wait``, ``time``) are lower-is-better; anything else is
compared as lower-is-better only when gated, informational otherwise.
"""

from __future__ import annotations

import json

__all__ = ["compare", "render", "main"]

#: Default relative tolerance for an ungated/low-noise metric.
DEFAULT_THRESHOLD = 0.08

#: Scatter multiplier: a series' noise bound is NOISE_K robust
#: coefficient-of-variations (MAD/median), so ~NOISE_K-sigma moves gate.
NOISE_K = 4.0

_HIGHER = ("per_s", "speedup", "rate", "throughput", "ops", "per_sec")
_LOWER = ("wall", "latency", "seconds", "wait", "time", "_s", "_us", "_ms")


def _direction(path):
    """+1 higher-is-better, -1 lower-is-better, 0 unknown."""
    leaf = path.rsplit(".", 1)[-1].lower()
    for pat in _HIGHER:
        if pat in leaf:
            return 1
    for pat in _LOWER:
        if pat in leaf:
            return -1
    return 0


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _walk(node, prefix=""):
    """Yield (dotted_path, value) for numeric leaves and numeric series."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(node, list):
        if node and all(_is_num(v) for v in node):
            yield prefix, node
        else:
            for i, v in enumerate(node):
                yield from _walk(v, f"{prefix}[{i}]")
    elif _is_num(node):
        yield prefix, node


def _median(vals):
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _series_stats(vals):
    """(median, mad) of a numeric series."""
    med = _median(vals)
    mad = _median([abs(v - med) for v in vals])
    return med, mad


def compare(old, new, threshold=DEFAULT_THRESHOLD, gates=None):
    """Diff two bench artifacts (parsed JSON), return the verdict dict.

    ``gates``: iterable of dotted paths that hard-fail on regression;
    defaults to NEW's top-level ``benchdiff_gate`` list (falling back
    to OLD's). A gate path matches a metric if it equals the metric's
    path or is a prefix of it (so ``consensus`` gates every metric
    under that subtree).
    """
    if gates is None:
        gates = new.get("benchdiff_gate", old.get("benchdiff_gate", []))
    gates = list(gates or [])

    def gated(path):
        return any(
            path == g or path.startswith(g + ".") or path.startswith(g + "[")
            for g in gates
        )

    old_metrics = dict(_walk(old))
    new_metrics = dict(_walk(new))
    regressions, improvements, ok, skipped = [], [], [], []

    for path in sorted(set(old_metrics) & set(new_metrics)):
        if path == "benchdiff_gate" or path.startswith("benchdiff_gate"):
            continue
        ov, nv = old_metrics[path], new_metrics[path]
        is_series = isinstance(ov, list)
        if is_series != isinstance(nv, list):
            skipped.append({"path": path, "reason": "shape-mismatch"})
            continue
        bound = threshold
        if is_series:
            if len(ov) < 3 or len(nv) < 3:
                skipped.append({"path": path, "reason": "short-series"})
                continue
            o_med, o_mad = _series_stats(ov)
            n_med, _ = _series_stats(nv)
            if o_med:
                bound = max(threshold, NOISE_K * o_mad / abs(o_med))
            ov, nv = o_med, n_med
        direction = _direction(path)
        if direction == 0 and not gated(path):
            skipped.append({"path": path, "reason": "direction-unknown"})
            continue
        if direction == 0:
            direction = -1  # gated but nameless: assume lower-is-better
        if ov == 0:
            if nv == 0:
                ok.append({"path": path, "old": ov, "new": nv, "ratio": 1.0})
                continue
            skipped.append({"path": path, "reason": "zero-baseline"})
            continue
        ratio = nv / ov
        # Normalize so delta > 0 always means "got worse".
        delta = (ratio - 1.0) if direction < 0 else (1.0 - ratio)
        entry = {
            "path": path,
            "old": ov,
            "new": nv,
            "ratio": ratio,
            "delta": delta,
            "bound": bound,
            "gated": gated(path),
            "series": is_series,
        }
        if delta > bound:
            regressions.append(entry)
        elif delta < -bound:
            improvements.append(entry)
        else:
            ok.append(entry)

    gated_regressions = [e for e in regressions if e["gated"]]
    return {
        "regressions": regressions,
        "gated_regressions": gated_regressions,
        "improvements": improvements,
        "ok": ok,
        "skipped": skipped,
        "gates": gates,
        "failed": bool(gated_regressions),
    }


def render(verdict):
    """Human-readable sentinel report lines."""
    lines = []

    def fmt(e, tag):
        flag = " [GATED]" if e.get("gated") else ""
        kind = "median" if e.get("series") else "value"
        lines.append(
            f"{tag}{flag} {e['path']}: {kind} {e['old']:.6g} -> "
            f"{e['new']:.6g} (delta {e['delta']:+.1%}, "
            f"bound {e['bound']:.1%})"
        )

    for e in verdict["regressions"]:
        fmt(e, "REGRESSION")
    for e in verdict["improvements"]:
        fmt(e, "improved  ")
    lines.append(
        f"{len(verdict['ok'])} ok, "
        f"{len(verdict['improvements'])} improved, "
        f"{len(verdict['regressions'])} regressed "
        f"({len(verdict['gated_regressions'])} gated), "
        f"{len(verdict['skipped'])} skipped"
    )
    if verdict["failed"]:
        lines.append("FAIL: gated perf regression")
    else:
        lines.append("PASS")
    return "\n".join(lines)


def main(old_path, new_path, threshold=DEFAULT_THRESHOLD, gates=None,
         as_json=False):
    """CLI entry: returns the process exit code."""
    with open(old_path) as fh:
        old = json.load(fh)
    with open(new_path) as fh:
        new = json.load(fh)
    verdict = compare(old, new, threshold=threshold, gates=gates)
    if as_json:
        print(json.dumps(verdict, indent=1))
    else:
        print(render(verdict))
    return 1 if verdict["failed"] else 0
