"""Journal merge + clock alignment: N per-process journals, one stream.

Every process on the mesh — the serving host, each remote tenant, each
deployment process — records its own flight-recorder journal
on its own clock. This module folds them into ONE causally-consistent
stream:

1. **pid stamping** — every event gains a seventh slot, the process's
   trace origin id (:class:`~hyperdrive_tpu_torch.obs.recorder.Event.pid`),
   so one stream can carry all processes without losing attribution.
2. **clock alignment** — per-process wall-clock offsets are estimated
   from the ``trace.offset`` events the HELLO echo handshake produced
   (client-side NTP: ``offset ≈ t1 - (t0 + t3) / 2``). The offset
   graph is walked breadth-first from the lowest origin id, so any
   connected mesh aligns to one reference clock; a process with no
   handshake path keeps its own clock (offset 0). Virtual-clock runs
   have no offset events at all, so fixed-seed sim journals merge
   EXACTLY — two runs' merged journals stay digest-identical.
3. **causal clamp** — after alignment, a ``trace.recv`` is never
   allowed to precede its matching ``trace.send`` (clock estimation
   error cannot invert causality in the merged order); a recv whose
   send appears in NO journal is an **orphaned span** — flagged in the
   merged meta, never dropped (a partition-torn run keeps its
   evidence).

The merged file round-trips through
:func:`~hyperdrive_tpu_torch.obs.recorder.load_journal` unchanged and
feeds :func:`~hyperdrive_tpu_torch.obs.report.critical_path_summary`
and the Perfetto exporter's per-process tracks.

Port copy of ``hyperdrive_tpu/obs/merge.py``, whole: a merged journal
and its :func:`merged_digest` are the JAX package's for the same input
journals. The ``python -m`` CLI face waits for ROADMAP Queue A item 6.
"""

from __future__ import annotations

import hashlib
import json

from hyperdrive_tpu_torch.obs.recorder import JOURNAL_VERSION, Event

__all__ = [
    "estimate_offsets",
    "merge_journals",
    "merged_digest",
    "save_merged",
]


def _journal_origin(journal: dict, position: int) -> int:
    """The journal's trace origin id: the recorded meta wins, else a
    deterministic 1-based position (stand-alone journals merged by
    hand still get distinct pids)."""
    meta = journal.get("meta") or {}
    origin = meta.get("origin")
    return int(origin) if origin else position + 1


def estimate_offsets(journals_by_origin: dict) -> dict:
    """origin -> seconds to ADD to that process's timestamps so every
    journal reads on one reference clock.

    Each ``trace.offset`` event in origin A's journal (detail
    ``"B:offset"``) asserts ``clock_B ≈ clock_A + offset``. Offsets
    compose along the resulting undirected graph; the reference is the
    lowest origin id in each connected component (deterministic across
    runs — never dict order). Conflicting estimates for one edge
    average; unreachable processes stay at 0.0.
    """
    edges: dict = {}
    for origin, events in journals_by_origin.items():
        for ev in events:
            if ev[4] != "trace.offset" or not ev[5]:
                continue
            peer_s, _, off_s = str(ev[5]).partition(":")
            try:
                peer, off = int(peer_s), float(off_s)
            except ValueError:
                continue
            edges.setdefault(origin, {}).setdefault(peer, []).append(off)
            edges.setdefault(peer, {}).setdefault(origin, []).append(-off)
    deltas = {origin: 0.0 for origin in journals_by_origin}
    seen: set = set()
    for root in sorted(journals_by_origin):
        if root in seen:
            continue
        seen.add(root)
        frontier = [root]
        while frontier:
            nxt = []
            for a in frontier:
                for b, offs in sorted(edges.get(a, {}).items()):
                    if b in seen or b not in deltas:
                        continue
                    seen.add(b)
                    # clock_b = clock_a + off  →  to map b onto the
                    # reference: delta_b = delta_a - off.
                    off = sum(offs) / len(offs)
                    deltas[b] = deltas[a] - off
                    nxt.append(b)
            frontier = nxt
    return deltas


def merge_journals(journals) -> dict:
    """Fold journal dicts (:func:`load_journal` output) into one merged
    journal dict: version 1, 7-slot events ordered on the aligned
    clock, and a meta block recording origins, the offset estimates,
    and any orphaned receive spans."""
    by_origin: dict = {}
    capacity = 0
    total = 0
    dropped = 0
    for i, journal in enumerate(journals):
        origin = _journal_origin(journal, i)
        if origin in by_origin:
            raise ValueError(f"duplicate journal origin {origin}")
        by_origin[origin] = journal["events"]
        capacity += journal.get("capacity", 0)
        total += journal.get("total", len(journal["events"]))
        dropped += journal.get("dropped", 0)
    deltas = estimate_offsets(by_origin)
    # Pair spans FIRST (on raw per-journal streams): span key ->
    # aligned send ts, so the causal clamp below can pin receives.
    send_ts: dict = {}
    for origin, events in by_origin.items():
        delta = deltas[origin]
        for ev in events:
            if ev[4] == "trace.send" and ev[5]:
                key = str(ev[5])
                ts = ev[0] + delta
                if key not in send_ts or ts < send_ts[key]:
                    send_ts[key] = ts
    merged = []
    orphans = []
    for origin in sorted(by_origin):
        delta = deltas[origin]
        for idx, ev in enumerate(by_origin[origin]):
            ts = ev[0] + delta
            if ev[4] == "trace.recv" and ev[5]:
                sent = send_ts.get(str(ev[5]))
                if sent is None:
                    # Partition-torn span: the sender's journal never
                    # made it here. Keep the event, flag the span.
                    orphans.append(f"{origin}<-{ev[5]}")
                elif ts < sent:
                    ts = sent  # causality beats clock estimation
            merged.append(
                (ts, Event((ts, ev[1], ev[2], ev[3], ev[4], ev[5],
                            origin)), origin, idx)
            )
    merged.sort(key=lambda item: (item[0], item[2], item[3]))
    return {
        "version": JOURNAL_VERSION,
        "capacity": capacity,
        "total": total,
        "dropped": dropped,
        "events": [list(item[1]) for item in merged],
        "meta": {
            "merged": True,
            "origins": sorted(by_origin),
            "offsets": {str(o): deltas[o] for o in sorted(deltas)},
            "orphans": sorted(orphans),
        },
    }


def merged_digest(merged: dict) -> str:
    """sha256 over the canonical JSON encoding of the merged events —
    the same shape :meth:`Recorder.digest` hashes, so two fixed-seed
    multi-process runs must agree here."""
    blob = json.dumps(
        [list(ev) for ev in merged["events"]],
        separators=(",", ":"),
        sort_keys=False,
    ).encode()
    return hashlib.sha256(blob).hexdigest()


def save_merged(merged: dict, path) -> None:
    with open(path, "w") as fh:
        json.dump(merged, fh, separators=(",", ":"))
        fh.write("\n")
