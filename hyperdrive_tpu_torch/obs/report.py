"""Round-anatomy report: decompose each committed height into phases.

Reads a recorder journal (live snapshot or one loaded from disk) and,
per (replica, height), reconstructs the commit's latency anatomy:

  propose   round.start      -> step.prevoting     (proposal wait+verify)
  prevote   step.prevoting   -> step.precommitting (prevote quorum)
  precommit step.precommitting -> commit           (precommit quorum)

A height that needed several rounds attributes the phases of the round
that actually committed, and the time burned in earlier rounds shows up
as ``stall`` (round.start of round 0 -> round.start of the committing
round). Outlier flags mark the interesting rows: extra rounds,
timeout-driven progress, and totals far above the run median.

Port copy of ``hyperdrive_tpu/obs/report.py``, whole: every summary is
a pure function of the events, so each one reads a journal of either
package.
"""

from __future__ import annotations

__all__ = [
    "anatomy",
    "phase_summary",
    "render_table",
    "tenant_summary",
    "render_tenant_table",
    "overload_summary",
    "render_overload_table",
    "overlay_summary",
    "render_overlay_table",
    "exec_summary",
    "render_exec_table",
    "proofs_summary",
    "render_proofs_table",
    "critical_path_summary",
    "render_critical_path_table",
]

_TIMEOUT_FIRES = (
    "timeout.propose.fired",
    "timeout.prevote.fired",
    "timeout.precommit.fired",
)


def anatomy(events):
    """Per-(replica, height) commit anatomy rows, sorted.

    ``events`` is an iterable of Event tuples (ts, replica, height,
    round, kind, detail). Returns a list of dict rows; heights that
    never committed in the journal window are omitted.
    """
    # Pass 1: index the marker events per (replica, height).
    marks = {}  # (replica, height) -> state dict

    def st(ev):
        key = (ev[1], ev[2])
        s = marks.get(key)
        if s is None:
            s = {
                "round_start": {},  # round -> ts of first round.start
                "prevoting": {},  # round -> ts
                "precommitting": {},  # round -> ts
                "commit": None,  # (ts, round, detail)
                "timeouts": 0,
                "equivocations": 0,
                "skips": 0,
            }
            marks[key] = s
        return s

    for ev in events:
        kind = ev[4]
        if kind == "round.start":
            s = st(ev)
            s["round_start"].setdefault(ev[3], ev[0])
        elif kind == "step.prevoting":
            s = st(ev)
            s["prevoting"].setdefault(ev[3], ev[0])
        elif kind == "step.precommitting":
            s = st(ev)
            s["precommitting"].setdefault(ev[3], ev[0])
        elif kind == "commit":
            s = st(ev)
            if s["commit"] is None:
                s["commit"] = (ev[0], ev[3], ev[5])
        elif kind in _TIMEOUT_FIRES:
            st(ev)["timeouts"] += 1
        elif kind == "equivocation":
            st(ev)["equivocations"] += 1
        elif kind == "round.skip":
            st(ev)["skips"] += 1

    # Pass 2: committed heights -> anatomy rows.
    rows = []
    for (replica, height), s in marks.items():
        if s["commit"] is None:
            continue
        t_commit, commit_round, detail = s["commit"]
        r0 = s["round_start"].get(0)
        rstart = s["round_start"].get(commit_round)
        tpv = s["prevoting"].get(commit_round)
        tpc = s["precommitting"].get(commit_round)

        def dur(a, b):
            if a is None or b is None:
                return None
            return max(0.0, b - a)

        total = dur(r0 if r0 is not None else rstart, t_commit)
        rows.append(
            {
                "replica": replica,
                "height": height,
                "rounds": commit_round + 1,
                "propose_s": dur(rstart, tpv),
                "prevote_s": dur(tpv, tpc),
                "precommit_s": dur(tpc, t_commit),
                "stall_s": dur(r0, rstart) if commit_round > 0 else 0.0,
                "total_s": total,
                "timeouts": s["timeouts"],
                "equivocations": s["equivocations"],
                "skips": s["skips"],
                "value": detail,
            }
        )
    rows.sort(key=lambda r: (r["height"], r["replica"]))

    # Pass 3: outlier flags need the run median.
    totals = sorted(r["total_s"] for r in rows if r["total_s"] is not None)
    median = totals[len(totals) // 2] if totals else 0.0
    for r in rows:
        flags = []
        if r["rounds"] > 1:
            flags.append("extra-rounds")
        if r["timeouts"] > 0:
            flags.append("timeout-driven")
        if (
            median > 0.0
            and r["total_s"] is not None
            and r["total_s"] > 3.0 * median
        ):
            flags.append("slow")
        if r["equivocations"] > 0:
            flags.append("equivocation")
        r["flags"] = flags
    return rows


def phase_summary(events):
    """Aggregate commit-latency breakdown for bench artifact embedding.

    Means over all committed (replica, height) rows, in journal time
    units (virtual seconds in the sim).
    """
    rows = anatomy(events)
    if not rows:
        return {"commits": 0}

    def mean_of(key):
        vals = [r[key] for r in rows if r[key] is not None]
        return (sum(vals) / len(vals)) if vals else None

    return {
        "commits": len(rows),
        "mean_rounds": sum(r["rounds"] for r in rows) / len(rows),
        "mean_propose_s": mean_of("propose_s"),
        "mean_prevote_s": mean_of("prevote_s"),
        "mean_precommit_s": mean_of("precommit_s"),
        "mean_stall_s": mean_of("stall_s"),
        "mean_total_s": mean_of("total_s"),
        "timeout_driven": sum(1 for r in rows if r["timeouts"] > 0),
        "extra_round_commits": sum(1 for r in rows if r["rounds"] > 1),
    }


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def tenant_summary(events):
    """Per-origin (tenant/replica) device-launch latency rows.

    Reconstructed purely from ``sched.launch.*`` journal events
    (obs/devtel.py), so it works on saved journals with no live
    registry: a command's *verify* latency is submit ts -> the end ts
    of the launch that carried it, and its *commit* latency extends to
    the ``sched.launch.commit`` event naming that launch. Rows are one
    per origin track (tenant id under ShardVerifyService, replica /
    -1 sim under the scheduler), with p50/p95 over the run.
    """
    submits = {}  # seq -> (origin, ts)
    seq_launch = {}  # seq -> launch_id
    launch_end = {}  # launch_id -> end ts
    commit_ts = {}  # launch_id -> [commit ts, ...]
    open_id = None
    for ev in events:
        ts, origin, kind, detail = ev[0], ev[1], ev[4], ev[5]
        if kind == "sched.launch.submit":
            submits[detail] = (origin, ts)
        elif kind == "sched.launch.begin":
            open_id = detail
        elif kind == "sched.launch.cmd":
            if open_id is not None:
                seq_launch[detail] = open_id
        elif kind == "sched.launch.end":
            if open_id is not None:
                launch_end[open_id] = ts
                open_id = None
        elif kind == "sched.launch.commit":
            commit_ts.setdefault(detail, []).append(ts)

    per = {}  # origin -> state

    def row(origin):
        r = per.get(origin)
        if r is None:
            r = {"submits": 0, "launches": set(), "verify": [], "commit": []}
            per[origin] = r
        return r

    for seq, (origin, t0) in submits.items():
        r = row(origin)
        r["submits"] += 1
        lid = seq_launch.get(seq)
        if lid is None:
            continue
        r["launches"].add(lid)
        t_end = launch_end.get(lid)
        if t_end is not None:
            r["verify"].append(max(0.0, t_end - t0))
        for tc in commit_ts.get(lid, ()):
            r["commit"].append(max(0.0, tc - t0))

    rows = []
    for origin in sorted(per):
        r = per[origin]
        v = sorted(r["verify"])
        c = sorted(r["commit"])
        rows.append(
            {
                "tenant": origin,
                "submits": r["submits"],
                "launches": len(r["launches"]),
                "verify_p50_s": _quantile(v, 0.50),
                "verify_p95_s": _quantile(v, 0.95),
                "commit_p50_s": _quantile(c, 0.50),
                "commit_p95_s": _quantile(c, 0.95),
                "commits": len(c),
            }
        )
    return rows


def render_tenant_table(rows):
    """The tenant-summary rows as an aligned text table."""
    cols = [
        ("tenant", "tenant"),
        ("subs", "submits"),
        ("launches", "launches"),
        ("vrfy p50", "verify_p50_s"),
        ("vrfy p95", "verify_p95_s"),
        ("cmt p50", "commit_p50_s"),
        ("cmt p95", "commit_p95_s"),
        ("commits", "commits"),
    ]
    table = [[h for h, _ in cols]]
    for r in rows:
        table.append([_fmt(r[k]) for _, k in cols])
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def overload_summary(events):
    """Overload posture reconstructed from the journal alone.

    Reads the ``load.*`` / ``admission.*`` events the open-loop harness
    emits plus the transport's ``wire.frame.*`` / ``transport.*``
    overload events, so a saved journal from an overloaded run is
    diagnosable with no live registry: how much load was injected, what
    the admission gates shed (by class), how the admission level moved
    over the run (transition timeline + time spent at each level), and
    what the wire path dropped on its own (per-peer backlog eviction,
    stale-generation frames, reconnect storms).
    """
    out = {
        "injected": 0,
        "injection_points": 0,
        "bursts": 0,
        "shed": {},
        "shed_total": 0,
        "level_timeline": [],
        "time_at_level": {},
        "wire_shed": {},
        "stale_frames": 0,
        "reconnects": 0,
        "reconnect_attempts": 0,
    }
    last_level = None  # (ts, name) of the level currently in force
    t_last = None
    for ev in events:
        ts, kind, detail = ev[0], ev[4], ev[5]
        t_last = ts
        if kind == "load.offered":
            out["injected"] += int(detail or 0)
            out["injection_points"] += 1
        elif kind == "load.burst":
            out["bursts"] += 1
        elif kind == "admission.shed":
            cls = detail if isinstance(detail, str) else "?"
            out["shed"][cls] = out["shed"].get(cls, 0) + 1
            out["shed_total"] += 1
        elif kind == "admission.level":
            out["level_timeline"].append((ts, detail))
            if last_level is not None:
                t0, prev = last_level
                out["time_at_level"][prev] = (
                    out["time_at_level"].get(prev, 0.0) + (ts - t0)
                )
            last_level = (ts, detail)
        elif kind == "wire.frame.shed":
            cls = detail if isinstance(detail, str) else "backlog"
            out["wire_shed"][cls] = out["wire_shed"].get(cls, 0) + 1
        elif kind == "wire.frame.stale":
            # The transport emits its cumulative per-node counter.
            out["stale_frames"] = max(out["stale_frames"], int(detail or 0))
        elif kind == "transport.reconnect":
            out["reconnects"] += 1
            out["reconnect_attempts"] += int(detail or 0)
    if last_level is not None and t_last is not None:
        t0, prev = last_level
        out["time_at_level"][prev] = (
            out["time_at_level"].get(prev, 0.0) + (t_last - t0)
        )
    return out


def render_overload_table(summary):
    """The overload summary as aligned text (the CLI's ``--overload``)."""
    lines = [
        f"injected {summary['injected']} "
        f"over {summary['injection_points']} delivery points · "
        f"amp-cap bursts {summary['bursts']}"
    ]
    shed = summary["shed"]
    if shed:
        total = summary["shed_total"]
        rows = [["class", "shed", "share"]]
        for cls in sorted(shed, key=shed.get, reverse=True):
            rows.append([cls, str(shed[cls]), f"{shed[cls] / total:.0%}"])
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    else:
        lines.append("admission shed nothing")
    tl = summary["level_timeline"]
    if tl:
        lines.append(
            "level timeline: "
            + " -> ".join(f"{name}@{ts:.3f}" for ts, name in tl[:12])
            + (f" (+{len(tl) - 12} more)" if len(tl) > 12 else "")
        )
        at = summary["time_at_level"]
        lines.append(
            "time at level: "
            + " · ".join(f"{k} {v:.3f}s" for k, v in at.items())
        )
    wire = []
    if summary["wire_shed"]:
        wire.append(
            "peer-queue shed "
            + ", ".join(
                f"{c}={n}" for c, n in sorted(summary["wire_shed"].items())
            )
        )
    if summary["stale_frames"]:
        wire.append(f"stale-generation frames {summary['stale_frames']}")
    if summary["reconnects"]:
        wire.append(
            f"reconnects {summary['reconnects']} "
            f"(total backoff attempts {summary['reconnect_attempts']})"
        )
    if wire:
        lines.append("wire: " + " · ".join(wire))
    return "\n".join(lines)


def overlay_summary(events):
    """Aggregation-overlay posture from the journal alone.

    Decodes the closed ``overlay.*`` family (obs/recorder.py) so a
    saved journal from an overlay run answers the robustness questions
    without a live runtime: how much coverage moved per tree level, who
    got charged for what (the contribution-score verdicts), how often
    level windows escalated or dead-ended into the ranked fallback, and
    which peers finished demoted vs recovered.
    """
    out = {
        "frames": 0,
        "new_coverage": 0,
        "frames_by_level": {},
        "charges": {"invalid": 0, "stale": 0, "duplicate": 0,
                    "withhold": 0},
        "charged_peers": {},
        "level_timeouts": 0,
        "timeouts_by_level": {},
        "fallbacks": 0,
        "demotions": [],
        "recoveries": [],
        "still_demoted": [],
        "rekeys": [],
    }
    _CHARGE_KINDS = {
        "overlay.invalid": "invalid",
        "overlay.stale": "stale",
        "overlay.duplicate": "duplicate",
        "overlay.withhold": "withhold",
    }
    demoted = set()
    for ev in events:
        replica, kind, detail = ev[1], ev[4], ev[5]
        if kind == "overlay.frame":
            out["frames"] += 1
            lvl = new = None
            for part in str(detail or "").split(":"):
                if part.startswith("lvl="):
                    lvl = int(part[4:])
                elif part.startswith("new="):
                    new = int(part[4:])
            if lvl is not None:
                out["frames_by_level"][lvl] = (
                    out["frames_by_level"].get(lvl, 0) + 1
                )
            if new is not None:
                out["new_coverage"] += new
        elif kind in _CHARGE_KINDS:
            cls = _CHARGE_KINDS[kind]
            out["charges"][cls] += 1
            peer = str(detail or "")
            if peer.startswith("peer="):
                key = f"{peer[5:]}:{cls}"
                out["charged_peers"][key] = (
                    out["charged_peers"].get(key, 0) + 1
                )
        elif kind == "overlay.level.timeout":
            out["level_timeouts"] += 1
            for part in str(detail or "").split(":"):
                if part.startswith("lvl="):
                    lvl = int(part[4:])
                    out["timeouts_by_level"][lvl] = (
                        out["timeouts_by_level"].get(lvl, 0) + 1
                    )
        elif kind == "overlay.fallback":
            out["fallbacks"] += 1
        elif kind == "overlay.demote":
            out["demotions"].append((replica, str(detail or "")))
            demoted.add(replica)
        elif kind == "overlay.recover":
            out["recoveries"].append((replica, str(detail or "")))
            demoted.discard(replica)
        elif kind == "overlay.rekey":
            out["rekeys"].append(str(detail or ""))
    out["still_demoted"] = sorted(demoted)
    return out


def render_overlay_table(summary):
    """The overlay summary as aligned text (the CLI's ``--overlay``)."""
    lines = [
        f"frames {summary['frames']} carrying "
        f"{summary['new_coverage']} new signer bits"
    ]
    by_level = summary["frames_by_level"]
    if by_level:
        tmo = summary["timeouts_by_level"]
        rows = [["level", "frames", "timeouts"]]
        for lvl in sorted(by_level):
            rows.append(
                [str(lvl), str(by_level[lvl]), str(tmo.get(lvl, 0))]
            )
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    charges = summary["charges"]
    total = sum(charges.values())
    if total:
        lines.append(
            "charges: "
            + " · ".join(
                f"{cls}={n}" for cls, n in sorted(charges.items()) if n
            )
        )
        per_peer = summary["charged_peers"]
        if per_peer:
            worst = sorted(
                per_peer.items(), key=lambda kv: -kv[1]
            )[:8]
            lines.append(
                "worst offenders: "
                + ", ".join(
                    f"peer {k.split(':')[0]} {k.split(':')[1]}x{n}"
                    for k, n in worst
                )
            )
    else:
        lines.append("no contribution charges (clean overlay)")
    lines.append(
        f"level windows: {summary['level_timeouts']} escalations · "
        f"{summary['fallbacks']} ranked fallbacks"
    )
    dem, rec = summary["demotions"], summary["recoveries"]
    if dem or rec:
        lines.append(
            f"demotions {len(dem)} / recoveries {len(rec)} · "
            f"still demoted at journal end: "
            f"{summary['still_demoted'] or 'none'}"
        )
    if summary["rekeys"]:
        lines.append(
            "rekeys: " + " -> ".join(summary["rekeys"][:6])
            + (f" (+{len(summary['rekeys']) - 6} more)"
               if len(summary["rekeys"]) > 6 else "")
        )
    return "\n".join(lines)


def exec_summary(events):
    """Execution-layer posture from the journal alone.

    Decodes the closed ``exec.*`` family (obs/recorder.py) so a saved
    journal from an execution run answers the ledger questions without
    a live sim: how many transactions each replica applied vs rejected,
    whether the per-height state roots agree across every replica that
    reported one, and which stake snapshots fed epoch elections.
    """
    out = {
        "blocks": 0,
        "txs": 0,
        "applied": 0,
        "rejected": 0,
        "device_blocks": 0,
        "host_blocks": 0,
        "per_replica": {},  # replica -> {blocks, txs, applied}
        "roots": {},  # height -> {root8 -> [replicas]}
        "root_forks": [],  # heights where >1 distinct root was reported
        "stake_marks": [],  # (height, detail) epoch stake snapshots
        # Speculation outcomes (exec.spec.* — the pipelined path):
        # replica -> {speculated, signed, confirmed, rolled_back,
        # max_depth}. A replica absent here ran strictly sequential.
        "spec_per_replica": {},
    }

    def spec_rep(replica):
        return out["spec_per_replica"].setdefault(
            replica,
            {"speculated": 0, "signed": 0, "confirmed": 0,
             "rolled_back": 0, "max_depth": 0},
        )

    for ev in events:
        replica, height, kind, detail = ev[1], ev[2], ev[4], ev[5]
        if kind == "exec.apply":
            out["blocks"] += 1
            txs = applied = dev = None
            for part in str(detail or "").split():
                if part.startswith("txs="):
                    txs = int(part[4:])
                elif part.startswith("applied="):
                    applied = int(part[8:])
                elif part.startswith("dev="):
                    dev = int(part[4:])
            rep = out["per_replica"].setdefault(
                replica, {"blocks": 0, "txs": 0, "applied": 0}
            )
            rep["blocks"] += 1
            if txs is not None:
                out["txs"] += txs
                rep["txs"] += txs
            if applied is not None:
                out["applied"] += applied
                rep["applied"] += applied
            if txs is not None and applied is not None:
                out["rejected"] += txs - applied
            if dev:
                out["device_blocks"] += 1
            elif dev is not None:
                out["host_blocks"] += 1
        elif kind == "exec.root":
            root8 = str(detail or "")
            by_root = out["roots"].setdefault(height, {})
            by_root.setdefault(root8, []).append(replica)
        elif kind == "exec.stake":
            out["stake_marks"].append((height, str(detail or "")))
        elif kind == "exec.spec.speculate":
            rep = spec_rep(replica)
            rep["speculated"] += 1
            if str(detail or "") == "signed=1":
                rep["signed"] += 1
        elif kind == "exec.spec.confirm":
            spec_rep(replica)["confirmed"] += 1
        elif kind == "exec.spec.rollback":
            rep = spec_rep(replica)
            rep["rolled_back"] += 1
            d = str(detail or "")
            if d.startswith("depth="):
                rep["max_depth"] = max(rep["max_depth"], int(d[6:]))
    out["root_forks"] = sorted(
        h for h, by_root in out["roots"].items() if len(by_root) > 1
    )
    return out


def render_exec_table(summary):
    """The exec summary as aligned text (the CLI's ``--exec``)."""
    lines = [
        f"{summary['blocks']} applied blocks · "
        f"{summary['txs']} txs ({summary['applied']} applied, "
        f"{summary['rejected']} rejected) · "
        f"route device={summary['device_blocks']} "
        f"host={summary['host_blocks']}"
    ]
    per = summary["per_replica"]
    if per:
        rows = [["replica", "blocks", "txs", "applied"]]
        for rep in sorted(per):
            s = per[rep]
            rows.append(
                [str(rep), str(s["blocks"]), str(s["txs"]),
                 str(s["applied"])]
            )
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    spec = summary.get("spec_per_replica") or {}
    if spec:
        lines.append("speculation outcomes:")
        rows = [["replica", "speculated", "signed", "confirmed",
                 "rolled back", "max depth"]]
        for rep in sorted(spec):
            s = spec[rep]
            rows.append(
                [str(rep), str(s["speculated"]), str(s["signed"]),
                 str(s["confirmed"]), str(s["rolled_back"]),
                 str(s["max_depth"])]
            )
        widths = [max(len(r[i]) for r in rows) for i in range(6)]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    roots = summary["roots"]
    if roots:
        agreed = len(roots) - len(summary["root_forks"])
        lines.append(
            f"state roots: {len(roots)} heights reported · "
            f"{agreed} unanimous"
        )
        if summary["root_forks"]:
            lines.append(
                "ROOT FORKS at heights: "
                + ", ".join(str(h) for h in summary["root_forks"])
            )
    if summary["stake_marks"]:
        lines.append(
            "epoch stake snapshots: "
            + " · ".join(
                f"h{h} {d}" for h, d in summary["stake_marks"][:6]
            )
            + (f" (+{len(summary['stake_marks']) - 6} more)"
               if len(summary["stake_marks"]) > 6 else "")
        )
    return "\n".join(lines)


def proofs_summary(events):
    """Trustless-read posture from the journal alone.

    Decodes the closed ``merkle.*`` / ``proof.*`` families
    (obs/recorder.py): how many proof frames the port served vs shed
    (and at what sizes), how the incremental tree kept up (updates vs
    full-rebuild fallbacks), and whether every replica that reported a
    Merkle root at a height reported the SAME one — a Merkle-root fork
    is state divergence even when the chained exec roots still agree.
    """
    out = {
        "served": 0,
        "shed": 0,
        "bytes_min": None,
        "bytes_max": None,
        "bytes_mean": None,
        "served_heights": {},  # basis height -> frames served
        "shed_tenants": {},  # tenant -> queries shed
        "updates": 0,
        "full_rebuilds": 0,
        "max_targets": 0,
        "depth": None,
        "merkle_roots": {},  # height -> {root8 -> [replicas]}
        "merkle_forks": [],  # heights with >1 distinct Merkle root
    }
    byte_total = 0
    for ev in events:
        replica, height, kind, detail = ev[1], ev[2], ev[4], ev[5]
        if kind == "proof.serve":
            out["served"] += 1
            out["served_heights"][height] = (
                out["served_heights"].get(height, 0) + 1
            )
            for part in str(detail or "").split():
                if part.startswith("bytes="):
                    b = int(part[6:])
                    byte_total += b
                    out["bytes_min"] = (
                        b if out["bytes_min"] is None
                        else min(out["bytes_min"], b)
                    )
                    out["bytes_max"] = (
                        b if out["bytes_max"] is None
                        else max(out["bytes_max"], b)
                    )
        elif kind == "proof.shed":
            out["shed"] += 1
            tenant = str(detail or "")
            out["shed_tenants"][tenant] = (
                out["shed_tenants"].get(tenant, 0) + 1
            )
        elif kind == "merkle.root":
            root8 = str(detail or "")
            by_root = out["merkle_roots"].setdefault(height, {})
            by_root.setdefault(root8, []).append(replica)
        elif kind == "merkle.update":
            out["updates"] += 1
            for part in str(detail or "").split():
                if part.startswith("targets="):
                    out["max_targets"] = max(
                        out["max_targets"], int(part[8:])
                    )
                elif part.startswith("depth="):
                    out["depth"] = int(part[6:])
                elif part.startswith("full=") and int(part[5:]):
                    out["full_rebuilds"] += 1
    if out["served"]:
        out["bytes_mean"] = byte_total / out["served"]
    out["merkle_forks"] = sorted(
        h for h, by_root in out["merkle_roots"].items()
        if len(by_root) > 1
    )
    return out


def render_proofs_table(summary):
    """The proofs summary as aligned text (the CLI's ``--proofs``)."""
    lines = [
        f"{summary['served']} proofs served · "
        f"{summary['shed']} queries shed"
    ]
    if summary["served"]:
        lines.append(
            f"proof frames: {summary['bytes_min']}"
            f"/{summary['bytes_mean']:.0f}/{summary['bytes_max']} "
            "bytes (min/mean/max)"
        )
        rows = [["basis height", "served"]]
        for h in sorted(summary["served_heights"]):
            rows.append([str(h), str(summary["served_heights"][h])])
        widths = [max(len(r[i]) for r in rows) for i in range(2)]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    if summary["shed_tenants"]:
        lines.append(
            "shed by tenant: "
            + " · ".join(
                f"{t}={n}"
                for t, n in sorted(summary["shed_tenants"].items())
            )
        )
    if summary["updates"]:
        lines.append(
            f"merkle updates: {summary['updates']} "
            f"({summary['full_rebuilds']} full rebuilds) · "
            f"max targets {summary['max_targets']} · "
            f"tree depth {summary['depth']}"
        )
    roots = summary["merkle_roots"]
    if roots:
        agreed = len(roots) - len(summary["merkle_forks"])
        lines.append(
            f"merkle roots: {len(roots)} heights reported · "
            f"{agreed} unanimous"
        )
        if summary["merkle_forks"]:
            lines.append(
                "MERKLE ROOT FORKS at heights: "
                + ", ".join(str(h) for h in summary["merkle_forks"])
            )
    return "\n".join(lines)


#: Finality milestones in doctrine order: the merged event kinds that
#: mark one committed height's journey across the mesh. ``send`` has no
#: kind of its own — it is the ``trace.send`` paired (by "origin:seq")
#: to the height's first ``trace.recv``, usually in ANOTHER process's
#: journal, which is exactly why this report wants merged input.
_CP_MILESTONES = (
    ("send", ()),
    ("recv", ("trace.recv",)),
    ("submit", ("service.remote.submit",)),
    ("verify", ("verify.launch", "sched.launch.begin", "tally.launch")),
    ("cert", ("cert.emit",)),
    ("resolve", ("service.remote.resolve",)),
    ("commit", ("commit",)),
    ("apply", ("exec.apply",)),
)


def critical_path_summary(events):
    """Finality critical-path attribution over a (merged) journal.

    Walks each committed height's event chain — frame send → peer
    receive → coalesced verify launch → cert mint → gated commit →
    apply drain — and names the hop that dominated its wall time.
    Milestones are the FIRST event of each kind at that height; hops
    are the gaps between consecutive milestones in time order, so they
    telescope to exactly the height's first-to-last span (100% of the
    wall time is attributed to named hops by construction).
    """
    kind_to_ms = {}
    for name, kinds in _CP_MILESTONES:
        for kind in kinds:
            kind_to_ms[kind] = name
    order = {name: i for i, (name, _) in enumerate(_CP_MILESTONES)}
    send_ts = {}  # trace span key -> earliest (aligned) send ts
    recv_key = {}  # height -> span key of its first trace.recv
    marks = {}  # height -> {milestone -> ts}
    for ev in events:
        ts, height, kind, detail = ev[0], ev[2], ev[4], ev[5]
        if kind == "trace.send" and detail:
            key = str(detail)
            if key not in send_ts or ts < send_ts[key]:
                send_ts[key] = ts
            continue
        if height < 0:
            continue
        name = kind_to_ms.get(kind)
        if name is None:
            continue
        ms = marks.setdefault(height, {})
        if name not in ms:
            ms[name] = ts
            if kind == "trace.recv" and detail:
                recv_key[height] = str(detail)
    rows = []
    aggregate = {}
    for height in sorted(marks):
        ms = marks[height]
        key = recv_key.get(height)
        if key is not None and key in send_ts:
            ms["send"] = send_ts[key]
        if len(ms) < 2:
            continue
        # Time order (milestone order as tiebreak) keeps the hops
        # telescoping even if clock alignment slightly reordered two
        # milestones — attribution stays exact, never negative.
        chain = sorted(ms.items(), key=lambda kv: (kv[1], order[kv[0]]))
        hops = []
        for (a, ta), (b, tb) in zip(chain, chain[1:]):
            label = f"{a}→{b}"
            hops.append((label, tb - ta))
            aggregate[label] = aggregate.get(label, 0.0) + (tb - ta)
        total = chain[-1][1] - chain[0][1]
        dominant, dominant_s = max(hops, key=lambda h: h[1])
        rows.append({
            "height": height,
            "milestones": dict(chain),
            "hops": hops,
            "total_s": total,
            "dominant": dominant,
            "dominant_s": dominant_s,
            "attributed": 1.0 if total > 0 else 0.0,
        })
    out = {"rows": rows, "aggregate": aggregate}
    if aggregate:
        dom = max(aggregate.items(), key=lambda kv: kv[1])
        out["dominant"] = dom[0]
        out["dominant_s"] = dom[1]
    return out


def render_critical_path_table(summary):
    """The critical-path rows as aligned text (the CLI's
    ``--critical-path``)."""
    rows = summary["rows"]
    if not rows:
        return "no committed heights with ≥2 finality milestones"
    table = [["ht", "total", "dominant hop", "share", "hops"]]
    for r in rows:
        share = r["dominant_s"] / r["total_s"] if r["total_s"] > 0 else 0.0
        table.append([
            str(r["height"]),
            _fmt(r["total_s"]),
            r["dominant"],
            f"{share:.0%}",
            " · ".join(f"{name}={dur:.4f}" for name, dur in r["hops"]),
        ])
    widths = [max(len(row[i]) for row in table) for i in range(5)]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    total = sum(r["total_s"] for r in rows)
    agg = summary["aggregate"]
    if total > 0 and agg:
        shares = " · ".join(
            f"{name}={dur / total:.0%}"
            for name, dur in sorted(
                agg.items(), key=lambda kv: -kv[1]
            )
        )
        lines.append(
            f"aggregate over {len(rows)} heights "
            f"({total:.4f}s attributed 100% to named hops): {shares}"
        )
    return "\n".join(lines)


def _detail_ints(detail):
    """Parse a ``k=v`` event detail string into an int dict.

    Campaign events carry compact ``rows=352 failed=256 level=2``
    payloads; ``seats=4/64`` splits into ``seats`` and ``of``. Tokens
    that don't parse are skipped so the decoder never throws on a
    journal written by a newer engine.
    """
    out = {}
    if not isinstance(detail, str):
        return out
    for tok in detail.split():
        if "=" not in tok:
            continue
        key, _, val = tok.partition("=")
        if "/" in val:
            val, _, denom = val.partition("/")
            try:
                out["of"] = int(denom)
            except ValueError:
                pass
        try:
            out[key] = int(val)
        except ValueError:
            pass
    return out


def campaign_summary(events):
    """Attack-campaign posture from the journal alone.

    Decodes the closed ``campaign.*`` family the campaign engines emit
    (hyperdrive_tpu_torch/campaign/families.py) plus the admission gate's
    ``admission.reputation.*`` feedback loop, so a journal saved from a
    campaign run (or a violation dump's sidecar journal) is diagnosable
    offline: which families ran, how each storm wave degraded and recovered, the adversary's per-epoch
    committee-seat trajectory vs its passive baseline, partition slices
    and the heal runway, reputation charges/demotions/recoveries, and
    any monitor violations with their final digests.
    """
    out = {
        "families": [],
        "waves": [],
        "epochs": [],
        "grinds": [],
        "partitions": [],
        "heal_runway": None,
        "violations": [],
        "done": [],
        "reputation": {
            "charges": {},
            "charge_total": 0,
            "demotions": 0,
            "recoveries": 0,
        },
    }
    rep = out["reputation"]
    for ev in events:
        height, kind, detail = ev[2], ev[4], ev[5]
        if kind == "campaign.family":
            out["families"].append(str(detail))
        elif kind == "campaign.wave":
            d = _detail_ints(detail)
            d["height"] = height
            out["waves"].append(d)
        elif kind == "campaign.epoch":
            d = _detail_ints(detail)
            d["height"] = height
            out["epochs"].append(d)
        elif kind == "campaign.grind":
            d = _detail_ints(detail)
            d["height"] = height
            out["grinds"].append(d)
        elif kind == "campaign.partition":
            d = _detail_ints(detail)
            d["height"] = height
            out["partitions"].append(d)
        elif kind == "campaign.heal":
            d = _detail_ints(detail)
            out["heal_runway"] = d.get("runway")
        elif kind == "campaign.violation":
            out["violations"].append(str(detail))
        elif kind == "campaign.done":
            out["done"].append(str(detail))
        elif kind == "admission.reputation.charge":
            cls = detail if isinstance(detail, str) else "?"
            rep["charges"][cls] = rep["charges"].get(cls, 0) + 1
            rep["charge_total"] += 1
        elif kind == "admission.reputation.demote":
            rep["demotions"] += 1
        elif kind == "admission.reputation.recover":
            rep["recoveries"] += 1
    return out


def render_campaign_table(summary):
    """The campaign summary as aligned text (the CLI's ``--campaign``)."""
    lines = []
    if summary["families"]:
        lines.append("families: " + " · ".join(summary["families"]))
    waves = summary["waves"]
    if waves:
        table = [["wave", "ht", "verified", "failed", "level"]]
        for i, w in enumerate(waves):
            table.append([
                str(i),
                str(w.get("height", "-")),
                str(w.get("rows", "-")),
                str(w.get("failed", "-")),
                str(w.get("level", "-")),
            ])
        widths = [max(len(r[i]) for r in table) for i in range(5)]
        for i, r in enumerate(table):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        failed = sum(w.get("failed", 0) for w in waves)
        lines.append(
            f"storm: {len(waves)} waves · "
            f"{failed} forged rows died at batch verify"
        )
    epochs = summary["epochs"]
    if epochs:
        grind_by_h = {g.get("height"): g for g in summary["grinds"]}
        part_by_h = {p.get("height"): p for p in summary["partitions"]}
        table = [["epoch", "ht", "adv seats", "grind", "partition"]]
        for e in epochs:
            h = e.get("height")
            g = grind_by_h.get(h)
            p = part_by_h.get(h)
            table.append([
                str(e.get("e", "-")),
                str(h),
                "%s/%s" % (e.get("seats", "-"), e.get("of", "-")),
                "cand=%s +%s" % (
                    g.get("cand", "-"),
                    g.get("seats", 0) - g.get("passive", 0),
                ) if g else "-",
                "lvl=%s sliced=%s" % (
                    p.get("level", "-"), p.get("sliced", "-"),
                ) if p else "-",
            ])
        widths = [max(len(r[i]) for r in table) for i in range(5)]
        for i, r in enumerate(table):
            lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        seats = sum(e.get("seats", 0) for e in epochs)
        lines.append(
            f"capture: {len(epochs)} epochs · "
            f"{seats} adversary seats total"
        )
    if summary["heal_runway"] is not None:
        lines.append(f"heal runway: {summary['heal_runway']} heights")
    rep = summary["reputation"]
    if rep["charge_total"] or rep["demotions"] or rep["recoveries"]:
        by_cls = ", ".join(
            f"{c}={n}" for c, n in sorted(rep["charges"].items())
        )
        lines.append(
            f"reputation: {rep['charge_total']} charges ({by_cls}) · "
            f"{rep['demotions']} demotions · "
            f"{rep['recoveries']} recoveries"
        )
    for v in summary["violations"]:
        lines.append(f"VIOLATION: {v}")
    for d in summary["done"]:
        lines.append(f"done: {d}")
    if not lines:
        return "no campaign.* events in journal window"
    return "\n".join(lines)


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def render_table(rows):
    """The anatomy rows as an aligned text table (the CLI's output)."""
    cols = [
        ("ht", "height"),
        ("rep", "replica"),
        ("rnds", "rounds"),
        ("propose", "propose_s"),
        ("prevote", "prevote_s"),
        ("precommit", "precommit_s"),
        ("stall", "stall_s"),
        ("total", "total_s"),
        ("t/o", "timeouts"),
        ("flags", "flags"),
    ]
    table = [[h for h, _ in cols]]
    for r in rows:
        table.append(
            [
                ",".join(r[k]) if k == "flags" else _fmt(r[k])
                for _, k in cols
            ]
        )
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
