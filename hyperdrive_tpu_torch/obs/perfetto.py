"""Chrome/Perfetto trace JSON exporter for recorder journals.

Emits the Trace Event Format (the JSON flavour ui.perfetto.dev and
chrome://tracing both load): one track (tid) per replica, ``B``/``E``
duration spans for rounds and consensus phases, and ``i`` instant
events for timeout fires, commits, equivocations, and wire anomalies.
Timestamps are the journal's (virtual) seconds scaled to microseconds,
so a sim second reads as a second in the UI.

Device telemetry (``sched.launch.*`` events, obs/devtel.py) renders as
its own **device** track (tid -3): one complete slice per coalesced
launch carrying the probe's args (rows, lanes, occupancy %, queue
wait), plus flow arrows stitching the cross-layer story together —
``cmdflow`` from each submitter's ``submit`` slice to the launch that
carried the command, and ``commitflow`` from the launch back to every
gated commit it finalized, so a commit's wall time decomposes across
the host/device boundary in one trace.

Merged journals (obs/merge.py) render MULTI-process: each event's
seventh slot is its origin pid, so every process gets its own Perfetto
process group (its own replica/device/sim tracks), and the causal
trace spans draw as ``traceflow`` arrows from each ``trace.send``
slice to its matching ``trace.recv`` slice — usually in ANOTHER
process's group. A per-process journal (6-tuples) renders exactly as
before under pid 0.

Port copy of ``hyperdrive_tpu/obs/perfetto.py``, whole.
"""

from __future__ import annotations

import json

__all__ = ["to_trace_events", "export"]

PID = 0

#: The device track's tid: one rung below the devsched queue track
#: (-2), mirroring the journal's replica>=0 / sim -1 / devsched -2
#: layering.
DEVICE_TID = -3

_INSTANTS = {
    "timeout.propose.fired": "timeout propose",
    "timeout.prevote.fired": "timeout prevote",
    "timeout.precommit.fired": "timeout precommit",
    "commit": "commit",
    "equivocation": "equivocation",
    "round.skip": "round skip",
    "height.resync": "height resync",
    "mq.drop": "mq drop",
    "wire.frame.malformed": "frame malformed",
    "wire.frame.oversize": "frame oversize",
    "wire.frame.shed": "frame shed",
    "settle.speculative": "speculative settle",
    "verify.rlc.fallbacks": "rlc fallback",
    "sched.coalesce": "coalesce",
    "sched.drain": "drain",
    "sched.gated": "commit gated",
    "sched.launch.split": "gen split",
    "epoch.begin": "epoch begin",
    "epoch.elect": "epoch elect",
    "epoch.switch": "epoch switch",
    "epoch.proof": "epoch proof",
    "epoch.stale_vote": "stale vote",
    "trace.offset": "clock offset",
    "metrics.serve": "metrics served",
    "metrics.shed": "metrics shed",
    "slo.breach": "SLO BREACH",
}

_PHASE_OPENERS = {
    "round.start": ("propose", "phase"),
    "step.prevoting": ("prevote", "phase"),
    "step.precommitting": ("precommit", "phase"),
}


def _us(ts):
    return max(0.0, ts * 1e6)


def _span_fid(detail):
    """The traceflow arrow id for one "origin:seq" span key, or None
    for a malformed detail (a flow id must be an int)."""
    origin_s, _, seq_s = str(detail).partition(":")
    try:
        return (int(origin_s) << 32) | (int(seq_s) & 0xFFFFFFFF)
    except ValueError:
        return None


def to_trace_events(events):
    """Journal events -> list of Chrome trace event dicts."""
    out = []
    tracks = set()  # (pid, tid) pairs seen
    # Per-(pid, replica) open-span state: rounds nest phases, so the
    # phase span must close before the round span that contains it.
    open_round = {}  # (pid, tid) -> (height, round)
    open_phase = {}  # (pid, tid) -> name

    def begin(pid, tid, ts, name, cat, args=None):
        ev = {
            "ph": "B",
            "ts": _us(ts),
            "pid": pid,
            "tid": tid,
            "name": name,
            "cat": cat,
        }
        if args:
            ev["args"] = args
        out.append(ev)

    def end(pid, tid, ts):
        out.append({"ph": "E", "ts": _us(ts), "pid": pid, "tid": tid})

    def close_phase(key, ts):
        if open_phase.pop(key, None) is not None:
            end(key[0], key[1], ts)

    def close_round(key, ts):
        close_phase(key, ts)
        if open_round.pop(key, None) is not None:
            end(key[0], key[1], ts)

    # Running queue depth for the devsched track's counter series —
    # reconstructed from the journal (submits raise it, a drain zeroes
    # it), so the counter is as deterministic as the journal itself.
    # Per-pid: each process owns its own queue.
    sched_depth = {}

    # Device-track state (sched.launch.* events), per pid: the launch
    # being assembled (begin..end bracket), completed launches' time
    # spans for the commit flows, and a running id for commitflow
    # arrows (each Chrome flow id is one polyline, so N commits off
    # one launch need N distinct ids).
    launch_open = {}  # pid -> open-launch state
    launch_spans = {}  # (pid, launch_id) -> (begin_ts, end_ts)
    commit_flows = 0

    def flow(ph, ts, pid, tid, fid, cat, name):
        ev = {
            "ph": ph,
            "ts": _us(ts),
            "pid": pid,
            "tid": tid,
            "id": fid,
            "cat": cat,
            "name": name,
        }
        if ph == "f":
            ev["bp"] = "e"
        out.append(ev)

    for ev in events:
        ts, replica, height, round_, kind, detail = (
            ev[0], ev[1], ev[2], ev[3], ev[4], ev[5],
        )
        pid = ev[6] if len(ev) > 6 else PID
        tid = replica
        key = (pid, tid)
        tracks.add(key)
        if kind == "sched.submit" or kind == "sched.drain":
            depth = (
                sched_depth.get(pid, 0) + 1
                if kind == "sched.submit" else 0
            )
            sched_depth[pid] = depth
            out.append(
                {
                    "ph": "C",
                    "ts": _us(ts),
                    "pid": pid,
                    "tid": tid,
                    "name": "sched.depth",
                    "args": {"depth": depth},
                }
            )
        if kind.startswith("sched.launch."):
            if kind == "sched.launch.submit":
                # A zero-ish slice anchors the flow start on the
                # submitter's track (flows bind to slices, and the sim
                # track has no spans of its own).
                out.append(
                    {
                        "ph": "X",
                        "ts": _us(ts),
                        "dur": 1.0,
                        "pid": pid,
                        "tid": tid,
                        "name": "submit",
                        "cat": "devtel",
                        "args": {"seq": detail},
                    }
                )
                flow("s", ts, pid, tid, int(detail), "cmdflow", "cmd")
            elif kind == "sched.launch.begin":
                launch_open[pid] = {
                    "id": detail,
                    "ts": ts,
                    "cmds": [],
                    "args": {"launch_id": detail},
                }
            elif kind == "sched.launch.cmd":
                if launch_open.get(pid) is not None:
                    launch_open[pid]["cmds"].append(detail)
            elif kind in (
                "sched.launch.rows",
                "sched.launch.lanes",
                "sched.launch.occupancy",
                "sched.launch.queue_wait",
            ):
                if launch_open.get(pid) is not None:
                    leaf = kind.rsplit(".", 1)[1]
                    launch_open[pid]["args"][leaf] = detail
            elif kind == "sched.launch.end":
                lo = launch_open.get(pid)
                if lo is not None:
                    tracks.add((pid, DEVICE_TID))
                    t0 = lo["ts"]
                    args = lo["args"]
                    args["commands"] = len(lo["cmds"])
                    out.append(
                        {
                            "ph": "X",
                            "ts": _us(t0),
                            "dur": max(_us(ts) - _us(t0), 1.0),
                            "pid": pid,
                            "tid": DEVICE_TID,
                            "name": f"launch {lo['id']}",
                            "cat": "launch",
                            "args": args,
                        }
                    )
                    for seq in lo["cmds"]:
                        flow("f", t0, pid, DEVICE_TID, int(seq),
                             "cmdflow", "cmd")
                    launch_spans[(pid, lo["id"])] = (t0, ts)
                    launch_open[pid] = None
            elif kind == "sched.launch.commit":
                out.append(
                    {
                        "ph": "X",
                        "ts": _us(ts),
                        "dur": 1.0,
                        "pid": pid,
                        "tid": tid,
                        "name": "commit finalize",
                        "cat": "devtel",
                        "args": {"height": height, "launch_id": detail},
                    }
                )
                span = launch_spans.get((pid, detail))
                if span is not None:
                    commit_flows += 1
                    flow("s", span[0], pid, DEVICE_TID, commit_flows,
                         "commitflow", "commit")
                    flow("f", ts, pid, tid, commit_flows,
                         "commitflow", "commit")

        if kind in ("trace.send", "trace.recv") and detail is not None:
            # Cross-process causal spans: an anchoring slice per end
            # (flows bind to slices) and one traceflow arrow per
            # "origin:seq" span key — in a merged journal the two ends
            # usually live in DIFFERENT process groups, which is the
            # arrow the per-process exports could never draw.
            fid = _span_fid(detail)
            if fid is not None:
                sendside = kind == "trace.send"
                out.append(
                    {
                        "ph": "X",
                        "ts": _us(ts),
                        "dur": 1.0,
                        "pid": pid,
                        "tid": tid,
                        "name": "frame send" if sendside else "frame recv",
                        "cat": "trace",
                        "args": {"span": detail, "height": height},
                    }
                )
                flow("s" if sendside else "f", ts, pid, tid, fid,
                     "traceflow", "frame")

        if kind == "round.start":
            close_round(key, ts)
            begin(
                pid,
                tid,
                ts,
                f"h{height} r{round_}",
                "round",
                {"height": height, "round": round_},
            )
            open_round[key] = (height, round_)
            begin(pid, tid, ts, "propose", "phase")
            open_phase[key] = "propose"
        elif kind in ("step.prevoting", "step.precommitting"):
            close_phase(key, ts)
            name = _PHASE_OPENERS[kind][0]
            begin(pid, tid, ts, name, "phase")
            open_phase[key] = name

        if kind in _INSTANTS:
            inst = {
                "ph": "i",
                "ts": _us(ts),
                "pid": pid,
                "tid": tid,
                "name": _INSTANTS[kind],
                "cat": kind.split(".", 1)[0],
                "s": "t",
                "args": {"height": height, "round": round_},
            }
            if detail is not None:
                inst["args"]["detail"] = detail
            out.append(inst)

        if kind == "commit":
            # The commit ends the whole round span for this height.
            close_round(key, ts)

    # Close anything still open at the journal edge.
    if events:
        last_ts = events[-1][0]
        for key in list(open_phase):
            close_phase(key, last_ts)
        for key in list(open_round):
            close_round(key, last_ts)

    # Track naming metadata first, so the UI labels tids as replicas
    # and (for merged journals) each origin as its own process group.
    meta = []
    for pid, tid in sorted(tracks):
        # tid -2 is the devsched work-queue track (sim.py scopes the
        # queue's recorder handle there); -1 is the sim's own track.
        if tid == DEVICE_TID:
            name = "device"
        elif tid == -2:
            name = "devsched"
        elif tid < 0:
            name = "sim"
        else:
            name = f"replica {tid}"
        meta.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": name},
            }
        )
    for pid in sorted({pid for pid, _ in tracks}):
        meta.append(
            {
                "ph": "M",
                "pid": pid,
                "name": "process_name",
                "args": {
                    "name": (
                        "hyperdrive consensus" if pid == PID
                        else f"hyperdrive process {pid}"
                    )
                },
            }
        )
    return meta + out


def export(events, path):
    """Write the Perfetto-loadable trace JSON for ``events``."""
    doc = {
        "traceEvents": to_trace_events(events),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.write("\n")
    return doc
