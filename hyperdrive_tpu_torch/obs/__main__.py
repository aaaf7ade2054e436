"""``python -m hyperdrive_tpu_torch.obs`` — record, report, export, metrics,
benchdiff.

    record     run a short observed sim and save its event journal
    report     render the round-anatomy table from a saved journal
               (``--tenants`` for per-origin device-launch latency,
               ``--overload`` for admission/shed posture,
               ``--overlay`` for aggregation-overlay posture,
               ``--exec`` for execution-layer/state-root posture,
               ``--proofs`` for trustless-read/Merkle posture,
               ``--campaign`` for attack-campaign posture,
               ``--critical-path`` for per-commit finality hop
               attribution — most useful on a merged journal)
    merge      fold N per-process journals into one causally-
               consistent stream (clock-aligned, pid-stamped)
    export     convert a saved journal to Perfetto/Chrome trace JSON
               (merged journals render per-process tracks + cross-
               process flow arrows)
    metrics    run a short observed sim, print its metrics-registry
               snapshot (JSON; ``--prometheus FILE`` for exposition text)
    benchdiff  diff two bench artifacts, exit nonzero on a gated
               perf regression (the CI sentinel)

``record`` exists so CI (and anyone without a saved journal) can go
from nothing to a viewable trace in two commands:

    python -m hyperdrive_tpu_torch.obs record -o journal.json
    python -m hyperdrive_tpu_torch.obs export journal.json -o trace.json

``metrics`` takes ``--device`` (the card by default; ``cpu`` for the
plain versions). Only ``--pipeline`` does device work: its signed,
pipelined sim verifies through the port's default batch verifier, a
``TorchBatchVerifier`` on ``--device`` (row 1, ``ed25519_verify``), where
the reference's is the ``HostVerifier``. Without CUDA, ``metrics
--pipeline`` exits non-zero unless ``--device cpu`` is given. The other
subcommands touch no device.

Port of the JAX package's ``obs/__main__.py``: the same subcommands,
flags, lines and JSON keys. Deliberate differences: ``metrics
--pipeline``'s registry holds the card verifier's launch telemetry
(``devtel.launch.lanes``, ``devtel.launch.syncs`` and
``devtel.launch.occupancy`` count bucket lanes and device syncs) and its
journal the device-only kinds (``fetch.sync``, ``verify.occupancy.*``,
counted by the ``obs.recorder.total`` gauge), so its ``digest`` is the
reference's only once those names are taken out of the snapshot; and the
hints name this package's modules.
"""

from __future__ import annotations

import argparse
import json
import sys

from hyperdrive_tpu_torch.obs.recorder import load_journal
from hyperdrive_tpu_torch.obs.report import (
    anatomy,
    campaign_summary,
    critical_path_summary,
    exec_summary,
    overlay_summary,
    overload_summary,
    phase_summary,
    proofs_summary,
    render_campaign_table,
    render_critical_path_table,
    render_exec_table,
    render_proofs_table,
    render_overlay_table,
    render_overload_table,
    render_table,
    render_tenant_table,
    tenant_summary,
)
from hyperdrive_tpu_torch.obs.perfetto import export
from hyperdrive_tpu_torch.utils.cli import add_device_arg


def _cmd_record(ns):
    # Imported here: the sim pulls in torch; report/export stay stdlib.
    from hyperdrive_tpu_torch.harness import Simulation

    sim = Simulation(
        n=ns.replicas,
        target_height=ns.heights,
        seed=ns.seed,
        timeout=ns.timeout,
        delivery_cost=ns.delivery_cost,
        observe=True,
    )
    res = sim.run()
    sim.obs.save(ns.output)
    print(
        json.dumps(
            {
                "completed": res.completed,
                "events": len(sim.obs),
                "dropped": sim.obs.dropped,
                "digest": sim.obs.digest(),
                "journal": ns.output,
            }
        )
    )
    return 0 if res.completed else 1


def _cmd_report(ns):
    journal = load_journal(ns.journal)
    if ns.campaign:
        summary = campaign_summary(journal["events"])
        if ns.json:
            print(json.dumps({"campaign": summary}, indent=1))
            return 0
        if not (summary["families"] or summary["waves"]
                or summary["epochs"]
                or summary["reputation"]["charge_total"]):
            print("no campaign.* events in journal window "
                  "(record one: python -m hyperdrive_tpu_torch.campaign run "
                  "— violation dumps ship a sidecar journal)")
            return 1
        print(render_campaign_table(summary))
        return 0
    if ns.critical_path:
        summary = critical_path_summary(journal["events"])
        if ns.json:
            print(json.dumps({"critical_path": summary}, indent=1))
            return 0
        if not summary["rows"]:
            print("no committed heights with >=2 finality milestones "
                  "in journal window (merge per-process journals first: "
                  "python -m hyperdrive_tpu_torch.obs merge ...)")
            return 1
        print(render_critical_path_table(summary))
        return 0
    if ns.exec:
        summary = exec_summary(journal["events"])
        if ns.json:
            print(json.dumps({"exec": summary}, indent=1))
            return 0
        if not (summary["blocks"] or summary["roots"]
                or summary["stake_marks"]):
            print("no exec.* events in journal window "
                  "(record an execution run: Simulation(execution=...))")
            return 1
        print(render_exec_table(summary))
        return 0
    if ns.proofs:
        summary = proofs_summary(journal["events"])
        if ns.json:
            print(json.dumps({"proofs": summary}, indent=1))
            return 0
        if not (summary["served"] or summary["shed"]
                or summary["updates"] or summary["merkle_roots"]):
            print("no merkle.*/proof.* events in journal window "
                  "(record an execution run and serve queries through "
                  "the service port)")
            return 1
        print(render_proofs_table(summary))
        return 0
    if ns.overlay:
        summary = overlay_summary(journal["events"])
        if ns.json:
            print(json.dumps({"overlay": summary}, indent=1))
            return 0
        if not (
            summary["frames"]
            or summary["level_timeouts"]
            or summary["fallbacks"]
            or sum(summary["charges"].values())
        ):
            print("no overlay.* events in journal window "
                  "(record an overlay run: Simulation(overlay=...))")
            return 1
        print(render_overlay_table(summary))
        return 0
    if ns.overload:
        summary = overload_summary(journal["events"])
        if ns.json:
            print(json.dumps({"overload": summary}, indent=1))
            return 0
        if not (
            summary["injected"]
            or summary["shed_total"]
            or summary["level_timeline"]
            or summary["wire_shed"]
            or summary["reconnects"]
        ):
            print("no load.*/admission.* events in journal window "
                  "(record an overloaded run: Simulation(load=...))")
            return 1
        print(render_overload_table(summary))
        return 0
    if ns.tenants:
        rows = tenant_summary(journal["events"])
        if ns.json:
            print(json.dumps({"tenants": rows}, indent=1))
            return 0
        if not rows:
            print("no sched.launch.* events in journal window "
                  "(record with device telemetry on)")
            return 1
        print(render_tenant_table(rows))
        return 0
    rows = anatomy(journal["events"])
    if ns.json:
        print(
            json.dumps(
                {"rows": rows, "summary": phase_summary(journal["events"])},
                indent=1,
            )
        )
        return 0
    if not rows:
        print("no committed heights in journal window")
        return 1
    print(render_table(rows))
    summary = phase_summary(journal["events"])
    print()
    print(
        f"{summary['commits']} commits · "
        f"mean rounds {summary['mean_rounds']:.2f} · "
        f"mean total {summary['mean_total_s']:.4f}s · "
        f"timeout-driven {summary['timeout_driven']} · "
        f"extra-round {summary['extra_round_commits']}"
    )
    if journal.get("dropped"):
        print(
            f"(ring dropped {journal['dropped']} oldest events; "
            "raise obs_capacity for full anatomy)"
        )
    return 0


def _cmd_merge(ns):
    from hyperdrive_tpu_torch.obs.merge import (
        merge_journals,
        merged_digest,
        save_merged,
    )

    journals = [load_journal(path) for path in ns.journals]
    merged = merge_journals(journals)
    save_merged(merged, ns.output)
    print(
        json.dumps(
            {
                "merged": ns.output,
                "journals": len(journals),
                "origins": merged["meta"]["origins"],
                "events": len(merged["events"]),
                "orphans": len(merged["meta"]["orphans"]),
                "digest": merged_digest(merged),
            }
        )
    )
    return 0


def _cmd_export(ns):
    journal = load_journal(ns.journal)
    doc = export(journal["events"], ns.output)
    print(
        json.dumps(
            {"trace": ns.output, "events": len(doc["traceEvents"])}
        )
    )
    return 0


def _cmd_metrics(ns):
    # Imported here: the sim pulls in torch; the registry itself is stdlib.
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.obs.metrics import to_prometheus
    from hyperdrive_tpu_torch.utils.cli import require_device

    extra = {}
    if ns.pipeline:
        # pipeline_heights requires burst mode and a batch verifier;
        # sign=True supplies the default, a TorchBatchVerifier on --device.
        extra = dict(sign=True, burst=True, pipeline_heights=True,
                     device=require_device(ns.device))
    sim = Simulation(
        n=ns.replicas,
        target_height=ns.heights,
        seed=ns.seed,
        timeout=ns.timeout,
        delivery_cost=ns.delivery_cost,
        observe=True,
        **extra,
    )
    res = sim.run()
    snap = sim.metrics_snapshot()
    if ns.output:
        with open(ns.output, "w") as fh:
            json.dump(snap, fh, indent=1, sort_keys=True)
            fh.write("\n")
    if ns.prometheus:
        with open(ns.prometheus, "w") as fh:
            fh.write(to_prometheus(snap))
    print(
        json.dumps(
            {
                "completed": res.completed,
                "counters": len(snap["counters"]),
                "gauges": len(snap["gauges"]),
                "histograms": len(snap["histograms"]),
                "digest": sim.registry.digest(),
                "snapshot": ns.output,
                "prometheus": ns.prometheus,
            }
        )
    )
    return 0 if res.completed else 1


def _cmd_benchdiff(ns):
    from hyperdrive_tpu_torch.obs.benchdiff import main as benchdiff_main

    return benchdiff_main(
        ns.old,
        ns.new,
        threshold=ns.threshold,
        gates=ns.gate or None,
        as_json=ns.json,
    )


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hyperdrive_tpu_torch.obs",
        description="consensus flight recorder tooling (OBSERVABILITY.md)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="run an observed sim, save journal")
    rec.add_argument("-o", "--output", default="journal.json")
    rec.add_argument("--replicas", type=int, default=4)
    rec.add_argument("--heights", type=int, default=5)
    rec.add_argument("--seed", type=int, default=91)
    rec.add_argument("--timeout", type=float, default=20.0)
    rec.add_argument("--delivery-cost", type=float, default=0.001)
    rec.set_defaults(fn=_cmd_record)

    rep = sub.add_parser("report", help="round-anatomy table from journal")
    rep.add_argument("journal")
    rep.add_argument("--json", action="store_true")
    rep.add_argument(
        "--tenants",
        action="store_true",
        help="per-origin device-launch latency summary instead",
    )
    rep.add_argument(
        "--overload",
        action="store_true",
        help="overload/admission posture summary instead "
             "(load.*, admission.*, wire.frame.* events)",
    )
    rep.add_argument(
        "--overlay",
        action="store_true",
        help="aggregation-overlay posture summary instead "
             "(the closed overlay.* family: frames, charges, "
             "escalations, demotions)",
    )
    rep.add_argument(
        "--exec",
        action="store_true",
        help="execution-layer posture summary instead "
             "(the closed exec.* family: applied blocks, state-root "
             "agreement, epoch stake snapshots)",
    )
    rep.add_argument(
        "--proofs",
        action="store_true",
        help="trustless-read posture summary instead "
             "(the closed merkle.*/proof.* families: proofs served vs "
             "shed, frame sizes, incremental-update posture, per-height "
             "Merkle-root agreement)",
    )
    rep.add_argument(
        "--campaign",
        action="store_true",
        help="attack-campaign posture summary instead "
             "(the closed campaign.*/admission.reputation.* families: "
             "storm waves, per-epoch adversary seat trajectory, grind "
             "candidates, partitions, reputation loop, violations)",
    )
    rep.add_argument(
        "--critical-path",
        dest="critical_path",
        action="store_true",
        help="per-commit finality critical path instead: walk each "
             "committed height's event chain (frame send -> peer recv "
             "-> verify launch -> cert mint -> gated commit -> apply "
             "drain) and name the dominating hop",
    )
    rep.set_defaults(fn=_cmd_report)

    mrg = sub.add_parser(
        "merge",
        help="fold N per-process journals into one aligned stream",
    )
    mrg.add_argument("journals", nargs="+",
                     help="per-process journal files (>=1)")
    mrg.add_argument("-o", "--output", default="merged.json")
    mrg.set_defaults(fn=_cmd_merge)

    exp = sub.add_parser("export", help="journal -> Perfetto trace JSON")
    exp.add_argument("journal")
    exp.add_argument("-o", "--output", default="trace.json")
    exp.set_defaults(fn=_cmd_export)

    met = sub.add_parser(
        "metrics", help="run an observed sim, print registry snapshot"
    )
    met.add_argument("-o", "--output", default=None,
                     help="also write the snapshot JSON here")
    met.add_argument("--prometheus", default=None,
                     help="write Prometheus exposition text here")
    met.add_argument("--replicas", type=int, default=4)
    met.add_argument("--heights", type=int, default=5)
    met.add_argument("--seed", type=int, default=91)
    met.add_argument("--timeout", type=float, default=20.0)
    met.add_argument("--delivery-cost", type=float, default=0.001)
    met.add_argument("--pipeline", action="store_true",
                     help="pipelined heights (exercises device telemetry)")
    add_device_arg(met)
    met.set_defaults(fn=_cmd_metrics)

    bd = sub.add_parser(
        "benchdiff", help="perf sentinel: diff two bench JSON artifacts"
    )
    bd.add_argument("old")
    bd.add_argument("new")
    bd.add_argument("--threshold", type=float, default=0.08)
    bd.add_argument("--gate", action="append", default=[],
                    help="extra gated metric path (repeatable)")
    bd.add_argument("--json", action="store_true")
    bd.set_defaults(fn=_cmd_benchdiff)

    ns = p.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
