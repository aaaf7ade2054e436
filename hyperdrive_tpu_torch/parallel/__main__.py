"""The multi-tenant serving CLI (CI's ``multitenant-smoke`` job).

Usage::

    python -m hyperdrive_tpu_torch.parallel serve
        [--tenants M] [--heights H] [--validators V]
        [--policy drr|fifo] [--capacity-rows N] [--quantum-rows N]
        [--starve-after K] [--weights T=W,...]
        [--verifier device|host|null] [--max-depth D]
        [--listen] [--remote-tenants K] [--parity]
        [--journal FILE] [--origin N] [--json] [-o FILE]

    python -m hyperdrive_tpu_torch.parallel tenant
        --connect HOST:PORT --name NAME
        [--validators V] [--heights H] [--unsigned] [--inflight N]
        [--journal FILE] [--origin N]

``--journal`` turns on the distributed flight recorder: the process
records a wall-clock journal (``time.time`` timestamps, so journals
from different processes share a clock domain up to offset), stamps
every outbound frame with a causal trace context, and saves the
journal (meta: its trace origin id) on exit. ``serve --journal`` hands
each spawned remote tenant its own journal path and origin, so one run
yields N+1 journals ready for ``python -m hyperdrive_tpu_torch.obs merge``.

``serve`` runs the deployment shape of ROADMAP item 2: M independent
shard-consensus instances (each its own deterministic committee)
funneling verify windows into ONE continuously-batching
:class:`~hyperdrive_tpu_torch.parallel.service.ShardVerifyService`. The drive
loop pumps every tenant, services the remote port, and drains the
shared queue — each drain is one coalesced launch covering whatever
every tenant had pending.

``--remote-tenants K`` spawns K child processes running the ``tenant``
subcommand against the port: REAL cross-process batching over TCP, with
commits finalized by O(1) certificate frames. ``--parity`` re-runs
every tenant on its own dedicated service afterwards and asserts the
commit digests match — continuous batching must change scheduling,
never results.

``serve`` verifies on ``--device`` by default (``--verifier device``): a
``TorchBatchVerifier`` on the card (row 1, ``ed25519_verify``), or on
``--device cpu`` the plain ladder; without CUDA it exits non-zero unless
``--device cpu`` is given. ``--verifier host`` and ``--verifier null``
touch no device, and neither does the ``tenant`` subcommand: a child
signs on the host and builds no CUDA library.

Port of the JAX package's ``parallel/__main__.py``: the same
subcommands, flags, JSON keys and journals. Deliberate differences: the
``--device`` option of ``serve``; ``--verifier`` defaults to ``device``
where the reference's default is ``host``, as the port's ``Simulation``
defaults to ``TorchBatchVerifier`` where the reference's uses
``HostVerifier``; ``--verifier device`` builds a ``TorchBatchVerifier``
where the reference builds its ``TpuBatchVerifier``; and the children
run ``python -m hyperdrive_tpu_torch.parallel tenant``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from hyperdrive_tpu_torch.parallel.service import (
    RemoteServiceClient,
    ShardVerifyService,
    TenantShard,
)
from hyperdrive_tpu_torch.utils.cli import add_device_arg, require_device


def _percentile(values, q: float):
    vals = sorted(values)
    if not vals:
        return None
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _journal_path_for_child(journal: str, i: int) -> str:
    """remote child i's journal path, derived from the serve journal
    (``foo.json`` -> ``foo.remote-0.json``)."""
    base, dot, ext = journal.rpartition(".")
    if not dot:
        return f"{journal}.remote-{i}"
    return f"{base}.remote-{i}.{ext}"


def _build_observer(origin: int):
    """One process's distributed-tracing kit: a threadsafe wall-clock
    Recorder (IO threads emit), its bound handle on the sim track, and
    the stamp mint."""
    from hyperdrive_tpu_torch.obs.recorder import Recorder
    from hyperdrive_tpu_torch.obs.tracectx import TraceSource

    rec = Recorder(time_fn=time.time, threadsafe=True)
    obs = rec.scoped(-1)
    return rec, obs, TraceSource(origin, obs=obs)


def _build_verifier(kind: str, device: str):
    if kind == "null":
        from hyperdrive_tpu_torch.verifier import NullVerifier

        return NullVerifier()
    if kind == "device":
        from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

        return TorchBatchVerifier(device=require_device(device))
    from hyperdrive_tpu_torch.verifier import HostVerifier

    return HostVerifier()


def _build_policy(args):
    if args.policy == "fifo":
        return None
    from hyperdrive_tpu_torch.devsched import DeficitRoundRobin

    weights = {}
    if args.weights:
        for part in args.weights.split(","):
            name, _, w = part.partition("=")
            weights[name.strip()] = int(w)
    return DeficitRoundRobin(
        capacity_rows=args.capacity_rows,
        quantum_rows=args.quantum_rows,
        weights=weights or None,
        starve_after=args.starve_after,
    )


def _dedicated_digest(name: str, validators: int, heights: int,
                      sign: bool, verifier_kind: str, device: str) -> str:
    """The per-tenant-queue baseline: the same tenant driven through its
    own fresh service (own queue, own verifier instance) — what the
    shared run's digest must match exactly."""
    svc = ShardVerifyService(_build_verifier(verifier_kind, device), max_depth=0)
    shard = TenantShard(
        name, n_validators=validators, target_height=heights, sign=sign
    ).attach_local(svc)
    while not shard.done:
        if not shard.pump(max_inflight=2):
            break
        svc.drain()
    svc.close()
    return shard.commit_digest()


def serve(args) -> int:
    from hyperdrive_tpu_torch.obs.devtel import DeviceTelemetry

    sign = args.verifier != "null"
    devtel = DeviceTelemetry(keep=4096)
    policy = _build_policy(args)
    flight_rec = obs = trace = registry = None
    if args.journal:
        from hyperdrive_tpu_torch.obs.metrics import Registry

        flight_rec, obs, trace = _build_observer(args.origin)
        registry = Registry()
    service = ShardVerifyService(
        _build_verifier(args.verifier, args.device),
        max_depth=args.max_depth,
        devtel=devtel,
        policy=policy,
        obs=obs,
        registry=registry,
    )
    tenants = [
        TenantShard(
            f"tenant-{i}", n_validators=args.validators,
            target_height=args.heights, sign=sign,
        ).attach_local(service)
        for i in range(args.tenants)
    ]

    port = None
    children = []
    child_journals = []
    if args.listen or args.remote_tenants:
        port = service.remote_port(obs=obs, trace=trace)
        host, pnum = port.address
        for i in range(args.remote_tenants):
            cmd = [
                sys.executable, "-m", "hyperdrive_tpu_torch.parallel", "tenant",
                "--connect", f"{host}:{pnum}",
                "--name", f"remote-{i}",
                "--validators", str(args.validators),
                "--heights", str(args.heights),
            ]
            if not sign:
                cmd.append("--unsigned")
            if args.journal:
                child_path = _journal_path_for_child(args.journal, i)
                child_journals.append(child_path)
                cmd += [
                    "--journal", child_path,
                    "--origin", str(args.origin + 1 + i),
                ]
            children.append(
                subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
            )

    t_start = time.perf_counter()
    deadline = t_start + args.timeout
    while time.perf_counter() < deadline:
        submitted = sum(t.pump(max_inflight=2) for t in tenants)
        handled = port.pump() if port is not None else 0
        if service.queue.depth:
            service.drain()
        locals_done = all(t.done for t in tenants)
        remote_quiet = port is None or (
            port.inflight == 0
            and all(c.poll() is not None for c in children)
        )
        if locals_done and remote_quiet and not service.queue.depth:
            break
        if not submitted and not handled and not service.queue.depth:
            time.sleep(0.001)
    wall = time.perf_counter() - t_start
    service.drain()

    child_reports = []
    for c in children:
        out, _ = c.communicate(timeout=30)
        child_reports.append(json.loads(out) if out.strip() else {})
    if port is not None:
        port.close()
    service.close()

    # Coalescing evidence straight from the launch probe: launches whose
    # origin tuples span more than one tenant track, and — with remote
    # tenants — launches mixing a remote tenant's track with local ones.
    local_tids = {service.tenant_ids[t.name] for t in tenants}
    multi_origin = 0
    remote_coalesced = 0
    for rec in devtel.records:
        origins = set(rec.origins)
        if len(origins) > 1:
            multi_origin += 1
            if origins - local_tids and origins & local_tids:
                remote_coalesced += 1

    total_rows = sum(
        len(t.commits) * args.validators for t in tenants
    ) + sum(
        r.get("commits", 0) * args.validators for r in child_reports
    )
    latencies = [lat for t in tenants for lat in t.commit_latencies]
    parity_ok = None
    if args.parity:
        parity_ok = True
        for t in tenants:
            want = _dedicated_digest(
                t.name, args.validators, args.heights, sign, args.verifier,
                args.device,
            )
            if t.commit_digest() != want:
                parity_ok = False
                print(
                    f"PARITY MISMATCH tenant={t.name}: shared "
                    f"{t.commit_digest()[:16]} != dedicated {want[:16]}",
                    file=sys.stderr,
                )
        for r in child_reports:
            if not r:
                continue
            want = _dedicated_digest(
                r["name"], args.validators, args.heights, sign,
                args.verifier, args.device,
            )
            if r.get("digest") != want:
                parity_ok = False
                print(
                    f"PARITY MISMATCH remote tenant={r['name']}: "
                    f"{str(r.get('digest'))[:16]} != local {want[:16]}",
                    file=sys.stderr,
                )

    summary = {
        "tenants": args.tenants,
        "remote_tenants": args.remote_tenants,
        "heights": args.heights,
        "validators": args.validators,
        "policy": args.policy,
        "verifier": args.verifier,
        "completed": all(t.done for t in tenants)
        and all(r.get("done") for r in child_reports if r),
        "wall_s": wall,
        "votes_per_s": (total_rows / wall) if wall > 0 else 0.0,
        "launches": service.queue.launches,
        "coalesced": service.queue.coalesced,
        "multi_origin_launches": multi_origin,
        "remote_coalesced_launches": remote_coalesced,
        "commit_latency_p50_s": _percentile(latencies, 0.50),
        "commit_latency_p95_s": _percentile(latencies, 0.95),
        "commit_latency_p99_s": _percentile(latencies, 0.99),
        "remote": None if port is None else {
            "submits": port.remote_submits,
            "resolves": port.remote_resolves,
            "sheds": port.remote_sheds,
            "metrics_serves": port.metrics_serves,
            "metrics_sheds": port.metrics_sheds,
            "children": child_reports,
        },
        "policy_stats": None if policy is None else {
            "deferred_total": policy.deferred_total,
            "forced_total": policy.forced_total,
            "max_deferrals": policy.max_deferrals,
        },
        "parity_ok": parity_ok,
    }
    if flight_rec is not None:
        flight_rec.save(args.journal, meta={"origin": args.origin})
        summary["journal"] = args.journal
        summary["journals"] = [args.journal] + child_journals
        summary["trace_origin"] = args.origin
        summary["trace_events"] = sum(
            1 for ev in flight_rec.snapshot() if ev[4].startswith("trace.")
        )
    text = json.dumps(summary, indent=None if args.json else 2)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    if not summary["completed"]:
        print("serve: tenants did not finish before --timeout",
              file=sys.stderr)
        return 1
    if args.parity and not parity_ok:
        return 1
    return 0


def tenant(args) -> int:
    host, _, pnum = args.connect.rpartition(":")
    rec = obs = trace = None
    if args.journal:
        rec, obs, trace = _build_observer(args.origin)
    client = RemoteServiceClient(
        host or "127.0.0.1", int(pnum), obs=obs, trace=trace
    )
    shard = TenantShard(
        args.name, n_validators=args.validators,
        target_height=args.heights, sign=not args.unsigned,
    ).attach_remote(client)
    t0 = time.perf_counter()
    shard.run_remote(max_inflight=args.inflight, timeout=args.timeout)
    client.close()
    report = {
        "name": shard.name,
        "done": shard.done,
        "commits": len(shard.commits),
        "digest": shard.commit_digest(),
        "wall_s": time.perf_counter() - t0,
        "rejected": shard.rejected,
        "shed_retries": shard.shed_retries,
        "commit_latency_p95_s": _percentile(shard.commit_latencies, 0.95),
    }
    if rec is not None:
        rec.save(args.journal, meta={"origin": args.origin})
        report["journal"] = args.journal
        report["trace_origin"] = args.origin
        report["clock_offsets"] = {
            str(o): off for o, off in sorted(client.clock_offsets.items())
        }
    print(json.dumps(report))
    return 0 if shard.done else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyperdrive_tpu_torch.parallel")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "serve", help="run the continuously-batching multi-tenant service"
    )
    p.add_argument("--tenants", type=int, default=4)
    p.add_argument("--heights", type=int, default=16)
    p.add_argument("--validators", type=int, default=4)
    p.add_argument("--policy", choices=("drr", "fifo"), default="drr")
    p.add_argument("--capacity-rows", type=int, default=256)
    p.add_argument("--quantum-rows", type=int, default=64)
    p.add_argument("--starve-after", type=int, default=4)
    p.add_argument("--weights", default="",
                   help="per-tenant DRR weights, e.g. tenant-0=3,tenant-1=1")
    p.add_argument("--verifier", choices=("host", "null", "device"),
                   default="device")
    p.add_argument("--max-depth", type=int, default=0,
                   help="queue auto-drain depth (0 = drive loop drains)")
    p.add_argument("--listen", action="store_true",
                   help="open the remote submit port even with no children")
    p.add_argument("--remote-tenants", type=int, default=0,
                   help="spawn K remote tenant subprocesses over TCP")
    p.add_argument("--parity", action="store_true",
                   help="assert shared-service digests == per-tenant-queue")
    p.add_argument("--journal", default="",
                   help="record a causal-trace journal here (children get "
                        "derived paths); enables frame stamping and the "
                        "TAG_METRICS plane")
    p.add_argument("--origin", type=int, default=1,
                   help="this process's trace origin id (children get "
                        "origin+1..origin+K)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--json", action="store_true",
                   help="single-line JSON summary")
    p.add_argument("-o", "--out", default="",
                   help="also write the summary JSON to this file")
    add_device_arg(p)
    p.set_defaults(fn=serve)

    p = sub.add_parser(
        "tenant", help="drive one remote tenant against a serve port"
    )
    p.add_argument("--connect", required=True, help="HOST:PORT of the serve")
    p.add_argument("--name", required=True)
    p.add_argument("--validators", type=int, default=4)
    p.add_argument("--heights", type=int, default=16)
    p.add_argument("--unsigned", action="store_true")
    p.add_argument("--inflight", type=int, default=4)
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--journal", default="",
                   help="record a causal-trace journal here")
    p.add_argument("--origin", type=int, default=2,
                   help="this process's trace origin id")
    p.set_defaults(fn=tenant)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
