"""The overload soak CLI (CI's ``overload-soak`` job).

Usage::

    python -m hyperdrive_tpu_torch.load soak [--scenarios N] [--seed S]
        [--n N_REPLICAS] [--target H] [--rate R] [--out DIR]
        [--p99-factor F] [--escalate-every K]

Each scenario pushes an open-loop duplicate storm through the
deterministic harness and asserts the overload doctrine end-to-end
(ROBUSTNESS.md "Overload doctrine"):

``baseline``
    unloaded, certificates on, observed — the reference chain and the
    reference commit-latency anatomy.

``pinned``
    the same run plus the storm, admission spine pinned in the
    behavior-neutral band. Must commit the byte-identical chain (no
    fork, same digests), mint the same certificates (certificates are
    never shed), shed only ``duplicate``/``stale_height``, and keep
    the admission accounting identity exact
    (offered == admitted + shed).

``escalation`` (every ``--escalate-every``-th scenario)
    the same storm with ``pin`` off and the device-work queue watched,
    so live depth/drain signals escalate the level freely. The chain
    may differ from baseline (fresh prevotes become sheddable) but
    safety must hold, the run must still complete, and the
    admitted-work commit p99 must stay within ``--p99-factor`` of the
    baseline's — graceful degradation, not collapse.

Scenarios run unsigned and touch no device, so the soak takes no
``--device``.

Port of the JAX package's ``load/__main__.py``: the same flags, lines and
failure dumps. Dropped: the runtime sanitizer (``HD_SANITIZE=1``; the
port drops the lint hooks).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from hyperdrive_tpu_torch.harness.sim import Simulation
from hyperdrive_tpu_torch.load.generator import LoadProfile
from hyperdrive_tpu_torch.obs.report import anatomy

#: Spread scenario seeds so adjacent indices explore unrelated storms
#: (same stride as the chaos soak, so seed N here and there relate).
_SEED_STRIDE = 9973

#: Shed classes allowed in the behavior-neutral (digest-safe) band.
_NEUTRAL = {"duplicate", "stale_height"}


class SoakViolation(AssertionError):
    """One overload-doctrine invariant failed."""


def _p99(result_events) -> "float | None":
    vals = sorted(
        r["total_s"] for r in anatomy(result_events)
        if r["total_s"] is not None
    )
    if not vals:
        return None
    return vals[min(len(vals) - 1, int(0.99 * len(vals)))]


def _build(scen_seed: int, n: int, target: int, max_steps: int,
           load=None, escalate: bool = False):
    extra = {"certificates": True}
    if load is not None:
        extra["load"] = load
    if escalate:
        # The escalation leg watches a REAL device-work queue: settles
        # flush through it, depth/drain feed the controller. max_depth
        # sits above the low-priority threshold (64) so pressure can
        # actually cross it before the auto-drain relieves the queue.
        from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
        from hyperdrive_tpu_torch.verifier import NullVerifier

        queue = DeviceWorkQueue(max_depth=96)
        extra["devsched"] = queue
        extra["flusher_for"] = lambda i, validators: QueueFlusher(
            NullVerifier(), queue
        )
    sim = Simulation(
        n=n,
        target_height=target,
        seed=scen_seed,
        timeout=1.0,
        delivery_cost=1e-3,
        observe=True,
        **extra,
    )
    return sim


def _check_accounting(snap) -> None:
    shed_total = sum(snap["shed"].values())
    if snap["offered"] != snap["admitted"] + shed_total:
        raise SoakViolation(
            "admission accounting broken: offered "
            f"{snap['offered']} != admitted {snap['admitted']} "
            f"+ shed {shed_total}"
        )


def _check_certs_intact(base_sim, loaded_sim) -> None:
    """Certificates-never-shed, asserted structurally: the loaded run
    minted exactly the certificates the unloaded run did."""
    for i, (bc, lc) in enumerate(
        zip(base_sim.certifiers, loaded_sim.certifiers)
    ):
        if set(bc.certs) != set(lc.certs):
            raise SoakViolation(
                f"replica {i} certificate set diverged under load: "
                f"{sorted(set(bc.certs) ^ set(lc.certs))}"
            )


def _dump_failure(out: str, scen_seed: int, sim, err) -> str:
    os.makedirs(out, exist_ok=True)
    base = os.path.join(out, f"overload_seed_{scen_seed}")
    record = getattr(sim, "record", None)
    if record is not None:
        record.dump(base + ".bin")
    sim.obs.save(base + ".journal.json")
    with open(base + ".txt", "w") as fh:
        fh.write(f"seed={scen_seed}\nviolation={err}\n")
    return base


def soak(args) -> int:
    failures = 0
    for k in range(args.scenarios):
        scen_seed = args.seed + k * _SEED_STRIDE
        profile = LoadProfile.seeded(scen_seed, rate=args.rate)
        base_sim = _build(scen_seed, args.n, args.target, args.max_steps)
        sim = base_sim
        try:
            base = base_sim.run(max_steps=args.max_steps)
            base.assert_safety()
            base_p99 = _p99(base_sim.obs.snapshot())

            # ---- pinned leg: behavior-neutral storm, identical chain
            sim = _build(
                scen_seed, args.n, args.target, args.max_steps,
                load=profile,
            )
            res = sim.run(max_steps=args.max_steps)
            res.assert_safety()
            if res.commit_digest() != base.commit_digest():
                raise SoakViolation(
                    "pinned overload run forked from the unloaded chain"
                )
            _check_certs_intact(base_sim, sim)
            snap = sim.overload_snapshot()
            _check_accounting(snap)
            # Only vote duplicates at un-advanced heights are the
            # gate's guaranteed prey; a storm landing solely on
            # proposal deliveries or behind the commit edge is
            # admitted/height-filtered by doctrine and sheds nothing.
            if snap["injected_sheddable"] and not snap["shed"]:
                raise SoakViolation(
                    "sheddable storm injected but admission shed nothing"
                )
            bad = set(snap["shed"]) - _NEUTRAL
            if bad:
                raise SoakViolation(
                    f"behavior-neutral run shed classes {sorted(bad)}"
                )
            p99 = _p99(sim.obs.snapshot())
            if (
                base_p99 is not None
                and p99 is not None
                and p99 > base_p99 * args.p99_factor
            ):
                raise SoakViolation(
                    f"pinned admitted-work p99 {p99:.4f}s blew past "
                    f"{args.p99_factor}x baseline {base_p99:.4f}s"
                )
            print(
                f"ok seed={scen_seed} injected={snap['injected']} "
                f"shed={snap['shed']} p99={p99 if p99 is None else round(p99, 4)}"
            )

            # ---- escalation leg: live signals, graceful degradation
            if args.escalate_every and k % args.escalate_every == 0:
                esc_profile = dataclasses.replace(profile, pin=False)
                sim = _build(
                    scen_seed, args.n, args.target, args.max_steps,
                    load=esc_profile, escalate=True,
                )
                eres = sim.run(max_steps=args.max_steps)
                eres.assert_safety()
                if not eres.completed:
                    raise SoakViolation(
                        "escalation run collapsed: target height never "
                        "reached under load"
                    )
                esnap = sim.overload_snapshot()
                _check_accounting(esnap)
                ep99 = _p99(sim.obs.snapshot())
                if (
                    base_p99 is not None
                    and ep99 is not None
                    and ep99 > base_p99 * args.p99_factor
                ):
                    raise SoakViolation(
                        f"escalation admitted-work p99 {ep99:.4f}s blew "
                        f"past {args.p99_factor}x baseline "
                        f"{base_p99:.4f}s"
                    )
                print(
                    f"ok escalation seed={scen_seed} "
                    f"level<={esnap['level']} "
                    f"transitions={esnap['transitions']} "
                    f"shed={esnap['shed']} "
                    f"p99={ep99 if ep99 is None else round(ep99, 4)}"
                )
        except AssertionError as err:
            failures += 1
            base_path = _dump_failure(args.out, scen_seed, sim, err)
            print(
                f"FAIL seed={scen_seed} {err}\n"
                f"  dumped {base_path}.journal.json (+ record)",
                file=sys.stderr,
            )
            if not args.keep_going:
                return 1
            continue
    if failures:
        print(f"soak FAILED: {failures}/{args.scenarios}", file=sys.stderr)
        return 1
    print(f"overload soak ok: {args.scenarios} scenarios, 0 violations")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyperdrive_tpu_torch.load")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "soak", help="run N seeded overload scenarios (CI overload-soak)"
    )
    p.add_argument("--scenarios", type=int, default=6)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--target", type=int, default=6)
    p.add_argument("--rate", type=float, default=3000.0,
                   help="nominal storm rate (duplicates per virtual s)")
    p.add_argument("--max-steps", type=int, default=500_000)
    p.add_argument("--out", default="load_failures")
    p.add_argument(
        "--p99-factor", type=float, default=3.0,
        help="admitted-work commit p99 must stay within this multiple "
        "of the unloaded baseline's",
    )
    p.add_argument(
        "--escalate-every", type=int, default=2,
        help="run every Kth scenario unpinned with the device queue "
        "watched, asserting graceful degradation (0 = off)",
    )
    p.add_argument("--keep-going", action="store_true")
    p.set_defaults(fn=soak)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
