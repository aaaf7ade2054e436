"""CLI: seeded attack campaigns as first-class workloads.

    python -m hyperdrive_tpu_torch.campaign run [--family F] [--seed N] ...
    python -m hyperdrive_tpu_torch.campaign replay DUMP.bin

``run`` executes the selected families (default: all three) at the
configured scale, judges each through the chaos monitor's campaign
checks, and — on any violation — dumps a replayable CampaignRecord
plus the obs journal next to it, with a one-line reproduce command.
``replay`` re-runs a dump's config from scratch and asserts the fresh
trajectory digest matches the recorded one bit-for-bit.

Both subcommands verify their storm and coincidence waves on
``--device``: a ``TorchBatchVerifier`` on the card by default (row 1,
``ed25519_verify``, one launch a wave), the reference's ``HostVerifier``
with ``--device cpu``. Without CUDA they exit non-zero unless ``--device
cpu`` is given.

Exit status: 0 clean, 1 violations (run) or digest mismatch (replay).

Port of the JAX package's ``campaign/__main__.py``: the same flags, lines,
JSON and dump files. The outcome digest is a pure function of the config,
so it is the reference's on either device. Deliberate differences: the
``--device`` option, and the reproduce line names this package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from hyperdrive_tpu_torch.campaign import FAMILIES, CampaignConfig
from hyperdrive_tpu_torch.campaign.record import CampaignRecord
from hyperdrive_tpu_torch.campaign.runner import replay_campaign, run_campaign
from hyperdrive_tpu_torch.utils.cli import add_device_arg, require_device


def _build_config(args, family: str) -> CampaignConfig:
    return CampaignConfig(
        family=family,
        seed=args.seed,
        validators=args.validators,
        committee_size=args.committee,
        epochs=args.epochs,
        epoch_length=args.epoch_length,
        attackers=args.attackers,
        waves=args.waves,
        wave_votes=args.wave_votes,
        attack_rate=args.attack_rate,
        sybils=args.sybils,
        budget_milli=args.budget_milli,
        grind_width=args.grind_width,
        reputation=not args.no_reputation,
    )


def _dump(outcome, out_dir: str, label: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(
        out_dir,
        "campaign-%s-%s" % (label, outcome.digest[:8].hex()),
    )
    outcome.record.dump(base + ".bin")
    with open(base + ".json", "w") as fh:
        json.dump(outcome.summary, fh, indent=1, sort_keys=True)
    return base + ".bin"


def _cmd_run(args) -> int:
    families = FAMILIES if args.family == "all" else (args.family,)
    from hyperdrive_tpu_torch.obs.metrics import Registry
    from hyperdrive_tpu_torch.obs.recorder import Recorder

    device = require_device(args.device)
    rc = 0
    results = []
    for family in families:
        config = _build_config(args, family)
        registry = Registry()
        recorder = Recorder()
        outcome = run_campaign(
            config, device=device, registry=registry, obs=recorder.scoped(-1)
        )
        results.append(outcome)
        status = "ok" if outcome.ok else "VIOLATION"
        print(
            "campaign %-11s seed=%d validators=%d digest=%s %s"
            % (
                family,
                config.seed,
                config.validators,
                outcome.digest[:8].hex(),
                status,
            )
        )
        if args.json:
            print(json.dumps(outcome.summary, sort_keys=True))
        if not outcome.ok:
            rc = 1
            for kind, detail in outcome.violations:
                print("  [%s] %s" % (kind, detail))
            path = _dump(outcome, args.out, family)
            recorder.save(
                os.path.splitext(path)[0] + ".journal.json",
                meta={"family": family, "seed": config.seed},
            )
            print(
                "  dumped %s\n  reproduce: python -m "
                "hyperdrive_tpu_torch.campaign replay %s" % (path, path)
            )
        elif args.dump_ok:
            path = _dump(outcome, args.dump_ok, family)
            print("  dumped %s" % path)
    return rc


def _cmd_replay(args) -> int:
    device = require_device(args.device)
    record = CampaignRecord.load_file(args.dump)
    ok, outcome = replay_campaign(record, device=device)
    status = "digest-identical" if ok else "DIGEST MISMATCH"
    print(
        "replay %-11s seed=%d recorded=%s fresh=%s %s"
        % (
            record.config.family,
            record.config.seed,
            record.digest[:8].hex(),
            outcome.digest[:8].hex(),
            status,
        )
    )
    if args.json:
        print(json.dumps(outcome.summary, sort_keys=True))
    if ok and not outcome.ok:
        # Identical trajectory that still violates: the record was
        # dumped FROM a violating run, and replay reproduced it.
        for kind, detail in outcome.violations:
            print("  [%s] %s" % (kind, detail))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyperdrive_tpu_torch.campaign",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run seeded attack campaigns")
    run.add_argument(
        "--family",
        choices=FAMILIES + ("all",),
        default="all",
        help="campaign family (default: all three)",
    )
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--validators", type=int, default=1024)
    run.add_argument("--committee", type=int, default=64)
    run.add_argument("--epochs", type=int, default=8)
    run.add_argument("--epoch-length", type=int, default=4)
    run.add_argument("--attackers", type=int, default=16)
    run.add_argument("--waves", type=int, default=6)
    run.add_argument("--wave-votes", type=int, default=2)
    run.add_argument("--attack-rate", type=int, default=8)
    run.add_argument("--sybils", type=int, default=16)
    run.add_argument("--budget-milli", type=int, default=200)
    run.add_argument("--grind-width", type=int, default=8)
    run.add_argument(
        "--no-reputation",
        action="store_true",
        help="disable the admission reputation loop (bench control)",
    )
    run.add_argument(
        "--out",
        default="campaign-failures",
        help="violation dump directory",
    )
    run.add_argument(
        "--dump-ok",
        default=None,
        metavar="DIR",
        help="also dump records for CLEAN runs (CI replay cross-check)",
    )
    run.add_argument("--json", action="store_true")
    add_device_arg(run)
    run.set_defaults(fn=_cmd_run)

    rp = sub.add_parser(
        "replay", help="re-run a dump, assert digest identity"
    )
    rp.add_argument("dump", help="CampaignRecord .bin path")
    rp.add_argument("--json", action="store_true")
    add_device_arg(rp)
    rp.set_defaults(fn=_cmd_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
