"""Devsched parity smoke: pipelined runs must commit the sequential chain.

Usage::

    python -m hyperdrive_tpu_torch.devsched parity [--n N] [--heights H]
        [--seed S] [--device] [--buckets 64,256]

Runs the same scenario sequentially and pipelined and compares
:meth:`~hyperdrive_tpu_torch.harness.sim.SimulationResult.commit_digest`:
byte-identical chains or exit 1. Two legs by default, both on the host:

- ``burst``: signed supersteps through the ``HostVerifier``, sequential vs
  ``pipeline_heights=True`` (speculative settle, gated commits);
- ``lockstep``: unsigned delivery, blocking flush vs queue-backed
  :class:`~hyperdrive_tpu_torch.devsched.QueueFlusher` replicas sharing one
  :class:`~hyperdrive_tpu_torch.devsched.DeviceWorkQueue`.

``--device`` adds the card leg: a
:class:`~hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier` with the
``--buckets`` ladder and device tallies, on the card (it exits non-zero
without CUDA).

Every run is observed (``observe=True``), as in the reference.

Port copy of ``hyperdrive_tpu/devsched/__main__.py``. ``HD_SANITIZE=1``
in the environment arms the runtime consensus sanitizer, as in the
reference.
"""

from __future__ import annotations

import argparse
import sys

from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
from hyperdrive_tpu_torch.harness.sim import Simulation
from hyperdrive_tpu_torch.verifier import HostVerifier, NullVerifier


def _leg_burst(args):
    kw = dict(
        n=args.n, target_height=args.heights, seed=args.seed,
        sign=True, burst=True, observe=True,
    )
    seq = Simulation(batch_verifier=HostVerifier(), **kw).run()
    sim = Simulation(batch_verifier=HostVerifier(), pipeline_heights=True, **kw)
    pipe = sim.run()
    return seq, pipe, sim._sched


def _leg_lockstep(args):
    kw = dict(
        n=args.n, target_height=args.heights, seed=args.seed,
        timeout=1.0, delivery_cost=1e-3, observe=True,
    )
    seq = Simulation(**kw).run()
    q = DeviceWorkQueue(max_depth=8)
    pipe = Simulation(
        devsched=q,
        flusher_for=lambda i, validators: QueueFlusher(NullVerifier(), q),
        **kw,
    ).run()
    return seq, pipe, q


def _leg_device(args):
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    buckets = tuple(int(b) for b in args.buckets.split(","))
    kw = dict(
        n=args.n, target_height=args.heights, seed=args.seed,
        sign=True, burst=True, observe=True,
        dedup_verify=True, device_tally=True,
    )
    seq = Simulation(
        batch_verifier=TorchBatchVerifier(buckets=buckets), **kw
    ).run()
    sim = Simulation(
        batch_verifier=TorchBatchVerifier(buckets=buckets),
        pipeline_heights=True,
        **kw,
    )
    pipe = sim.run()
    return seq, pipe, sim._sched


def parity(args) -> int:
    legs = {"burst": _leg_burst, "lockstep": _leg_lockstep}
    if args.device:
        legs["device"] = _leg_device
    failed = 0
    for name, leg in legs.items():
        seq, pipe, q = leg(args)
        d_seq, d_pipe = seq.commit_digest(), pipe.commit_digest()
        ok = seq.completed and pipe.completed and d_seq == d_pipe
        print(
            f"{'ok' if ok else 'FAIL'} {name}: digest {d_seq[:16]} "
            f"{'==' if d_seq == d_pipe else '!='} {d_pipe[:16]} "
            f"sched={q.submitted} submitted / {q.launches} launches "
            f"({q.coalesced} coalesced)"
        )
        if not ok:
            failed += 1
        if q.coalesced == 0:
            print(f"FAIL {name}: queue never coalesced", file=sys.stderr)
            failed += 1
    if failed:
        print(f"parity FAILED: {failed} checks", file=sys.stderr)
        return 1
    print(f"parity ok: {len(legs)} legs, pipelined == sequential")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyperdrive_tpu_torch.devsched")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "parity", help="pipelined-vs-sequential commit-digest smoke"
    )
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--heights", type=int, default=6)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument(
        "--device", action="store_true",
        help="also run the card leg (TorchBatchVerifier + device tally)",
    )
    p.add_argument(
        "--buckets", default="64,256",
        help="card-leg verify bucket ladder (comma-separated)",
    )
    p.set_defaults(fn=parity)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
