"""The deployment worker: threaded replicas on a loopback-TCP full mesh.

::

    python -m hyperdrive_tpu_torch.harness.deploy <port>... <rank> \\
        <replicas-per-process> <target> <host|card> [--deadline S] \\
        [--buckets B,...] [--check-host]

One worker process per port: worker ``rank`` listens on the rank-th port,
dials every other one, and runs replicas ``rank * k .. rank * k + k - 1``
(``k`` replicas per process) of an ``n = ports * k`` validator network on
one :class:`~hyperdrive_tpu_torch.transport.TcpNode`, each replica on its
own thread (:meth:`~hyperdrive_tpu_torch.replica.Replica.run`) with
wall-clock :class:`~hyperdrive_tpu_torch.timer.LinearTimer` timeouts and
signed envelopes, until every local replica has committed ``target``
heights. It prints ``TRANSPORT_OK rank=<r> heights=<target>
digest=<sha256 of the chain> mode=<mode> consulted=<n> grouped=<n>`` as
its last line; the caller checks the digests agree across processes.

``mode``:

- ``host``: :class:`~hyperdrive_tpu_torch.verifier.HostVerifier` per
  replica, per-message flushing; no device.
- ``card``: the deployment stack of :func:`build_card_stacks`: one
  :class:`~hyperdrive_tpu_torch.ops.ed25519_wire.TorchWireVerifier` with a
  resident :class:`~hyperdrive_tpu_torch.ops.ed25519_wire.ValidatorTable`
  for the process (grouped challenge route: ``ed25519_challenge``, then
  ``ed25519_semiwire``), one
  :class:`~hyperdrive_tpu_torch.tallyflush.DeviceTallyFlusher` (n = 1 vote
  grid) per replica with every device count checked against the host
  counters (``CheckedTallyView``), and coalesced inbox drains. Without
  CUDA it exits non-zero: it never runs on the CPU. Before the last line
  it prints the card's name, the run's wall, flushes, kernel launches and
  lanes, the share of replica-thread time spent in verification and in
  the grid's ``update_and_tally`` (the flushers' ``verify_seconds`` and
  ``tally_seconds``), and the frames shed from peer backlogs.

``--check-host`` (card mode) verifies every flush's window with
``HostVerifier`` as well and fails on any lane where the card's verdict
differs.

This is the port's counterpart of the JAX package's
``tests/transport_worker.py`` (two processes x two replicas; ``tpu`` mode
there is ``card`` here). It lives in the package because the card's
machine runs the port without JAX, and so without the JAX test suite.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import threading
import time

import numpy as np

from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
from hyperdrive_tpu_torch.testutil import CommitterCallback, MockProposer, MockValidator
from hyperdrive_tpu_torch.timer import LinearTimer
from hyperdrive_tpu_torch.transport import FlightRecorder, TcpBroadcaster, TcpNode
from hyperdrive_tpu_torch.verifier import HostVerifier

__all__ = [
    "NAMESPACE",
    "deterministic_value",
    "build_replica",
    "run_local_replicas",
    "commits_digest",
    "commit_rounds",
    "build_card_stacks",
    "main",
]

#: Key namespace of the deployment network (the JAX package's worker's).
NAMESPACE = b"tcp-demo"
#: LinearTimer base timeouts, seconds. The card mode's is well above a
#: height's wall at n = 256, so a run commits in round 0 unless a replica
#: really stalls.
HOST_TIMEOUT_S = 5.0
CARD_TIMEOUT_S = 20.0


def deterministic_value(height, round_):
    return hashlib.sha256(b"txval-%d-%d" % (height, round_)).digest()


def build_replica(node: TcpNode, ring: KeyRing, i: int, target: int,
                  commits: dict, done: threading.Event,
                  timeout_s: float = 5.0, verifier=None,
                  flusher=None, recorder=None) -> Replica:
    """One threaded replica wired to ``node``: a signing TcpBroadcaster, a
    LinearTimer (a wall-clock thread per timeout), a verifier
    (HostVerifier by default), and a committer recording into ``commits``
    that fires ``done`` at ``target`` heights. ``flusher`` plugs a flush
    delegate (a DeviceTallyFlusher) into the replica's flush seam."""
    cell: dict = {}
    timer = LinearTimer(
        handle_timeout_propose=lambda t: cell["r"].timeout(t),
        handle_timeout_prevote=lambda t: cell["r"].timeout(t),
        handle_timeout_precommit=lambda t: cell["r"].timeout(t),
        timeout=timeout_s,
    )

    def on_commit(height, value):
        commits[height] = value
        if len(commits) >= target:
            done.set()
        return 0, None

    rep = Replica(
        ReplicaOptions(),
        whoami=ring[i].public,
        signatories=list(ring.signatories),
        timer=timer,
        proposer=MockProposer(fn=deterministic_value),
        validator=MockValidator(ok=True),
        committer=CommitterCallback(on_commit=on_commit),
        catcher=None,
        broadcaster=TcpBroadcaster(node, keypair=ring[i]),
        verifier=verifier if verifier is not None else HostVerifier(),
        flusher=flusher,
        recorder=recorder,
    )
    cell["r"] = rep
    node.add_replica(rep)
    return rep


def run_local_replicas(node: TcpNode, ring: KeyRing, indices, target: int,
                       deadline_s: float = 120.0, timeout_s: float = 5.0,
                       make_stack=None, coalesce: bool = False,
                       recorders: dict | None = None):
    """Run replicas ``indices`` on ``node`` until each has committed
    ``target`` heights. Returns {index: {height: value}}.

    ``make_stack(i) -> (verifier, flusher)`` supplies each replica's
    verification stack; ``coalesce`` batches each replica's inbox drains
    (one flush, so one launch, per burst). ``recorders`` (a dict the
    caller owns) gets a FlightRecorder per index, filled even when the
    run stalls. Raises RuntimeError when the deadline passes first, and
    re-raises the first exception of a replica thread as soon as it
    happens."""
    commits = {i: {} for i in indices}
    dones = {i: threading.Event() for i in indices}
    reps = []
    for i in indices:
        verifier = flusher = None
        if make_stack is not None:
            verifier, flusher = make_stack(i)
        recorder = None
        if recorders is not None:
            recorder = recorders[i] = FlightRecorder()
        reps.append(
            build_replica(node, ring, i, target, commits[i], dones[i],
                          timeout_s=timeout_s, verifier=verifier,
                          flusher=flusher, recorder=recorder)
        )
    stop = threading.Event()
    errors: list = []

    def loop(rep):
        try:
            rep.run(stop, coalesce)
        except Exception as e:  # reported to the caller, below
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=loop, args=(r,), daemon=True) for r in reps]
    node.start()
    for t in threads:
        t.start()
    end = time.monotonic() + deadline_s
    while not errors and time.monotonic() < end:
        if all(d.wait(timeout=0.05) for d in dones.values()):
            break
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    node.stop()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a replica thread did not stop")
    if not all(d.is_set() for d in dones.values()):
        raise RuntimeError(
            f"stalled: heights {[len(c) for c in commits.values()]} of {target}"
        )
    return commits


def commits_digest(commits_by_index: dict, up_to: "int | None" = None) -> str:
    """One digest over all local chains, which must be identical: through
    height ``up_to`` when given (a replica may commit past the target
    while its neighbours finish), else whole."""
    chains = [
        tuple(sorted((h, v) for h, v in c.items() if up_to is None or h <= up_to))
        for c in commits_by_index.values()
    ]
    if any(c != chains[0] for c in chains):
        raise AssertionError("local replicas diverged")
    return hashlib.sha256(repr(chains[0]).encode()).hexdigest()


def commit_rounds(commits: dict, up_to: int, max_round: int = 64) -> list:
    """The round each height through ``up_to`` committed in: the round
    whose :func:`deterministic_value` the chain holds (-1 if none below
    ``max_round``). All zeros means no timeout moved a round."""
    out = []
    for h in range(1, up_to + 1):
        v = commits.get(h)
        out.append(next((r for r in range(max_round)
                         if deterministic_value(h, r) == v), -1))
    return out


class _HostChecked:
    """A pending card verification whose mask is held against
    HostVerifier's on the same items when it resolves."""

    def __init__(self, pending, items, host, checked: list):
        self._pending = pending
        self._items = items
        self._host = host
        self._checked = checked

    def mask(self):
        got = self._pending.mask()
        want = np.asarray(self._host.verify_signatures(self._items), dtype=bool)
        if not np.array_equal(np.asarray(got, dtype=bool), want):
            raise AssertionError(
                f"card mask differs from HostVerifier's on a window of "
                f"{len(self._items)}: lanes {np.flatnonzero(got != want).tolist()}"
            )
        self._checked.append(len(self._items))
        return got


def build_card_stacks(ring, collector: list, buckets=None, device=None,
                      check_host: bool = False):
    """The card-mode verification stack: ONE shared TorchWireVerifier
    (resident ValidatorTable, grouped challenge route) for the process and
    one DeviceTallyFlusher (n = 1 vote grid) per replica, every device
    count checked by a CheckedTallyView appended to ``collector``.

    Returns ``(verifier, make_stack, flushers, checked)``: ``make_stack(i)
    -> (verifier, flusher)`` for :func:`run_local_replicas`, the flushers
    it made, and the window sizes whose card mask was held against
    HostVerifier's (``check_host``; the host check runs inside the card
    mask's wait, so inside the flushers' ``verify_seconds``). The first
    flusher's warmup runs the grid program and every verifier route once
    for the whole process: PyTorch ops and the kernels build and load per
    process, not per grid."""
    from hyperdrive_tpu_torch.ops import votegrid
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher

    n = len(ring.signatories)
    table = ValidatorTable([ring[i].public for i in range(n)], device=device)
    kw = {} if buckets is None else {"buckets": tuple(buckets)}
    wv = TorchWireVerifier(table=table, device=device, **kw)
    checked: list = []
    if check_host:
        host = HostVerifier()
        begin = wv.verify_signatures_begin

        def checked_begin(items, repeats: int = 1):
            items = list(items)
            return _HostChecked(begin(items, repeats), items * repeats, host, checked)

        wv.verify_signatures_begin = checked_begin
    flushers: list = []

    def check(view, proc):
        v = votegrid.CheckedTallyView(view, proc)
        collector.append(v)
        return v

    def make_stack(i):
        fl = DeviceTallyFlusher(wv, list(ring.signatories), tally_check=check)
        if not flushers:
            fl.warmup()
        flushers.append(fl)
        return wv, fl

    return wv, make_stack, flushers, checked


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m hyperdrive_tpu_torch.harness.deploy",
        description="One worker of a loopback-TCP deployment network.",
    )
    ap.add_argument("args", nargs="+", type=str,
                    help="<port>... <rank> <replicas-per-process> <target> <host|card>")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds until an unfinished run fails (host 120, card 420)")
    ap.add_argument("--buckets", type=str, default=None,
                    help="verifier buckets, e.g. 64 (card; default the verifier's)")
    ap.add_argument("--check-host", action="store_true",
                    help="hold every card mask against HostVerifier's (card)")
    ns = ap.parse_args(argv)
    if len(ns.args) < 5:
        ap.error("need at least one port, rank, replicas-per-process, target, mode")
    *ports, rank, per, target, mode = ns.args
    if mode not in ("host", "card"):
        ap.error(f"mode must be host or card, got {mode!r}")
    return ns, [int(p) for p in ports], int(rank), int(per), int(target), mode


def main(argv=None) -> int:
    ns, ports, rank, per, target, mode = _parse(sys.argv[1:] if argv is None else argv)
    if not 0 <= rank < len(ports):
        raise SystemExit(f"rank {rank} outside 0..{len(ports) - 1}")
    n = len(ports) * per
    ring = KeyRing.deterministic(n, namespace=NAMESPACE)
    indices = range(rank * per, (rank + 1) * per)
    if mode == "host":
        node = TcpNode(listen_port=ports[rank])
        for p in ports:
            if p != ports[rank]:
                node.add_peer("127.0.0.1", p)
        commits = run_local_replicas(
            node, ring, indices, target,
            deadline_s=ns.deadline or 120.0, timeout_s=HOST_TIMEOUT_S,
        )
        print(f"TRANSPORT_OK rank={rank} heights={target} "
              f"digest={commits_digest(commits, target)} mode=host", flush=True)
        return 0

    import torch

    from hyperdrive_tpu_torch.ops import ed25519_cuda

    if not torch.cuda.is_available():
        print("deploy: card mode needs CUDA, and CUDA is not available",
              file=sys.stderr)
        return 2
    views: list = []
    buckets = None if ns.buckets is None else [int(b) for b in ns.buckets.split(",")]
    wv, make_stack, flushers, checked = build_card_stacks(
        ring, views, buckets=buckets, device="cuda", check_host=ns.check_host,
    )
    node = TcpNode(listen_port=ports[rank])
    for p in ports:
        if p != ports[rank]:
            node.add_peer("127.0.0.1", p)
    stacks = {i: make_stack(i) for i in indices}  # boot, warmup included
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    wv.reset_stats()
    for fl in flushers:
        fl.verify_seconds = fl.tally_seconds = 0.0
    t0 = time.perf_counter()
    commits = run_local_replicas(
        node, ring, indices, target,
        deadline_s=ns.deadline or 420.0, timeout_s=CARD_TIMEOUT_S,
        make_stack=stacks.__getitem__, coalesce=True,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    digest = commits_digest(commits, target)
    rounds = commit_rounds(commits[indices[0]], target)
    consulted = sum(v.hits for v in views)
    kst = ed25519_cuda.stats
    replica_s = wall * per
    verify_s = sum(f.verify_seconds for f in flushers)
    tally_s = sum(f.tally_seconds for f in flushers)
    print(f"DEPLOY_DEVICE rank={rank} name={torch.cuda.get_device_name(0)!r}",
          flush=True)
    print(
        f"DEPLOY_STATS rank={rank} n={n} replicas={per} heights={target} "
        f"wall_s={wall:.3f} heights_per_s={target / wall:.4f} "
        f"flushes={sum(f.launches for f in flushers)} "
        + "".join(f"{k}_launches={kst[k].launches} {k}_lanes={kst[k].lanes} "
                  for k in ("ed25519_challenge", "ed25519_semiwire", "ed25519_wire"))
        + f"lanes_grouped={wv.stats['lanes_grouped']} "
        f"verify_thread_s={verify_s:.3f} tally_thread_s={tally_s:.3f} "
        f"verify_share={verify_s / replica_s:.4f} tally_share={tally_s / replica_s:.4f} "
        f"commit_rounds={','.join(map(str, rounds))} "
        f"dropped_frames={sum(node.dropped_frames.values())} "
        f"malformed_frames={node.malformed_frames} "
        f"masks_checked={len(checked)}",
        flush=True,
    )
    print(f"TRANSPORT_OK rank={rank} heights={target} digest={digest} mode=card "
          f"consulted={consulted} grouped={wv.stats['lanes_grouped']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
