"""The port's deployment path against the JAX package's: wire frames,
reconnect schedules, checkpoints, flight logs, the threaded replica loop
over loopback TCP, and the two-process deployment worker.

Frames, checkpoints and flight logs must be byte for byte the JAX
package's on seeded inputs; socket runs must commit identical chains in
every replica and every process.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from itertools import islice

import numpy as np
import pytest
import torch

from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.messages import Precommit as RefPrecommit
from hyperdrive_tpu.messages import Prevote as RefPrevote
from hyperdrive_tpu.messages import Propose as RefPropose
from hyperdrive_tpu.replica import Replica as RefReplica
from hyperdrive_tpu.replica import ReplicaOptions as RefReplicaOptions
from hyperdrive_tpu.replica import ResetHeight as RefResetHeight
from hyperdrive_tpu.testutil import CommitterCallback as RefCommitterCallback
from hyperdrive_tpu.testutil import MockProposer as RefMockProposer
from hyperdrive_tpu.testutil import MockValidator as RefMockValidator
from hyperdrive_tpu.transport import FlightRecorder as RefFlightRecorder
from hyperdrive_tpu.transport import encode_frame as ref_encode_frame
from hyperdrive_tpu.transport import reconnect_schedule as ref_reconnect_schedule
from hyperdrive_tpu.transport import replay_flight as ref_replay_flight
from hyperdrive_tpu.utils import checkpoint as ref_ckpt
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.codec import SerdeError
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.harness import deploy
from hyperdrive_tpu_torch.harness.deploy import (
    NAMESPACE,
    commit_rounds,
    commits_digest,
    deterministic_value,
    run_local_replicas,
)
from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions, ResetHeight
from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
from hyperdrive_tpu_torch.testutil import CommitterCallback, MockProposer, MockValidator
from hyperdrive_tpu_torch.transport import (
    _PEER_QUEUE,
    FlightRecorder,
    TcpNode,
    encode_frame,
    reconnect_schedule,
    replay_flight,
)
from hyperdrive_tpu_torch.utils import checkpoint
from hyperdrive_tpu_torch.types import INVALID_ROUND
from hyperdrive_tpu_torch.verifier import HostVerifier, NullVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _seeded_messages(seed):
    """The same signed Propose, Prevote and Precommit from both packages:
    fields from a numpy generator, signatures from each package's ring."""
    rng = np.random.default_rng(seed)
    ring, ref_ring = KeyRing.deterministic(3, b"frames"), RefKeyRing.deterministic(
        3, b"frames")
    h, r = int(rng.integers(1, 1 << 40)), int(rng.integers(0, 50))
    vals = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(3)]
    payload = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
    ours = [
        Propose(height=h, round=r, valid_round=r - 1, value=vals[0],
                sender=ring[0].public, payload=payload),
        Prevote(height=h, round=r, value=vals[1], sender=ring[1].public),
        Precommit(height=h, round=r, value=vals[2], sender=ring[2].public),
    ]
    theirs = [
        RefPropose(height=h, round=r, valid_round=r - 1, value=vals[0],
                   sender=ref_ring[0].public, payload=payload),
        RefPrevote(height=h, round=r, value=vals[1], sender=ref_ring[1].public),
        RefPrecommit(height=h, round=r, value=vals[2], sender=ref_ring[2].public),
    ]
    ours = [ring[i].sign_message(m) for i, m in enumerate(ours)]
    theirs = [ref_ring[i].sign_message(m) for i, m in enumerate(theirs)]
    return ours, theirs


# ------------------------------------------------------------- frames


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["propose", "prevote", "precommit"])
@pytest.mark.parametrize("seed", [3, 11])
def test_encode_frame_is_the_jax_frame(kind, seed):
    ours, theirs = _seeded_messages(seed)
    frame = encode_frame(ours[kind])
    assert frame == ref_encode_frame(theirs[kind])
    assert struct.unpack("<I", frame[:4])[0] == len(frame) - 4


@pytest.mark.parametrize("seed,key", [
    (7, ("127.0.0.1", 4242)),
    (0, ("127.0.0.1", 9)),
    (123456789, None),
])
def test_reconnect_schedule_is_the_jax_schedule(seed, key):
    got = list(islice(reconnect_schedule(seed, key), 12))
    assert got == list(islice(ref_reconnect_schedule(seed, key), 12))
    assert all(d <= 2.0 * 1.5 for d in got)


@pytest.mark.parametrize("bad", [
    {"cap": 0.01}, {"base": -1.0}, {"factor": 0.5}, {"jitter": -0.1},
])
def test_reconnect_schedule_refuses_as_jax_does(bad):
    with pytest.raises(ValueError) as ours:
        next(reconnect_schedule(7, None, **bad))
    with pytest.raises(ValueError) as theirs:
        next(ref_reconnect_schedule(7, None, **bad))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError):
        TcpNode(seed=7, backoff=bad)


class _Sink:
    def __init__(self):
        self.got = []

    def propose(self, m, stop=None):
        self.got.append(m)

    prevote = precommit = timeout = propose


def test_malformed_and_oversize_frames_do_not_poison_the_node():
    node = TcpNode()
    sink = _Sink()
    node.add_replica(sink)
    node.start()
    ring = KeyRing.deterministic(1, namespace=b"rogue")
    pv = ring[0].sign_message(
        Prevote(height=1, round=0, value=b"\x01" * 32, sender=ring[0].public)
    )
    try:
        with socket.create_connection(("127.0.0.1", node.port)) as s:
            s.sendall(struct.pack("<I", 12) + b"\xff" * 12)  # malformed envelope
            s.sendall(encode_frame(pv))  # the same connection survives it
        with socket.create_connection(("127.0.0.1", node.port)) as s:
            s.sendall(struct.pack("<I", 1 << 30))  # absurd length: dropped
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not (
            sink.got and node.oversize_frames
        ):
            time.sleep(0.01)
    finally:
        node.stop()
    assert sink.got == [pv] and sink.got[0].signature == pv.signature
    assert node.malformed_frames == 1
    assert node.oversize_frames == 1


def test_peer_backlog_overflow_sheds_the_oldest_frames():
    node = TcpNode()  # never started: no sender drains the queue
    (dead_port,) = _free_ports(1)
    try:
        node.add_peer("127.0.0.1", dead_port)
        frames = [
            Prevote(height=1, round=r, value=b"\x05" * 32, sender=b"\x01" * 32)
            for r in range(_PEER_QUEUE + 3)
        ]
        for pv in frames:
            node.broadcast(pv)
        key = ("127.0.0.1", dead_port)
        assert node.dropped_frames == {key: 3}
        q = node._peer_queues[key]
        assert q.qsize() == _PEER_QUEUE
        assert q.get_nowait() == encode_frame(frames[3])
    finally:
        node.stop()


def test_inbox_methods_enqueue_and_reset_height_jumps():
    ring = KeyRing.deterministic(4, NAMESPACE)
    rep = _fresh(ring.signatories, 0)
    v = b"\x02" * 32
    msgs = [Propose(height=1, round=0, valid_round=-1, value=v, sender=ring[1].public),
            Prevote(height=1, round=0, value=v, sender=ring[1].public),
            Precommit(height=1, round=0, value=v, sender=ring[1].public)]
    rep.propose(msgs[0])
    rep.prevote(msgs[1])
    rep.precommit(msgs[2])
    rep.reset_height(1)  # not above the current height: ignored
    rep.reset_height(7, ring.signatories[:3])
    got = [rep._inbox.get_nowait() for _ in range(4)]
    assert got[:3] == msgs and rep._inbox.empty()
    assert got[3] == ResetHeight(7, tuple(ring.signatories[:3]))
    rep.start()
    rep.handle(got[3])
    assert rep.proc.current_height == 7
    assert rep.procs_allowed == set(ring.signatories[:3])


def test_unported_node_features_refuse():
    with pytest.raises(NotImplementedError):
        TcpNode(admission=object())
    with pytest.raises(NotImplementedError):
        TcpNode(trace=object())
    with pytest.raises(NotImplementedError):
        TcpNode(registry=object())
    node = TcpNode()
    try:
        with pytest.raises(NotImplementedError):
            node.rotate_epoch(1)
    finally:
        node.stop()


def test_kernel_counts_lose_no_launch_under_thread_switches():
    # Replica threads of one process count kernel launches concurrently.
    st = ed25519_cuda.KernelStats()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [st.add(3) for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 1))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (st.launches, st.lanes) == (2000 * len(threads), 6000 * len(threads))


# --------------------------------------------------------- checkpoints


@pytest.mark.parametrize("seed", [1, 5])
def test_checkpoint_bytes_are_the_jax_bytes(seed):
    sim = Simulation(n=4, target_height=3, seed=seed, burst=True)
    ref = RefSimulation(n=4, target_height=3, seed=seed, burst=True)
    assert sim.run().commit_digest(up_to=3) == ref.run().commit_digest(up_to=3)
    for ours, theirs in zip(sim.replicas, ref.replicas):
        got = checkpoint.checkpoint_bytes(ours.proc)
        assert got == ref_ckpt.checkpoint_bytes(theirs.proc)
        assert ours.proc.current_height >= 4


def _fresh(sigs, i, cls=Replica, opts=ReplicaOptions):
    return cls(
        opts(), whoami=sigs[i], signatories=list(sigs), timer=None,
        proposer=None, validator=None, committer=None, catcher=None,
        broadcaster=None,
    )


def test_checkpoints_restore_across_the_packages(tmp_path):
    sim = Simulation(n=4, target_height=3, seed=2, burst=True)
    ref = RefSimulation(n=4, target_height=3, seed=2, burst=True)
    sim.run()
    ref.run()
    sigs = sim.signatories
    for i in range(4):
        theirs = ref_ckpt.checkpoint_bytes(ref.replicas[i].proc)
        ours = checkpoint.checkpoint_bytes(sim.replicas[i].proc)
        port_rep = _fresh(sigs, i)
        port_rep.restore(theirs)
        assert checkpoint.checkpoint_bytes(port_rep.proc) == theirs
        ref_rep = _fresh(sigs, i, RefReplica, RefReplicaOptions)
        ref_rep.restore(ours)
        assert ref_ckpt.checkpoint_bytes(ref_rep.proc) == ours
    # The file layer and the store keep the same envelope.
    ours0 = checkpoint.checkpoint_bytes(sim.replicas[0].proc)
    path = str(tmp_path / "replica.ckpt")
    checkpoint.save_process(sim.replicas[0].proc, path)
    rep = _fresh(sigs, 0)
    checkpoint.restore_process(rep.proc, path)
    assert checkpoint.checkpoint_bytes(rep.proc) == ours0
    store = checkpoint.CheckpointStore()
    assert not store.restore(0, rep.proc)
    store.save(0, sim.replicas[0].proc)
    assert store.latest(0) == ours0 and len(store) == 1
    dump = tmp_path / "dump"
    assert store.dump(str(dump)) == [str(dump / "replica_0.ckpt")]
    # Corruption is refused without touching the process.
    for bad in (ours0[:-1], b"\x00" + ours0[1:], ours0[:-1] + bytes([ours0[-1] ^ 1])):
        with pytest.raises(SerdeError):
            checkpoint.restore_bytes(rep.proc, bad)
    assert checkpoint.checkpoint_bytes(rep.proc) == ours0
    # restore(None) is genesis recovery at the starting height.
    rep.restore(None)
    assert rep.proc.current_height == ReplicaOptions().starting_height
    assert rep.proc.current_round == 0


# ---------------------------------------------------------- flight logs


def test_jax_flight_log_loads_in_the_port(tmp_path):
    ours, theirs = _seeded_messages(5)
    ring = KeyRing.deterministic(4, NAMESPACE)
    rec, ref_rec = FlightRecorder(), RefFlightRecorder()
    for m in theirs:
        ref_rec.record(m)
    ref_rec.record(RefResetHeight(9, tuple(ring.signatories)))
    for m in ours:
        rec.record(m)
    rec.record(ResetHeight(9, tuple(ring.signatories)))
    assert rec.frames == ref_rec.frames
    path = tmp_path / "jax.log"
    ref_rec.dump(path)
    loaded = FlightRecorder.load(path)
    assert loaded[:3] == ours
    assert [m.signature for m in loaded[:3]] == [m.signature for m in ours]
    assert loaded[3] == ResetHeight(9, tuple(ring.signatories))
    # Killed mid-write: the partial trailing frame is dropped.
    blob = path.read_bytes()
    for cut in (3, len(ref_rec.frames[-1]) - 1):
        ragged = tmp_path / f"ragged{cut}.log"
        ragged.write_bytes(blob[:-cut])
        assert FlightRecorder.load(ragged) == loaded[:3]
    bad = tmp_path / "bad.log"
    bad.write_bytes(b"\x07" + blob[1:])
    with pytest.raises(SerdeError):
        FlightRecorder.load(bad)


class _Loopback:
    """Broadcaster wired straight back into its replica (self-delivery)."""

    def __init__(self):
        self.rep = None

    def broadcast_propose(self, m):
        self.rep.handle(m)

    broadcast_prevote = broadcast_precommit = broadcast_propose


def _mesh(n):
    nodes = [TcpNode() for _ in range(n)]
    for a in range(n):
        for b in range(n):
            if a != b:
                nodes[a].add_peer("127.0.0.1", nodes[b].port)
    return nodes


def _run_mesh(target, coalesce=False, recorders=None):
    """Four single-replica nodes in this process over real sockets, each
    driven on its own thread; returns each node's {index: commits}."""
    ring = KeyRing.deterministic(4, namespace=NAMESPACE)
    nodes = _mesh(4)
    results = [None] * 4
    errors = []

    def drive(i):
        try:
            results[i] = run_local_replicas(
                nodes[i], ring, (i,), target, deadline_s=60.0, timeout_s=2.0,
                coalesce=coalesce,
                recorders=None if recorders is None else recorders[i],
            )
        except Exception as e:  # reported below
            errors.append((i, e))

    runners = [threading.Thread(target=drive, args=(i,), daemon=True) for i in range(4)]
    for t in runners:
        t.start()
    for t in runners:
        t.join(timeout=90.0)
    assert not any(t.is_alive() for t in runners)
    assert not errors, errors
    return ring, results


@pytest.mark.parametrize("coalesce", [False, True])
def test_threaded_replicas_commit_one_chain_over_sockets(coalesce):
    _, results = _run_mesh(3, coalesce=coalesce)
    digests = {commits_digest(r, 3) for r in results}
    assert len(digests) == 1
    chain = results[0][0]
    assert set(range(1, 4)) <= set(chain)
    assert chain[1] in {deterministic_value(1, r) for r in range(3)}
    assert min(commit_rounds(chain, 3)) >= 0


@pytest.mark.parametrize("coalesce", [False, True])
def test_socket_run_replays_offline_from_its_flight_logs(tmp_path, coalesce):
    # Each replica's log of a port run replays offline to the live chain,
    # through the port's replay_flight into a port Replica and through the
    # JAX package's into a JAX Replica with the same keys, proposer and
    # host verifier.
    recs = [dict() for _ in range(4)]
    ring, results = _run_mesh(3, coalesce=coalesce, recorders=recs)
    ref_ring = RefKeyRing.deterministic(4, namespace=NAMESPACE)
    assert list(ref_ring.signatories) == list(ring.signatories)

    def offline(pkg, i, commits):
        Rep, Opts, Prop, Val, Com, Ver = pkg
        return Rep(
            Opts(), whoami=ring[i].public, signatories=list(ring.signatories),
            timer=None, proposer=Prop(fn=deterministic_value), validator=Val(ok=True),
            committer=Com(
                on_commit=lambda h, v, c=commits: (c.__setitem__(h, v), (0, None))[1]),
            catcher=None, broadcaster=None, verifier=Ver(),
        )

    port = (Replica, ReplicaOptions, MockProposer, MockValidator, CommitterCallback,
            HostVerifier)
    ref = (RefReplica, RefReplicaOptions, RefMockProposer, RefMockValidator,
           RefCommitterCallback, RefHostVerifier)
    for i in range(4):
        path = tmp_path / f"flight_{i}.log"
        recs[i][i].dump(path)
        assert len(FlightRecorder.load(path)) == len(recs[i][i].frames)
        for label, pkg, replay in (("port", port, replay_flight),
                                   ("jax", ref, ref_replay_flight)):
            commits: dict = {}
            replay(path, offline(pkg, i, commits))
            assert commits == results[i][i], f"replica {i} replay diverged ({label})"


def test_two_process_host_deployment():
    ports = _free_ports(2)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    cmd = [sys.executable, "-m", "hyperdrive_tpu_torch.harness.deploy",
           *map(str, ports)]
    procs = [
        subprocess.Popen(cmd + [str(rank), "2", "5", "host"], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    fields = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        line = out.strip().splitlines()[-1]
        assert line.startswith(f"TRANSPORT_OK rank={rank} heights=5 "), out
        fields.append(dict(kv.split("=", 1) for kv in line.split()[1:]))
    assert fields[0]["digest"] == fields[1]["digest"]
    assert {f["mode"] for f in fields} == {"host"}


def test_worker_timing_counts_nested_calls_once_and_host_check_raises():
    # The worker's verify and tally shares are its flushers' own counters:
    # the flusher times its outer verifier call, so what that call does
    # inside (here a nested call) counts once.
    calls = []

    class Sleepy(NullVerifier):
        def verify_batch(self, window):
            calls.append(len(window))
            time.sleep(0.02)
            return self.inner(window)

        def inner(self, window):
            time.sleep(0.02)
            return super().verify_batch(window)

    ring = KeyRing.deterministic(4, namespace=NAMESPACE)
    sigs = list(ring.signatories)
    fl = DeviceTallyFlusher(Sleepy(), sigs, device="cpu")
    commits: dict = {}
    loop = _Loopback()
    rep = Replica(
        ReplicaOptions(), whoami=sigs[0], signatories=sigs, timer=None,
        proposer=MockProposer(fn=deterministic_value), validator=MockValidator(ok=True),
        committer=CommitterCallback(
            on_commit=lambda h, v: (commits.__setitem__(h, v), (0, None))[1]),
        catcher=None, broadcaster=loop, verifier=None, flusher=fl,
    )
    loop.rep = rep
    rep.start()
    v = deterministic_value(1, 0)
    rep.handle(Propose(height=1, round=0, valid_round=INVALID_ROUND, value=v,
                       sender=sigs[1]))
    for kind in (Prevote, Precommit):
        for s in sigs[1:]:
            rep.handle(kind(height=1, round=0, value=v, sender=s))
    assert commits == {1: v}
    assert calls and fl.launches == len(calls)
    assert 0.04 * len(calls) <= fl.verify_seconds < 0.055 * len(calls)
    assert fl.tally_seconds > 0.0

    class Pending:
        def __init__(self, mask):
            self._mask = np.array(mask, dtype=bool)

        def mask(self):
            return self._mask

    class Host:
        def verify_signatures(self, items):
            return [bool(sig) for _, _, sig in items]

    items = [(b"a", b"d", b"s"), (b"b", b"d", b"")]
    checked = []
    ok = deploy._HostChecked(Pending([True, False]), items, Host(), checked)
    assert list(ok.mask()) == [True, False] and checked == [2]
    bad = deploy._HostChecked(Pending([True, True]), items, Host(), checked)
    with pytest.raises(AssertionError, match="lanes \\[1\\]"):
        bad.mask()


def test_card_worker_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the card worker would run on it")
    proc = subprocess.run(
        [sys.executable, "-m", "hyperdrive_tpu_torch.harness.deploy",
         *map(str, _free_ports(2)), "0", "2", "3", "card"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode != 0
    assert "TRANSPORT_OK" not in proc.stdout
