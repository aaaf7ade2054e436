"""The port's DeviceTallyFlusher and QueueFlusher against the JAX
package's: one replica's n = 1 vote grid behind its own flush seam.

Each case drives the same script of messages (N = 4 validators) through
a JAX replica with the JAX flusher (JAX ``VoteGrid`` on the CPU) and a
port replica with the port flusher (``device="cpu"``: the grid's PyTorch
ops on the CPU), and requires equal commits, equal tally launches and,
launch for launch, equal counts in the TallyView each launch handed the
rule cascade, with every device count checked against the host counters
(``CheckedTallyView`` hits > 0). The tolerance is exact equality: the
counts are integers.
"""

import hashlib

import numpy as np
import torch

from hyperdrive_tpu import batch as ref_batch
from hyperdrive_tpu import messages as ref_messages
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.devsched import DeviceWorkQueue as RefDeviceWorkQueue
from hyperdrive_tpu.devsched import QueueFlusher as RefQueueFlusher
from hyperdrive_tpu.ops.votegrid import CheckedTallyView as RefCheckedTallyView
from hyperdrive_tpu.replica import Replica as RefReplica
from hyperdrive_tpu.replica import ReplicaOptions as RefReplicaOptions
from hyperdrive_tpu.tallyflush import DeviceTallyFlusher as RefDeviceTallyFlusher
from hyperdrive_tpu.testutil import CommitterCallback as RefCommitterCallback
from hyperdrive_tpu.testutil import MockProposer as RefMockProposer
from hyperdrive_tpu.testutil import MockValidator as RefMockValidator
from hyperdrive_tpu.utils.checkpoint import checkpoint_bytes as ref_checkpoint_bytes
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu.verifier import NullVerifier as RefNullVerifier
from hyperdrive_tpu_torch import batch as port_batch
from hyperdrive_tpu_torch import messages
from hyperdrive_tpu_torch.certificates import Certifier
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, FifoDrainPolicy, QueueFlusher
from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
from hyperdrive_tpu_torch.testutil import CommitterCallback, MockProposer, MockValidator
from hyperdrive_tpu_torch.types import INVALID_ROUND
from hyperdrive_tpu_torch.utils.checkpoint import checkpoint_bytes
from hyperdrive_tpu_torch.verifier import NullVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

N = 4
SIGS = [bytes([i + 1]) * 32 for i in range(N)]
COUNT_KEYS = ("matching", "nil", "total", "l28")

PORT = dict(
    msgs=messages, Replica=Replica, Options=ReplicaOptions,
    Flusher=DeviceTallyFlusher, Checked=CheckedTallyView, Queue=DeviceWorkQueue,
    QueueFlusher=QueueFlusher, Null=NullVerifier, Committer=CommitterCallback,
    Proposer=MockProposer, Validator=MockValidator, ckpt=checkpoint_bytes,
    flusher_kw=dict(device="cpu"),
)
JAX = dict(
    msgs=ref_messages, Replica=RefReplica, Options=RefReplicaOptions,
    Flusher=RefDeviceTallyFlusher, Checked=RefCheckedTallyView,
    Queue=RefDeviceWorkQueue, QueueFlusher=RefQueueFlusher, Null=RefNullVerifier,
    Committer=RefCommitterCallback, Proposer=RefMockProposer,
    Validator=RefMockValidator, ckpt=ref_checkpoint_bytes, flusher_kw={},
)


def _value(height, round_):
    return hashlib.sha256(b"flushval-%d-%d" % (height, round_)).digest()


class _Loopback:
    """Broadcaster wired straight back into the replica (the contract
    includes self-delivery; handle()'s reentrancy buffer serializes it)."""

    def __init__(self):
        self.rep = None

    def broadcast_propose(self, m):
        self.rep.handle(m)

    broadcast_prevote = broadcast_precommit = broadcast_propose


class _Run:
    """One replica of one package behind a flusher, with every launch's
    checked TallyView kept."""

    def __init__(self, pkg, verifier=None, sigs=SIGS, certifier=None, **flusher_kw):
        self.pkg = pkg
        self.views = []
        self.commits: dict = {}

        def check(view, proc):
            cv = pkg["Checked"](view, proc)
            self.views.append(cv)
            return cv

        self.verifier = pkg["Null"]() if verifier is None else verifier
        self.fl = pkg["Flusher"](self.verifier, list(sigs), tally_check=check,
                                 certifier=certifier, **pkg["flusher_kw"], **flusher_kw)
        lb = _Loopback()
        self.rep = pkg["Replica"](
            pkg["Options"](), whoami=sigs[0], signatories=list(sigs),
            timer=None, proposer=pkg["Proposer"](fn=_value),
            validator=pkg["Validator"](ok=True),
            committer=pkg["Committer"](
                on_commit=lambda h, v: (self.commits.__setitem__(h, v), (0, None))[1]),
            catcher=None, broadcaster=lb, verifier=None, flusher=self.fl,
            certifier=certifier,
        )
        lb.rep = self.rep

    def counts(self):
        return [
            {k: np.asarray(v.view.counts[k]) for k in COUNT_KEYS} for v in self.views
        ]

    def hits(self):
        return sum(v.hits for v in self.views)


def _script(pkg, heights, signature=b""):
    """The other three validators' messages for a clean run of
    ``heights`` heights, round 0 each; replica 0's own votes self-deliver
    through the loopback."""
    m = pkg["msgs"]
    out = []
    for h in range(1, heights + 1):
        proposer = SIGS[h % N]
        v = _value(h, 0)
        if proposer != SIGS[0]:
            out.append(m.Propose(height=h, round=0, valid_round=INVALID_ROUND,
                                 value=v, sender=proposer))
        out += [m.Prevote(height=h, round=0, value=v, sender=s) for s in SIGS[1:]]
        out += [m.Precommit(height=h, round=0, value=v, sender=s) for s in SIGS[1:]]
    if signature:
        out = [x.with_signature(signature) for x in out]
    return out


def _same(port: _Run, ref: _Run):
    assert port.commits == ref.commits
    assert port.fl.launches == ref.fl.launches == len(port.views) == len(ref.views)
    for j, (got, want) in enumerate(zip(port.counts(), ref.counts())):
        for k in COUNT_KEYS:
            assert np.array_equal(got[k], want[k]), (j, k)
    assert port.hits() == ref.hits() > 0


def _handle_all(runs, heights, drain=False):
    for run in runs:
        run.rep.start()
        for msg in _script(run.pkg, heights):
            run.rep.handle(msg)
            if drain:
                run.fl.queue.drain()


def test_three_heights_match_jax():
    port, ref = _Run(PORT), _Run(JAX)
    _handle_all((port, ref), 3)
    assert set(port.commits) == {1, 2, 3} and port.commits[2] == _value(2, 0)
    _same(port, ref)
    # The grid lives on the device the caller named; no queue: blocking.
    assert port.fl.device.type == "cpu" and port.fl.queue is None


def test_grid_resets_across_heights_as_jax():
    port, ref = _Run(PORT), _Run(JAX)
    _handle_all((port, ref), 2)
    assert set(port.commits) == {1, 2}
    _same(port, ref)
    # The plane was reset on the move to height 2: its counts start clean.
    first_h2 = next(v for v in port.views if v.height == 2)
    assert first_h2.view.counts["total"].sum() <= 2 * N


class _RejectOne:
    def verify_batch(self, window):
        return [m.sender != SIGS[3] for m in window]


def test_rejected_votes_never_reach_the_grid_as_jax():
    port, ref = _Run(PORT, _RejectOne()), _Run(JAX, _RejectOne())
    _handle_all((port, ref), 2)
    assert set(port.commits) == {1, 2}
    assert SIGS[3] not in port.rep.proc.state.prevote_logs.get(0, {})
    _same(port, ref)


def test_unknown_sender_poisons_its_round_as_jax():
    stranger = bytes([9]) * 32
    runs = (_Run(PORT), _Run(JAX))
    for run in runs:
        run.rep.procs_allowed.add(stranger)
        run.rep.start()
        run.rep.handle(run.pkg["msgs"].Prevote(
            height=1, round=0, value=_value(1, 0), sender=stranger))
        assert (0, 0) in run.fl._dirty
        for msg in _script(run.pkg, 1):
            run.rep.handle(msg)
    assert set(runs[0].commits) == {1}
    _same(*runs)


class _Mask:
    def __init__(self, mask):
        self._mask = mask

    def mask(self):
        return self._mask


class _TrustingBegin:
    """Transport trust with the async entry point the split schedule
    needs; records the size of every verify call."""

    def __init__(self):
        self.calls = []

    def verify_batch(self, window):
        self.calls.append(len(window))
        return [True] * len(window)

    def verify_signatures_begin(self, items):
        self.calls.append(len(items))
        return _Mask(np.ones(len(items), dtype=bool))


def _drive_mq(pkg, split):
    """Each height's signed window inserted into the queue, then one
    flush: a 7-message window, split in two halves when ``split <= 7``."""
    run = _Run(pkg, _TrustingBegin(), pipeline_split=split)
    script = _script(pkg, 3, signature=b"\x01" * 64)
    for h in range(1, 4):
        for m in script:
            if m.height == h:
                kind = type(m).__name__.lower()
                getattr(run.rep.mq, f"insert_{kind}")(m)
        run.fl.flush(run.rep)
    return run


def test_split_window_matches_the_single_launch_and_jax():
    split, mono = _drive_mq(PORT, 4), _drive_mq(PORT, 0)
    assert split.commits == mono.commits and set(split.commits) == {1, 2, 3}
    assert split.rep.proc.current_height == mono.rep.proc.current_height == 4
    assert 3 in split.verifier.calls and 7 not in split.verifier.calls
    assert 7 in mono.verifier.calls
    ref = _drive_mq(JAX, 4)
    assert split.verifier.calls == ref.verifier.calls
    _same(split, ref)


def test_queue_mode_matches_the_blocking_flush_and_jax():
    port = _Run(PORT, queue=DeviceWorkQueue())
    ref = _Run(JAX, queue=RefDeviceWorkQueue())
    _handle_all((port, ref), 3, drain=True)
    blocking = _Run(PORT)
    _handle_all((blocking,), 3)
    assert port.commits == blocking.commits and len(port.commits) >= 3
    q = port.fl.queue
    assert q.submitted > 0 and q.depth == 0 and q.submitted == ref.fl.queue.submitted
    _same(port, ref)


def test_reset_cancels_inflight_windows_as_jax():
    runs = (_Run(PORT, queue=DeviceWorkQueue()), _Run(JAX, queue=RefDeviceWorkQueue()))
    for run in runs:
        rep, fl = run.rep, run.fl
        rep.start()
        ckpt = run.pkg["ckpt"](rep.proc)
        for m in _script(run.pkg, 2):
            rep.handle(m)  # no drain: windows pile up in flight
        inflight = list(fl._inflight)
        assert inflight
        rep.restore(ckpt)
        assert not fl._inflight and all(f.cancelled() for f in inflight)
        fl.queue.drain()
        run.commits.clear()
        for m in _script(run.pkg, 2):
            rep.handle(m)
            fl.queue.drain()
    assert set(runs[0].commits) == {1, 2}
    _same(*runs)
    assert checkpoint_bytes(runs[0].rep.proc) == ref_checkpoint_bytes(runs[1].rep.proc)


def test_wire_verifier_flush_on_the_cpu_matches_jax():
    # The deployment's verifier on its plain versions: one height, one
    # 64-lane call on the grouped challenge route.
    ns = b"flushwire"
    ring, ref_ring = KeyRing.deterministic(N, ns), RefKeyRing.deterministic(N, ns)
    sigs = ring.signatories
    table = ValidatorTable(sigs, device="cpu")
    wv = TorchWireVerifier(buckets=(64,), table=table, device="cpu")
    runs = (_Run(PORT, wv, sigs=sigs), _Run(JAX, RefHostVerifier(), sigs=sigs))
    assert runs[0].fl.device.type == "cpu"  # the verifier's device
    for run, r in zip(runs, (ring, ref_ring)):
        m = run.pkg["msgs"]
        v = _value(1, 0)
        window = [r[1].sign_message(m.Propose(
            height=1, round=0, valid_round=INVALID_ROUND, value=v, sender=sigs[1]))]
        window += [r[i].sign_message(m.Prevote(height=1, round=0, value=v,
                                               sender=sigs[i])) for i in (1, 2, 3)]
        window += [r[i].sign_message(m.Precommit(height=1, round=0, value=v,
                                                 sender=sigs[i])) for i in (1, 2, 3)]
        for msg in window:
            getattr(run.rep.mq, f"insert_{type(msg).__name__.lower()}")(msg)
        run.fl.flush(run.rep)
    assert set(runs[0].commits) == {1}
    assert wv.stats["lanes_grouped"] == 7
    _same(*runs)


def _queue_flusher_run(pkg, queued, drain=True, **queue_kw):
    commits: dict = {}
    q = pkg["Queue"](**queue_kw) if queued else None
    fl = pkg["QueueFlusher"](pkg["Null"](), q) if queued else None
    lb = _Loopback()
    rep = pkg["Replica"](
        pkg["Options"](), whoami=SIGS[0], signatories=list(SIGS), timer=None,
        proposer=pkg["Proposer"](fn=_value), validator=pkg["Validator"](ok=True),
        committer=pkg["Committer"](
            on_commit=lambda h, v: (commits.__setitem__(h, v), (0, None))[1]),
        catcher=None, broadcaster=lb,
        verifier=None if queued else pkg["Null"](), flusher=fl,
    )
    lb.rep = rep
    rep.start()
    for m in _script(pkg, 3):
        rep.handle(m)
        if queued and drain:
            q.drain()
    return commits, rep, fl


def test_queue_flusher_commits_equal_the_blocking_flush_and_jax():
    # The port's flusher seats each command under its replica's identity,
    # which a drain policy reads; FIFO seats everything at once.
    got, rep, fl = _queue_flusher_run(PORT, True, policy=FifoDrainPolicy())
    want, _, ref_fl = _queue_flusher_run(JAX, True)
    blocking, _, _ = _queue_flusher_run(PORT, False)
    assert got == want == blocking and set(got) == {1, 2, 3}
    assert fl.submitted == fl.dispatched == ref_fl.submitted == ref_fl.dispatched > 0
    assert fl.queue.launches == ref_fl.queue.launches
    seen = []
    def select(live):
        seen.extend(c[3] for c in live)
        return live, []

    fl.queue.policy.select = select
    rep.handle(_script(PORT, 4)[-1])
    fl.queue.drain()
    assert seen and all(m.origin == SIGS[0] and m.rows >= 1 for m in seen)


def test_queue_flusher_reset_cancels_inflight_futures():
    commits, rep, fl = _queue_flusher_run(PORT, True, drain=False)
    inflight = list(fl._inflight)
    assert inflight and not commits
    rep.restore(checkpoint_bytes(rep.proc))
    assert not fl._inflight and all(f.cancelled() for f in inflight)
    assert fl.queue.drain() == 0 and fl.dispatched == 0 and not commits


def _settle_block_run(pkg, batch, columnar):
    """Three heights of signed windows, one window a height: through
    ``settle_block`` (``columnar``) or inserted into the queue and
    flushed (the object path)."""
    run = _Run(pkg)
    run.rep.start()
    script = _script(pkg, 3, signature=b"\x01" * 64)
    for h in range(1, 4):
        window = [m for m in script if m.height == h]
        if columnar:
            run.fl.settle_block(run.rep, batch.MessageBlock.from_messages(window))
        else:
            for m in window:
                getattr(run.rep.mq, f"insert_{type(m).__name__.lower()}")(m)
            run.fl.flush(run.rep)
    return run


def test_unported_flusher_features_refuse():
    # settle_block is ported: a MessageBlock window straight into the
    # columnar insert equals the JAX package's settle_block and the
    # object-path flush of the same window.
    got = _settle_block_run(PORT, port_batch, True)
    want = _settle_block_run(JAX, ref_batch, True)
    obj = _settle_block_run(PORT, port_batch, False)
    assert set(got.commits) == {1, 2, 3} and got.commits == obj.commits
    _same(got, want)
    assert got.fl.fastpath_rows == want.fl.fastpath_rows > 0
    assert checkpoint_bytes(got.rep.proc) == checkpoint_bytes(obj.rep.proc)
    assert checkpoint_bytes(got.rep.proc) == ref_checkpoint_bytes(want.rep.proc)
    # rotate_validators is ported (tests/test_torch_generations.py holds
    # it to the JAX flusher in queue mode): a blocking rotation bumps the
    # generation and reorders the columns, as the JAX flusher's does.
    fl = DeviceTallyFlusher(NullVerifier(), SIGS, device="cpu")
    ref = RefDeviceTallyFlusher(RefNullVerifier(), SIGS)
    for f in (fl, ref):
        f.rotate_validators(SIGS[::-1])
    assert (fl.generation, fl._pos, fl.grid.V) == (ref.generation, ref._pos, ref.grid.V)
    # Certificates are ported: a Certifier binds to the flusher and rides
    # the Replica's Process; since the BLS slice, so does a BLS keyring
    # (a counted signer without a key mints no aggregate).
    certifier = Certifier(SIGS, 1)
    assert DeviceTallyFlusher(NullVerifier(), SIGS, device="cpu",
                              certifier=certifier).certifier is certifier
    rep = Replica(ReplicaOptions(), whoami=SIGS[0], signatories=SIGS, timer=None,
                  proposer=None, validator=None, committer=None, catcher=None,
                  broadcaster=None, certifier=certifier)
    assert rep.proc.certifier is certifier
    keyed = Certifier(SIGS, 1, bls_keyring={})
    assert DeviceTallyFlusher(NullVerifier(), SIGS, device="cpu",
                              certifier=keyed).certifier is keyed
    assert keyed.observe_commit(1, 0, b"v", SIGS).agg_sig == b""
