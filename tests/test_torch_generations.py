"""Table generations on the port's device-work queue against the JAX
package's: a drain groups its commands by (launcher, generation) in
first-submission order, calls ``set_generation`` only for a nonzero
generation on a launcher that has the method, and a
``DeviceTallyFlusher`` that rotates its validators mid-drain gets one
launch per generation.

Every case runs the same script through both packages and requires equal
launch counts, coalesced counts, launch order and results (exact: they
are integers and booleans).
"""

import hashlib

import numpy as np
import pytest
import torch

from hyperdrive_tpu import messages as ref_messages
from hyperdrive_tpu.crypto import bls as ref_bls
from hyperdrive_tpu.devsched.queue import DeviceWorkQueue as RefDeviceWorkQueue
from hyperdrive_tpu.ops.votegrid import CheckedTallyView as RefCheckedTallyView
from hyperdrive_tpu.replica import Replica as RefReplica
from hyperdrive_tpu.replica import ReplicaOptions as RefReplicaOptions
from hyperdrive_tpu.tallyflush import DeviceTallyFlusher as RefDeviceTallyFlusher
from hyperdrive_tpu.testutil import CommitterCallback as RefCommitterCallback
from hyperdrive_tpu.testutil import MockProposer as RefMockProposer
from hyperdrive_tpu.testutil import MockValidator as RefMockValidator
from hyperdrive_tpu.verifier import NullVerifier as RefNullVerifier
from hyperdrive_tpu_torch import messages
from hyperdrive_tpu_torch.devsched import DeviceWorkQueue
from hyperdrive_tpu_torch.ops import g1
from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
from hyperdrive_tpu_torch.testutil import CommitterCallback, MockProposer, MockValidator
from hyperdrive_tpu_torch.types import INVALID_ROUND
from hyperdrive_tpu_torch.verifier import NullVerifier

torch.set_num_threads(1)

QUEUES = {"port": DeviceWorkQueue, "jax": RefDeviceWorkQueue}


class _GenVerifier:
    """A verifier with a ``set_generation`` the queue must never call: the
    verify launchers have none, so a drain splits by generation but never
    swaps a verifier's table."""

    def __init__(self):
        self.calls = []
        self.generations = []

    def verify_signatures(self, items):
        self.calls.append([it[1] for it in items])
        return [True] * len(items)

    def set_generation(self, g):
        self.generations.append(g)


class _GenLauncher:
    """A launcher that has ``set_generation``: it hears each nonzero
    generation just before that group's launch."""

    kind = "gen"

    def __init__(self):
        self.log = []

    def set_generation(self, g):
        self.log.append(("gen", g))

    def launch(self, payloads):
        self.log.append(("launch", [p[0] for p in payloads]))
        return [[x * 10 for x in p] for p in payloads]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_generation_split_matches_the_reference_rule(pkg):
    q = QUEUES[pkg]()
    v = _GenVerifier()
    launcher = q.verify_launcher(v)
    futs = [q.submit(launcher, [(b"s", b"d%d" % i, b"sig")], g)
            for i, g in enumerate((0, 1, 0))]
    assert q.drain() == 3
    # Generations 0 and 1 in first-submission order: 2 launches, the two
    # generation-0 commands in one of them.
    assert (q.submitted, q.launches, q.coalesced) == (3, 2, 1)
    assert v.calls == [[b"d0", b"d2"], [b"d1"]]
    assert [f.result() for f in futs] == [[True]] * 3
    assert v.generations == []


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_set_generation_hears_nonzero_generations_only(pkg):
    q = QUEUES[pkg]()
    launcher = _GenLauncher()
    futs = [q.submit(launcher, [i], g) for i, g in enumerate((0, 2, 0, 3, 2))]
    q.drain()
    assert launcher.log == [
        ("launch", [0, 2]), ("gen", 2), ("launch", [1, 4]), ("gen", 3), ("launch", [3]),
    ]
    assert [f.result() for f in futs] == [[0], [10], [20], [30], [40]]
    assert (q.launches, q.coalesced) == (3, 2)


def test_generation_split_equals_the_jax_queue_on_a_mixed_script():
    # Two launchers, three generations, interleaved; origin and rows by
    # keyword, as every port caller passes them.
    out = {}
    for pkg, Q in QUEUES.items():
        q = Q()
        a, b = _GenLauncher(), _GenLauncher()
        for i, (lau, g) in enumerate([(a, 0), (b, 0), (a, 1), (a, 0), (b, 2), (a, 1)]):
            q.submit(lau, [i], g, origin=i % 2, rows=1)
        q.drain()
        out[pkg] = (a.log, b.log, q.launches, q.coalesced)
    assert out["port"] == out["jax"]
    assert out["port"][2:] == (4, 2)


def test_g1sum_launcher_batches_one_launch_under_generation_zero():
    points, p = [], ref_bls.G1_GEN
    for i in range(8):
        p = ref_bls.g1_double(p) if i % 3 else ref_bls.g1_add(p, ref_bls.G1_GEN)
        points.append(p)
    queue = DeviceWorkQueue()
    launcher = g1.G1SumLauncher(width=8, device="cpu")
    futs = [queue.submit(launcher, points[i : i + 4], generation=0, rows=4)
            for i in (0, 4)]
    queue.drain()
    assert [f.result() for f in futs] == [
        ref_bls.aggregate_signatures(points[i : i + 4]) for i in (0, 4)]
    assert launcher.launched == 1 and queue.launches == 1


# ----------------------------------------------- rotation of the flusher

N = 4
SIGS = [bytes([i + 1]) * 32 for i in range(N)]
NEW = [SIGS[2], SIGS[0], SIGS[3], SIGS[1], bytes([9]) * 32]

PORT = dict(msgs=messages, Replica=Replica, Options=ReplicaOptions,
            Flusher=DeviceTallyFlusher, Checked=CheckedTallyView, Queue=DeviceWorkQueue,
            Null=NullVerifier, Committer=CommitterCallback, Proposer=MockProposer,
            Validator=MockValidator, flusher_kw=dict(device="cpu"))
JAX = dict(msgs=ref_messages, Replica=RefReplica, Options=RefReplicaOptions,
           Flusher=RefDeviceTallyFlusher, Checked=RefCheckedTallyView,
           Queue=RefDeviceWorkQueue, Null=RefNullVerifier, Committer=RefCommitterCallback,
           Proposer=RefMockProposer, Validator=RefMockValidator, flusher_kw={})


def _value(height, round_):
    return hashlib.sha256(b"genval-%d-%d" % (height, round_)).digest()


class _Counting:
    """A shared verifier that accepts every signed row and logs each
    launch's rows (the queue's one ``verify_signatures`` call a group)."""

    def __init__(self):
        self.launches = []

    def verify_signatures(self, items):
        self.launches.append(len(items))
        return [True] * len(items)


def _rotated_run(pkg):
    views = []
    q = pkg["Queue"]()
    verifier = _Counting()

    def check(view, proc):
        cv = pkg["Checked"](view, proc)
        views.append(cv)
        return cv

    fl = pkg["Flusher"](verifier, list(SIGS), tally_check=check, queue=q,
                        **pkg["flusher_kw"])
    commits = {}
    rep = pkg["Replica"](
        pkg["Options"](), whoami=SIGS[0], signatories=list(SIGS), timer=None,
        proposer=pkg["Proposer"](fn=_value), validator=pkg["Validator"](ok=True),
        committer=pkg["Committer"](
            on_commit=lambda h, v: (commits.__setitem__(h, v), (0, None))[1]),
        catcher=None, broadcaster=None, verifier=None, flusher=fl,
    )
    m = pkg["msgs"]
    v = _value(1, 0)
    sign = b"\x01" * 64
    before = [m.Propose(height=1, round=0, valid_round=INVALID_ROUND, value=v,
                        sender=SIGS[1]).with_signature(sign),
              m.Prevote(height=1, round=0, value=v, sender=SIGS[1]).with_signature(sign)]
    after = [m.Prevote(height=1, round=0, value=v, sender=s).with_signature(sign)
             for s in SIGS[2:]]
    rep.start()
    for msg in before:  # one window each, generation 0
        rep.handle(msg)
    grid0 = fl.grid
    fl.rotate_validators(NEW)
    for msg in after:  # one window each, generation 1
        rep.handle(msg)
    depth = q.depth
    q.drain()
    return dict(depth=depth, submitted=q.submitted, launches=q.launches,
                coalesced=q.coalesced, rows=verifier.launches, gen=fl.generation,
                pos=dict(fl._pos), V=fl.grid.V, new_grid=fl.grid is not grid0,
                counts=[{k: np.asarray(cv.view.counts[k]).tolist()
                         for k in ("matching", "nil", "total")} for cv in views],
                hits=sum(cv.hits for cv in views), commits=commits)


def test_rotated_flusher_launches_once_per_generation_as_jax():
    got, want = _rotated_run(PORT), _rotated_run(JAX)
    assert got == want
    # Two windows a generation in one drain: one launch each, in order.
    assert (got["depth"], got["submitted"], got["launches"], got["coalesced"]) == (4, 4, 2, 2)
    assert got["rows"] == [2, 2]
    assert got["gen"] == 1
    assert got["pos"] == {s: i for i, s in enumerate(NEW)}
    assert got["V"] == 5 and got["new_grid"]
    assert got["hits"] > 0


def test_same_size_rotation_keeps_the_grid_and_resets_the_plane():
    fl = DeviceTallyFlusher(NullVerifier(), SIGS, device="cpu")
    ref = RefDeviceTallyFlusher(RefNullVerifier(), SIGS)
    grid = fl.grid
    fl._height, ref._height = 3, 3
    fl._dirty, ref._dirty = {1}, {1}
    for f in (fl, ref):
        f.rotate_validators(list(reversed(SIGS)), generation=7)
    assert fl.grid is grid and fl.grid.device.type == "cpu"
    for f in (fl, ref):
        assert (f.generation, f._height, f._dirty) == (7, None, set())
        assert f._pos == {s: i for i, s in enumerate(reversed(SIGS))}
    fl.rotate_validators(SIGS)
    assert fl.generation == 8
