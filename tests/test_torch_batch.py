"""The port's dense message layer and columnar insert against the JAX
package's.

The same seeded windows (numpy draws) are built as JAX messages and as
the port's: ``MessageBlock`` rows must be byte for byte the JAX rows,
with equal digests, verifier items, packed arrays, tally inputs and
``WindowColumns``; the port's ``Process.ingest_insert_cols`` over a
window must leave the same state as the JAX ``Process.ingest_insert``
(the object path) over the filtered window: the same plan, the same
accepted rows and catcher calls in the same order, the same checkpoint
bytes. The tolerance is exact equality throughout: everything compared
is bytes, integers or booleans.
"""

import numpy as np
import pytest
import torch

from hyperdrive_tpu import batch as ref_batch
from hyperdrive_tpu import messages as ref_messages
from hyperdrive_tpu.codec import Writer as RefWriter
from hyperdrive_tpu.process import Process as RefProcess
from hyperdrive_tpu.testutil import CatcherCallbacks as RefCatcherCallbacks
from hyperdrive_tpu.types import MessageType as RefMessageType
from hyperdrive_tpu_torch import batch, messages
from hyperdrive_tpu_torch.codec import Writer
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.process import Process
from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
from hyperdrive_tpu_torch.testutil import CatcherCallbacks, CommitterCallback
from hyperdrive_tpu_torch.types import INVALID_ROUND, MessageType
from hyperdrive_tpu_torch.utils.checkpoint import checkpoint_bytes
from hyperdrive_tpu_torch.verifier import HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

WHOAMI = b"\x01" * 32
KINDS = ("Propose", "Prevote", "Precommit")


def _draw_window(seed: int, n: int = 60, height: int = 1):
    """One adversarial window as message specs: a small sender and value
    pool (duplicates and equivocations are frequent), strangers, wrong
    heights, hostile rounds, proposes with every valid_round shape, some
    payloads and signatures (right and wrong length)."""
    rng = np.random.default_rng(seed)
    senders = [rng.bytes(32) for _ in range(6)]
    values = [rng.bytes(32) for _ in range(3)]
    specs = []
    while len(specs) < n:
        roll = rng.random()
        if roll < 0.12 and specs:
            specs.append(specs[int(rng.integers(len(specs)))])  # exact duplicate
            continue
        kind = KINDS[int(rng.integers(3))] if roll < 0.3 else KINDS[1 + int(rng.integers(2))]
        h = height if roll < 0.85 else int(rng.choice([0, 2, 5, 1 << 40]))
        rnd = int(rng.integers(4)) if roll < 0.9 else int(rng.choice([INVALID_ROUND, 7, 200]))
        sender = senders[int(rng.integers(6))] if roll < 0.95 else rng.bytes(32)
        spec = dict(kind=kind, height=h, round=rnd, value=values[int(rng.integers(3))],
                    sender=sender)
        if kind == "Propose":
            spec["valid_round"] = int(rng.choice([INVALID_ROUND, 0, 1]))
            spec["payload"] = rng.bytes(40) if rng.random() < 0.3 else b""
        sig_roll = rng.random()
        spec["signature"] = (rng.bytes(64) if sig_roll < 0.5
                             else rng.bytes(12) if sig_roll < 0.6 else b"")
        specs.append(spec)
    return specs, senders


def _build(specs, mod):
    """Message objects of ``mod`` (the JAX or the port package) for the
    specs; a repeated spec is the same object, as a fanned-out broadcast."""
    made = {}
    out = []
    for spec in specs:
        key = id(spec)
        if key not in made:
            kw = {k: v for k, v in spec.items() if k not in ("kind", "signature")}
            m = getattr(mod, spec["kind"])(**kw)
            made[key] = m.with_signature(spec["signature"]) if spec["signature"] else m
        out.append(made[key])
    return out


def _rows_equal(got, want):
    assert got.dtype.descr == want.dtype.descr
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [3, 11])
def test_message_block_matches_jax(seed):
    specs, senders = _draw_window(seed, height=9)
    got = batch.MessageBlock.from_messages(_build(specs, messages))
    want = ref_batch.MessageBlock.from_messages(_build(specs, ref_messages))
    _rows_equal(got.rows, want.rows)
    assert batch.MESSAGE_DTYPE.descr == ref_batch.MESSAGE_DTYPE.descr
    assert got.payloads == want.payloads and len(got) == len(want)
    assert got.digests() == want.digests()
    assert got.verify_items() == want.verify_items()
    for a, b in zip(got.pack_arrays(), want.pack_arrays()):
        assert np.array_equal(a, b)
    for vt, rvt in ((MessageType.PREVOTE, RefMessageType.PREVOTE),
                    (MessageType.PRECOMMIT, RefMessageType.PRECOMMIT)):
        g, w = got.tally_inputs(senders, vt, 9), want.tally_inputs(senders, rvt, 9)
        assert g[0] == w[0]
        assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
    # Row -> object: the port's objects equal the messages they came from,
    # signatures included.
    back = got.to_messages()
    assert back == _build(specs, messages)
    assert [m.signature for m in back] == [
        w.signature for w in want.to_messages()
    ]
    gc, wc = got.columns(), want.columns()
    for name in ("n", "kinds", "heights", "rounds", "senders", "values", "runs"):
        assert getattr(gc, name) == getattr(wc, name), name
    oc = batch.WindowColumns.from_messages(_build(specs, messages))
    assert (oc.kinds, oc.runs) == (gc.kinds, gc.runs)
    # Lazy rows: materialized once, then cached.
    assert gc.msgs[0] is None and gc.msg(0) is gc.msg(0) == back[0]
    with pytest.raises(TypeError):
        batch.MessageBlock.from_messages([messages.Timeout(
            message_type=MessageType.PREVOTE, height=1, round=0)])


def _marshal(st, writer) -> bytes:
    w = writer()
    st.marshal(w)
    return w.data()


def _key(m):
    return (type(m).__name__, m.height, m.round, m.value, m.sender,
            getattr(m, "valid_round", None), getattr(m, "payload", None),
            m.signature)


def _ingest_both(specs, keep, allowed, wire: bool):
    """The JAX object path over the filtered window against the port's
    columnar insert over the whole window (from objects, or from wire
    rows when ``wire``)."""
    ref_events, events, ref_acc, acc = [], [], [], []
    ref_p = RefProcess(WHOAMI, f=2, catcher=RefCatcherCallbacks(
        on_double_propose=lambda n, e: ref_events.append(("dpp", _key(n), _key(e))),
        on_double_prevote=lambda n, e: ref_events.append(("dpv", _key(n), _key(e))),
        on_double_precommit=lambda n, e: ref_events.append(("dpc", _key(n), _key(e))),
    ))
    p = Process(WHOAMI, f=2, catcher=CatcherCallbacks(
        on_double_propose=lambda n, e: events.append(("dpp", _key(n), _key(e))),
        on_double_prevote=lambda n, e: events.append(("dpv", _key(n), _key(e))),
        on_double_precommit=lambda n, e: events.append(("dpc", _key(n), _key(e))),
    ))
    ref_msgs = _build(specs, ref_messages)
    if wire:
        # A wire row carries a 64-byte signature or none: the objects the
        # JAX package materializes from its own block are the reference.
        ref_msgs = ref_batch.MessageBlock.from_messages(ref_msgs).to_messages()
    filtered = [m for i, m in enumerate(ref_msgs)
                if (keep is None or keep[i]) and (allowed is None or m.sender in allowed)]
    ref_plan = ref_p.ingest_insert(
        filtered, on_accepted=lambda m, pc: ref_acc.append((_key(m), pc)))
    port_msgs = _build(specs, messages)
    cols = (batch.MessageBlock.from_messages(port_msgs).columns() if wire
            else batch.WindowColumns.from_messages(port_msgs))
    plan, ingested = p.ingest_insert_cols(
        cols, keep=keep, allowed=allowed,
        on_accepted=lambda m, pc: acc.append((_key(m), pc)))
    assert ingested == len(filtered)
    assert plan == ref_plan
    assert acc == ref_acc and events == ref_events
    assert _marshal(p.state, Writer) == _marshal(ref_p.state, RefWriter)
    return cols


@pytest.mark.parametrize("seed", range(6))
def test_columnar_insert_matches_jax_object_path(seed):
    rng = np.random.default_rng(1000 + seed)
    for case in range(12):
        specs, senders = _draw_window(int(rng.integers(1 << 30)))
        keep = None if rng.random() < 0.4 else list(rng.random(len(specs)) < 0.8)
        allowed = None
        if rng.random() < 0.5:
            allowed = set(senders)
            if rng.random() < 0.5:
                allowed.update(s["sender"] for s in specs)
        cols = _ingest_both(specs, keep, allowed, wire=False)
        assert all(m is not None for m in cols.msgs)
        cols = _ingest_both(specs, keep, None, wire=True)
        # Wire rows the keep mask filtered out never became objects.
        if keep is not None and not all(keep):
            assert any(m is None for m in cols.msgs), (seed, case)


def test_fully_filtered_run_leaves_no_empty_logs():
    # A (kind, height, round) run whose every row is filtered by keep
    # must not create the round's log dict (checkpoint bytes would differ).
    s1, s2, v = b"\x0a" * 32, b"\x0b" * 32, b"\x33" * 32
    specs = [
        dict(kind="Prevote", height=1, round=0, value=v, sender=s1, signature=b""),
        dict(kind="Prevote", height=1, round=3, value=v, sender=s1, signature=b""),
        dict(kind="Prevote", height=1, round=3, value=v, sender=s2, signature=b""),
        dict(kind="Precommit", height=1, round=5, value=v, sender=s2, signature=b""),
    ]
    keep = [True, False, False, True]
    _ingest_both(specs, keep, None, wire=False)
    p = Process(WHOAMI, f=2)
    p.ingest_insert_cols(batch.WindowColumns.from_messages(_build(specs, messages)),
                         keep=keep)
    assert 3 not in p.state.prevote_logs
    assert 0 in p.state.prevote_logs and 5 in p.state.precommit_logs


def _flusher_replica(ring, verifier, commits):
    sigs = ring.signatories
    fl = DeviceTallyFlusher(verifier, sigs, device="cpu")
    rep = Replica(
        ReplicaOptions(), whoami=sigs[0], signatories=list(sigs), timer=None,
        proposer=None, validator=None,
        committer=CommitterCallback(
            on_commit=lambda h, v: (commits.__setitem__(h, v), (0, None))[1]),
        catcher=None, broadcaster=None, flusher=fl,
    )
    return rep, fl


def test_settle_block_with_the_batch_verifier_equals_the_object_path():
    # One signed height-1 window (a propose, four prevotes, one of them
    # forged, and two precommits: no commit yet) through settle_block on
    # the packed verifier (its plain version on the CPU: one call) and
    # through the queue with the host verifier.
    ring = KeyRing.deterministic(4, namespace=b"settle-block")
    sigs = ring.signatories
    v = b"\x42" * 32
    window = [ring[1].sign_message(messages.Propose(
        height=1, round=0, valid_round=INVALID_ROUND, value=v, sender=sigs[1]))]
    for i in range(4):
        window.append(ring[i].sign_message(messages.Prevote(
            height=1, round=0, value=v, sender=sigs[i])))
    window[2] = window[2].with_signature(bytes(64))  # forged
    for i in (2, 3):
        window.append(ring[i].sign_message(messages.Precommit(
            height=1, round=0, value=v, sender=sigs[i])))
    got_commits, want_commits = {}, {}
    rep, fl = _flusher_replica(ring, TorchBatchVerifier(device="cpu", buckets=(64,)),
                               got_commits)
    obj, obj_fl = _flusher_replica(ring, HostVerifier(), want_commits)
    rep.start()
    obj.start()
    fl.settle_block(rep, batch.MessageBlock.from_messages(window))
    for m in window:
        getattr(obj.mq, f"insert_{type(m).__name__.lower()}")(m)
    obj_fl.flush(obj)
    assert got_commits == want_commits == {}
    logged = rep.proc.state.prevote_logs[0]
    assert sigs[1] not in logged and {sigs[0], sigs[2], sigs[3]} <= set(logged)
    assert len(rep.proc.state.precommit_logs[0]) == 2
    assert fl.launches == obj_fl.launches == 1 and fl.fastpath_rows == len(window)
    assert checkpoint_bytes(rep.proc) == checkpoint_bytes(obj.proc)
