"""The port's runtime consensus sanitizer (HDS001–HDS005) against the JAX
package's, case for case with ``tests/analysis/test_sanitizer.py``.

Each scenario is a host run (one Process, f = 1) that goes through both
packages with the same inputs; the rule names and the whole messages
must be equal. The Byzantine-tally scenario also runs with a real port
vote grid on the CPU whose counts hold votes the host logs never saw:
it must die with the same HDS001 message as the reference's lying view.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyperdrive_tpu.analysis.annotations as ref_ann
import hyperdrive_tpu.analysis.sanitizer as ref_san
import hyperdrive_tpu.codec as ref_codec
import hyperdrive_tpu.messages as ref_msgs
import hyperdrive_tpu.process as ref_process
import hyperdrive_tpu.replica as ref_replica
import hyperdrive_tpu.testutil as ref_tu
import hyperdrive_tpu_torch.analysis.annotations as port_ann
import hyperdrive_tpu_torch.analysis.sanitizer as port_san
import hyperdrive_tpu_torch.codec as port_codec
import hyperdrive_tpu_torch.messages as port_msgs
import hyperdrive_tpu_torch.process as port_process
import hyperdrive_tpu_torch.replica as port_replica
import hyperdrive_tpu_torch.testutil as port_tu
from hyperdrive_tpu_torch.ops import votegrid as vg
from hyperdrive_tpu_torch.types import INVALID_ROUND, NIL_VALUE

torch.set_num_threads(1)

REF = SimpleNamespace(san=ref_san, ann=ref_ann, codec=ref_codec, msgs=ref_msgs,
                      Process=ref_process.Process, replica=ref_replica, tu=ref_tu)
PORT = SimpleNamespace(san=port_san, ann=port_ann, codec=port_codec, msgs=port_msgs,
                       Process=port_process.Process, replica=port_replica, tu=port_tu)
BOTH = (REF, PORT)


def sig(i: int) -> bytes:
    return bytes([i]) * 32


WHOAMI = sig(1)
PROPOSER = sig(2)
OTHERS = [sig(3), sig(4), sig(5)]
VALUE = bytes([0xAB]) * 32


class _Scheduler:
    """Always elects PROPOSER (the reference's MockScheduler)."""

    def schedule(self, height, round):
        return PROPOSER


def make_proc(pk, sanitize=True):
    rec = SimpleNamespace(commits=[], prevotes=[], precommits=[], proposes=[])
    proc = pk.Process(
        whoami=WHOAMI,
        f=1,
        timer=None,
        scheduler=_Scheduler(),
        proposer=pk.tu.MockProposer(value=VALUE),
        validator=pk.tu.MockValidator(ok=True),
        broadcaster=pk.tu.BroadcasterCallbacks(
            on_propose=rec.proposes.append,
            on_prevote=rec.prevotes.append,
            on_precommit=rec.precommits.append,
        ),
        committer=pk.tu.CommitterCallback(
            on_commit=lambda h, v: (rec.commits.append((h, v)), (0, None))[1]
        ),
        catcher=None,
        height=1,
    )
    if sanitize:
        pk.san.install(proc)
    return proc, rec


def deliver_valid_proposal(pk, proc):
    proc.start()
    proc.propose(pk.msgs.Propose(height=1, round=0, valid_round=INVALID_ROUND,
                                 value=VALUE, sender=PROPOSER))
    assert proc.state.propose_is_valid.get(0), "fixture: proposal must log"


def _raises(pk, fn, rule):
    with pytest.raises(pk.san.SanitizerError) as exc:
        fn()
    assert exc.value.rule == rule and str(exc.value).startswith(rule + ": ")
    return str(exc.value)


def _same_error(fn, rule):
    """Run ``fn(pk)`` in both packages; both raise ``rule`` with one message."""
    msgs = [_raises(pk, lambda pk=pk: fn(pk), rule) for pk in BOTH]
    assert msgs[0] == msgs[1]
    return msgs[1]


class LyingTallyView:
    """Claims a 2f+1 precommit quorum regardless of what the logs hold."""

    def __init__(self, height, claimed):
        self.height = height
        self.rep = 0
        self._claimed = claimed

    def prevotes_for(self, rnd, value):
        return None

    def precommits_for(self, rnd, value):
        return self._claimed

    def prevote_total(self, rnd):
        return None

    def precommit_total(self, rnd):
        return self._claimed


def _words(value: bytes) -> np.ndarray:
    return np.frombuffer(value, dtype="<i4").astype(np.int32)


def lying_grid_view(device="cpu"):
    """A port vote grid holding three precommits for VALUE at round 0 from
    validators the host logs never heard: its TallyView claims the
    quorum the logs lack."""
    R, V = 4, 4
    grid = vg.VoteGrid(1, V, r_slots=R, buckets=(16,), device=device)
    idx = np.array([[0, 1, 0, v] for v in (1, 2, 3)], dtype=np.int32)
    words = np.stack([_words(VALUE)] * 3)
    targets = np.zeros((1, R, 8), dtype=np.int32)
    tvalid = np.zeros((1, R), dtype=bool)
    targets[0, 0], tvalid[0, 0] = _words(VALUE), True
    counts = grid.update_and_tally(
        idx, words, np.zeros(1, dtype=bool), targets, tvalid,
        np.array([-1], dtype=np.int32), np.zeros((1, 8), dtype=np.int32),
        np.ones(1, dtype=np.int32))
    return vg.TallyView(0, 1, counts, R, {0: VALUE}, -1, NIL_VALUE)


# ------------------------------------------------------- HDS001 (2f+1 recount)


@pytest.mark.parametrize("tally", ["lying_view", "port_grid"])
def test_byzantine_device_tally_cannot_force_commit(tally):
    commits = []

    def run(pk):
        proc, rec = make_proc(pk)
        commits.append(rec.commits)
        deliver_valid_proposal(pk, proc)
        # One real precommit in the logs; quorum needs 2f+1 = 3.
        proc.precommit(pk.msgs.Precommit(height=1, round=0, value=VALUE,
                                         sender=OTHERS[0]))
        view = LyingTallyView(1, 3)
        if pk is PORT and tally == "port_grid":
            view = lying_grid_view()
            assert view.precommits_for(0, VALUE) == 3
        proc.ingest_cascade(({0}, set()), tallies=view)

    msg = _same_error(run, "HDS001")
    assert "no host-log quorum" in msg
    assert commits == [[], []], "the lying tally must not reach the app"


def test_honest_quorum_commits_through_the_sanitizer():
    out = []
    for pk in BOTH:
        proc, rec = make_proc(pk)
        deliver_valid_proposal(pk, proc)
        for s in OTHERS:
            proc.precommit(pk.msgs.Precommit(height=1, round=0, value=VALUE, sender=s))
        out.append((rec.commits, proc.state.current_height))
    assert out[0] == out[1] == ([(1, VALUE)], 2)


# -------------------------------------------------- HDS002 (locked <= current)


def test_corrupted_locked_round_surfaces_with_rule_name():
    def run(pk):
        proc, _ = make_proc(pk)
        proc.start()
        proc.state.locked_round = 5  # corruption: lock a round never reached
        proc.propose(pk.msgs.Propose(height=1, round=0, valid_round=INVALID_ROUND,
                                     value=VALUE, sender=PROPOSER))

    assert "locked_round 5 > current_round 0" in _same_error(run, "HDS002")


# ------------------------------------------------- HDS003 (height monotonic)


@pytest.mark.parametrize("case", ["wrong_height", "replayed_height"])
def test_commit_height_is_blocked(case):
    commits = []

    def run(pk):
        proc, rec = make_proc(pk)
        commits.append(rec.commits)
        if case == "wrong_height":
            proc.committer.commit(99, VALUE)
        deliver_valid_proposal(pk, proc)
        for s in OTHERS:
            proc.precommit(pk.msgs.Precommit(height=1, round=0, value=VALUE, sender=s))
        assert rec.commits == [(1, VALUE)]
        proc.state.current_height = 1  # roll the automaton back behind its commit
        proc.committer.commit(1, VALUE)

    msg = _same_error(run, "HDS003")
    if case == "wrong_height":
        assert commits == [[], []] and "commit at height 99" in msg
    else:
        assert "does not advance past 1" in msg


# ------------------------------------------------- HDS004 (settle-path parity)


@pytest.mark.parametrize("device_count", [7, 2], ids=["divergence", "parity"])
def test_device_host_tally_parity(monkeypatch, device_count):
    monkeypatch.setenv("HD_SANITIZE", "1")
    out = []
    for pk in BOTH:
        factory = pk.san.maybe_tally_check()
        assert factory is not None
        view = SimpleNamespace(
            height=1, rep=0,
            prevotes_for=lambda rnd, value: device_count,
            precommits_for=lambda rnd, value: None,
            prevote_total=lambda rnd: None,
            precommit_total=lambda rnd: None,
        )
        proc = SimpleNamespace(
            state=SimpleNamespace(count_prevotes_for=lambda rnd, value: 2)
        )
        checked = factory(view, proc)
        if device_count != 2:
            out.append(_raises(pk, lambda: checked.prevotes_for(0, VALUE), "HDS004"))
        else:
            out.append((checked.prevotes_for(0, VALUE), checked.hits))
    assert out[0] == out[1]
    if device_count == 2:
        assert out[1] == (2, 1)
    else:
        assert "device prevote[r=0] count 7 != host 2" in out[1]
    assert issubclass(port_san.maybe_tally_check(), vg.CheckedTallyView)


# ----------------------------------------------------------- wiring + toggles


def test_env_toggle_gates_installation(monkeypatch):
    for pk in BOTH:
        monkeypatch.setenv("HD_SANITIZE", "0")
        assert not pk.san.enabled()
        proc, _ = make_proc(pk, sanitize=False)
        before = proc.committer
        pk.san.maybe_install(proc)
        assert proc.committer is before
        assert pk.san.maybe_tally_check() is None

        monkeypatch.setenv("HD_SANITIZE", "1")
        assert pk.san.enabled()
        pk.san.maybe_install(proc)
        assert isinstance(proc.committer, pk.san._SanitizedCommitter)
        assert isinstance(proc.broadcaster, pk.san._SanitizedBroadcaster)
    for word in ("true", " ON ", "yes", "0", "off", ""):
        monkeypatch.setenv("HD_SANITIZE", word)
        assert port_san.enabled() == ref_san.enabled()


def test_install_is_idempotent():
    for pk in BOTH:
        proc, _ = make_proc(pk)
        once, bcast = proc.committer, proc.broadcaster
        pk.san.install(proc)
        assert proc.committer is once and proc.broadcaster is bcast


def test_replica_installs_sanitizer_by_default(monkeypatch):
    monkeypatch.setenv("HD_SANITIZE", "1")

    class AppCommitter:
        def commit(self, height, value):
            return 0, None

    for pk in BOTH:
        replica = pk.replica.Replica(
            opts=pk.replica.ReplicaOptions(),
            whoami=WHOAMI,
            signatories=[WHOAMI, PROPOSER] + OTHERS,
            timer=None,
            proposer=pk.tu.MockProposer(value=VALUE),
            validator=pk.tu.MockValidator(ok=True),
            committer=AppCommitter(),
            catcher=None,
            broadcaster=pk.tu.BroadcasterCallbacks(),
        )
        assert isinstance(replica.proc.committer, pk.san._SanitizedCommitter)
        # The sanitizer wraps the replica's tracing committer, which wraps
        # the app's: attribute access falls through the whole chain.
        assert replica.proc.committer.commit is not None


# -------------------------------------------------------- HDS005 wire budget


def test_unregistered_frame_family_raises(monkeypatch):
    monkeypatch.setenv("HD_SANITIZE", "1")
    msg = _same_error(lambda pk: pk.san.WireBudget("no.such.family"), "HDS005")
    assert "unregistered" in msg
    _same_error(lambda pk: pk.san.maybe_wire_reader("no.such.family", b"\x00"),
                "HDS005")


def test_oversized_payload_is_charged_up_front(monkeypatch):
    for pk in BOTH:
        monkeypatch.setitem(pk.ann.WIRE_BUDGETS, "test.tiny", 8)
    msg = _same_error(lambda pk: pk.san.WireBudget("test.tiny").reader(b"\x00" * 9),
                      "HDS005")
    assert "needs 9 bytes, max_bytes=8" in msg
    for pk in BOTH:
        assert pk.san.WireBudget("test.tiny").charge(8) == 8
    _same_error(lambda pk: pk.san.WireBudget("test.tiny").charge(9), "HDS005")


def test_budget_violating_decoder_dies_with_rule_name(monkeypatch):
    # A decoder that reads PAST its family's declared budget raises HDS005;
    # a merely truncated payload keeps its typed SerdeError.
    for pk in BOTH:
        monkeypatch.setitem(pk.ann.WIRE_BUDGETS, "test.tiny", 8)

    def greedy_decode(pk):
        r = pk.san.WireBudget("test.tiny").reader(b"\x00" * 8)
        r.u64()
        return r.u8()  # 9th byte: past the family budget

    assert "needs 9 bytes" in _same_error(greedy_decode, "HDS005")
    errs = []
    for pk in BOTH:
        r = pk.san.WireBudget("test.tiny").reader(b"\x00" * 2)
        with pytest.raises(pk.codec.SerdeError) as exc:
            r.u32(), r.u32()  # underflow, budget untouched
        errs.append(str(exc.value))
    assert errs[0] == errs[1]
    assert type(port_san.WireBudget("test.tiny").reader(b"")) is port_san._BudgetReader


def test_budget_breach_emits_wire_budget_event(monkeypatch):
    from hyperdrive_tpu_torch.obs.recorder import EVENT_KINDS, Recorder

    out = []
    for pk in BOTH:
        monkeypatch.setitem(pk.ann.WIRE_BUDGETS, "test.tiny", 8)
        events = []
        obs = SimpleNamespace(
            emit=lambda kind, node, h, r, detail, ev=events: ev.append((kind, detail))
        )
        with pytest.raises(pk.san.SanitizerError):
            pk.san.WireBudget("test.tiny", obs=obs).charge(64)
        out.append(events)
    assert out[0] == out[1] == [("wire.budget.exceeded", "test.tiny:64")]
    # The port's recorder takes the kind.
    assert "wire.budget.exceeded" in EVENT_KINDS
    rec = Recorder()
    with pytest.raises(port_san.SanitizerError):
        port_san.WireBudget("test.tiny", obs=rec.scoped(-1)).reader(b"\x00" * 9)
    assert [(e.kind, e.detail) for e in rec.snapshot()] == [
        ("wire.budget.exceeded", "test.tiny:9")]


def test_budget_breach_on_a_bound_recorder(monkeypatch):
    # A seam's bound handle (TcpNode passes its own): the port emits on
    # the handle's track and raises HDS005; the reference's five-argument
    # emit raises TypeError there instead (ROADMAP Queue C, C2).
    import struct

    from hyperdrive_tpu.obs.recorder import NULL_BOUND as REF_NULL_BOUND
    from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND, Recorder

    monkeypatch.setenv("HD_SANITIZE", "1")
    frame = b"\x01" + struct.pack("<I", 1 << 30) + b"x" * 10
    r = ref_san.maybe_wire_reader("msg.envelope", frame, obs=REF_NULL_BOUND)
    r.u8()
    with pytest.raises(TypeError):
        r.raw()
    rec = Recorder()
    for obs in (NULL_BOUND, rec.scoped(3)):
        r = port_san.maybe_wire_reader("msg.envelope", frame, obs=obs)
        r.u8()
        with pytest.raises(port_san.SanitizerError, match="^HDS005.*needs 1073741829"):
            r.raw()
    assert [(e.replica, e.kind, e.detail) for e in rec.snapshot()] == [
        (3, "wire.budget.exceeded", "msg.envelope:1073741829")]


def test_maybe_wire_reader_off_path_is_a_plain_reader(monkeypatch):
    monkeypatch.setenv("HD_SANITIZE", "0")
    for pk in BOTH:
        r = pk.san.maybe_wire_reader("no.such.family", b"\x01\x02")
        assert type(r) is pk.codec.Reader  # no budget subclass, no registry check
        assert r.rem == pk.codec.MAX_BYTES
        r2 = pk.san.maybe_wire_reader("no.such.family", b"\x01", rem=7)
        assert r2.rem == 7  # a seam's own budget survives sanitizer-off


def test_wire_charge_is_a_noop_when_disabled(monkeypatch):
    monkeypatch.setenv("HD_SANITIZE", "0")
    for pk in BOTH:
        assert pk.san.wire_charge("no.such.family", 1 << 40) == 1 << 40
    monkeypatch.setenv("HD_SANITIZE", "1")
    _same_error(lambda pk: pk.san.wire_charge("no.such.family", 1), "HDS005")


def test_registered_budgets_match_the_annotations(monkeypatch):
    # The runtime resolves the budget the registration declared: the min
    # across a tag's specs.
    monkeypatch.setenv("HD_SANITIZE", "1")
    for pk in BOTH:
        for tag, specs in pk.ann.WIRE_CODECS.items():
            assert pk.san.WireBudget(tag).max_bytes == pk.ann.wire_budget_for(tag)
            assert pk.ann.wire_budget_for(tag) == min(s.max_bytes for s in specs)
    assert "msg.propose" in port_ann.WIRE_CODECS
