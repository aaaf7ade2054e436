"""The port's device-work queue and pipelined heights against the JAX
package's.

Queue mechanics (``hyperdrive_tpu_torch/devsched``) use counting
launchers: per-submitter FIFO, coalescing order, callbacks, ``max_depth``,
cancel, ``close``, ``on_drain``, the memoized and the null launcher, and
the drain policies. The pipelined network (``Simulation(
pipeline_heights=True)``) must commit the sequential run's digest and the
JAX package's pipelined digest, coalesce launches, fail loudly on a forged
signature, and take the reference's routes under ``device_tally``.
"""

import dataclasses

import pytest
import torch

from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.ops.votegrid import CheckedTallyView as RefCheckedTallyView
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.devsched import (
    DeficitRoundRobin,
    DeviceWorkQueue,
    FifoDrainPolicy,
    NullVerifyLauncher,
    SpeculationMismatch,
    VerifyLauncher,
)
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
from hyperdrive_tpu_torch.verifier import HostVerifier, NullVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

# ------------------------------------------------------- queue mechanics


class CountingLauncher:
    """Echo launcher: each payload's result is the payload itself; records
    every launch's shape for coalescing assertions."""

    kind = "echo"

    def __init__(self):
        self.launches = []

    def launch(self, payloads):
        self.launches.append([len(p) for p in payloads])
        return [list(p) for p in payloads]


def test_submit_returns_pending_future_and_drain_resolves():
    q = DeviceWorkQueue()
    launcher = CountingLauncher()
    fut = q.submit(launcher, [1, 2, 3])
    assert not fut.done() and q.depth == 1
    assert q.drain() == 1
    assert fut.done() and fut.result() == [1, 2, 3]
    assert launcher.launches == [[3]]


def test_per_submitter_fifo_resolution_order():
    # Futures resolve in global submission order; interleave three
    # "replicas" and the callback log replays the submission sequence.
    q = DeviceWorkQueue()
    launcher = CountingLauncher()
    order, expect = [], []
    for step in range(9):
        tag = (step % 3, step)
        expect.append(tag)
        q.submit(launcher, [tag]).add_done_callback(
            lambda f, t=tag: order.append(t)
        )
    q.drain()
    assert order == expect
    assert launcher.launches == [[1] * 9]  # ... all in ONE launch


def test_coalescing_groups_by_launcher_in_first_submission_order():
    q = DeviceWorkQueue()
    a, b = CountingLauncher(), CountingLauncher()
    q.submit(a, [1])
    q.submit(b, [2, 2])
    q.submit(a, [3])
    assert q.drain() == 3
    assert a.launches == [[1, 1]]  # two commands, one launch
    assert b.launches == [[2]]
    assert (q.submitted, q.launches, q.coalesced) == (3, 2, 1)


def test_future_fanout_multiple_callbacks_in_order():
    q = DeviceWorkQueue()
    fut = q.submit(CountingLauncher(), [7])
    seen = []
    fut.add_done_callback(lambda f: seen.append(("first", f.result())))
    fut.add_done_callback(lambda f: seen.append(("second", f.result())))
    q.drain()
    assert seen == [("first", [7]), ("second", [7])]
    fut.add_done_callback(lambda f: seen.append(("late", f.result())))
    assert seen[-1] == ("late", [7])  # a resolved future calls at once


def test_callbacks_may_submit_more_work_into_same_drain():
    q = DeviceWorkQueue()
    launcher = CountingLauncher()
    results = []

    def chain(f):
        results.append(f.result())
        if len(results) < 3:
            q.submit(launcher, [len(results)]).add_done_callback(chain)

    q.submit(launcher, [0]).add_done_callback(chain)
    assert q.drain() == 3
    assert results == [[0], [1], [2]]
    assert q.depth == 0


def test_max_depth_auto_drains_on_submit():
    q = DeviceWorkQueue(max_depth=2)
    launcher = CountingLauncher()
    f1 = q.submit(launcher, [1])
    assert not f1.done()
    f2 = q.submit(launcher, [2])  # reaches the bound: drains both
    assert f1.done() and f2.done()
    assert launcher.launches == [[1, 1]]


def test_cancel_skips_resolution_and_launch():
    q = DeviceWorkQueue()
    launcher = CountingLauncher()
    fut = q.submit(launcher, [1])
    live = q.submit(launcher, [2])
    assert fut.cancel()
    q.drain()
    assert fut.cancelled() and live.result() == [2]
    assert launcher.launches == [[1]]  # the cancelled payload never ran
    with pytest.raises(RuntimeError, match="cancelled"):
        fut.result()
    assert not live.cancel()  # already resolved


def test_result_forces_drain():
    q = DeviceWorkQueue()
    fut = q.submit(CountingLauncher(), [5])
    assert fut.result() == [5]
    assert q.depth == 0


def test_close_drains_then_rejects_submits():
    q = DeviceWorkQueue()
    launcher = CountingLauncher()
    futs = [q.submit(launcher, [i]) for i in range(4)]
    assert q.close() == 4
    assert all(f.done() for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(launcher, [9])


def test_on_drain_fires_with_resolved_count():
    q = DeviceWorkQueue()
    counts = []
    q.on_drain = counts.append
    q.submit(CountingLauncher(), [1])
    q.submit(CountingLauncher(), [2])
    q.drain()
    q.drain()  # an empty drain does not fire the hook
    assert counts == [2]


def test_launcher_result_count_is_checked():
    class Short(CountingLauncher):
        def launch(self, payloads):
            return []

    q = DeviceWorkQueue()
    q.submit(Short(), [1])
    with pytest.raises(RuntimeError, match="0 results for 1"):
        q.drain()


def test_verify_launcher_memoized_per_verifier():
    q = DeviceWorkQueue()
    host, null = HostVerifier(), NullVerifier()
    assert q.verify_launcher(host) is q.verify_launcher(host)
    assert isinstance(q.verify_launcher(host), VerifyLauncher)
    # NullVerifier has no verify_signatures: the transport-trusting leg.
    assert isinstance(q.verify_launcher(null), NullVerifyLauncher)


def test_verify_launcher_slices_and_filters_unsigned():
    class Echo:
        def verify_signatures(self, items):
            return [True] * len(items)

    rows = [(b"\x00" * 32, b"\x01" * 32, b"\x02" * 64)]
    unsigned = [(b"\x00" * 32, b"\x01" * 32, b"")]
    got = VerifyLauncher(Echo()).launch([rows * 2, unsigned + rows, []])
    assert got == [[True, True], [False, True], []]


def test_null_launcher_matches_null_verifier_verdicts():
    payload = [(b"\x00" * 32, b"\x01" * 32, None)] * 3
    assert NullVerifyLauncher().launch([payload]) == [[True, True, True]]
    assert NullVerifier().verify_batch(payload) == [True, True, True]


def test_launch_transcript_reaches_the_service_certificate():
    """The launchers carry the verifier's last transcript as the JAX
    package's do, and a service ``Certifier`` binds it: the certificate
    and its bytes equal the JAX package's."""
    from hyperdrive_tpu.certificates import marshal_certificate as ref_marshal
    from hyperdrive_tpu.codec import Writer as RefWriter
    from hyperdrive_tpu.devsched import DeviceWorkQueue as RefQueue
    from hyperdrive_tpu.devsched import NullVerifyLauncher as RefNullLauncher
    from hyperdrive_tpu.parallel.service import ShardVerifyService as RefService
    from hyperdrive_tpu_torch.certificates import marshal_certificate
    from hyperdrive_tpu_torch.codec import Writer
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.parallel.service import ShardVerifyService

    transcript = bytes(range(32))

    class Stub:
        last_transcript = b""

        def verify_signatures(self, items):
            self.last_transcript = transcript
            return [True] * len(items)

    ring = KeyRing.deterministic(4, namespace=b"transcript")
    items = [(kp.public, b"\x01" * 32, b"\x02" * 64) for kp in ring.pairs]
    assert NullVerifyLauncher.last_transcript == RefNullLauncher.last_transcript == b""
    certs = []
    for queue_cls, service_cls, writer, marshal in (
            (DeviceWorkQueue, ShardVerifyService, Writer, marshal_certificate),
            (RefQueue, RefService, RefWriter, ref_marshal)):
        launcher = queue_cls().verify_launcher(Stub())
        assert launcher.last_transcript == b""
        launcher.launch([items])
        assert launcher.last_transcript == transcript
        svc = service_cls(Stub(), max_depth=0)
        fut = svc.submit("t", items)
        svc.drain()
        assert fut.result() == [True] * 4
        cert = svc.certifier(ring.signatories, 1).observe_commit(
            3, 0, b"\x07" * 32, ring.signatories[:3])
        assert cert.transcript == transcript
        w = writer()
        marshal(cert, w)
        certs.append((cert, w.data()))
    assert dataclasses.astuple(certs[0][0]) == dataclasses.astuple(certs[1][0])
    assert certs[0][1] == certs[1][1]


# ------------------------------------------------- tenant drain policies


def _submit_tenants(q, launcher, plan):
    """plan: (origin, rows) pairs — one command each, its payload ``rows``
    copies of the origin tag so results identify tenants."""
    return [
        q.submit(launcher, [origin] * rows, origin=origin, rows=rows)
        for origin, rows in plan
    ]


def test_fifo_policy_is_scheduling_identical_to_no_policy():
    plan = [("a", 3), ("b", 1), ("a", 2), ("c", 5), ("b", 4)]
    shapes = []
    for policy in (None, FifoDrainPolicy()):
        q = DeviceWorkQueue(policy=policy)
        launcher = CountingLauncher()
        futs = _submit_tenants(q, launcher, plan)
        q.drain()
        shapes.append(launcher.launches)
        assert [f.result() for f in futs] == [[o] * r for o, r in plan]
    assert shapes[0] == shapes[1] == [[3, 1, 2, 5, 4]]


def test_drr_bounds_rows_per_cycle_and_shares_seats():
    # A firehose tenant next to two small ones: the capacity splits one
    # monster launch into a bounded train, and the small tenants ride the
    # first launch.
    q = DeviceWorkQueue(policy=DeficitRoundRobin(capacity_rows=16, quantum_rows=8))
    launcher = CountingLauncher()
    futs = _submit_tenants(q, launcher, [("fire", 10)] * 4 + [("b", 2), ("c", 2)])
    q.drain()
    assert all(f.done() for f in futs)
    assert len(launcher.launches) > 1
    assert all(sum(shape) <= 16 for shape in launcher.launches)
    first = launcher.launches[0]
    assert 2 in first and first.count(10) <= 2


def test_drr_starvation_bound_forces_selection():
    policy = DeficitRoundRobin(capacity_rows=8, quantum_rows=1, starve_after=3)
    q = DeviceWorkQueue(policy=policy)
    launcher = CountingLauncher()
    slow = q.submit(launcher, ["s"] * 8, origin="slow", rows=8)
    count = [0]

    def resubmit(f):
        count[0] += 1
        if count[0] < 12:
            q.submit(launcher, ["t"], origin="talk", rows=1).add_done_callback(resubmit)

    q.submit(launcher, ["t"], origin="talk", rows=1).add_done_callback(resubmit)
    q.drain()
    assert slow.done() and slow.result() == ["s"] * 8
    assert policy.forced_total >= 1
    assert policy.max_deferrals <= policy.starve_after


def test_drr_rows_default_to_payload_length_and_origins_share_a_seat():
    # Without ``rows`` a command weighs its payload's length; origin-less
    # commands share one round-robin seat, so the capacity still splits them.
    shapes = []
    for rows in (None, 1):
        q = DeviceWorkQueue(policy=DeficitRoundRobin(capacity_rows=4, quantum_rows=4))
        launcher = CountingLauncher()
        futs = [q.submit(launcher, ["x"] * 3, rows=rows) for _ in range(2)]
        q.drain()
        assert [f.result() for f in futs] == [["x"] * 3] * 2
        shapes.append(launcher.launches)
    assert shapes == [[[3], [3]], [[3, 3]]]


def test_drr_progress_guarantee_over_capacity_command():
    q = DeviceWorkQueue(policy=DeficitRoundRobin(capacity_rows=4))
    launcher = CountingLauncher()
    fut = q.submit(launcher, ["x"] * 9, origin="big", rows=9)
    q.drain()
    assert fut.result() == ["x"] * 9
    assert launcher.launches == [[9]]


def test_drr_weights_tilt_occupancy():
    policy = DeficitRoundRobin(capacity_rows=8, quantum_rows=2, weights={"heavy": 3})
    q = DeviceWorkQueue(policy=policy)

    class TaggingLauncher(CountingLauncher):
        def __init__(self):
            super().__init__()
            self.tags = []

        def launch(self, payloads):
            self.tags.append([p[0] for p in payloads])
            return super().launch(payloads)

    launcher = TaggingLauncher()
    futs = _submit_tenants(q, launcher, [("heavy", 2)] * 4 + [("light", 2)] * 4)
    q.drain()
    assert all(f.done() for f in futs)
    assert all(sum(shape) <= 8 for shape in launcher.launches)
    first = launcher.tags[0]
    assert first.count("heavy") > first.count("light") >= 1


def test_drr_preserves_per_tenant_fifo():
    q = DeviceWorkQueue(policy=DeficitRoundRobin(capacity_rows=4, quantum_rows=4))
    launcher = CountingLauncher()
    order = []
    for i in range(6):
        q.submit(launcher, [("a", i)], origin="a", rows=1).add_done_callback(
            lambda f, i=i: order.append(i)
        )
    q.drain()
    assert order == sorted(order)


def test_policy_validation():
    with pytest.raises(ValueError, match="capacity_rows"):
        DeficitRoundRobin(capacity_rows=0)
    with pytest.raises(ValueError, match="quantum_rows"):
        DeficitRoundRobin(quantum_rows=0)
    with pytest.raises(ValueError, match="starve_after"):
        DeficitRoundRobin(starve_after=0)


# ------------------------------------------------ pipelined burst network

SIGNED = dict(n=4, target_height=6, seed=7, sign=True, burst=True)


def _pipelined(**kw):
    return Simulation(batch_verifier=HostVerifier(), pipeline_heights=True,
                      **dict(SIGNED, **kw))


def test_pipelined_digest_parity_with_sequential_and_reference():
    seq = Simulation(batch_verifier=HostVerifier(), **SIGNED).run()
    pipe = _pipelined()
    got = pipe.run()
    ref = RefSimulation(pipeline_heights=True, **SIGNED)
    want = ref.run()
    assert seq.completed and got.completed and want.completed
    assert got.commit_digest() == seq.commit_digest() == want.commit_digest()
    assert (got.steps, got.heights) == (seq.steps, seq.heights)
    q = pipe._sched
    assert q.coalesced > 0 and q.launches < q.submitted
    assert (q.submitted, q.launches, q.coalesced) == (
        ref._sched.submitted, ref._sched.launches, ref._sched.coalesced
    )
    assert q.depth == 0 and not pipe._gated_commits  # drained before return


def test_pipelined_run_is_deterministic_at_fixed_seed():
    a, b = _pipelined(), _pipelined()
    res_a, res_b = a.run(), b.run()
    assert res_a.commit_digest() == res_b.commit_digest()
    assert res_a.commits == res_b.commits and res_a.steps == res_b.steps
    assert (a._sched.submitted, a._sched.launches, a._sched.coalesced) == (
        b._sched.submitted, b._sched.launches, b._sched.coalesced
    )


def test_forged_signature_raises_speculation_mismatch():
    # Speculation accepts parseable-and-signed rows; a verifier rejecting
    # them all at drain time stands for forged-but-well-formed signatures.
    sim = _pipelined()
    launcher = sim._sched.verify_launcher(sim.batch_verifier)
    launcher.verifier = type(
        "Forged", (), {"verify_signatures": staticmethod(lambda items: [False] * len(items))}
    )()
    with pytest.raises(SpeculationMismatch, match="forged-but-well-formed"):
        sim.run()
    # No commit rested on the refused launch.
    assert not any(sim.commits)


def test_pipeline_heights_requires_burst_and_a_verifier():
    with pytest.raises(ValueError, match="burst"):
        Simulation(n=4, target_height=3, sign=True, pipeline_heights=True)
    with pytest.raises(ValueError, match="batch_verifier"):
        Simulation(n=4, target_height=3, burst=True, pipeline_heights=True)


def test_pipelined_device_tally_takes_the_reference_routes():
    # A pipelined settle dispatches on the host counters and only poisons
    # the grid: nothing fused, no tally launch, no host-routed settle.
    views = []

    def check(view, proc):
        views.append(CheckedTallyView(view, proc))
        return views[-1]

    kw = dict(SIGNED, dedup_verify=True, device_tally=True)
    sim = _pipelined(dedup_verify=True, device_tally=True, tally_check=check,
                     device="cpu")
    got = sim.run()
    ref = RefSimulation(pipeline_heights=True, batch_verifier=RefHostVerifier(),
                        tally_check=RefCheckedTallyView, **kw)
    want = ref.run()
    assert got.commit_digest() == want.commit_digest()
    assert (got.steps, got.heights) == (want.steps, want.heights)
    assert (sim.fused_settles, sim.tally_launches, sim.host_routed_settles) == (0, 0, 0)
    assert sim.vote_settles > 0 and sim._sched.launches < sim._sched.submitted
    assert sum(v.hits for v in views) == 0
    assert any(sim._grid_dirty)  # the bypassed slots are poisoned


def test_pipelined_coalesced_launch_through_the_plain_ladder():
    # TorchBatchVerifier on the CPU: each coalesced launch runs the CUDA
    # kernel's plain version over several settles' rows in one 64 bucket.
    kw = dict(SIGNED, target_height=2)
    seq = Simulation(batch_verifier=HostVerifier(), **kw).run()
    sim = Simulation(batch_verifier=TorchBatchVerifier(device="cpu", buckets=(64,)),
                     pipeline_heights=True, small_window_host=False, device="cpu",
                     **kw)
    ed25519_cuda.reset_stats()
    got = sim.run()
    assert got.commit_digest(up_to=2) == seq.commit_digest(up_to=2)
    q = sim._sched
    assert 0 < q.launches < q.submitted and q.coalesced > 0
    assert ed25519_cuda.stats["ed25519_verify"].launches == 0  # CPU: plain


class _BucketedStub:
    """An accept-all verifier with a bucket ladder, recording each call's
    size: the queue's slot-close rule reads ``host.buckets``."""

    def __init__(self, buckets):
        self.host = type("Host", (), {"buckets": buckets})()
        self.calls = []

    def verify_signatures(self, items):
        self.calls.append(len(items))
        return [True] * len(items)


@pytest.mark.parametrize(
    "buckets, calls",
    [
        # Default ladder: a 256-lane vote window fills its bucket, so the
        # spill rule closes every slot after one settle.
        ((64, 256, 1024, 4096), [1, 256, 256] * 5),
        # The JAX config-4 bench's ladder (chip_smoke.PIPE_BUCKETS).
        ((1024, 4096, 16384), [770, 770, 769, 256]),
    ],
)
def test_spill_rule_at_the_main_path_width(buckets, calls):
    stub = _BucketedStub(buckets)
    sim = Simulation(n=256, target_height=5, seed=1, sign=True, burst=True,
                     dedup_verify=True, small_window_host=False,
                     batch_verifier=stub, pipeline_heights=True)
    res = sim.run()
    assert res.commit_digest(up_to=5).startswith("215413db54656240")
    assert stub.calls == calls
    assert (sim._sched.submitted, sim._sched.launches) == (15, len(calls))
