"""The PyTorch port's vote grid and tallies against the JAX package's.

The same seeded numpy inputs go through ``hyperdrive_tpu.ops.tally`` /
``hyperdrive_tpu.ops.votegrid`` (single device) and their ports on the CPU:
counts must be equal for every key, grids equal word for word, across
resets, L28 lanes, empty launches, bucket padding and the fused merge's
presence guard. The fused path's verify is a stub that returns a fixed
mask on both sides, and once the port's plain ladder through
``TorchBatchVerifier(device="cpu").fused_inner``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperdrive_tpu.ops import tally as ref_tally
from hyperdrive_tpu.ops import votegrid as ref_vg
from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops import tally
from hyperdrive_tpu_torch.ops import votegrid as vg
from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier, verify_plain
from hyperdrive_tpu_torch.types import NIL_VALUE

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

# Vote values: two proposals, nil, and one whose words are negative int32
# (bytes >= 0x80), so words are compared as bit patterns.
PALETTE = [b"\xaa" * 32, b"\x11" * 32, NIL_VALUE, bytes(range(0x80, 0xA0))]
KEYS = ("matching", "nil", "total", "quorum_matching", "quorum_nil",
        "quorum_any", "l28", "l28_quorum")


def _words(value: bytes) -> np.ndarray:
    return np.frombuffer(value, dtype="<i4").astype(np.int32)


def _meta(rng, n, R, f=1):
    """Seeded per-replica launch metadata: targets from the palette on
    random rounds, an L28 lane on about half the replicas."""
    targets = np.zeros((n, R, 8), dtype=np.int32)
    tvalid = rng.random((n, R)) < 0.7
    for i in range(n):
        for r in range(R):
            targets[i, r] = _words(PALETTE[rng.integers(0, 2)])
    l28_slot = np.where(rng.random(n) < 0.5, rng.integers(0, R, n), -1).astype(np.int32)
    l28_target = np.stack([_words(PALETTE[rng.integers(0, 4)]) for _ in range(n)])
    fs = np.full(n, f, dtype=np.int32)
    return targets, tvalid, l28_slot, l28_target, fs


def _same_counts(got, want):
    for key in KEYS:
        assert key in got and len(got) == len(KEYS)
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        assert np.array_equal(a, b), key


def _same_grid(grid, ref):
    assert np.array_equal(grid._values.numpy(), np.asarray(ref._values))
    assert np.array_equal(grid._present.numpy(), np.asarray(ref._present))


@pytest.mark.parametrize("seed", [0, 1])
def test_tally_ops_match_reference(seed):
    rng = np.random.default_rng(seed)
    R, V = 4, 9
    vals = np.stack([_words(PALETTE[k]) for k in rng.integers(0, 4, R * V)]).reshape(R, V, 8)
    present = rng.random((R, V)) < 0.8
    targets = np.stack([_words(PALETTE[k]) for k in rng.integers(0, 4, R)])
    got = tally.tally_counts(torch.from_numpy(vals), torch.from_numpy(present),
                             torch.from_numpy(targets))
    want = ref_tally.tally_counts(jnp.asarray(vals), jnp.asarray(present),
                                  jnp.asarray(targets))
    for key in want:
        assert got[key].dtype == torch.int32
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for f in (1, 2):
        flags = tally.quorum_flags(got, f)
        ref_flags = ref_tally.quorum_flags(want, jnp.int32(f))
        for key in ref_flags:
            assert np.array_equal(flags[key].numpy(), np.asarray(ref_flags[key])), key
    values = [PALETTE[k] for k in rng.integers(0, 4, 5)]
    assert np.array_equal(tally.pack_values(values), ref_tally.pack_values(values))
    assert tally.pack_value(PALETTE[3]).dtype == np.int32
    assert (tally.pack_value(PALETTE[3]) < 0).all()
    with pytest.raises(ValueError):
        tally.pack_value(b"short")


def _rows(rng, n, R, V, k):
    """k scatter rows on distinct lanes (the host's one-row-per-lane
    guarantee) with palette values."""
    lanes = rng.choice(n * 2 * R * V, size=k, replace=False)
    idx = np.stack(np.unravel_index(lanes, (n, 2, R, V)), axis=1).astype(np.int32)
    words = np.stack([_words(PALETTE[j]) for j in rng.integers(0, 4, k)]) if k else \
        np.zeros((0, 8), dtype=np.int32)
    return idx, words.astype(np.int32)


@pytest.mark.parametrize("seed", [2, 3])
def test_update_and_tally_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, V, R = 3, 5, 4
    grid = vg.VoteGrid(n, V, r_slots=R, buckets=(4, 8), device="cpu")
    ref = ref_vg.VoteGrid(n, V, r_slots=R, buckets=(4, 8))
    # Row counts: a bucket fit, an empty launch, a launch past the largest
    # bucket (padded to its next multiple), and lanes written again later.
    for step, k in enumerate((3, 0, 13, 6, 8, 0, 20)):
        idx, words = _rows(rng, n, R, V, k)
        reset = rng.random(n) < (0.4 if step else 0.0)
        meta = _meta(rng, n, R, f=int(rng.integers(1, 3)))
        got = grid.update_and_tally(idx, words, reset, *meta)
        want = ref.update_and_tally(idx, words, reset, *meta)
        _same_counts(got, want)
        _same_grid(grid, ref)
    assert int(grid._present.sum()) > 0


def _side(rng, n, R, V, b, grid_present):
    """One seeded fused launch: the side inputs and the flat side array in
    the layout of ``_fused_kernel``. Lanes already present in the grid are
    claimed again with another value (the presence guard)."""
    upd_lane = np.where(rng.random((2, R, V)) < 0.5,
                        rng.integers(0, b, (2, R, V)), -1).astype(np.int32)
    again = np.argwhere(grid_present.any(axis=0))[:4]
    for p, r, v in again:
        upd_lane[p, r, v] = rng.integers(0, b)
    upd_vals = np.stack([_words(PALETTE[j]) for j in rng.integers(0, 4, 2 * R * V)])
    upd_vals = upd_vals.reshape(2, R, V, 8).astype(np.int32)
    reset = rng.random(n) < 0.3
    participate = rng.random(n) < 0.7
    targets, tvalid, l28_slot, l28_target, fs = _meta(rng, n, R)
    tw = R * 8 + R + 8
    meta = np.stack([reset, participate, l28_slot, fs], axis=1).astype(np.int32)
    tpack = np.concatenate([targets.reshape(n, R * 8), tvalid, l28_target], axis=1)
    side = np.concatenate([upd_lane.reshape(-1), upd_vals.reshape(-1),
                           meta.reshape(-1), tpack.reshape(n * tw)]).astype(np.int32)
    args = (upd_lane, upd_vals, reset, participate, targets, tvalid, l28_slot,
            l28_target, fs)
    return side, args


def _verify_arrays(b):
    return ([np.zeros((b, 20), dtype=np.int32)] * 5
            + [np.zeros((b, 64), dtype=np.int32)] * 2)


@pytest.mark.parametrize("seed", [4, 5])
def test_fused_kernel_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, V, R, b = 3, 6, 4, 8
    mask = rng.random(b) < 0.75
    arrays = _verify_arrays(b)

    # The two programs on the same side arrays, step by step.
    values = torch.zeros((n, 2, R, V, 8), dtype=torch.int32)
    present = torch.zeros((n, 2, R, V), dtype=torch.bool)
    ref_values = jnp.zeros((n, 2, R, V, 8), dtype=jnp.int32)
    ref_present = jnp.zeros((n, 2, R, V), dtype=bool)
    mask_t, mask_j = torch.from_numpy(mask), jnp.asarray(mask)
    for _ in range(3):
        side, _ = _side(rng, n, R, V, b, present.numpy().reshape(-1, 2, R, V))
        out = vg._fused_kernel(lambda *a: mask_t, values, present,
                               *map(torch.from_numpy, arrays), torch.from_numpy(side))
        ref_values, ref_present, ref_out = ref_vg._fused_kernel(
            lambda *a: mask_j, ref_values, ref_present,
            *map(jnp.asarray, arrays), jnp.asarray(side))
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), np.asarray(ref_out))
        assert np.array_equal(values.numpy(), np.asarray(ref_values))
        assert np.array_equal(present.numpy(), np.asarray(ref_present))
    assert bool(present.any())

    # The grids' fused entry points: side built by each package, one
    # upload, mask and counts through _FusedOut / LazyCounts.
    grid = vg.VoteGrid(n, V, r_slots=R, device="cpu")
    ref = ref_vg.VoteGrid(n, V, r_slots=R)
    grid.attach_fused(lambda batch: lambda *a: mask_t)
    ref.attach_fused(lambda batch: lambda *a: mask_j)
    for _ in range(3):
        _, args = _side(rng, n, R, V, b, grid._present.numpy())
        got = grid.fused_update_and_tally(arrays, *args)
        want = ref.fused_update_and_tally(arrays, *args)
        assert np.array_equal(got.mask(), want.mask())
        _same_counts(got.counts(), want.counts())
        _same_grid(grid, ref)


def test_fused_update_and_tally_through_the_plain_ladder():
    # One 24-signature window (valid, flipped-bit, malformed and
    # wrong-digest lanes) through TorchBatchVerifier(device="cpu")'s
    # fused_inner: the mask must equal verify_plain's on the same packed
    # rows, and the counts a second grid's fed that mask.
    ring = KeyRing.deterministic(8, namespace=b"votegrid")
    rng = np.random.default_rng(6)
    items = []
    for j in range(24):
        kp = ring[j % 8]
        digest = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        sig = host_ed.sign(kp.seed, digest)
        if j % 4 == 1:
            sig = sig[:7] + bytes([sig[7] ^ 4]) + sig[8:]
        elif j % 4 == 2:
            sig = b"\xff" * 64
        elif j % 8 == 3:
            digest = bytes(32)
        items.append((kp.public, digest, sig))
    bv = TorchBatchVerifier(device="cpu", buckets=(64,))
    arrays, prevalid, nitems = bv.host.pack(items)
    n, V, R = 4, 8, 4
    upd_lane = np.full((2, R, V), -1, dtype=np.int32)
    upd_vals = np.zeros((2, R, V, 8), dtype=np.int32)
    for j in range(24):
        upd_lane[j // 8 % 2, j // 16, j % 8] = j
        upd_vals[j // 8 % 2, j // 16, j % 8] = _words(PALETTE[j % 4])
    rng = np.random.default_rng(7)
    targets, tvalid, l28_slot, l28_target, fs = _meta(rng, n, R)
    args = (upd_lane, upd_vals, np.zeros(n, bool), np.array([1, 1, 0, 1], bool),
            targets, tvalid, l28_slot, l28_target, fs)

    grid = vg.VoteGrid(n, V, r_slots=R, device="cpu")
    grid.attach_fused(bv.fused_inner)
    got = grid.fused_update_and_tally(arrays, *args)
    plain = verify_plain(*map(torch.from_numpy, arrays))
    assert np.array_equal(got.mask(), plain.numpy())
    oracle = np.array([host_ed.verify(*it) for it in items])
    assert np.array_equal((got.mask() & prevalid)[:nitems], oracle)
    assert 0 < oracle.sum() < len(items)

    fed = vg.VoteGrid(n, V, r_slots=R, device="cpu")
    fed.attach_fused(lambda batch: lambda *a: plain)
    want = fed.fused_update_and_tally(arrays, *args)
    _same_counts(got.counts(), want.counts())
    assert torch.equal(grid._values, fed._values)
    assert torch.equal(grid._present, fed._present)
    assert int(grid._present[2].sum()) == 0  # replica 2 did not participate


def test_tally_views_answer_and_decline_as_the_reference():
    n, V, R = 2, 5, 4
    a, b = PALETTE[0], PALETTE[1]
    rows = [(0, 0, 0, v, a) for v in range(3)] + [(0, 1, 0, v, a) for v in range(2)]
    rows += [(0, 0, 1, 0, NIL_VALUE), (0, 0, 2, 1, a), (0, 0, 2, 2, a)]
    idx = np.array([r[:4] for r in rows], dtype=np.int32)
    words = np.stack([_words(r[4]) for r in rows])
    targets = np.zeros((n, R, 8), dtype=np.int32)
    tvalid = np.zeros((n, R), dtype=bool)
    targets[0, 0], tvalid[0, 0] = _words(a), True
    l28_slot = np.array([2, -1], dtype=np.int32)
    l28_target = np.stack([_words(a), np.zeros(8, np.int32)])
    meta = (targets, tvalid, l28_slot, l28_target, np.full(n, 1, dtype=np.int32))
    grid = vg.VoteGrid(n, V, r_slots=R, buckets=(16,), device="cpu")
    ref = ref_vg.VoteGrid(n, V, r_slots=R, buckets=(16,))
    reset = np.zeros(n, dtype=bool)
    counts = grid.update_and_tally(idx, words, reset, *meta)
    ref_counts = ref.update_and_tally(idx, words, reset, *meta)
    queries = [("prevotes_for", r, v) for r in (0, 1, 2, 3, 4, 99) for v in (a, b, NIL_VALUE)]
    queries += [("precommits_for", r, v) for r in (0, 1, -1) for v in (a, NIL_VALUE)]
    queries += [(q, r) for q in ("prevote_total", "precommit_total") for r in (0, 1, 4, -1)]
    for dirty in (frozenset(), {(0, 0)}, {(1, 0), (0, 2)}):
        view = vg.TallyView(0, 1, counts, R, {0: a}, 2, a, dirty)
        ref_view = ref_vg.TallyView(0, 1, ref_counts, R, {0: a}, 2, a, dirty)
        for name, *q in queries:
            assert getattr(view, name)(*q) == getattr(ref_view, name)(*q), (name, q, dirty)
    view = vg.TallyView(0, 1, counts, R, {0: a}, 2, a)
    assert view.prevotes_for(0, a) == 3 and view.precommits_for(0, a) == 2
    assert view.prevotes_for(2, a) == 2  # through the L28 lane only
    assert view.prevotes_for(0, b) is None and view.prevote_total(99) is None
    assert counts["l28"][0] == 2 and bool(counts["l28_quorum"][0]) is False


class _State:
    def __init__(self, prevotes, precommits):
        self.prevote_logs = prevotes
        self.precommit_logs = precommits

    def count_prevotes_for(self, rnd, value):
        return sum(m == value for m in self.prevote_logs.get(rnd, {}).values())

    def count_precommits_for(self, rnd, value):
        return sum(m == value for m in self.precommit_logs.get(rnd, {}).values())


class _Proc:
    def __init__(self, state):
        self.state = state


def test_checked_view_counts_hits_and_raises_on_mismatch():
    a = PALETTE[0]
    counts = {"matching": np.array([[[3, 0], [1, 0]]]), "nil": np.zeros((1, 2, 2), int),
              "total": np.array([[[3, 0], [1, 0]]]), "l28": np.array([0])}
    view = vg.TallyView(0, 5, counts, 2, {0: a}, -1, b"")
    logs = {0: {b"s%d" % i: a for i in range(3)}}
    checked = vg.CheckedTallyView(view, _Proc(_State(logs, {0: {b"s0": a}})))
    assert checked.height == 5
    assert checked.prevotes_for(0, a) == 3
    assert checked.prevote_total(0) == 3
    assert checked.precommits_for(0, a) == 1 and checked.precommit_total(0) == 1
    assert checked.prevotes_for(7, a) is None  # declined: no hit
    assert checked.hits == 4
    wrong = vg.CheckedTallyView(view, _Proc(_State({0: {b"s0": a}}, {})))
    with pytest.raises(AssertionError, match="device prevote"):
        wrong.prevotes_for(0, a)


def test_lazy_counts_defer_the_copy_and_grids_default_to_the_card():
    packed = torch.arange(2 * (2 * 3 * 3 + 1), dtype=torch.int32).view(2, -1)
    lazy = vg.LazyCounts(packed, 2, 3, np.array([1, 2], dtype=np.int32))
    assert len(lazy) == 8 and "l28" in lazy and list(lazy) == list(KEYS)
    assert lazy._dict is None  # shape probes copy nothing
    assert lazy["total"].shape == (2, 2, 3) and lazy["l28"].tolist() == [18, 37]
    assert lazy["quorum_any"][1].all() and not lazy["quorum_any"][0, 0, 0]
    with pytest.raises(KeyError):
        lazy["nope"]
    # The sharded grid is ported: a validator count that does not divide
    # over the mesh's 'val' axis raises the reference's ValueError in both
    # packages (a 1 x 2 mesh: the check comes before any collective).
    import types

    import jax

    from hyperdrive_tpu.parallel import make_mesh as ref_make_mesh

    with pytest.raises(ValueError, match="divide evenly"):
        vg.VoteGrid(4, 5, mesh=types.SimpleNamespace(shape=(1, 2), mesh_dim_names=(
            "hr", "val")), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        ref_vg.VoteGrid(4, 5, mesh=ref_make_mesh(devices=jax.devices()[:2], hr=1))
    with pytest.raises(RuntimeError, match="attach_fused"):
        vg.VoteGrid(1, 1, device="cpu").fused_update_and_tally(
            _verify_arrays(1), *([None] * 9))
    if torch.cuda.is_available():
        assert vg.VoteGrid(4, 4).device.type == "cuda"
        assert Simulation(n=4, target_height=1, burst=True,
                          device_tally=True).vote_grid.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vg.VoteGrid(4, 4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation(n=4, target_height=1, burst=True, device_tally=True)
