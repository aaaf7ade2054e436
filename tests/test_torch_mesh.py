"""The port's sharded verify+tally steps, the sharded vote grid and
``challenge_from_round``, held against the JAX package on the CPU.

The JAX side is only its cheap functions (the host oracle, the packers
``grid_pack``/``grid_pack_wire``, ``ops.tally`` and the single-device
``VoteGrid``): its sharded programs compile for minutes on the CPU, and
the JAX package's own tests (``tests/test_mesh.py``,
``tests/test_multihost.py``, ``tests/test_harness.py``) hold them to the
same oracle and host runs. The port runs here on a world-size-1 gloo group
over a ``HashStore`` (created by ``make_mesh``, destroyed by the
fixture); ``tests/test_torch_multihost.py`` runs the real collectives in
worker processes.
"""

import hashlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import torch_multihost_worker as worker
from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.ops import tally as ref_tally
from hyperdrive_tpu.ops import votegrid as ref_vg
from hyperdrive_tpu.parallel import mesh as ref_mesh
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.ops import ed25519 as ted
from hyperdrive_tpu_torch.ops import ed25519_wire as wire
from hyperdrive_tpu_torch.ops.tally import pack_values
from hyperdrive_tpu_torch.ops.votegrid import VoteGrid
from hyperdrive_tpu_torch.parallel import (
    global_window_from_local,
    grid_pack,
    grid_pack_wire,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    make_sharded_step,
    replicate_to_all_hosts,
    sharded_chalwire_tally,
    sharded_verify_tally,
)

torch.set_num_threads(1)

R, V, CORRUPT = worker.R, worker.V, worker.CORRUPT
VALUES = [bytes([r + 1]) * 32 for r in range(R)]


@pytest.fixture
def mesh1():
    """A 1 x 1 CPU mesh on a world-size-1 gloo group, torn down after."""
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def expected_window():
    """The corrupt pattern's mask and its counts and flags through the JAX
    package's ``ops.tally``: what every sharded step must give, gathered."""
    ok = np.array([[(r, v) not in CORRUPT for v in range(V)] for r in range(R)])
    vote = jnp.asarray(np.stack([pack_values([VALUES[r]] * V) for r in range(R)]))
    counts = ref_tally.tally_counts(vote, jnp.asarray(ok), jnp.asarray(pack_values(VALUES)))
    flags = ref_tally.quorum_flags(counts, V // 3)
    return ok, {k: np.asarray(v) for k, v in counts.items()}, \
        {k: np.asarray(v) for k, v in flags.items()}


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), k


# ------------------------------------------------ (a) challenge_from_round


@pytest.mark.parametrize("rounds,validators,lanes,form", [
    (3, 4, 16, "grouped"), (2, 5, 10, "grouped"),
    # past 255 rounds: a full 256-row table, and one too long for the byte
    (256, 1, 256, "grouped"), (300, 1, 320, "per-lane"), (256, 4, 1024, "grouped"),
])
def test_challenge_from_round_equals_hashlib_and_the_oracle(rounds, validators, lanes,
                                                            form, monkeypatch):
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    forms = []
    for name, tag in (("challenge", "per-lane"), ("challenge_grouped", "grouped")):
        fn = getattr(ed25519_cuda, name)
        monkeypatch.setattr(ed25519_cuda, name,
                            lambda *a, fn=fn, tag=tag: forms.append(tag) or fn(*a))
    rng = np.random.default_rng(rounds * 10 + validators)
    ring = KeyRing.deterministic(validators, namespace=b"chalround")
    table = wire.ValidatorTable(ring.signatories, device="cpu")
    idx = torch.from_numpy(rng.integers(0, validators, lanes).astype(np.int32))
    r_rows = torch.from_numpy(rng.integers(0, 256, (lanes, 32), dtype=np.uint8))
    m_round = torch.from_numpy(rng.integers(0, 256, (rounds, 32), dtype=np.uint8))
    got = wire.challenge_from_round(idx, r_rows, m_round, table.rows, validators)
    cached = wire.make_challenge_round_fn(validators)
    assert wire.make_challenge_round_fn(validators) is cached
    assert torch.equal(cached(idx, r_rows, m_round, table.rows), got)
    assert forms == [form, form]
    assert torch.equal(
        wire.challenge_from_round_plain(idx, r_rows, m_round, table.rows, validators), got)
    for lane in range(lanes):
        live = lane < rounds * validators
        msg = bytes(m_round[lane // validators].numpy()) if live else bytes(32)
        r, a = bytes(r_rows[lane].numpy()), ring.signatories[int(idx[lane])]
        k = int.from_bytes(hashlib.sha512(r + a + msg).digest(), "little") % ref_ed.L
        assert k == ref_ed.challenge_scalar(r, a, msg)
        assert int.from_bytes(bytes(got[lane].numpy()), "little") == k, lane


def test_round_digest_index_holds_one_byte():
    m_idx = wire.round_digest_index(256 * 2 + 3, 255, 2, "cpu")
    assert m_idx.dtype == torch.uint8
    assert m_idx[:4].tolist() == [0, 0, 1, 1]
    assert m_idx[508:].tolist() == [254, 254] + [255] * 5  # 5 padding lanes
    # 256 rounds with no padding lane: rows 0-255, no zero row
    full = wire.round_digest_index(256 * 2, 256, 2, "cpu")
    assert full[-2:].tolist() == [255, 255]
    assert wire.digest_table_rows(256 * 2, 256, 2) == wire.MAX_DIGEST_ROWS == 256
    assert torch.equal(wire.grouped_digest_index(256 * 2, 256, 2, "cpu"), full)
    assert wire.grouped_digest_index(256 * 2 + 1, 256, 2, "cpu") is None
    with pytest.raises(ValueError, match="at most 256"):
        wire.round_digest_index(256 * 2 + 1, 256, 2, "cpu")
    with pytest.raises(ValueError, match="lanes"):
        wire.round_digest_index(7, 2, 4, "cpu")


# ------------------------------------------------------------ (b) packers


def test_packers_equal_the_reference():
    ring = KeyRing.deterministic(V, namespace=b"mesh")
    ref_ring = RefKeyRing.deterministic(V, namespace=b"mesh")
    shaped, prevalid = grid_pack(ring, R, V, VALUES, corrupt=CORRUPT, device="cpu")
    ref_shaped, ref_prevalid = ref_mesh.grid_pack(ref_ring, R, V, VALUES, corrupt=CORRUPT)
    want, want_prevalid = ted.from_reference([np.array(a) for a in ref_shaped],
                                             ref_prevalid, device="cpu")
    assert np.array_equal(prevalid, want_prevalid.numpy()) and prevalid.all()
    assert len(shaped) == 7
    for a, b in zip(shaped, want):
        assert a.shape == b.shape and torch.equal(a, b)

    rows, table, prevalid = grid_pack_wire(ring, R, V, VALUES, corrupt=CORRUPT,
                                           device="cpu")
    ref_rows, ref_table, ref_prevalid = ref_mesh.grid_pack_wire(
        ref_ring, R, V, VALUES, corrupt=CORRUPT)
    want, want_prevalid = wire.from_reference([np.array(a) for a in ref_rows],
                                              ref_prevalid, device="cpu")
    assert np.array_equal(prevalid, want_prevalid.numpy())
    for a, b in zip(rows, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(table.arrays_chal(), ref_table.arrays_chal()):
        assert np.array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------- (c) world size 1, in process


def test_sharded_steps_at_world_size_one(mesh1):
    ok_want, counts_want, flags_want = expected_window()
    ring = KeyRing.deterministic(V, namespace=b"mesh")
    vote = torch.from_numpy(np.stack([pack_values([VALUES[r]] * V) for r in range(R)]))
    target = torch.from_numpy(pack_values(VALUES))
    shaped, _ = grid_pack(ring, R, V, VALUES, corrupt=CORRUPT, device="cpu")
    window = global_window_from_local(mesh1, shaped)
    counts, flags, ok = sharded_verify_tally(mesh1)(*window, vote, target, V // 3)
    assert np.array_equal(ok.numpy(), ok_want)
    _same(counts, counts_want)
    _same(flags, flags_want)

    (idx, r_rows, s_rows, m_round), table, _ = grid_pack_wire(
        ring, R, V, VALUES, corrupt=CORRUPT, device="cpu")
    counts, flags, ok = sharded_chalwire_tally(mesh1)(
        idx, r_rows, s_rows, m_round, *table.arrays_chal(), vote, target, V // 3)
    assert np.array_equal(ok.numpy(), ok_want)
    _same(counts, counts_want)
    _same(flags, flags_want)

    with pytest.raises(ValueError, match="backend"):
        sharded_verify_tally(mesh1, backend="pallas")
    with pytest.raises(ValueError, match="mesh device"):
        sharded_verify_tally(mesh1)(*window[:6], window[6].to(torch.float32).to("meta"),
                                    vote, target, 1)


def test_sharded_step_example_args_count_nothing(mesh1):
    step, example_args = make_sharded_step(mesh1)
    args = example_args(rounds=2, validators=3)
    assert args[0].shape == (2, 3, 20) and args[5].shape == (2, 3, 64) and args[-1] == 1
    counts, flags, ok = step(*args)
    assert int(counts["total"].sum()) == 0 and not flags["quorum_any"].any()
    assert not ok.any()


def test_multihost_helpers_at_world_size_one(mesh1):
    assert init_distributed() == 1
    assert make_hybrid_mesh(device="cpu").shape == (1, 1)
    local = np.arange(2 * 4 * 3, dtype=np.int32).reshape(2, 4, 3)
    for spec in (("hr", "val"), ("hr",), (None, "val"), ()):
        (got,) = global_window_from_local(mesh1, (local,), spec=spec)
        assert np.array_equal(got.numpy(), local)
    got = replicate_to_all_hosts(mesh1, np.arange(5, dtype=np.int32))
    assert got.tolist() == list(range(5))


# ------------------------------------------------------ (d) the sharded grid


@pytest.fixture(scope="module")
def grid_reference():
    """The JAX single-device grid's counts over ``worker.grid_steps()``."""
    ref = ref_vg.VoteGrid(**worker.GRID)
    return [{k: np.asarray(v) for k, v in ref.update_and_tally(*a).items()}
            for a in worker.grid_steps()]


def test_sharded_vote_grid_equals_the_reference_grid(mesh1, grid_reference):
    grid = VoteGrid(**worker.GRID, mesh=mesh1, device="cpu")
    assert grid._values.shape[3] == worker.GRID["n_validators"]
    for got, want in zip(worker.grid_counts(grid), grid_reference):
        _same(got, want)
    with pytest.raises(ValueError, match="single-chip"):
        grid.attach_fused(lambda b: None)
    with pytest.raises(ValueError, match="mesh device"):
        VoteGrid(**worker.GRID, mesh=mesh1, device="meta")


# --------------------------------------------------- (f) shape validation


def test_mesh_shape_validation():
    with pytest.raises(ValueError, match="world size"):
        make_mesh(hr=3, device="cpu")  # 3 does not divide 1
    assert not dist.is_initialized()


def test_hybrid_mesh_requires_divisible_hr(monkeypatch):
    # Validation fires before any group is touched: three nodes cannot
    # tile an 'hr' axis of 2 without splitting a node.
    from hyperdrive_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "_world_size", lambda: 8)
    monkeypatch.setattr(multihost, "_node_count", lambda: 3)
    with pytest.raises(ValueError, match="multiple of the node count"):
        make_hybrid_mesh(hr_dcn=2, val_ici=4)


def test_hybrid_mesh_rejects_local_shape_mismatch(monkeypatch):
    # Two nodes of eight ranks admit a 1 x 4 tile a node on average, but
    # this node holds two ranks: the local check must fail loudly.
    from hyperdrive_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "_world_size", lambda: 8)
    monkeypatch.setattr(multihost, "_node_count", lambda: 2)
    monkeypatch.setattr(multihost, "_local_world_size", lambda: 2)
    with pytest.raises(ValueError, match="attached to this node"):
        make_hybrid_mesh(hr_dcn=2, val_ici=4)
    with pytest.raises(ValueError, match="world size"):
        make_hybrid_mesh(hr_dcn=3, val_ici=3)
