"""Worker process for the port's multi-process mesh tests (gloo on the CPU).

Launched by ``tests/test_torch_multihost.py`` as
``python tests/torch_multihost_worker.py <steps-url> <sim-url> <rank>``,
one process a rank, for ranks 1-3 (the test's own process is rank 0,
through :func:`run_rank`). Each joins a world-size-4 process group
through ``parallel.init_distributed`` (a ``file://`` store), then:

- ``steps``: builds the ("hr", "val") mesh with ``make_hybrid_mesh`` (2 x
  2), packs the window of ``tests/test_mesh.py`` (R = 2, V = 4, two
  corrupt lanes), cuts its block from its ``hr`` slab with
  ``global_window_from_local``, broadcasts ``f`` with
  ``replicate_to_all_hosts`` and runs ``sharded_verify_tally`` and
  ``sharded_chalwire_tally``;

then ranks 0 and 1 join a world-size-2 group on the second store:

- ``sim``: runs the signed four-replica network with the vote grid's
  validator axis sharded over both ranks (``make_mesh(hr=1)``), every
  device count checked against the host counters, all-gathers the commit
  digest, and runs :func:`grid_steps` through a sharded ``VoteGrid``.

The last line of its output is one JSON object with its results; any
failure raises (nonzero exit), which the parent asserts on. Every rank
must be started: a rank alone waits at the rendezvous.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R, V, CORRUPT = 2, 4, {(0, 2), (1, 0)}
SIM = dict(n=4, target_height=3, seed=311, sign=True, burst=True)
#: The vote-grid sequence: n replicas, V validators, R slots, buckets.
GRID = dict(n_replicas=3, n_validators=4, r_slots=4, buckets=(4, 8))
PALETTE = [b"\xaa" * 32, b"\x11" * 32, bytes(32), bytes(range(0x80, 0xA0))]


def grid_steps(seed: int = 5) -> list:
    """Seeded ``VoteGrid.update_and_tally`` argument tuples (numpy): a
    bucket fit, empty launches, launches past the largest bucket, resets,
    L28 lanes, rows on every validator (global indices)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, v, r = GRID["n_replicas"], GRID["n_validators"], GRID["r_slots"]

    def words(j):
        return np.frombuffer(PALETTE[j], dtype="<i4").astype(np.int32)

    steps = []
    for step, k in enumerate((3, 0, 13, 6, 8, 0, 16)):
        lanes = rng.choice(n * 2 * r * v, size=k, replace=False)
        idx = np.stack(np.unravel_index(lanes, (n, 2, r, v)), axis=1).astype(np.int32)
        vals = np.stack([words(j) for j in rng.integers(0, 4, k)]) if k else \
            np.zeros((0, 8), dtype=np.int32)
        reset = rng.random(n) < (0.4 if step else 0.0)
        targets = np.stack([[words(rng.integers(0, 2)) for _ in range(r)] for _ in range(n)])
        tvalid = rng.random((n, r)) < 0.7
        l28_slot = np.where(rng.random(n) < 0.5, rng.integers(0, r, n), -1).astype(np.int32)
        l28_target = np.stack([words(rng.integers(0, 4)) for _ in range(n)])
        f = np.full(n, 1 + step % 2, dtype=np.int32)
        steps.append((idx, vals, reset, targets, tvalid, l28_slot, l28_target, f))
    return steps


def grid_counts(grid) -> list:
    """Every step's counts of :func:`grid_steps` through ``grid``, as
    lists."""
    return [{k: v.tolist() for k, v in grid.update_and_tally(*a).items()}
            for a in grid_steps()]


def _plain(d: dict) -> dict:
    return {k: v.tolist() for k, v in d.items()}


def steps(rank: int) -> dict:
    import numpy as np
    import torch

    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops.tally import pack_values
    from hyperdrive_tpu_torch.parallel import (
        global_window_from_local,
        grid_pack,
        grid_pack_wire,
        make_hybrid_mesh,
        replicate_to_all_hosts,
        sharded_chalwire_tally,
        sharded_verify_tally,
    )

    world = torch.distributed.get_world_size()
    mesh = make_hybrid_mesh(hr_dcn=2, val_ici=world // 2, device="cpu")
    rh, rv = mesh.get_coordinate()
    r_l = R // 2
    ring = KeyRing.deterministic(V, namespace=b"mesh")
    values = [bytes([r + 1]) * 32 for r in range(R)]
    vote = np.stack([pack_values([values[r]] * V) for r in range(R)])
    target = pack_values(values)
    mine = slice(rh * r_l, (rh + 1) * r_l)  # this rank's hr slab
    (vote_b,) = global_window_from_local(mesh, (vote[mine],))
    (target_b,) = global_window_from_local(mesh, (target[mine],), spec=("hr",))
    f = replicate_to_all_hosts(mesh, np.int32(V // 3 if rank == 0 else -1))
    out = {"rank": rank, "coord": [rh, rv], "f": int(f)}

    shaped, prevalid = grid_pack(ring, R, V, values, corrupt=CORRUPT, device="cpu")
    assert prevalid.all()
    window = global_window_from_local(mesh, tuple(a[mine] for a in shaped))
    counts, flags, ok = sharded_verify_tally(mesh)(*window, vote_b, target_b, f)
    out["packed"] = {"ok": ok.tolist(), "counts": _plain(counts), "flags": _plain(flags)}

    (idx, r_rows, s_rows, m_round), table, prevalid = grid_pack_wire(
        ring, R, V, values, corrupt=CORRUPT, device="cpu")
    assert prevalid.all()
    idx_b, r_b, s_b = global_window_from_local(
        mesh, (idx[mine], r_rows[mine], s_rows[mine]))
    (m_b,) = global_window_from_local(mesh, (m_round[mine],), spec=("hr",))
    counts, flags, ok = sharded_chalwire_tally(mesh)(
        idx_b, r_b, s_b, m_b, *table.arrays_chal(), vote_b, target_b, f)
    out["chal"] = {"ok": ok.tolist(), "counts": _plain(counts), "flags": _plain(flags)}
    return out


def sim(rank: int) -> dict:
    import torch.distributed as dist

    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
    from hyperdrive_tpu_torch.parallel import make_mesh

    mesh = make_mesh(hr=1, device="cpu")  # (1, world): 'val' spans every rank
    views = []

    def check(view, proc):
        views.append(CheckedTallyView(view, proc))
        return views[-1]

    net = Simulation(**SIM, device_tally=True, tally_mesh=mesh, tally_check=check,
                     device="cpu")
    res = net.run(max_steps=200_000)
    assert res.completed, f"rank {rank}: stalled at {res.heights}"
    res.assert_safety()
    consulted = sum(v.hits for v in views)
    assert consulted > 0, f"rank {rank}: sharded counts never consulted"
    from hyperdrive_tpu_torch.ops.votegrid import VoteGrid

    counts = grid_counts(VoteGrid(**GRID, mesh=mesh, device="cpu"))
    digest = res.commit_digest(up_to=SIM["target_height"])
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, digest)
    assert len(set(gathered)) == 1, f"rank {rank}: commit digests differ {gathered}"
    return {"rank": rank, "digest": digest, "steps": res.steps, "consulted": consulted,
            "grid_calls": net.tally_launches, "shards": mesh.shape[1],
            "grid_counts": counts}


def run_rank(steps_url: str, sim_url: str, rank: int, init) -> dict:
    """Rank ``rank``'s part: the world-size-4 steps, then (ranks 0 and 1)
    the world-size-2 network. ``init(url, world, rank)`` joins a group."""
    import torch.distributed as dist

    out = {}
    for mode, url, world in (("steps", steps_url, 4), ("sim", sim_url, 2)):
        if rank >= world:
            break
        init(url, world, rank)
        try:
            out[mode] = {"steps": steps, "sim": sim}[mode](rank)
        finally:
            dist.destroy_process_group()
    return out


def main() -> None:
    steps_url, sim_url, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    import torch

    torch.set_num_threads(1)
    from hyperdrive_tpu_torch.parallel import init_distributed

    def init(url, world, r):
        assert init_distributed(url, world, r, backend="gloo") == world

    print(json.dumps(run_rank(steps_url, sim_url, rank, init)), flush=True)
    # Skip the interpreter's teardown: a gloo thread still joinable in a
    # C++ destructor at exit can abort a finished worker.
    os._exit(0)


if __name__ == "__main__":
    main()
