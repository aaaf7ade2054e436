"""The port's multi-device programs across real processes: gloo process
groups on the CPU at world sizes 4 and 2 (``tests/torch_multihost_worker.py``,
one process a rank, ``file://`` stores under a temporary directory; this
process is rank 0 and starts ranks 1-3 once for the module, and ranks 0
and 1 go on to the world-size-2 group).

- World size 4 (hr = 2, val = 2, from ``make_hybrid_mesh``): both sharded
  steps; the parent gathers the ranks' blocks into the window and holds
  them to the corrupt pattern's mask and the JAX package's counts and
  flags (``test_torch_mesh.expected_window``), each block's counts summed
  over its ``val`` pair by a real all-reduce.
- World size 2 (hr = 1, val = 2): the signed four-replica network with
  the vote grid's validator axis split across the two processes, every
  device count checked against the host counters; both ranks' commits
  equal the JAX host run's, and a sharded grid's counts over a seeded
  scatter sequence equal the single-device grid's (which
  ``tests/test_torch_mesh.py`` and ``tests/test_torch_votegrid.py`` hold
  to the JAX grid's).
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multihost_worker as worker
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu_torch.ops.votegrid import VoteGrid
from test_torch_mesh import _same, expected_window

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")
TIMEOUT_S = 90


def _init_here(url: str, world: int, rank: int) -> None:
    """This process's rank joins with a bounded wait: a worker that dies
    fails the test instead of hanging it."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=url, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list:
    """Run rank 0 here and ranks 1-3 as workers, once; each rank's result."""
    tmp = tmp_path_factory.mktemp("stores")
    urls = [f"file://{tmp / name}" for name in ("steps", "sim")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, *urls, str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for rank in (1, 2, 3)]
    outs = []
    try:
        mine = worker.run_rank(*urls, 0, _init_here)
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs), start=1):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [mine] + [json.loads(out.strip().splitlines()[-1]) for out in outs]


def test_sharded_steps_across_four_ranks(ranks):
    ok_want, counts_want, flags_want = expected_window()
    results = [r["steps"] for r in ranks]
    assert sorted(tuple(r["coord"]) for r in results) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for step in ("packed", "chal"):
        ok = np.zeros_like(ok_want)
        counts = {k: np.zeros_like(v) for k, v in counts_want.items()}
        flags = {k: np.zeros_like(v) for k, v in flags_want.items()}
        for r in results:
            rh, rv = r["coord"]
            assert r["f"] == worker.V // 3  # rank 0's value, broadcast
            block = np.array(r[step]["ok"])
            assert block.shape == (1, 2)
            ok[rh, 2 * rv: 2 * rv + 2] = block[0]
            for k in counts:  # equal on both ranks of a val pair
                if rv == 0:
                    counts[k][rh] = r[step]["counts"][k][0]
                assert counts[k][rh] == r[step]["counts"][k][0], (step, k)
            for k in flags:
                if rv == 0:
                    flags[k][rh] = r[step]["flags"][k][0]
                assert flags[k][rh] == r[step]["flags"][k][0], (step, k)
        assert np.array_equal(ok, ok_want), step
        _same(counts, counts_want)
        _same(flags, flags_want)


def test_sharded_grid_consensus_across_two_ranks(ranks):
    results = [r["sim"] for r in ranks if "sim" in r]
    assert [r["rank"] for r in results] == [0, 1]
    ref = RefSimulation(**worker.SIM).run(max_steps=200_000)
    want = ref.commit_digest(up_to=worker.SIM["target_height"])
    single = worker.grid_counts(VoteGrid(**worker.GRID, device="cpu"))
    for r in results:
        assert r["shards"] == 2 and r["consulted"] > 0 and r["grid_calls"] > 0
        assert (r["digest"], r["steps"]) == (want, ref.steps)
        for got, expect in zip(r["grid_counts"], single, strict=True):
            _same(got, {k: np.asarray(v) for k, v in expect.items()})
