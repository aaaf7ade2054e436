"""The entry points: the single-card step and the multi-device dry run.

- :func:`entry` returns the flagship step, batched Ed25519 vote
  verification on the WIRE path (raw 32-byte encodings in, both points
  decompressed and the signature checked in row 2's kernel,
  ``csrc/ed25519_wire.cu`` ``hd_ed25519_wire_kernel``) fused with the
  quorum tallies (``ops/tally.py``), plus example args at rounds 2 x
  validators 32.
- :func:`dryrun_multichip` runs the sharded programs of
  :mod:`~hyperdrive_tpu_torch.parallel.mesh` over a ("hr", "val") mesh of
  ``n`` ranks on real signed votes and checks every count: the sharded
  verify + tally step with the round-1 quorum break, the challenge-wire
  step on the same votes, the sharded vote grid across two launches, and a
  signed burst network whose quorum counts come from the sharded grid
  (``Simulation(tally_mesh=)``) under ``CheckedTallyView``, equal to a
  host run.

Port of the repository root's ``__graft_entry__.py``. Both functions run
on the card unless the caller passes ``device="cpu"``; without CUDA they
raise. Deliberate differences:

- One process drives one device (the port's multi-device convention):
  ``dryrun_multichip(n)`` runs as the caller's rank of a default process
  group of ``n`` ranks (NCCL on cards, gloo on the CPU, joined as
  :func:`~hyperdrive_tpu_torch.parallel.multihost.init_distributed` does);
  with no group and ``n == 1`` the mesh starts a world-size-1 group. Rank 0
  prints the summary line. The reference configures ``n`` virtual JAX
  devices in one process.
- The dry run's two networks verify their signatures with the
  ``TorchBatchVerifier`` on the card and, on the CPU, with the host
  verifier (the sharded steps still run the kernels' plain versions there).
  Its host run is the reference's: host verifier, host tallies.
- :func:`signed_example_args` also gives the step real signed votes, with
  corrupted lanes, beside the all-zero example args.
"""

from __future__ import annotations

import numpy as np
import torch

from hyperdrive_tpu_torch.ops.merkle import resolve_device

__all__ = ["entry", "signed_example_args", "dryrun_multichip", "SIGNED_CORRUPT"]

ROUNDS, VALIDATORS = 2, 32


def entry(device=None):
    """``(fn, example_args)``: the single-card verify + tally step on the
    wire path. ``fn(a_rows, r_rows, s_rows, k_rows, vote_vals,
    target_vals, f)`` returns ``(ok, counts, flags)``: the verdict mask
    bool [64] (one row-2 launch on a CUDA tensor, the plain version on a
    CPU one) and the per-round count and quorum-flag dicts of [2]
    tensors. The example args are all zeros on ``device`` (the card unless
    the caller passes ``"cpu"``)."""
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.tally import quorum_flags, tally_counts

    dev = resolve_device(device)
    rounds, validators = ROUNDS, VALIDATORS
    batch = rounds * validators

    def step(a_rows, r_rows, s_rows, k_rows, vote_vals, target_vals, f):
        ok = ed25519_cuda.wire_verify(a_rows, r_rows, s_rows, k_rows)
        counts = tally_counts(vote_vals, ok.reshape(rounds, validators), target_vals)
        return ok, counts, quorum_flags(counts, f)

    def zb(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=dev)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    example_args = (zb(batch, 32), zb(batch, 32), zb(batch, 32), zb(batch, 32),
                    z(rounds, validators, 8), z(rounds, 8), validators // 3)
    return step, example_args


#: Round r's value is ``bytes([SIGNED_SEED + r]) * 32``.
SIGNED_SEED = 7

#: The signed window's corrupted lanes: one in round 0 (31 of 32 stay, at
#: quorum 21) and twelve in round 1 (20 stay, below quorum).
SIGNED_CORRUPT = frozenset({(0, 31)} | {(1, v) for v in range(12)})


def signed_example_args(device=None):
    """The step's args over real votes: every validator of a deterministic
    ring signs its round's value; the lanes in :data:`SIGNED_CORRUPT` get
    one bit of s flipped, so they still parse and the kernel must reject
    them. Returns ``(args, items)``,
    ``items`` the (pub, digest, sig) triples in lane order."""
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops.ed25519_wire import Ed25519WireHost
    from hyperdrive_tpu_torch.ops.tally import pack_values

    dev = resolve_device(device)
    rounds, validators = ROUNDS, VALIDATORS
    ring = KeyRing.deterministic(validators, namespace=b"entry")
    values = [bytes([SIGNED_SEED + r]) * 32 for r in range(rounds)]
    items = []
    for r in range(rounds):
        for v in range(validators):
            sig = ring[v].sign_digest(values[r])
            if (r, v) in SIGNED_CORRUPT:
                sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            items.append((ring[v].public, values[r], sig))
    rows, prevalid, n = Ed25519WireHost(buckets=(rounds * validators,)).pack_wire(items)
    if n != rounds * validators or not prevalid.all():
        raise RuntimeError("entry: the signed window must pack whole")
    vote = np.stack([np.tile(pack_values([values[r]])[0], (validators, 1))
                     for r in range(rounds)])

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (*(up(a) for a in rows), up(vote), up(pack_values(values)), validators // 3)
    return args, items


def _check(cond, msg):
    """The dry run's checks must hold under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"dryrun_multichip FAILED: {msg}")


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run the sharded verify/tally programs on an ``n_devices``-rank mesh
    over real signed votes and check that the all-reduced counts and the
    quorum flags are exactly right, so a pass certifies the sharded logic,
    not only that it runs. Raises ``RuntimeError`` on any wrong count,
    flag or verdict. Returns the summary line (rank 0 also prints it)."""
    import torch.distributed as dist

    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops.tally import pack_values
    from hyperdrive_tpu_torch.parallel import (
        global_window_from_local,
        grid_pack,
        grid_pack_wire,
        make_mesh,
        sharded_chalwire_tally,
        sharded_verify_tally,
    )
    from hyperdrive_tpu_torch.parallel.mesh import _block

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(
            f"need {n_devices} ranks, the default process group has {world} "
            "(join it with parallel.multihost.init_distributed first)"
        )
    hr = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(hr=hr, device=dev.type)
    step = sharded_verify_tally(mesh)

    val = n_devices // hr
    rounds, validators = hr * 2, val * 2
    f = validators // 3
    quorum = 2 * f + 1

    # Real Ed25519 votes: every validator signs every round's value. Round
    # 0 loses one signature (stays at quorum); round 1 loses enough to drop
    # below quorum, so the flags must split.
    ring = KeyRing.deterministic(validators, namespace=b"dryrun")
    values = [bytes([r + 1]) * 32 for r in range(rounds)]
    corrupt = {(0, validators - 1)}
    below = validators - quorum + 1
    corrupt |= {(1, v) for v in range(below)}
    shaped, prevalid = grid_pack(ring, rounds, validators, values, corrupt=corrupt,
                                 device="cpu")
    _check(bool(prevalid.all()), "corruption must break verification, not parsing")

    vote = np.stack([np.tile(pack_values([values[r]])[0], (validators, 1))
                     for r in range(rounds)])
    target = pack_values(values)
    rs, vs = _block(mesh, rounds, validators)
    blocks = global_window_from_local(mesh, [t[rs] for t in shaped] + [vote[rs]])
    (target_blk,) = global_window_from_local(mesh, [target[rs]], ("hr",))
    counts, flags, ok = step(*blocks, target_blk, f)

    ok_np = ok.cpu().numpy()
    for r in range(rs.start, rs.stop):
        for v in range(vs.start, vs.stop):
            want = (r, v) not in corrupt
            _check(bool(ok_np[r - rs.start, v - vs.start]) == want,
                   f"verify mask wrong at {(r, v)}")
    matching = counts["matching"].cpu().numpy()
    q_match = flags["quorum_matching"].cpu().numpy()
    for r in range(rs.start, rs.stop):
        expect = validators - sum(1 for (rr, _) in corrupt if rr == r)
        got = int(matching[r - rs.start])
        _check(got == expect, f"round {r}: all-reduced count {got} != {expect}")
        _check(bool(q_match[r - rs.start]) == (expect >= quorum),
               f"round {r}: quorum flag wrong")
    if rs.start <= 1 < rs.stop:
        _check(not bool(q_match[1 - rs.start]), "round 1 must be below quorum")

    # The challenge-wire leg: the SAME votes in the 68 B/lane format, the
    # challenge k = SHA-512(R || A || M) mod L derived on each rank (row 4),
    # the table replicated, the semiwire ladder (row 3), one all-reduce.
    (widx, wr, ws, wm), wtable, wprevalid = grid_pack_wire(
        ring, rounds, validators, values, corrupt=corrupt, device=dev)
    _check(bool(wprevalid.all()), "wire corruption must parse, not fail pack")
    chal_step = sharded_chalwire_tally(mesh)
    wblocks = global_window_from_local(mesh, [widx[rs], wr[rs], ws[rs]])
    (wm_blk,) = global_window_from_local(mesh, [wm[rs]], ("hr",))
    (vote_blk,) = global_window_from_local(mesh, [vote[rs]])
    wcounts, wflags, wok = chal_step(*wblocks, wm_blk, *wtable.arrays_chal(),
                                     vote_blk, target_blk, f)
    _check(torch.equal(wok.cpu(), ok.cpu()), "chal-wire verify mask differs from "
           "the packed path")
    _check(torch.equal(wcounts["matching"].cpu(), counts["matching"].cpu()),
           "chal-wire all-reduced counts differ from the packed path")
    if rs.start <= 1 < rs.stop:
        _check(not bool(wflags["quorum_matching"][1 - rs.start]),
               "chal-wire round 1 must be below quorum")

    # The persistent vote grid sharded over the whole mesh (validator lanes
    # split across all ranks, counts all-reduced): replica 0's round-0
    # prevotes in two launches must sum to the windowed step's count.
    from hyperdrive_tpu_torch.ops.votegrid import PREVOTE_PLANE, VoteGrid

    gmesh = make_mesh(hr=1, device=dev.type)
    grid = VoteGrid(2, validators, r_slots=2, buckets=(64,), mesh=gmesh)
    accepted = [v for v in range(validators) if (0, v) not in corrupt]
    rows = [(0, PREVOTE_PLANE, 0, v) for v in accepted]
    w = np.tile(pack_values([values[0]])[0], (len(rows), 1))
    targets = np.zeros((2, 2, 8), dtype=np.int32)
    targets[0, 0] = pack_values([values[0]])[0]
    tvalid = np.zeros((2, 2), dtype=bool)
    tvalid[0, 0] = True
    common = dict(
        reset=np.zeros(2, dtype=bool), targets=targets, target_valid=tvalid,
        l28_slot=np.full(2, -1, dtype=np.int32),
        l28_target=np.zeros((2, 8), dtype=np.int32),
        f=np.full(2, f, dtype=np.int32),
    )
    split = len(rows) // 2
    grid.update_and_tally(np.array(rows[:split], dtype=np.int32), w[:split], **common)
    gcounts = grid.update_and_tally(np.array(rows[split:], dtype=np.int32), w[split:],
                                    **common)
    got = int(gcounts["matching"][0, PREVOTE_PLANE, 0])
    want0 = validators - sum(1 for (rr, _) in corrupt if rr == 0)
    _check(got == want0, f"sharded vote grid count {got} != windowed count {want0}")
    _check(bool(gcounts["quorum_matching"][0, PREVOTE_PLANE, 0]),
           "vote grid quorum flag must be set for round 0")

    # Sharded consensus end to end: a signed burst network whose settle
    # counts come from the mesh-sharded grid, every device count checked
    # against the host counters, the commits equal to a host run.
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView
    from hyperdrive_tpu_torch.verifier import HostVerifier

    height = 3
    views = []

    def _checked(view, proc):
        v = CheckedTallyView(view, proc)
        views.append(v)
        return v

    kw = dict(n=n_devices, target_height=height, seed=1777, sign=True, burst=True)
    card = {} if dev.type == "cuda" else {"batch_verifier": HostVerifier()}
    sharded_run = Simulation(**kw, **card, device=dev, device_tally=True,
                             tally_mesh=gmesh, tally_check=_checked).run(max_steps=200_000)
    _check(sharded_run.completed, f"sharded consensus stalled at {sharded_run.heights}")
    sharded_run.assert_safety()
    consulted = sum(v.hits for v in views)
    _check(consulted > 0, "sharded counts were never consulted")
    host_run = Simulation(**kw, batch_verifier=HostVerifier()).run(max_steps=200_000)
    _check(sharded_run.commits == host_run.commits,
           "sharded consensus diverged from the host run")

    line = (
        f"dryrun_multichip ok: mesh=({hr}x{val}) axes=('hr','val') on "
        f"{dev.type}, {rounds * validators} real signatures verified, chal-wire "
        f"leg mask-identical to the packed path, all-reduced tallies exact, "
        f"quorum split correct (round0={validators - 1}>={quorum}, "
        f"round1={validators - below}<{quorum}); sharded vote grid over "
        f"{n_devices} ranks accumulated {got} verified prevotes across 2 "
        f"launches; sharded consensus committed {height} heights ({consulted} "
        f"device counts consulted, all host-equal, commits identical to the "
        f"host-tally run)"
    )
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line)
    return line

