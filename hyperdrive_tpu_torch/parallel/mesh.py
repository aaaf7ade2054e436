"""Sharded verification + tally: the multi-device consensus data path.

Port of ``hyperdrive_tpu/parallel/mesh.py`` onto ``torch.distributed``.
Domain decomposition as in the reference:

- **validator axis** (``val``): votes land sharded by sender; each rank
  verifies its block's signatures and tallies them locally, and the
  per-round partial counts combine in one all-reduce over the ``val``
  group.
- **round axis** (``hr``): independent in-flight (height, round) pairs,
  which never communicate.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
dim names ``("hr", "val")`` over the ranks of the default process group,
one process a device (PyTorch's SPMD idiom): the reference's one-process
mesh of eight devices is eight ranks here. Each rank runs the reference's
``shard_map`` body on its own block, with an explicit collective where
the reference has ``lax.psum``. A CUDA mesh runs on NCCL and a CPU mesh on
gloo; :func:`make_mesh` raises on any other pairing and every step raises
on inputs off the mesh's device, so nothing falls back to gloo or the CPU.

Differences from the reference:

- **Blocks in and out.** A step takes this rank's block of the window
  (``[R/hr, V/val, ...]``; ``[R/hr, ...]`` for per-round inputs; the
  validator table and ``f`` whole) and returns this rank's block of the
  reference's outputs (counts and flags ``[R/hr]``, equal on every rank of
  a ``val`` group; the mask ``[R/hr, V/val]``).
  :func:`~hyperdrive_tpu_torch.parallel.multihost.global_window_from_local`
  cuts the block from the rank's ``hr`` slab.
- **One all-reduce** of the stacked int32 (matching, nil, total) counts
  where the reference has three ``psum``.
- **``backend=``** has no choice to make: the reference picks its Pallas
  or XLA ladder per mesh, while here a CUDA block runs the hand-written
  kernels (row 1 ``ed25519_verify``; rows 4 and 3 ``ed25519_challenge`` and
  ``ed25519_semiwire`` for the challenge step) and a CPU block their plain
  versions. ``backend`` accepts only None.
- :func:`grid_pack` and :func:`grid_pack_wire` sign with the native signer
  (the same bytes as the reference's pure-Python oracle) and return
  tensors on ``device`` (the card unless the caller passes the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops import tally as tally_ops
from hyperdrive_tpu_torch.ops.ed25519 import _resolve_device
from hyperdrive_tpu_torch.ops.ed25519_wire import make_challenge_round_fn

__all__ = [
    "make_mesh",
    "mesh_device",
    "sharded_verify_tally",
    "sharded_chalwire_tally",
    "make_sharded_step",
    "grid_pack",
    "grid_pack_wire",
]

AXES = ("hr", "val")
_COUNT_KEYS = ("matching", "nil", "total")


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_backend(device_type: str, group=None) -> None:
    """Raise unless ``group`` (the default group if None) moves tensors
    of ``device_type`` over the backend this package pairs with it (NCCL
    for CUDA, gloo for the CPU)."""
    name = str(dist.get_backend(group))
    if ":" in name:  # "cpu:gloo,cuda:nccl"
        name = dict(p.split(":", 1) for p in name.split(",")).get(device_type, name)
    want = _backend_for(device_type)
    if name != want:
        raise ValueError(f"a {device_type} mesh runs on {want}; the process "
                         f"group's backend is {name}")


def _local_cuda_index(device: torch.device) -> int:
    if device.index is not None:
        return device.index
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))


def make_mesh(hr: int = 1, val: int | None = None, device="cuda"):
    """Build the 2D ("hr", "val") mesh over the ranks of the default
    process group, rank = hr_coordinate * val + val_coordinate.

    ``device``: ``"cuda"`` (the default: this rank's card, NCCL) or
    ``"cpu"`` (gloo). Raises the reference's ``ValueError`` when
    ``hr * val`` is not the world size. With no default process group and
    ``hr * val == 1`` it starts a world-size-1 group over a
    ``dist.HashStore`` (no port, no environment); a larger mesh needs
    :func:`~hyperdrive_tpu_torch.parallel.multihost.init_distributed`
    first."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {dev}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if val is None:
        val = world // hr
    if hr * val != world:
        raise ValueError(f"hr*val must equal the world size ({hr}*{val} != {world})")
    if dev.type == "cuda":
        torch.cuda.set_device(_local_cuda_index(dev))
    if not dist.is_initialized():
        dist.init_process_group(_backend_for(dev.type), store=dist.HashStore(),
                                rank=0, world_size=1)
    check_backend(dev.type)
    return DeviceMesh(dev.type, torch.arange(world).reshape(hr, val),
                      mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, checked for
    the mesh's backend."""
    group = mesh.get_group(axis)
    check_backend(mesh.device_type, group)
    return group


def _check_on(device: torch.device, tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"input on {t.device}; this rank's mesh device is {device}")


def _check_backend_arg(backend) -> None:
    if backend is not None:
        raise ValueError(f"backend={backend!r}: the port's sharded steps run the "
                         "hand-written kernels on a CUDA mesh and their plain "
                         "versions on a CPU mesh; pass None")


def _tally_reduce(ok, vote_vals, target_vals, f, group):
    """Local masked tallies, then ONE all-reduce of the stacked counts
    over the validator axis: the tail every sharded step shares."""
    counts = tally_ops.tally_counts(vote_vals, ok, target_vals)
    stacked = torch.stack([counts[k] for k in _COUNT_KEYS])
    dist.all_reduce(stacked, group=group)
    counts = dict(zip(_COUNT_KEYS, stacked.unbind(0)))
    return counts, tally_ops.quorum_flags(counts, f), ok


def _flat(t: torch.Tensor, r_l: int, v_l: int) -> torch.Tensor:
    return t.reshape((r_l * v_l,) + tuple(t.shape[2:])).contiguous()


def sharded_verify_tally(mesh, backend=None):
    """The verify+tally step over ``mesh``:
    ``step(ax, ay, at, rx, ry, s_nib, k_nib, vote_vals, target_vals, f)``.

    Block shapes (this rank's): ax..ry int32 [R/hr, V/val, 20], nibbles
    int32 [R/hr, V/val, 64], vote_vals int32 [R/hr, V/val, 8], target_vals
    int32 [R/hr, 8]; ``f`` an int (or a tensor on the mesh's device).
    Returns (counts, flags, ok): counts and flags dicts of [R/hr] tensors
    summed over the ``val`` group, the mask bool [R/hr, V/val]. One row-1
    launch a call on a CUDA mesh."""
    _check_backend_arg(backend)
    group = axis_group(mesh, "val")
    device = mesh_device(mesh)

    def step(ax, ay, at, rx, ry, s_nib, k_nib, vote_vals, target_vals, f):
        sig = (ax, ay, at, rx, ry, s_nib, k_nib)
        _check_on(device, (*sig, vote_vals, target_vals))
        r_l, v_l = ax.shape[0], ax.shape[1]
        ok = ed25519_cuda.verify(*(_flat(t, r_l, v_l) for t in sig)).reshape(r_l, v_l)
        return _tally_reduce(ok, vote_vals, target_vals, f, group)

    return step


def sharded_chalwire_tally(mesh, backend=None):
    """The 68 B/lane challenge-on-device step over ``mesh``:
    ``step(idx, r_rows, s_rows, m_round, tnax, tay, tnat, tvalid, trows,
    vote_vals, target_vals, f)``.

    Block shapes (this rank's): idx int32 [R/hr, V/val] (global indices
    into the table), r_rows/s_rows uint8 [R/hr, V/val, 32], m_round uint8
    [R/hr, 32]; the five ``ValidatorTable.arrays_chal()`` tensors whole
    (the table is replicated consensus configuration); vote_vals,
    target_vals and ``f`` as in :func:`sharded_verify_tally`. Each rank
    derives k = SHA-512(R || A || M) mod L for its lanes from the per-round
    digests (:func:`~hyperdrive_tpu_torch.ops.ed25519_wire.challenge_from_round`,
    row 4's grouped form, or its per-lane form past 256 rounds a block),
    keeps k on the device, runs the semiwire ladder
    (row 3) against the table, then the shared one-all-reduce tail.
    Outputs as :func:`sharded_verify_tally`."""
    _check_backend_arg(backend)
    group = axis_group(mesh, "val")
    device = mesh_device(mesh)

    def step(idx, r_rows, s_rows, m_round, tnax, tay, tnat, tvalid, trows,
             vote_vals, target_vals, f):
        _check_on(device, (idx, r_rows, s_rows, m_round, tnax, tay, tnat, tvalid,
                           trows, vote_vals, target_vals))
        r_l, v_l = idx.shape
        flat_idx = _flat(idx, r_l, v_l)
        r_flat = _flat(r_rows, r_l, v_l)
        k_rows = make_challenge_round_fn(v_l)(flat_idx, r_flat, m_round.contiguous(),
                                              trows)
        ok = ed25519_cuda.semiwire_verify(
            flat_idx, r_flat, _flat(s_rows, r_l, v_l), k_rows, tnax, tay, tnat, tvalid,
        ).reshape(r_l, v_l)
        return _tally_reduce(ok, vote_vals, target_vals, f, group)

    return step


def _block(mesh, rounds: int, validators: int):
    """This rank's (round slice, validator slice) of a [rounds, validators]
    window."""
    hr, val = mesh.shape
    if rounds % hr or validators % val:
        raise ValueError(f"a {rounds} x {validators} window does not tile the "
                         f"{hr} x {val} mesh")
    rh, rv = mesh.get_coordinate()
    r_l, v_l = rounds // hr, validators // val
    return slice(rh * r_l, (rh + 1) * r_l), slice(rv * v_l, (rv + 1) * v_l)


def make_sharded_step(mesh):
    """Convenience: ``(step_fn, example_args)`` for benchmarking and the
    multi-device dry run. ``example_args(rounds, validators, rng_seed=0)``
    gives this rank's block of a well-shaped window in the port's limb
    layout (int32 [.., 20] limbs, [.., 64] nibbles): all-zero signatures,
    which verify False, and seeded vote values (the same global values on
    every rank), ``f = validators // 3``."""
    step = sharded_verify_tally(mesh)
    device = mesh_device(mesh)

    def example_args(rounds: int, validators: int, rng_seed: int = 0):
        rs, vs = _block(mesh, rounds, validators)
        rnd = np.random.RandomState(rng_seed)
        vote = rnd.randint(0, 1 << 30, size=(rounds, validators, 8)).astype(np.int32)
        r_l, v_l = rs.stop - rs.start, vs.stop - vs.start

        def z(width):
            return torch.zeros((r_l, v_l, width), dtype=torch.int32, device=device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return (
            *(z(fe.N_LIMBS) for _ in range(5)),
            z(64),
            z(64),
            up(vote[rs, vs]),
            up(vote[rs, 0, :]),
            validators // 3,
        )

    return step, example_args


def _sign_grid(ring, rounds, validators, digest_of, corrupt):
    items = []
    for r in range(rounds):
        digest = digest_of(r)
        for v in range(validators):
            kp = ring[v]
            sig = kp.sign_digest(digest)
            if (r, v) in corrupt:
                sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            items.append((kp.public, digest, sig))
    return items


def grid_pack(ring, rounds: int, validators: int, values, corrupt=(), device=None):
    """Sign one vote per (round, validator) and pack to [R, V, ...] tensors
    on ``device`` ready for :func:`sharded_verify_tally` (after
    ``global_window_from_local``).

    ``values``: one 32-byte proposal value per round (each vote's digest is
    ``values[r] + bytes([r])``). ``corrupt``: (r, v) pairs whose signature
    scalar s gets one bit flipped: the lane still parses (prevalid stays
    True) so rejection exercises the device kernel. Returns
    (shaped_tensors, prevalid bool numpy [R, V])."""
    from hyperdrive_tpu_torch.ops.ed25519 import Ed25519BatchHost

    dev = _resolve_device(device)
    host = Ed25519BatchHost(buckets=(rounds * validators,))
    items = _sign_grid(ring, rounds, validators, lambda r: values[r] + bytes([r]),
                       corrupt)
    arrays, prevalid, n = host.pack(items)
    assert n == rounds * validators
    shaped = tuple(
        torch.from_numpy(a.reshape(rounds, validators, *a.shape[1:])).to(dev)
        for a in arrays
    )
    return shaped, prevalid.reshape(rounds, validators)


def grid_pack_wire(ring, rounds: int, validators: int, values, corrupt=(),
                   device=None):
    """Sign one vote per (round, validator) and marshal to the sharded
    CHALLENGE wire format for :func:`sharded_chalwire_tally`, on
    ``device``.

    ``values``: one 32-byte value per round; the signing digest is the
    32-byte ``bytes([r]) + values[r][1:]`` (distinct per round, shared by
    the round's validators). ``corrupt``: as in :func:`grid_pack`. Returns
    ((idx [R,V] int32, r_rows [R,V,32], s_rows [R,V,32], m_round [R,32]
    uint8), table, prevalid bool numpy [R,V])."""
    from hyperdrive_tpu_torch.ops.ed25519_wire import Ed25519WireHost, ValidatorTable

    table = ValidatorTable([ring[v].public for v in range(validators)], device=device)
    host = Ed25519WireHost(buckets=(rounds * validators,))
    m_round = np.zeros((rounds, 32), dtype=np.uint8)
    for r in range(rounds):
        m_round[r] = np.frombuffer(bytes([r]) + values[r][1:], dtype=np.uint8)
    items = _sign_grid(ring, rounds, validators, lambda r: m_round[r].tobytes(), corrupt)
    (idx, r_rows, s_rows, _), prevalid, n = host.pack_wire_challenge(
        items, table, with_m=False
    )
    assert n == rounds * validators

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(table.device)

    shaped = (
        up(np.asarray(idx, dtype=np.int32).reshape(rounds, validators)),
        up(r_rows.reshape(rounds, validators, 32)),
        up(s_rows.reshape(rounds, validators, 32)),
        up(m_round),
    )
    return shaped, table, prevalid.reshape(rounds, validators)
