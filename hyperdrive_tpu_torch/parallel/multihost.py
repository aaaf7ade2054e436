"""Multi-node scale-out: hybrid meshes and window distribution on
``torch.distributed``.

Port of ``hyperdrive_tpu/parallel/multihost.py``. The reference's
network is the embedding application's (the Broadcaster seam); this
module is the bulk data path's counterpart: when the validator set
outgrows one card, votes are tensors, and tensor exchange belongs on the
device fabric, not the host NICs.

Axis placement follows the bandwidth hierarchy, as in the reference:

- ``val`` carries the quorum all-reduce (``mesh._tally_reduce``), so it
  stays inside one node (NVLink); it is the inner mesh axis.
- ``hr``: in-flight (height, round) pairs never communicate, so the only
  traffic between nodes is input and output distribution; it is the
  outer axis.

One process a device: nodes take the place of the reference's host
processes, and a rank's local world (its node's ranks) the place of the
devices attached to one process. Ranks are taken to be node-major (rank =
node * local_world_size + local_rank), as ``torchrun`` numbers them. A
single node builds the same topology, so every consumer is
topology-agnostic: axis names, not device counts, are the contract.
``ShardVerifyService`` is re-exported, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from hyperdrive_tpu_torch.parallel.mesh import AXES, make_mesh, mesh_device
from hyperdrive_tpu_torch.parallel.service import ShardVerifyService

__all__ = [
    "init_distributed",
    "make_hybrid_mesh",
    "global_window_from_local",
    "replicate_to_all_hosts",
    "ShardVerifyService",
]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    auto: bool = False,
    backend: str | None = None,
) -> int:
    """Join (or skip joining) the default process group.

    Each process calls this once, before :func:`make_hybrid_mesh`, with
    the rendezvous address (``host:port`` for a TCP store, or a full init
    URL such as ``file:///path``), the world size and its rank; or with
    ``auto=True`` to read the ``torchrun`` environment (``env://``). With
    neither it returns 1 and touches nothing. ``backend``: ``"nccl"``
    (the default, for ranks on cards) or ``"gloo"`` (CPU ranks).

    Returns the world size after initialization (1 on the no-op path)."""
    if coordinator_address is None and not auto:
        return 1
    backend = backend or "nccl"
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _local_world_size() -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE`` when ``torchrun`` set it,
    else the ranks whose host name is this one's (one gather)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    world = _world_size()
    if world == 1:
        return 1
    import socket

    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return names.count(socket.gethostname())


def _node_count() -> int:
    return max(_world_size() // _local_world_size(), 1)


def make_hybrid_mesh(hr_dcn: int | None = None, val_ici: int | None = None,
                     device="cuda"):
    """Build the 2D ("hr", "val") mesh with node-aware rank placement.

    ``hr_dcn``: size of the ``hr`` axis (defaults to the node count, so
    each node owns a disjoint set of in-flight rounds). ``val_ici``: size
    of the ``val`` axis (defaults to world size // ``hr_dcn``, the local
    world size by default, keeping every quorum all-reduce inside one
    node). ``device`` as in :func:`~hyperdrive_tpu_torch.parallel.mesh.make_mesh`.

    Across nodes, ``hr_dcn`` must be a multiple of the node count and the
    per-node tile must match the node's ranks; both are checked before the
    mesh is built, with the reference's reasons."""
    world = _world_size()
    n_nodes = _node_count()
    if hr_dcn is None:
        hr_dcn = n_nodes
    if val_ici is None:
        val_ici = world // hr_dcn
    if hr_dcn * val_ici != world:
        raise ValueError(
            f"hr_dcn*val_ici must equal the world size ({hr_dcn}*{val_ici} != {world})"
        )
    if n_nodes > 1:
        # The nodes tile the 'hr' axis, so 'val' all-reduces never leave
        # a node.
        if hr_dcn % n_nodes != 0:
            raise ValueError(
                f"hr_dcn ({hr_dcn}) must be a multiple of the node count "
                f"({n_nodes}) so the 'val' axis — which carries the quorum "
                f"all-reduce — stays inside one node"
            )
        per_node_hr = hr_dcn // n_nodes
        # Check against the ranks ACTUALLY on this node, not the global
        # average: on a misconfigured launch the average can look right
        # while the local tile cannot be held.
        local = _local_world_size()
        if per_node_hr * val_ici != local:
            raise ValueError(
                f"per-node mesh {per_node_hr}x{val_ici} does not match the "
                f"{local} ranks attached to this node"
            )
    return make_mesh(hr=hr_dcn, val=val_ici, device=device)


def _spec(spec) -> tuple:
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def global_window_from_local(mesh, local_arrays, spec=AXES):
    """This rank's blocks of a window, from its ``hr`` slab.

    Each rank packs only the votes of its rounds (its ``[R/hr, V, ...]``
    slab of the global ``[R, V, ...]`` window: host packing parallelizes
    across ranks) and passes the slab here; it gets back its own block of
    each array on its device, cut along every dim that ``spec`` names
    ``"val"`` (``None`` or ``"hr"`` keep the dim whole: the slab is
    already the rank's rounds). At world size 1 the slab is the whole
    window and the block is all of it. No data moves between ranks.

    ``spec``: one axis name or None per leading dim (the reference's
    ``PartitionSpec`` as a tuple): ``("hr", "val")`` for [R, V, ...]
    arrays, ``("hr",)`` for per-round ones, ``()`` for replicated ones.
    Takes numpy arrays and tensors alike."""
    spec = _spec(spec)
    device = mesh_device(mesh)
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    sizes = dict(zip(names, mesh.shape))
    out = []
    for a in local_arrays:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        for dim, axis in enumerate(spec):
            if axis not in (None, "hr"):
                d = sizes[axis]
                if t.shape[dim] % d:
                    raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                                     f"divide over the {d} ranks of '{axis}'")
                w = t.shape[dim] // d
                t = t.narrow(dim, coord[axis] * w, w)
        out.append(t.to(device).contiguous())
    return tuple(out)


def replicate_to_all_hosts(mesh, value):
    """A small host value (the target proposal values, ``f``) as a tensor
    on every rank's device: rank 0's bytes, broadcast over the mesh.

    A real broadcast at every world size: replication from each rank's
    own copy would silently keep divergent inputs if the ranks ever
    disagreed, and "every host already agrees" is exactly what a consensus
    framework must not assume about its own inputs. Every rank must pass a
    value of the same shape and dtype."""
    t = torch.from_numpy(np.array(value)).to(mesh_device(mesh))
    dist.broadcast(t, src=0)
    return t
