"""Serving and scaling across tenants and cards.

Port of the JAX package's ``parallel/`` package: the multi-tenant verify
service (:mod:`~hyperdrive_tpu_torch.parallel.service`:
``ShardVerifyService``, ``ServicePort``, ``RemoteServiceClient``,
``TenantShard``), the sharded verify+tally steps over a ("hr", "val")
mesh of ranks (:mod:`~hyperdrive_tpu_torch.parallel.mesh`: ``make_mesh``,
``sharded_verify_tally``, ``sharded_chalwire_tally``,
``make_sharded_step``, ``grid_pack``, ``grid_pack_wire``) and the
multi-node helpers (:mod:`~hyperdrive_tpu_torch.parallel.multihost`:
``init_distributed``, ``make_hybrid_mesh``, ``global_window_from_local``,
``replicate_to_all_hosts``), on ``torch.distributed`` (NCCL on cards,
gloo on the CPU). Names resolve on first touch (PEP 562), so importing the
package imports nothing. The CLI is ``python -m
hyperdrive_tpu_torch.parallel`` (``serve``/``tenant``).
"""

_EXPORTS = {
    "grid_pack": "hyperdrive_tpu_torch.parallel.mesh",
    "grid_pack_wire": "hyperdrive_tpu_torch.parallel.mesh",
    "make_mesh": "hyperdrive_tpu_torch.parallel.mesh",
    "make_sharded_step": "hyperdrive_tpu_torch.parallel.mesh",
    "sharded_chalwire_tally": "hyperdrive_tpu_torch.parallel.mesh",
    "sharded_verify_tally": "hyperdrive_tpu_torch.parallel.mesh",
    "global_window_from_local": "hyperdrive_tpu_torch.parallel.multihost",
    "init_distributed": "hyperdrive_tpu_torch.parallel.multihost",
    "make_hybrid_mesh": "hyperdrive_tpu_torch.parallel.multihost",
    "replicate_to_all_hosts": "hyperdrive_tpu_torch.parallel.multihost",
    "ShardVerifyService": "hyperdrive_tpu_torch.parallel.service",
    "ServicePort": "hyperdrive_tpu_torch.parallel.service",
    "RemoteServiceClient": "hyperdrive_tpu_torch.parallel.service",
    "TenantShard": "hyperdrive_tpu_torch.parallel.service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
