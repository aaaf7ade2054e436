"""Serving and scaling across tenants and cards.

Port of the JAX package's ``parallel/`` package, so far its multi-tenant
verify service (:mod:`~hyperdrive_tpu_torch.parallel.service`):
``ShardVerifyService``, ``ServicePort``, ``RemoteServiceClient`` and
``TenantShard``, resolved on first touch (PEP 562), so importing the
package imports nothing. The mesh and multihost members of the reference
(``grid_pack``, ``make_mesh``, ..., ``replicate_to_all_hosts``) wait for
ROADMAP Queue A item 5 and raise ``NotImplementedError`` that says so; the
``serve``/``tenant`` CLI waits for Queue A item 6.
"""

_EXPORTS = {
    "ShardVerifyService": "hyperdrive_tpu_torch.parallel.service",
    "ServicePort": "hyperdrive_tpu_torch.parallel.service",
    "RemoteServiceClient": "hyperdrive_tpu_torch.parallel.service",
    "TenantShard": "hyperdrive_tpu_torch.parallel.service",
}

#: The reference's mesh and multihost exports, not ported yet.
_LATER = (
    "grid_pack",
    "grid_pack_wire",
    "make_mesh",
    "make_sharded_step",
    "sharded_chalwire_tally",
    "sharded_verify_tally",
    "global_window_from_local",
    "init_distributed",
    "make_hybrid_mesh",
    "replicate_to_all_hosts",
)

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"parallel.{name} is not ported to the PyTorch package yet: "
            "the mesh and multihost members wait for ROADMAP Queue A item 5"
        )
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
