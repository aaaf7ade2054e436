"""The hand-written Hopper G1 aggregation kernel: build, binding, wrapper.

``g1_aggregate`` (``csrc/g1_aggregate.cu``) replaces the JAX package's jnp
program ``aggregate_kernel`` (``hyperdrive_tpu/ops/g1.py:182``, batched by
``make_batched_aggregate_fn``, ``:246``): the masked sum of a committee's
G1 points, deselected lanes made the identity, then a halving tree of
complete additions. Plain version:
:func:`~hyperdrive_tpu_torch.ops.g1.aggregate_kernel`, limb for limb. One
block a committee; the source's note gives the bound (multiply
instructions) and the design.

Build: at first use, ``nvcc`` compiles ``csrc/g1_aggregate.cu`` on its own
(a unit of its own beside ``csrc/ed25519_kernels.cu``; it shares no
constant block with the ed25519 kernels) into a shared library with a
plain C interface under ``hyperdrive_tpu_torch/_build/``, keyed on a hash
of the source and the flags, and ``ctypes`` binds it. The modulus, R mod p
and n0' reach the kernel as a 61-word int32 tensor, made once per device
from the same integers as the plain version's. :func:`aggregate` launches
on the current stream without synchronizing, raises on a nonzero
``cudaGetLastError`` and counts the launch in ``stats``; it takes CUDA
tensors only (:func:`~hyperdrive_tpu_torch.ops.g1.g1_aggregate` sends CPU
tensors to the plain version).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from hyperdrive_tpu_torch.ops import fp381 as fp
from hyperdrive_tpu_torch.ops.ed25519_cuda import KernelStats, _check_like, build_library

__all__ = ["build", "stats", "reset_stats", "check_aggregate", "aggregate",
           "consts_block"]

SOURCE = "g1_aggregate.cu"

#: One count per kernel, keyed by kernel name.
stats = {"g1_aggregate": KernelStats()}


def reset_stats() -> None:
    for st in stats.values():
        st.reset()


def consts_block() -> np.ndarray:
    """The kernel's constants (``G1Consts`` in the source): p and R mod p
    as 30 13-bit limbs each, then n0' = -p^-1 mod 2^13."""
    return np.concatenate(
        [fp.to_limbs(fp.P_INT), fp.ONE, [fp.MONT.n0p]]
    ).astype(np.int32)


def build(force: bool = False):
    """Compile the kernel library from the source in the package and
    return its path (``ed25519_cuda.build_library``)."""
    return build_library("g1", SOURCE, (SOURCE,), force)


_LIB = None
_CONSTS: dict = {}
_LOCK = threading.Lock()


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.hd_g1_aggregate.argtypes = [ci] + [vp] * 5 + [ci, ci] + [vp] * 5
            lib.hd_g1_aggregate.restype = ci
            _LIB = lib
        return _LIB


def _consts(device: torch.device) -> torch.Tensor:
    with _LOCK:
        t = _CONSTS.get(device)
        if t is None:
            t = torch.from_numpy(consts_block()).to(device)
            # Made once, read by launches on any stream: let the copy land.
            torch.cuda.current_stream(device).synchronize()
            _CONSTS[device] = t
        return t


def check_aggregate(px, py, pz, mask) -> torch.device:
    """Checks ``[B, N, 30]`` int32 coordinates and an int32 ``[B, N]``
    mask, contiguous on one device, N >= 1; returns the device."""
    if px.dim() != 3 or px.shape[-1] != fp.N_LIMBS or px.shape[1] < 1:
        raise ValueError(f"expected [B, N, 30] limbs with N >= 1, got {tuple(px.shape)}")
    shape = tuple(px.shape)
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _check_like(name, t, shape, torch.int32, px.device)
    _check_like("mask", mask, shape[:2], torch.int32, px.device)
    return px.device


def aggregate(px, py, pz, mask):
    """Launch ``g1_aggregate`` on CUDA tensors checked by
    :func:`check_aggregate`: ``[B, 1, 30]`` x3, limb for limb the plain
    version's."""
    device = px.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    bsz, n, _ = px.shape
    outs = [torch.empty((bsz, 1, fp.N_LIMBS), dtype=torch.int32, device=device)
            for _ in range(3)]
    if bsz == 0:
        return tuple(outs)
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        consts = _consts(torch.device("cuda", index))
        scratch = torch.empty((bsz, 3, n, fp.N_LIMBS), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(index).cuda_stream
        rc = _library().hd_g1_aggregate(
            index, px.data_ptr(), py.data_ptr(), pz.data_ptr(), mask.data_ptr(),
            consts.data_ptr(), bsz, n, scratch.data_ptr(),
            *(o.data_ptr() for o in outs), stream,
        )
    if rc != 0:
        raise RuntimeError(f"g1_aggregate kernel launch failed: cudaError {rc}")
    stats["g1_aggregate"].add(bsz * n)
    return tuple(outs)
