"""The hand-written Hopper G1 aggregation kernel: build, binding, wrapper.

``g1_aggregate`` (``csrc/g1_aggregate.cu``) replaces the JAX package's jnp
program ``aggregate_kernel`` (``hyperdrive_tpu/ops/g1.py:182``, batched by
``make_batched_aggregate_fn``, ``:246``): the masked sum of a committee's
G1 points, deselected lanes made the identity, then a halving tree of
complete additions. Plain version:
:func:`~hyperdrive_tpu_torch.ops.g1.aggregate_kernel`, the same tree and
formula, so every output coordinate is its field element; the kernel's
limbs are canonical (compare after ``fp381.canonical``). One cluster of
:data:`CLUSTER` blocks a committee, eight threads an addition, GF(p381) on
12 x 32-bit words with R = 2^384; the source's note gives the bound
(multiply instructions) and the design.

Build: at first use, ``nvcc`` compiles ``csrc/g1_aggregate.cu`` on its own
(a unit of its own beside ``csrc/ed25519_kernels.cu``; it shares no
constant block with the ed25519 kernels) into a shared library with a
plain C interface under ``hyperdrive_tpu_torch/_build/``, keyed on a hash
of the source and the flags, and ``ctypes`` binds it. The constants
(:func:`consts_block`, made from ``fp381``'s integers) go to the kernel's
``__constant__`` block once per device. :func:`aggregate` launches on the
current stream without synchronizing, raises on a nonzero
``cudaGetLastError`` and counts the launch in ``stats``; it takes CUDA
tensors only (:func:`~hyperdrive_tpu_torch.ops.g1.g1_aggregate` sends CPU
tensors to the plain version).

Widths: a committee's N/2 first-level sums live in its cluster's shared
memory (144 bytes a sum, 1,614 a block at 227 KB), so up to
:data:`MAX_SHARED_WIDTH` lanes; a wider committee keeps them in a global
scratch this wrapper allocates (``hd_g1_scratch_words``), same tree, same
single launch. One launch takes any N >= 1.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from hyperdrive_tpu_torch.ops import fp381 as fp
from hyperdrive_tpu_torch.ops.ed25519_cuda import KernelStats, _check_like, build_library

__all__ = ["build", "stats", "reset_stats", "check_aggregate", "aggregate",
           "consts_block", "scratch_words", "CLUSTER", "W32_WORDS",
           "MAX_SHARED_WIDTH"]

SOURCE = "g1_aggregate.cu"
#: 32-bit words of the kernel's field element (R = 2^384).
W32_WORDS = 12
#: Blocks of a committee's cluster (``G1_CLUSTER`` in the source).
CLUSTER = 8
#: The widest committee whose first-level sums fit in the cluster's
#: shared memory on an H100 (232,448 bytes a block, 144 a sum).
MAX_SHARED_WIDTH = 2 * CLUSTER * (232_448 // (3 * W32_WORDS * 4)) + 1

#: One count per kernel, keyed by kernel name.
stats = {"g1_aggregate": KernelStats()}


def reset_stats() -> None:
    for st in stats.values():
        st.reset()


def _words(x: int, n: int = W32_WORDS) -> list:
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(n)]


def consts_block() -> np.ndarray:
    """The kernel's constant block (``G1C_*`` in the source), 61 words as
    int32 bit patterns: p in 12 little-endian 32-bit words; n0' = -p^-1
    mod 2^32; 2^384 mod p (1 in the kernel's domain, and the fold of a
    carry out of bit 384); p minus that (the fold of a negative top);
    2^378 mod p (entry: times 2^-6, from R = 2^390 to R = 2^384); 2^390
    mod p (exit)."""
    p = fp.P_INT
    one = (1 << 384) % p
    words = (_words(p) + [(-pow(p, -1, 1 << 32)) % (1 << 32)] + _words(one)
             + _words(p - one) + _words((1 << 378) % p) + _words((1 << 390) % p))
    return np.array(words, dtype=np.uint32).view(np.int32)


def build(force: bool = False):
    """Compile the kernel library from the source in the package and
    return its path (``ed25519_cuda.build_library``)."""
    return build_library("g1", SOURCE, (SOURCE,), force)


_LIB = None
_READY: set = set()
_LOCK = threading.Lock()


def _library(index: int):
    """The bound library, with the constant block set on device
    ``index`` (a synchronous copy, once per device)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.hd_g1_set_consts.argtypes = [ci, vp]
            lib.hd_g1_set_consts.restype = ci
            lib.hd_g1_scratch_words.argtypes = [ci, ci]
            lib.hd_g1_scratch_words.restype = ctypes.c_longlong
            lib.hd_g1_aggregate.argtypes = [ci] + [vp] * 4 + [ci, ci] + [vp] * 5
            lib.hd_g1_aggregate.restype = ci
            _LIB = lib
        if index not in _READY:
            block = np.ascontiguousarray(consts_block())
            rc = _LIB.hd_g1_set_consts(index, block.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"g1_aggregate constant upload failed: cudaError {rc}")
            _READY.add(index)
        return _LIB


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


_WORDS: dict = {}


def scratch_words(n: int, device=None) -> int:
    """32-bit words of global scratch one committee of ``n`` lanes needs
    on ``device`` (None: the current card): 0 when its first-level sums
    fit in the cluster's shared memory. Asked of the library once per
    device and width."""
    return _scratch_words(_index(torch.device("cuda" if device is None else device)), int(n))


def _scratch_words(index: int, n: int) -> int:
    words = _WORDS.get((index, n))
    if words is None:
        words = int(_library(index).hd_g1_scratch_words(index, n))
        if words < 0:
            raise RuntimeError("g1_aggregate: cannot query the device's shared memory")
        _WORDS[(index, n)] = words
    return words


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
    :func:`check_aggregate`: ``[B, 1, 30]`` x3, canonical limbs, each
    coordinate the plain version's field element."""
    device = px.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    bsz, n, _ = px.shape
    outs = torch.empty((3, bsz, 1, fp.N_LIMBS), dtype=torch.int32, device=device).unbind(0)
    if bsz == 0:
        return outs
    index = _index(device)
    lib = _library(index)
    words = _scratch_words(index, n)
    scratch = torch.empty(bsz * words, dtype=torch.int32, device=device) if words else None
    rc = lib.hd_g1_aggregate(
        index, px.data_ptr(), py.data_ptr(), pz.data_ptr(), mask.data_ptr(),
        bsz, n, None if scratch is None else scratch.data_ptr(),
        *(o.data_ptr() for o in outs), torch.cuda.current_stream(index).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"g1_aggregate kernel launch failed: cudaError {rc}")
    stats["g1_aggregate"].add(bsz * n)
    return outs
