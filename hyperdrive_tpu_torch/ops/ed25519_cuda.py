"""The hand-written Hopper Ed25519 verify kernel: build, binding, wrapper.

Replaces the TPU kernel ``_verify_kernel_body`` / ``_verify_kernel_inner``
of the JAX package (``hyperdrive_tpu/ops/ed25519_pallas.py:373``, shared
ladder ``_ladder_ok`` at ``:402``). The source is ``csrc/ed25519_verify.cu``
with the ladder in ``csrc/ladder.cuh`` and the field in
``csrc/fe25519.cuh``; one thread verifies one signature.

What bounds it on the card: 32-bit integer multiplies. A signature needs
about 2,800 field multiplications or squarings of 20 x 13-bit limbs, about
1.0M multiply-adds with the carry folds, against ~912 bytes of input, so
the byte bound is negligible. At the main path's shapes (256-lane vote
windows, 8 warps) the time is set by each thread's dependent chain and its
per-thread table in local memory, far above the multiply bound. The design
reads each input once, unrolls the field loops so product columns stay in
registers, runs one warp per block so small batches spread over SMs,
stages the constant B table into shared memory, and launches on PyTorch's
current stream without synchronizing. Splitting a signature across
threads, or fewer and wider limbs, is later work.

Build: at first use, ``nvcc`` compiles the sources into a shared library
with a plain C interface under ``hyperdrive_tpu_torch/_build/``, keyed on
a hash of the sources, and ``ctypes`` binds it. A CUDA tensor launches the
kernel or raises; a CPU tensor takes :func:`verify_plain`. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops.ed25519 import K2D_LIMBS, _b_niels_np, verify_plain

__all__ = ["build", "stats", "verify", "KernelStats"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("fe25519.cuh", "ladder.cuh", "ed25519_verify.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: Entries of the constant block, in the layout ``csrc/fe25519.cuh``
#: declares (HD_C_*).
CONSTS_LEN = 80 + 3 * 9 * fe.N_LIMBS


class KernelStats:
    """Launch accounting: ``launches`` grows by one per kernel launch and
    ``lanes`` by the lanes launched; the plain version counts nothing."""

    def __init__(self):
        self.launches = 0
        self.lanes = 0

    def reset(self) -> None:
        self.launches = 0
        self.lanes = 0


stats = KernelStats()


def consts_block() -> np.ndarray:
    """The kernel's constant block, from the same values the plain version
    uses: subtraction bias, 2d, digits of p and 2p, then the [0..8]B niels
    planes (y+x, y-x, 2d*x*y), each [9, 20]."""
    byp, bym, bt2 = _b_niels_np(9)
    block = np.concatenate(
        [fe._SUB_BIAS, K2D_LIMBS, fe.P_LIMBS, fe.P2_LIMBS,
         byp.ravel(), bym.ravel(), bt2.ravel()]
    ).astype(np.int32)
    if block.shape != (CONSTS_LEN,):
        raise AssertionError("constant block layout drifted from fe25519.cuh")
    return block


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built here")


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernel library from the sources in the package (once per
    source hash, or anew with ``force``) and return its path. The
    compiler's register and spill report is kept beside it as
    ``nvcc.log``."""
    out_dir = BUILD_DIR / f"ed25519_{source_hash()}"
    lib = out_dir / "libhd_ed25519.so"
    if lib.exists() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libhd_ed25519.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "ed25519_verify.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


class _Library:
    """The loaded library plus the devices whose constant block is set."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self.lib = ctypes.CDLL(str(path))
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        self.lib.hd_ed25519_set_consts.argtypes = [ci, vp]
        self.lib.hd_ed25519_set_consts.restype = ci
        self.lib.hd_ed25519_verify.argtypes = [ci] + [vp] * 8 + [ci, vp]
        self.lib.hd_ed25519_verify.restype = ctypes.c_int
        self.ready: set = set()
        self._consts = consts_block()

    def upload_consts(self, index: int) -> None:
        if index in self.ready:
            return
        rc = self.lib.hd_ed25519_set_consts(
            index, self._consts.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise RuntimeError(f"constant upload failed: cudaError {rc}")
        self.ready.add(index)


_LIB: "_Library | None" = None
_LIB_LOCK = threading.Lock()


def _library(index: int) -> _Library:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _Library(build())
        _LIB.upload_consts(index)
        return _LIB


def _check(tensors) -> torch.device:
    ax = tensors[0]
    if ax.dim() != 2:
        raise ValueError(f"expected [B, 20] limb rows, got {tuple(ax.shape)}")
    bsz = ax.shape[0]
    for i, t in enumerate(tensors):
        want = (bsz, fe.N_LIMBS) if i < 5 else (bsz, 64)
        if tuple(t.shape) != want:
            raise ValueError(f"input {i}: shape {tuple(t.shape)}, want {want}")
        if t.dtype != torch.int32:
            raise TypeError(f"input {i}: dtype {t.dtype}, want torch.int32")
        if t.device != ax.device:
            raise ValueError(f"input {i} on {t.device}, input 0 on {ax.device}")
        if not t.is_contiguous():
            raise ValueError(f"input {i} is not contiguous")
    return ax.device


def verify(ax, ay, at, rx, ry, s_nib, k_nib) -> torch.Tensor:
    """bool[B]: per lane, [s]B + [k]A' == R on the packer's rows (ax, ay,
    at, rx, ry int32 [B, 20]; s_nib, k_nib int32 [B, 64]). CUDA tensors run
    the kernel on the current stream without synchronizing; CPU tensors run
    :func:`verify_plain`. All-zero lanes reject, as in the reference."""
    tensors = (ax, ay, at, rx, ry, s_nib, k_nib)
    device = _check(tensors)
    if device.type == "cpu":
        return verify_plain(*tensors)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    bsz = ax.shape[0]
    # The kernel writes 0/1 bytes, which is torch.bool's representation.
    out = torch.empty(bsz, dtype=torch.bool, device=device)
    if bsz == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    lib = _library(index)
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = lib.lib.hd_ed25519_verify(
        index, *(t.data_ptr() for t in tensors), out.data_ptr(), bsz, stream
    )
    if rc != 0:
        raise RuntimeError(f"Ed25519 verify kernel launch failed: cudaError {rc}")
    stats.launches += 1
    stats.lanes += bsz
    return out
