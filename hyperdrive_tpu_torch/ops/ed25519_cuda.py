"""The hand-written Hopper Ed25519 verify kernels: build, binding, wrappers.

Three kernels, one per TPU kernel of the JAX package
(``hyperdrive_tpu/ops/ed25519_pallas.py``):

- ``ed25519_verify`` (``csrc/ed25519_verify.cu``) replaces
  ``_verify_kernel_body`` / ``_verify_kernel_inner`` (``:373/:380``):
  packed, host-decompressed limbs. Plain version
  :func:`~hyperdrive_tpu_torch.ops.ed25519.verify_plain`. One thread a
  signature, on the ladder of ``csrc/ladder.cuh`` and the TPU's field of
  ``csrc/fe25519.cuh`` (20 x 13-bit limbs), its [0..8]A' table a
  per-thread array in local memory.
- ``ed25519_wire`` (``csrc/ed25519_wire.cu``) replaces
  ``_wire_kernel_body`` / ``_wire_kernel_inner`` (``:486/:493``): raw
  [B, 32] uint8 A, R, s, k rows, both points decompressed in the kernel
  (``csrc/decompress.cuh``), A on threads 0 and 2 of a group while R runs
  on threads 1 and 3. Plain version
  :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.wire_verify_plain`.
- ``ed25519_semiwire`` (``csrc/ed25519_wire.cu``) replaces
  ``_semiwire_kernel_body`` / ``_semiwire_kernel_inner`` (``:522/:529``):
  -A read from the resident validator table by index (its 13-bit limbs
  converted by value), R decompressed in the kernel. Plain version
  :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.semiwire_verify_plain`.

The two wire kernels run on the field of ``csrc/fe25519_w32.cuh`` (8 x
32-bit limbs in full radix on PTX carry chains: 146 multiply instructions
a product against 423 for 20 x 13-bit limbs) and the ladder of
``csrc/ladder4.cuh``: four threads a signature, thread j owning coordinate
j of (X, Y, Z, T), each point formula two rounds of four products
exchanged by warp shuffles; the [0..8]A' table, the B table and the
signed digits in shared memory, field elements in registers. A block is
one warp, 8 signatures.

What bounds them on the card: 32-bit multiply instructions; bytes in are
at most ~912 a lane, negligible. At the main path's shape (one 256-lane
vote window) every kernel is latency-bound, far above that bound: the
time is the dependent chain of one signature. Times, bounds and launches
on the card are in ``PERF.md`` (``chip_smoke.py``, NVIDIA H100 80GB HBM3,
700.00 W).

Build: at first use, ``nvcc`` compiles ``csrc/ed25519_kernels.cu`` (the
one translation unit that includes every kernel, so each constant block
has one copy per device and one upload) into a shared library with a
plain C interface under ``hyperdrive_tpu_torch/_build/``, keyed on a hash
of all the sources, and ``ctypes`` binds it. The constant blocks are
:func:`consts_block` (20 x 13-bit limbs) and :func:`consts_block_w32` (8 x
32-bit limbs), built from the same integers. A CUDA tensor launches the
kernel or raises, with the launch's ``cudaGetLastError`` checked; a CPU
tensor takes the plain version. There is no fallback from one to the
other.
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

from hyperdrive_tpu_torch.ops import ed25519_wire as wire
from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops.ed25519 import K2D_LIMBS, _b_niels_np, verify_plain

__all__ = [
    "build",
    "stats",
    "reset_stats",
    "verify",
    "wire_verify",
    "semiwire_verify",
    "KernelStats",
]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (
    "fe25519.cuh", "ladder.cuh", "fe25519_w32.cuh", "ladder4.cuh",
    "decompress.cuh", "ed25519_verify.cu", "ed25519_wire.cu",
    "ed25519_kernels.cu",
)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: Entries of the constant block, in the layout ``csrc/fe25519.cuh``
#: declares (HD_C_*).
CONSTS_LEN = 80 + 3 * 9 * fe.N_LIMBS + 2 * fe.N_LIMBS
#: Limbs of the 8 x 32-bit field (``csrc/fe25519_w32.cuh``).
W32_LIMBS = 8
#: Entries of the second constant block, in the layout
#: ``csrc/fe25519_w32.cuh`` declares (HD_W_*).
CONSTS_W32_LEN = 4 * W32_LIMBS + 3 * 9 * W32_LIMBS


class KernelStats:
    """Launch accounting: ``launches`` grows by one per kernel launch and
    ``lanes`` by the lanes launched; the plain version counts nothing."""

    def __init__(self):
        self.launches = 0
        self.lanes = 0

    def reset(self) -> None:
        self.launches = 0
        self.lanes = 0


#: One count per kernel, keyed by kernel name.
stats = {
    "ed25519_verify": KernelStats(),
    "ed25519_wire": KernelStats(),
    "ed25519_semiwire": KernelStats(),
}


def reset_stats() -> None:
    for st in stats.values():
        st.reset()


def consts_block() -> np.ndarray:
    """The kernel's constant block, from the same values the plain version
    uses: subtraction bias, 2d, digits of p and 2p, the [0..8]B niels
    planes (y+x, y-x, 2d*x*y), each [9, 20], then d and sqrt(-1)."""
    byp, bym, bt2 = _b_niels_np(9)
    block = np.concatenate(
        [fe._SUB_BIAS, K2D_LIMBS, fe.P_LIMBS, fe.P2_LIMBS,
         byp.ravel(), bym.ravel(), bt2.ravel(),
         wire.D_LIMBS, wire.SQRTM1_LIMBS]
    ).astype(np.int32)
    if block.shape != (CONSTS_LEN,):
        raise AssertionError("constant block layout drifted from fe25519.cuh")
    return block


def _words32(values) -> np.ndarray:
    """Integers in [0, 2^256) -> [..., 8] uint32 little-endian limbs."""
    vals = np.asarray(values, dtype=object)
    out = np.zeros(vals.shape + (W32_LIMBS,), dtype=np.uint32)
    for pos, v in np.ndenumerate(vals):
        v = int(v)
        if not 0 <= v < 1 << 256:
            raise ValueError(f"{v} is outside [0, 2^256)")
        out[pos] = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(W32_LIMBS)]
    return out


def consts_block_w32() -> np.ndarray:
    """The wire kernels' constant block, from the same integers as
    :func:`consts_block`: p, 2d, d, sqrt(-1), then the [0..8]B niels
    planes (y+x, y-x, 2d*x*y), each [9, 8], all as canonical values in
    uint32 limbs."""
    ints = [fe.P_INT, fe.from_limbs(K2D_LIMBS), fe.from_limbs(wire.D_LIMBS),
            fe.from_limbs(wire.SQRTM1_LIMBS)]
    planes = [[fe.from_limbs(row) for row in plane] for plane in _b_niels_np(9)]
    block = np.concatenate(
        [_words32(ints).ravel(), _words32(planes).ravel()]
    ).astype(np.uint32)
    if block.shape != (CONSTS_W32_LEN,):
        raise AssertionError("constant block layout drifted from fe25519_w32.cuh")
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
    """Compile the kernel library (all three kernels) from the sources in
    the package (once per source hash, or anew with ``force``) and return
    its path. The compiler's register and spill report is kept beside it
    as ``nvcc.log``."""
    out_dir = BUILD_DIR / f"ed25519_{source_hash()}"
    lib = out_dir / "libhd_ed25519.so"
    if lib.exists() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libhd_ed25519.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "ed25519_kernels.cu")]
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
        self.lib.hd_ed25519_set_consts.argtypes = [ci, vp, vp]
        self.lib.hd_ed25519_set_consts.restype = ci
        self.lib.hd_ed25519_verify.argtypes = [ci] + [vp] * 8 + [ci, vp]
        self.lib.hd_ed25519_verify.restype = ci
        self.lib.hd_ed25519_wire_verify.argtypes = [ci] + [vp] * 5 + [ci, vp]
        self.lib.hd_ed25519_wire_verify.restype = ci
        self.lib.hd_ed25519_semiwire_verify.argtypes = (
            [ci] + [vp] * 8 + [ci, vp, ci, vp]
        )
        self.lib.hd_ed25519_semiwire_verify.restype = ci
        self.ready: set = set()
        self._consts = consts_block()
        self._consts_w32 = consts_block_w32()

    def upload_consts(self, index: int) -> None:
        if index in self.ready:
            return
        rc = self.lib.hd_ed25519_set_consts(
            index, self._consts.ctypes.data_as(ctypes.c_void_p),
            self._consts_w32.ctypes.data_as(ctypes.c_void_p),
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


def _check_like(name, t, shape, dtype, device):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check(tensors) -> torch.device:
    """Checks the packed-limb inputs (int32 [B, 20] x 5, [B, 64] x 2) on
    one device; returns the device."""
    ax = tensors[0]
    if ax.dim() != 2:
        raise ValueError(f"expected [B, 20] limb rows, got {tuple(ax.shape)}")
    bsz = ax.shape[0]
    for i, t in enumerate(tensors):
        want = (bsz, fe.N_LIMBS) if i < 5 else (bsz, 64)
        _check_like(f"input {i}", t, want, torch.int32, ax.device)
    return ax.device


def _rows_device(rows) -> torch.device:
    """Checks [B, 32] uint8 wire rows on one device; returns the device."""
    r0 = rows[0]
    if r0.dim() != 2:
        raise ValueError(f"expected [B, 32] rows, got {tuple(r0.shape)}")
    for i, t in enumerate(rows):
        _check_like(f"rows {i}", t, (r0.shape[0], 32), torch.uint8, r0.device)
    return r0.device


def _launch(name: str, device: torch.device, bsz: int, fn, args) -> torch.Tensor:
    """Run one kernel on ``device``'s current stream into a fresh bool [B]
    (the kernel writes 0/1 bytes, torch.bool's representation), raise on
    a failed launch, count it."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty(bsz, dtype=torch.bool, device=device)
    if bsz == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    lib = _library(index)
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = getattr(lib.lib, fn)(index, *args, out.data_ptr(), bsz, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    stats[name].launches += 1
    stats[name].lanes += bsz
    return out


def verify(ax, ay, at, rx, ry, s_nib, k_nib) -> torch.Tensor:
    """bool[B]: per lane, [s]B + [k]A' == R on the packer's rows (ax, ay,
    at, rx, ry int32 [B, 20]; s_nib, k_nib int32 [B, 64]). CUDA tensors run
    the kernel on the current stream without synchronizing; CPU tensors run
    :func:`verify_plain`. All-zero lanes reject, as in the reference."""
    tensors = (ax, ay, at, rx, ry, s_nib, k_nib)
    device = _check(tensors)
    if device.type == "cpu":
        return verify_plain(*tensors)
    return _launch("ed25519_verify", device, ax.shape[0], "hd_ed25519_verify",
                   [t.data_ptr() for t in tensors])


def wire_verify(a_rows, r_rows, s_rows, k_rows) -> torch.Tensor:
    """bool[B]: the wire kernel on [B, 32] uint8 A, R, s, k rows (both
    points decompressed in the kernel), lane for lane
    :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.wire_verify_plain`,
    which CPU tensors run. Lanes must be masked by the packer's prevalid."""
    rows = (a_rows, r_rows, s_rows, k_rows)
    device = _rows_device(rows)
    if device.type == "cpu":
        return wire.wire_verify_plain(*rows)
    return _launch("ed25519_wire", device, a_rows.shape[0],
                   "hd_ed25519_wire_verify", [t.data_ptr() for t in rows])


def semiwire_verify(idx, r_rows, s_rows, k_rows,
                    tnax, tay, tnat, tvalid) -> torch.Tensor:
    """bool[B]: the semiwire kernel: -A read from the validator table
    (tnax, tay, tnat int32 [V, 20], tvalid bool [V]) at ``idx`` (int32
    [B]), R decompressed in the kernel, lane for lane
    :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.semiwire_verify_plain`,
    which CPU tensors run. Indices are range-checked by the caller on the
    host before upload (``ValidatorTable.upload_index``); a lane whose
    index lies outside the table reads nothing and rejects."""
    rows = (r_rows, s_rows, k_rows)
    device = _rows_device(rows)
    bsz = r_rows.shape[0]
    v = tvalid.shape[0] if tvalid.dim() == 1 else -1  # -1 fails the check
    _check_like("idx", idx, (bsz,), torch.int32, device)
    for name, t in (("tnax", tnax), ("tay", tay), ("tnat", tnat)):
        _check_like(name, t, (v, fe.N_LIMBS), torch.int32, device)
    _check_like("tvalid", tvalid, (v,), torch.bool, device)
    if device.type == "cpu":
        return wire.semiwire_verify_plain(idx, *rows, tnax, tay, tnat, tvalid)
    ptrs = [t.data_ptr() for t in (idx, *rows, tnax, tay, tnat, tvalid)]
    return _launch("ed25519_semiwire", device, bsz,
                   "hd_ed25519_semiwire_verify", [*ptrs, v])
