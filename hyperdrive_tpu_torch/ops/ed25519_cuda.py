"""The hand-written Hopper Ed25519 kernels: build, binding, wrappers.

Four kernels. Three are the TPU kernels of the JAX package
(``hyperdrive_tpu/ops/ed25519_pallas.py``); the fourth is the JAX
package's challenge leg, a device program it wrote in jnp:

- ``ed25519_verify`` (``csrc/ed25519_verify.cu``) replaces
  ``_verify_kernel_body`` / ``_verify_kernel_inner`` (``:373/:380``):
  packed, host-decompressed limbs, converted to the kernel's field by
  value. Plain version
  :func:`~hyperdrive_tpu_torch.ops.ed25519.verify_plain`.
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
- ``ed25519_challenge`` (``csrc/ed25519_challenge.cu``) replaces
  ``sha512_cat`` + ``sc_reduce_limbs`` (``hyperdrive_tpu/ops/
  sha512_jax.py:146/:345``) under the challenge legs of
  ``hyperdrive_tpu/ops/ed25519_wire.py`` (``:281/:328``): k =
  SHA-512(R || A || M) mod L, one thread a lane, the preimage gathered in
  the kernel. Plain versions
  :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.challenge` and
  :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.challenge_grouped`.

The three verify kernels run on the field of ``csrc/fe25519_w32.cuh`` (8
x 32-bit limbs in full radix on PTX carry chains: 146 multiply
instructions a product against 423 for 20 x 13-bit limbs) and the ladder
of ``csrc/ladder4.cuh``: four threads a signature, thread j owning
coordinate j of (X, Y, Z, T), each point formula two rounds of four
products exchanged by warp shuffles; the [0..8]A' table, the B table and
the signed digits in shared memory, field elements in registers. A block
is one warp, 8 signatures.

What bounds them on the card: 32-bit multiply instructions for the verify
kernels, integer instructions for the challenge; bytes are at most ~913 a
lane, negligible. At the main path's shape (one 256-lane vote window)
every kernel is latency-bound, far above its bound: the time is the
dependent chain of one signature or lane. Times, bounds and launches on
the card are in ``PERF.md`` (``chip_smoke.py``).

Build: at first use, ``nvcc`` compiles ``csrc/ed25519_kernels.cu`` (the
one translation unit that includes every kernel, so the constant block
has one copy per device and one upload) into a shared library with a
plain C interface under ``hyperdrive_tpu_torch/_build/``, keyed on a hash
of all the sources, and ``ctypes`` binds it. The constant block is
:func:`consts_block_w32`. A CUDA tensor launches the kernel or raises,
with the launch's ``cudaGetLastError`` checked; a CPU tensor takes the
plain version. There is no fallback from one to the other.
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

from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
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
    "challenge",
    "challenge_grouped",
    "KernelStats",
]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (
    "fe25519_w32.cuh", "ladder4.cuh", "decompress.cuh", "ed25519_verify.cu",
    "ed25519_wire.cu", "ed25519_challenge.cu", "ed25519_kernels.cu",
)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: Limbs of the 8 x 32-bit field (``csrc/fe25519_w32.cuh``).
W32_LIMBS = 8
#: delta = L - 2^252, so 2^252 = -delta (mod L): the challenge kernel's
#: fold constant.
SC_DELTA = host_ed.L - (1 << 252)
#: Widths of the part above bit 252 that each of the challenge kernel's
#: three folds takes (``csrc/ed25519_challenge.cu``, ``hd_sc_reduce``).
SC_FOLD_WIDTHS = (260, 133, 6)
#: Entries of the constant block, in the layout ``csrc/fe25519_w32.cuh``
#: declares (HD_W_*): 4 field values, the 27 B-table entries, then L,
#: delta and the three fold constants.
CONSTS_W32_LEN = (4 + 3 * 9 + 2 + len(SC_FOLD_WIDTHS)) * W32_LIMBS


class KernelStats:
    """Launch accounting: ``launches`` grows by one per kernel launch and
    ``lanes`` by the lanes launched; the plain version counts nothing.
    Lock-guarded: replica threads of one process launch concurrently."""

    def __init__(self):
        self.launches = 0
        self.lanes = 0
        self._lock = threading.Lock()

    def add(self, lanes: int) -> None:
        with self._lock:
            self.launches += 1
            self.lanes += lanes

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.lanes = 0


#: One count per kernel, keyed by kernel name.
stats = {
    "ed25519_verify": KernelStats(),
    "ed25519_wire": KernelStats(),
    "ed25519_semiwire": KernelStats(),
    "ed25519_challenge": KernelStats(),
}


def reset_stats() -> None:
    for st in stats.values():
        st.reset()


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


def _sc_fold_const(width: int) -> int:
    """-delta (2^width - 1) mod L: the constant of the challenge kernel's
    fold of a part ``b < 2^width`` above bit 252, which adds
    ``delta * (2^width - 1 - b)`` in place of subtracting ``delta * b``."""
    return -SC_DELTA * ((1 << width) - 1) % host_ed.L


def consts_block_w32() -> np.ndarray:
    """The kernels' constant block, from the same integers as the plain
    versions: p, 2d, d, sqrt(-1), then the [0..8]B niels planes (y+x,
    y-x, 2d*x*y), each [9, 8], then L, delta and the challenge kernel's
    fold constants, all as canonical values in uint32 limbs."""
    ints = [fe.P_INT, fe.from_limbs(K2D_LIMBS), fe.from_limbs(wire.D_LIMBS),
            fe.from_limbs(wire.SQRTM1_LIMBS)]
    planes = [[fe.from_limbs(row) for row in plane] for plane in _b_niels_np(9)]
    scalars = [host_ed.L, SC_DELTA, *(_sc_fold_const(w) for w in SC_FOLD_WIDTHS)]
    block = np.concatenate(
        [_words32(ints).ravel(), _words32(planes).ravel(),
         _words32(scalars).ravel()]
    ).astype(np.uint32)
    if block.shape != (CONSTS_W32_LEN,):
        raise AssertionError("constant block layout drifted from fe25519_w32.cuh")
    return block


def source_hash(sources=SOURCES) -> str:
    h = hashlib.sha256()
    for name in sources:
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


def build_library(tag: str, unit: str, sources, force: bool = False) -> pathlib.Path:
    """Compile the translation unit ``csrc/<unit>`` into
    ``_build/<tag>_<hash>/libhd_<tag>.so`` (once per hash of ``sources``
    and the flags, or anew with ``force``) and return its path. The
    compiler's register and spill report is kept beside it as
    ``nvcc.log``."""
    out_dir = BUILD_DIR / f"{tag}_{source_hash(sources)}"
    lib = out_dir / f"libhd_{tag}.so"
    if lib.exists() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libhd_{tag}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / unit)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernel library (all four kernels) from the sources in
    the package and return its path (:func:`build_library`)."""
    return build_library("ed25519", "ed25519_kernels.cu", SOURCES, force)


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
        self.lib.hd_ed25519_verify.restype = ci
        self.lib.hd_ed25519_wire_verify.argtypes = [ci] + [vp] * 5 + [ci, vp]
        self.lib.hd_ed25519_wire_verify.restype = ci
        self.lib.hd_ed25519_semiwire_verify.argtypes = (
            [ci] + [vp] * 8 + [ci, vp, ci, vp]
        )
        self.lib.hd_ed25519_semiwire_verify.restype = ci
        self.lib.hd_ed25519_challenge.argtypes = (
            [ci] + [vp] * 4 + [ci, vp, ci, vp, ci, vp]
        )
        self.lib.hd_ed25519_challenge.restype = ci
        self.ready: set = set()
        self._consts = consts_block_w32()

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


def _launch(name: str, device: torch.device, bsz: int, fn, args,
            out_shape=(), out_dtype=torch.bool) -> torch.Tensor:
    """Run one kernel on ``device``'s current stream into a fresh
    ``[B, *out_shape]`` output (by default bool [B]: the verify kernels
    write 0/1 bytes, torch.bool's representation), raise on a failed
    launch, count it."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((bsz, *out_shape), dtype=out_dtype, device=device)
    if bsz == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    lib = _library(index)
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = getattr(lib.lib, fn)(index, *args, out.data_ptr(), bsz, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    stats[name].add(bsz)
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


def _check_challenge(idx, r_rows, m_rows, trows) -> torch.device:
    """Checks the challenge inputs (int32 [B] idx, uint8 [B, 32] R rows,
    uint8 [*, 32] digest rows, uint8 [V, 32] table rows) on one device;
    the kernel reads rows as 16-byte vectors, so on the card each row
    tensor must start 16-byte aligned. Returns the device."""
    device = _rows_device((r_rows,))
    _check_like("idx", idx, (r_rows.shape[0],), torch.int32, device)
    for name, t in (("m_rows", m_rows), ("trows", trows)):
        n = t.shape[0] if t.dim() == 2 else -1  # -1 fails the check
        _check_like(name, t, (n, 32), torch.uint8, device)
    if device.type == "cuda":
        for name, t in (("r_rows", r_rows), ("m_rows", m_rows), ("trows", trows)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
    return device


def challenge(idx, r_rows, m_rows, trows) -> torch.Tensor:
    """uint8 [B, 32]: the per-lane challenge leg, k = SHA-512(R || A || M)
    mod L (canonical, little-endian) from R rows, the table's compressed A
    rows ``trows`` ([V, 32]) at ``idx`` and per-lane digest rows
    ``m_rows`` ([B, 32]), byte for byte
    :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.challenge`, which CPU
    tensors run. Indices are range-checked by the caller on the host
    (``ValidatorTable.upload_index``); the kernel reads zeros for an index
    outside the table."""
    device = _check_challenge(idx, r_rows, m_rows, trows)
    if m_rows.shape[0] != r_rows.shape[0]:
        raise ValueError(f"m_rows: {m_rows.shape[0]} rows for {r_rows.shape[0]} lanes")
    if device.type == "cpu":
        return wire.challenge(idx, r_rows, m_rows, trows)
    ptrs = [idx.data_ptr(), r_rows.data_ptr(), m_rows.data_ptr(), None, 0,
            trows.data_ptr(), trows.shape[0]]
    return _launch("ed25519_challenge", device, r_rows.shape[0],
                   "hd_ed25519_challenge", ptrs, (32,), torch.uint8)


def challenge_grouped(idx, r_rows, m_idx, m_uniq, trows) -> torch.Tensor:
    """uint8 [B, 32]: the grouped challenge leg, as :func:`challenge` with
    the digests taken from the deduplicated table ``m_uniq`` ([U, 32]
    uint8) at ``m_idx`` ([B] uint8), byte for byte
    :func:`~hyperdrive_tpu_torch.ops.ed25519_wire.challenge_grouped`,
    which CPU tensors run. ``m_idx`` must lie in ``[0, U)``; the kernel
    reads zeros for an index outside it."""
    device = _check_challenge(idx, r_rows, m_uniq, trows)
    _check_like("m_idx", m_idx, (r_rows.shape[0],), torch.uint8, device)
    if device.type == "cpu":
        return wire.challenge_grouped(idx, r_rows, m_idx, m_uniq, trows)
    ptrs = [idx.data_ptr(), r_rows.data_ptr(), m_uniq.data_ptr(),
            m_idx.data_ptr(), m_uniq.shape[0], trows.data_ptr(), trows.shape[0]]
    return _launch("ed25519_challenge", device, r_rows.shape[0],
                   "hd_ed25519_challenge", ptrs, (32,), torch.uint8)
