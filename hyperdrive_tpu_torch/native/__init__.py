"""ctypes binding for the native host runtime (``hd_native.cc``).

Port copy of ``hyperdrive_tpu/native/__init__.py``: the C++ signer,
packers and host verifier that keep the host's per-signature work
(point decompression, SHA-512, reduction mod L, limb and nibble packing,
RFC 8032 signing and verification) out of pure Python.

The shared library is compiled by ``g++`` at first use, never at import,
into ``hyperdrive_tpu_torch/_build/``. Its name is keyed on a hash of the
source, the compiler flags and the target that ``-march=native`` resolves
to on this machine (``g++ -march=native -Q --help=target``), so a library
left by one machine is never loaded on a CPU it was not built for. The
build writes a temporary file that ``os.replace`` moves into place, so
concurrent builds race benignly.

If the toolchain is missing or the build fails, :func:`load` returns None
(with the reason in :func:`last_error`) and callers take the pure-Python
oracle path; ``HD_NO_NATIVE=1`` forces that path. Both give the same
bytes and verdicts (differentially tested). Every argument is validated
in Python before its pointer reaches C.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

import numpy as np

__all__ = [
    "load",
    "available",
    "last_error",
    "instance",
    "NativePacker",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hd_native.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_lib_err: str | None = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_INT = ctypes.c_int
_SIZE = ctypes.c_size_t

#: (restype, argtypes) of every C entry point of hd_native.cc.
_ABI = {
    "hd_decompress": (_INT, [_U8P, _U8P]),
    "hd_sha512": (None, [_U8P, _SIZE, _U8P]),
    "hd_mod_l": (None, [_U8P, _U8P]),
    "hd_public_from_seed": (None, [_U8P, _U8P]),
    "hd_sign": (None, [_U8P, _U8P, _U8P, _SIZE, _U8P]),
    "hd_verify_batch": (_INT, [_U8P, _U8P, _I32P, _INT, _U8P, _U8P, _INT, _U8P]),
    "hd_verify_one": (_INT, [_U8P, _U8P, _SIZE, _U8P]),
    "hd_cache_clear": (None, []),
    "hd_pack_batch": (
        _INT, [_U8P, _U8P, _I32P, _INT, _U8P, _U8P, _INT] + [_I32P] * 7 + [_U8P]
    ),
    "hd_pack_wire": (
        _INT, [_U8P, _U8P, _I32P, _INT, _U8P, _U8P, _INT] + [_U8P] * 5
    ),
}


def _native_target() -> str:
    """What ``-march=native`` enables here, as g++ reports it; "" when the
    compiler cannot say (then the build does not use ``-march=native``)."""
    try:
        return subprocess.run(
            [CXX, "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=True,
        ).stdout
    except (subprocess.CalledProcessError, OSError):
        return ""


def _build_plans():
    """(flags, library path) to try in order: the ``-march=native`` build
    keyed on the resolved target, then the portable build."""
    with open(_SRC, "rb") as fh:
        src = fh.read()
    target = _native_target()
    plans = []
    for flags, extra in (((*CXX_FLAGS, "-march=native"), target), (CXX_FLAGS, "")):
        if "-march=native" in flags and not target:
            continue
        h = hashlib.sha256(src)
        h.update(" ".join(flags).encode())
        h.update(extra.encode())
        plans.append(
            (flags, os.path.join(_BUILD_DIR, f"libhd_native-{h.hexdigest()[:16]}.so"))
        )
    return plans


def _compile() -> str:
    """Path of a library built from this checkout's source, compiling it
    if needed."""
    err = None
    for flags, so_path in _build_plans():
        if os.path.exists(so_path):
            return so_path
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                [CXX, *flags, _SRC, "-o", tmp], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, OSError) as e:
            err = e
            continue
        os.replace(tmp, so_path)  # atomic: concurrent builds race benignly
        return so_path
    raise err


def load():
    """The loaded CDLL, or None if native is unavailable."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if os.environ.get("HD_NO_NATIVE"):
            _lib_err = "disabled by HD_NO_NATIVE"
            return None
        try:
            lib = ctypes.CDLL(_compile())
        except subprocess.CalledProcessError as e:
            stderr = (e.stderr or b"").decode("utf-8", "replace").strip()
            _lib_err = f"native build failed: {e}: {stderr[-500:]}"
            return None
        except OSError as e:  # missing g++, unloadable library
            _lib_err = f"native build failed: {e}"
            return None
        for name, (restype, argtypes) in _ABI.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def last_error() -> str | None:
    """Why native is unavailable (None if it loaded or was not tried)."""
    return _lib_err


_packer = None
_packer_failed = False


def instance():
    """The shared :class:`NativePacker`, or None when native is
    unavailable: the one place the fallback policy lives (callers: the
    keys, the host verifier, both packers). A failed build warns once;
    ``HD_NO_NATIVE`` is silent."""
    global _packer, _packer_failed
    if _packer is None and not _packer_failed:
        try:
            _packer = NativePacker()
        except RuntimeError as e:
            _packer_failed = True
            if not os.environ.get("HD_NO_NATIVE"):
                warnings.warn(
                    f"native runtime unavailable ({e}); signing, packing and "
                    "host verification take the pure-Python path (about 100x "
                    "slower). Set HD_NO_NATIVE=1 to silence this.",
                    RuntimeWarning,
                    stacklevel=2,
                )
    return _packer


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _bytes_arg(data: bytes, size: int | None = None, what: str = "argument"):
    """``data`` as a contiguous uint8 array (kept alive by the caller while
    C reads it); ``size``, when given, is the required length."""
    if size is not None and len(data) != size:
        raise ValueError(f"{what} must be {size} bytes, got {len(data)}")
    if not data:
        return np.zeros(1, dtype=np.uint8)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _check_rows(arr: np.ndarray, n: int, width: int, dtype, name: str) -> None:
    """An output array C writes rows 0..n-1 of: the right dtype, C order,
    at least ``n`` rows of ``width``."""
    if (
        not isinstance(arr, np.ndarray)
        or arr.dtype != dtype
        or arr.ndim != 2
        or arr.shape[0] < n
        or arr.shape[1] != width
        or not arr.flags.c_contiguous
        or not arr.flags.writeable
    ):
        raise ValueError(
            f"{name} must be a writable C-contiguous {np.dtype(dtype).name} "
            f"array of shape [>= {n}, {width}]"
        )


def _marshal_items(items):
    """Marshal (pub32, payload, sig64) triples into the contiguous buffers
    the C ABI consumes: (pubs, payloads, payload_lens, payload_stride,
    sigs, in_ok). Wrong-length pubs/sigs get in_ok=0; payloads may be any
    length. Shared by packing and host batch verification so the two paths
    can never diverge.

    Fast path: when every row is well formed and payloads share one length
    (consensus digests are always 32 bytes), the buffers are built with
    three byte-joins instead of a per-row numpy loop.
    """
    n = len(items)
    if n and all(
        len(p) == 32 and s is not None and len(s) == 64
        and len(m) == len(items[0][1])
        for p, m, s in items
    ):
        mlen = len(items[0][1])
        stride = mlen or 1
        pubs = np.frombuffer(
            b"".join(p for p, _, _ in items), dtype=np.uint8
        ).reshape(n, 32)
        sigs = np.frombuffer(
            b"".join(s for _, _, s in items), dtype=np.uint8
        ).reshape(n, 64)
        if mlen:
            payloads = np.frombuffer(
                b"".join(m for _, m, _ in items), dtype=np.uint8
            ).reshape(n, mlen)
        else:
            payloads = np.zeros((n, 1), dtype=np.uint8)
        lens = np.full(n, mlen, dtype=np.int32)
        in_ok = np.ones(n, dtype=np.uint8)
        return pubs, payloads, lens, stride, sigs, in_ok

    stride = max((len(m) for _, m, _ in items), default=1) or 1
    pubs = np.zeros((n, 32), dtype=np.uint8)
    payloads = np.zeros((n, stride), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    sigs = np.zeros((n, 64), dtype=np.uint8)
    in_ok = np.zeros(n, dtype=np.uint8)
    for i, (pub, payload, sig) in enumerate(items):
        if len(pub) != 32 or sig is None or len(sig) != 64:
            continue
        pubs[i] = np.frombuffer(pub, dtype=np.uint8)
        if payload:
            payloads[i, : len(payload)] = np.frombuffer(payload, dtype=np.uint8)
        lens[i] = len(payload)
        sigs[i] = np.frombuffer(sig, dtype=np.uint8)
        in_ok[i] = 1
    return pubs, payloads, lens, stride, sigs, in_ok


class NativePacker:
    """Batch Ed25519 packing, signing and host verification through the
    native library.

    Same contract as the Python loops in ``Ed25519BatchHost.pack`` and
    ``Ed25519WireHost.pack_wire``: given (pub, digest, sig) byte triples,
    fill the kernel's arrays and return a prevalidity mask.
    """

    def __init__(self):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(_lib_err or "native library unavailable")

    def pack_into(self, items, ax, ay, at, rx, ry, s_nib, k_nib) -> np.ndarray:
        """items: sequence of (pub, digest, sig) byte triples (digests may
        be any length; pub/sig must be 32/64 bytes to pack). Writes row i
        of each output array (int32: five ``[>= n, 20]`` limb arrays, two
        ``[>= n, 64]`` nibble arrays, pre-zeroed by the caller) for every
        item that passes the host checks; returns the bool prevalid mask
        (length ``len(items)``)."""
        n = len(items)
        for name, arr in zip(("ax", "ay", "at", "rx", "ry"), (ax, ay, at, rx, ry)):
            _check_rows(arr, n, 20, np.int32, name)
        _check_rows(s_nib, n, 64, np.int32, "s_nib")
        _check_rows(k_nib, n, 64, np.int32, "k_nib")
        if not n:
            return np.zeros(0, dtype=bool)
        pubs, digests, digest_lens, dstride, sigs, in_ok = _marshal_items(items)
        prevalid = np.zeros(n, dtype=np.uint8)
        self._lib.hd_pack_batch(
            _u8ptr(pubs), _u8ptr(digests), _i32ptr(digest_lens), dstride,
            _u8ptr(sigs), _u8ptr(in_ok), n,
            _i32ptr(ax), _i32ptr(ay), _i32ptr(at), _i32ptr(rx), _i32ptr(ry),
            _i32ptr(s_nib), _i32ptr(k_nib), _u8ptr(prevalid),
        )
        return prevalid.astype(bool)

    def pack_wire_into(self, items, a_rows, r_rows, s_rows, k_rows) -> np.ndarray:
        """Wire-route packing (decompression on the device): writes the
        32-byte rows (pub, R, s, k) of every item passing the host range
        checks into uint8 ``[>= n, 32]`` arrays; returns the bool prevalid
        mask. Same item contract as :meth:`pack_into`."""
        n = len(items)
        for name, arr in zip(("a_rows", "r_rows", "s_rows", "k_rows"),
                             (a_rows, r_rows, s_rows, k_rows)):
            _check_rows(arr, n, 32, np.uint8, name)
        if not n:
            return np.zeros(0, dtype=bool)
        pubs, digests, digest_lens, dstride, sigs, in_ok = _marshal_items(items)
        prevalid = np.zeros(n, dtype=np.uint8)
        self._lib.hd_pack_wire(
            _u8ptr(pubs), _u8ptr(digests), _i32ptr(digest_lens), dstride,
            _u8ptr(sigs), _u8ptr(in_ok), n,
            _u8ptr(a_rows), _u8ptr(r_rows), _u8ptr(s_rows), _u8ptr(k_rows),
            _u8ptr(prevalid),
        )
        return prevalid.astype(bool)

    # ------------------------------------------------------ self-test hooks

    def decompress(self, data: bytes):
        """Mirror of ``crypto.ed25519.point_decompress`` for differential
        tests: (x, y) ints or None."""
        if len(data) != 32:
            return None
        buf = _bytes_arg(data)
        out = np.zeros(64, dtype=np.uint8)
        if not self._lib.hd_decompress(_u8ptr(buf), _u8ptr(out)):
            return None
        return (int.from_bytes(out[:32].tobytes(), "little"),
                int.from_bytes(out[32:].tobytes(), "little"))

    def sha512(self, data: bytes) -> bytes:
        buf = _bytes_arg(data)
        out = np.zeros(64, dtype=np.uint8)
        self._lib.hd_sha512(_u8ptr(buf), len(data), _u8ptr(out))
        return out.tobytes()

    def mod_l(self, data64: bytes) -> int:
        buf = _bytes_arg(data64, 64, "data64")
        out = np.zeros(32, dtype=np.uint8)
        self._lib.hd_mod_l(_u8ptr(buf), _u8ptr(out))
        return int.from_bytes(out.tobytes(), "little")

    def cache_clear(self) -> None:
        """Empty the public-key decompression cache."""
        self._lib.hd_cache_clear()

    # -------------------------------------------------------- sign / verify

    def public_from_seed(self, seed: bytes) -> bytes:
        sbuf = _bytes_arg(seed, 32, "seed")
        out = np.zeros(32, dtype=np.uint8)
        self._lib.hd_public_from_seed(_u8ptr(sbuf), _u8ptr(out))
        return out.tobytes()

    def sign(self, seed: bytes, msg: bytes, pub: bytes | None = None) -> bytes:
        """RFC 8032 signature of ``msg``. Passing the (derivable) cached
        ``pub`` skips one of the three base-point scalar multiplications."""
        sbuf = _bytes_arg(seed, 32, "seed")
        pbuf = None if pub is None else _bytes_arg(pub, 32, "pub")
        mbuf = _bytes_arg(msg)
        out = np.zeros(64, dtype=np.uint8)
        self._lib.hd_sign(
            _u8ptr(sbuf), None if pbuf is None else _u8ptr(pbuf),
            _u8ptr(mbuf), len(msg), _u8ptr(out),
        )
        return out.tobytes()

    def verify(self, pub: bytes, msg: bytes, sig: bytes) -> bool:
        if len(pub) != 32 or sig is None or len(sig) != 64:
            return False
        pbuf, mbuf, sbuf = _bytes_arg(pub), _bytes_arg(msg), _bytes_arg(sig)
        return bool(
            self._lib.hd_verify_one(_u8ptr(pbuf), _u8ptr(mbuf), len(msg), _u8ptr(sbuf))
        )

    def verify_batch(self, items) -> np.ndarray:
        """items: sequence of (pub, msg, sig); returns bool[n]. Host-CPU
        batch verification (no device involved)."""
        n = len(items)
        if not n:
            return np.zeros(0, dtype=bool)
        pubs, msgs, lens, dstride, sigs, in_ok = _marshal_items(items)
        out = np.zeros(n, dtype=np.uint8)
        self._lib.hd_verify_batch(
            _u8ptr(pubs), _u8ptr(msgs), _i32ptr(lens), dstride,
            _u8ptr(sigs), _u8ptr(in_ok), n, _u8ptr(out),
        )
        return out.astype(bool)
