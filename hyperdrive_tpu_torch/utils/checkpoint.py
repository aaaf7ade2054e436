"""Crash-restart checkpointing for consensus processes.

The reference's checkpoint format is the surge marshal of the whole
``Process`` — identity, f, and the full State including message logs and
once-flags — with the contract "State should be saved after every method
call" (reference: process/process.go:183-223, process/state.go:18-20).
This module provides the file layer around this framework's equivalent
(:meth:`hyperdrive_tpu_torch.process.Process.marshal`): a versioned,
checksummed envelope with atomic replace, so a replica killed mid-write
never sees a torn checkpoint.

Port copy of ``hyperdrive_tpu/utils/checkpoint.py``; its envelopes are
byte for byte the JAX package's, so a checkpoint written by either
restores in the other. The payload is read through the sanitizer's
budget reader (``maybe_wire_reader("process.checkpoint")``), as in the
reference.
"""

from __future__ import annotations

import os
import zlib

from hyperdrive_tpu_torch.analysis.sanitizer import maybe_wire_reader
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.process import Process

__all__ = [
    "save_process",
    "restore_process",
    "checkpoint_bytes",
    "restore_bytes",
    "CheckpointStore",
]

_MAGIC = 0x48594350  # "HYCP"
_VERSION = 1

#: Generous budget for one Process: state grows with logged votes per round.
_MAX_BYTES = 1 << 28


def checkpoint_bytes(proc: Process) -> bytes:
    """Serialize a Process into a self-validating envelope."""
    body = Writer(rem=_MAX_BYTES)
    proc.marshal(body)
    payload = body.data()
    head = Writer(rem=64)
    head.u32(_MAGIC)
    head.u32(_VERSION)
    head.u64(len(payload))
    head.u32(zlib.crc32(payload) & 0xFFFFFFFF)
    return head.data() + payload


def restore_bytes(proc: Process, data: bytes) -> None:
    """Restore ``proc`` in place from :func:`checkpoint_bytes` output.

    Raises :class:`~hyperdrive_tpu_torch.codec.SerdeError` on any corruption —
    wrong magic, unsupported version, truncated payload, or checksum
    mismatch — without touching ``proc``.
    """
    head = Reader(data, rem=_MAX_BYTES + 64)
    if head.u32() != _MAGIC:
        raise SerdeError("not a process checkpoint (bad magic)")
    version = head.u32()
    if version != _VERSION:
        raise SerdeError(f"unsupported checkpoint version {version}")
    size = head.u64()
    crc = head.u32()
    payload = data[20:]
    if len(payload) != size:
        raise SerdeError(
            f"checkpoint truncated: header says {size} bytes, got {len(payload)}"
        )
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise SerdeError("checkpoint checksum mismatch")
    proc.unmarshal_into(maybe_wire_reader(
        "process.checkpoint", payload, rem=_MAX_BYTES
    ))


def save_process(proc: Process, path: str) -> None:
    """Atomically write a checkpoint: write to a sibling temp file, fsync,
    rename. A crash at any point leaves either the old or the new
    checkpoint intact, never a torn one."""
    data = checkpoint_bytes(proc)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def restore_process(proc: Process, path: str) -> None:
    """Restore ``proc`` in place from a checkpoint file."""
    with open(path, "rb") as fh:
        restore_bytes(proc, fh.read())


class CheckpointStore:
    """Latest-checkpoint-per-key store over the same self-validating
    envelope the file layer writes.

    An in-memory stand-in for each replica's checkpoint file:
    :meth:`save` snapshots a Process after every handled delivery (the
    reference's "save after every method call" contract), :meth:`latest`
    / :meth:`restore` hand the newest envelope back on crash-restart, and
    :meth:`dump` writes each entry to ``<dir>/replica_<key>.ckpt`` for
    post-mortem inspection.
    """

    def __init__(self) -> None:
        self._latest: dict[object, bytes] = {}

    def save(self, key, proc: Process) -> None:
        self._latest[key] = checkpoint_bytes(proc)

    def latest(self, key) -> "bytes | None":
        return self._latest.get(key)

    def restore(self, key, proc: Process) -> bool:
        """Restore ``proc`` from the newest checkpoint under ``key``;
        returns False (proc untouched) when none was ever saved."""
        data = self._latest.get(key)
        if data is None:
            return False
        restore_bytes(proc, data)
        return True

    def __len__(self) -> int:
        return len(self._latest)

    def dump(self, dirpath: str) -> list[str]:
        os.makedirs(dirpath, exist_ok=True)
        paths = []
        for key in sorted(self._latest, key=str):
            path = os.path.join(dirpath, f"replica_{key}.ckpt")
            with open(path, "wb") as fh:
                fh.write(self._latest[key])
            paths.append(path)
        return paths
