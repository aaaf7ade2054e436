"""Pluggable vote-signature verification.

The reference assumes authentication happens outside the library
(process/process.go:95-98, mq/mq.go:85-86). This framework makes it a
first-class, injectable seam: a Verifier receives a whole window of queued
messages and returns an accept mask.

Port copy of ``Verifier`` and ``HostVerifier`` from
``hyperdrive_tpu/verifier.py``. The native C++ batch path is not ported, so
:class:`HostVerifier` runs the pure-Python oracle
(:mod:`hyperdrive_tpu_torch.crypto.ed25519`); its verdicts are bit-identical
to the reference's native path (both implement RFC 8032 verification). The
device verifier is
:class:`hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier`.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from hyperdrive_tpu_torch.crypto import ed25519

__all__ = ["Verifier", "HostVerifier"]


@runtime_checkable
class Verifier(Protocol):
    def verify_batch(self, window: Sequence) -> Sequence[bool]:
        """Return one accept/reject per message in the window."""
        ...


class HostVerifier:
    """Host-CPU Ed25519 verification of each message's detached signature,
    with the sender's public key as the verification key — the host
    baseline and the small-window route of the burst harness."""

    def verify_batch(self, window):
        return [
            bool(msg.signature)
            and ed25519.verify(msg.sender, msg.digest(), msg.signature)
            for msg in window
        ]

    def verify_signatures(self, items):
        """Raw (pub, digest, sig) triples -> bool mask; the aggregated-batch
        entry point shared with TorchBatchVerifier so harness drivers can
        swap host and device backends freely."""
        return [ed25519.verify(pub, digest, sig) for pub, digest, sig in items]
