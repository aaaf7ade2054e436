"""Pluggable vote-signature verification.

The reference assumes authentication happens outside the library
(process/process.go:95-98, mq/mq.go:85-86). This framework makes it a
first-class, injectable seam: a Verifier receives a whole window of queued
messages and returns an accept mask.

Port copy of ``Verifier``, ``NullVerifier`` and ``HostVerifier`` from
``hyperdrive_tpu/verifier.py``:

- :class:`NullVerifier` accepts everything (the reference's trust model);
  the pipelined harness's null launcher mirrors it.
- :class:`HostVerifier` verifies on the host CPU through the native C++
  batch path (:mod:`hyperdrive_tpu_torch.native`) when it builds, and
  through the pure-Python oracle (:mod:`hyperdrive_tpu_torch.crypto.
  ed25519`) otherwise; both implement RFC 8032 verification and agree bit
  for bit (differentially tested).

The device verifiers are
:class:`hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier` and
:class:`hyperdrive_tpu_torch.ops.ed25519_wire.TorchWireVerifier`.
``AdaptiveVerifier`` is not ported yet.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from hyperdrive_tpu_torch.crypto import ed25519

__all__ = ["Verifier", "NullVerifier", "HostVerifier"]


@runtime_checkable
class Verifier(Protocol):
    def verify_batch(self, window: Sequence) -> Sequence[bool]:
        """Return one accept/reject per message in the window."""
        ...


class NullVerifier:
    """Trusts the transport (the reference's model)."""

    def verify_batch(self, window):
        return [True] * len(window)


class HostVerifier:
    """Host-CPU Ed25519 verification of each message's detached signature,
    with the sender's public key as the verification key — the host
    baseline and the small-window route of the burst harness."""

    def __init__(self):
        from hyperdrive_tpu_torch import native

        self._native = native.instance()

    def verify_batch(self, window):
        if self._native is not None:
            # Signatures pass through unchanged: the native marshaller
            # length-checks and marks wrong-length signatures invalid
            # (never substitute a zero signature: with an adversarial
            # small-order pubkey a zero signature can verify).
            items = [(msg.sender, msg.digest(), msg.signature) for msg in window]
            mask = self._native.verify_batch(items)
            return [bool(ok) and bool(msg.signature) for ok, msg in zip(mask, window)]
        return [
            bool(msg.signature)
            and ed25519.verify(msg.sender, msg.digest(), msg.signature)
            for msg in window
        ]

    def verify_signatures(self, items):
        """Raw (pub, digest, sig) triples -> bool mask; the aggregated-batch
        entry point shared with TorchBatchVerifier so harness drivers can
        swap host and device backends freely."""
        if self._native is not None:
            return self._native.verify_batch(items)
        return [ed25519.verify(pub, digest, sig) for pub, digest, sig in items]
