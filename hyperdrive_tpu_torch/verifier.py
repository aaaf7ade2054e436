"""Pluggable vote-signature verification.

The reference assumes authentication happens outside the library
(process/process.go:95-98, mq/mq.go:85-86). This framework makes it a
first-class, injectable seam: a Verifier receives a whole window of queued
messages and returns an accept mask.

Port copy of ``hyperdrive_tpu/verifier.py``:

- :class:`NullVerifier` accepts everything (the reference's trust model);
  the pipelined harness's null launcher mirrors it.
- :class:`HostVerifier` verifies on the host CPU through the native C++
  batch path (:mod:`hyperdrive_tpu_torch.native`) when it builds, and
  through the pure-Python oracle (:mod:`hyperdrive_tpu_torch.crypto.
  ed25519`) otherwise; both implement RFC 8032 verification and agree bit
  for bit (differentially tested).
- :class:`AdaptiveVerifier` routes each window to the host or the device
  leg by size, at a crossover it measures on its first large window.

The device verifiers are
:class:`hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier` and
:class:`hyperdrive_tpu_torch.ops.ed25519_wire.TorchWireVerifier`.
"""

from __future__ import annotations

import time
from typing import Protocol, Sequence, runtime_checkable

from hyperdrive_tpu_torch.crypto import ed25519

__all__ = ["Verifier", "NullVerifier", "HostVerifier", "AdaptiveVerifier"]


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


class AdaptiveVerifier:
    """Routes each window to the host or the device backend by size.

    The latency/throughput tension: a device launch
    has a fixed dispatch+transfer overhead but far higher sustained
    throughput, so small windows (a lone propose, a timeout-round trickle)
    verify faster on the host while vote storms belong on the device. The
    crossover is measured, not guessed: the first window at least as large
    as ``calibrate_at`` is timed through BOTH backends (their verdicts also
    cross-checked), and the per-signature rates + device overhead solve for
    the break-even size. Until calibration, windows route by the
    provisional ``crossover`` guess.

    Both backends implement the same ``verify_signatures`` contract and
    must agree bit-for-bit, so routing is a pure performance decision; a
    disagreement at calibration raises. The default device leg is
    :class:`~hyperdrive_tpu_torch.ops.ed25519.TorchBatchVerifier` on the
    card (it raises without CUDA); pass ``device=TorchBatchVerifier(
    device="cpu")`` to run it on the CPU.
    """

    def __init__(
        self,
        device=None,
        host=None,
        crossover: int = 192,
        calibrate_at: int = 384,
    ):
        if device is None:
            from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

            device = TorchBatchVerifier(device="cuda")
        self.device = device
        self.host = host if host is not None else HostVerifier()
        self.crossover = int(crossover)
        self.calibrate_at = int(calibrate_at)
        self.calibrated = False
        #: Self-describing calibration record once measured — keys
        #: ``host_sigs_per_s``, ``device_sigs_per_s``,
        #: ``device_overhead_s`` (the single-launch time, i.e. dispatch +
        #: transfer, in seconds — NOT a rate) — exposed for benchmark
        #: reporting.
        self.rates = None

    @staticmethod
    def _median_time(fn, reps: int = 3):
        """Median-of-``reps`` timing: one jittered sample (a host hiccup,
        scheduler preemption) cannot set the rate a calibration bakes in
        for the rest of the process."""
        out = None
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2], out

    def recalibrate(self) -> None:
        """Forget the measured crossover; the next window at least
        ``calibrate_at`` large re-measures both legs. Call after anything
        that changes the latency regime (device contention ended, link
        changed, process migrated)."""
        self.calibrated = False

    def _calibrate(self, items):
        # Warm BOTH device shapes first so the kernel build and each
        # bucket's first launch are not billed as launch overhead (the
        # tiny probe below typically lands in a different bucket than the
        # full window). Each timed device call ends in its mask's copy to
        # the host, so the wall clock covers the device work.
        self.device.verify_signatures(items)
        self.device.verify_signatures(items[:1])
        t_dev_full, mask_dev = self._median_time(
            lambda: self.device.verify_signatures(items)
        )
        # A tiny launch isolates the fixed overhead (dispatch + transfer).
        t_dev_one, _ = self._median_time(
            lambda: self.device.verify_signatures(items[:1])
        )
        t_host, mask_host = self._median_time(
            lambda: self.host.verify_signatures(items)
        )
        if list(mask_dev) != list(mask_host):
            raise RuntimeError(
                "host and device verifiers disagree during calibration — "
                "refusing to route on performance while correctness differs"
            )
        n = len(items)
        host_rate = n / t_host if t_host > 0 else float("inf")
        # Marginal device cost per signature: the difference between the
        # full and single-item launches. When both land in the same padded
        # bucket the difference is ~0 (the launch is overhead-dominated) —
        # clamp at zero and report the sustained rate instead, which is
        # what the full launch actually achieved.
        dev_per_sig = max(t_dev_full - t_dev_one, 0.0) / max(n - 1, 1)
        dev_rate = n / t_dev_full if t_dev_full > 0 else float("inf")
        # Break-even: n/host_rate == overhead + n*dev_per_sig.
        denom = 1.0 / host_rate - dev_per_sig
        self.crossover = (
            int(t_dev_one / denom) + 1 if denom > 0 else 1 << 30
        )
        self.rates = {
            "host_sigs_per_s": host_rate,
            "device_sigs_per_s": dev_rate,
            "device_overhead_s": t_dev_one,
        }
        self.calibrated = True
        return mask_dev

    def verify_signatures(self, items):
        if not self.calibrated and len(items) >= self.calibrate_at:
            return self._calibrate(list(items))
        backend = self.device if len(items) >= self.crossover else self.host
        return backend.verify_signatures(items)

    def verify_batch(self, window):
        items = [(m.sender, m.digest(), m.signature) for m in window]
        mask = self.verify_signatures(items)
        return [bool(ok) and bool(m.signature) for ok, m in zip(mask, window)]
