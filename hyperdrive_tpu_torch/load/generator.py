"""Open-loop load generators: the sim injector and the TCP firehose.

:class:`LoadProfile` is data — the sim interprets it
(``Simulation(load=...)``): arrivals from the profile's schedule are
checked against the virtual clock at every delivered vote, and each due
arrival re-delivers the current vote to its recipient as a gossip
duplicate. Injection is *trajectory-neutral by construction*: injected
deliveries consume no virtual time, no delivery steps, and no RNG
draws, so the real message schedule — timeouts, chaos faults, reorder
swaps — is bit-identical to the unloaded run, and because duplicates
are exactly what the Process dedups (and the admission gate sheds),
the committed chain digests equal too. That is the property the chaos
overload family asserts; what overload *costs* is measured on the wall
clock (the overload bench) and on the admission counters.

:class:`TcpLoadGenerator` is the real-socket path: a thread that fires
pre-encoded frames at :class:`~hyperdrive_tpu_torch.transport.TcpNode`
listen ports on the wall clock, at the schedule's arrival times,
whether or not the node keeps up — open-loop by definition. When the
generator falls behind the schedule (the socket blocked), it does not
thin the offered load; the backlog drains as fast as the socket
allows, exactly like a real firehose peer.

Port copy of ``hyperdrive_tpu/load/generator.py``, whole. The sim's
injection point drops the reference's ``load.offered`` registry count and
``load.offered``/``load.burst`` recorder events, with the recorder and the
registry (they come back with ``obs/``).
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass

from hyperdrive_tpu_torch.load.backpressure import SHED_DUPLICATES
from hyperdrive_tpu_torch.load.schedule import BurstSchedule, PoissonSchedule

__all__ = ["LoadProfile", "LoadRuntime", "TcpLoadGenerator"]


@dataclass(frozen=True)
class LoadProfile:
    """One open-loop overload scenario for the deterministic sim.

    ``rate`` is injected duplicate votes per *virtual* second between
    ``start`` and ``stop``; ``burst > 1`` switches the arrival process
    from Poisson to periodic spikes of that size. ``admission`` wires a
    :class:`~hyperdrive_tpu_torch.load.backpressure.BackpressureController`
    (pinned at ``floor``) and per-replica admission gates onto the run;
    with it off, the same storm hits the raw Process-dedup path — the
    differential the overload bench measures. ``floor`` must stay in
    the behavior-neutral band (<= SHED_DUPLICATES) when the run's chain
    digest is compared against an unloaded baseline; the chaos family
    checks that invariant at construction.

    ``amp_cap`` bounds duplicates injected at one delivery point; when
    a virtual-clock jump makes more arrivals due at once, the excess
    stays due and drains at the next deliveries (offered load is never
    silently discarded).
    """

    rate: float
    burst: int = 1
    start: float = 0.0
    stop: float = float("inf")
    seed: int = 0
    admission: bool = True
    floor: int = SHED_DUPLICATES
    #: pin=True (digest-safe mode) holds the admission level AT the
    #: floor: live pressure signals are not coupled, so the level can
    #: never escalate into the trajectory-changing band mid-run.
    #: pin=False additionally watches the sim's device-work queue —
    #: depth/drain signals escalate freely (the bench's escalation
    #: exercise; digests may then diverge from an unloaded run).
    pin: bool = True
    amp_cap: int = 64

    def validate(self) -> None:
        if self.rate <= 0.0:
            raise ValueError(f"load rate must be positive, got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"load burst must be >= 1, got {self.burst}")
        if not 0.0 <= self.start < self.stop:
            raise ValueError(
                f"load window [{self.start}, {self.stop}) is empty"
            )
        if self.amp_cap < 1:
            raise ValueError(f"amp_cap must be >= 1, got {self.amp_cap}")

    def schedule(self):
        if self.burst > 1:
            return BurstSchedule(self.rate, burst=self.burst, seed=self.seed)
        return PoissonSchedule(self.rate, seed=self.seed)

    @classmethod
    def seeded(cls, seed: int, *, rate: float = 2000.0) -> "LoadProfile":
        """The chaos overload family's profile draw: a deterministic
        storm shape from the scenario seed — Poisson or spiky, full-run
        window — always in the behavior-neutral admission band so the
        loaded run's chain must equal the unloaded baseline's."""
        import random

        rng = random.Random((seed << 1) ^ 0x4C4F4144)
        burst = rng.choice([1, 1, 16, 64])
        return cls(
            rate=rate * rng.uniform(0.5, 2.0),
            burst=burst,
            seed=seed,
            admission=True,
            floor=SHED_DUPLICATES,
        )


class LoadRuntime:
    """The sim-side interpreter state for one :class:`LoadProfile`:
    walks the schedule's arrival stream against the virtual clock."""

    def __init__(self, profile: LoadProfile):
        profile.validate()
        self.profile = profile
        self._arrivals = iter(profile.schedule())
        self._next = next(self._arrivals) + profile.start
        self._due = 0
        #: Total arrivals handed out (the run's offered injection count).
        self.offered = 0
        #: The subset of ``offered`` the admission gate is *expected* to
        #: shed: vote duplicates whose height had not advanced past the
        #: original delivery (the sim tallies this at the injection
        #: point). Duplicated proposals and votes re-delivered after the
        #: commit edge are admitted/height-filtered by doctrine, so a
        #: bursty storm landing only there legitimately sheds nothing.
        self.sheddable = 0

    def due(self, now: float) -> int:
        """Arrivals due at virtual time ``now``, capped at ``amp_cap``
        per call (the excess stays due for the next call)."""
        p = self.profile
        if now >= p.stop:
            self._due = 0
            return 0
        while self._next <= now:
            self._due += 1
            self._next = next(self._arrivals) + p.start
        n = min(self._due, p.amp_cap)
        self._due -= n
        self.offered += n
        return n


class TcpLoadGenerator:
    """Wall-clock open-loop frame firehose at real TcpNode ports.

    ``targets`` is a list of ``(host, port)`` listen addresses;
    ``frames`` a list of pre-encoded wire frames
    (:func:`~hyperdrive_tpu_torch.transport.encode_frame` output) cycled
    round-robin — the caller decides what the storm is made of
    (duplicate prevotes for a behavior-neutral storm, fresh signed
    votes for a verification storm). One socket per target, dialed
    with bounded retries; a target that stays down just accumulates
    ``errors`` (open-loop: the storm does not care).
    """

    def __init__(
        self,
        targets,
        frames,
        schedule,
        *,
        duration: float = 1.0,
        time_fn=time.monotonic,
    ):
        if not frames:
            raise ValueError("frames must be non-empty")
        self.targets = list(targets)
        self.frames = list(frames)
        self.arrivals = schedule.arrivals(duration)
        self._time = time_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        #: Frames written / write+connect failures / max scheduling lag
        #: observed (seconds the generator ran behind its own schedule —
        #: a lag far above 0 means the *sender host* saturated, worth
        #: knowing when reading offered-load numbers).
        self.sent = 0
        self.errors = 0
        self.behind_max = 0.0
        #: Wall time the schedule started at (set when the thread runs);
        #: arrival k was offered at ``t0 + arrivals[k]`` — the reference
        #: point latency probes measure against.
        self.t0 = None

    def start(self) -> "TcpLoadGenerator":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout=None) -> None:
        self._thread.join(timeout)

    def _run(self) -> None:
        socks: dict = {}
        try:
            t0 = self.t0 = self._time()
            k = 0
            nf = len(self.frames)
            nt = len(self.targets)
            for at in self.arrivals:
                if self._stop.is_set():
                    return
                lag = (self._time() - t0) - at
                if lag < 0.0:
                    time.sleep(-lag)
                elif lag > self.behind_max:
                    self.behind_max = lag
                target = self.targets[k % nt]
                frame = self.frames[k % nf]
                k += 1
                sock = socks.get(target)
                if sock is None:
                    try:
                        sock = socket.create_connection(target, timeout=2.0)
                        sock.setsockopt(
                            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                        )
                        socks[target] = sock
                    except OSError:
                        self.errors += 1
                        continue
                try:
                    sock.sendall(frame)
                    self.sent += 1
                except OSError:
                    self.errors += 1
                    try:
                        sock.close()
                    except OSError:
                        pass
                    socks.pop(target, None)
        finally:
            for sock in socks.values():
                try:
                    sock.close()
                except OSError:
                    pass
