"""Deterministic open-loop arrival schedules.

An arrival schedule is a seeded, reproducible stream of absolute
arrival times (seconds from the schedule's epoch). Open-loop means the
stream is fixed up front: arrivals never wait on service, so offered
load can exceed capacity — the whole point of the overload harness.
Both generators (the sim injector and the wall-clock TCP firehose)
consume the same schedules, so "the same storm" can be replayed
against either path.

Everything draws from ``random.Random(seed)`` only — same seed, same
arrival times, byte for byte.

Port copy of ``hyperdrive_tpu/load/schedule.py``, whole: the arrival
lists equal the JAX package's for the same parameters.
"""

from __future__ import annotations

import random

__all__ = ["PoissonSchedule", "BurstSchedule"]


class PoissonSchedule:
    """Memoryless arrivals at ``rate`` per second (exponential gaps).

    The classic open-loop model: each inter-arrival gap is an
    independent exponential draw with mean ``1/rate``, so short-term
    bursts well above the mean rate occur naturally — the traffic shape
    that makes fixed-capacity queues interesting.
    """

    def __init__(self, rate: float, seed: int = 0):
        if rate <= 0.0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)

    def __iter__(self):
        # String seeds hash through SHA-512 inside random.seed — stable
        # across processes, unlike tuple seeding (deprecated) or hash().
        rng = random.Random(f"poisson:{self.seed}:{self.rate!r}")
        t = 0.0
        while True:
            t += rng.expovariate(self.rate)
            yield t

    def arrivals(self, horizon: float) -> list[float]:
        """Every arrival time in ``[0, horizon)``, ascending."""
        out: list[float] = []
        for t in self:
            if t >= horizon:
                break
            out.append(t)
        return out


class BurstSchedule:
    """``burst`` arrivals at once, every ``burst / rate`` seconds.

    The adversarial complement of Poisson smoothing: the same mean rate
    delivered as periodic spikes (a gossip storm, a reconnecting peer
    flushing its backlog). ``jitter`` perturbs each spike's position by
    up to that fraction of the period, seeded.
    """

    def __init__(self, rate: float, burst: int = 32, seed: int = 0,
                 jitter: float = 0.0):
        if rate <= 0.0:
            raise ValueError(f"rate must be positive, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.rate = float(rate)
        self.burst = int(burst)
        self.seed = int(seed)
        self.jitter = float(jitter)

    def __iter__(self):
        rng = random.Random(f"burst:{self.seed}:{self.burst}")
        period = self.burst / self.rate
        k = 0
        while True:
            base = k * period
            if self.jitter:
                base += period * self.jitter * rng.random()
            for _ in range(self.burst):
                yield base
            k += 1

    def arrivals(self, horizon: float) -> list[float]:
        """Every arrival time in ``[0, horizon)``, ascending."""
        out: list[float] = []
        for t in self:
            if t >= horizon:
                break
            out.append(t)
        return out
