"""Timeout scheduling with linear round scaling.

Capability parity with the reference's ``timer/timer.go``: a
:class:`LinearTimer` schedules propose/prevote/precommit timeouts whose
duration grows linearly with the round (``timeout * (1 + round * scaling)``),
delivering a :class:`~hyperdrive_tpu_torch.messages.Timeout` event to an injected
handler when the deadline passes.

Two implementations are provided:

- :class:`LinearTimer` — wall-clock, one daemon ``threading.Timer`` per
  scheduled timeout (the analogue of the reference's goroutine-per-timeout,
  timer/timer.go:88-92). For production-style use.
- :class:`VirtualTimer` — deterministic simulated time for the test/bench
  harness: deadlines go into a heap owned by a
  :class:`~hyperdrive_tpu_torch.harness.sim.VirtualClock`; the simulator advances
  time explicitly, so runs are reproducible and fast. This is this
  framework's answer to the reference's real-sleep test timers.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional

from hyperdrive_tpu_torch.messages import Timeout
from hyperdrive_tpu_torch.types import Height, MessageType, Round

__all__ = ["LinearTimer", "VirtualTimer", "DEFAULT_TIMEOUT", "DEFAULT_TIMEOUT_SCALING"]

#: Default base timeout in seconds (reference: timer/opt.go:10-11).
DEFAULT_TIMEOUT = 20.0
#: Default linear scaling factor per round (reference: timer/opt.go:13-14).
DEFAULT_TIMEOUT_SCALING = 0.5

TimeoutHandler = Callable[[Timeout], None]


def _shaped_duration(
    timeout: float,
    scaling: float,
    round: Round,
    max_timeout: "float | None",
    jitter: float,
    rng: "random.Random | None",
) -> float:
    """The shared duration policy behind both timer implementations.

    Base law: ``timeout * (1 + round * scaling)`` (reference:
    timer/timer.go:120-122). Two optional shapers, both OFF by default
    so existing deployments and every recorded sim trajectory are
    untouched:

    - ``max_timeout`` caps the linear growth — unbounded, a long stall
      (a partition lasting many rounds) leaves replicas waiting
      arbitrarily long after conditions recover.
    - ``jitter`` stretches each duration by a uniform factor in
      ``[1, 1 + jitter)`` — identical deterministic timeouts expire in
      lockstep across replicas, synchronizing their round changes and
      re-proposals into colliding bursts; per-replica jitter (pass each
      replica its own seeded ``rng``) desynchronizes them.

    The cap applies BEFORE jitter, so the effective ceiling is
    ``max_timeout * (1 + jitter)`` and jitter keeps working (stays
    non-lockstep) even for capped rounds.
    """
    d = timeout + timeout * round * scaling
    if max_timeout is not None and d > max_timeout:
        d = max_timeout
    if jitter:
        d += d * jitter * (rng or random).random()
    return d


class LinearTimer:
    """Wall-clock timer: spawns a daemon thread per scheduled timeout."""

    def __init__(
        self,
        handle_timeout_propose: Optional[TimeoutHandler] = None,
        handle_timeout_prevote: Optional[TimeoutHandler] = None,
        handle_timeout_precommit: Optional[TimeoutHandler] = None,
        timeout: float = DEFAULT_TIMEOUT,
        timeout_scaling: float = DEFAULT_TIMEOUT_SCALING,
        max_timeout: "float | None" = None,
        jitter: float = 0.0,
        rng: "random.Random | None" = None,
    ):
        self._handle_propose = handle_timeout_propose
        self._handle_prevote = handle_timeout_prevote
        self._handle_precommit = handle_timeout_precommit
        self.timeout = timeout
        self.timeout_scaling = timeout_scaling
        self.max_timeout = max_timeout
        self.jitter = jitter
        self._rng = rng

    def duration_at(self, height: Height, round: Round) -> float:
        """Timeout duration for a (height, round)
        (reference: timer/timer.go:120-122), optionally capped and
        jittered — see :func:`_shaped_duration`."""
        return _shaped_duration(
            self.timeout,
            self.timeout_scaling,
            round,
            self.max_timeout,
            self.jitter,
            self._rng,
        )

    def _spawn(self, handler: TimeoutHandler, ty: MessageType, h: Height, r: Round):
        t = threading.Timer(
            self.duration_at(h, r),
            handler,
            args=(Timeout(message_type=ty, height=h, round=r),),
        )
        t.daemon = True
        t.start()

    def timeout_propose(self, height: Height, round: Round) -> None:
        if self._handle_propose is not None:
            self._spawn(self._handle_propose, MessageType.PROPOSE, height, round)

    def timeout_prevote(self, height: Height, round: Round) -> None:
        if self._handle_prevote is not None:
            self._spawn(self._handle_prevote, MessageType.PREVOTE, height, round)

    def timeout_precommit(self, height: Height, round: Round) -> None:
        if self._handle_precommit is not None:
            self._spawn(self._handle_precommit, MessageType.PRECOMMIT, height, round)


class VirtualTimer:
    """Simulated-time timer for the deterministic harness.

    Schedules deadlines on a clock object exposing
    ``schedule(delay: float, event: Timeout, handler) -> None``; the harness
    decides when virtual time advances and then invokes ``handler(event)``
    (or routes the event itself when ``handler`` is None).
    """

    def __init__(
        self,
        clock,
        handler: Optional[TimeoutHandler] = None,
        timeout: float = 1.0,
        timeout_scaling: float = DEFAULT_TIMEOUT_SCALING,
        max_timeout: "float | None" = None,
        jitter: float = 0.0,
        rng: "random.Random | None" = None,
    ):
        self._clock = clock
        self._handler = handler
        self.timeout = timeout
        self.timeout_scaling = timeout_scaling
        self.max_timeout = max_timeout
        self.jitter = jitter
        #: Jittered virtual timers MUST get a seeded per-replica rng or
        #: the harness's determinism (record/replay, fixed-seed digests)
        #: breaks; the harness owns that wiring.
        self._rng = rng

    def duration_at(self, height: Height, round: Round) -> float:
        return _shaped_duration(
            self.timeout,
            self.timeout_scaling,
            round,
            self.max_timeout,
            self.jitter,
            self._rng,
        )

    def _schedule(self, ty: MessageType, h: Height, r: Round) -> None:
        self._clock.schedule(
            self.duration_at(h, r),
            Timeout(message_type=ty, height=h, round=r),
            self._handler,
        )

    def timeout_propose(self, height: Height, round: Round) -> None:
        self._schedule(MessageType.PROPOSE, height, round)

    def timeout_prevote(self, height: Height, round: Round) -> None:
        self._schedule(MessageType.PREVOTE, height, round)

    def timeout_precommit(self, height: Height, round: Round) -> None:
        self._schedule(MessageType.PRECOMMIT, height, round)
