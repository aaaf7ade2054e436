"""Shared frame classification: one vocabulary for every ingress.

Two independent paths judge an arriving consensus frame before any
protocol logic sees it: the :class:`~hyperdrive_tpu.load.backpressure.
AdmissionGate` (overload shedding) and the overlay contribution scorer
(:mod:`hyperdrive_tpu.overlay` — charging peers that relay duplicate or
stale-generation votes). Before this module each re-implemented the
duplicate / stale-height / stale-generation predicates locally, and the
two could drift — a frame the gate called a duplicate could score as
fresh coverage, silently rewarding replay spam. :func:`classify_frame`
is now the single source of truth; both callers map its verdicts onto
their own policies (shed vs. charge), never re-deriving them.

The classes form a closed vocabulary (mirroring ``SHED_CLASSES``):

``FRESH``
    admit / credit — first sighting of a live vote (or a never-shed
    kind: proposals and non-vote frames carry no dedup key at all).
``DUPLICATE``
    this ingress already saw the exact (type, sender, height, round,
    value) key.
``STALE_HEIGHT``
    the consumer's height has moved past the vote (the replica's
    height filter would drop it anyway).
``STALE_GENERATION``
    signed under an identity retired by an epoch rotation at or before
    the frame's height (epochs.py key retirement) — checked FIRST and
    for every message kind, because a retired key is invalid regardless
    of freshness.
``QUERY``
    a read-path proof query (:class:`QueryFrame` — the service port's
    TAG_QUERY ingress). Always sheddable at SHED_LOW_PRIORITY and
    above: reads are idempotent and retryable, so a read storm must
    never displace consensus traffic — certificates and precommits
    outrank queries by doctrine.

Port copy of ``hyperdrive_tpu/load/frames.py``, whole. In the port its
callers are the admission gate
(:mod:`hyperdrive_tpu_torch.load.backpressure`), the overlay's
contribution scorer (:mod:`hyperdrive_tpu_torch.overlay`) and the
stale-generation filter on
:class:`~hyperdrive_tpu_torch.transport.TcpNode`'s wire ingress.
"""

from __future__ import annotations

from dataclasses import dataclass

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose

__all__ = [
    "FRESH",
    "DUPLICATE",
    "STALE_HEIGHT",
    "STALE_GENERATION",
    "QUERY",
    "FRAME_CLASSES",
    "QueryFrame",
    "MetricsFrame",
    "classify_frame",
]

FRESH = "fresh"
DUPLICATE = "duplicate"
STALE_HEIGHT = "stale_height"
STALE_GENERATION = "stale_generation"
QUERY = "query"

#: The closed classification vocabulary, in check order.
FRAME_CLASSES = (STALE_GENERATION, QUERY, STALE_HEIGHT, DUPLICATE, FRESH)


@dataclass(frozen=True)
class QueryFrame:
    """One proof query at an admission gate: the lightweight stand-in
    the service port classifies before any ledger work happens. Carries
    no sender identity (stateless clients are anonymous to the gate —
    fairness attribution uses the connection's tenant as ``peer``)."""

    account: int
    height: int = -1
    round: int = -1
    sender: bytes | None = None


@dataclass(frozen=True)
class MetricsFrame:
    """One live-metrics scrape at an admission gate: the service
    port's TAG_METRICS ingress. Classified WITH proof queries (QUERY)
    — a scrape is an idempotent, retryable read, and the
    observability plane must be the first thing shed under load,
    never a reason consensus traffic queues."""

    height: int = -1
    round: int = -1
    sender: bytes | None = None


#: Message-type tags for dedup keys (stable across runs, unlike id()).
_TAG = {Propose: 0, Prevote: 1, Precommit: 2}


def classify_frame(msg, *, seen=None, height_fn=None, retired=None):
    """Classify one frame; returns ``(cls, key)``.

    ``seen`` is the caller's dedup memory (any container supporting
    ``in`` over keys), ``height_fn`` supplies the consumer's current
    height, ``retired`` maps retired signatory -> first stale height
    (the sim / TcpNode shared retirement bound). Each is optional —
    an unsupplied signal simply never triggers its class, so callers
    opt into exactly the checks their ingress owns.

    ``key`` is the stable dedup key ``(tag, sender, height, round,
    value)`` for vote frames, or None for never-shed kinds (proposals,
    certificates, unknown types) — those classify FRESH by doctrine
    (aggregates outrank raw votes; there is exactly one legitimate
    proposal per round) and have nothing to remember.
    """
    sender = getattr(msg, "sender", None)
    if retired and sender is not None:
        bad_from = retired.get(sender)
        if bad_from is not None and getattr(msg, "height", -1) >= bad_from:
            return STALE_GENERATION, None
    t = type(msg)
    if t is QueryFrame:
        # Reads carry a key (so the gate treats them as sheddable) but
        # are never deduplicated: an identical re-query after a shed is
        # the client doing exactly what the retry doctrine tells it to.
        return QUERY, ("query", msg.account)
    if t is MetricsFrame:
        # Metrics scrapes are the same read-path class: sheddable
        # first, never deduplicated (a re-scrape after a shed is the
        # scraper's retry loop working as designed).
        return QUERY, ("metrics",)
    tag = _TAG.get(t)
    if tag is None or t is Propose:
        return FRESH, None
    key = (tag, sender, msg.height, msg.round, msg.value)
    if height_fn is not None and msg.height < height_fn():
        return STALE_HEIGHT, key
    if seen is not None and key in seen:
        return DUPLICATE, key
    return FRESH, key
