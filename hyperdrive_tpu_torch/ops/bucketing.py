"""Static-shape bucket selection, shared by every padded device launch.

XLA compiles one executable per input shape, so variable-size batches are
padded up to a small ladder of precompiled bucket sizes; batches beyond
the largest bucket round up to its next multiple (large launches amortize
the padding, and chunked callers split on the largest bucket anyway).
One policy, one place — the Ed25519 packer, the vote grid, and any future
padded launch must agree or they recompile/pad inconsistently.
"""

from __future__ import annotations

import math

__all__ = ["bucket_for", "launch_target", "would_spill"]


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket holding ``n``, else the next multiple of the
    largest. ``buckets`` must be sorted ascending and non-empty."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return math.ceil(n / top) * top


def launch_target(buckets, default: int = 4096) -> int:
    """Preferred lanes-per-launch: the ladder's largest bucket (chunked
    callers split on it, coalescing callers aim to fill it), or
    ``default`` when the verifier exposes no ladder (HostVerifier).
    The one number the Ed25519 chunker, the settle-pass grouping, and
    the devsched slot-close rule must agree on."""
    return buckets[-1] if buckets else default


def would_spill(rows: int, add: int, buckets) -> bool:
    """True when growing a padded batch from ``rows`` by ``add`` lanes
    crosses a bucket boundary. Padded launches cost by bucket, not by
    fill — the devsched spill rule drains the queue rather than cross
    (harness/sim.py speculative settle); any coalescer sharing the
    ladder should make the same call here."""
    if not buckets or not rows:
        return False
    return bucket_for(rows + add, buckets) > bucket_for(rows, buckets)
