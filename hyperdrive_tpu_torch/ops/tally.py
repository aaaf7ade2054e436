"""Quorum tallies as masked reductions over vote tensors.

The reference's four hot loops scan Go maps per received message —
O(n) per vote, O(n^2) per round per replica
(reference: process/process.go:487-491, 574-579, 626-631, 696-701). Here a
round's votes live in a dense tensor ``[rounds, validators, words]`` and
every rule's count is one masked equality + sum reduction, batched over all
in-flight rounds at once.

Port of ``hyperdrive_tpu/ops/tally.py``: the packers stay numpy (``<i4``
words, so a value byte of 0x80 or more gives a negative word), the counts
are PyTorch ops on tensors of any device. The sharded steps sum these
counts over a mesh's ``val`` group
(:mod:`hyperdrive_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "VALUE_WORDS",
    "pack_value",
    "pack_values",
    "tally_counts",
    "quorum_flags",
]

#: A 32-byte value packs into eight int32 words.
VALUE_WORDS = 8


def pack_value(value: bytes) -> np.ndarray:
    """32-byte value -> [8] int32 (little-endian words)."""
    if len(value) != 32:
        raise ValueError("value must be 32 bytes")
    return np.frombuffer(value, dtype="<i4").astype(np.int32)


def pack_values(values) -> np.ndarray:
    """Iterable of 32-byte values -> [n, 8] int32."""
    return np.stack([pack_value(v) for v in values])


def tally_counts(
    vote_values: torch.Tensor,  # [R, V, 8] int32 — per-round per-validator vote
    present: torch.Tensor,  # [R, V] bool — vote exists AND signature verified
    target_values: torch.Tensor,  # [R, 8] int32 — the proposal value per round
):
    """All per-round counts the consensus rules need, in one pass.

    Returns a dict of [R] int32 tensors:
      - ``matching``:  votes equal to the round's target value   (L36/L28/L49)
      - ``nil``:       votes for the nil value                   (L44)
      - ``total``:     votes present at all                      (L34/L47)
    """
    eq_target = (vote_values == target_values[:, None, :]).all(dim=-1)
    eq_nil = (vote_values == 0).all(dim=-1)
    return {
        "matching": (eq_target & present).sum(dim=-1, dtype=torch.int32),
        "nil": (eq_nil & present).sum(dim=-1, dtype=torch.int32),
        "total": present.sum(dim=-1, dtype=torch.int32),
    }


def quorum_flags(counts: dict, f):
    """Threshold the counts: 2f+1 quorums and skip-target eligibility.

    ``f`` is an int or a [R] int32 tensor. Returns a dict of [R] bool
    tensors keyed by the paper rules they open. ``skip_eligible`` is only
    the *count* half of rule L55 (>= f+1 unique participants in the round);
    the consumer must additionally require ``round > current_round`` —
    flagging the current round itself would break liveness.
    """
    q = 2 * f + 1
    return {
        "quorum_matching": counts["matching"] >= q,  # L36 / L28 / L49
        "quorum_nil": counts["nil"] >= q,  # L44
        "quorum_any": counts["total"] >= q,  # L34 / L47
        "skip_eligible": counts["total"] >= f + 1,  # L55, count half only
    }
