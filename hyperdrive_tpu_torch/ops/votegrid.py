"""Device-resident vote grids: the consensus tally state lives on device.

The reference scans Go maps per received vote (reference:
process/process.go:487-491, 574-579, 626-631, 696-701); here the
*accumulated* per-replica vote state is a persistent device tensor, so
every settle pass is one merge + one reduction for the whole network:

- ``values [n, 2, R, V, 8]`` int32 — per replica, per vote plane
  (0=prevote, 1=precommit), per round slot, per validator, the 32-byte
  vote value as eight little-endian words;
- ``present [n, 2, R, V]`` bool — vote exists, passed signature
  verification, and survived the host automaton's duplicate/equivocation
  filters (only *accepted* inserts are written, so the grid is exactly
  the device image of ``State.prevote_logs``/``precommit_logs``).

:meth:`VoteGrid.update_and_tally` scatters one superstep's accepted votes
for ALL replicas and returns every per-round count the rule cascade needs
(L28/L34/L36/L44/L47/L49); :meth:`VoteGrid.fused_update_and_tally`
verifies the shared window's signatures, merges the verified votes and
tallies behind one upload and one download. The grids update in place on
their device; the host only ever sees the small count tensors.

Capacity: round slots cover rounds ``0..R-1`` of each replica's current
height. Rounds beyond the window are not covered; the cascade falls back
to the host counters for those rounds, which remain authoritative.

Port of ``hyperdrive_tpu/ops/votegrid.py``. The three device programs
(``_kernel``, ``_tally``, ``_fused_kernel``) are PyTorch ops; inside the
fused path the signatures are verified by the verify callable the caller
attaches (``TorchBatchVerifier.fused_inner``: the hand-written row 1
kernel on a CUDA tensor), on the same stream as the merge, with no host
round trip between them. ``mesh=`` (a ("hr", "val") mesh of ranks from
:func:`~hyperdrive_tpu_torch.parallel.mesh.make_mesh`) shards the
validator axis: each rank holds ``[n, 2, R, V/val, ...]``, keeps the
scatter rows of its own validator range, and sums the partial counts over
the ``val`` group with one all-reduce inside every
:meth:`VoteGrid.update_and_tally` call (never at the deferred fetch, which
a rank skips when no rule reads its counts). Differences from the
reference: the sharded grid sums the packed counts in one all-reduce
where the reference has four ``psum``; the scatter keeps only the
``valid`` rows where XLA dropped out-of-range ones (``mode="drop"``),
because PyTorch raises on an out-of-range index; every launch's host inputs go up in one
copy; the unused ``f`` argument of ``_kernel``/``_tally`` is gone (quorum
flags are derived on the host, as in the reference, from an ``f`` that
stays on the host, so the reference's ``"f rides the count fetch"``
fetch has no counterpart). The mask and count copies go through
:func:`~hyperdrive_tpu_torch.analysis.annotations.device_fetch` with the
reference's ``why``; the fused call's wait for its pinned copy is inside
that fetch.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from hyperdrive_tpu_torch.analysis.annotations import device_fetch
from hyperdrive_tpu_torch.ops import bucketing
from hyperdrive_tpu_torch.ops.ed25519 import _resolve_device
from hyperdrive_tpu_torch.types import NIL_VALUE

__all__ = [
    "PREVOTE_PLANE",
    "PRECOMMIT_PLANE",
    "VoteGrid",
    "TallyView",
    "CheckedTallyView",
    "LazyCounts",
]

PREVOTE_PLANE = 0
PRECOMMIT_PLANE = 1


class TallyView:
    """One replica's slice of a :class:`VoteGrid` launch result — the
    object ``Process.ingest_cascade`` consults for quorum thresholds.

    The view answers a count query ONLY when the launch provably tallied
    that exact query; otherwise it returns None and the Process falls back
    to its host counters. Declines happen for: rounds outside the slot
    window, rounds marked dirty (a vote couldn't be scattered — unknown
    sender), target values the launch didn't compare against, and any
    query after the replica's height moved past :attr:`height`.
    """

    __slots__ = ("rep", "height", "counts", "R", "targets",
                 "l28_round", "l28_value", "dirty")

    def __init__(self, rep: int, height: int, counts: Mapping, r_slots: int,
                 targets: dict, l28_round: int, l28_value: bytes,
                 dirty=frozenset()):
        self.rep = rep
        self.height = height
        self.counts = counts
        self.R = r_slots
        #: round -> the 32-byte proposal value the launch used as that
        #: round's matching target.
        self.targets = targets
        self.l28_round = l28_round
        self.l28_value = l28_value
        self.dirty = dirty

    def _covered(self, plane: int, rnd: int) -> bool:
        return 0 <= rnd < self.R and (plane, rnd) not in self.dirty

    def _matching(self, plane: int, rnd: int, value: bytes):
        if not self._covered(plane, rnd):
            return None
        if self.targets.get(rnd) == value:
            return int(self.counts["matching"][self.rep, plane, rnd])
        if value == NIL_VALUE:
            return int(self.counts["nil"][self.rep, plane, rnd])
        return None

    def prevotes_for(self, rnd: int, value: bytes):
        c = self._matching(PREVOTE_PLANE, rnd, value)
        if c is not None:
            return c
        # The L28 cross-round lane: prevotes at the current proposal's
        # valid_round compared against the current proposal's value.
        if (
            rnd == self.l28_round
            and value == self.l28_value
            and self._covered(PREVOTE_PLANE, rnd)
        ):
            return int(self.counts["l28"][self.rep])
        return None

    def precommits_for(self, rnd: int, value: bytes):
        return self._matching(PRECOMMIT_PLANE, rnd, value)

    def prevote_total(self, rnd: int):
        if not self._covered(PREVOTE_PLANE, rnd):
            return None
        return int(self.counts["total"][self.rep, PREVOTE_PLANE, rnd])

    def precommit_total(self, rnd: int):
        if not self._covered(PRECOMMIT_PLANE, rnd):
            return None
        return int(self.counts["total"][self.rep, PRECOMMIT_PLANE, rnd])


def _kernel(values, present, reset, idx, words, valid,
            targets, target_valid, l28_slot, l28_target, v_lo=None):
    """One scatter + tally step, updating ``values`` and ``present`` in
    place; returns the packed counts (see :func:`_tally`).

    values [n,2,R,V,8] int32, present [n,2,R,V] bool, reset [n] bool —
    zero a replica's planes before scattering (height advanced), idx [k,4]
    int32 rows (replica, plane, slot, validator), words [k,8] int32 vote
    values, valid [k] bool (padding mask), targets [n,R,8] int32 per-round
    proposal values, target_valid [n,R] bool, l28_slot [n] int32
    (valid-round slot for the L28 cross-round count, or -1), l28_target
    [n,8] int32 (the *current* round's proposal value). The host
    guarantees at most one valid row per lane.

    Sharded mode (``v_lo`` set): V is this rank's shard, the rows carry
    GLOBAL validator indices, and the rank keeps only the rows of its
    range ``[v_lo, v_lo + V)``.
    """
    n, _, R, V, _ = values.shape
    if v_lo is not None:
        vloc = idx[:, 3] - v_lo
        valid = valid & (vloc >= 0) & (vloc < V)
        idx = torch.cat([idx[:, :3], vloc[:, None]], dim=1)
    present.logical_and_(~reset[:, None, None, None])
    idx = idx[valid].long()
    lane = ((idx[:, 0] * 2 + idx[:, 1]) * R + idx[:, 2]) * V + idx[:, 3]
    values.view(-1, 8)[lane] = words[valid]
    present.view(-1)[lane] = True
    return _tally(values, present, targets, target_valid, l28_slot, l28_target)


def _tally(values, present, targets, target_valid, l28_slot, l28_target):
    """The reduction shared by both grid programs: per-(replica, plane,
    round) matching/nil/total counts and the L28 cross-round lane, packed
    into ONE int32 tensor (one device-to-host copy). Layout: [n, 2*R*3 + 1]
    = [n, 2, R, 3] (matching, nil, total) flattened, then the L28 count
    per replica. Quorum flags are derived on the host (:class:`LazyCounts`)."""
    n, _, R, _, _ = values.shape
    eq_target = (
        (values == targets[:, None, :, None, :]).all(dim=-1)
        & target_valid[:, None, :, None]
    )
    eq_nil = (values == 0).all(dim=-1)  # NIL_VALUE is 32 zero bytes
    matching = (eq_target & present).sum(dim=-1, dtype=torch.int32)
    nil = (eq_nil & present).sum(dim=-1, dtype=torch.int32)
    total = present.sum(dim=-1, dtype=torch.int32)

    # L28 cross-round count: prevotes at the CURRENT proposal's valid_round
    # matching the CURRENT proposal's value (the per-round targets above
    # compare round r's votes against round r's own proposal).
    slot_ok = torch.arange(R, device=values.device)[None, :] == l28_slot[:, None]
    eq28 = (
        (values[:, PREVOTE_PLANE] == l28_target[:, None, None, :]).all(dim=-1)
        & present[:, PREVOTE_PLANE]
        & slot_ok[:, :, None]
    )
    l28 = eq28.sum(dim=(1, 2), dtype=torch.int32)  # [n]
    three = torch.stack([matching, nil, total], dim=-1)  # [n, 2, R, 3]
    return torch.cat([three.reshape(n, -1), l28[:, None]], dim=1)


def _fused_kernel(verify_inner, values, present,
                  ax, ay, at, rx, ry, s_nib, k_nib, side):
    """Verification + merge + tally behind one upload: ``values`` and
    ``present`` update in place; returns ONE flat int32 tensor, the mask
    [B] then the packed counts.

    ``verify_inner``: the batch verify callable ((ax..k_nib) -> bool[B]),
    run on the same stream as the merge. The update is a DENSE
    one-superstep image of the shared window (every lockstep replica
    receives the same broadcasts), merged by three elementwise passes over
    the grid. ``side`` is one flat int32 tensor, layout (sizes static from
    the grid shape): upd_lane [2*R*V] | upd_vals [2*R*V*8] | rep_meta [n*4]
    | tpack [n*(R*8+R+8)], where

    - ``upd_lane [2, R, V]``: the verify lane whose verdict gates the
      lane's update, -1 where the window has no vote for that lane
      (duplicate/conflicting claims are resolved host-side; conflicts
      poison the round via the dirty set).
    - ``upd_vals [2, R, V, 8]``: the vote value per updated lane.
    - ``rep_meta [n, 4]``: reset, participate, l28_slot, f.
    - ``tpack [n, R*8 + R + 8]``: per-round target words | target-valid |
      the L28 target words.

    Writes are presence-guarded — an existing vote in a lane always wins,
    reproducing the host logs' first-wins rule — so per-replica grids stay
    exactly equal to the host automaton's accepted inserts without
    per-replica update tensors.
    """
    n, _, R, V, _ = values.shape
    mask = verify_inner(ax, ay, at, rx, ry, s_nib, k_nib)  # [B] bool
    lanes = 2 * R * V
    o1 = lanes
    o2 = o1 + lanes * 8
    o3 = o2 + n * 4
    upd_lane = side[:o1].view(2, R, V)
    upd_vals = side[o1:o2].view(2, R, V, 8)
    rep_meta = side[o2:o3].view(n, 4)
    tpack = side[o3:].view(n, R * 8 + R + 8)
    reset = rep_meta[:, 0].bool()
    participate = rep_meta[:, 1].bool()
    l28_slot = rep_meta[:, 2]
    targets = tpack[:, : R * 8].reshape(n, R, 8)
    target_valid = tpack[:, R * 8 : R * 8 + R].bool()
    l28_target = tpack[:, R * 8 + R :]

    has = upd_lane >= 0
    upd_ok = has & mask[torch.where(has, upd_lane, 0).long()]  # [2, R, V]
    present.logical_and_(~reset[:, None, None, None])
    write = (
        upd_ok[None]
        & participate[:, None, None, None]
        & ~present  # presence guard: existing votes win
    )  # [n, 2, R, V]
    torch.where(write[..., None], upd_vals[None], values, out=values)
    present.logical_or_(write)
    packed = _tally(values, present, targets, target_valid, l28_slot, l28_target)
    return torch.cat([mask.to(torch.int32), packed.reshape(-1)])


class CheckedTallyView:
    """Differential instrumentation: wraps a :class:`TallyView` and
    cross-checks every device-sourced count against the host counters
    before returning it — a mismatch raises. Tests and ``chip_smoke.py``
    install it (``Simulation(tally_check=CheckedTallyView)``) to certify
    that device-tally runs are count-for-count identical to host runs.
    ``hits`` counts answered queries so a caller can assert the device
    path was actually exercised rather than silently falling back."""

    __slots__ = ("view", "proc", "height", "hits")

    def __init__(self, view: TallyView, proc):
        self.view = view
        self.proc = proc
        self.height = view.height
        self.hits = 0

    def _check(self, device, host, what):
        if device is None:
            return None
        self.hits += 1
        if device != host:
            raise AssertionError(
                f"device {what} count {device} != host {host} "
                f"(replica {self.view.rep}, height {self.height})"
            )
        return device

    def prevotes_for(self, rnd, value):
        return self._check(
            self.view.prevotes_for(rnd, value),
            self.proc.state.count_prevotes_for(rnd, value),
            f"prevote[r={rnd}]",
        )

    def precommits_for(self, rnd, value):
        return self._check(
            self.view.precommits_for(rnd, value),
            self.proc.state.count_precommits_for(rnd, value),
            f"precommit[r={rnd}]",
        )

    def prevote_total(self, rnd):
        return self._check(
            self.view.prevote_total(rnd),
            len(self.proc.state.prevote_logs.get(rnd, {})),
            f"prevote_total[r={rnd}]",
        )

    def precommit_total(self, rnd):
        return self._check(
            self.view.precommit_total(rnd),
            len(self.proc.state.precommit_logs.get(rnd, {})),
            f"precommit_total[r={rnd}]",
        )


class VoteGrid:
    """Persistent device grids for ``n`` replicas × ``validators`` senders,
    on ``device`` (the card unless the caller passes ``device="cpu"``).

    One instance serves a whole simulated network. Call
    :meth:`update_and_tally` (or, with a verify callable attached,
    :meth:`fused_update_and_tally`) once per settle pass; it returns a
    :class:`LazyCounts` mapping of per-(replica, plane, slot) counts whose
    host copy is deferred to first value access.

    Memory: ``values [n, 2, R, V, 8] int32`` + ``present [n, 2, R, V]
    bool`` = ``n * 2 * R * V * 33`` bytes; 17.3 MB at n = V = 256, R = 4.
    The n × V product is a simulation artifact (one process carrying every
    replica's grid); a deployed replica holds n = 1. ``mesh=`` shards the
    VALIDATOR axis over the mesh's ``val_axis`` (V must divide evenly):
    each rank holds V/val validators' lanes on its mesh device, scatter
    rows route by global index, counts sum over the axis; the fused path
    is single-device.
    """

    def __init__(self, n_replicas: int, n_validators: int, r_slots: int = 8,
                 buckets: tuple = (256, 1024, 4096, 16384),
                 mesh=None, val_axis: str = "val", device=None):
        self.n = n_replicas
        self.V = n_validators
        self.R = r_slots
        self._all_slots = frozenset(
            (p, r) for p in (0, 1) for r in range(r_slots)
        )
        self.buckets = tuple(sorted(buckets))
        self._fused = None
        self._mesh = mesh
        #: This rank's validator range [_v_lo, _v_lo + _v_local) and the
        #: process group its partial counts sum over (None: one device).
        self._v_lo, self._v_local, self._group = 0, n_validators, None
        if mesh is None:
            self.device = _resolve_device(device)
        else:
            # The validator axis shards over `val_axis`: each rank owns its
            # validators' grid lanes, scatter rows route by global index,
            # counts sum over the axis's group. Everything else (reset
            # masks, targets, counts) is the same on every rank.
            from hyperdrive_tpu_torch.parallel.mesh import axis_group, mesh_device

            d = mesh.shape[mesh.mesh_dim_names.index(val_axis)]
            if n_validators % d:
                raise ValueError(
                    f"validators ({n_validators}) must divide evenly over "
                    f"the '{val_axis}' axis ({d} devices)"
                )
            self.device = mesh_device(mesh)
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != self.device.type or want.index
                                     not in (None, self.device.index)):
                raise ValueError(f"device {device} is not this rank's mesh "
                                 f"device {self.device}")
            self._v_local = n_validators // d
            self._v_lo = mesh.get_local_rank(val_axis) * self._v_local
            self._group = axis_group(mesh, val_axis)
        self._values = torch.zeros(
            (n_replicas, 2, r_slots, self._v_local, 8), dtype=torch.int32,
            device=self.device,
        )
        self._present = torch.zeros(
            (n_replicas, 2, r_slots, self._v_local), dtype=torch.bool,
            device=self.device,
        )

    def bucket_for(self, k: int) -> int:
        return bucketing.bucket_for(k, self.buckets)

    def all_slots(self) -> frozenset:
        """Every (plane, round-slot) pair this grid serves — the full
        poison set. A host-routed settle that cannot say which slots it
        bypassed (a whole-height claim, or the hysteresis rebuild after a
        disengaged stretch) marks all of them dirty: TallyView then
        declines every query for the claimed height and the cascade reads
        its always-complete host fallback, while the next height's reset
        starts the grid clean."""
        return self._all_slots

    def _upload(self, parts) -> list:
        """numpy arrays -> int32 tensors of the same shapes on the grid's
        device, through ONE host-to-device copy (from pinned memory on the
        card, without blocking the host)."""
        sizes = [a.size for a in parts]
        host = torch.empty(
            sum(sizes), dtype=torch.int32, pin_memory=self.device.type == "cuda"
        )
        buf = host.numpy()
        o = 0
        for a, size in zip(parts, sizes):
            buf[o : o + size] = a.reshape(-1)
            o += size
        flat = host.to(self.device, non_blocking=True)
        out = []
        o = 0
        for a, size in zip(parts, sizes):
            out.append(flat[o : o + size].view(a.shape))
            o += size
        return out

    # ------------------------------------------------------------ fused path

    def attach_fused(self, inner_factory) -> None:
        """Install the batch-verify factory (``batch -> verify callable``,
        e.g. ``TorchBatchVerifier.fused_inner``) and enable
        :meth:`fused_update_and_tally` (single-device grids only: a
        sharded grid keeps the two-launch path)."""
        if self._mesh is not None:
            raise ValueError("fused path is single-chip; sharded grids "
                             "use update_and_tally")
        self._fused = inner_factory

    def fused_update_and_tally(self, verify_arrays, upd_lane, upd_vals,
                               reset, participate,
                               targets, target_valid, l28_slot, l28_target,
                               f):
        """One launch sequence on one stream: verify the packed signature
        batch, merge the shared window's vote lanes (gated by the
        verification mask) into every participating replica's grid, tally.
        Returns a :class:`_FusedOut` whose ``mask()`` is the settle's one
        blocking sync and whose ``counts()`` ride the same copy.

        ``verify_arrays``: the packer's (ax, ay, at, rx, ry, s_nib, k_nib),
        numpy, already padded to a bucket size B. ``upd_lane [2, R, V]`` /
        ``upd_vals [2, R, V, 8]``: the dense one-superstep update image
        (see :func:`_fused_kernel`). All of it goes up in one copy, and
        mask and counts come back in one copy into pinned memory, started
        at once."""
        if self._fused is None:
            raise RuntimeError("attach_fused() was not called on this grid")
        b = verify_arrays[0].shape[0]
        n, R, V = self.n, self.R, self.V
        lanes = 2 * R * V
        tw = R * 8 + R + 8
        side = np.empty(lanes * 9 + n * (4 + tw), dtype=np.int32)
        o1 = lanes
        o2 = o1 + lanes * 8
        o3 = o2 + n * 4
        side[:o1] = upd_lane.reshape(-1)
        side[o1:o2] = upd_vals.reshape(-1)
        rep_meta = side[o2:o3].reshape(n, 4)
        rep_meta[:, 0] = reset
        rep_meta[:, 1] = participate
        rep_meta[:, 2] = l28_slot
        rep_meta[:, 3] = f
        tpack = side[o3:].reshape(n, tw)
        tpack[:, : R * 8] = targets.reshape(n, R * 8)
        tpack[:, R * 8 : R * 8 + R] = target_valid
        tpack[:, R * 8 + R :] = l28_target
        *arrays, side_t = self._upload([*verify_arrays, side])
        out = _fused_kernel(
            self._fused(b), self._values, self._present, *arrays, side_t
        )
        done = None
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = host
        return _FusedOut(out, done, b, n, R, np.asarray(f))

    def update_and_tally(self, idx, words, reset, targets, target_valid,
                         l28_slot, l28_target, f):
        """Scatter accepted votes, reduce, return the counts.

        idx [k,4] int32 (replica, plane, slot, validator) — the host
        automaton guarantees at most one row per lane per call (duplicate
        and equivocating votes are rejected before scatter); words [k,8]
        int32; remaining args as in :func:`_kernel` (numpy, host-built per
        settle), f [n] int32. The rows are padded to a bucket of
        :attr:`buckets`. Returns a :class:`LazyCounts` (dict-like; the
        device-to-host copy happens on first key access).

        On a sharded grid ``idx`` carries GLOBAL validator indices: each
        rank keeps the rows of its own range, and the partial counts sum
        over the ``val`` group in one all-reduce launched here, on every
        call, so every rank joins it whether or not a rule later reads
        the counts.
        """
        k = len(idx)
        b = self.bucket_for(max(k, 1))
        pad_idx = np.zeros((b, 4), dtype=np.int32)
        pad_words = np.zeros((b, 8), dtype=np.int32)
        valid = np.zeros(b, dtype=np.int32)
        if k:
            pad_idx[:k] = idx
            pad_words[:k] = words
            valid[:k] = 1
        (reset_t, idx_t, words_t, valid_t, targets_t, tvalid_t, l28s_t,
         l28t_t) = self._upload([
            np.asarray(reset), pad_idx, pad_words, valid, np.asarray(targets),
            np.asarray(target_valid), np.asarray(l28_slot),
            np.asarray(l28_target),
        ])
        packed = _kernel(
            self._values, self._present, reset_t.bool(), idx_t, words_t,
            valid_t.bool(), targets_t, tvalid_t.bool(), l28s_t, l28t_t,
            v_lo=None if self._group is None else self._v_lo,
        )
        if self._group is not None:
            import torch.distributed as dist

            dist.all_reduce(packed, group=self._group)
        return LazyCounts(packed, self.n, self.R, np.asarray(f))


class _PinnedCopy:
    """A device-to-host copy in flight into pinned memory: converting it
    to an array (``np.asarray``, and so :func:`device_fetch`) waits for the
    copy's event and returns a private copy (the pinned buffer goes back
    to the allocator)."""

    __slots__ = ("_host", "_done")

    def __init__(self, host, done):
        self._host = host
        self._done = done

    def __array__(self, dtype=None, copy=None):
        if self._done is not None:
            self._done.synchronize()
        out = self._host.numpy().copy()
        return out if dtype is None else out.astype(dtype)


class _FusedOut:
    """One fused launch's flat output, already on its way to pinned host
    memory: ``mask()`` waits for that copy (the settle's single blocking
    sync) and returns the verification mask; ``counts()`` wraps the
    already-copied tail as the TallyView mapping for free."""

    __slots__ = ("_out", "_done", "_b", "_n", "_R", "_f", "_np")

    def __init__(self, out, done, b: int, n: int, r_slots: int, f):
        self._out = out
        self._done = done
        self._b = b
        self._n = n
        self._R = r_slots
        self._f = f
        self._np = None

    def mask(self) -> np.ndarray:
        if self._np is None:
            self._np = device_fetch(
                _PinnedCopy(self._out, self._done),
                why="single deferred fetch of mask+counts",
            )
            self._out = self._done = None
        return self._np[: self._b].astype(bool)

    def counts(self) -> "LazyCounts":
        self.mask()
        return LazyCounts(
            self._np[self._b :].reshape(self._n, -1), self._n, self._R,
            self._f,
        )


class LazyCounts(Mapping):
    """Mapping over one packed count tensor (or its host copy), copied to
    the host on first VALUE access. The key set is static, so shape
    probes (iteration, membership, len) never trigger the copy."""

    __slots__ = ("_packed", "_n", "_R", "_f", "_dict")

    _KEYS = (
        "matching",
        "nil",
        "total",
        "quorum_matching",
        "quorum_nil",
        "quorum_any",
        "l28",
        "l28_quorum",
    )

    def __init__(self, packed, n: int, r_slots: int, f):
        self._packed = packed
        self._n = n
        self._R = r_slots
        self._f = f
        self._dict = None

    def _materialize(self) -> dict:
        d = self._dict
        if d is None:
            flat = device_fetch(
                self._packed, why="deferred count fetch on first access"
            )
            n, R = self._n, self._R
            three = flat[:, : 2 * R * 3].reshape(n, 2, R, 3)
            l28 = flat[:, 2 * R * 3]
            # Quorum flags are host-derived (counts and f travel; flags
            # don't — half the transfer for a handful of comparisons).
            q = (2 * np.asarray(self._f).reshape(n) + 1)[:, None, None]
            d = self._dict = {
                "matching": three[..., 0],
                "nil": three[..., 1],
                "total": three[..., 2],
                "quorum_matching": three[..., 0] >= q,
                "quorum_nil": three[..., 1] >= q,
                "quorum_any": three[..., 2] >= q,
                "l28": l28,
                "l28_quorum": l28 >= q[:, 0, 0],
            }
            self._packed = None
        return d

    def __getitem__(self, key):
        if key not in self._KEYS:
            raise KeyError(key)
        return self._materialize()[key]

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __contains__(self, key) -> bool:
        return key in self._KEYS
