"""Messages as NumPy struct-array rows: the dense message layer.

A :class:`MessageBlock` is a window of consensus messages in columnar form,
the layout the device data path consumes:

- :meth:`MessageBlock.verify_items` / :meth:`MessageBlock.pack_arrays`
  feed the Ed25519 batch verifier (one contiguous array per field, no
  per-message marshalling);
- :meth:`MessageBlock.tally_inputs` builds the ``[rounds, validators, 8]``
  vote tensor + presence mask that :mod:`hyperdrive_tpu_torch.ops.tally`
  fuses behind the verification mask;
- :meth:`MessageBlock.digests` computes signing digests with vectorized
  preimage assembly (one hashlib call per row over a prebuilt byte
  matrix: the serialization work is columnar).

Row layout mirrors the wire envelope (`messages.marshal_message`); Propose
payloads are variable-length and rare, so they ride in a sparse side table
rather than widening every row.

:class:`WindowColumns` is the feed of the columnar settle path
(``Process.ingest_insert_cols``): one extraction pass per settle window,
shared by every replica that ingests it.

Port copy of ``hyperdrive_tpu/batch.py`` for the PyTorch package, whole:
host NumPy structures over the port's own ``types`` and ``messages``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from hyperdrive_tpu_torch.messages import Precommit, Prevote, Propose
from hyperdrive_tpu_torch.types import INVALID_ROUND, MessageType

__all__ = ["MESSAGE_DTYPE", "MessageBlock", "WindowColumns"]

#: One consensus message as a fixed-width structured row.
MESSAGE_DTYPE = np.dtype(
    [
        ("type", "<i1"),
        ("height", "<i8"),
        ("round", "<i8"),
        ("valid_round", "<i8"),
        ("value", "u1", 32),
        ("sender", "u1", 32),
        ("signature", "u1", 64),
        ("has_sig", "?"),
    ]
)

_TYPE_TAG = {
    Propose: int(MessageType.PROPOSE),
    Prevote: int(MessageType.PREVOTE),
    Precommit: int(MessageType.PRECOMMIT),
}

def _bytes_col(parts: list[bytes], width: int) -> np.ndarray:
    return np.frombuffer(b"".join(parts), dtype=np.uint8).reshape(
        len(parts), width
    )


class MessageBlock:
    """A window of Propose/Prevote/Precommit messages in columnar form."""

    __slots__ = ("rows", "payloads")

    def __init__(self, rows: np.ndarray, payloads: dict[int, bytes]):
        self.rows = rows
        #: Sparse row index -> Propose payload bytes (empty payloads and
        #: non-propose rows are absent).
        self.payloads = payloads

    def __len__(self) -> int:
        return len(self.rows)

    # ------------------------------------------------------------ construct

    @classmethod
    def from_messages(cls, msgs) -> "MessageBlock":
        """Columnarize a window. Timeouts are control events, not votes —
        they have no row representation and are rejected."""
        n = len(msgs)
        rows = np.zeros(n, dtype=MESSAGE_DTYPE)
        if n == 0:
            return cls(rows, {})
        values, senders, sigs = [], [], []
        payloads: dict[int, bytes] = {}
        heights = np.empty(n, dtype=np.int64)
        rounds = np.empty(n, dtype=np.int64)
        vrounds = np.full(n, INVALID_ROUND, dtype=np.int64)
        types = np.empty(n, dtype=np.int8)
        has_sig = np.zeros(n, dtype=bool)
        for i, m in enumerate(msgs):
            tag = _TYPE_TAG.get(type(m))
            if tag is None:
                raise TypeError(f"not a batchable message: {type(m)!r}")
            types[i] = tag
            heights[i] = m.height
            rounds[i] = m.round
            values.append(m.value)
            senders.append(m.sender)
            if isinstance(m, Propose):
                vrounds[i] = m.valid_round
                if m.payload:
                    payloads[i] = m.payload
            sig = m.signature
            if sig and len(sig) == 64:
                sigs.append(sig)
                has_sig[i] = True
            else:
                # Missing/wrong-length signatures cannot ride in a fixed
                # 64-byte row; the row is zero-filled ONLY as padding and
                # has_sig=False gates it — every consumer must route such
                # rows to deterministic rejection (verify_items emits b"",
                # which the packers length-check to invalid), never hand
                # the zero bytes to the verifier as if they were the
                # signature (a zero sig can verify under an adversarial
                # small-order pubkey).
                sigs.append(b"\x00" * 64)
        rows["type"] = types
        rows["height"] = heights
        rows["round"] = rounds
        rows["valid_round"] = vrounds
        rows["value"] = _bytes_col(values, 32)
        rows["sender"] = _bytes_col(senders, 32)
        rows["signature"] = _bytes_col(sigs, 64)
        rows["has_sig"] = has_sig
        return cls(rows, payloads)

    def message_at(self, i: int):
        """Materialize one row into its message object (the lazy unit of
        :meth:`to_messages`; the columnar settle fast path calls it only
        for rows the automaton keeps or reports)."""
        row = self.rows[i]
        ty = int(row["type"])
        common = dict(
            height=int(row["height"]),
            round=int(row["round"]),
            value=row["value"].tobytes(),
            sender=row["sender"].tobytes(),
        )
        if ty == int(MessageType.PROPOSE):
            msg = Propose(
                valid_round=int(row["valid_round"]),
                payload=self.payloads.get(i, b""),
                **common,
            )
        elif ty == int(MessageType.PREVOTE):
            msg = Prevote(**common)
        else:
            msg = Precommit(**common)
        if row["has_sig"]:
            msg = msg.with_signature(row["signature"].tobytes())
        return msg

    def to_messages(self) -> list:
        """Materialize the rows back into message objects (exact inverse of
        :meth:`from_messages` for well-formed inputs)."""
        return [self.message_at(i) for i in range(len(self.rows))]

    def columns(self) -> "WindowColumns":
        """A :class:`WindowColumns` view over this block: the columnar
        ingest entry point for wire-delivered windows — rows flow into the
        automaton without up-front object materialization."""
        return WindowColumns.from_block(self)

    # -------------------------------------------------------------- digests

    def digests(self) -> list[bytes]:
        """Per-row signing digests, preimages assembled columnar.

        Vote digests are sha256(tag || i64 h || i64 r || value); proposes
        additionally splice valid_round (and the payload hash when one
        rides along), handled per-row since proposes are ~1/(2n) of
        traffic.
        """
        n = len(self.rows)
        pre = np.zeros((n, 1 + 8 + 8 + 32), dtype=np.uint8)
        pre[:, 0:1] = self.rows["type"].astype(np.uint8).reshape(n, 1)
        pre[:, 1:9] = self.rows["height"].astype("<i8").view(np.uint8).reshape(n, 8)
        pre[:, 9:17] = self.rows["round"].astype("<i8").view(np.uint8).reshape(n, 8)
        pre[:, 17:49] = self.rows["value"]
        flat = pre.tobytes()
        w = pre.shape[1]
        out: list[bytes] = []
        is_propose = self.rows["type"] == int(MessageType.PROPOSE)
        for i in range(n):
            if is_propose[i]:
                row = self.rows[i]
                buf = (
                    b"\x01"
                    + row["height"].astype("<i8").tobytes()
                    + row["round"].astype("<i8").tobytes()
                    + row["valid_round"].astype("<i8").tobytes()
                    + row["value"].tobytes()
                )
                payload = self.payloads.get(i, b"")
                if payload:
                    buf += hashlib.sha256(payload).digest()
                out.append(hashlib.sha256(buf).digest())
            else:
                out.append(hashlib.sha256(flat[i * w : (i + 1) * w]).digest())
        return out

    # -------------------------------------------------------- verifier feed

    def verify_items(self) -> list[tuple[bytes, bytes, bytes]]:
        """(pub, digest, sig) triples for the Verifier protocol. Rows with
        ``has_sig=False`` (absent or wrong-length signature) emit ``b""``
        so the packer's length check rejects them deterministically — the
        same verdict the object path gives them — instead of forwarding
        the zero padding as a signature."""
        digests = self.digests()
        senders = self.rows["sender"]
        sigs = self.rows["signature"]
        has_sig = self.rows["has_sig"]
        return [
            (
                senders[i].tobytes(),
                digests[i],
                sigs[i].tobytes() if has_sig[i] else b"",
            )
            for i in range(len(self.rows))
        ]

    def pack_arrays(self):
        """Contiguous (pubs[n,32], digests[n,32], sigs[n,64], has_sig[n])
        uint8/bool arrays — the zero-copy feed for the native packer ABI.
        Callers MUST mask verdicts with ``has_sig``: a False lane's
        signature bytes are padding, not a signature."""
        digests = _bytes_col(self.digests(), 32)
        return (
            np.ascontiguousarray(self.rows["sender"]),
            digests,
            np.ascontiguousarray(self.rows["signature"]),
            np.ascontiguousarray(self.rows["has_sig"]),
        )

    # ----------------------------------------------------------- tally feed

    def tally_inputs(self, signatories: list[bytes], vote_type: MessageType,
                     height: int):
        """Build the device tally tensors for one vote type at one height.

        Returns (rounds, vote_vals [R, V, 8] int32, present [R, V] bool)
        where R spans the distinct rounds this block holds for that
        (type, height) and V indexes ``signatories``. Unknown senders and
        duplicate votes (first wins, the log rule) are excluded. Feed
        ``present & verify_mask`` to :func:`hyperdrive_tpu_torch.ops.tally.
        tally_counts` to fuse quorum counting behind signature
        verification.
        """
        sel = (self.rows["type"] == int(vote_type)) & (
            self.rows["height"] == height
        )
        idx = np.nonzero(sel)[0]
        rounds = sorted({int(self.rows["round"][i]) for i in idx})
        round_pos = {r: j for j, r in enumerate(rounds)}
        sender_pos = {s: v for v, s in enumerate(signatories)}
        R, V = max(len(rounds), 1), len(signatories)
        vote_vals = np.zeros((R, V, 8), dtype=np.int32)
        present = np.zeros((R, V), dtype=bool)
        for i in idx:
            v = sender_pos.get(self.rows["sender"][i].tobytes())
            if v is None:
                continue
            rj = round_pos[int(self.rows["round"][i])]
            if present[rj, v]:
                continue  # duplicate: first vote wins (the log rule)
            present[rj, v] = True
            vote_vals[rj, v] = (
                self.rows["value"][i].view("<i4").astype(np.int32)
            )
        return rounds, vote_vals, present


class WindowColumns:
    """A settle window decomposed into per-row columns plus run segments —
    the feed of the columnar ingest fast path (``Process.
    ingest_insert_cols``).

    The object-path hot loop pays per-message attribute access and type
    dispatch once per (message, replica); a lockstep settle re-pays it for
    every one of the n replicas sharing the same window. This view hoists
    that extraction to ONE pass per window: plain Python lists for the
    fields the insert loop reads (kind tag, height, round, sender, value)
    and maximal consecutive ``runs`` sharing (kind, height, round), so the
    per-replica loop fetches its round-log views once per run instead of
    re-checking per row.

    Message objects stay the log/checkpoint/evidence source of truth, so
    the fast path still stores them — but via :meth:`msg`, which is a list
    index when the window already holds objects (:meth:`from_messages`)
    and lazy row materialization when it came off the wire
    (:meth:`from_block`): rows the automaton filters out (wrong height,
    duplicate, unverified) never become objects at all.
    """

    __slots__ = ("n", "kinds", "heights", "rounds", "senders", "values",
                 "runs", "msgs", "_block")

    #: Row kind tags — the MessageType wire tags, matching
    #: ``MESSAGE_DTYPE``'s ``type`` column.
    KIND_PROPOSE = int(MessageType.PROPOSE)
    KIND_PREVOTE = int(MessageType.PREVOTE)
    KIND_PRECOMMIT = int(MessageType.PRECOMMIT)

    def __init__(self, kinds, heights, rounds, senders, values, msgs,
                 block=None):
        self.n = len(kinds)
        self.kinds = kinds
        self.heights = heights
        self.rounds = rounds
        self.senders = senders
        self.values = values
        #: Per-row message objects; ``None`` entries materialize lazily
        #: from ``_block`` on first :meth:`msg` access.
        self.msgs = msgs
        self._block = block
        self.runs = self._segment()

    def _segment(self):
        """Maximal consecutive (kind, height, round) runs as
        (kind, height, round, start, end) tuples. Windows arrive (height,
        round)-sorted so runs are long; adversarial interleavings just
        degrade to shorter runs with identical semantics (row order inside
        and across runs is preserved)."""
        kinds, heights, rounds = self.kinds, self.heights, self.rounds
        runs = []
        n = self.n
        i = 0
        while i < n:
            k, h, r = kinds[i], heights[i], rounds[i]
            j = i + 1
            while j < n and kinds[j] == k and heights[j] == h \
                    and rounds[j] == r:
                j += 1
            runs.append((k, h, r, i, j))
            i = j
        return runs

    @classmethod
    def from_messages(cls, msgs) -> "WindowColumns":
        """Columnarize a window of live message objects (the simulator's
        shared-superstep lane): one extraction pass serves every replica
        that ingests the window."""
        kinds = []
        heights = []
        rounds = []
        senders = []
        values = []
        for m in msgs:
            tag = _TYPE_TAG.get(type(m))
            if tag is None:
                raise TypeError(f"not a batchable message: {type(m)!r}")
            kinds.append(tag)
            heights.append(m.height)
            rounds.append(m.round)
            senders.append(m.sender)
            values.append(m.value)
        return cls(kinds, heights, rounds, senders, values,
                   msgs if isinstance(msgs, list) else list(msgs))

    @classmethod
    def from_block(cls, block: MessageBlock) -> "WindowColumns":
        """Columnar view over wire rows; message objects materialize only
        on demand (accepted/equivocating/propose rows)."""
        rows = block.rows
        n = len(rows)
        senders = [s.tobytes() for s in rows["sender"]]
        values = [v.tobytes() for v in rows["value"]]
        return cls(
            rows["type"].tolist(), rows["height"].tolist(),
            rows["round"].tolist(), senders, values,
            [None] * n, block=block,
        )

    def msg(self, i: int):
        """Row ``i`` as a message object (cached)."""
        m = self.msgs[i]
        if m is None:
            m = self.msgs[i] = self._block.message_at(i)
        return m
