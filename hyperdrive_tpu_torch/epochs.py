"""Dynamic validator sets: epoch schedule, proportional election, and
light-client-checkable transition proofs.

The validator set is frozen at construction everywhere else in the
engine — no real deployment survives that (ROADMAP item 4). This module
adds the missing lifecycle:

- **Election** (:func:`elect_committee`): stake-weighted proportional
  sampling without replacement, deterministic from a seed digest
  (PAPERS.md: "A verifiably secure and proportional committee election
  rule", arXiv:2004.12990 — the committee is a verifiable random
  function of public randomness and the stake table, so every observer
  recomputes the same set).
- **Schedule** (:class:`EpochSchedule`): heights partition into
  fixed-length epochs; committing an epoch's last height ("the
  boundary") elects the next committee. The election seed chains
  ``anchor(e+1) = H(seed ‖ e+1 ‖ anchor(e) ‖ H(boundary value))`` — a
  pure function of *agreed* consensus state, so replicas that committed
  the same boundary value compute the same committee. (Seeding from the
  per-replica :class:`~hyperdrive_tpu_torch.certificates.QuorumCertificate`
  digest instead would fork elections: a certificate's round and signer
  bitmap legitimately differ per replica under partitions.) Re-keying
  rides the same anchor: each transition deterministically picks
  ``rekey_per_epoch`` members of the new committee and bumps their key
  generation, retiring the old identity.
- **Proofs** (:class:`EpochProof`, :func:`verify_epoch_chain`): a
  constant-size :class:`~hyperdrive_tpu_torch.certificates.QuorumCertificate`
  over the *transition digest* (epoch ‖ next-set digest ‖ prev-set
  digest), signed — via the boundary commit's 2f+1 precommit quorum —
  under the OLD committee. A light client holding epoch N's validator
  set walks to N+1 with a constant number of checks per hop: two set
  digests, one transition digest, one bitmap popcount, one binding
  recompute. No history is ever re-verified.
- **Emission** (:class:`EpochCertifier`): a
  :class:`~hyperdrive_tpu_torch.certificates.Certifier` that mints the epoch
  proof at each boundary commit and hot-swaps itself to the next
  committee (``Certifier.rotate``), keeping one continuous certificate
  chain across the transition.

Port copy of ``hyperdrive_tpu/epochs.py`` (host code, no device
import), on this package's ``codec`` and ``certificates``, with the
proof codec's ``epoch.proof`` wire registration. :class:`EpochCertifier`
takes the reference's recorder
(``obs``) and emits its ``epoch.proof`` event. The
chaos engine (:mod:`hyperdrive_tpu_torch.chaos`, ``FaultPlan.churn``) is
the proving ground for churn, as in the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from hyperdrive_tpu_torch.analysis.annotations import wire_codec
from hyperdrive_tpu_torch.certificates import (
    Certifier,
    QuorumCertificate,
    _binding,
    marshal_certificate,
    unmarshal_certificate,
)
from hyperdrive_tpu_torch.codec import Reader, SerdeError, Writer
from hyperdrive_tpu_torch.obs.recorder import NULL_BOUND

__all__ = [
    "ValidatorInfo",
    "EpochConfig",
    "EpochTransition",
    "EpochSchedule",
    "EpochProof",
    "EpochChainError",
    "elect_committee",
    "set_digest",
    "transition_digest",
    "default_signatory",
    "genesis_anchor",
    "verify_epoch_chain",
    "marshal_epoch_proof",
    "unmarshal_epoch_proof",
    "EpochCertifier",
]

#: Domain separator for every epoch-layer hash (versioned: a format
#: change must not collide with old anchors/digests).
_EPOCH_TAG = b"hd-epoch-v1"


# ------------------------------------------------------------------ election


def _draw(material: bytes, ctr: int, bound: int) -> tuple[int, int]:
    """One uniform draw in ``[0, bound)`` from the sha256 counter stream
    keyed by ``material``; returns ``(value, next_ctr)``. Rejection
    sampling over the top of the 64-bit range keeps the draw exactly
    uniform (no modulo bias), and the counter advance makes the stream
    position part of the deterministic contract."""
    if bound <= 0:
        raise ValueError(f"draw bound must be positive, got {bound}")
    limit = (1 << 64) - ((1 << 64) % bound)
    while True:
        h = hashlib.sha256()
        h.update(_EPOCH_TAG)
        h.update(b"draw")
        h.update(material)
        h.update(ctr.to_bytes(8, "little"))
        ctr += 1
        v = int.from_bytes(h.digest()[:8], "little")
        if v < limit:
            return v % bound, ctr


def elect_committee(stakes, k: int, seed_material: bytes) -> tuple:
    """Stake-weighted proportional election: sample ``k`` distinct pool
    indices without replacement, each draw proportional to remaining
    stake (arXiv:2004.12990's proportionality, instantiated over a hash
    counter stream so every observer of ``seed_material`` recomputes the
    identical committee). Zero-stake candidates are never elected.
    Returns the winners in election order — the committee's canonical
    whitelist order."""
    pool = [(i, int(s)) for i, s in enumerate(stakes) if int(s) > 0]
    if k > len(pool):
        raise ValueError(
            f"committee size {k} exceeds {len(pool)} staked candidates"
        )
    ctr = 0
    chosen: list = []
    for _ in range(k):
        total = sum(s for _, s in pool)
        r, ctr = _draw(seed_material, ctr, total)
        acc = 0
        for j, (idx, s) in enumerate(pool):
            acc += s
            if r < acc:
                chosen.append(idx)
                pool.pop(j)
                break
    return tuple(chosen)


# ------------------------------------------------------------------- digests


def set_digest(signatories) -> bytes:
    """Canonical digest of a validator set *in whitelist order* — the
    order certificate signer bitmaps index, so the digest commits to the
    bitmap semantics, not just the membership."""
    h = hashlib.sha256()
    h.update(_EPOCH_TAG)
    h.update(b"set")
    sigs = list(signatories)
    h.update(len(sigs).to_bytes(4, "little"))
    for s in sigs:
        h.update(len(s).to_bytes(2, "little"))
        h.update(s)
    return h.digest()


def transition_digest(epoch: int, next_set_digest: bytes,
                      prev_set_digest: bytes) -> bytes:
    """The value an epoch proof's certificate commits to: "epoch
    ``epoch`` runs under the set whose digest is ``next_set_digest``,
    succeeding ``prev_set_digest``"."""
    h = hashlib.sha256()
    h.update(_EPOCH_TAG)
    h.update(b"transition")
    h.update(int(epoch).to_bytes(8, "little"))
    h.update(next_set_digest)
    h.update(prev_set_digest)
    return h.digest()


def default_signatory(index: int, generation: int,
                      namespace: bytes = b"epoch") -> bytes:
    """The unsigned-harness identity function: a 32-byte digest per
    (pool index, key generation). Signed deployments pass a
    ``signatory_fn`` that derives real pubkeys instead."""
    h = hashlib.sha256()
    h.update(_EPOCH_TAG)
    h.update(b"sig")
    h.update(namespace)
    h.update(int(index).to_bytes(4, "little"))
    h.update(int(generation).to_bytes(4, "little"))
    return h.digest()


def genesis_anchor(seed: int) -> bytes:
    """The epoch-0 anchor — a pure function of the schedule seed.

    Exposed at module level because consumers that key material off the
    anchor chain (the aggregation overlay's topology, FaultPlan.overlay
    computing tree-slicing partitions *before* a sim exists) need the
    epoch-0 value without constructing a schedule. Must stay
    byte-identical to the value ``EpochSchedule.__init__`` installs."""
    return hashlib.sha256(
        _EPOCH_TAG + b"anchor" + int(seed).to_bytes(8, "little")
        + b"genesis"
    ).digest()


# ----------------------------------------------------------------- schedule


@dataclass(frozen=True)
class ValidatorInfo:
    """One committee seat: pool index, current-generation identity,
    stake, and key generation."""

    index: int
    signatory: bytes
    stake: int
    generation: int


@dataclass(frozen=True)
class EpochConfig:
    """Harness-facing epoch knobs (``Simulation(epochs=EpochConfig())``).

    ``committee_size`` of 0 means "the whole pool". ``stakes`` of ()
    means uniform stake 1 per pool member. ``rekey_per_epoch`` members
    of each NEW committee rotate to a fresh key generation at the
    boundary, retiring their old identity."""

    epoch_length: int = 4
    committee_size: int = 0
    rekey_per_epoch: int = 1
    seed: int = 0
    stakes: tuple = ()


@dataclass(frozen=True)
class EpochTransition:
    """The computed outcome of one boundary commit."""

    epoch: int                      #: the NEW epoch index
    committee: tuple                #: tuple[ValidatorInfo] in whitelist order
    signatories: tuple              #: committee identities, same order
    set_digest: bytes               #: digest of ``signatories``
    prev_set_digest: bytes          #: digest of the outgoing committee
    joined: tuple = ()              #: pool indices newly seated
    left: tuple = ()                #: pool indices unseated
    rekeyed: tuple = ()             #: pool indices with a bumped generation
    retired: tuple = ()             #: the old identities those retired
    anchoring_digest: bytes = b""   #: sha256 of the boundary value


class EpochSchedule:
    """The deterministic epoch state machine.

    Advances strictly in epoch order as boundary commits arrive
    (:meth:`transition_at`); every query before the corresponding
    boundary commit raises, because the committee genuinely does not
    exist yet — it is a function of a value the network has not agreed
    on. Idempotent per epoch: replicas committing the same boundary
    value share one cached transition, and a replica committing a
    *different* value at the same boundary trips the fork check here
    before it can elect a divergent committee.
    """

    def __init__(self, stakes, committee_size: int, epoch_length: int,
                 seed: int, *, rekey_per_epoch: int = 1,
                 signatory_fn=default_signatory):
        self.stakes = tuple(int(s) for s in stakes)
        if committee_size < 3:
            raise ValueError(
                f"committee_size must be >= 3 (got {committee_size}): "
                "f = k // 3 must stay positive for 2f+1 quorums"
            )
        staked = sum(1 for s in self.stakes if s > 0)
        if committee_size > staked:
            raise ValueError(
                f"committee_size {committee_size} exceeds {staked} "
                "staked pool members"
            )
        if epoch_length < 1:
            raise ValueError(f"epoch_length must be >= 1, got {epoch_length}")
        self.committee_size = int(committee_size)
        self.epoch_length = int(epoch_length)
        self.seed = int(seed)
        self.rekey_per_epoch = int(rekey_per_epoch)
        self.signatory_fn = signatory_fn
        #: Optional ``height -> stake vector`` hook consulted when
        #: :meth:`transition_at` gets no explicit ``stakes`` override:
        #: the execution layer binds the committed ledger's stake
        #: column here, so EVERY transition-creating path — the sim's
        #: commit seam and EpochCertifier.observe_commit alike — elects
        #: from replicated state. Must be deterministic in ``height``.
        self.stake_source = None
        self._gens = [0] * len(self.stakes)
        anchor0 = genesis_anchor(self.seed)
        self._anchors: dict = {0: anchor0}
        members = elect_committee(
            self.stakes, self.committee_size, anchor0 + b"elect"
        )
        committee = tuple(
            ValidatorInfo(i, signatory_fn(i, 0), self.stakes[i], 0)
            for i in members
        )
        sigs = tuple(v.signatory for v in committee)
        self._transitions: dict = {
            0: EpochTransition(
                epoch=0,
                committee=committee,
                signatories=sigs,
                set_digest=set_digest(sigs),
                prev_set_digest=bytes(32),
                joined=members,
            )
        }

    # ------------------------------------------------------------- geometry

    def epoch_of(self, height: int) -> int:
        """The epoch height ``height`` belongs to (heights start at 1)."""
        return (int(height) - 1) // self.epoch_length

    def anchor(self, epoch: int) -> bytes:
        """The chained anchor digest for ``epoch``.

        Only anchors already derived exist — epoch e's anchor is minted
        by :meth:`advance` from the committed boundary value of epoch
        e-1, so asking for a future epoch is a programming error, not a
        lookup miss. The overlay keys its per-epoch tree off this value."""
        a = self._anchors.get(int(epoch))
        if a is None:
            raise KeyError(
                f"anchor for epoch {epoch} not derived yet "
                f"(have epochs {sorted(self._anchors)})"
            )
        return a

    def is_boundary(self, height: int) -> bool:
        """True when committing ``height`` triggers the next election."""
        return int(height) % self.epoch_length == 0

    def boundary_height(self, epoch: int) -> int:
        """The last height of ``epoch`` — its commit elects ``epoch+1``."""
        return (int(epoch) + 1) * self.epoch_length

    # -------------------------------------------------------------- queries

    @property
    def latest_epoch(self) -> int:
        return max(self._transitions)

    def transition(self, epoch: int) -> EpochTransition:
        got = self._transitions.get(int(epoch))
        if got is None:
            raise KeyError(
                f"epoch {epoch} not elected yet (latest: "
                f"{self.latest_epoch}) — its boundary has not committed"
            )
        return got

    def committee(self, epoch: int) -> tuple:
        return self.transition(epoch).committee

    def signatories(self, epoch: int) -> tuple:
        return self.transition(epoch).signatories

    def f(self, epoch: int) -> int:
        return len(self.committee(epoch)) // 3

    def generation_of(self, index: int) -> int:
        return self._gens[index]

    # ----------------------------------------------------------- transition

    def transition_at(
        self, height: int, value: bytes, stakes=None
    ) -> EpochTransition:
        """Compute (or fetch) the transition triggered by committing
        ``value`` at boundary ``height``. Raises on a non-boundary
        height, and raises ``ValueError`` when a cached transition was
        anchored on a *different* committed value — that is a fork at
        the boundary, and electing from it would split the network into
        two futures.

        ``stakes`` overrides the static construction-time table for
        THIS election (and the committee's ValidatorInfo stakes): the
        execution layer passes the committed ledger's stake column at
        the boundary, so elections read replicated state instead of a
        fixed table (ROADMAP item 4). Callers must be deterministic —
        every replica reaching this boundary passes the same vector
        (the chained state root enforces it); the cached first-
        committer transition is returned as-is, same as value-anchored
        determinism."""
        if not self.is_boundary(height):
            raise ValueError(f"height {height} is not an epoch boundary")
        new_epoch = self.epoch_of(height) + 1
        vdigest = hashlib.sha256(value).digest()
        got = self._transitions.get(new_epoch)
        if got is not None:
            if got.anchoring_digest != vdigest:
                raise ValueError(
                    f"epoch {new_epoch} fork: boundary {height} already "
                    f"anchored on {got.anchoring_digest.hex()[:16]}, "
                    f"got {vdigest.hex()[:16]}"
                )
            return got
        if new_epoch != self.latest_epoch + 1:
            raise ValueError(
                f"transition to epoch {new_epoch} out of order "
                f"(latest: {self.latest_epoch})"
            )
        prev = self._transitions[new_epoch - 1]
        anchor = hashlib.sha256(
            _EPOCH_TAG + b"anchor" + self.seed.to_bytes(8, "little")
            + new_epoch.to_bytes(8, "little")
            + self._anchors[new_epoch - 1] + vdigest
        ).digest()
        self._anchors[new_epoch] = anchor
        if stakes is None and self.stake_source is not None:
            stakes = self.stake_source(height)
        elect_stakes = (
            self.stakes if stakes is None else tuple(int(s) for s in stakes)
        )
        if len(elect_stakes) != len(self.stakes):
            raise ValueError(
                f"stake override has {len(elect_stakes)} entries for a "
                f"{len(self.stakes)}-member pool"
            )
        members = elect_committee(
            elect_stakes, self.committee_size, anchor + b"elect"
        )
        # Deterministic re-key: rekey_per_epoch distinct members of the
        # NEW committee bump their key generation, drawn from the same
        # anchor so every replica retires the same identities.
        rekeyed: list = []
        retired: list = []
        if self.rekey_per_epoch > 0 and members:
            ctr = 0
            picks = min(self.rekey_per_epoch, len(members))
            remaining = list(members)
            for _ in range(picks):
                j, ctr = _draw(anchor + b"rekey", ctr, len(remaining))
                idx = remaining.pop(j)
                retired.append(
                    self.signatory_fn(idx, self._gens[idx])
                )
                self._gens[idx] += 1
                rekeyed.append(idx)
        committee = tuple(
            ValidatorInfo(
                i, self.signatory_fn(i, self._gens[i]),
                elect_stakes[i], self._gens[i],
            )
            for i in members
        )
        sigs = tuple(v.signatory for v in committee)
        old_members = {v.index for v in prev.committee}
        tr = EpochTransition(
            epoch=new_epoch,
            committee=committee,
            signatories=sigs,
            set_digest=set_digest(sigs),
            prev_set_digest=prev.set_digest,
            joined=tuple(i for i in members if i not in old_members),
            left=tuple(sorted(old_members - set(members))),
            rekeyed=tuple(rekeyed),
            retired=tuple(retired),
            anchoring_digest=vdigest,
        )
        self._transitions[new_epoch] = tr
        return tr


# ------------------------------------------------------------------- proofs


class EpochChainError(ValueError):
    """An epoch-proof chain failed verification; the message names the
    hop and the check that broke."""


@dataclass(frozen=True)
class EpochProof:
    """The light-client hop from epoch ``epoch - 1`` to ``epoch``.

    ``cert`` is a constant-size quorum certificate whose value digest is
    :func:`transition_digest` — minted from the boundary commit's 2f+1
    precommit quorum, so its signer bitmap indexes the OLD committee's
    whitelist order. ``next_signatories`` rides along (committed to by
    ``next_set_digest``) so the verifier can keep walking."""

    epoch: int
    prev_set_digest: bytes
    next_set_digest: bytes
    next_signatories: tuple
    cert: QuorumCertificate


@wire_codec(tag="epoch.proof", max_bytes=4 << 20)
def marshal_epoch_proof(proof: EpochProof, w: Writer) -> None:
    w.u64(proof.epoch)
    w.bytes32(proof.prev_set_digest)
    w.bytes32(proof.next_set_digest)
    w.u32(len(proof.next_signatories))
    for s in proof.next_signatories:
        w.raw(s)
    marshal_certificate(proof.cert, w)


@wire_codec(tag="epoch.proof", max_bytes=4 << 20)
def unmarshal_epoch_proof(r: Reader) -> EpochProof:
    epoch = r.u64()
    prev_digest = r.bytes32()
    next_digest = r.bytes32()
    n = r.u32()
    if n > 65536:
        raise SerdeError(f"epoch proof signatory count too large: {n}")
    sigs = tuple(r.raw() for _ in range(n))
    cert = unmarshal_certificate(r)
    return EpochProof(
        epoch=epoch,
        prev_set_digest=prev_digest,
        next_set_digest=next_digest,
        next_signatories=sigs,
        cert=cert,
    )


def verify_epoch_chain(genesis_signatories, proofs) -> int:
    """Walk epoch N → N+1 → … with a constant number of checks per hop.

    ``genesis_signatories``: the trusted starting committee (whitelist
    order). ``proofs``: consecutive :class:`EpochProof` hops. Per hop:
    the prev-set digest must match the set we trust, the next-set digest
    must match the carried signatories, the certificate must commit to
    exactly this transition, and its signer bitmap must hold a 2f+1
    quorum of the OLD committee with an intact binding — no signature
    set, no history, nothing proportional to chain length. Returns the
    number of hops verified; raises :class:`EpochChainError` on any
    break."""
    cur = tuple(genesis_signatories)
    hops = 0
    prev_epoch = None
    for proof in proofs:
        tag = f"hop to epoch {proof.epoch}"
        if prev_epoch is not None and proof.epoch != prev_epoch + 1:
            raise EpochChainError(
                f"{tag}: not consecutive after epoch {prev_epoch}"
            )
        if set_digest(cur) != proof.prev_set_digest:
            raise EpochChainError(f"{tag}: prev-set digest mismatch")
        if set_digest(proof.next_signatories) != proof.next_set_digest:
            raise EpochChainError(
                f"{tag}: carried signatories do not match next-set digest"
            )
        want = transition_digest(
            proof.epoch, proof.next_set_digest, proof.prev_set_digest
        )
        cert = proof.cert
        if cert.value_digest != want:
            raise EpochChainError(
                f"{tag}: certificate commits to a different transition"
            )
        n = len(cur)
        if len(cert.signers) != -(-n // 8):
            raise EpochChainError(
                f"{tag}: signer bitmap width {len(cert.signers)} for "
                f"committee of {n}"
            )
        if cert.signer_count() < 2 * (n // 3) + 1:
            raise EpochChainError(
                f"{tag}: {cert.signer_count()} signers < 2f+1 quorum"
            )
        if cert.binding != _binding(
            cert.height, cert.round, cert.value_digest, cert.signers,
            cert.transcript,
        ):
            raise EpochChainError(f"{tag}: certificate binding broken")
        cur = proof.next_signatories
        prev_epoch = proof.epoch
        hops += 1
    return hops


# ----------------------------------------------------------------- emission


class EpochCertifier(Certifier):
    """A :class:`~hyperdrive_tpu_torch.certificates.Certifier` that follows
    the epoch schedule: per boundary commit it mints the epoch proof
    (under the OLD committee's whitelist order — the quorum that
    committed the boundary) and rotates itself to the new committee, so
    one certifier instance carries a continuous certificate chain plus
    the proof chain across every transition it lived through."""

    def __init__(self, schedule: EpochSchedule, epoch: int = 0,
                 transcript_source=None, obs=None, bls_keyring=None,
                 bls_aggregate_fn=None):
        super().__init__(
            schedule.signatories(epoch), schedule.f(epoch),
            transcript_source, obs,
            bls_keyring=bls_keyring, bls_aggregate_fn=bls_aggregate_fn,
        )
        self.schedule = schedule
        self.epoch = int(epoch)
        #: new-epoch index -> EpochProof, in emission order.
        self.proofs: dict = {}

    def observe_commit(self, height, round, value, signers):
        cert = super().observe_commit(height, round, value, signers)
        if not self.schedule.is_boundary(height):
            return cert
        tr = self.schedule.transition_at(height, value)
        td = transition_digest(tr.epoch, tr.set_digest, tr.prev_set_digest)
        pcert = QuorumCertificate(
            height=cert.height,
            round=cert.round,
            value_digest=td,
            signers=cert.signers,
            transcript=cert.transcript,
            binding=_binding(
                cert.height, cert.round, td, cert.signers, cert.transcript
            ),
        )
        self.proofs[tr.epoch] = EpochProof(
            epoch=tr.epoch,
            prev_set_digest=tr.prev_set_digest,
            next_set_digest=tr.set_digest,
            next_signatories=tr.signatories,
            cert=pcert,
        )
        if self.obs is not NULL_BOUND:
            self.obs.emit(
                "epoch.proof", int(height), int(round), td.hex()[:16]
            )
        self.rotate_to(tr.epoch)
        return cert

    def rotate_to(self, epoch: int) -> None:
        """Hot-swap to ``epoch``'s committee (boundary commit, or a
        resync that jumped the replica over one or more boundaries)."""
        self.rotate(
            self.schedule.signatories(epoch), self.schedule.f(epoch)
        )
        self.epoch = int(epoch)

    def proof_chain(self) -> list:
        """The held proofs in epoch order — feed to
        :func:`verify_epoch_chain` with the first hop's predecessor
        committee."""
        return [self.proofs[e] for e in sorted(self.proofs)]

    def reset(self) -> None:
        """Crash-restart hook: certificates AND proofs re-emit from the
        restored state; the committee rotation itself is re-derived by
        the restore path (``rotate_to``)."""
        super().reset()
        self.proofs.clear()
