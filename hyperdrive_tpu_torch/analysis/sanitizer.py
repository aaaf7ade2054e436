"""Runtime consensus sanitizer: the HDS001–HDS005 invariant checks.

It watches the running automaton. It interposes on the Process seams
(the committer and broadcaster slots are plain assignable attributes),
on the DeviceTallyFlusher's per-launch tally view, and on every decode
at a wire seam:

* **HDS001** quorum recount: every commit is re-derived from the HOST
  message logs (a valid proposal round whose value holds >= 2f+1
  precommits). A device tally that lies its way past L49 dies here.
* **HDS002** lock sanity: ``locked_round <= current_round`` at every
  broadcast and commit (the automaton only ever locks the round it is
  in, paper L36).
* **HDS003** height monotonicity: committed heights strictly increase
  and always equal the automaton's ``current_height`` at commit time.
* **HDS004** settle-path parity: the flusher's device counts must equal
  the host counters for every answered query (the
  :class:`~hyperdrive_tpu_torch.ops.votegrid.CheckedTallyView`
  differential, re-raised under the rule name).
* **HDS005** wire decode budget: every frame decoded at a wire seam
  (TcpNode ingress, ServicePort/RemoteServiceClient frames, flight,
  scenario, campaign and checkpoint loaders, trace stamps, overlay
  partial frames) is charged against the ``max_bytes`` its
  ``@wire_codec`` registration declared
  (:mod:`~hyperdrive_tpu_torch.analysis.annotations`). A decode that
  reads past its family budget, or a frame family with no registration,
  raises here.

Toggled by ``HD_SANITIZE`` (the tests arm it through ``tests/conftest.py``;
``chip_smoke.py`` arms it for its ``sanitize`` phase). Violations raise
:class:`SanitizerError`, an ``AssertionError`` whose message leads with
the rule name so harnesses can match on it.

Port copy of ``hyperdrive_tpu/analysis/sanitizer.py``: the same rules,
names and messages. One fault of the reference is fixed: an HDS005
breach reported to a seam's bound recorder handle emits on its track,
where the reference raises TypeError (ROADMAP Queue C, C2). The HDS004
view subclasses the port's ``CheckedTallyView`` and is built once, like
the budget reader; the module imports no torch until
``maybe_tally_check`` is armed.
"""

from __future__ import annotations

import os

from hyperdrive_tpu_torch.analysis.annotations import wire_budget_for
from hyperdrive_tpu_torch.codec import Reader, SerdeError

__all__ = ["SanitizerError", "enabled", "install", "maybe_install",
           "maybe_tally_check", "WireBudget", "maybe_wire_reader",
           "wire_charge"]


class SanitizerError(AssertionError):
    """An HDS invariant violation. ``rule`` is the HDSnnn code; the
    message always starts with it."""

    def __init__(self, rule: str, message: str):
        super().__init__(f"{rule}: {message}")
        self.rule = rule


def enabled() -> bool:
    return os.environ.get("HD_SANITIZE", "0").strip().lower() in (
        "1", "true", "on", "yes"
    )


class WireBudget:
    """HDS005 accounting for ONE frame family: resolves the registered
    ``max_bytes`` for ``tag`` and charges decode reads against it.

    ``reader(payload)`` returns a budget-capped
    :class:`~hyperdrive_tpu_torch.codec.Reader` whose exhaustion
    re-raises as HDS005 (instead of the generic SerdeError budget
    message), so a decoder that reads past its family's declared budget
    dies loudly under HD_SANITIZE while plain malformed input keeps its
    typed SerdeError. ``charge(nbytes)`` is the object-frame variant for
    seams with no byte decode (overlay partial frames): the handler
    estimates the frame's wire size and charges it up front.
    """

    __slots__ = ("tag", "max_bytes", "_obs")

    def __init__(self, tag: str, obs=None):
        max_bytes = wire_budget_for(tag)
        if max_bytes is None:
            raise SanitizerError(
                "HDS005",
                f"decode of unregistered wire frame family {tag!r}: every "
                "decode seam must name a @wire_codec tag (or a "
                "declare_wire_budget entry) so its byte budget is "
                "accounted",
            )
        self.tag = tag
        self.max_bytes = max_bytes
        self._obs = obs

    def _exceeded(self, needed: int) -> SanitizerError:
        obs = self._obs
        if obs is not None:
            from hyperdrive_tpu_torch.obs.recorder import BoundRecorder

            detail = f"{self.tag}:{needed}"
            if isinstance(obs, BoundRecorder):
                # A seam's bound handle (TcpNode, ServicePort) carries its
                # own track; the reference's five-argument emit raises
                # TypeError on it (ROADMAP Queue C, C2).
                obs.emit("wire.budget.exceeded", -1, -1, detail)
            else:
                obs.emit("wire.budget.exceeded", -1, -1, -1, detail)
        return SanitizerError(
            "HDS005",
            f"decode of a {self.tag!r} frame read past its registered "
            f"budget: needs {needed} bytes, max_bytes={self.max_bytes} "
            "(raise the registration or fix the decoder's caps)",
        )

    def charge(self, nbytes: int) -> int:
        if nbytes > self.max_bytes:
            raise self._exceeded(nbytes)
        return nbytes

    def reader(self, payload: bytes):
        # Charge the frame itself first: a payload already wider than
        # the family budget is a violation before the first read.
        if len(payload) > self.max_bytes:
            raise self._exceeded(len(payload))
        r = _BudgetReader(payload, rem=self.max_bytes)
        r._budget = self
        return r


class _BudgetReader(Reader):
    """The budget-capped reader, defined once: it sits on every frame
    decode under HD_SANITIZE."""

    __slots__ = ("_budget",)

    def _take(self, n):
        try:
            return Reader._take(self, n)
        except SerdeError:
            b = self._budget
            if self.rem < n:  # budget breach, not mere underflow
                raise b._exceeded(b.max_bytes - self.rem + n) from None
            raise


def maybe_wire_reader(tag: str, payload: bytes, obs=None, rem=None):
    """The decode-seam helper: an HDS005 budget reader for ``tag`` when
    the sanitizer is on, a plain Reader otherwise. Wire seams call this
    instead of ``Reader(payload)``. ``rem`` keeps a seam's sanitizer-off
    byte budget where it differs from the codec default (the large
    scenario and checkpoint loaders)."""
    if enabled():
        return WireBudget(tag, obs=obs).reader(payload)
    return Reader(payload) if rem is None else Reader(payload, rem=rem)


def wire_charge(tag: str, nbytes: int, obs=None) -> int:
    """Object-frame seams (no byte decode): charge an estimated wire
    size against ``tag``'s budget under HD_SANITIZE; no-op otherwise.
    Returns ``nbytes`` so the charge can wrap an expression."""
    if enabled():
        WireBudget(tag, obs=obs).charge(nbytes)
    return nbytes


def _check_lock(proc) -> None:
    st = proc.state
    if st.locked_round > st.current_round:
        raise SanitizerError(
            "HDS002",
            f"locked_round {st.locked_round} > current_round "
            f"{st.current_round} at height {st.current_height} "
            f"(replica {proc.whoami!r}): the automaton only locks the "
            "round it is in (L36)",
        )


class _SanitizedCommitter:
    """Wraps the committer seam: HDS001 + HDS002 + HDS003 on the way
    into every commit. Delegates everything else to the wrapped
    committer (which may itself be the replica's tracing wrapper)."""

    def __init__(self, inner, proc):
        self._inner = inner
        self._proc = proc
        self._last_height = None

    def commit(self, height, value):
        proc = self._proc
        st = proc.state
        if height != st.current_height:
            raise SanitizerError(
                "HDS003",
                f"commit at height {height} while the automaton is at "
                f"{st.current_height} (replica {proc.whoami!r})",
            )
        if self._last_height is not None and height <= self._last_height:
            raise SanitizerError(
                "HDS003",
                f"commit height {height} does not advance past "
                f"{self._last_height} (replica {proc.whoami!r}): heights "
                "must be strictly increasing",
            )
        _check_lock(proc)
        need = 2 * proc.f + 1
        quorum = any(
            p.value == value
            and st.propose_is_valid.get(rnd, False)
            and st.count_precommits_for(rnd, value) >= need
            for rnd, p in st.propose_logs.items()
        )
        if not quorum:
            raise SanitizerError(
                "HDS001",
                f"commit of {value!r} at height {height} has no host-log "
                f"quorum: no valid proposal round carries >= {need} "
                f"(2f+1) precommits for it (replica {proc.whoami!r}); a "
                "device tally overruled the message logs",
            )
        self._last_height = height
        return self._inner.commit(height, value)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _SanitizedBroadcaster:
    """Wraps the broadcaster seam: HDS002 before every outbound step, so
    the automaton's visible actions never leave a state where it locked
    a round it has not reached."""

    def __init__(self, inner, proc):
        self._inner = inner
        self._proc = proc

    def broadcast_propose(self, msg):
        _check_lock(self._proc)
        return self._inner.broadcast_propose(msg)

    def broadcast_prevote(self, msg):
        _check_lock(self._proc)
        return self._inner.broadcast_prevote(msg)

    def broadcast_precommit(self, msg):
        _check_lock(self._proc)
        return self._inner.broadcast_precommit(msg)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def install(proc):
    """Interpose HDS checks on ``proc``'s committer/broadcaster seams.
    Idempotent; tolerates absent seams (a Process built without a
    committer has no commit effect to guard)."""
    if proc.committer is not None and not isinstance(
        proc.committer, _SanitizedCommitter
    ):
        proc.committer = _SanitizedCommitter(proc.committer, proc)
    if proc.broadcaster is not None and not isinstance(
        proc.broadcaster, _SanitizedBroadcaster
    ):
        proc.broadcaster = _SanitizedBroadcaster(proc.broadcaster, proc)
    return proc


def maybe_install(proc):
    """:func:`install` iff ``HD_SANITIZE`` is on (the Replica
    constructor's hook)."""
    if enabled():
        install(proc)
    return proc


#: The HDS004 view class, built on the first armed call: it subclasses
#: the vote grid's CheckedTallyView, whose module loads torch.
_HDS004_VIEW = None


def maybe_tally_check():
    """HDS004 factory for the DeviceTallyFlusher's ``tally_check`` seam:
    a ``(view, proc) -> view`` wrapper cross-checking device counts
    against the host counters, or None when the sanitizer is off."""
    global _HDS004_VIEW
    if not enabled():
        return None
    if _HDS004_VIEW is None:
        from hyperdrive_tpu_torch.ops.votegrid import CheckedTallyView

        class _HDS004View(CheckedTallyView):
            __slots__ = ()

            def _check(self, device, host, what):
                try:
                    return super()._check(device, host, what)
                except SanitizerError:
                    raise
                except AssertionError as e:
                    raise SanitizerError(
                        "HDS004",
                        f"device/host tally divergence: {e} — the redundant "
                        "settle paths no longer agree",
                    ) from e

        _HDS004_VIEW = _HDS004View
    return _HDS004_VIEW
