"""Safety/liveness invariant monitor for chaos runs.

The monitor wraps a :class:`~hyperdrive_tpu_torch.harness.sim.Simulation`'s
commit callback — the same seam the HD_SANITIZE runtime sanitizer
interposes (:mod:`~hyperdrive_tpu_torch.analysis.sanitizer`) — and
receives lifecycle notifications
(crash/restore/heal) from the chaos engine. It checks, *while the run is
still live* so the ScenarioRecord is intact at raise time:

- **no-fork-across-restarts** — one committed value per height,
  network-wide, forever: a restored replica re-committing a height must
  agree with what the network committed, and no two replicas may ever
  commit different values at the same height (safety under ≤ f faults,
  paper Lemma: agreement).
- **bounded rounds to commit after every heal** — after a partition
  heals, each live replica's next commit must land within
  ``max_rounds_after_heal`` rounds (liveness once synchrony resumes,
  paper round-synchronization argument).

and post-run via :meth:`check_final`:

- **commit-digest equality among honest replicas** — byte-equality of
  every overlapping commit, cross-checked against the obs journal's
  commit events when the sim runs with ``observe=True``.
- **completeness** — the run actually reached its target height.

A violation raises :class:`InvariantViolation` (an ``AssertionError``
subclass so plain pytest/soak harnesses catch it naturally); the soak
CLI reacts by dumping the ScenarioRecord and obs journal for
message-for-message replay.

Port copy of ``hyperdrive_tpu/chaos/monitor.py``, whole: the journal
cross-check (``_check_journal``) and the static checks
(``check_tenant_fairness``, ``check_campaign_proportionality``,
``check_storm_hygiene``, ``check_campaign_economy``) included.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from hyperdrive_tpu_torch.harness.sim import Simulation, SimulationResult

__all__ = ["InvariantMonitor", "InvariantViolation"]


class InvariantViolation(AssertionError):
    """A chaos invariant failed; ``kind`` names which one."""

    def __init__(self, kind: str, detail: str) -> None:
        super().__init__(f"{kind}: {detail}")
        self.kind = kind


class InvariantMonitor:
    """Attach to a Simulation *before* ``run()``; it hooks the commit
    callback and registers itself as ``sim._chaos_monitor`` so the chaos
    engine reports crashes, restores, and heals as they happen."""

    def __init__(
        self,
        sim: "Simulation",
        *,
        max_rounds_after_heal: int = 12,
        honest: "set[int] | None" = None,
    ) -> None:
        self.sim = sim
        self.max_rounds_after_heal = max_rounds_after_heal
        self.honest = set(range(sim.n)) if honest is None else set(honest)
        #: height -> committed value: the network-wide chain. Survives
        #: crashes and restores by construction — it is never reset.
        self.chain: dict[int, bytes] = {}
        self.heals: list[float] = []
        self.crashes: list[tuple[int, float]] = []
        self.restores: list[tuple[int, int]] = []
        self.commit_rounds_after_heal: list[int] = []
        self._await_heal_commit: "set[int] | None" = None
        #: (epoch, boundary height) per observed epoch switch.
        self.epoch_switches: list[tuple[int, int]] = []
        self.commit_rounds_after_epoch: list[int] = []
        self._last_epoch = 0
        self._epoch_boundary: "int | None" = None
        self._await_epoch_commit: "set[int] | None" = None
        self._orig_commit = sim._on_commit
        sim._on_commit = self._commit
        sim._chaos_monitor = self

    # -- live hooks --------------------------------------------------

    def _commit(self, i: int, height: int, value: bytes):
        prev = self.chain.get(height)
        if prev is not None and prev != value:
            raise InvariantViolation(
                "fork",
                f"replica {i} committed {value.hex()[:16]} at height "
                f"{height}; the network committed {prev.hex()[:16]}",
            )
        self.chain[height] = value
        awaiting = self._await_heal_commit
        if awaiting is not None and i in awaiting:
            awaiting.discard(i)
            rounds = self.sim.replicas[i].proc.current_round + 1
            self.commit_rounds_after_heal.append(rounds)
            if rounds > self.max_rounds_after_heal:
                raise InvariantViolation(
                    "liveness",
                    f"replica {i} needed {rounds} rounds to commit "
                    f"height {height} after heal "
                    f"(bound {self.max_rounds_after_heal})",
                )
        # Bounded rounds-to-commit after churn: armed at each epoch
        # switch below; checked BEFORE the commit callback runs (the
        # sim's boundary handler rotates the round machinery, so
        # current_round must be read pre-rotation).
        eawait = self._await_epoch_commit
        if (
            eawait is not None
            and i in eawait
            and self._epoch_boundary is not None
            and height > self._epoch_boundary
        ):
            eawait.discard(i)
            rounds = self.sim.replicas[i].proc.current_round + 1
            self.commit_rounds_after_epoch.append(rounds)
            if rounds > self.max_rounds_after_heal:
                raise InvariantViolation(
                    "epoch-liveness",
                    f"replica {i} needed {rounds} rounds to commit "
                    f"height {height} after the epoch "
                    f"{self._last_epoch} switch "
                    f"(bound {self.max_rounds_after_heal})",
                )
        ret = self._orig_commit(i, height, value)
        sim = self.sim
        if (
            getattr(sim, "epoch_schedule", None) is not None
            and sim.epoch > self._last_epoch
        ):
            self._last_epoch = sim.epoch
            self.epoch_switches.append((sim.epoch, height))
            self._epoch_boundary = height
            self._await_epoch_commit = {
                j
                for j in range(sim.n)
                if sim.alive[j] and j in self.honest
            }
        return ret

    def note_crash(self, victim: int, now: float) -> None:
        self.crashes.append((victim, now))

    def note_restore(self, victim: int, resync_height: int) -> None:
        self.restores.append((victim, resync_height))

    def note_heal(self, now: float) -> None:
        self.heals.append(now)
        sim = self.sim
        self._await_heal_commit = {
            i for i in range(sim.n) if sim.alive[i] and i in self.honest
        }

    # -- post-run ----------------------------------------------------

    def check_final(self, result: "SimulationResult") -> "InvariantMonitor":
        """Assert the post-run invariants; returns self for chaining."""
        result.assert_safety()
        has_exec = bool(getattr(self.sim, "executors", None))
        for i in sorted(self.honest):
            for height, value in result.commits[i].items():
                want = self.chain.get(height)
                if want is None:
                    continue
                if has_exec:
                    # Execution runs store root-extended commits
                    # (value + state root); the monitor's chain holds
                    # the raw consensus value from the callback seam.
                    # Root agreement is _check_exec's dedicated job.
                    value = value[: len(want)]
                if value != want:
                    raise InvariantViolation(
                        "digest",
                        f"replica {i} holds {value.hex()[:16]} at height "
                        f"{height}; chain has {want.hex()[:16]}",
                    )
        self._check_journal()
        # Post-heal liveness: a completed run IS the liveness proof —
        # completion means every replica individually committed the
        # target height, and the harness stops delivering the moment
        # that happens, so a replica can legitimately end mid-height
        # with its commit quorum still in flight. Only when the run
        # STALLED (queue drained or max_steps without completing) does
        # an unemptied awaiting set witness a real post-heal deadlock.
        if (
            not result.completed
            and self.heals
            and self._await_heal_commit
        ):
            raise InvariantViolation(
                "liveness",
                f"replicas {sorted(self._await_heal_commit)} never "
                "committed after the last heal",
            )
        if not result.completed:
            raise InvariantViolation(
                "liveness",
                f"run stalled below target; heights={result.heights}",
            )
        self._check_epochs()
        self._check_overlay()
        self._check_exec()
        return self

    def _check_epochs(self) -> None:
        """Dynamic-validator-set invariants (epoch runs only):

        - **no retired key in a caught-up whitelist** — once a rotation
          retires a key at its bound height, no replica at or past that
          height may still whitelist it (so no commit can count it);
        - **epoch-proof chain continuity** — the UNION of per-replica
          proof chains covers every epoch 1..current and verifies
          end-to-end from genesis. Per-replica chains legitimately have
          gaps (a resync jumps a laggard OVER boundary commits, so it
          never mints those proofs); the network-wide claim is that
          SOMEONE certified every hop, and the hops link up.
        """
        sim = self.sim
        sched = getattr(sim, "epoch_schedule", None)
        if sched is None:
            return
        for sig, bad_from in sim._retired.items():
            for j in sorted(self.honest):
                if not sim.alive[j]:
                    continue
                r = sim.replicas[j]
                if (
                    r.proc.current_height >= bad_from
                    and sig in r.procs_allowed
                ):
                    raise InvariantViolation(
                        "retired-key",
                        f"replica {j} at height {r.proc.current_height} "
                        f"still whitelists a key retired from height "
                        f"{bad_from}",
                    )
        certifiers = [
            c for c in getattr(sim, "certifiers", []) if c is not None
        ]
        if not certifiers or sim.epoch == 0:
            return
        covered: dict = {}
        for c in certifiers:
            for e, pr in getattr(c, "proofs", {}).items():
                covered.setdefault(e, pr)
        missing = [
            e for e in range(1, sim.epoch + 1) if e not in covered
        ]
        if missing:
            raise InvariantViolation(
                "epoch-chain",
                f"no replica holds a transition proof for epochs "
                f"{missing} (current epoch {sim.epoch})",
            )
        from hyperdrive_tpu_torch.epochs import EpochChainError, verify_epoch_chain

        try:
            verify_epoch_chain(
                sched.signatories(0),
                [covered[e] for e in range(1, sim.epoch + 1)],
            )
        except EpochChainError as exc:
            raise InvariantViolation("epoch-chain", str(exc)) from exc

    def _check_overlay(self) -> None:
        """Aggregation-overlay invariants (overlay runs only):

        - **no honest peer permanently demoted** — contribution scoring
          may transiently demote an honest peer caught behind a
          partition or mid-restore (its frames look withheld from the
          far side), and per-commit rehabilitation restores it once the
          charges stop. PERMANENT means the commit floor advanced far
          enough past the peer's last charge that rehabilitation must
          have lifted it back over ``demote_at`` — and it didn't. A
          still-demoted honest peer whose last charge was too recent
          for the available runway is tolerated: the scenario ended,
          not the recovery mechanism.
        - **never-starve** — if any level window ever expired with
          coverage still missing, the ranked direct-gossip fallback
          must have engaged: timeouts without fallback means the
          escalation ladder dead-ends and slow peers starve silently.
        """
        ov = getattr(self.sim, "_overlay", None)
        if ov is None:
            return
        heal = ov.config.heal_rate
        permanent = []
        for p in ov.honest_demoted():
            if p not in self.honest:
                continue
            deficit = ov.scores.demote_at - ov.scores.scores[p] + 1
            runway = ov._floor - ov._last_charge_floor.get(p, ov._floor)
            if heal and runway * heal < deficit:
                continue
            permanent.append(p)
        if permanent:
            raise InvariantViolation(
                "overlay-demotion",
                f"honest peers {permanent} permanently demoted (scores "
                f"{[ov.scores.scores[p] for p in permanent]}, floor "
                f"{ov._floor}, byzantine={sorted(ov._byz)}) — "
                f"rehabilitation had the runway and did not recover them",
            )
        exhausted = getattr(ov, "windows_exhausted", 0)
        if exhausted and not ov.fallback_engaged:
            raise InvariantViolation(
                "overlay-starvation",
                f"{exhausted} level windows exhausted all "
                f"{ov.config.max_waves} waves with coverage missing but "
                "the ranked fallback never engaged",
            )

    def _check_exec(self) -> None:
        """Replicated-ledger invariants (execution runs only):

        - **state-root agreement** — every honest replica that applied
          a block at a committed height derived the SAME chained state
          root: the deterministic-execution analogue of no-fork. The
          commit values already carry the root (the sim chains it into
          the commit digest), so a divergence would eventually surface
          as a value fork too — checking the executors directly
          localizes blame to the apply path and catches a replica whose
          ledger ran ahead of or behind its own commits.
        - **commit/ledger binding** — each replica's stored commit at a
          height must end with that replica's own root for the height,
          so the root the certificate chain vouches for is the root the
          ledger actually computed.
        - **no rolled-back root committed** — the speculative pipeline's
          hard promise (``--exec-pipeline-every`` soak legs): a root
          computed under a wrong signature guess and then unwound
          (``discarded_roots``) must never appear inside ANY honest
          replica's committed value. A leak means a commit record was
          minted from pre-rollback state — the one failure mode
          speculation must not have.
        """
        executors = getattr(self.sim, "executors", None)
        if not executors:
            return
        # Device executors queue applied heights on-device; materialize
        # every pending root before auditing (host sync is a no-op).
        for ex in {id(e): e for e in executors}.values():
            ex.sync()
        by_height: dict[int, dict[bytes, list[int]]] = {}
        for i, ex in enumerate(executors):
            if i not in self.honest:
                continue
            for height, root in ex.roots.items():
                by_height.setdefault(height, {}).setdefault(
                    root, []
                ).append(i)
        for height in sorted(by_height):
            by_root = by_height[height]
            if len(by_root) > 1:
                raise InvariantViolation(
                    "exec-root",
                    f"state-root fork at height {height}: "
                    + "; ".join(
                        f"{root[:8].hex()} from replicas {reps}"
                        for root, reps in sorted(by_root.items())
                    ),
                )
        for i in sorted(self.honest):
            ex = executors[i]
            for height, value in self.sim.commits[i].items():
                root = ex.roots.get(height)
                if root is not None and not value.endswith(root):
                    raise InvariantViolation(
                        "exec-root",
                        f"replica {i}'s commit at height {height} does "
                        f"not end with its own state root "
                        f"{root[:8].hex()}",
                    )
        discarded: set[bytes] = set()
        for i, ex in enumerate(executors):
            if i in self.honest:
                discarded |= getattr(ex, "discarded_roots", set())
        if discarded:
            for i in sorted(self.honest):
                for height, value in self.sim.commits[i].items():
                    for root in discarded:
                        if root in value:
                            raise InvariantViolation(
                                "exec-rollback",
                                f"rolled-back root {root[:8].hex()} "
                                f"appears in replica {i}'s committed "
                                f"value at height {height} — a commit "
                                "was minted from speculative state that "
                                "the pipeline later unwound",
                            )

    @staticmethod
    def check_tenant_fairness(policy) -> None:
        """Multi-tenant drain-policy invariant (the ``--tenants-every``
        soak leg): the starvation bound is a hard promise, not a
        heuristic. A :class:`~hyperdrive_tpu_torch.devsched.DeficitRoundRobin`
        forces a command into the next launch once it has been deferred
        ``starve_after`` times, so no command ever observes a deferral
        count beyond the bound — however hard one tenant firehoses the
        shared queue. ``max_deferrals`` is the policy's own high-water
        mark; exceeding the bound means the forced lane failed."""
        bound = getattr(policy, "starve_after", 0)
        seen = getattr(policy, "max_deferrals", 0)
        if bound and seen > bound:
            raise InvariantViolation(
                "tenant-fairness",
                f"a tenant command was deferred {seen} times "
                f"(starvation bound {bound}) — the forced lane never "
                f"fired for it",
            )

    # --------------------------------------------------- campaign checks
    # Sim-free staticmethods (the check_tenant_fairness precedent): the
    # campaign runner hands them the campaign summary, and they speak
    # InvariantViolation like every other probe, so the chaos soak, the
    # campaign CLI and the tests all share one failure currency.

    @staticmethod
    def check_campaign_proportionality(
        trajectory, *, grind_width: int = 1
    ) -> None:
        """The arXiv:2004.12990 proportionality bound over a WHOLE
        capture trajectory: cumulative adversary committee seats must
        not exceed cumulative proportional expectation plus a
        concentration allowance plus the grinding uplift.

        Per epoch ``e`` with realized adversary stake share ``p_e`` and
        committee size ``k``, a proportional election seats the
        adversary ``k * p_e`` in expectation with per-epoch deviation
        ``sigma_e = sqrt(k * p_e * (1 - p_e))``. A grinder choosing the
        best of ``W`` candidate boundary blocks takes the max of ``W``
        roughly-independent draws — worth at most
        ``sigma_e * sqrt(2 ln W)`` extra per epoch (the Gaussian
        max bound; LOGARITHMIC in grinding effort, which is the whole
        point of the anchor chain). On top, a 3-sigma allowance over
        the campaign's summed variance covers ordinary luck. Exceeding
        the total means the election machinery leaks more than
        grinding theory permits — a real disproportionality bug, not
        adversary luck."""
        import math

        seats = 0.0
        expected = 0.0
        var = 0.0
        grind_slack = 0.0
        uplift = math.sqrt(2.0 * math.log(max(grind_width, 2)))
        for row in trajectory:
            k = row["committee"]
            p = row["adv_stake"] / row["total_stake"]
            sigma = math.sqrt(k * p * (1.0 - p))
            seats += row["seats"]
            expected += k * p
            var += k * p * (1.0 - p)
            grind_slack += sigma * uplift
        bound = expected + grind_slack + 3.0 * math.sqrt(var)
        if seats > bound:
            raise InvariantViolation(
                "capture-proportionality",
                f"adversary took {seats:.0f} committee seats over "
                f"{len(list(trajectory))} epochs; proportional "
                f"expectation {expected:.1f} + grinding allowance "
                f"{grind_slack:.1f} (width {grind_width}) + 3-sigma "
                f"{3.0 * math.sqrt(var):.1f} bounds it at {bound:.1f}",
            )

    @staticmethod
    def check_storm_hygiene(summary: dict) -> None:
        """Signed-vote-storm invariants over a storm (or coincidence)
        gate summary: verify failures and demotions attribute ONLY to
        attackers (an honest signer must never fail batch verify or be
        reputation-shed), shed classes stay inside the closed
        vocabulary, and — when the reputation loop is on — repeat
        forgers actually demote and stop reaching the verifier by the
        final wave (the loop's entire reason to exist)."""
        from hyperdrive_tpu_torch.load.backpressure import SHED_CLASSES

        gate = summary["gate"]
        honest = set(summary["honest"])
        attackers = set(summary["attackers"])
        for cls in gate["shed"]:
            if cls not in SHED_CLASSES:
                raise InvariantViolation(
                    "storm-shed-class",
                    f"gate shed under unknown class {cls!r}",
                )
        leaked = sorted(set(gate["verify_failed"]) & honest)
        if leaked:
            raise InvariantViolation(
                "storm-attribution",
                f"honest signers {leaked} charged with verify "
                "failures — misattribution would let a storm demote "
                "bystanders",
            )
        bad_demotions = sorted(set(gate["demoted"]) - attackers)
        if bad_demotions:
            raise InvariantViolation(
                "storm-attribution",
                f"non-attackers {bad_demotions} reputation-demoted",
            )
        if summary.get("reputation"):
            if gate["demotions"] < 1 or not gate["shed"].get(
                "reputation"
            ):
                raise InvariantViolation(
                    "storm-reputation",
                    "reputation loop on, yet no forger was demoted "
                    "or reputation-shed across the storm",
                )
            last = summary["waves"][-1]
            if last["attacker_rows_verified"]:
                raise InvariantViolation(
                    "storm-reputation",
                    f"{last['attacker_rows_verified']} forged rows "
                    "still reached batch verify in the final wave — "
                    "the reputation loop failed to move the shed "
                    "ahead of the verifier",
                )
            if last["admitted"] < summary["honest_rows"]:
                raise InvariantViolation(
                    "storm-liveness",
                    f"final wave admitted {last['admitted']} rows but "
                    f"the honest workload alone is "
                    f"{summary['honest_rows']} — the storm starved "
                    "honest prevotes instead of shedding forgers",
                )

    @staticmethod
    def check_campaign_economy(summary: dict) -> None:
        """Coincidence-family overlay invariants: the never-starve
        doctrine holds under the slice (every epoch that exhausted
        retry windows engaged the ranked fallback), and after the heal
        runway no HONEST validator is still contribution-demoted —
        partitions are forgiven, only persistent misbehavior is not."""
        for row in summary.get("overlay", ()):
            if row["windows_exhausted"] and not row["fallback_engaged"]:
                raise InvariantViolation(
                    "campaign-starvation",
                    f"epoch {row['epoch']}: {row['windows_exhausted']} "
                    "slots exhausted their retry windows with no "
                    "fallback engagement",
                )
        stuck = summary.get("honest_demoted_final", [])
        if stuck:
            raise InvariantViolation(
                "campaign-demotion",
                f"honest validators {stuck} still demoted after the "
                "heal runway — amnesty plus contribution credit must "
                "always repay a partition's debt",
            )

    def _check_journal(self) -> None:
        """Cross-check the obs flight recorder against the chain: every
        journalled commit event's value prefix must match what the
        monitor saw at the callback seam (observe=True runs only)."""
        snapshot = getattr(self.sim.obs, "snapshot", None)
        if snapshot is None:
            return
        for ev in snapshot():
            if ev.kind != "commit":
                continue
            want = self.chain.get(ev.height)
            if want is None or ev.detail is None:
                continue
            if not want.hex().startswith(str(ev.detail)):
                raise InvariantViolation(
                    "journal",
                    f"obs journal commit at height {ev.height} carries "
                    f"{ev.detail}; chain has {want.hex()[:16]}",
                )
