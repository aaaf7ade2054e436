"""The FaultPlan DSL: seeded, declarative adversarial conditions.

Tendermint-BFT's guarantees (PAPER.md; arXiv:1807.04938) are claims about
behavior under message loss, duplication, delay, network partitions, and
crash-restarts. A :class:`FaultPlan` states one such adversarial scenario
as data — per-link fault distributions, scheduled partitions with heal
times, crash-at-step followed by restart-from-checkpoint — and the
deterministic harness interprets it per delivery
(:class:`hyperdrive_tpu_torch.harness.sim.Simulation` with ``chaos=``), while
:class:`hyperdrive_tpu_torch.chaos.proxy.ChaosProxy` applies the same fault
vocabulary to real-socket :class:`~hyperdrive_tpu_torch.transport.TcpNode`
traffic.

Everything is seeded: the same (plan, sim seed) pair produces the same
run, and because the harness records only *post-fault* deliveries, a
failing chaos run replays message-for-message from its
:class:`~hyperdrive_tpu_torch.harness.sim.ScenarioRecord` with no knowledge of
the plan at all (crash/restore/resync lifecycle ops ride a record
trailer; see ROBUSTNESS.md).

Port copy of ``hyperdrive_tpu/chaos/plan.py``, whole: every family draws
the same plan as the JAX package's for the same ``(seed, n)``, and
:meth:`FaultPlan.overlay` rebuilds the epoch-0 tree from the port's
:func:`~hyperdrive_tpu_torch.epochs.genesis_anchor` and
:class:`~hyperdrive_tpu_torch.overlay.Topology`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

__all__ = ["LinkFault", "Partition", "CrashRestart", "FaultPlan"]


@dataclass(frozen=True)
class LinkFault:
    """Per-link fault distribution on the directed link ``src -> dst``.

    Each probability is evaluated once per delivery from the chaos
    engine's dedicated seeded stream. A dropped delivery is silently
    lost (the protocol has no retransmission — exactly the reference's
    trust model, process/process.go:47-60). A duplicated delivery
    arrives once now and once more at the back of the queue. A delayed
    delivery is deferred on the virtual clock by a uniform draw from
    ``[delay_min, delay_max)`` virtual seconds. Faulted copies are never
    re-faulted (no infinite delay/duplication chains); partitions still
    apply to them at their eventual delivery time.
    """

    src: int
    dst: int
    drop: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_min: float = 0.05
    delay_max: float = 0.5


@dataclass(frozen=True)
class Partition:
    """A scheduled network partition on the virtual clock.

    From virtual time ``at`` until ``heal``, deliveries between replicas
    in different groups are blocked (local Timeout events are never
    blocked — a partitioned replica's own timers keep firing). Replicas
    not named in any group form one implicit remainder group, so
    ``groups=((5, 6),)`` isolates replicas 5 and 6 from everyone else.

    On heal, when ``resync_on_heal`` is set (default), every live
    replica whose height lags the network's best commit is jumped
    forward via :class:`~hyperdrive_tpu_torch.replica.ResetHeight` — the
    protocol has no retransmission, so a minority partition can never
    recover the missed heights by itself; resync is the reference's own
    catch-up mechanism (replica/replica.go:222-235).
    """

    at: float
    heal: float
    groups: tuple[tuple[int, ...], ...]
    resync_on_heal: bool = True


@dataclass(frozen=True)
class CrashRestart:
    """Crash ``replica`` at delivery step ``crash_at_step``; restart it
    from its latest checkpoint ``restart_after_steps`` later.

    The crash loses every volatile buffer (sorted queue, burst lane,
    reentrant backlog); only the checkpoint envelope — taken through
    :func:`hyperdrive_tpu_torch.utils.checkpoint.checkpoint_bytes` after every
    delivery the victim handles, the reference's "save after every
    method call" contract (process/state.go:18-20) — survives. On
    restart the Process state is restored (locked/valid values, vote
    logs, once-flags included) and the replica rejoins: in place when
    its height is still live (mid-height, re-arming the current step's
    timeout via :meth:`~hyperdrive_tpu_torch.process.Process.resume`), or via
    ResetHeight when the network committed past it. A replica that
    crashes before handling anything restarts from the default genesis
    state.
    """

    replica: int
    crash_at_step: int
    restart_after_steps: int = 500


@dataclass(frozen=True)
class FaultPlan:
    """One scenario's complete adversarial schedule."""

    links: tuple[LinkFault, ...] = ()
    partitions: tuple[Partition, ...] = ()
    crashes: tuple[CrashRestart, ...] = field(default_factory=tuple)

    def validate(self, n: int) -> None:
        """Reject structurally impossible plans with a clear error
        instead of a mid-run surprise."""
        for lf in self.links:
            if not (0 <= lf.src < n and 0 <= lf.dst < n):
                raise ValueError(
                    f"link fault {lf.src}->{lf.dst} outside 0..{n - 1}"
                )
            for p in (lf.drop, lf.duplicate, lf.delay):
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"link fault probability {p} outside [0, 1]"
                    )
            if not 0.0 <= lf.delay_min <= lf.delay_max:
                raise ValueError(
                    "link delay bounds must satisfy "
                    f"0 <= min <= max, got [{lf.delay_min}, {lf.delay_max}]"
                )
        for part in self.partitions:
            if not 0.0 <= part.at < part.heal:
                raise ValueError(
                    f"partition window [{part.at}, {part.heal}) is empty"
                )
            seen: set[int] = set()
            for group in part.groups:
                for m in group:
                    if not 0 <= m < n:
                        raise ValueError(
                            f"partition member {m} outside 0..{n - 1}"
                        )
                    if m in seen:
                        raise ValueError(
                            f"replica {m} appears in two partition groups"
                        )
                    seen.add(m)
        crashed: set[int] = set()
        for c in self.crashes:
            if not 0 <= c.replica < n:
                raise ValueError(
                    f"crash victim {c.replica} outside 0..{n - 1}"
                )
            if c.replica in crashed:
                raise ValueError(
                    f"replica {c.replica} has two crash schedules"
                )
            crashed.add(c.replica)
            if c.crash_at_step < 1 or c.restart_after_steps < 1:
                raise ValueError("crash/restart steps must be >= 1")

    @classmethod
    def seeded(
        cls,
        seed: int,
        n: int,
        *,
        partition: bool = True,
        crash: bool = True,
        links: bool = True,
    ) -> "FaultPlan":
        """Draw one randomized-but-reproducible scenario: a partition
        isolating up to f replicas with a heal time, one crash-restart
        (inside the isolated group when there is one, so the majority
        keeps its 2f+1 quorum), and a couple of lossy/dup/laggy links.
        The soak CLI (``python -m hyperdrive_tpu_torch.chaos soak``) iterates
        this over scenario seeds."""
        rng = random.Random(seed)
        f = n // 3
        parts: tuple[Partition, ...] = ()
        isolated: list[int] = []
        if partition and f:
            isolated = rng.sample(range(n), rng.randint(1, f))
            at = rng.uniform(0.2, 0.8)
            parts = (
                Partition(
                    at=at,
                    heal=at + rng.uniform(1.0, 3.0),
                    groups=(tuple(isolated),),
                ),
            )
        crashes: tuple[CrashRestart, ...] = ()
        if crash and f:
            victim = rng.choice(isolated) if isolated else rng.randrange(n)
            crashes = (
                CrashRestart(
                    replica=victim,
                    crash_at_step=rng.randint(250, 700),
                    restart_after_steps=rng.randint(200, 600),
                ),
            )
        link_faults: list[LinkFault] = []
        if links:
            for _ in range(rng.randint(0, 3)):
                src, dst = rng.randrange(n), rng.randrange(n)
                link_faults.append(
                    LinkFault(
                        src=src,
                        dst=dst,
                        drop=rng.choice([0.0, 0.05, 0.1]),
                        duplicate=rng.choice([0.0, 0.05]),
                        delay=rng.choice([0.0, 0.1]),
                        delay_min=0.01,
                        delay_max=rng.uniform(0.05, 0.3),
                    )
                )
        plan = cls(
            links=tuple(link_faults), partitions=parts, crashes=crashes
        )
        plan.validate(n)
        return plan

    @classmethod
    def overload(
        cls,
        seed: int,
        n: int,
        *,
        rate: float = 2000.0,
    ) -> "tuple[FaultPlan, object]":
        """The overload fault family (ISSUE 11): open-loop load
        COINCIDING with partitions and heals. Returns ``(plan,
        profile)`` — the same :meth:`seeded` plan the unloaded baseline
        runs, paired with a digest-safe
        :class:`~hyperdrive_tpu_torch.load.generator.LoadProfile` drawn from
        the same seed. The acceptance contract: a run with both applied
        commits the SAME chain digests as the plan alone, because the
        profile stays pinned in the behavior-neutral admission band
        (floor <= SHED_DUPLICATES) and the injector consumes no steps,
        clock, or rng. The soak CLI's ``--overload-every`` leg asserts
        exactly that equality."""
        from hyperdrive_tpu_torch.load.generator import LoadProfile

        plan = cls.seeded(seed, n)
        profile = LoadProfile.seeded(seed, rate=rate)
        if profile.floor > 1:  # SHED_DUPLICATES
            raise ValueError(
                "overload family profiles must stay behavior-neutral "
                f"(floor <= SHED_DUPLICATES), got floor={profile.floor}"
            )
        return plan, profile

    @classmethod
    def churn(
        cls,
        seed: int,
        n: int,
        *,
        est_virtual_time: float = 4.0,
        crash: bool = True,
        links: bool = True,
    ) -> "FaultPlan":
        """The epoch-churn scenario family (ISSUE: dynamic validator
        sets). Three stressors composed so faults LAND ON epoch
        machinery rather than around it:

        - churn during an active partition — the partition window is
          drawn wide (``est_virtual_time`` fractions) so with short
          epochs at least one boundary election + key rotation commits
          while up to f//2 replicas are isolated;
        - crash-restore across an epoch boundary — the victim is chosen
          from the isolated group when there is one, and its restart
          window is long enough that the network usually crosses a
          boundary while it is down, forcing the restore path to
          re-apply epoch state (rotated whoami, new committee) before
          rejoining;
        - laggard rejoining under a rotated key — heal-time resync of
          the isolated group exercises exactly the stale-generation
          reject + retired-key bound in replica.py.

        The caller supplies the epoch schedule on the Simulation side
        (``epochs=EpochConfig(...)``); this plan only shapes WHEN the
        network is hostile. ``est_virtual_time``: rough expected virtual
        duration of the run, used to place the partition window."""
        rng = random.Random((seed << 1) ^ 0x45504F43)
        f = n // 3
        isolated: list[int] = []
        parts: tuple[Partition, ...] = ()
        if f:
            isolated = rng.sample(range(n), rng.randint(1, max(1, f // 2)))
            at = est_virtual_time * rng.uniform(0.25, 0.4)
            heal = at + est_virtual_time * rng.uniform(0.3, 0.45)
            parts = (
                Partition(at=at, heal=heal, groups=(tuple(isolated),)),
            )
        crashes: tuple[CrashRestart, ...] = ()
        if crash and f:
            victim = rng.choice(isolated) if isolated else rng.randrange(n)
            crashes = (
                CrashRestart(
                    replica=victim,
                    crash_at_step=rng.randint(300, 900),
                    restart_after_steps=rng.randint(300, 800),
                ),
            )
        link_faults: list[LinkFault] = []
        if links:
            for _ in range(rng.randint(0, 2)):
                src, dst = rng.randrange(n), rng.randrange(n)
                link_faults.append(
                    LinkFault(
                        src=src,
                        dst=dst,
                        drop=rng.choice([0.0, 0.05]),
                        duplicate=rng.choice([0.0, 0.05]),
                        delay=rng.choice([0.0, 0.1]),
                        delay_min=0.01,
                        delay_max=rng.uniform(0.05, 0.2),
                    )
                )
        plan = cls(
            links=tuple(link_faults), partitions=parts, crashes=crashes
        )
        plan.validate(n)
        return plan

    @classmethod
    def overlay(
        cls,
        seed: int,
        n: int,
        *,
        est_virtual_time: float = 4.0,
        crash: bool = True,
    ) -> "tuple[FaultPlan, object]":
        """The overlay fault family (ISSUE 12): Byzantine contributors
        composed with faults aimed at the aggregation TREE rather than
        at random replicas. Returns ``(plan, OverlayFaults)`` for
        ``Simulation(chaos=plan, overlay=OverlayConfig(faults=...))``.

        The tree-slicing partition is the novel piece: the epoch-0
        topology is a pure function of (seed, genesis anchor, default
        identities), so the plan reconstructs it here — before any sim
        exists — and cuts the network along a level boundary, isolating
        one full 2**level rank block. Inside the partition window every
        member of that block loses its entire sibling half at the level
        above, forcing wave escalation + withhold charging + ranked
        fallback on one side and reciprocal-push starvation handling on
        the other; the monitor then requires honest scores to recover
        after heal.

        Byzantine contributors (up to f//2, disjoint from the sliced
        block so the two stressors compose rather than shadow each
        other) withhold at a seeded level and garbage the rest of their
        frames. Crash-restore rotates an interior (odd-rank, relay-heavy)
        node mid-height, exercising tick disarm/re-arm."""
        import hashlib

        from hyperdrive_tpu_torch.epochs import genesis_anchor
        from hyperdrive_tpu_torch.overlay import OverlayFaults, Topology

        rng = random.Random((seed << 1) ^ 0x4F564C59)
        f = n // 3
        identities = [
            hashlib.sha256(b"sim-replica-%d-%d" % (seed, i)).digest()
            for i in range(n)
        ]
        topo = Topology(seed, genesis_anchor(seed), identities)
        parts: tuple[Partition, ...] = ()
        sliced: tuple = ()
        if topo.levels >= 1 and f:
            level = rng.randint(1, max(1, topo.levels - 1))
            groups = topo.level_groups(level)
            # Cut off one block, capped at f members so quorum survives.
            block = list(rng.choice(groups))
            if len(block) > f:
                block = sorted(rng.sample(block, f))
            sliced = tuple(block)
            at = est_virtual_time * rng.uniform(0.2, 0.35)
            heal = at + est_virtual_time * rng.uniform(0.25, 0.4)
            parts = (Partition(at=at, heal=heal, groups=(sliced,)),)
        byz_pool = [i for i in range(n) if i not in set(sliced)]
        byz_count = min(max(1, f // 2), len(byz_pool)) if f else 0
        byz = tuple(sorted(rng.sample(byz_pool, byz_count))) if byz_count else ()
        faults = OverlayFaults(
            byzantine=byz,
            withhold_levels=(rng.randint(1, max(1, topo.levels)),),
            garbage_rate=rng.uniform(0.2, 0.5),
            stale_rate=rng.uniform(0.0, 0.4),
        )
        crashes: tuple[CrashRestart, ...] = ()
        if crash and f:
            candidates = [i for i in range(n) if i not in byz]
            victim = max(
                candidates, key=lambda i: (topo.rank[i] & 1, -i)
            )
            crashes = (
                CrashRestart(
                    replica=victim,
                    crash_at_step=rng.randint(300, 900),
                    restart_after_steps=rng.randint(300, 800),
                ),
            )
        plan = cls(partitions=parts, crashes=crashes)
        plan.validate(n)
        faults.validate(n)
        return plan, faults
