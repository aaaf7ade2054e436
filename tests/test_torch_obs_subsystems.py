"""Observed simulations of the subsystems whose hooks ROADMAP Queue A item
4b ported (the overlay, chaos with load and admission, execution, epochs
with BLS certificates) against the JAX package's.

The same seeded configuration runs in both packages with ``observe=True``
(the JAX side on the host, n <= 16, nothing jitted), compared by journal
(every event, in order), journal digest and metrics snapshot. The chaos
runs arm both packages' ``InvariantMonitor``, whose ``_check_journal``
cross-checks the journal's commits against the chain. The port's device
ledger executor (its plain PyTorch version on the CPU) journals what the
JAX host executor does, but for the ``dev=`` flag and the ``full=`` flag
of its Merkle update.
"""

import pytest
import torch

from hyperdrive_tpu.chaos import FaultPlan as RefFaultPlan
from hyperdrive_tpu.chaos.monitor import InvariantMonitor as RefInvariantMonitor
from hyperdrive_tpu.chaos.monitor import InvariantViolation as RefInvariantViolation
from hyperdrive_tpu.epochs import EpochConfig as RefEpochConfig
from hyperdrive_tpu.exec import ExecutionConfig as RefExecutionConfig
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.load import LoadProfile as RefLoadProfile
from hyperdrive_tpu.overlay import OverlayConfig as RefOverlayConfig
from hyperdrive_tpu_torch.chaos import FaultPlan
from hyperdrive_tpu_torch.chaos.monitor import InvariantMonitor, InvariantViolation
from hyperdrive_tpu_torch.epochs import EpochConfig
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.load import LoadProfile
from hyperdrive_tpu_torch.overlay import OverlayConfig

torch.set_num_threads(1)

_OVERLAY = dict(seed=29, target_height=2, delivery_cost=1e-3)
_CHAOS = dict(n=8, target_height=4, seed=1002, timeout=20.0, delivery_cost=1e-3)
_EXEC = dict(accounts=16, txs_per_block=12)


def _cases(overlay, plan, load, execution, epochs):
    """name -> (Simulation kwargs, the event-kind families it must journal)."""
    return {
        "overlay": (dict(n=16, overlay=overlay(), **_OVERLAY), ("overlay.",)),
        "overlay_signed": (dict(n=8, sign=True, overlay=overlay(), **_OVERLAY),
                           ("overlay.",)),
        "chaos_load": (dict(chaos=plan.seeded(1002, 8), load=load(rate=100.0, seed=17),
                            **_CHAOS), ("chaos.", "admission.", "load.")),
        "exec": (dict(n=4, target_height=4, seed=3, execution=execution(**_EXEC)),
                 ("exec.", "merkle.")),
        "epochs_bls": (dict(n=4, target_height=4, seed=3, certificates=True,
                            bls_certificates=True,
                            epochs=epochs(epoch_length=2, committee_size=4)),
                       ("cert.", "bls.", "epoch.proof")),
    }


_PORT = _cases(OverlayConfig, FaultPlan, LoadProfile, ExecutionConfig, EpochConfig)
_REF = _cases(RefOverlayConfig, RefFaultPlan, RefLoadProfile, RefExecutionConfig,
              RefEpochConfig)


def _run(case):
    kw, _ = _PORT[case]
    ref_kw, _ = _REF[case]
    got = Simulation(**kw, observe=True, device="cpu")
    ref = RefSimulation(**ref_kw, observe=True)
    mons = (InvariantMonitor(got), RefInvariantMonitor(ref)) if "chaos" in kw else None
    res, ref_res = got.run(), ref.run()
    if mons is not None:
        mons[0].check_final(res)
        mons[1].check_final(ref_res)
    return got, res, ref, ref_res, mons


@pytest.fixture(scope="module")
def observed():
    return {case: _run(case) for case in _PORT}


@pytest.mark.parametrize("case", sorted(_PORT))
def test_observed_subsystem_journal_and_metrics_equal_jax(observed, case):
    got, res, ref, ref_res, _ = observed[case]
    assert res.completed and res.commit_digest() == ref_res.commit_digest()
    assert res.steps == ref_res.steps
    assert got.obs.snapshot() == ref.obs.snapshot()
    assert (got.obs.digest(), got.obs.dropped) == (ref.obs.digest(), ref.obs.dropped)
    assert got.metrics_snapshot() == ref.metrics_snapshot()
    assert got.registry.digest() == ref.registry.digest()
    kinds = {e.kind for e in got.obs.snapshot()}
    for family in _PORT[case][1]:
        assert any(k.startswith(family) for k in kinds), family


def test_chaos_monitor_checks_the_journal_like_jax(observed):
    got, res, ref, _, (mon, ref_mon) = observed["chaos_load"]
    assert mon.crashes and mon.restores and mon.heals
    assert {"chaos.crash", "chaos.restore", "admission.shed", "load.offered"} <= {
        e.kind for e in got.obs.snapshot()}
    # A chain that disagrees with a journalled commit is a violation.
    height = max(h for h, _ in mon.chain.items())
    errors = []
    for m, exc in ((mon, InvariantViolation), (ref_mon, RefInvariantViolation)):
        m.chain[height] = b"\xff" * 32
        with pytest.raises(exc) as err:
            m._check_journal()
        errors.append((err.value.kind, str(err.value)))
    assert errors[0] == errors[1] and errors[0][0] == "journal"


def test_device_executor_journals_the_host_executors_events():
    # The port's DeviceLedgerExecutor (plain PyTorch ops on the CPU)
    # against the JAX host executor: the same exec.* and merkle.* events
    # but for the executor flags (dev=1, and full=1: every block rewrites
    # a 16-account tree).
    kw = dict(n=4, target_height=4, seed=3, observe=True)
    got = Simulation(**kw, execution=ExecutionConfig(**_EXEC, device=True), device="cpu")
    ref = RefSimulation(**kw, execution=RefExecutionConfig(**_EXEC))
    assert got.run().commit_digest() == ref.run().commit_digest()

    def flags(events, dev):
        out = []
        for e in events:
            detail = e.detail
            if e.kind == "exec.apply":
                detail = detail.replace(f"dev={dev}", "dev=-")
            elif e.kind == "merkle.update":
                detail = detail.replace(f"full={dev}", "full=-")
            out.append((e.ts, e.replica, e.height, e.round, e.kind, detail))
        return out

    events = got.obs.snapshot()
    assert flags(events, 1) == flags(ref.obs.snapshot(), 0)
    assert [e.kind for e in events].count("exec.root") == 4 * 4
