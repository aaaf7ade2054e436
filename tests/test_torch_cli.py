"""The port's CLIs (``python -m hyperdrive_tpu_torch.{obs,campaign,ops,
exec,parallel,load}``), each called through its ``main(argv)`` in process
with ``--device cpu``.

Where the JAX CLI runs on the host (``obs``, ``campaign``, ``load``,
``parallel serve`` with the null or host verifier), it runs on the same
argv without ``--device`` and the two must print the same lines and JSON,
timing fields and paths aside. The JAX ``exec`` and ``ops`` CLIs jit their
device legs, so the port's are held to the JAX package's host oracles
instead (``exec.ledger.HostLedgerExecutor`` roots, ``crypto/ed25519.py``,
``crypto/bls.py``). Every device CLI has a case in which a wrong device
result makes it fail, and every device subcommand refuses to run without
CUDA unless ``--device cpu`` is given. Only
``test_parallel_remote_tenant_merges_and_matches_the_reference`` starts a
child process.
"""

import contextlib
import copy
import io
import json

import pytest
import torch

from hyperdrive_tpu.campaign.__main__ import main as ref_campaign_main
from hyperdrive_tpu.crypto import bls as ref_bls
from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.exec import ExecutionConfig as RefExecutionConfig
from hyperdrive_tpu.exec.ledger import HostLedgerExecutor as RefHostLedgerExecutor
from hyperdrive_tpu.load.__main__ import main as ref_load_main
from hyperdrive_tpu.obs.__main__ import main as ref_obs_main
from hyperdrive_tpu.ops.msm import msm_plan as ref_msm_plan
from hyperdrive_tpu.parallel import __main__ as ref_parallel_cli
from hyperdrive_tpu_torch.campaign import CampaignConfig
from hyperdrive_tpu_torch.campaign import runner as campaign_runner
from hyperdrive_tpu_torch.campaign.__main__ import main as campaign_main
from hyperdrive_tpu_torch.devsched.queue import SpeculationMismatch
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.exec.__main__ import main as exec_main
from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.load import LoadProfile
from hyperdrive_tpu_torch.load.__main__ import main as load_main
from hyperdrive_tpu_torch.obs.__main__ import main as obs_main
from hyperdrive_tpu_torch.obs.recorder import Recorder
from hyperdrive_tpu_torch.ops import __main__ as ops_cli
from hyperdrive_tpu_torch.ops import ed25519 as ted
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops import ledger as ops_ledger
from hyperdrive_tpu_torch.parallel.__main__ import main as parallel_main
from hyperdrive_tpu_torch.verifier import HostVerifier

torch.set_num_threads(1)

#: Metric names whose values only the card verifier's launch telemetry
#: sets (bucket lanes, device syncs) or that count the journal's
#: device-only kinds: ``obs metrics --pipeline`` compares after them.
DEVICE_METRICS = ("devtel.launch.lanes", "devtel.launch.syncs",
                  "devtel.launch.occupancy", "obs.recorder.total")

#: ``parallel serve`` summary fields read off a clock.
TIMING = ("wall_s", "votes_per_s", "commit_latency_p50_s",
          "commit_latency_p95_s", "commit_latency_p99_s", "clock_offsets")


def call(main, argv):
    """``main(argv)`` in process: (rc, stdout, stderr), with the package
    name folded to the reference's so hint lines compare."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    fold = lambda s: s.replace("hyperdrive_tpu_torch", "hyperdrive_tpu")  # noqa: E731
    return rc, fold(out.getvalue()), fold(err.getvalue())


def both(port_main, ref_main, argv):
    """The port's run with ``--device cpu`` and the reference's without."""
    return call(port_main, [*argv, "--device", "cpu"]), call(ref_main, argv)


def untimed(node):
    """``node`` without its clock-read fields, at any depth."""
    if isinstance(node, dict):
        return {k: untimed(v) for k, v in node.items() if k not in TIMING}
    if isinstance(node, list):
        return [untimed(v) for v in node]
    return node


# ------------------------------------------------------------------ obs


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """Four saved journals that feed every report view: the CLI's
    ``record``, an overloaded run, an execution run and a storm
    campaign."""
    d = tmp_path_factory.mktemp("journals")
    call(obs_main, ["record", "-o", d / "record.json", "--heights", 3])
    kw = dict(n=4, target_height=3, seed=5, timeout=1.0, delivery_cost=1e-3,
              observe=True, device="cpu")
    sim = Simulation(certificates=True, load=LoadProfile.seeded(1, rate=3000.0), **kw)
    sim.run()
    sim.obs.save(d / "load.json")
    sim = Simulation(execution=ExecutionConfig(accounts=8, txs_per_block=8, stake_every=2,
                                               stake_accounts=4), **kw)
    sim.run()
    sim.obs.save(d / "exec.json")
    rec = Recorder()
    campaign_runner.run_campaign(
        CampaignConfig(family="storm", validators=32, committee_size=8, epochs=2,
                       attackers=2, waves=2, sybils=4),
        device="cpu", obs=rec.scoped(-1))
    rec.save(d / "campaign.json")
    return d


def test_obs_record_equals_the_reference(tmp_path):
    (rc, out, _), (ref_rc, ref_out, _) = (
        call(m, ["record", "-o", tmp_path / name, "--heights", 3, "--seed", 4])
        for m, name in ((obs_main, "port.json"), (ref_obs_main, "ref.json")))
    got, want = json.loads(out), json.loads(ref_out)
    assert rc == ref_rc == 0 and got["completed"] and got["events"] > 0
    assert got.pop("journal") != want.pop("journal")
    assert got == want
    port, ref = (json.loads((tmp_path / n).read_text()) for n in ("port.json", "ref.json"))
    assert port["events"] == ref["events"]


VIEWS = ("", "--tenants", "--overload", "--overlay", "--exec", "--proofs",
         "--campaign", "--critical-path")


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("journal", ["record", "load", "exec", "campaign"])
def test_obs_report_views_equal_the_reference(journals, journal, view, as_json):
    argv = ["report", journals / f"{journal}.json"] + [a for a in (view,) if a]
    argv += ["--json"] if as_json else []
    got, want = call(obs_main, argv), call(ref_obs_main, argv)
    assert got == want
    if (journal, view) in (("record", ""), ("load", "--overload"), ("exec", "--exec"),
                           ("exec", "--proofs"), ("campaign", "--campaign")):
        assert got[0] == 0 and len(got[1]) > 100


def test_obs_merge_and_export_equal_the_reference(journals, tmp_path):
    paths = [journals / "record.json", journals / "exec.json"]
    outs = []
    for m, tag in ((obs_main, "port"), (ref_obs_main, "ref")):
        merged, trace = tmp_path / f"{tag}-merged.json", tmp_path / f"{tag}-trace.json"
        rc, out, _ = call(m, ["merge", *paths, "-o", merged])
        rc2, out2, _ = call(m, ["export", merged, "-o", trace])
        outs.append((rc, rc2, json.loads(out), json.loads(out2)))
        assert json.loads(out)["merged"] == str(merged)
        assert json.loads(out2)["trace"] == str(trace)
    for got in outs:
        got[2].pop("merged")
        got[3].pop("trace")
    assert outs[0] == outs[1] and outs[0][:2] == (0, 0) and outs[0][2]["journals"] == 2
    for name in ("merged", "trace"):
        assert ((tmp_path / f"port-{name}.json").read_bytes()
                == (tmp_path / f"ref-{name}.json").read_bytes())


ARTIFACT = {
    "benchdiff_gate": ["consensus.block_wall_s"],
    "consensus": {"block_wall_s": [0.010, 0.011, 0.010, 0.012], "heights_per_s": 95.0},
    "verify": {"speedup": [3.0, 3.1, 2.9], "rows": 4096},
}


@pytest.mark.parametrize("as_json", [False, True])
def test_obs_benchdiff_equals_the_reference(tmp_path, as_json):
    slow = copy.deepcopy(ARTIFACT)
    slow["consensus"]["block_wall_s"] = [v * 1.6 for v in slow["consensus"]["block_wall_s"]]
    for name, doc in (("old", ARTIFACT), ("same", ARTIFACT), ("slow", slow)):
        (tmp_path / f"{name}.json").write_text(json.dumps(doc))
    for new, want_rc in (("same", 0), ("slow", 1)):
        argv = ["benchdiff", tmp_path / "old.json", tmp_path / f"{new}.json",
                "--threshold", 0.1] + (["--json"] if as_json else [])
        got = call(obs_main, argv)
        assert got == call(ref_obs_main, argv) and got[0] == want_rc


def test_obs_metrics_equals_the_reference(tmp_path):
    outs = []
    for m, tag in ((obs_main, "port"), (ref_obs_main, "ref")):
        snap, prom = tmp_path / f"{tag}.json", tmp_path / f"{tag}.prom"
        argv = ["metrics", "--heights", 3, "-o", snap, "--prometheus", prom]
        rc, out, _ = call(m, argv + (["--device", "cpu"] if tag == "port" else []))
        got = json.loads(out)
        assert (got.pop("snapshot"), got.pop("prometheus")) == (str(snap), str(prom))
        outs.append((rc, got, snap.read_text(), prom.read_text()))
    assert outs[0] == outs[1] and outs[0][0] == 0


def _without_device_metrics(snap: dict) -> dict:
    return {sec: {k: v for k, v in vals.items() if k not in DEVICE_METRICS}
            for sec, vals in snap.items()}


def test_obs_metrics_pipeline_equals_the_reference_after_device_names(tmp_path):
    argv = ["metrics", "--pipeline", "--heights", 2]
    (rc, out, _), (ref_rc, ref_out, _) = both(
        obs_main, ref_obs_main, argv + ["-o", tmp_path / "port.json"])
    call(ref_obs_main, argv + ["-o", tmp_path / "ref.json"])
    got, want = json.loads(out), json.loads(ref_out)
    for d in (got, want):
        d.pop("digest")
        d.pop("snapshot")
    assert rc == ref_rc == 0 and got == want and got["completed"]
    port, ref = (json.loads((tmp_path / n).read_text()) for n in ("port.json", "ref.json"))
    assert port["counters"]["devtel.launches"] > 0
    assert _without_device_metrics(port) == _without_device_metrics(ref)


def test_obs_metrics_pipeline_fails_on_a_wrong_verdict(monkeypatch):
    # Every verdict False: the first pipelined settle's speculation is
    # refuted, which ends the run (``python -m`` exits 1 on it).
    monkeypatch.setattr(ed25519_cuda, "verify",
                        lambda *a: torch.zeros(a[0].shape[0], dtype=torch.bool))
    with pytest.raises(SpeculationMismatch):
        call(obs_main, ["metrics", "--pipeline", "--heights", 2, "--device", "cpu"])


# ------------------------------------------------------------- campaign

CAMPAIGN = ["--validators", 32, "--committee", 8, "--attackers", 2, "--sybils", 4,
            "--epochs", 2, "--waves", 2]


def test_campaign_run_and_replay_equal_the_reference(tmp_path):
    port, ref = both(campaign_main, ref_campaign_main,
                     ["run", *CAMPAIGN, "--json", "--dump-ok", tmp_path / "dumps"])
    assert port == ref and port[0] == 0
    assert port[1].count(" ok\n") == 3 and port[1].count("dumped") == 3
    bins = sorted((tmp_path / "dumps").glob("*.bin"))
    assert len(bins) == 3
    got, want = both(campaign_main, ref_campaign_main, ["replay", bins[0], "--json"])
    assert got == want and got[0] == 0 and "digest-identical" in got[1]


def test_campaign_violation_dumps_and_a_wrong_verdict_fails_replay(tmp_path, monkeypatch):
    rc, out, _ = call(campaign_main, ["run", "--family", "storm", *CAMPAIGN, "--device", "cpu",
                                      "--dump-ok", tmp_path / "ok"])
    assert rc == 0
    (dump,) = (tmp_path / "ok").glob("*.bin")
    # A flipped verdict moves the storm's trajectory: replay must refuse.
    real = HostVerifier.verify_signatures

    def flipped(self, items):
        mask = list(real(self, items))
        mask[0] = not mask[0]
        return mask

    monkeypatch.setattr(HostVerifier, "verify_signatures", flipped)
    rc, out, _ = call(campaign_main, ["replay", dump, "--device", "cpu"])
    assert rc == 1 and "DIGEST MISMATCH" in out
    monkeypatch.undo()

    def violated(config, summary):
        def check():
            raise campaign_runner.InvariantViolation("storm.test", "injected")
        return [check]

    monkeypatch.setattr(campaign_runner, "_checks_for", violated)
    rc, out, _ = call(campaign_main, ["run", "--family", "storm", *CAMPAIGN, "--device", "cpu",
                                      "--out", tmp_path / "bad"])
    assert rc == 1 and "VIOLATION" in out and "reproduce:" in out
    names = sorted(p.name.split(".", 1)[1] for p in (tmp_path / "bad").iterdir())
    assert names == ["bin", "journal.json", "json"]


# ----------------------------------------------------------------- load


def test_load_soak_equals_the_reference(tmp_path):
    argv = ["soak", "--scenarios", 1, "--n", 4, "--target", 2, "--out", tmp_path]
    got, want = call(load_main, argv), call(ref_load_main, argv)
    assert got == want and got[0] == 0
    assert "ok escalation" in got[1] and "overload soak ok: 1 scenarios" in got[1]


# ------------------------------------------------------------- parallel


@pytest.mark.parametrize("verifier", ["null", "host"])
def test_parallel_serve_equals_the_reference(verifier):
    (rc, out, _), (ref_rc, ref_out, _) = both(
        parallel_main, ref_parallel_cli.main,
        ["serve", "--verifier", verifier, "--tenants", 2, "--heights", 3, "--json", "--parity"])
    got, want = json.loads(out), json.loads(ref_out)
    assert rc == ref_rc == 0 and got["completed"] and got["parity_ok"]
    assert untimed(got) == untimed(want)


def test_parallel_remote_tenant_merges_and_matches_the_reference(tmp_path):
    journal = tmp_path / "serve.json"
    rc, out, _ = call(parallel_main, [
        "serve", "--verifier", "host", "--tenants", 2, "--heights", 3, "--remote-tenants", 1,
        "--parity", "--journal", journal, "--json", "--device", "cpu"])
    got = json.loads(out)
    assert rc == 0 and got["completed"] and got["parity_ok"]
    (child,) = got["remote"]["children"]
    assert child["done"] and child["commits"] == 3
    assert child["digest"] == ref_parallel_cli._dedicated_digest("remote-0", 4, 3, True, "host")
    assert got["journals"] == [str(journal), str(tmp_path / "serve.remote-0.json")]
    rc, out, _ = call(obs_main, ["merge", *got["journals"], "-o", tmp_path / "merged.json"])
    merged = json.loads(out)
    assert rc == 0 and merged["origins"] == [1, 2] and merged["orphans"] == 0
    argv = ["report", tmp_path / "merged.json", "--critical-path"]
    assert call(obs_main, argv) == call(ref_obs_main, argv)


def test_parallel_device_verifier_fails_on_a_wrong_verdict(monkeypatch):
    # Every verdict False: no quorum, so no tenant finishes in time.
    monkeypatch.setattr(ed25519_cuda, "verify",
                        lambda *a: torch.zeros(a[0].shape[0], dtype=torch.bool))
    rc, out, err = call(parallel_main, ["serve", "--verifier", "device", "--device", "cpu",
                                        "--tenants", 1, "--heights", 1, "--timeout", 0.2,
                                        "--json"])
    assert rc == 1 and json.loads(out)["completed"] is False and "--timeout" in err


# ----------------------------------------------------------------- exec

#: ``exec parity --blocks 1 --accounts 8 --txs 8``'s legs: (config,
#: genesis stakes), as the CLI builds them.
EXEC_LEGS = {
    "exec-apply": (dict(accounts=8, txs_per_block=8, stake_every=3, stake_accounts=4,
                        seed=7), (5, 9, 2, 7)),
    "exec-signed": (dict(accounts=8, txs_per_block=8, stake_every=4, stake_accounts=4,
                         seed=8, sign_txs=True, bad_sig_every=8), (3, 3, 3, 3)),
    "exec-insolvent": (dict(accounts=8, txs_per_block=8, stake_every=2, stake_accounts=4,
                            seed=9, amount_cap=64, initial_balance=40), (1, 0, 2, 0)),
}


def test_exec_parity_roots_equal_the_host_oracle(monkeypatch):
    roots = {}
    real = DeviceLedgerExecutor.advance_to

    def spy(self, height):
        root = real(self, height)
        roots.setdefault((self.config.seed, self.config.amount_cap, height), set()).add(root)
        return root

    monkeypatch.setattr(DeviceLedgerExecutor, "advance_to", spy)
    rc, out, err = call(exec_main, ["parity", "--blocks", 1, "--accounts", 8, "--txs", 8,
                                    "--pipelined", "--device", "cpu"])
    assert rc == 0 and err == "" and out.endswith("exec parity ok\n")
    for name, (kw, genesis) in EXEC_LEGS.items():
        ref = RefHostLedgerExecutor(RefExecutionConfig(**kw), genesis)
        root = ref.advance_to(1)
        cap = ExecutionConfig(**kw).amount_cap
        assert roots[(kw["seed"], cap, 1)] == {root}, name
        assert (f"ok {name}: 1 blocks, roots identical, applied={ref.applied_total} "
                f"rejected={ref.rejected_total}\n") in out
    assert "ok exec-pipelined-signed: 1 blocks pipelined == sequential" in out


def test_exec_prove_equals_the_host_oracle():
    rc, out, _ = call(exec_main, ["prove", "--blocks", 2, "--accounts", 8, "--txs", 8,
                                  "--device", "cpu"])
    kw, _ = EXEC_LEGS["exec-apply"]
    ref = RefHostLedgerExecutor(RefExecutionConfig(**kw))
    ref.advance_to(2)
    depth = len(ref.prove(7).siblings)
    assert rc == 0 and out == (
        "ok prove: 2 blocks, 3 accounts host==device, codec roundtrip, root "
        f"verification, 4 forgeries rejected (depth={depth})\nexec prove ok\n")


def test_exec_fails_on_a_wrong_device_root(monkeypatch):
    real = ops_ledger.apply_block_chain_merkle_cols_torch

    def skewed(*args):
        out = list(real(*args))
        out[3] = out[3] ^ 1  # the running root's first word
        return tuple(out)

    monkeypatch.setattr(ops_ledger, "apply_block_chain_merkle_cols_torch", skewed)
    rc, _, err = call(exec_main, ["prove", "--blocks", 2, "--accounts", 8, "--txs", 8,
                                  "--device", "cpu"])
    assert rc == 1 and "FAIL prove: host/device root mismatch" in err


def test_exec_parity_fails_on_a_wrong_signature_verdict(monkeypatch):
    # Every verdict True: the corrupted lane is admitted on both executors
    # alike, so only the check against the workload can see it.
    monkeypatch.setattr(ed25519_cuda, "verify",
                        lambda *a: torch.ones(a[0].shape[0], dtype=torch.bool))
    rc, out, err = call(exec_main, ["parity", "--blocks", 1, "--accounts", 8, "--txs", 8,
                                    "--device", "cpu"])
    assert rc == 1 and out == "" and "FAIL exec-signed: the verifier's admission mask" in err


# ------------------------------------------------------------------ ops


def test_ops_msm_parity_with_rlc_matches_the_jax_oracle(monkeypatch):
    monkeypatch.setattr(ops_cli, "hed", ref_ed)
    rc, out, _ = call(ops_cli.main, ["msm-parity", "--n", 4, "--windows", 2, "--rlc",
                                     "--device", "cpu"])
    plan = ref_msm_plan(4, 2)
    lines = out.splitlines()
    assert rc == 0 and lines[0] == (
        f"ok msm-kernel: n=4 windows=2 groups={plan['groups']}x{plan['group_size']} "
        f"depth={plan['reduction_depth']} matches host reference")
    assert lines[1].startswith("ok rlc-msm: n=4 masks == fallbacks=1 transcript=")
    assert lines[2] == "msm parity ok"


def test_ops_msm_parity_fails_on_a_wrong_point(monkeypatch):
    real = ted.msm_kernel
    monkeypatch.setattr(ted, "msm_kernel",
                        lambda px, py, pt, digits: real(px, py, pt, -digits))
    rc, out, err = call(ops_cli.main, ["msm-parity", "--n", 4, "--windows", 2,
                                       "--device", "cpu"])
    assert rc == 1 and out.startswith("FAIL msm-kernel") and "msm parity FAILED" in err


@pytest.mark.slow
def test_ops_bls_parity_matches_the_jax_oracle(monkeypatch):
    # Full-window G1 MSM and two pairings on the host: over 5 s here. The
    # card runs it in chip_smoke.py's cli phase (``ops bls-parity --n 8``).
    monkeypatch.setattr(ops_cli, "bls", ref_bls)
    rc, out, _ = call(ops_cli.main, ["bls-parity", "--n", 4, "--device", "cpu"])
    assert rc == 0 and out.splitlines() == [
        "ok fp381-mul: 4 random products match Python ints",
        "ok g1-msm: n=4 windows=64 matches host reference",
        out.splitlines()[2],
        "ok bls-e2e: 4-of-4 device aggregate verifies, forgery rejected",
        "bls parity ok",
    ] and out.splitlines()[2].startswith("ok g1-aggregate: width=4 mask=")


# ------------------------------------------------------ --device refusal

DEVICE_ARGV = {
    "obs metrics --pipeline": (obs_main, ["metrics", "--pipeline"]),
    "campaign run": (campaign_main, ["run"]),
    "campaign replay": (campaign_main, ["replay", "missing.bin"]),
    "ops msm-parity": (ops_cli.main, ["msm-parity"]),
    "ops bls-parity": (ops_cli.main, ["bls-parity"]),
    "exec parity": (exec_main, ["parity"]),
    "exec prove": (exec_main, ["prove"]),
    "parallel serve --verifier device": (parallel_main, ["serve", "--verifier", "device"]),
    "parallel serve": (parallel_main, ["serve"]),
}


@pytest.mark.parametrize("name", sorted(DEVICE_ARGV))
def test_device_subcommands_refuse_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    main, argv = DEVICE_ARGV[name]
    with pytest.raises(SystemExit) as err:
        call(main, argv)
    assert "CUDA is not available" in str(err.value.code)
