"""The port's chaos soak CLI (``python -m hyperdrive_tpu_torch.chaos``)
against the JAX package's, both through ``main(argv)`` in process at a
tiny depth (``--n 4 --target 3``, one or two scenarios).

Every leg runs in one of the cases below, in both packages on the same
argv (the port's with ``--device cpu`` where a leg reaches device work);
the exit codes, standard output and standard error must be equal once
the package names and output directories are folded and the metrics
probe's scrape size (its text carries wall-clock latencies) is masked.
Dumps are byte-equal, and each package's ``replay`` of either dump prints
the same lines. No child process is started.
"""

import contextlib
import io
import os
import re

import pytest
import torch

import hyperdrive_tpu.analysis.sanitizer as ref_san
import hyperdrive_tpu.chaos.__main__ as ref_cli
import hyperdrive_tpu_torch.analysis.sanitizer as port_san
import hyperdrive_tpu_torch.chaos.__main__ as port_cli

torch.set_num_threads(1)

TINY = ["--n", "4", "--target", "3"]
#: The default-on legs switched off, for the cases that test other legs.
QUIET = ["--replay-every", "0", "--pipelined-every", "0", "--certs-every", "0",
         "--overload-every", "0"]

LEGS = {
    "consensus": ["--scenarios", "2", "--replay-every", "1", "--pipelined-every", "1",
                  "--certs-every", "1", "--overload-every", "1", "--churn-every", "2",
                  "--overlay-every", "2"],
    "execution": ["--scenarios", "1", *QUIET, "--exec-every", "1",
                  "--exec-pipeline-every", "1", "--proofs-every", "1",
                  "--campaign-every", "1"],
    "serving": ["--scenarios", "1", *QUIET, "--tenants-every", "1",
                "--fuzz-frames-every", "1", "--metrics-every", "1"],
    "bls": ["--scenarios", "1", *QUIET, "--bls-certs-every", "1"],
}


def _fold(text: str, dirs) -> str:
    text = text.replace("hyperdrive_tpu_torch", "hyperdrive_tpu")
    for d in dirs:
        text = text.replace(str(d), "<out>")
    return re.sub(r"(ok metrics .* )bytes=\d+", r"\1bytes=<n>", text)


def call(cli, argv, *dirs):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    return rc, _fold(out.getvalue(), dirs), _fold(err.getvalue(), dirs)


def both(argv, tmp_path, device=True, dump_ok=False):
    """The port's run (``--device cpu``) and the reference's, each with
    output directories of its own."""
    pdir, rdir = tmp_path / "port", tmp_path / "ref"
    dev = ["--device", "cpu"] if device else []
    runs = []
    for cli, d, extra in ((port_cli, pdir, dev), (ref_cli, rdir, [])):
        ok = ["--dump-ok", d / "ok"] if dump_ok else []
        runs.append(call(cli, [*argv, "--out", d / "fail", *ok, *extra], d))
    return runs[0], runs[1], pdir, rdir


@pytest.mark.parametrize("legs", sorted(LEGS))
def test_soak_legs_print_the_reference_lines(legs, tmp_path):
    argv = ["soak", *TINY, *LEGS[legs]]
    port, ref, pdir, rdir = both(argv, tmp_path, dump_ok=legs == "consensus")
    assert port == ref
    assert port[0] == 0 and port[1].endswith("soak ok: 2 scenarios, 0 violations\n"
                                             if legs == "consensus" else
                                             "soak ok: 1 scenarios, 0 violations\n")
    for line in {"consensus": ("ok churn", "ok overlay", "ok overload"),
                 "execution": ("ok exec ", "ok exec-pipeline", "ok proofs", "ok campaign"),
                 "serving": ("ok tenants", "ok wire-fuzz", "ok metrics"),
                 "bls": ("ok bls",)}[legs]:
        assert line in port[1]
    if legs == "consensus":
        # The first passing churn record, dumped byte-equal by both runs:
        # each package replays it with the epoch chain walked from genesis.
        dump = pdir / "ok" / "churn_seed_1.bin"
        assert dump.read_bytes() == (rdir / "ok" / "churn_seed_1.bin").read_bytes()
        rp = call(port_cli, ["replay", dump])
        rr = call(ref_cli, ["replay", dump])
        assert rp == rr and rp[0] == 0
        assert "epoch chain ok: 3 transitions verified from genesis" in rp[1]


@pytest.mark.parametrize("armed", ["1", "0"])
def test_soak_arms_the_sanitizer_on_every_replica(armed, tmp_path, monkeypatch):
    monkeypatch.setenv("HD_SANITIZE", armed)
    counts = {}
    for san in (port_san, ref_san):
        real = san.install
        calls = counts.setdefault(san.__name__, [])
        monkeypatch.setattr(san, "install",
                            lambda proc, real=real, calls=calls: calls.append(1) or real(proc))
    # No device leg: the soak runs without --device (and without CUDA).
    port, ref, _, _ = both(["soak", *TINY, "--scenarios", "1"], tmp_path, device=False)
    assert port == ref and port[0] == 0
    installs = [len(c) for c in counts.values()]
    assert installs[0] == installs[1]
    assert (installs[0] > 0) == (armed == "1")


def test_failure_dump_replays_in_both_packages(tmp_path, monkeypatch):
    for cli in (port_cli, ref_cli):
        real = cli.InvariantMonitor.check_final

        def check_final(self, result, real=real, cli=cli):
            real(self, result)
            raise cli.InvariantViolation("test", "injected after the real checks")

        monkeypatch.setattr(cli.InvariantMonitor, "check_final", check_final)
    port, ref, pdir, rdir = both(["soak", *TINY, "--scenarios", "2"], tmp_path)
    assert port == ref
    assert port[0] == 1 and port[1] == ""
    assert "FAIL seed=1 n=4 test: injected after the real checks" in port[2]
    assert "reproduce: python -m hyperdrive_tpu.chaos replay <out>/fail/chaos_seed_1.bin" in port[2]
    names = sorted(os.listdir(pdir / "fail"))
    assert names == sorted(os.listdir(rdir / "fail"))
    for name in ("chaos_seed_1.bin", "chaos_seed_1.txt"):
        assert (pdir / "fail" / name).read_bytes() == (rdir / "fail" / name).read_bytes()
    monkeypatch.undo()
    outs = [call(cli, ["replay", d / "fail" / "chaos_seed_1.bin", *dev])
            for d in (pdir, rdir)
            for cli, dev in ((port_cli, ["--device", "cpu"]), (ref_cli, []))]
    assert all(o == outs[0] for o in outs) and outs[0][0] == 0
    assert outs[0][1].startswith("replayed seed=1 n=4 target=3: completed=True")


@pytest.mark.parametrize("leg", ["--bls-certs-every", "--exec-every",
                                 "--exec-pipeline-every"])
def test_device_legs_refuse_without_cuda(leg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        call(port_cli, ["soak", *TINY, "--scenarios", "1", leg, "1"])
    assert "CUDA is not available" in str(err.value.code)
