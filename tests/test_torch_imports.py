"""The PyTorch port stands alone: no module of ``hyperdrive_tpu_torch``,
and not ``chip_smoke.py``, imports JAX or anything of ``hyperdrive_tpu``;
its entry points default to the card and refuse to run without one."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
from hyperdrive_tpu_torch.verifier import NullVerifier

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import hyperdrive_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from hyperdrive_tpu_torch import native
from hyperdrive_tpu_torch.ops import ed25519_cuda, g1_cuda
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "hyperdrive_tpu" or m.startswith("hyperdrive_tpu."))
# Importing builds nothing: the native library and the CUDA kernels are
# compiled at first use.
built = (native._lib is not None or native._lib_err is not None
         or ed25519_cuda._LIB is not None or g1_cuda._LIB is not None)
print(json.dumps({"names": names, "bad": bad, "built": built}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = json.loads(subprocess.run(
        [sys.executable, "-c", "import json\n" + _PROBE], cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.splitlines()[-1])
    assert len(out["names"]) >= 15
    for name in ("native", "devsched", "devsched.queue", "devsched.policy",
                 "transport", "tallyflush", "devsched.flusher", "utils.checkpoint",
                 "harness.deploy", "crypto.shamir", "ops.shamir", "ops.msm",
                 "certificates", "ops.rootmix", "ops.merkle", "ops.ledger", "exec",
                 "exec.ledger", "exec.device", "crypto.bls", "ops.limbs", "ops.fp381",
                 "ops.g1", "ops.g1_cuda", "batch", "campaign", "campaign.record",
                 "campaign.families", "campaign.runner", "parallel", "parallel.service",
                 "parallel.mesh", "parallel.multihost",
                 "obs", "obs.recorder", "obs.metrics", "obs.devtel", "obs.perfetto",
                 "obs.report", "obs.slo", "analysis", "analysis.annotations",
                 "utils.trace", "utils.cli", "obs.__main__", "campaign.__main__",
                 "ops.__main__", "exec.__main__", "parallel.__main__",
                 "load.__main__", "devsched.__main__", "analysis.sanitizer",
                 "chaos.__main__", "entry"):
        assert f"hyperdrive_tpu_torch.{name}" in out["names"]
    assert out["bad"] == []
    assert out["built"] is False


def test_no_source_names_jax_or_the_jax_package():
    files = sorted((ROOT / "hyperdrive_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "hyperdrive_tpu"), (path, mod)


def test_batch_verifier_defaults_to_the_card():
    validators = [bytes([i + 1]) * 32 for i in range(4)]
    if torch.cuda.is_available():
        assert TorchBatchVerifier().device.type == "cuda"
        assert DeviceTallyFlusher(NullVerifier(), validators).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchBatchVerifier()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceTallyFlusher(NullVerifier(), validators)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run on it")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
