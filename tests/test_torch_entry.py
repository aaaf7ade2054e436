"""The port's entry points (``hyperdrive_tpu_torch.entry``), the
counterpart of the repository root's ``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``'s step (row 2's plain version, then the tally)
  on a seeded signed window: the mask lane for lane against the JAX
  package's host oracle (``crypto/ed25519.py``), the counts and flags
  against the JAX ``tally_counts`` / ``quorum_flags`` on the same mask.
  Exact equality: verdicts and counts are booleans and integers.
- ``dryrun_multichip(1)`` on a world-size-1 gloo group in this process;
  a wrong verdict injected into its sharded step makes it raise
  ``RuntimeError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.ops import tally as ref_tally
from hyperdrive_tpu_torch import entry as entry_mod
from hyperdrive_tpu_torch.ops import ed25519_cuda

torch.set_num_threads(1)


@pytest.fixture
def no_group():
    """The dry run starts a world-size-1 group; tear it down after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_entry_step_matches_the_oracle_and_the_jax_tally():
    fn, example = entry_mod.entry(device="cpu")
    shapes = [(tuple(t.shape), t.dtype, t.device.type) for t in example[:6]]
    assert shapes == [((64, 32), torch.uint8, "cpu")] * 4 + [
        ((2, 32, 8), torch.int32, "cpu"), ((2, 8), torch.int32, "cpu")]
    assert example[6] == 10

    args, items = entry_mod.signed_example_args(device="cpu")
    ok, counts, flags = fn(*args)
    oracle = np.array([ref_ed.verify(pub, msg, sig) for pub, msg, sig in items])
    assert np.array_equal(ok.numpy(), oracle)
    lanes = {(i // 32, i % 32) for i in np.flatnonzero(~oracle)}
    assert lanes == set(entry_mod.SIGNED_CORRUPT)

    present = jnp.asarray(oracle.reshape(2, 32))
    want = ref_tally.tally_counts(jnp.asarray(args[4].numpy()), present,
                                  jnp.asarray(args[5].numpy()))
    want_flags = ref_tally.quorum_flags(want, args[6])
    assert {k: v.tolist() for k, v in counts.items()} == {
        k: np.asarray(v).tolist() for k, v in want.items()}
    assert {k: v.tolist() for k, v in flags.items()} == {
        k: np.asarray(v).tolist() for k, v in want_flags.items()}
    assert counts["matching"].tolist() == [31, 20]
    assert flags["quorum_matching"].tolist() == [True, False]


def test_dryrun_multichip_on_one_gloo_rank(no_group, capsys):
    line = entry_mod.dryrun_multichip(1, device="cpu")
    assert capsys.readouterr().out == line + "\n"
    assert line.startswith("dryrun_multichip ok: mesh=(1x1) axes=('hr','val') on cpu")
    assert "quorum split correct (round0=1>=1, round1=0<1)" in line
    assert "accumulated 1 verified prevotes across 2 launches" in line


def test_a_wrong_verdict_makes_the_dry_run_raise(no_group, monkeypatch):
    # The sharded step's verify says every lane verified: the corrupted
    # lane (0, 1) must fail the dry run's first mask check.
    monkeypatch.setattr(ed25519_cuda, "verify",
                        lambda ax, *rest: torch.ones(ax.shape[0], dtype=torch.bool))
    with pytest.raises(RuntimeError, match=r"verify mask wrong at \(0, 1\)"):
        entry_mod.dryrun_multichip(1, device="cpu")


def test_entry_points_refuse_without_cuda(no_group, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry_mod.entry, lambda: entry_mod.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        entry_mod.dryrun_multichip(2, device="cpu")
