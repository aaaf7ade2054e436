"""The port's execution layer against the JAX package's.

- ``ExecutionConfig`` (checks, ``as_ints``/``from_ints``), the kinds and
  the tx ladder;
- ``ops/ledger.py``: the state digest and root fold (uint32 wrap held in
  int64) against the jnp twins; ``apply_block`` against the JAX
  ``apply_block`` with overdrawn senders, STAKE/UNSTAKE, rejected
  signatures, pad rows and negative balances; the Merkleized step
  ``apply_block_chain_merkle_cols_torch`` against
  ``apply_block_chain_merkle_cols_jax`` on both Merkle branches;
- ``exec/ledger.py`` and ``exec/device.py``: ``BlockSource`` columns,
  values and signature triples byte for byte; the port's host and device
  (``device="cpu"``) executors against the JAX executors over six
  heights, through speculation with wrong guesses, a double rollback
  against one capture, ``discarded_roots``, ``prove`` and ``ProofBasis``;
- the burst ``Simulation(execution=...)`` at n = 4 against the JAX run
  (sequential with per-replica device executors, unsigned and signed,
  the signed run verifying each block once through the sim's batch
  verifier; pipelined and signed, fused and two-kind), and the option
  combinations still refused.

Every comparison is exact: state, masks, counts, roots and tree words
are integers.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hyperdrive_tpu.exec import ExecutionConfig as RefConfig
from hyperdrive_tpu.exec.device import DeviceLedgerExecutor as RefDeviceExecutor
from hyperdrive_tpu.exec.ledger import BlockSource as RefBlockSource
from hyperdrive_tpu.exec.ledger import HostLedgerExecutor as RefHostExecutor
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.ops import ledger as ref_ledger
from hyperdrive_tpu.ops import merkle as ref_merkle
from hyperdrive_tpu.ops import rootmix as ref_rootmix
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.devsched import DeviceWorkQueue
from hyperdrive_tpu_torch.exec import ExecutionConfig
from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
from hyperdrive_tpu_torch.exec.ledger import (
    EXEC_ORIGIN,
    BlockSource,
    ExecApplyLauncher,
    HostLedgerExecutor,
)
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops import ledger, rootmix
from hyperdrive_tpu_torch.verifier import HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

M32 = 0xFFFFFFFF

#: The executors' ledger: 1,000 accounts (1,024 leaves) and blocks in the
#: 256-lane bucket, so the JAX step compiles once and takes the
#: incremental Merkle branch; small balances, so senders overdraw.
LEDGER = dict(accounts=1000, txs_per_block=200, stake_every=3, stake_accounts=8,
              seed=9, amount_cap=900, initial_balance=1500)
SIGNED = dict(LEDGER, accounts=64, txs_per_block=24, sign_txs=True, bad_sig_every=4)


def _pair(**kw):
    return ExecutionConfig(**kw), RefConfig(**kw)


def _u32(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _executor(kind, cfg, source=None):
    if kind == "device":
        return DeviceLedgerExecutor(cfg, (7, 0, 3), source=source, device="cpu")
    return HostLedgerExecutor(cfg, (7, 0, 3), source=source)


def _same_ledger(ex, ref):
    assert ex.height == ref.height
    assert ex.roots == ref.roots and ex.root == ref.root
    assert ex.genesis_root == ref.genesis_root
    assert (ex.applied_total, ex.rejected_total) == (ref.applied_total, ref.rejected_total)
    assert list(map(int, ex.balances)) == list(map(int, ref.balances))
    assert list(map(int, ex.stakes)) == list(map(int, ref.stakes))


# ----------------------------------------------------------- config, kinds


def test_constants_and_config_encoding_match_reference():
    for name in ("KIND_TRANSFER", "KIND_STAKE", "KIND_UNSTAKE", "TX_BUCKETS", "ROOT_WORDS"):
        assert getattr(ledger, name) == getattr(ref_ledger, name)
    assert EXEC_ORIGIN == -3
    cfg, ref = _pair(**SIGNED)
    assert cfg.as_ints() == ref.as_ints()
    assert ExecutionConfig.from_ints(ref.as_ints()) == cfg
    assert ExecutionConfig().as_ints() == RefConfig().as_ints()
    with pytest.raises(ValueError, match="11"):
        ExecutionConfig.from_ints((1, 2, 3))


@pytest.mark.parametrize("bad", [
    dict(accounts=0), dict(txs_per_block=0), dict(amount_cap=0),
    dict(stake_accounts=65), dict(stake_floor=-1),
    dict(initial_balance=2**31 - 100, txs_per_block=10, amount_cap=10),
])
def test_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        RefConfig(**bad)
    with pytest.raises(ValueError):
        ExecutionConfig(**bad)


# ---------------------------------------------------- digest, fold, apply


@pytest.mark.parametrize("height", [0, 1, 7, 2**31, M32])
def test_state_digest_and_root_fold_match_reference(height):
    rng = np.random.default_rng(height % 1000)
    bal = rng.integers(-(2**31), 2**31, 300, dtype=np.int64).astype(np.int32)
    stk = rng.integers(-5, 5, 300).astype(np.int32)
    bal[:4] = [0, -1, -(2**31), 2**31 - 1]
    mix = ledger.mix_tensor(4 * 300, "cpu")
    assert np.array_equal(mix.numpy(), _u32(ref_rootmix.mix_matrix(4 * 300)))
    digest = ledger._state_digest_torch(*_t(bal, stk), mix)
    want = ref_rootmix.state_digest_np(bal, stk)
    w = ref_ledger._state_words_jax(jnp.asarray(bal), jnp.asarray(stk))
    jdigest = (w[:, None] * jnp.asarray(ref_rootmix.mix_matrix(1200))).sum(axis=0, dtype=jnp.uint32)
    assert np.array_equal(digest.numpy(), _u32(want))
    assert np.array_equal(digest.numpy(), _u32(jdigest))
    prev = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    got = ledger._fold_root_torch(torch.from_numpy(_u32(prev)), height, digest)
    jgot = ref_ledger._fold_root_jax(jnp.asarray(prev), jnp.uint32(height), jnp.asarray(want))
    assert np.array_equal(got.numpy(), _u32(jgot))
    assert np.array_equal(got.numpy(), _u32(ref_rootmix.fold_root_np(prev, height, want)))


def test_mix_tensor_is_built_once_per_width_and_device():
    assert ledger.mix_tensor(40, "cpu") is ledger.mix_tensor(40, torch.device("cpu"))
    assert ledger.mix_tensor(40, "cpu").dtype == torch.int64
    assert ledger.mix_tensor(44, "cpu").shape == (44, rootmix.ROOT_WORDS)


def _block(seed, accounts=50, n=180):
    """A block with overdrawn senders, every kind, rejected signatures and
    (padded to 256) pad rows, on a state with negative balances."""
    rng = np.random.default_rng(seed)
    bal = rng.integers(-20, 400, accounts).astype(np.int32)
    stk = rng.integers(-3, 60, accounts).astype(np.int32)
    kind = rng.integers(0, 3, n)
    sender = rng.integers(0, accounts, n)
    recipient = rng.integers(0, accounts, n)
    amount = rng.integers(1, 120, n)
    sig_ok = rng.random(n) < 0.85
    return bal, stk, kind, sender, recipient, amount, sig_ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_block_matches_reference(seed):
    args = _block(seed)
    nb, ns, applied = ledger.apply_block(*args, device="cpu")
    rb, rs, rapplied = ref_ledger.apply_block(*args)
    assert np.array_equal(nb, rb) and np.array_equal(ns, rs)
    assert np.array_equal(applied, rapplied)
    # The block exercises what it claims: rejections of both kinds.
    assert 0 < applied.sum() < args[6].sum()
    assert nb.dtype == np.int32 and applied.dtype == bool


def test_pack_and_pad_block_match_reference():
    bal, stk, *block = _block(3, n=100)
    for bucket in (None, 128):
        assert np.array_equal(ledger.pack_block_cols(*block, bucket=bucket),
                              ref_ledger.pack_block_cols(*block, bucket=bucket))
        for got, want in zip(ledger.pad_block(*block, bucket=bucket),
                             ref_ledger.pad_block(*block, bucket=bucket)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(ledger.pack_block_cols(*block[:4]),
                          ref_ledger.pack_block_cols(*block[:4]))


@pytest.mark.parametrize("accounts,branch", [(1000, "incremental"), (200, "full")])
def test_merkle_cols_step_matches_reference(accounts, branch):
    bal, stk, *block = _block(accounts, accounts=accounts, n=200)
    cols = ref_ledger.pack_block_cols(*block)
    tree = ref_merkle.build_tree_np(bal, stk)
    root = np.arange(8, dtype=np.uint32) * np.uint32(0x9E3779B9)
    mix = ref_rootmix.mix_matrix(4 * accounts)
    assert (2 * cols.shape[1] >= len(tree[0])) == (branch == "full")
    want = ref_ledger._jitted_chain_merkle_cols()(
        jnp.asarray(bal), jnp.asarray(stk), jnp.asarray(root),
        tuple(jnp.asarray(lvl) for lvl in tree), jnp.uint32(5), jnp.asarray(cols),
        jnp.asarray(mix),
    )
    args = ledger.from_reference(bal, stk, root, tree, cols, device="cpu")
    kept = [a.clone() for a in args[:3]]
    got = ledger.apply_block_chain_merkle_cols_torch(
        *args[:4], 5, args[4], ledger.mix_tensor(4 * accounts, "cpu"))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert np.array_equal(got[3].numpy(), _u32(want[3]))
    assert np.array_equal(got[4].numpy(), _u32(want[4]))
    assert len(got[5]) == len(want[5])
    for g, w in zip(got[5], want[5]):
        assert np.array_equal(g.numpy(), _u32(w))
    # The step is out of place: its inputs stay a valid snapshot.
    assert all(torch.equal(a, k) for a, k in zip(args[:3], kept))
    # Without the tree: the chained root of the PR-16 form.
    chain = ref_ledger._jitted_chain_cols()(
        jnp.asarray(bal), jnp.asarray(stk), jnp.asarray(root), jnp.uint32(5),
        jnp.asarray(cols), jnp.asarray(mix))
    plain = ledger.apply_block_chain_cols_torch(
        args[0], args[1], args[2], 5, args[4], ledger.mix_tensor(4 * accounts, "cpu"))
    assert int(plain[2]) == int(chain[2])
    assert np.array_equal(plain[3].numpy(), _u32(chain[3]))


# ------------------------------------------------------------ block source


@pytest.mark.parametrize("height", [1, 2, 5])
def test_block_source_matches_reference_byte_for_byte(height):
    cfg, ref_cfg = _pair(**SIGNED)
    src, ref = BlockSource(cfg), RefBlockSource(ref_cfg)
    blk, rblk = src.block(height), ref.block(height)
    assert blk.digest == rblk.digest and src.value(height) == ref.value(height)
    for got, want in zip(blk._np, rblk._np):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (blk.kind, blk.sender, blk.recipient, blk.amount) == (
        rblk.kind, rblk.sender, rblk.recipient, rblk.amount)
    items = src.sig_items(blk)
    assert items == ref.sig_items(rblk)
    mask = HostVerifier().verify_signatures(items)
    assert [bool(v) for v in mask] == [(t + 1) % 4 != 0 for t in range(len(items))]


# ---------------------------------------------------------------- executors


@pytest.mark.parametrize("kind", ["host", "device"])
def test_executors_match_reference_over_six_heights(kind, monkeypatch):
    # The JAX device executor builds its first tree eagerly, one compile
    # an op and a level; jitted, the same function costs one compile.
    monkeypatch.setattr(ref_merkle, "build_tree_jax", jax.jit(ref_merkle.build_tree_jax))
    cfg, ref_cfg = _pair(**LEDGER)
    ex = _executor(kind, cfg)
    ref = RefHostExecutor(ref_cfg, (7, 0, 3))
    ex.advance_to(2)
    ex.advance_to(6)  # a resync gap
    ref.advance_to(6)
    _same_ledger(ex, ref)
    assert 0 < ex.rejected_total < ex.applied_total
    assert ex.advance_to(3) == ref.roots[3]
    assert ex.host_verify() == ref.root
    assert ex.election_stakes(4) == ref.election_stakes(4)
    if kind == "device":
        jref = RefDeviceExecutor(ref_cfg, (7, 0, 3))
        jref.advance_to(6)
        _same_ledger(ex, jref)
        tree, digest = ex._proof_materials()
        jtree, jdigest = jref._proof_materials()
        assert np.array_equal(digest, jdigest)
        assert all(np.array_equal(a, b) for a, b in zip(tree, jtree))


def _true_masks(src, heights):
    verifier = HostVerifier()
    return {h: [bool(v) for v in verifier.verify_signatures(src.sig_items(src.block(h)))]
            for h in heights}


@pytest.mark.parametrize("kind", ["host", "device"])
def test_speculation_with_wrong_guesses_matches_reference(kind):
    cfg, ref_cfg = _pair(**SIGNED)
    src, rsrc = BlockSource(cfg), RefBlockSource(ref_cfg)
    ex = _executor(kind, cfg, src)
    ref = RefHostExecutor(ref_cfg, (7, 0, 3), source=rsrc)
    masks = _true_masks(src, (1, 2, 3, 4))
    guess = [True] * cfg.txs_per_block  # forged lanes look well-formed
    for h in (1, 2, 3, 4):
        for e in (ex, ref):
            # Height 1 guesses right (the confirm path), the rest wrong.
            e.speculate(h, masks[1] if h == 1 else guess)
    with pytest.raises(RuntimeError):
        ex.prove(0)  # an open window refuses proofs
    for h in (1, 2, 3, 4):
        assert ex.resolve(h, masks[h]) == ref.resolve(h, masks[h])
    assert not ex._spec and ex.spec_rolled_back == ref.spec_rolled_back > 0
    assert ex.spec_rollback_depth == ref.spec_rollback_depth
    assert ex.spec_confirmed == ref.spec_confirmed
    _same_ledger(ex, ref)
    assert ex.discarded_roots == ref.discarded_roots
    assert ex.discarded_roots and not ex.discarded_roots & set(ex.roots.values())
    # The settled chain is the never-speculated one.
    plain = _executor(kind, cfg)
    plain.masks = masks
    plain.advance_to(4)
    _same_ledger(ex, plain)
    ex.host_verify()


@pytest.mark.parametrize("kind", ["host", "device"])
def test_double_rollback_against_one_capture(kind):
    cfg, ref_cfg = _pair(**SIGNED)
    src = BlockSource(cfg)
    ex = _executor(kind, cfg, src)
    ref = RefHostExecutor(ref_cfg, (7, 0, 3))
    masks = _true_masks(src, (1, 2, 3))
    ex.advance_to(1)
    ref.advance_to(3)
    # One capture restored twice: neither restore may see the step that
    # ran on the state restored before it.
    snap = ex._snapshot()
    for wrong in ([True] * cfg.txs_per_block, [False] * cfg.txs_per_block):
        ex._step(2, ok=wrong)
        ex.sync()
        ex._restore(snap)
        ex.height = 1
        ex.roots.pop(2)
    ex._step(2, ok=masks[2])
    ex.sync()
    assert ex.roots[2] == ref.roots[2]
    # Through the public API: two rollbacks in one window.
    wrong = [not m for m in masks[3]]
    ex.speculate(3, wrong)
    ex.speculate(4, [True] * cfg.txs_per_block)
    assert not ex.resolve(3, masks[3])
    assert not ex.resolve(4, _true_masks(src, (4,))[4])
    assert ex.spec_rolled_back == 2
    ref.advance_to(4)
    assert ex.roots[3] == ref.roots[3] and ex.roots[4] == ref.roots[4]
    assert list(map(int, ex.balances)) == list(map(int, ref.balances))
    ex.host_verify()


@pytest.mark.parametrize("kind", ["host", "device"])
def test_prove_and_proof_basis_match_reference(kind):
    cfg, ref_cfg = _pair(**LEDGER)
    ex = _executor(kind, cfg)
    ref = RefHostExecutor(ref_cfg, (7, 0, 3))
    ex.advance_to(4)
    ref.advance_to(4)
    basis, rbasis = ex.proof_basis(), ref.proof_basis()
    ex.advance_to(5)  # the basis is frozen against progress
    for account in (0, 3, 511, 999):
        want = dataclasses.asdict(rbasis.prove(account))
        assert dataclasses.asdict(basis.prove(account)) == want
        p = basis.prove(account)
        assert ex.verify_inclusion(ex.roots[4], account, p.balance, p.stake, p)
        assert not ex.verify_inclusion(ex.roots[5], account, p.balance, p.stake, p)
    ref.advance_to(5)
    assert dataclasses.asdict(ex.prove(7)) == dataclasses.asdict(ref.prove(7))
    with pytest.raises(ValueError):
        ex.prove(1000)


def test_device_executor_defaults_to_the_card():
    cfg = ExecutionConfig(accounts=8, txs_per_block=4)
    if torch.cuda.is_available():
        assert DeviceLedgerExecutor(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceLedgerExecutor(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation(n=4, target_height=1, burst=True, execution=cfg)
    ex = DeviceLedgerExecutor(cfg, device="cpu")
    assert ex.device.type == "cpu" and ex._dbal.device.type == "cpu"


def test_block_columns_are_cached_on_the_block_for_every_executor():
    cfg = ExecutionConfig(**dict(LEDGER, accounts=40))
    src = BlockSource(cfg)
    a, b = (DeviceLedgerExecutor(cfg, source=src, device="cpu") for _ in range(2))
    a.advance_to(2)
    cols = src.block(2)._cols
    b.advance_to(2)
    assert src.block(2)._cols is cols and cols.device == a.device
    assert a.roots == b.roots
    assert np.array_equal(cols.numpy(), ledger.pack_block_cols(*src.block(2)._np))


def test_exec_apply_launcher_rides_the_shared_drain():
    cfg = ExecutionConfig(**SIGNED)
    src = BlockSource(cfg)
    q = DeviceWorkQueue()
    verifier = HostVerifier()
    launcher = ExecApplyLauncher(verifier)
    assert launcher.kind == "exec.apply"
    items = src.sig_items(src.block(1))
    votes = q.submit(q.verify_launcher(verifier), items[:3])
    fut = q.submit(launcher, items, origin=EXEC_ORIGIN, rows=len(items))
    q.drain()
    assert q.launches == 2  # one a launcher, in one drain
    assert fut.result() == _true_masks(src, (1,))[1]
    assert votes.result() == [True] * 3


# --------------------------------------------------------------- the sim


SIM = dict(n=4, target_height=6, seed=3, sign=True, burst=True)
SIM_LEDGER = dict(accounts=16, txs_per_block=12, stake_every=3, seed=5)


def _sim(**kw):
    return Simulation(batch_verifier=HostVerifier(), device="cpu", **dict(SIM, **kw))


def _ref_sim(**kw):
    return RefSimulation(**dict(SIM, **kw)).run()


def test_sequential_sim_with_device_executors_matches_reference():
    sim = _sim(execution=ExecutionConfig(device=True, **SIM_LEDGER))
    res = sim.run()
    want = _ref_sim(execution=RefConfig(**SIM_LEDGER))
    assert res.completed and res.commits == want.commits
    res.assert_safety()
    assert len(sim._exec_unique) == 4 and not sim._exec_speculate
    assert all(isinstance(ex, DeviceLedgerExecutor) for ex in sim.executors)
    for i, commits in enumerate(res.commits):
        for h, v in commits.items():
            assert len(v) == 64 and v[32:] == sim.executors[i].roots[h]


class _CountingVerifier(HostVerifier):
    def __init__(self):
        super().__init__()
        self.calls = []

    def verify_signatures(self, items):
        self.calls.append(list(items))
        return super().verify_signatures(items)


def test_sequential_signed_sim_verifies_each_block_once_and_matches_reference():
    led = dict(SIM_LEDGER, sign_txs=True, bad_sig_every=5)
    verifier = _CountingVerifier()
    sim = Simulation(batch_verifier=verifier, device="cpu",
                     execution=ExecutionConfig(device=True, **led), **SIM)
    res = sim.run()
    want = _ref_sim(execution=RefConfig(**led))
    assert res.completed and res.commits == want.commits
    assert len(sim._exec_unique) == 4 and sim._exec_launcher is None
    src = sim._exec_source
    blocks = [src.sig_items(src.block(h)) for h in range(1, SIM["target_height"] + 1)]
    assert [c for c in verifier.calls if c in blocks] == blocks
    assert sorted(sim._exec_masks) == list(range(1, SIM["target_height"] + 1))
    assert not all(all(m) for m in sim._exec_masks.values())
    assert all(ex._verifier is None for ex in sim._exec_unique)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_kind"])
def test_pipelined_signed_sim_matches_reference(fused):
    led = dict(SIM_LEDGER, sign_txs=True, bad_sig_every=5)
    sim = _sim(execution=ExecutionConfig(device=True, **led), pipeline_heights=True,
               fused_exec_drain=fused)
    res = sim.run()
    ref = RefSimulation(execution=RefConfig(**led), pipeline_heights=True,
                        fused_exec_drain=fused, **SIM)
    want = ref.run()
    assert res.completed and res.commits == want.commits
    ex, rex = sim._exec_unique[0], ref._exec_unique[0]
    assert len(sim._exec_unique) == 1 and sim._exec_speculate
    assert ex.spec_rolled_back == rex.spec_rolled_back > 0
    assert ex.discarded_roots == rex.discarded_roots
    committed = {v[32:] for c in res.commits for v in c.values()}
    assert ex.discarded_roots and not ex.discarded_roots & committed
    assert sim._sched.launches == ref._sched.launches


def test_fused_drain_issues_fewer_launches_than_two_kind():
    led = dict(SIM_LEDGER, sign_txs=True, bad_sig_every=5)
    runs = {}
    for fused in (True, False):
        sim = _sim(execution=ExecutionConfig(**led), pipeline_heights=True,
                   fused_exec_drain=fused)
        runs[fused] = (sim.run(), sim._sched.launches)
    assert runs[True][0].commits == runs[False][0].commits
    assert runs[True][1] < runs[False][1]


@pytest.mark.parametrize("opts,error", [
    (dict(epochs=object()), NotImplementedError),
    (dict(load=object()), NotImplementedError),
    (dict(burst=False), NotImplementedError),
    (dict(payload_bytes=31), ValueError),
    (dict(exec_speculate=True), ValueError),
    (dict(fused_exec_drain=True, pipeline_heights=True), ValueError),
], ids=["epochs", "load", "lockstep", "payload", "speculate_sequential", "fused_unsigned"])
def test_refused_option_combinations(opts, error):
    kw = dict(SIM, device="cpu", batch_verifier=HostVerifier(),
              execution=ExecutionConfig(**SIM_LEDGER))
    kw.update(opts)
    with pytest.raises(error):
        Simulation(**kw)


def test_exec_options_without_execution_are_refused():
    for opt in ("exec_speculate", "fused_exec_drain", "dedup_exec"):
        with pytest.raises(ValueError, match="require"):
            Simulation(device="cpu", batch_verifier=HostVerifier(), **{opt: True}, **SIM)


class _BucketedVerifier(HostVerifier):
    """The host verifier with a verify-bucket ladder, so pipelined settles
    close their slot before a batch would spill into a larger bucket."""

    host = SimpleNamespace(buckets=(64, 256))


class _BucketedRefVerifier(RefHostVerifier):
    host = SimpleNamespace(buckets=(64, 256))


def test_queue_callback_runs_before_the_auto_drain_hook():
    q = DeviceWorkQueue(max_depth=1)
    seen = []
    q.on_drain = lambda resolved: seen.append("drain")
    q.submit(ExecApplyLauncher(HostVerifier()), [], callback=lambda f: seen.append("cb"))
    assert seen == ["cb", "drain"]


def test_auto_drain_at_an_exec_submit_resolves_the_height_first():
    # At pipeline_depth=3 the submit of a height's exec rows fills the
    # queue and drains it at once; the drain hook then confirms every
    # speculation window, so the height's own verdict must be in by then.
    # The reference attaches it after submit returns and raises there.
    led = dict(SIM_LEDGER, sign_txs=True, bad_sig_every=5)
    kw = dict(SIM, pipeline_heights=True, pipeline_depth=3)
    with pytest.raises(RuntimeError, match="awaits signature verification"):
        RefSimulation(execution=RefConfig(**led), batch_verifier=_BucketedRefVerifier(),
                      **kw).run()
    sim = Simulation(execution=ExecutionConfig(device=True, **led), device="cpu",
                     batch_verifier=_BucketedVerifier(), **kw)
    res = sim.run()
    want = _ref_sim(execution=RefConfig(**led), pipeline_heights=True)
    assert res.completed and res.commits == want.commits
    assert sim._exec_unique[0].spec_rolled_back > 0
