"""The PyTorch port's Pippenger MSM and RLC batch equation against the
JAX package's host functions and its host curve oracle
(``hyperdrive_tpu.crypto.ed25519``, pure Python: no jit).

- the geometry (``plan_groups``, ``msm_plan``, ``windows_for_bits``, the
  64/33 windows) equals the JAX package's;
- ``msm_kernel`` (PyTorch ops on the CPU) equals the JAX oracle's
  ``scalar_mult``/``point_add`` sum at 1, 7, 16 and 64 lanes, with
  padding lanes, zero digits, duplicate points and torsion points, all
  made by that oracle;
- ``rlc_scalars`` and the RLC binder / ``last_transcript`` bytes equal the
  JAX package's host code (its verifier's RLC path runs with the device
  check stubbed out: the JAX RLC and MSM programs are never called, their
  jit costs minutes on the CPU);
- ``TorchBatchVerifier(device="cpu", rlc=True)``: verdicts, the one
  ``rlc_check`` a clean chunk costs, the ladder fallback on a forgery
  (mask equal to the JAX oracle's), and the documented cofactored divergence
  on the order-8 torsion vector.

Points, scalars, bytes and verdicts: every comparison is exact.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.ops import msm as ref_msm
from hyperdrive_tpu.ops.ed25519_jax import TpuBatchVerifier as RefTpuBatchVerifier
from hyperdrive_tpu.ops.ed25519_jax import rlc_scalars as ref_rlc_scalars
from hyperdrive_tpu_torch.crypto import ed25519 as hed
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.ops import ed25519 as ted
from hyperdrive_tpu_torch.ops import msm

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 63, 64, 65, 256, 1000, 4096, 16384, 65536])
def test_geometry_matches_reference(n):
    assert msm.plan_groups(n) == ref_msm.plan_groups(n)
    for windows in (33, 64, 97):
        assert msm.msm_plan(n, windows) == ref_msm.msm_plan(n, windows)
    G, g = msm.plan_groups(n)
    assert G * g >= n and (G == 1 or G & (G - 1) == 0)


def test_window_counts_match_reference():
    for bits in (1, 4, 5, 128, 129, 253, 255, 256):
        assert msm.windows_for_bits(bits) == ref_msm.windows_for_bits(bits)
    assert (msm.ED25519_FULL_WINDOWS, msm.ED25519_HALF_WINDOWS) == (64, 33)
    assert (ref_msm.ED25519_FULL_WINDOWS, ref_msm.ED25519_HALF_WINDOWS) == (64, 33)


# ------------------------------------------------------------ MSM vs oracle


def _host_msm(points, scalars):
    """The JAX package's oracle sum, affine."""
    acc = ref_ed.IDENTITY
    for p, s in zip(points, scalars):
        acc = ref_ed.point_add(acc, ref_ed.scalar_mult(s, p))
    x, y, z, _ = acc
    zinv = pow(z, ref_ed.P - 2, ref_ed.P)
    return x * zinv % ref_ed.P, y * zinv % ref_ed.P


def _points(rng, n):
    """Host points from the JAX oracle: extended, Z != 1 in general."""
    return [ref_ed.scalar_mult(rng.randrange(1, ref_ed.L), ref_ed.BASE) for _ in range(n)]


def _digits(scalars, windows):
    """Signed digits of scalars < 2^(4 windows): one extra window absorbs
    the recode carry, as the RLC's 33rd window does for 128-bit z."""
    nib = torch.tensor(
        [[(s >> (4 * w)) & 0xF for w in range(64)] for s in scalars], dtype=torch.int32
    )
    return ted._recode_signed(nib)[: windows + 1]


def _order8_point():
    """An order-8 torsion point (the canonical small-order vector of the
    "Taming the many EdDSAs" suite)."""
    for seed in range(2, 50):
        p = ref_ed.point_decompress(bytes([seed]) + bytes(31))
        if p is None:
            continue
        q = ref_ed.scalar_mult(ref_ed.L, p)
        o, acc = 1, q
        while not ref_ed.point_equal(acc, ref_ed.IDENTITY) and o <= 8:
            acc = ref_ed.point_add(acc, q)
            o += 1
        if o == 8:
            return q
    raise AssertionError("no order-8 point found")


@pytest.mark.parametrize("n", [1, 7, 16, 64])
def test_msm_kernel_matches_oracle(n):
    rng = random.Random(n)
    windows = 16
    points = _points(rng, n)
    assert n == 1 or any(p[2] != 1 for p in points)
    scalars = [rng.randrange(0, 1 << (4 * windows)) for _ in range(n)]
    if n >= 7:
        scalars[3] = 0  # a zero scalar: every digit to the trash slot
        points[5] = points[1]  # a duplicate point
        points[6] = _order8_point()  # a torsion point: plain group arithmetic
    px, py, pt = (torch.from_numpy(a) for a in ted.pack_affine(points))
    got = ted.affine_of(ted.msm_kernel(px, py, pt, _digits(scalars, windows)))
    assert got == _host_msm(points, scalars)


def test_msm_padding_lanes_and_full_width_scalars():
    rng = random.Random(3)
    n = 9  # plan (8, 2): 7 padding lanes
    assert msm.plan_groups(n) == (8, 2)
    points = _points(rng, n)
    scalars = [rng.randrange(0, ref_ed.L) for _ in range(n)]
    px, py, pt = (torch.from_numpy(a) for a in ted.pack_affine(points))
    nib = torch.tensor(
        [[(s >> (4 * w)) & 0xF for w in range(64)] for s in scalars], dtype=torch.int32
    )
    got = ted.affine_of(ted.msm_kernel(px, py, pt, ted._recode_signed(nib)))
    assert got == _host_msm(points, scalars)


def test_window_sums_of_two_sets_equal_their_msms():
    rng = random.Random(4)
    n = 8
    sets, want = [], []
    ops = ted.CURVE_OPS
    for windows in (6, 3):
        points = _points(rng, n)
        scalars = [rng.randrange(0, 1 << (4 * windows)) for _ in range(n)]
        px, py, pt = (torch.from_numpy(a) for a in ted.pack_affine(points))
        sets.append((ted.niels_affine(px, py, pt), _digits(scalars, windows)))
        want.append(_host_msm(points, scalars))
    sums = msm.msm_window_sums(sets, ops)
    assert [s[0].shape[0] for s in sums] == [7, 4]
    for s, w in zip(sums, want):
        assert ted.affine_of(msm.horner(s, ops)) == w


# ------------------------------------------------------ RLC host functions


@pytest.fixture(scope="module")
def ring():
    return KeyRing.deterministic(4, namespace=b"msmtest")


def _items(ring, count, seed=0):
    out = []
    for i in range(count):
        kp = ring[i % 4]
        m = bytes([seed, i]) * 12
        out.append((kp.public, m, ref_ed.sign(kp.seed, m)))
    return out


def test_rlc_scalars_match_reference(ring):
    host = ted.Ed25519BatchHost(buckets=(16,))
    items = _items(ring, 6)
    items[2] = (items[2][0], items[2][1], items[2][2][:32] + b"\xff" * 32)  # s >= L
    arrays, prevalid, _ = host.pack(items)
    assert list(prevalid[:6]) == [True, True, False, True, True, True]
    binder = ted.rlc_binder(items)
    got = ted.rlc_scalars(arrays[5], arrays[6], prevalid, binder)
    want = ref_rlc_scalars(arrays[5], arrays[6], prevalid, binder)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not got[0][2].any() and not got[1][2].any()  # invalid lane: zeros
    assert not got[1][:, 32:].any()  # z is 128-bit


class _StubCheck:
    """Stands in for the JAX RLC program (never called here: its jit costs
    minutes on the CPU) and keeps what the JAX verifier handed it."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append([np.asarray(a) for a in args])
        return jnp.asarray(True)


@pytest.mark.parametrize("generation", [0, 7])
def test_binder_and_transcript_match_reference(ring, generation):
    items = _items(ring, 5, seed=generation)
    ref = RefTpuBatchVerifier(buckets=(16,), rlc=False)
    stub = ref._rlc_fn = _StubCheck()
    ref.generation = generation
    assert ref.verify_signatures(items).tolist() == [True] * 5
    bv = ted.TorchBatchVerifier(buckets=(16,), rlc=True, device="cpu")
    bv.generation = generation
    assert bv.verify_signatures(items).tolist() == [True] * 5
    assert bv.last_transcript == ref.last_transcript != b""
    binder = ted.rlc_binder(items, generation)
    assert (binder[:6] == b"hd-gen") == bool(generation)
    assert hashlib.sha256(binder).digest() == bv.last_transcript
    # The scalars the JAX verifier would have launched with are the ones
    # the port derives from the same binder.
    arrays, prevalid, _ = bv.host.pack(items)
    for g, w in zip(ted.rlc_scalars(arrays[5], arrays[6], prevalid, binder),
                    stub.calls[0][5:]):
        assert np.array_equal(g, w)
    assert bv.rlc_calls == 1 and bv.rlc_fallbacks == 0


# -------------------------------------------------------- RLC verification


def test_rlc_verdicts_and_fallback(ring):
    items = _items(ring, 6, seed=1)
    bv = ted.TorchBatchVerifier(buckets=(16,), rlc=True, device="cpu")
    assert bv.verify_signatures(items).tolist() == [True] * 6
    assert (bv.rlc_calls, bv.rlc_fallbacks) == (1, 0)
    bad = list(items)
    bad[3] = (bad[3][0], b"forged" * 4, bad[3][2])  # valid shape, wrong message
    bad[4] = (bad[4][0], bad[4][1], bad[4][2][:63])  # wrong length: packer rejects
    mask = bv.verify_signatures(bad)
    assert mask.tolist() == [True, True, True, False, False, True]
    assert mask.tolist() == [ref_ed.verify(p, m, s) for p, m, s in bad]
    assert (bv.rlc_calls, bv.rlc_fallbacks) == (2, 1)
    # A chunk of nothing but malformed lanes costs no check at all.
    assert bv.verify_signatures([bad[4]]).tolist() == [False]
    assert bv.rlc_calls == 2
    assert bv.verify_signatures([]).tolist() == []


def _small_order_item():
    """(pub, msg, sig) that is cofactored-valid but strict-invalid:
    A = R = an 8-torsion point, s = 0."""
    t8 = _order8_point()
    enc = ref_ed.point_compress(t8)
    sig = enc + bytes(32)
    for i in range(64):
        msg = b"small-order-%d" % i
        k = ref_ed.challenge_scalar(enc, enc, msg)
        rka = ref_ed.point_add(t8, ref_ed.scalar_mult(k, t8))
        if not ref_ed.point_equal(ref_ed.IDENTITY, rka):
            return enc, msg, sig
    raise AssertionError("no diverging message found")


def test_order8_vector_shows_the_cofactored_divergence(ring):
    pub, msg, sig = _small_order_item()
    assert not hed.verify(pub, msg, sig) and not ref_ed.verify(pub, msg, sig)
    batch = _items(ring, 3, seed=2) + [(pub, msg, sig)]
    ladder = ted.TorchBatchVerifier(buckets=(16,), rlc=False, device="cpu")
    assert ladder.verify_signatures(batch).tolist() == [True, True, True, False]
    rlc = ted.TorchBatchVerifier(buckets=(16,), rlc=True, device="cpu")
    # The cofactored batch equation absorbs the torsion: all four accept
    # in one check, no fallback.
    assert rlc.verify_signatures(batch).tolist() == [True, True, True, True]
    assert (rlc.rlc_calls, rlc.rlc_fallbacks) == (1, 0)


def test_rlc_auto_resolution(monkeypatch):
    monkeypatch.delenv("HD_RLC", raising=False)
    assert ted.TorchBatchVerifier(device="cpu").rlc is False
    monkeypatch.setenv("HD_RLC", "1")
    assert ted.TorchBatchVerifier(device="cpu").rlc is True
    monkeypatch.setenv("HD_RLC", "0")
    assert ted.TorchBatchVerifier(device="cpu").rlc is False
    assert ted.TorchBatchVerifier(device="cpu", rlc=True).rlc is True
    with pytest.raises(ValueError):
        ted.TorchBatchVerifier(device="cpu", rlc="yes")
