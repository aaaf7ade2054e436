"""The PyTorch port's GF(2^255 - 19) field against the JAX package's.

Same seeded numpy inputs through ``hyperdrive_tpu.ops.fe25519`` (jnp) and
``hyperdrive_tpu_torch.ops.fe25519`` (torch): every operation must give
the same int32 limbs, not just the same field element, because the CUDA
kernels' plain versions run on it. The kernels' one constant block (8 x
32-bit limbs) is held by value to the TPU kernels' constants and to the
host oracle's integers. Exact comparisons throughout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.ops import fe25519 as ref
from hyperdrive_tpu.ops.ed25519_jax import _b_niels_np as ref_b_niels
from hyperdrive_tpu.ops.ed25519_pallas import _consts as ref_pallas_consts
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops import fe25519 as fe

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

P = fe.P_INT
EDGE_INTS = [0, 1, P - 1, P, P + 1, 2 * P - 1, 2**255 - 1, 2**256 - 1]


def _operands(seed=0, rows=48):
    """[rows + edges, 20] int32 limbs satisfying the invariant (limbs in
    [0, SLACK_MAX], value < 2^256 guaranteed for the random rows by their
    top limb), with the edge values and all-SLACK_MAX rows appended."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, fe.SLACK_MAX + 1, (rows, fe.N_LIMBS)).astype(np.int32)
    a[:, -1] = rng.integers(0, 256, rows)
    edges = np.stack([fe.to_limbs(v) for v in EDGE_INTS])
    slack = np.full((2, fe.N_LIMBS), fe.SLACK_MAX, dtype=np.int32)
    return np.concatenate([a, edges, slack]).astype(np.int32)


def _value(limbs) -> int:
    return sum(int(v) << (13 * i) for i, v in enumerate(limbs))


OPS = {
    "add": (lambda m, a, b: m.add(a, b), lambda x, y: x + y),
    "sub": (lambda m, a, b: m.sub(a, b), lambda x, y: x - y),
    "neg": (lambda m, a, b: m.neg(a), lambda x, y: -x),
    "mul": (lambda m, a, b: m.mul(a, b), lambda x, y: x * y),
    "sqr": (lambda m, a, b: m.sqr(a), lambda x, y: x * x),
    "mul_small": (lambda m, a, b: m.mul_small(a, 121666), lambda x, y: 121666 * x),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_field_op_matches_reference_limb_for_limb(name):
    op, _ = OPS[name]
    a = _operands(seed=1)
    b = _operands(seed=2)[::-1].copy()
    want = np.asarray(op(ref, jnp.asarray(a), jnp.asarray(b)))
    got = op(fe, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(OPS))
def test_field_op_matches_python_ints(name):
    op, pyop = OPS[name]
    a = _operands(seed=3)
    b = _operands(seed=4)[::-1].copy()
    got = op(fe, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.min() >= 0 and got.max() <= fe.SLACK_MAX
    for ra, rb, rg in zip(a, b, got):
        assert _value(rg) % P == pyop(_value(ra), _value(rb)) % P
        assert _value(rg) < 2**256


def test_pow22523_matches_python_ints():
    """Limb for limb with the JAX chain through decompression
    (``test_torch_sha512.py``); here its value, which needs no JAX."""
    a = _operands(seed=6)
    got = fe.pow22523(torch.from_numpy(a)).numpy()
    assert got.min() >= 0 and got.max() <= fe.SLACK_MAX
    for ra, rg in zip(a, got):
        assert _value(rg) % P == pow(_value(ra), (P - 5) // 8, P)


def test_canonical_eq_select_match_reference():
    a = _operands(seed=5)
    b = np.concatenate([a[1:], a[:1]])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        fe.canonical(ta).numpy(), np.asarray(ref.canonical(jnp.asarray(a)))
    )
    for v in EDGE_INTS:
        assert fe.from_limbs(fe.canonical(torch.from_numpy(fe.to_limbs(v)))) == v % P
    np.testing.assert_array_equal(
        fe.eq(ta, tb).numpy(), np.asarray(ref.eq(jnp.asarray(a), jnp.asarray(b)))
    )
    np.testing.assert_array_equal(
        fe.is_zero(ta).numpy(), np.asarray(ref.is_zero(jnp.asarray(a)))
    )
    assert fe.is_zero(ta).sum() == 2  # the rows of 0 and p
    # p and 0 are one field element in two representations.
    p_vs_0 = fe.eq(torch.from_numpy(fe.P_LIMBS), torch.from_numpy(fe.ZERO))
    assert bool(p_vs_0)
    mask = torch.from_numpy(np.arange(len(a)) % 3 == 0)
    np.testing.assert_array_equal(
        fe.select(mask, ta, tb).numpy(),
        np.asarray(ref.select(jnp.asarray(mask.numpy()), jnp.asarray(a), jnp.asarray(b))),
    )


def test_packing_and_constants_match_reference():
    vals = [0, 1, P - 1, P, 2**255 - 1, 2**259 + 12345]
    np.testing.assert_array_equal(fe.to_limbs(vals), ref.to_limbs(vals))
    assert fe.from_limbs(fe.to_limbs(vals)) == vals
    assert fe.from_limbs(torch.from_numpy(fe.to_limbs(vals))) == vals
    np.testing.assert_array_equal(fe._SUB_BIAS, ref._SUB_BIAS)
    np.testing.assert_array_equal(fe.ONE, ref.ONE)
    np.testing.assert_array_equal(fe.ZERO, ref.ZERO)
    assert (fe.N_LIMBS, fe.LIMB_BITS, fe.SLACK_MAX) == (
        ref.N_LIMBS, ref.LIMB_BITS, ref.SLACK_MAX
    )
    assert (fe.FOLD_260, fe.FOLD_255, fe.TOP_SHIFT) == (
        ref.FOLD_260, ref.FOLD_255, ref.TOP_SHIFT
    )
    with pytest.raises(ValueError):
        fe.to_limbs(2**260)
    with pytest.raises(ValueError):
        fe.mul_small(torch.from_numpy(fe.ONE), 1 << 17)


def _value32(words) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(words))


def _w32_slots():
    w = ed25519_cuda.W32_LIMBS
    block = ed25519_cuda.consts_block_w32()
    assert block.dtype == np.uint32 and block.shape == (ed25519_cuda.CONSTS_W32_LEN,)
    return [_value32(block[i:i + w]) for i in range(0, block.size, w)]


def test_cuda_constant_block_matches_the_pallas_kernels_constants():
    """Every field constant the CUDA kernels read, slot by slot by value,
    against the TPU kernels' own const block (p, 2d, d and sqrt(-1), which
    the decompression reads, then the [0..8]B niels planes); and the port's
    B table against the reference's."""
    slots = _w32_slots()
    _, k2d, pdig, _, d, sqrtm1, byp, bym, bt2 = (np.asarray(c) for c in ref_pallas_consts())
    want = [_value(c[:, 0]) for c in (pdig, k2d, d, sqrtm1)]
    want += [_value(plane[:, e]) for plane in (byp, bym, bt2) for e in range(9)]
    assert slots[:len(want)] == want
    for got, want in zip(ed25519_cuda._b_niels_np(16), ref_b_niels(16)):
        np.testing.assert_array_equal(got, want)


def test_cuda_w32_constant_block_matches_by_value():
    """The 8 x 32-bit block slot by slot against the host oracle's
    integers: p, 2d, d, sqrt(-1), the 9 [0..8]B entries of each niels
    plane (y+x, y-x, 2d x y from the oracle's point arithmetic), then the
    challenge kernel's L, delta and its three fold constants, each of which
    cancels delta (2^w - 1) mod L."""
    slots = _w32_slots()
    d = ref_ed.D
    want = [P, 2 * d % P, d, ref_ed.SQRT_M1]
    planes = ([], [], [])
    pt = ref_ed.IDENTITY
    for _ in range(9):
        zi = pow(pt[2], P - 2, P)
        x, y = pt[0] * zi % P, pt[1] * zi % P
        for plane, v in zip(planes, (y + x, y - x, 2 * d * x * y)):
            plane.append(v % P)
        pt = ref_ed.point_add(pt, ref_ed.BASE)
    want += [v for plane in planes for v in plane]
    L = ref_ed.L
    delta = L - (1 << 252)
    want += [L, delta]
    assert slots[:len(want)] == want
    folds = slots[len(want):]
    assert len(folds) == len(ed25519_cuda.SC_FOLD_WIDTHS) == 3
    for c, w in zip(folds, ed25519_cuda.SC_FOLD_WIDTHS):
        assert 0 <= c < L and (c + delta * ((1 << w) - 1)) % L == 0
    assert slots[0] == P and all(0 <= s < P for s in slots[1:])
