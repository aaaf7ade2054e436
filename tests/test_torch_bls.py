"""The PyTorch port's BLS12-381 modules against the JAX package's.

- ``ops/limbs`` and ``ops/fp381``: packing, Montgomery products, carries,
  add/sub/neg/mul_small, canonical, eq, is_zero and select, limb for limb
  against the JAX functions on the same seeded signed-redundant arrays;
- ``ops/g1``: ``padd`` and ``pdbl`` limb for limb (P+P, P+(-P), P+O, O+O
  included), the plain ``aggregate_kernel`` limb for limb at widths 1, 5
  and 8, ``recode_scalars``/``pack_points``/``unpack_points`` array for
  array; ``g1_msm_kernel`` against the JAX package's oracle; the
  ``g1_aggregate`` wrapper's checks and constants, ``aggregate_points``
  and ``G1SumLauncher`` (two payloads, one launch);
- ``crypto/bls``: keys, signatures, compressed bytes, hash-to-curve points
  and aggregate verdicts equal the JAX package's oracle, the pinned
  vectors and the standard G1 generator encoding included.

The JAX side is jitted once a shape ([8, 30] rows): its field ops in one
program, ``padd``, ``pdbl``. Its ``aggregate_kernel`` runs as written,
with its module's ``padd`` swapped for that one program (rows padded to 8
with the identity, which a row-wise formula leaves alone), so no width
compiles a tree of its own. The kernel itself runs only on the card
(``chip_smoke.py`` holds it against ``aggregate_kernel``).
"""

import random

import jax
import numpy as np
import pytest
import torch

from hyperdrive_tpu.crypto import bls as ref_bls
from hyperdrive_tpu.ops import fp381 as ref_fp
from hyperdrive_tpu.ops import g1 as ref_g1
from hyperdrive_tpu.ops import limbs as ref_limbs
from hyperdrive_tpu_torch.crypto import bls
from hyperdrive_tpu_torch.devsched.queue import DeviceWorkQueue
from hyperdrive_tpu_torch.ops import fp381 as fp
from hyperdrive_tpu_torch.ops import g1
from hyperdrive_tpu_torch.ops import g1_cuda
from hyperdrive_tpu_torch.ops import limbs

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

ROWS = 8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _redundant(vals, rng):
    """Montgomery limbs of ``vals`` (ints in [0, 2p)) in a signed
    redundant form: each limb borrows -1, 0 or 1 units of 2^13 from the
    next one, so limbs go negative and past 2^13 at the same value."""
    x = np.array(fp.to_mont([v % fp.P_INT for v in vals]), dtype=np.int64)
    plus_p = np.array([v >= fp.P_INT for v in vals])
    x[plus_p] += np.array(fp.to_limbs(fp.P_INT), dtype=np.int64)
    d = rng.integers(-1, 2, size=(x.shape[0], x.shape[1] - 1))
    x[:, :-1] += d << 13
    x[:, 1:] -= d
    return x.astype(np.int32)


@pytest.fixture(scope="module")
def field_inputs():
    rng = np.random.default_rng(0xB15)
    pr = random.Random(0xB15)
    xs = [pr.randrange(2 * fp.P_INT) for _ in range(ROWS)]
    ys = [pr.randrange(fp.P_INT) for _ in range(ROWS)]
    # Row 0: zero; rows 1 and 2: b holds a's value plus p (equal fields).
    xs[0], xs[3] = 0, fp.P_INT
    ys[1], ys[2] = (xs[1] + fp.P_INT) % (2 * fp.P_INT), xs[2] % fp.P_INT + fp.P_INT
    a = _redundant(xs, rng)
    b = _redundant(ys, rng)
    mask = rng.integers(0, 2, ROWS).astype(bool)
    return xs, ys, a, b, mask


def _jax_field(a, b, mask):
    return dict(
        mul=ref_fp.mul(a, b), sqr=ref_fp.sqr(a), mont=ref_fp.MONT.mul(b, a),
        add=ref_fp.add(a, b), sub=ref_fp.sub(a, b), neg=ref_fp.neg(a),
        small12=ref_fp.mul_small(a, 12), small2=ref_fp.mul_small(b, 2),
        canonical=ref_fp.canonical(a), eq=ref_fp.eq(a, b), is_zero=ref_fp.is_zero(a),
        select=ref_fp.select(mask, a, b), scan=ref_limbs.carry_scan(a),
        carry_pass=ref_limbs.carry_pass(b), keep_top=ref_limbs.carry_pass_keep_top(a),
    )


def _port_field(a, b, mask):
    return dict(
        mul=fp.mul(a, b), sqr=fp.sqr(a), mont=fp.MONT.mul(b, a),
        add=fp.add(a, b), sub=fp.sub(a, b), neg=fp.neg(a),
        small12=fp.mul_small(a, 12), small2=fp.mul_small(b, 2),
        canonical=fp.canonical(a), eq=fp.eq(a, b), is_zero=fp.is_zero(a),
        select=fp.select(mask, a, b), scan=limbs.carry_scan(a),
        carry_pass=limbs.carry_pass(b), keep_top=limbs.carry_pass_keep_top(a),
    )


@pytest.fixture(scope="module")
def field_results(field_inputs):
    _, _, a, b, mask = field_inputs
    want = jax.jit(_jax_field)(a, b, mask)
    got = _port_field(_t(a), _t(b), torch.from_numpy(mask))
    return want, got


@pytest.fixture(scope="module")
def jax_padd():
    return jax.jit(ref_g1.padd)


@pytest.fixture(scope="module")
def points():
    """Eight distinct points by a doubling/adding chain (the JAX package's
    bench derivation), from the JAX package's oracle."""
    pts, p = [], ref_bls.G1_GEN
    for i in range(ROWS):
        p = ref_bls.g1_double(p) if i % 3 else ref_bls.g1_add(p, ref_bls.G1_GEN)
        pts.append(p)
    return pts


def _same(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape and (want == got).all()


# ---------------------------------------------------------------- field


@pytest.mark.parametrize("op", ["mul", "sqr", "mont", "add", "sub", "neg", "small12",
                                "small2", "canonical", "eq", "is_zero", "select",
                                "keep_top"])
def test_field_ops_limb_for_limb(field_results, op):
    want, got = field_results
    _same(want[op], got[op])


@pytest.mark.parametrize("op", ["scan", "carry_pass"])
def test_carries_limb_for_limb(field_results, op):
    want, got = field_results
    for w, g in zip(want[op], got[op]):
        _same(w, g)


def test_field_ops_against_python_ints(field_inputs, field_results):
    xs, ys, _, _, _ = field_inputs
    _, got = field_results
    p = fp.P_INT
    assert fp.from_mont(got["mul"]) == [x * y % p for x, y in zip(xs, ys)]
    assert fp.from_limbs(got["canonical"]) == [x % p for x in xs]
    assert fp.from_limbs(fp.canonical(got["sub"])) == [(x - y) % p for x, y in zip(xs, ys)]
    assert fp.from_mont(got["small12"]) == [12 * x % p for x in xs]
    assert got["eq"].tolist() == [x % p == y % p for x, y in zip(xs, ys)]
    assert got["is_zero"].tolist() == [x % p == 0 for x in xs]


def test_packing_matches_reference():
    vals = [0, 1, 2, fp.P_INT - 1, fp.P_INT - 2, (fp.P_INT - 1) // 2, (1 << 390) - 1]
    assert (fp.to_limbs(vals) == ref_fp.to_limbs(vals)).all()
    assert (limbs.to_limbs_flat(vals, 30) == ref_limbs.to_limbs_flat(vals, 30)).all()
    assert (fp.to_mont(vals[:-1]) == ref_fp.to_mont(vals[:-1])).all()
    assert (fp.ONE == ref_fp.ONE).all() and fp.MONT.n0p == ref_fp.MONT.n0p
    for v in vals[:-1]:
        assert fp.from_mont(fp.to_mont(v)) == v == ref_fp.from_mont(ref_fp.to_mont(v))
        assert fp.from_limbs(_t(fp.to_limbs(v))) == v
    with pytest.raises(ValueError):
        fp.to_limbs(1 << 390)
    with pytest.raises(ValueError):
        fp.mul_small(_t(fp.ONE), 1 << 17)


# ---------------------------------------------------------------- curve


def _edge_pairs(points):
    """(P, Q) rows: generic sums, P + P, P + (-P), P + O, O + O."""
    neg = [ref_bls.g1_neg(q) for q in points]
    lhs = points[:3] + points[3:5] + [points[5], points[6], None]
    rhs = points[1:4] + [points[3], neg[4]] + [None, None, None]
    return lhs, rhs


def test_padd_limb_for_limb_with_edges(points, jax_padd):
    lhs, rhs = _edge_pairs(points)
    p, q = ref_g1.pack_points(lhs), ref_g1.pack_points(rhs)
    want = jax_padd(p, q)
    got = g1.padd(tuple(map(_t, p)), tuple(map(_t, q)))
    for w, c in zip(want, got):
        _same(w, c)
    sums = g1.unpack_points(*got)
    assert sums[:3] == [ref_bls.g1_add(a, b) for a, b in zip(lhs[:3], rhs[:3])]
    assert sums[3] == ref_bls.g1_double(points[3])
    assert sums[4] is None and sums[5:7] == points[5:7] and sums[7] is None


def test_pdbl_limb_for_limb(points):
    pts = points[:7] + [None]
    p = ref_g1.pack_points(pts)
    want = jax.jit(ref_g1.pdbl)(p)
    got = g1.pdbl(tuple(map(_t, p)))
    for w, c in zip(want, got):
        _same(w, c)
    assert g1.unpack_points(*got) == [ref_bls.g1_double(q) for q in pts[:7]] + [None]


def _padd_8_rows(jax_padd):
    """The JAX ``padd`` on up to 8 rows through one compiled shape."""

    def padd(p, q):
        k = p[0].shape[0]
        ident = ref_g1.pack_points([None] * (ROWS - k))
        pad = [np.concatenate([np.asarray(c), e]) for c, e in zip(p, ident)]
        qad = [np.concatenate([np.asarray(c), e]) for c, e in zip(q, ident)]
        return tuple(c[:k] for c in jax_padd(tuple(pad), tuple(qad)))

    return padd


@pytest.mark.parametrize("n,mask", [(1, [1]), (1, [0]), (5, [1, 0, 1, 1, 1]),
                                    (8, [1, 1, 0, 1, 1, 0, 1, 1])])
def test_aggregate_kernel_limb_for_limb(points, jax_padd, monkeypatch, n, mask):
    monkeypatch.setattr(ref_g1, "padd", _padd_8_rows(jax_padd))
    px, py, pz = ref_g1.pack_points(points[:n])
    m = np.array(mask, dtype=np.int32)
    want = ref_g1.aggregate_kernel(px, py, pz, m)
    got = g1.aggregate_kernel(_t(px), _t(py), _t(pz), _t(m))
    for w, c in zip(want, got):
        _same(w, c)
    acc = None
    for q, on in zip(points, mask):
        if on:
            acc = ref_bls.g1_add(acc, q)
    assert g1.unpack_points(*got)[0] == acc


def test_aggregate_edge_lanes_and_batch(points):
    neg = ref_bls.g1_neg(points[2])
    rows = [[points[2], neg, points[4], points[4], None],  # P, -P, P twice, O
            [None] * 5,  # identity rows
            points[:5]]
    masks = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], np.int32)
    coords = [np.stack([g1.pack_points(r)[c] for r in rows]) for c in range(3)]
    args = g1.from_reference(coords + [masks], "cpu")
    got = g1.g1_aggregate(*args)
    assert [c.shape for c in got] == [(3, 1, 30)] * 3
    sums = g1.unpack_points(got[0][:, 0], got[1][:, 0], got[2][:, 0])
    assert sums == [ref_bls.g1_double(points[4]), None, None]
    # Row by row, the batch equals the unbatched plain version.
    for b in range(3):
        one = g1.aggregate_kernel(*(a[b] for a in args))
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))
    assert g1.aggregate_points([], device="cpu") is None
    assert g1.aggregate_points(points[:3], width=8, device="cpu") == (
        ref_bls.aggregate_signatures(points[:3]))
    with pytest.raises(ValueError):
        g1.aggregate_points(points[:3], width=2, device="cpu")


def test_g1_aggregate_checks_its_inputs():
    coords = tuple(_t(c)[None] for c in g1.pack_points([None] * 4))
    mask = torch.ones((1, 4), dtype=torch.int32)
    g1.g1_aggregate(*coords, mask)
    bad = [
        (coords[0][:, :0], coords[1][:, :0], coords[2][:, :0], mask[:, :0]),  # N = 0
        (coords[0][0], coords[1][0], coords[2][0], mask[0]),  # no batch axis
        (coords[0], coords[1], coords[2], mask.bool()),  # mask dtype
        (coords[0].long(), coords[1], coords[2], mask),  # limb dtype
        (coords[0], coords[1][:, :3], coords[2], mask),  # shapes differ
        (coords[0].transpose(0, 1), coords[1], coords[2], mask),  # layout
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            g1.g1_aggregate(*args)


def test_kernel_constants_come_from_the_reference_field():
    block = g1_cuda.consts_block()
    assert block.shape == (61,) and block.dtype == np.int32
    assert (block[:30] == ref_fp.to_limbs(ref_fp.P_INT)).all()
    assert (block[30:60] == ref_fp.ONE).all() and block[60] == ref_fp.MONT.n0p
    assert g1_cuda.stats["g1_aggregate"].launches == 0  # CPU tensors launch nothing


def test_recode_pack_unpack_match_reference(points):
    pr = random.Random(3)
    ks = [pr.randrange(ref_bls.R_ORDER) for _ in range(5)] + [0, 1]
    assert (g1.recode_scalars(ks) == ref_g1.recode_scalars(ks)).all()
    with pytest.raises(ValueError):
        g1.recode_scalars([1 << 255])
    pts = points + [None]
    for mine, ref in zip(g1.pack_points(pts), ref_g1.pack_points(pts)):
        assert (mine == ref).all()
    packed = ref_g1.pack_points(pts)
    assert g1.unpack_points(*map(_t, packed)) == ref_g1.unpack_points(*packed) == pts
    assert g1.unpack_points(*(_t(c[0]) for c in packed)) == pts[0]


def test_g1_msm_two_windows_matches_oracle(points):
    # Scalars below 2^7 recode into windows 0 and 1 only; a zero scalar
    # and an identity point are free lanes.
    pts = [points[0], None, points[2], points[5]]
    ks = [0, 77, 127, 9]
    digits = g1.recode_scalars(ks)
    assert not digits[2:].any()
    px, py, pz = g1.pack_points(pts)
    got = g1.g1_msm_kernel(_t(px), _t(py), _t(pz), _t(digits[:2]))
    acc = None
    for q, k in zip(pts, ks):
        acc = ref_bls.g1_add(acc, ref_bls.g1_mul(q, k))
    assert g1.unpack_points(*got)[0] == acc


@pytest.mark.slow
def test_g1_msm_full_windows_matches_oracle(points):
    pr = random.Random(11)
    ks = [pr.randrange(ref_bls.R_ORDER) for _ in range(ROWS)]
    ks[0] = 0
    px, py, pz = g1.pack_points(points)
    got = g1.g1_msm_kernel(_t(px), _t(py), _t(pz), _t(g1.recode_scalars(ks)))
    acc = None
    for q, k in zip(points, ks):
        acc = ref_bls.g1_add(acc, ref_bls.g1_mul(q, k))
    assert g1.unpack_points(*got)[0] == acc


def test_g1sum_launcher_batches_one_launch(points):
    queue = DeviceWorkQueue()
    launcher = g1.G1SumLauncher(width=8, device="cpu")
    futs = [queue.submit(launcher, points[i : i + 4], rows=4) for i in (0, 4)]
    queue.drain()
    assert [f.result() for f in futs] == [
        ref_bls.aggregate_signatures(points[i : i + 4]) for i in (0, 4)]
    assert launcher.launched == 1 and launcher.rows == 2
    with pytest.raises(ValueError):
        launcher.launch([points + [None]])  # 9 points on 8 lanes


def test_entry_points_default_to_the_card(points):
    from hyperdrive_tpu_torch.harness import Simulation

    if torch.cuda.is_available():
        pytest.skip("a card is present; the defaults would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g1.aggregate_points(points[:2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g1.G1SumLauncher(width=4).launch([points[:2]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulation(n=4, target_height=1, burst=True, bls_certificates="device")


# --------------------------------------------------------------- oracle


def test_oracle_keys_signatures_and_points_match_reference():
    for i in range(2):
        ident = b"bls-port-%d" % i
        mine, ref = bls.bls_keypair_from_identity(ident), ref_bls.bls_keypair_from_identity(ident)
        assert (mine.sk, mine.pk, mine.pk_bytes) == (ref.sk, ref.pk, ref.pk_bytes)
        msg = b"hd-bls-commit-%d" % i
        assert bls.hash_to_curve_g1(msg) == ref_bls.hash_to_curve_g1(msg)
        sig = mine.sign(msg)
        assert sig == ref.sign(msg)
        assert bls.g1_compress(sig) == ref_bls.g1_compress(sig)
        assert bls.g1_decompress(bls.g1_compress(sig)) == sig
        assert bls.g2_decompress(mine.pk_bytes) == mine.pk
    assert bls.keygen(b"\x01" * 32) == ref_bls.keygen(b"\x01" * 32)
    assert bls.DST == ref_bls.DST


def test_pinned_vectors_and_generator_encoding():
    assert bls.g1_compress(bls.G1_GEN).hex() == (
        "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
        "6c55e83ff97a1aeffb3af00adb22c6bb"
    )
    assert bls.g1_compress(None)[0] == 0xC0
    kp = bls.bls_keypair_from_identity(b"hd-bls-test-vector")
    assert kp.pk_bytes.hex() == (
        "b725489b6c05dfba5b0c10621913bb19637f12524da91b1a25f47af5beea8b8e"
        "7a8a15c47e88011a74b87475f0ff5a700355255a31f99eddd2b7fca74c490eaf"
        "eebde28317f903f45ddc8accca0d363a5cc6cc6dde41b1bcefabc48a55fa6f8d"
    )
    assert bls.g1_compress(kp.sign(b"hd-bls-test-message")).hex() == (
        "931b8317b8c284f1450455c4d9ac1f173d09884622265fc89370510b22a8d5c9"
        "4210a8423d57d2465727a8d98c250a65"
    )


@pytest.mark.parametrize("msg", [b"hd-bls-commit", b"forged"])
def test_aggregate_verify_matches_reference(msg):
    kps = [ref_bls.bls_keypair_from_identity(b"bls-%d" % i) for i in range(3)]
    agg = ref_bls.aggregate_signatures([kp.sign(b"hd-bls-commit") for kp in kps])
    assert bls.aggregate_signatures([kp.sign(b"hd-bls-commit") for kp in kps]) == agg
    pks = [kp.pk for kp in kps]
    got = bls.verify_aggregate_same_message(pks, msg, agg)
    assert got == ref_bls.verify_aggregate_same_message(pks, msg, agg)
    assert got == (msg == b"hd-bls-commit")
