"""Models of the ``g1_aggregate`` kernel's arithmetic and schedule
(``hyperdrive_tpu_torch/csrc/g1_aggregate.cu``), held against Python ints,
the port's plain ``aggregate_kernel`` and the host oracle.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``aggregate_kernel``); here:

- the constant block (``g1_cuda.consts_block``): p, n0', 2^384 mod p, its
  negative fold, and the two conversion constants, against Python ints
  and the JAX package's field; the entry and exit conversions on edge
  values, including signed limbs at the plain version's bound;
- a word-for-word model of the kernel's 12 x 32-bit Montgomery product
  (interleaved rows on an even and an odd accumulator, the closing merge
  and subtraction), every step's bound asserted, against x * y * 2^-384
  mod p;
- a model of the cluster schedule (which block holds each lane, which
  levels read partners across blocks and are cluster-synced), run with
  the complete projective addition over the oracle's field: its X, Y, Z
  equal ``aggregate_kernel``'s after ``fp381.canonical`` and its affine
  sum the oracle's ``aggregate_signatures``.
"""

import random

import numpy as np
import pytest
import torch

from hyperdrive_tpu.ops import fp381 as ref_fp
from hyperdrive_tpu_torch.crypto import bls
from hyperdrive_tpu_torch.ops import fp381 as fp
from hyperdrive_tpu_torch.ops import g1, g1_cuda

torch.set_num_threads(1)

P = fp.P_INT
M32 = (1 << 32) - 1
W = g1_cuda.W32_WORDS
LAZY = 1 << 384  # every kernel value is below this
ONE = LAZY % P
BLOCKS = g1_cuda.CLUSTER


def _words(x: int, n: int = W) -> list:
    return [(x >> (32 * k)) & M32 for k in range(n)]


def _value(ws) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(ws))


def _block():
    b = g1_cuda.consts_block().view(np.uint32).tolist()
    return {"p": b[0:12], "n0": b[12], "one": b[13:25], "neg": b[25:37],
            "to": b[37:49], "from": b[49:61]}


# ------------------------------------------------- the product, word for word


def _mac_pairs(t, x, pairs, carry=0):
    """g1_mac_pairs: t[0..12] += x * (pairs as 64-bit slots), one carry
    chain that starts with ``carry`` and whose carry out of t[11] lands in
    t[12]; asserts no carry is lost."""
    for k, a in enumerate(pairs):
        prod = x * a
        for pos, half in ((2 * k, prod & M32), (2 * k + 1, prod >> 32)):
            s = t[pos] + half + carry
            t[pos], carry = s & M32, s >> 32
    t[12] += carry
    assert t[12] <= M32


def mont_model(a: int, b: int) -> int:
    """g1_mul step by step: interleaved CIOS on two accumulators, every
    chain's carries and bounds asserted. The running value is E + O 2^32 +
    c: a row adds the even words of a times b_i and of p times m_i into E,
    the odd ones into O, then divides by 2^32 by renaming (E <- O, c <- E[1],
    O <- E[2..12])."""
    assert 0 <= a < LAZY and 0 <= b < LAZY
    k = _block()
    pw, n0 = k["p"], k["n0"]
    aw, bw = _words(a), _words(b)
    e, o, c = [0] * 13, [0] * 13, 0
    done = 0  # a * b_0..i-1 + m_0..i-1 p, the value the rows have added
    for i in range(W):
        # c joins word 0 of E; the carry of that addition is word 1's, so the
        # odd chain (O's word 0 weighs 2^32) starts with it.
        s = e[0] + c
        e[0] = s & M32
        _mac_pairs(o, bw[i], aw[1::2], s >> 32)
        _mac_pairs(e, bw[i], aw[0::2])
        m = (e[0] * n0) & M32
        _mac_pairs(e, m, pw[0::2])
        _mac_pairs(o, m, pw[1::2])
        assert e[0] == 0
        done += (a * bw[i] + m * P) << (32 * i)
        e, c, o = o, e[1], e[2:] + [0, 0]
        value = _value(e) + (_value(o) << 32) + c
        assert value << (32 * (i + 1)) == done and value < a + P
        assert e[12] <= 7
    # r = E + c + O 2^32 in one chain; the top word is 0 or 1.
    carry, r = c, []
    for k in range(13):
        s = e[k] + (o[k - 1] if k else 0) + carry
        r.append(s & M32)
        carry = s >> 32
    assert carry == 0 and r[12] in (0, 1)
    full = _value(r)
    assert full < LAZY + P
    out = (full - (P if r[12] else 0)) % LAZY
    assert out < LAZY and out % P == a * b * pow(LAZY, -1, P) % P
    if b < P:
        assert out < 2 * P
    return out


def _fold_top(r: int, t: int, c: int):
    v = r + t * c
    return v % LAZY, v >> 384


def entry_model(limbs) -> int:
    """g1_from_limbs: a signed window packs 12 words and a signed top,
    the top folds back (three folds), then the product by 2^378 mod p."""
    acc, shift, ws = 0, 0, []
    for limb in limbs:
        acc += int(limb) << shift
        shift += 13
        if shift >= 32:
            ws.append(acc & M32)
            acc >>= 32
            shift -= 32
    assert len(ws) == W and -(1 << 31) <= acc < (1 << 31)
    c = _block()
    r, t = _fold_top(_value(ws), abs(acc), _value(c["neg"] if acc < 0 else c["one"]))
    for _ in range(2):
        r, t = _fold_top(r, t, ONE)
    assert t == 0
    return mont_model(r, _value(c["to"]))


def exit_model(v: int) -> int:
    """The exit product by 2^390 mod p, then one conditional subtraction."""
    y = mont_model(v, _value(_block()["from"]))
    assert y < 2 * P
    return y - P if y >= P else y


def test_constant_block_words_come_from_python_ints():
    block = g1_cuda.consts_block()
    assert block.shape == (61,) and block.dtype == np.int32
    c = _block()
    assert _value(c["p"]) == P == ref_fp.P_INT
    assert (P * c["n0"] + 1) % (1 << 32) == 0
    assert _value(c["one"]) == ONE and ONE == (1 << 384) - 9 * P
    assert _value(c["neg"]) == P - ONE
    assert _value(c["to"]) == pow(2, 378, P) and _value(c["from"]) == pow(2, 390, P)
    # The round trip through the kernel's domain on edge values.
    r390 = pow(2, 390, P)
    for x in (0, 1, 2, P - 1, P - 2, (P + 1) // 2, 1 << 380):
        xm = x * r390 % P
        inside = mont_model(xm, _value(c["to"]))
        assert inside < 2 * P and inside % P == x * ONE % P
        assert exit_model(inside) == xm


def test_entry_takes_signed_limbs_up_to_the_plain_bound():
    bound = (1 << 389) + (1 << 388)  # just under 2^389.5, the fp381 bound
    rng = random.Random(7)
    vals = [0, 1, -1, P, -P, bound, -bound, (1 << 384) - 1, -(1 << 384)]
    vals += [rng.randrange(-bound, bound) for _ in range(20)]
    for v in vals:
        limbs, x = [], v
        for _ in range(29):
            limbs.append(x & 0x1FFF)
            x >>= 13
        limbs.append(x)  # the signed top limb
        # A redundant form: each limb lends -1, 0 or 1 units to the next.
        for k in range(29):
            d = rng.randrange(-1, 2)
            limbs[k] += d << 13
            limbs[k + 1] -= d
        assert sum(limb << (13 * k) for k, limb in enumerate(limbs)) == v
        inside = entry_model(limbs)
        assert inside % P == v * pow(2, -6, P) % P
        assert fp.from_limbs(np.array(fp.to_limbs(exit_model(inside)))) == v % P


def test_montgomery_product_model_matches_python_ints():
    edges = [0, 1, 2, P - 1, P, P + 1, 2 * P - 1, LAZY - P, LAZY - 1, M32, 1 << 383]
    rng = random.Random(0x384)
    seeded = [rng.randrange(LAZY) for _ in range(12)] + [rng.randrange(P) for _ in range(6)]
    inv = pow(LAZY, -1, P)
    for a in edges + seeded[:6]:
        for b in edges + seeded[6:]:
            assert mont_model(a, b) % P == a * b * inv % P


# ------------------------------------------------------- the cluster schedule


def cluster_schedule(n: int) -> list:
    """The kernel's levels for a committee of n lanes: per level, the
    sync before it ('cluster' or 'block'; none before level 1, which reads
    the inputs) and each block's (lane, partner, tail) additions. Lane i
    lives in block i % 8."""
    if n == 1:
        return [{"sync": None, "inputs": True, "work": {0: [(0, None, None)]}}]
    h = n // 2
    levels = [{"sync": None, "inputs": True, "work": {}}]
    for i in range(h):
        tail = n - 1 if n % 2 and i == h - 1 else None
        levels[0]["work"].setdefault(i % BLOCKS, []).append((i, i + h, tail))
    w = h
    while w > 1:
        h = w // 2
        level = {"sync": "cluster" if (h % BLOCKS or w % 2) else "block",
                 "inputs": False, "work": {}}
        for i in range(h):
            tail = w - 1 if w % 2 and i == h - 1 else None
            level["work"].setdefault(i % BLOCKS, []).append((i, i + h, tail))
        levels.append(level)
        w = h
    return levels


def rcb_add(p1, p2):
    """Complete projective addition, a = 0 (g1.padd), over the oracle's
    field."""
    q = bls.P
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    t0, t1, t2 = x1 * x2 % q, y1 * y2 % q, z1 * z2 % q
    t3 = ((x1 + y1) * (x2 + y2) - t0 - t1) % q
    t4 = ((y1 + z1) * (y2 + z2) - t1 - t2) % q
    x3 = (x1 + z1) * (x2 + z2) % q
    y3 = 12 * (x3 - t0 - t2) % q
    t0, t2 = 3 * t0 % q, 12 * t2 % q
    z3, t1 = (t1 + t2) % q, (t1 - t2) % q
    return ((t3 * t1 - t4 * y3) % q, (t1 * z3 + y3 * t0) % q, (z3 * t4 + t0 * t3) % q)


def run_schedule(points, mask):
    """The committee's sum by the schedule, each block reading only what
    its sync allows; returns X, Y, Z (standard domain)."""
    lanes = [(p[0], p[1], 1) if m and p is not None else (0, 1, 0)
             for p, m in zip(points, mask)]
    store = {}  # lane -> (point, writer block, level)
    levels = cluster_schedule(len(points))
    for lv, level in enumerate(levels):
        written = {}
        for rank, items in level["work"].items():
            for i, j, tail in items:
                assert i % BLOCKS == rank  # a block writes the lanes it holds
                if level["inputs"]:
                    acc = lanes[i] if j is None else rcb_add(lanes[i], lanes[j])
                    if tail is not None:
                        acc = rcb_add(acc, lanes[tail])
                else:
                    for k in (i, j) + ((tail,) if tail is not None else ()):
                        _, writer, at = store[k]
                        assert at < lv and k not in written
                        if level["sync"] == "block":  # no cluster barrier
                            assert writer == rank
                    acc = rcb_add(store[i][0], store[j][0])
                    if tail is not None:
                        acc = rcb_add(acc, store[tail][0])
                written[i] = (acc, rank, lv)
        store.update(written)
    point, writer, _ = store[0]
    assert writer == 0  # block 0 writes the result
    return point


def _committees(pts, n):
    """All masked, one lane, identity rows, P and -P, and a random mask."""
    rng = np.random.default_rng(n)
    rows = [pts[:n], pts[:n],
            [None if i % 2 == 0 else p for i, p in enumerate(pts[:n])],
            [bls.g1_neg(pts[i // 2]) if i % 2 else pts[i // 2] for i in range(n)],
            pts[:n]]
    masks = np.ones((5, n), np.int32)
    masks[0] = 0
    masks[1] = 0
    masks[1, n // 2] = 1
    masks[4] = rng.random(n) < 2 / 3
    return rows, masks


@pytest.fixture(scope="module")
def g1_points():
    pts, p = [], bls.G1_GEN
    for i in range(256):
        p = bls.g1_double(p) if i % 3 else bls.g1_add(p, bls.G1_GEN)
        pts.append(p)
    return pts


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 255, 256])
def test_cluster_schedule_equals_the_plain_tree(g1_points, n):
    rows, masks = _committees(g1_points, n)
    coords = [np.stack([g1.pack_points(r)[c] for r in rows]) for c in range(3)]
    plain = g1.aggregate_kernel(*(torch.from_numpy(c) for c in coords),
                                torch.from_numpy(masks))
    plain = [fp.from_limbs(fp.canonical(c[:, 0])) for c in plain]
    for b, (row, mask) in enumerate(zip(rows, masks)):
        got = run_schedule(row, mask)
        assert list(got) == [plain[0][b], plain[1][b], plain[2][b]]
        x, y, z = got
        zi = pow(z, -1, bls.P) if z else 0
        affine = None if z == 0 else (x * zi % bls.P, y * zi % bls.P)
        assert affine == bls.aggregate_signatures([p for p, m in zip(row, mask) if m])


def test_cluster_schedule_levels_and_capacity():
    # Power-of-two widths: every level local to its block until the last
    # three; odd widths cross blocks.
    syncs = [lv["sync"] for lv in cluster_schedule(256)]
    assert syncs == [None, "block", "block", "block", "block", "cluster", "cluster",
                     "cluster"]
    assert [lv["sync"] for lv in cluster_schedule(255)][1] == "cluster"
    assert len(cluster_schedule(4096)) == 12
    # The level-1 sums of the widest shared-memory committee fill a block's
    # 227 KB; one more lane spills to the global scratch.
    per_sum = 3 * W * 4
    slots = -(-(g1_cuda.MAX_SHARED_WIDTH // 2) // BLOCKS)
    assert slots * per_sum <= 232_448 < (slots + 1) * per_sum
    assert -(-((g1_cuda.MAX_SHARED_WIDTH + 1) // 2) // BLOCKS) == slots + 1
