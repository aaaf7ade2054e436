"""The warp-specialised challenge kernel and the challenge routes' one host
call, on the CPU.

- A Python model of ``csrc/ed25519_challenge.cu``'s split of a lane over
  two warps: the producer loads the rows, computes W16..W79 in a rolling
  window and writes K[t] + W[t] to shared memory, releasing the rounds in
  the chunks that the source's ``hd_chal_chunk`` defines, each through a
  named barrier of its own; the round warp waits on each chunk's barrier
  and runs its rounds on K + W with h + (K + W) summed first. The two
  warps run as generators under a scheduler that lets the round warp run
  as far as its barriers allow before the producer takes a step, and
  shared memory raises on a word read before it was written, so a release
  ahead of its writes fails. The model's k is held byte for byte to
  ``hashlib.sha512`` and to the host ``challenge_scalar`` (the port's and
  the JAX package's oracle) on seeded and edge preimages: all-zero rows,
  all-0xff rows, an index outside the table and a digest index >= U (both
  read zeros, as the kernel does).
- ``ed25519_cuda.chal_semiwire_verify`` on CPU tensors: the verdicts and k
  rows of ``challenge[_grouped]`` then ``semiwire_verify``, per-lane and
  grouped, on one 64-lane batch; its input checks; no launch counted.
- ``TorchWireVerifier(device="cpu")`` on the per-lane and grouped
  challenge routes: the host verifier's mask, the route's stats, one k
  scratch buffer a width.

No JAX program runs here: the JAX-parity tests of the challenge leg are in
``test_torch_sha512.py`` and ``test_torch_wire.py``. Exact comparisons
throughout.
"""

import hashlib
import re

import numpy as np
import pytest
import torch

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.crypto import ed25519 as port_ed
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops import ed25519_wire as wire
from hyperdrive_tpu_torch.ops import sha512

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

M64 = (1 << 64) - 1
SRC = (ed25519_cuda.CSRC / "ed25519_challenge.cu").read_text()
K = [k % (1 << 64) for k in sha512._K]
H0 = [h % (1 << 64) for h in sha512._H0]


def _c_expr(expr: str, c: int) -> int:
    """Evaluates the source's chained ternary in ``c`` (``a ? b : rest``)."""
    cond, _, rest = expr.partition("?")
    if not rest:
        return eval(expr, {"c": c})  # noqa: S307 - an arithmetic expression of the source
    then, _, other = rest.partition(":")
    return _c_expr(then, c) if eval(cond, {"c": c}) else _c_expr(other, c)  # noqa: S307


def _source_chunks():
    """The chunk bounds of the source: ``hd_chal_chunk(c)`` for c = 0..
    HD_CHAL_NCHUNK, each chunk released through barrier 1 + c."""
    nchunk = int(re.search(r"HD_CHAL_NCHUNK = (\d+);", SRC).group(1))
    body = re.search(r"hd_chal_chunk\(int c\) \{\s*return (.*?);", SRC, re.S).group(1)
    return [_c_expr(body, c) for c in range(nchunk + 1)]


def _rotr(x, n):
    return ((x >> n) | (x << (64 - n))) & M64


def _words(row: bytes):
    return [int.from_bytes(row[8 * i: 8 * i + 8], "big") for i in range(4)]


class SharedMemory:
    """K + W words by (round, lane); a read of a word not yet written raises."""

    def __init__(self):
        self.kw = {}

    def put(self, t, j, v):
        self.kw[(t, j)] = v

    def get(self, t, j):
        if (t, j) not in self.kw:
            raise AssertionError(f"round warp read K + W[{t}] of lane {j} before its write")
        return self.kw[(t, j)]


def _row(rows, i, n):
    return bytes(rows[i]) if 0 <= i < n else bytes(32)


def producer(smem, j, bounds, r_rows, idx, m_rows, m_idx, trows, n):
    """Warp 1, lane j: loads (zeros outside a table or past n), the
    schedule in a 16-word rolling window, K + W into shared memory, one
    release a chunk. Yields ("release", barrier id)."""
    live = j < n
    ia = int(idx[j]) if live else -1
    im = j if m_idx is None else int(m_idx[j]) if live else -1
    w = _words(_row(r_rows, j, n))
    w += _words(_row(trows, ia, len(trows)))
    w += _words(_row(m_rows, im, n if m_idx is None else len(m_rows)))
    w += [0x8000000000000000, 0, 0, 8 * 96]
    for t in range(bounds[0], bounds[1]):  # rounds 0-3: the R row only
        smem.put(t, j, (K[t] + w[t & 15]) & M64)
    yield ("release", 1)
    for t in range(bounds[1], bounds[2]):
        smem.put(t, j, (K[t] + w[t & 15]) & M64)
    yield ("release", 2)
    for c in range(2, len(bounds) - 1):
        for t in range(bounds[c], bounds[c + 1]):
            x15, x2 = w[(t - 15) & 15], w[(t - 2) & 15]
            s0 = _rotr(x15, 1) ^ _rotr(x15, 8) ^ (x15 >> 7)
            s1 = _rotr(x2, 19) ^ _rotr(x2, 61) ^ (x2 >> 6)
            w[t & 15] = (w[t & 15] + s0 + w[(t - 7) & 15] + s1) & M64
            smem.put(t, j, (K[t] + w[t & 15]) & M64)
        yield ("release", 1 + c)


def round_warp(smem, j, bounds, out):
    """Warp 0, lane j: one wait a chunk, then its rounds on K + W with
    h + (K + W) summed ahead of e; the feed-forward into out[j] (the
    64-byte digest). Yields ("wait", barrier id)."""
    a, b, c, d, e, f, g, h = H0
    for ch in range(len(bounds) - 1):
        yield ("wait", 1 + ch)
        for t in range(bounds[ch], bounds[ch + 1]):
            hk = (h + smem.get(t, j)) & M64
            t1 = (hk + (_rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41))
                  + (g ^ (e & (f ^ g)))) & M64
            t2 = ((_rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39))
                  + ((a & b) | (c & (a | b)))) & M64
            a, b, c, d, e, f, g, h = (t1 + t2) & M64, a, b, c, (d + t1) & M64, e, f, g
    state = [a, b, c, d, e, f, g, h]
    out[j] = b"".join(((s + h0) & M64).to_bytes(8, "big") for s, h0 in zip(state, H0))


def run_block(bounds, r_rows, idx, m_rows, m_idx, trows, n, lanes=32):
    """One block's 32 lanes: the round warp runs until it waits on a
    barrier the producer has not released, then the producer takes one
    step (its writes, then a release). Returns the digests and the order
    of releases and waits passed."""
    smem, out, log = SharedMemory(), {}, []
    for j in range(lanes):
        prod = producer(smem, j, bounds, r_rows, idx, m_rows, m_idx, trows, n)
        rounds = round_warp(smem, j, bounds, out)
        released = set()
        want = next(rounds)
        while True:
            while want[1] in released:
                log.append(("passed", j, want[1]))
                want = next(rounds, None)
                if want is None:
                    break
            if want is None:
                break
            step = next(prod)
            released.add(step[1])
            log.append(("released", j, step[1]))
        assert next(prod, None) is None
    return out, log


def _k_of(digest: bytes) -> bytes:
    return (int.from_bytes(digest, "little") % port_ed.L).to_bytes(32, "little")


def test_model_chunks_are_the_sources():
    bounds = _source_chunks()
    assert bounds == [0, 4, 16, 32, 48, 64, 80]
    assert re.search(r"HD_CHAL_WARPS = 2;", SRC) and re.search(r"HD_CHAL_LANES = 32;", SRC)
    # Rounds 0-15 unrolled: chunk 0 (the R row's four words) released and
    # awaited at hd_chal_chunk(1) and (0), chunk 1 at (2) and (1).
    assert "t + 1 == hd_chal_chunk(1) || t + 1 == hd_chal_chunk(2)" in SRC
    assert "hd_chal_release(t < 4 ? 1 : 2);" in SRC
    assert "t == hd_chal_chunk(0) || t == hd_chal_chunk(1)" in SRC
    assert "hd_chal_wait(t == 0 ? 1 : 2);" in SRC
    # Chunks 2 and on: one loop trip each, 16 rounds (and 16 schedule
    # steps, window slot u for t = u mod 16) from hd_chal_chunk(c), then a
    # release (producer) or after a wait (round warp) on barrier 1 + c.
    assert all(bounds[c + 1] - bounds[c] == 16 and bounds[c] % 16 == 0
               for c in range(2, len(bounds) - 1))
    assert len(re.findall(r"for \(int c = 2; c < HD_CHAL_NCHUNK; \+\+c\)", SRC)) == 2
    assert re.search(r"hd_chal_schedule\(w, 16 \+ u\);\s*kw\[t0 \+ u\]\[j\] = "
                     r"hd_sha512_k\[t0 \+ u\] \+ w\[u\];\s*\}\s*hd_chal_release\(1 \+ c\);", SRC)
    assert re.search(r"hd_chal_wait\(1 \+ c\);\s*#pragma unroll\s*for \(int u = 0; u < 16; "
                     r"\+\+u\) hd_chal_round\(s, kw\[t0 \+ u\]\[j\]\);", SRC)
    # The schedule reads only words it has already made or loaded.
    for t in range(16, 80):
        assert all(t - 16 <= s < t for s in (t - 15, t - 2, t - 7, t - 16))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_model_matches_hashlib_and_host(seed):
    rng = np.random.default_rng(seed)
    n, v, u = 32, 12, 5
    trows = rng.integers(0, 256, (v, 32), dtype=np.uint8)
    r_rows = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    m_rows = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    m_uniq = rng.integers(0, 256, (u, 32), dtype=np.uint8)
    idx = rng.integers(0, v, n).astype(np.int32)
    m_idx = rng.integers(0, u, n).astype(np.uint8)
    bounds = _source_chunks()
    for form, (mr, mi) in {"per_lane": (m_rows, None), "grouped": (m_uniq, m_idx)}.items():
        out, log = run_block(bounds, r_rows, idx, mr, mi, trows, n)
        for j in range(n):
            m = bytes(m_rows[j]) if mi is None else bytes(m_uniq[m_idx[j]])
            pre = bytes(r_rows[j]) + bytes(trows[idx[j]]) + m
            assert out[j] == hashlib.sha512(pre).digest(), (form, j)
            want = port_ed.challenge_scalar(bytes(r_rows[j]), bytes(trows[idx[j]]), m)
            assert want == ref_ed.challenge_scalar(bytes(r_rows[j]), bytes(trows[idx[j]]), m)
            assert _k_of(out[j]) == want.to_bytes(32, "little")
        # Every wait passed after its own release, lane by lane.
        for j in range(n):
            seq = [(kind, bid) for kind, jj, bid in log if jj == j]
            for bid in range(1, len(bounds)):
                assert seq.index(("released", bid)) < seq.index(("passed", bid))


EDGES = ["zeros", "ones", "outside_table", "digest_index_past_u", "past_n"]


@pytest.mark.parametrize("edge", EDGES)
def test_model_edge_preimages(edge):
    rng = np.random.default_rng(7)
    v, u = 6, 3
    trows = rng.integers(0, 256, (v, 32), dtype=np.uint8)
    r_rows = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    m_uniq = rng.integers(0, 256, (u, 32), dtype=np.uint8)
    idx = rng.integers(0, v, 32).astype(np.int32)
    m_idx = rng.integers(0, u, 32).astype(np.uint8)
    n = 32
    if edge == "zeros":
        r_rows[:], trows[:], m_uniq[:] = 0, 0, 0
    elif edge == "ones":
        r_rows[:], trows[:], m_uniq[:] = 0xFF, 0xFF, 0xFF
    elif edge == "outside_table":
        idx[::3] = v
        idx[1::7] = -1
    elif edge == "digest_index_past_u":
        m_idx[::2] = u
        m_idx[1::5] = 255
    else:
        n = 5  # lanes 5..31 of the block lie past n: zero rows, no store
    out, _ = run_block(_source_chunks(), r_rows, idx, m_uniq, m_idx, trows, n)
    # The plain version on tables with a zero row appended, the indices
    # outside them pointed at it (live lanes).
    tz = np.concatenate([trows, np.zeros((1, 32), np.uint8)])
    mz = np.concatenate([m_uniq, np.zeros((1, 32), np.uint8)])
    ip = np.where((idx >= 0) & (idx < v), idx, v).astype(np.int32)[:n]
    mp = np.where(m_idx < u, m_idx, u).astype(np.uint8)[:n]
    plain = wire.challenge_grouped(torch.from_numpy(ip), torch.from_numpy(r_rows[:n].copy()),
                                   torch.from_numpy(mp), torch.from_numpy(mz),
                                   torch.from_numpy(tz)).numpy()
    for j in range(32):
        live = j < n
        a = bytes(trows[idx[j]]) if live and 0 <= idx[j] < v else bytes(32)
        m = bytes(m_uniq[m_idx[j]]) if live and m_idx[j] < u else bytes(32)
        r = bytes(r_rows[j]) if live else bytes(32)
        assert out[j] == hashlib.sha512(r + a + m).digest(), j
        want = ref_ed.challenge_scalar(r, a, m)
        assert _k_of(out[j]) == want.to_bytes(32, "little")
        if live:
            assert bytes(plain[j]) == want.to_bytes(32, "little")


def test_model_catches_a_release_before_its_writes():
    """The checks above can fail: a producer that releases chunk 1 before
    writing it makes the round warp read an unwritten word."""
    bounds = _source_chunks()
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    idx = np.zeros(4, np.int32)

    def early(smem, j, *args):
        gen = producer(smem, j, *args)
        yield ("release", 2)  # chunk 1 released ahead of its words
        yield from (s for s in gen if s[1] != 2)

    with pytest.raises(AssertionError, match="before its write"):
        smem, out = SharedMemory(), {}
        prod = early(smem, 0, bounds, rows, idx, rows, None, rows, 4)
        rounds = round_warp(smem, 0, bounds, out)
        released, want = set(), next(rounds)
        while want is not None:
            while want is not None and want[1] in released:
                want = next(rounds, None)
            if want is not None:
                released.add(next(prod)[1])


@pytest.fixture(scope="module")
def batch():
    """One 64-lane challenge batch of signed items (every fourth signature
    broken), its table, rows on the CPU, per-lane digests equal to the
    grouped form's table rows at m_idx, and the two separate calls'
    verdicts and k rows."""
    ring = RefKeyRing.deterministic(8, namespace=b"torch-chal-w")
    digests = [bytes([d]) * 32 for d in (3, 5, 7)]
    items = []
    for i in range(64):
        kp, d = ring[i % 8], digests[i % 3]
        sig = kp.sign_digest(d)
        if i % 4 == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        items.append((kp.public, d, sig))
    table = wire.ValidatorTable([kp.public for kp in ring.pairs], device="cpu")
    host = wire.Ed25519WireHost(buckets=(64,))
    (idx, r, s, m), prevalid, _ = host.pack_wire_challenge(items, table)
    m_idx, m_uniq, u = host.group_digests(items, 64)
    assert u == 3 and prevalid.all()
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in
         dict(idx=idx, r=r, s=s, m=m, m_idx=m_idx, m_uniq=m_uniq).items()}
    k = ed25519_cuda.challenge(t["idx"], t["r"], t["m"], table.rows)
    np.testing.assert_array_equal(
        k.numpy(),
        ed25519_cuda.challenge_grouped(t["idx"], t["r"], t["m_idx"], t["m_uniq"],
                                       table.rows).numpy())
    ok = ed25519_cuda.semiwire_verify(t["idx"], t["r"], t["s"], k, *table.arrays())
    want = [ref_ed.verify(*it) for it in items]
    assert ok.tolist() == want and any(want) and not all(want)
    return items, table, t, k, ok


@pytest.mark.parametrize("form", ["per_lane", "grouped"])
def test_chal_semiwire_verify_equals_the_two_calls(batch, form):
    _, table, t, k, ok = batch
    ed25519_cuda.reset_stats()
    k_rows = torch.full((64, 32), 0xAB, dtype=torch.uint8)
    if form == "per_lane":
        got = ed25519_cuda.chal_semiwire_verify(t["idx"], t["r"], t["s"], t["m"], table.rows,
                                                *table.arrays(), k_rows)
    else:
        got = ed25519_cuda.chal_semiwire_verify(t["idx"], t["r"], t["s"], t["m_uniq"],
                                                table.rows, *table.arrays(), k_rows,
                                                m_idx=t["m_idx"])
    assert got.dtype == torch.bool and torch.equal(got, ok)
    assert torch.equal(k_rows, k)
    assert all(st.launches == 0 for st in ed25519_cuda.stats.values())


def test_chal_semiwire_verify_checks_its_inputs():
    ed25519_cuda.reset_stats()
    i4 = torch.zeros(4, dtype=torch.int32)
    z = torch.zeros((4, 32), dtype=torch.uint8)
    tv = torch.zeros(3, dtype=torch.bool)
    tl = torch.zeros((3, 20), dtype=torch.int32)
    trows = torch.zeros((3, 32), dtype=torch.uint8)
    m_idx = torch.zeros(4, dtype=torch.uint8)
    k = torch.zeros((4, 32), dtype=torch.uint8)

    def call(**kw):
        a = dict(idx=i4, r_rows=z, s_rows=z, m_rows=z, trows=trows, tnax=tl, tay=tl,
                 tnat=tl, tvalid=tv, k_rows=k)
        a.update(kw)
        return ed25519_cuda.chal_semiwire_verify(**a)

    for kw, err in [
        (dict(idx=i4.long()), TypeError),              # idx dtype
        (dict(m_rows=z[:2]), ValueError),              # per-lane digest rows
        (dict(trows=trows[:, :16]), ValueError),       # table row width
        (dict(trows=torch.zeros((2, 32), dtype=torch.uint8)), ValueError),  # V differs
        (dict(s_rows=z[:3]), ValueError),              # s rows
        (dict(k_rows=torch.zeros((4, 16), dtype=torch.uint8)), ValueError),  # k scratch
        (dict(tnax=tl.long()), TypeError),             # table dtype
        (dict(tvalid=tv.to(torch.uint8)), TypeError),  # valid mask dtype
        (dict(m_idx=m_idx.int(), m_rows=z[:1]), TypeError),  # digest index dtype
        (dict(m_idx=m_idx[:3], m_rows=z[:1]), ValueError),   # digest index shape
        (dict(s_rows=z.to("meta")), ValueError),       # devices differ
        (dict(trows=trows.to("meta")), ValueError),
        (dict(tnat=tl.to("meta")), ValueError),
    ]:
        with pytest.raises(err):
            call(**kw)
    ok = call(m_idx=m_idx, m_rows=z[:1])
    assert ok.shape == (4,) and not ok.any()
    assert all(st.launches == 0 for st in ed25519_cuda.stats.values())


@pytest.mark.parametrize("route", ["chal", "grouped"])
def test_wire_verifier_challenge_routes_through_one_call(batch, route):
    items, table, t, k, _ = batch
    ed25519_cuda.reset_stats()
    wv = wire.TorchWireVerifier(buckets=(64,), table=table, device="cpu")
    if route == "chal":
        wv.host.M_GROUP_CAP = 2  # three digests: the per-lane rows
    calls = []
    inner = wv._chal_semi

    def counted(*args, **kw):
        calls.append(kw.get("m_idx") is not None)
        return inner(*args, **kw)

    wv._chal_semi = counted
    got = wv.verify_signatures(items)
    want = np.asarray(RefHostVerifier().verify_signatures(items), dtype=bool)
    np.testing.assert_array_equal(got, want)
    assert calls == [route == "grouped"]
    n = len(items)
    key = "lanes_chal" if route == "chal" else "lanes_grouped"
    assert wv.stats[key] == n and wv.stats["lanes_wire"] == 0
    assert wv.stats["format_bytes"] == (100 * n if route == "chal" else 69 * n + 32 * 3)
    # One k scratch for the 64-lane bucket, holding this batch's k.
    assert list(wv._k_scratch) == [(64, 0)]
    assert torch.equal(wv._k_scratch[(64, 0)], k)
    assert all(st.launches == 0 for st in ed25519_cuda.stats.values())
