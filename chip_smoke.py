"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines:

1. card: the card's name and power limit as nvidia-smi prints them, then
   the nvcc build of the kernel library (the three verify kernels and the
   challenge kernel) from the sources in this checkout, with each kernel's
   registers, stack and spills as ptxas reports them;
2. kernels against their plain PyTorch versions on the card, mask for mask
   on every lane, on mixed lanes made from a fixed seed:
   - ``ed25519_verify`` (packed limbs) at the verifier's bucket sizes (64,
     256, 1024, 4096) and one 65,536-lane batch (16 launches of 4096);
   - ``ed25519_wire`` (raw wire rows) at 64 to 4096 lanes, with the
     decompression edge encodings as A and as R in raw rows that no
     prevalid mask covers;
   - ``ed25519_semiwire`` (table-indexed A) at 64 to 65,536 lanes, with
     the edge encodings as R and lanes on a table slot that holds a bogus
     pubkey;
   each with a 256-lane sample against the host oracle, kernel and plain
   times (CUDA events), threads per signature, the operation bound (the
   multiply instructions of the 8 x 32-bit field for the same work) and
   its share; then the 256-lane time of each wire kernel over
   ``ed25519_verify``'s in the same run;
3. ``ed25519_challenge`` (SHA-512 and the reduction mod L in one kernel):
   k rows of a 256-lane sample equal the host's challenge scalars on both
   forms (per-lane and grouped digests); kernel against its plain version
   (the PyTorch-ops leg) byte for byte at 256 and 4,096 lanes on both
   forms, with edge digests (all-zero and all-0xff M) and R = 0xff...;
   kernel and plain times, the integer-instruction bound and its share;
4. main path: the signed 256-validator burst network
   (``Simulation(n=256, sign=True, burst=True, dedup_verify=True,
   small_window_host=False)``) to height 5, three times, every settle
   verified on the card: through the packed verifier (``ed25519_verify``),
   through ``TorchWireVerifier`` with a ``ValidatorTable`` of the 256
   validator keys (grouped challenge route, ``ed25519_challenge`` then
   ``ed25519_semiwire``), and through ``TorchWireVerifier`` with no table
   (full wire route, ``ed25519_wire``). Each run is checked for safety,
   against one run with the host verifier (digest, steps, heights), and
   for having launched its own kernels, each at least once per
   vote-bearing settle, and no other.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260
SIZES = (64, 256, 1024, 4096)
BIG = 65_536
POOL = 512
HEIGHT = 5
N_VALIDATORS = 256
PATH_LANES = 256  # a vote window at n=256: one lane per validator
#: INT32 multiply-adds per SM per clock on compute capability 9.0 (the
#: CUDA C++ Programming Guide's arithmetic-instruction throughput table).
IMAD_PER_SM_CLOCK = 64
#: Device memory rate of an H100 SXM (NVIDIA's data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
BOGUS = b"\xff" * 32  # y >= p: never decompresses
#: Threads that work on one signature (lane), per kernel.
THREADS_PER_SIG = {"ed25519_verify": 4, "ed25519_wire": 4, "ed25519_semiwire": 4,
                   "ed25519_challenge": 1}
KERNELS = {
    "ed25519_verify": ("hyperdrive_tpu_torch/csrc/ed25519_verify.cu",
                       "hyperdrive_tpu/ops/ed25519_pallas.py:373"),
    "ed25519_wire": ("hyperdrive_tpu_torch/csrc/ed25519_wire.cu",
                     "hyperdrive_tpu/ops/ed25519_pallas.py:486"),
    "ed25519_semiwire": ("hyperdrive_tpu_torch/csrc/ed25519_wire.cu",
                         "hyperdrive_tpu/ops/ed25519_pallas.py:522"),
    "ed25519_challenge": ("hyperdrive_tpu_torch/csrc/ed25519_challenge.cu",
                          "hyperdrive_tpu/ops/sha512_jax.py:146 (with :345, under "
                          "hyperdrive_tpu/ops/ed25519_wire.py:328)"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out)


# Multiply instructions of the field operations of csrc/fe25519_w32.cuh (8
# x 32-bit limbs on carry chains): a product is 64 low and 64 high halves
# plus the fold's 16 + 2, a squaring 28 cross products (56 halves), 8
# squares (16) and the fold; an addition folds its carry twice as 38 * c;
# a subtraction folds its borrow with a mask; a canonical reduction
# multiplies bit 255 by 19; a table row of 20 x 13-bit limbs converts with
# one addition and one x38. The bound counts the work of one signature once
# (the reference's formulas, 2Z as an addition), in these costs, for the
# three verify kernels: the copies that the four-thread layout runs on
# idle threads are not counted, so it stays a lower bound.
MUL, SQR, ADD, SUB, CANON, LIMBS13 = 146, 90, 2, 0, 1, 3


def _dbl(need_t: bool) -> int:
    """_dbl: 4 squarings, 3 products (4 with T), X + Y, 2 Z^2 and G as
    additions, -A, E (two), F and H as subtractions."""
    return 4 * SQR + (4 if need_t else 3) * MUL + 3 * ADD + 5 * SUB


def _padd() -> int:
    """_padd with T: 8 products; Y + X, 2 Z z, G, H; Y - X, E, F."""
    return 8 * MUL + 4 * ADD + 3 * SUB


def _madd(need_t: bool) -> int:
    """_madd: 6 products (7 with T); Y + X, 2 Z, G, H; Y - X, E, F."""
    return (7 if need_t else 6) * MUL + 4 * ADD + 3 * SUB


def imad_ladder() -> int:
    """One signature's ladder: A' in niels form (1 product, 1 addition, 1
    subtraction), the [0..8]A' table (9 entries of 1 product, 2 additions
    and 1 subtraction; 8 affine additions with T), 64 windows of 4
    doublings, one projective and one affine addition and 2 entry
    negations, and the check (2 products, 2 subtractions, 2 canonical
    reductions)."""
    table = MUL + ADD + SUB + 9 * (MUL + 2 * ADD + SUB) + 8 * _madd(True)
    window = 3 * _dbl(False) + _dbl(True) + _padd() + _madd(False) + 2 * SUB
    check = 2 * MUL + 2 * SUB + 2 * CANON
    return table + 64 * window + check


def imad_decompress() -> int:
    """One decompression (csrc/decompress.cuh): 255 squarings and 18
    products (251 and 11 of them in the pow22523 chain), 2 additions, 3
    subtractions and 4 canonical reductions (3 zero tests, the parity)."""
    return 255 * SQR + 18 * MUL + 2 * ADD + 3 * SUB + 4 * CANON


def imad_per_signature(kernel: str) -> int:
    if kernel == "ed25519_verify":  # five limb rows converted
        return imad_ladder() + 5 * LIMBS13
    if kernel == "ed25519_wire":  # two decompressions, -A and t = x' * y
        return imad_ladder() + 2 * imad_decompress() + SUB + MUL
    return imad_ladder() + imad_decompress() + 3 * LIMBS13


#: Bytes each lane reads and writes once: packed limbs 5 x 80 + 2 x 256
#: in; wire rows 4 x 32 in; semiwire idx 4 + R, s, k rows 96 + its table
#: row 3 x 80 + 1 valid byte in; 1 verdict byte out.
BYTES_PER_LANE = {"ed25519_verify": 913, "ed25519_wire": 129,
                  "ed25519_semiwire": 342}


# Integer instructions of the challenge kernel (csrc/ed25519_challenge.cu),
# one for each 32-bit operation of the code: a 64-bit addition is 2 (a
# carry chain over the halves), a 64-bit rotation or shift 2 (funnel
# shifts), a three-input logic function of 64-bit words 2 (one LOP3 a
# half), a byte swap 1 (PRMT); in the reduction a 32 x 32 -> 64-bit
# multiply-add with its carry 2, a carry step or a subtraction step 2, a
# select 1. Counted at the same cc 9.0 rate as the multiply-adds (32-bit
# add, logic, shift and multiply-add all run at 64 per SM per clock).
ADD64, ROT64, LOGIC64, BSWAP, MACW, STEP = 2, 2, 2, 1, 2, 2
#: (limbs of ~b, limbs of the result) of each fold: hd_sc_reduce.
SC_FOLDS = ((9, 13), (5, 9), (1, 8))


def ops_challenge() -> int:
    """One lane: the 64 scheduled words (sigma0, sigma1: three rotations
    or shifts and one three-input xor each; three additions), the 80
    rounds (Sigma0, Sigma1, Ch, Maj; seven additions), the feed-forward,
    24 byte-swapped words in and 16 limbs out, the three folds (the a + c
    chain, ~b, the rows of 4 multiply-adds and their carry runs) and the
    two conditional subtractions of L."""
    sigma = 3 * ROT64 + LOGIC64
    schedule = 64 * (2 * sigma + 3 * ADD64)
    rounds = 80 * (2 * sigma + 2 * LOGIC64 + 7 * ADD64)
    digest = 8 * ADD64 + (24 + 16) * BSWAP
    folds = sum(nr * STEP + nb * (STEP + 4 * MACW)
                + STEP * sum(nr - 4 - i for i in range(nb)) for nb, nr in SC_FOLDS)
    return schedule + rounds + digest + folds + 2 * 8 * (STEP + 1)


def challenge_bytes(lanes: int, uniq: int) -> int:
    """Bytes the challenge kernel must move: per lane the index 4, the R
    row and the A row 64 and the k row out 32; then the digest index 1 a
    lane and the digest table once (grouped, ``uniq`` rows), or a digest
    row a lane (per-lane, ``uniq`` 0)."""
    return lanes * 100 + (lanes + 32 * uniq if uniq else lanes * 32)


def bound_ms(kernel: str, lanes: int, clock_mhz: float, sms: int, uniq: int = 16):
    """(bound ms, bound_by): the larger of the operation time at the cc 9.0
    INT32 rate and the byte time at the memory rate. ``uniq``: the
    challenge kernel's digest-table rows (0: per-lane digests)."""
    if kernel == "ed25519_challenge":
        n_ops, n_bytes = lanes * ops_challenge(), challenge_bytes(lanes, uniq)
    else:
        n_ops, n_bytes = lanes * imad_per_signature(kernel), lanes * BYTES_PER_LANE[kernel]
    ops = n_ops / (sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6)
    byt = n_bytes / HBM_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= byt else (byt * 1e3, "bytes")


def time_ms(fn, reps: int, warm: bool = True, keep=None) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    one warm-up call unless ``warm`` is False; ``keep`` (a list) receives
    each call's result."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if keep is not None:
            keep.append(got)
    return statistics.median(times)


def _ring():
    from hyperdrive_tpu_torch.crypto.keys import KeyRing

    return KeyRing.deterministic(32, namespace=b"chip-smoke")


def mixed_pool(size: int, rng):
    """Signed (pub, digest, sig) items of every verdict class: valid,
    flipped s bit, wrong digest, malformed point, s >= L."""
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed

    ring = _ring()
    items = []
    for i in range(size):
        kp = ring[i % 32]
        digest = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        sig = host_ed.sign(kp.seed, digest)
        kind = i % 5
        if kind == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif kind == 2:
            digest = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        elif kind == 3:
            sig = b"\xff" * 64
        elif kind == 4 and i % 10 == 4:
            s = int.from_bytes(sig[32:], "little") + host_ed.L
            sig = sig[:32] + s.to_bytes(32, "little")
        items.append((kp.public, digest, sig))
    return items


def edge_encodings() -> list:
    """The decompression edge encodings: identity, the sign bit on x = 0,
    y = 0 (both signs), y = p - 1, y = p, y = p + 1, y = 2^255 - 1, and a
    non-residue."""
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed

    p = host_ed.P

    def enc(y, sign=0):
        return int.to_bytes(y | (sign << 255), 32, "little")

    nonres = next(enc(y) for y in range(2, 50)
                  if host_ed.point_decompress(enc(y)) is None)
    return [enc(1), enc(1, 1), enc(0), enc(0, 1), enc(p - 1), enc(p),
            enc(p + 1), enc((1 << 255) - 1), nonres]


def ptxas_report(log: str) -> list:
    """Per entry kernel: (name, registers, stack bytes, spill stores, spill
    loads) from the -Xptxas -v log, where each entry's figures follow its
    "Compiling entry function" line."""
    out = []
    for m in re.finditer(
        r"Compiling entry function '[^']*?(hd_ed25519_\w+?_kernel)[^']*'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers", log, re.S,
    ):
        name, stack, st, ld, regs = m.groups()
        out.append((name, int(regs), int(stack), int(st), int(ld)))
    return out


def phase_card():
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    lib = ed25519_cuda.build(force=True)
    build_s = time.perf_counter() - t0
    log = (lib.parent / "nvcc.log").read_text()
    report = ptxas_report(log)
    if len(report) != len(KERNELS):
        raise AssertionError(f"expected {len(KERNELS)} kernels in the ptxas log, got {report}")
    print(f"build: nvcc {build_s:.2f} s for {lib.name} ({len(KERNELS)} kernels, one unit)",
          flush=True)
    for name, regs, stack, st, ld in report:
        print(f"ptxas: {name} registers={regs} stack_bytes={stack} "
              f"spill_stores={st} spill_loads={ld}", flush=True)


def compare_sizes(kernel: str, pool, run_kernel, run_plain, sizes, rng,
                  clock_mhz: float, sms: int, must_include=()) -> dict:
    """Kernel against plain, mask for mask, at each size (batches above
    4096 run as launches of 4096), then the timings. ``pool`` is a tuple
    of POOL-lane tensors on the card; ``must_include`` lanes join every
    batch."""
    rows = {}
    keep = np.asarray(must_include, dtype=np.int64)
    for size in sizes:
        idx = np.concatenate([keep, rng.integers(0, POOL, size - len(keep))])
        idx_t = torch.from_numpy(idx).to("cuda")
        batch = [t[idx_t].contiguous() for t in pool]
        chunk = min(size, SIZES[-1])
        parts = [[t[lo:lo + chunk] for t in batch] for lo in range(0, size, chunk)]

        def kern(parts=parts):
            return [run_kernel(*p) for p in parts]

        def plain(parts=parts):
            return [run_plain(*p) for p in parts]

        k_mask = torch.cat(kern()).cpu().numpy()
        # The plain version runs once: the compared call is the timed one.
        p_ms = time_ms(plain, 1, warm=False, keep=(out := []))
        p_mask = torch.cat(out[0]).cpu().numpy()
        err = int(np.abs(k_mask.astype(np.int32) - p_mask.astype(np.int32)).max())
        if err:
            bad = int((k_mask != p_mask).sum())
            raise AssertionError(f"{kernel}: kernel != plain on {bad} of {size} lanes")
        k_ms = time_ms(kern, 7)
        b_ms, b_by = bound_ms(kernel, size, clock_mhz, sms)
        rows[size] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "err": err}
        print(f"kernel {kernel}: lanes={size} threads_per_sig={THREADS_PER_SIG[kernel]} "
              f"launches={len(parts)} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.2f} sigs_per_s={size / k_ms * 1e3:.0f} "
              f"bound_ms={b_ms:.4f} bound_by={b_by} bound_share={b_ms / k_ms:.4f} "
              f"valid_lanes={int(k_mask.sum())} mismatches=0", flush=True)
    return rows


def phase_verify_kernel(clock_mhz: float, sms: int) -> dict:
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    rng = np.random.default_rng(SEED)
    items = mixed_pool(POOL, rng)
    host = ted.Ed25519BatchHost(buckets=(POOL,))
    t0 = time.perf_counter()
    arrays, prevalid, _ = host.pack(items[:256])
    pack_ms = (time.perf_counter() - t0) * 1e3
    pool, pool_valid, _ = host.pack(items)
    # Raw lanes outside the packer's precondition (s nibbles of s + L on a
    # valid row) and an explicit all-zero lane.
    pool = [a.copy() for a in pool]
    for j in range(0, POOL, 50):
        if pool_valid[j]:
            s = sum(int(v) << (4 * k) for k, v in enumerate(pool[5][j])) + host_ed.L
            pool[5][j] = [(s >> (4 * k)) & 0xF for k in range(64)]
    for a in pool:
        a[POOL - 1] = 0

    sample = [torch.from_numpy(a).to("cuda") for a in arrays]
    got = ed25519_cuda.verify(*sample).cpu().numpy() & prevalid
    oracle = np.array([host_ed.verify(*it) for it in items[:256]])
    if not np.array_equal(got[:256], oracle):
        raise AssertionError("ed25519_verify disagrees with the host oracle")
    print(f"kernel ed25519_verify: oracle sample 256 lanes agree; "
          f"pack_ms(256 items)={pack_ms:.1f}", flush=True)
    pool_t = tuple(torch.from_numpy(a).to("cuda") for a in pool)
    return compare_sizes("ed25519_verify", pool_t, ed25519_cuda.verify, ted.verify_plain,
                         SIZES + (BIG,), rng, clock_mhz, sms, must_include=[0, 50, POOL - 1])


def _raw_lanes(arrays, slots, edges, rng):
    """Overwrite the pool's last 32 lanes with raw rows outside the
    packer's precondition, built on lane 0 (a valid signature): each edge
    encoding in each of ``slots`` (the A and R rows of ``arrays``), then
    random bytes in the last slot. Returns the lanes."""
    lanes = list(range(POOL - 32, POOL))
    for a in arrays:
        a[lanes] = a[0]
    cases = [(slot, e) for e in edges for slot in slots]
    for lane, (slot, e) in zip(lanes, cases):
        arrays[slot][lane] = np.frombuffer(e, dtype=np.uint8)
    for lane in lanes[len(cases):]:
        arrays[slots[-1]][lane] = rng.integers(0, 256, 32, dtype=np.uint8)
    return lanes


def phase_wire_kernels(clock_mhz: float, sms: int):
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops import ed25519_wire as wire

    rng = np.random.default_rng(SEED + 1)
    items = mixed_pool(POOL, rng)
    edges = edge_encodings()
    host = wire.Ed25519WireHost(buckets=(POOL,))
    dev = torch.device("cuda")

    # Full wire: the packer's rows, then raw edge rows as A and as R.
    rows, prevalid, _ = host.pack_wire(items)
    rows = [r.copy() for r in rows]
    raw = _raw_lanes(rows, (0, 1), edges, rng)
    t = [torch.from_numpy(r).to(dev) for r in rows]
    got = ed25519_cuda.wire_verify(*(x[:256] for x in t)).cpu().numpy() & prevalid[:256]
    oracle = np.array([host_ed.verify(*it) for it in items[:256]])
    if not np.array_equal(got, oracle):
        raise AssertionError("ed25519_wire disagrees with the host oracle")
    print("kernel ed25519_wire: oracle sample 256 lanes agree", flush=True)
    wire_rows = compare_sizes("ed25519_wire", tuple(t), ed25519_cuda.wire_verify,
                              wire.wire_verify_plain, SIZES, rng, clock_mhz, sms,
                              must_include=raw)

    # Semiwire: a table of the pool's keys plus one bogus pubkey; every
    # seventh lane points at the bogus slot; raw edge rows as R.
    ring = _ring()
    table = wire.ValidatorTable(ring.signatories + [BOGUS], device=dev)
    rows, prevalid, _ = host.pack_wire_indexed(items, table)
    rows = [r.copy() for r in rows]  # idx, R, s, k
    rows[0][6::7] = table.index[BOGUS]
    raw = _raw_lanes(rows, (1,), edges, rng)
    pubs = ring.signatories + [BOGUS]
    eff = [(pubs[rows[0][i]], d, sig) for i, (_, d, sig) in enumerate(items)]
    pool = (table.upload_index(rows[0]),
            *(torch.from_numpy(r).to(dev) for r in rows[1:]))
    got = ed25519_cuda.semiwire_verify(*(x[:256] for x in pool),
                                       *table.arrays()).cpu().numpy() & prevalid[:256]
    oracle = np.array([host_ed.verify(*it) for it in eff[:256]])
    if not np.array_equal(got, oracle):
        raise AssertionError("ed25519_semiwire disagrees with the host oracle")
    print("kernel ed25519_semiwire: oracle sample 256 lanes agree "
          f"(bogus-slot lanes {len(range(6, 256, 7))})", flush=True)

    def semi(i, r, s, k):
        return ed25519_cuda.semiwire_verify(i, r, s, k, *table.arrays())

    def semi_plain(i, r, s, k):
        return wire.semiwire_verify_plain(i, r, s, k, *table.arrays())

    semi_rows = compare_sizes("ed25519_semiwire", pool, semi, semi_plain,
                              SIZES + (BIG,), rng, clock_mhz, sms, must_include=raw)
    return wire_rows, semi_rows, (items, table, pool, eff)


def _challenge_inputs(lanes: int, table, pool, rng):
    """A lanes-wide batch for the challenge kernel: table indices over
    every slot (the bogus one included), R rows from the wire pool (its
    raw edge lanes included) with lane 2 set to 0xff..., random digest
    rows with lane 0 all zero and lane 1 all 0xff, and a 16-row digest
    table with the same two edge rows at random digest indices."""
    dev = torch.device("cuda")
    idx = torch.from_numpy(rng.integers(0, table.n, lanes).astype(np.int32)).to(dev)
    pick = torch.from_numpy(rng.integers(0, POOL, lanes)).to(dev)
    r_rows = pool[1][pick].contiguous()
    r_rows[2] = 0xFF
    m_rows = torch.from_numpy(rng.integers(0, 256, (lanes, 32), dtype=np.uint8)).to(dev)
    m_rows[0], m_rows[1] = 0, 0xFF
    m_uniq = m_rows[:16].clone()
    m_idx = torch.from_numpy(rng.integers(0, 16, lanes).astype(np.uint8)).to(dev)
    m_idx[0], m_idx[1] = 0, 1
    return idx, r_rows, m_rows, m_idx, m_uniq


def phase_challenge(state, clock_mhz: float, sms: int) -> dict:
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops import ed25519_wire as wire

    items, table, pool, eff = state
    idx, r_rows = pool[0][:256], pool[1][:256]
    m = np.frombuffer(b"".join(d for _, d, _ in items[:256]), dtype=np.uint8).reshape(256, 32)
    m_t = torch.from_numpy(m.copy()).to("cuda")
    per_lane = ed25519_cuda.challenge(idx, r_rows, m_t, table.rows).cpu().numpy()
    m_uniq = m_t[:16].contiguous()
    m_idx = (torch.arange(256, device="cuda") % 16).to(torch.uint8)
    grouped = ed25519_cuda.challenge_grouped(idx, r_rows, m_idx, m_uniq,
                                             table.rows).cpu().numpy()
    r_host = r_rows.cpu().numpy()
    for i in range(256):
        pub, _, _ = eff[i]
        want = host_ed.challenge_scalar(bytes(r_host[i]), pub, bytes(m[i]))
        if bytes(per_lane[i]) != want.to_bytes(32, "little"):
            raise AssertionError(f"per-lane challenge differs from the host on lane {i}")
        want = host_ed.challenge_scalar(bytes(r_host[i]), pub, bytes(m[i % 16]))
        if bytes(grouped[i]) != want.to_bytes(32, "little"):
            raise AssertionError(f"grouped challenge differs from the host on lane {i}")
    print("kernel ed25519_challenge: oracle sample 256 lanes agree (per-lane and grouped)",
          flush=True)

    rng = np.random.default_rng(SEED + 2)
    rows = {}
    for lanes in (PATH_LANES, SIZES[-1]):
        idx, r_rows, m_rows, m_idx, m_uniq = _challenge_inputs(lanes, table, pool, rng)
        forms = {
            "per_lane": (ed25519_cuda.challenge, wire.challenge,
                         (idx, r_rows, m_rows, table.rows), 0),
            "grouped": (ed25519_cuda.challenge_grouped, wire.challenge_grouped,
                        (idx, r_rows, m_idx, m_uniq, table.rows), len(m_uniq)),
        }
        for form, (kern, plain, args, uniq) in forms.items():
            got = kern(*args).cpu().numpy().astype(np.int32)
            want = plain(*args).cpu().numpy().astype(np.int32)
            err = int(np.abs(got - want).max())
            if err:
                bad = int((got != want).any(axis=1).sum())
                raise AssertionError(
                    f"ed25519_challenge ({form}): kernel != plain on {bad} of {lanes} lanes")
            k_ms = time_ms(lambda kern=kern, args=args: kern(*args), 7)
            p_ms = time_ms(lambda plain=plain, args=args: plain(*args), 5)
            b_ms, b_by = bound_ms("ed25519_challenge", lanes, clock_mhz, sms, uniq)
            print(f"kernel ed25519_challenge: form={form} lanes={lanes} threads_per_lane=1 "
                  f"launches=1 kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
                  f"lanes_per_s={lanes / k_ms * 1e3:.0f} bound_ms={b_ms:.6f} "
                  f"bound_by={b_by} bound_share={b_ms / k_ms:.4f} mismatches=0", flush=True)
            if form == "grouped":
                rows[lanes] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "err": err}
    return rows


def _timed(spent, depth, key, fn):
    # Outermost calls only: the packer calls itself on a dedup fan-out.
    def run(*args, **kwargs):
        depth[key] = depth.get(key, 0) + 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[key] -= 1
            if not depth[key]:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
    return run


def run_path(label: str, own: tuple, verifier, ref) -> dict:
    """One n=256 network run with ``verifier`` on every settle; checks it
    against the host-verifier result ``ref`` and the kernel counts (each
    kernel of ``own`` at least once per vote-bearing settle, no other
    kernel at all), prints the line. Returns each own kernel's
    launches."""
    from hyperdrive_tpu_torch.crypto.keys import KeyPair
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                     burst=True, dedup_verify=True, small_window_host=False,
                     batch_verifier=verifier)
    bv = sim.batch_verifier
    bv.warmup()
    torch.cuda.synchronize()
    spent: dict = {}
    depth: dict = {}
    for name in ("pack", "pack_wire", "pack_wire_challenge", "group_digests", "index_lanes"):
        if hasattr(bv.host, name):
            setattr(bv.host, name, _timed(spent, depth, "pack", getattr(bv.host, name)))
    for name in ("_chal", "_chal_grouped"):
        if hasattr(bv, name):
            setattr(bv, name, _timed(spent, depth, "chal", getattr(bv, name)))
    bv.verify_signatures = _timed(spent, depth, "verify", bv.verify_signatures)

    sign = KeyPair.sign_digest
    KeyPair.sign_digest = _timed(spent, depth, "sign", sign)
    try:
        ed25519_cuda.reset_stats()
        if hasattr(bv, "reset_stats"):
            bv.reset_stats()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: (v.launches, v.lanes) for k, v in ed25519_cuda.stats.items()}
    finally:
        KeyPair.sign_digest = sign

    if not res.completed or min(res.heights) <= HEIGHT:
        raise AssertionError(f"{label}: network did not reach height {HEIGHT}: {res.heights}")
    res.assert_safety()
    if res.commit_digest(up_to=HEIGHT) != ref.commit_digest(up_to=HEIGHT):
        raise AssertionError(f"{label}: commit digest differs from the host-verifier run")
    if (res.steps, res.heights) != (ref.steps, ref.heights):
        raise AssertionError(f"{label}: steps or heights differ from the host-verifier run")
    launches = {k: counts[k][0] for k in own}
    for k, n in launches.items():
        if n < sim.vote_settles or n == 0:
            raise AssertionError(
                f"{label}: {n} {k} launches for {sim.vote_settles} vote-bearing settles")
    moved = {k: c for k, c in counts.items() if k not in own and c[0]}
    if moved:
        raise AssertionError(f"{label}: other kernels launched: {moved}")
    extra = ""
    if hasattr(bv, "stats"):
        key = "lanes_grouped" if bv.table is not None else "lanes_wire"
        if bv.stats[key] != sim.verified_sigs:
            raise AssertionError(
                f"{label}: {key}={bv.stats[key]} for {sim.verified_sigs} verified signatures")
        extra = (f" {key}={bv.stats[key]} bytes_per_lane={bv.bytes_per_lane():.2f}")
    shares = " ".join(f"{k}_share={spent.get(k, 0.0) / wall:.3f}"
                      for k in ("sign", "pack", "chal", "verify"))
    print(f"main {label}: n={N_VALIDATORS} height={HEIGHT} completed={res.completed} "
          f"steps={res.steps} wall_s={wall:.2f} heights_per_s={HEIGHT / wall:.3f} "
          f"verified_sigs={sim.verified_sigs} "
          f"verified_sigs_per_s={sim.verified_sigs / wall:.0f} "
          f"settle_passes={sim.settle_passes} vote_settles={sim.vote_settles} "
          + "".join(f"{k}_launches={counts[k][0]} {k}_lanes={counts[k][1]} " for k in own)
          + f"launches_per_height={sum(launches.values()) / HEIGHT:.1f}{extra} {shares} "
          f"digest={res.commit_digest(up_to=HEIGHT)[:16]} matches_host=True", flush=True)
    return launches


def phase_main_path() -> dict:
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.verifier import HostVerifier

    t0 = time.perf_counter()
    ref = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                     burst=True, dedup_verify=True, small_window_host=False,
                     batch_verifier=HostVerifier()).run()
    print(f"main host: host_verifier_wall_s={time.perf_counter() - t0:.2f} "
          f"digest={ref.commit_digest(up_to=HEIGHT)[:16]}", flush=True)
    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
    table = ValidatorTable(ring.signatories, device="cuda")
    return {
        **run_path("packed", ("ed25519_verify",), TorchBatchVerifier(device="cuda"), ref),
        **run_path("chal", ("ed25519_challenge", "ed25519_semiwire"),
                   TorchWireVerifier(device="cuda", table=table), ref),
        **run_path("wire", ("ed25519_wire",), TorchWireVerifier(device="cuda"), ref),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    props = torch.cuda.get_device_properties(0)
    clock = sm_clock_mhz()
    sms = props.multi_processor_count
    phase_card()
    rows = {"ed25519_verify": phase_verify_kernel(clock, sms)}
    rows["ed25519_wire"], rows["ed25519_semiwire"], state = phase_wire_kernels(clock, sms)
    base = rows["ed25519_verify"][PATH_LANES]["ms"]
    print(f"ratio: {PATH_LANES}-lane kernel time over ed25519_verify's in this run: "
          + " ".join(f"{k}={rows[k][PATH_LANES]['ms'] / base:.4f}"
                     for k in ("ed25519_wire", "ed25519_semiwire")), flush=True)
    rows["ed25519_challenge"] = phase_challenge(state, clock, sms)
    launches = phase_main_path()
    table = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name][PATH_LANES]
        table.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in rows[name].values()),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
