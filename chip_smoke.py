"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines:

1. card: the card's name and power limit as nvidia-smi prints them, then
   the nvcc builds of the two kernel libraries (the three verify kernels
   and the challenge kernel in one unit, ``g1_aggregate`` in another; both
   nvcc calls started together) from the sources in this checkout, with
   each kernel's registers, stack and spills as ptxas reports them; then
   the g++ build of the native host runtime (``hyperdrive_tpu_torch/
   native``: signer, packers, host verifier) and its host times a
   signature, a packed item and a host verification beside the
   pure-Python oracle's, on a line that begins ``native: loaded``
   (``HD_NO_NATIVE`` set, or a failed build, is an error here, not a
   fallback);
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
   (the PyTorch-ops leg) byte for byte on both forms at 64 lanes (the
   deployment capstone's bucket), 256, 1,024 (the pipelined runs'
   coalesced batch) and 4,096, with edge digests (all-zero and all-0xff M) and R = 0xff...;
   kernel and plain times, the integer-instruction bound and its share;
4. the vote grid (``ops/votegrid.py``, PyTorch ops, no hand-written
   kernel) at the main path's shape (n = V = 256, R = 4): one seeded
   sequence of settles (scatters with resets and L28 lanes, an empty
   launch, fused merges with lanes written twice and replicas that do not
   participate) replayed on the card and on the CPU, grids and counts
   equal bit for bit after every step; one fused call whose verify is
   ``ed25519_verify`` on a 256-lane mixed window, its mask equal to
   ``verify_plain``'s and its counts to the CPU grid's fed that mask; then
   the device time (CUDA events) of ``update_and_tally`` at 65,536 rows,
   of the fused call with and without the verify kernel, and of the
   verify alone, the CUDA kernels one call launches (``torch.profiler``)
   and the bound (the grid's bytes read once at the memory rate), on
   lines that begin ``programs:``;
5. main path: the signed 256-validator burst network
   (``Simulation(n=256, sign=True, burst=True, dedup_verify=True,
   small_window_host=False)``) to height 5, five times, every settle
   verified on the card: through the packed verifier (``ed25519_verify``),
   through ``TorchWireVerifier`` with a ``ValidatorTable`` of the 256
   validator keys (grouped challenge route, ``ed25519_challenge`` then
   ``ed25519_semiwire``), through ``TorchWireVerifier`` with no table
   (full wire route, ``ed25519_wire``), and with ``device_tally=True,
   tally_check=CheckedTallyView`` through the packed verifier (every
   vote-bearing settle verified, merged and tallied in one fused call)
   and through the table's challenge route (verify, then a separate tally
   launch on every settle). Each run is checked for safety, against one
   run with the host verifier (digest, steps, heights), and for having
   launched its own kernels, each at least once per vote-bearing settle,
   and no other; the device-tally runs also for device counts consulted
   (and equal to the host's) and for their settle routes. Every run signs,
   packs and host-verifies natively; ``packed`` runs once more in a child
   process with ``HD_NO_NATIVE=1`` (``packed (python host)``) for the
   shares of the pure-Python host in the same call;
6. pipelined heights: the same network with ``pipeline_heights=True``
   (``packed+pipe``, ``chal+pipe``, and ``packed+tally+pipe``, the
   README's config-4 call with ``device_tally=True,
   tally_check=CheckedTallyView``), each verifier on the buckets of the
   JAX package's config-4 pipelined benchmark (1,024 lanes up), so that
   the device-work queue coalesces settles into fewer launches than it
   was handed commands. Each run commits the host run's digest; each own
   kernel launched once for every chunk of every queue launch and no
   other kernel ran; the device-tally run dispatched on the host counters
   (no fused settle, no tally launch, no host-routed settle). Then the
   sequential and the pipelined packed run in turns, three pairs each
   way, on lines that begin ``pairs:`` (walls, median, spread);
7. the deployment path: threaded replicas on a loopback-TCP full mesh,
   one worker process per port (``python -m
   hyperdrive_tpu_torch.harness.deploy ... card``), each process with one
   ``TorchWireVerifier`` (a ``ValidatorTable`` of the network's keys:
   ``ed25519_challenge`` then ``ed25519_semiwire`` on every flush) and one
   ``DeviceTallyFlusher`` (an n = 1 vote grid, every count checked by
   ``CheckedTallyView``) per replica, replicas on their own threads with
   wall-clock timeouts. Two runs: ``capstone`` (the JAX package's
   two-process capstone: n = 4, two processes x two replicas, ten
   heights, 64-lane buckets, every flush's card mask held against
   ``HostVerifier``'s) and ``full`` (n = 256, four processes x 64
   replicas, three heights, default buckets, 20 s timeouts, 300 s
   deadline). Each checked for equal digests across the processes, the
   device counts consulted, grouped lanes, and both kernels launched in
   every worker; each worker's wall, heights/s, flushes, launches, lanes,
   verify and tally shares, commit rounds and shed frames on lines that
   begin ``deploy``. Before them, ``deploy contention:`` lines: a flush's
   grid call (n = 1, V = 256) and verify call (100 grouped lanes), host
   wall per call from one thread and from 64 threads of this process;
8. Shamir reconstruct (``ops/shamir.py``, PyTorch ops, no hand-written
   kernel): ``BatchReconstructor`` on the card at k = 171 (n = 256, f =
   85) for 16, 64 and 1,024 blocks, every payload equal byte for byte to
   the oracle's ``reconstruct_payload`` (at 1,024 blocks: to the payload,
   to the host leg, and 40 sampled blocks to the oracle's
   ``reconstruct_block``); ms of ``reconstruct_kernel`` (CUDA events),
   CUDA kernels a call, the bound and its share, the wrapper's and the
   host leg's wall; ``AdaptiveReconstructor``'s calibration record at
   1,024 blocks; on lines that begin ``programs: shamir``;
9. the RLC batch equation (``rlc_check`` on ``ops/msm.py``, PyTorch ops):
   one 64-lane MSM equal to the oracle's point sum; then
   ``TorchBatchVerifier(rlc=True)`` at 64, 256, 1,024 and 4,096 lanes: a
   clean batch accepted by one check with no fallback and no ladder
   launch, a batch with one forged lane falling back once with its mask
   equal to ``ed25519_verify``'s and the oracle's, and (64 lanes) the
   order-8 torsion vector accepted by the RLC and rejected by the ladder;
   ms and CUDA kernels of ``rlc_check`` beside the ladder's time at the
   same lanes; on lines that begin ``programs: rlc``;
10. config 5 (BASELINE configs[4]) as the JAX package's bench runs it
   (n = 256, k = 171, 496-byte payloads, seed 1005, 20 s timeouts,
   burst, 10 heights), signed (every settle on ``ed25519_verify``): the
   host run (``HostVerifier``), a run with
   ``BatchReconstructor`` pinned on the card (one reconstruct launch a
   committed value) and one with the adaptive default (16-block commits
   on the host leg: no launch); each equal to the host run in digest,
   steps and every replica's reconstructed payloads; heights/s, the
   reconstruct share of wall and its p50, launches; lines ``config5``;
11. certificates: the main path with ``certificates=True`` through the
   packed verifier with ``rlc=False`` and ``rlc=True``: digest
   ``215413db54656240`` in 656,640 steps, chain digests equal across
   replicas and to a host run's, every certificate re-verified and
   round-tripped through its codec, the RLC run's checks, fallbacks and
   wall; lines ``certs``;
12. the execution layer (``exec/``, ``ops/ledger.py``, ``ops/merkle.py``,
   PyTorch ops, no hand-written kernel) at the JAX package's documented
   sizes: one Merkleized apply step at 65,536 accounts and 16,384
   (incremental tree update) and 65,536 txs (full rebuild), every output
   equal to the host executor's, ms (CUDA events), CUDA kernels a call and
   the bound by bytes (``programs: exec``); leg A, the n = 256 network
   sequential with a ``DeviceLedgerExecutor`` a replica (65,536 accounts,
   16,384-tx blocks, three heights), every replica's commit record equal
   to the value and the host executor's root, heights/s, apply and
   block-synthesis shares; leg B, pipelined, speculative and signed (4,096
   accounts, 1,024 txs a block, every 7th signature forged, five
   heights), fused on the card, fused with the host executor and
   two-kind on the card: rollbacks, no discarded root committed, commits
   equal across the three and the JAX package's digest, fewer
   ``ed25519_verify`` launches fused, and the blocks' signature rows
   verified by ``ed25519_verify``; lines ``exec``;
13. BLS12-381 (``phase_bls``): ``fp381.mul`` (PyTorch ops) on 4,096 products
   against Python ints; the ``g1_aggregate`` kernel (``csrc/g1_aggregate.cu``,
   built in phase 1 beside the ed25519 library, one nvcc a unit, both
   started together) against its plain version ``aggregate_kernel`` at the
   JAX package's bench widths (256, 1,024 and 4,096 lanes, masks about
   two-thirds set), on edge lanes (an all-masked committee, identity rows,
   P and -P, P twice), at odd widths 5 and 255 and on a batched 8 x 256
   call through ``G1SumLauncher`` (one launch), every coordinate equal
   after ``canonical`` and every affine sum equal to the oracle's fold;
   kernel ms (CUDA events), plain ms, host-fold s, the bound (multiply
   instructions of a 12 x 32-bit field) and the plain version's CUDA
   kernels a call; ``g1_msm_kernel`` (PyTorch ops, 8 lanes, 64 windows)
   against the oracle; the n = 256 certificate minted on the kernel and
   on the host fold (equal aggregates, the light-client check passing and
   a forged height failing); then the certified sim (``Simulation(n=16,
   target_height=5, seed=1, sign=True, burst=True, dedup_verify=True,
   small_window_host=False, bls_certificates="device")``) on the card
   against its host run with the host fold: digest, steps and chain
   digests equal, ``g1_aggregate`` launched once a replica a commit and
   no kernel but it and ``ed25519_verify``, one certificate a height
   re-verified; heights/s and the aggregate's share of wall; lines
   ``bls``, ``kernel g1_aggregate`` and ``programs: bls``, after the
   card's name and power limit.

Each path of phases 5, 6, 10, 11, 12 and 13 is driven with the kernel counts
set to 0 just before it and read just after.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
#: Verify buckets of the pipelined runs: the JAX package's config-4
#: pipelined benchmark verifier (``benches/run_all.py``,
#: ``TpuBatchVerifier(buckets=(1024, 4096, 16384))``). With the default
#: ladder a 256-lane vote window fills its bucket alone, and the queue's
#: spill rule closes every pipeline slot after one settle.
PIPE_BUCKETS = (1024, 4096, 16384)
#: The largest coalesced settle batch of the pipelined runs (three vote
#: settles and a proposal) and the most distinct digests in one of them;
#: ``run_path`` checks both against the ``chal+pipe`` run, and
#: ``phase_challenge`` holds the kernel against its plain version there.
PIPE_BATCH, PIPE_DIGESTS = 770, 5
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
    "g1_aggregate": ("hyperdrive_tpu_torch/csrc/g1_aggregate.cu",
                     "hyperdrive_tpu/ops/g1.py:182 (batched by :246)"),
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
        sig = kp.sign_digest(digest)
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
        r"Compiling entry function '[^']*?(hd_\w+?_kernel)[^']*'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers", log, re.S,
    ):
        name, stack, st, ld, regs = m.groups()
        out.append((name, int(regs), int(stack), int(st), int(ld)))
    return out


def phase_card():
    """Build every kernel library from the sources in this checkout, one
    nvcc a unit, all started together, and print what ptxas reports."""
    from concurrent.futures import ThreadPoolExecutor

    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1_cuda

    print(card_line(), flush=True)

    def timed_build(mod):
        t0 = time.perf_counter()
        lib = mod.build(force=True)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(timed_build, (ed25519_cuda, g1_cuda)))
    wall = time.perf_counter() - t0
    report = []
    for lib, build_s in built:
        entries = ptxas_report((lib.parent / "nvcc.log").read_text())
        report += entries
        print(f"build: nvcc {build_s:.2f} s for {lib.name} ({len(entries)} kernels, "
              f"one unit)", flush=True)
    if len(report) != len(KERNELS):
        raise AssertionError(f"expected {len(KERNELS)} kernels in the ptxas logs, got {report}")
    print(f"build: {len(built)} units in parallel, {wall:.2f} s wall", flush=True)
    for name, regs, stack, st, ld in report:
        print(f"ptxas: {name} registers={regs} stack_bytes={stack} "
              f"spill_stores={st} spill_loads={ld}", flush=True)


def _host_us(fn, count: int, reps: int = 5) -> float:
    """Median host time of ``fn()`` over ``reps`` calls, in µs per item
    (``count`` items a call)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / count * 1e6


def phase_native() -> None:
    """Build the native host runtime and time it on this machine's host
    beside the pure-Python oracle, on 256 signed items of one ring."""
    from hyperdrive_tpu_torch import native
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.verifier import HostVerifier

    if os.environ.get("HD_NO_NATIVE"):
        raise AssertionError("HD_NO_NATIVE is set: this script measures the native host")
    prebuilt = any(os.path.exists(path) for _, path in native._build_plans())
    t0 = time.perf_counter()
    packer = native.instance()
    build_s = time.perf_counter() - t0
    if packer is None:
        raise AssertionError(f"native runtime did not load: {native.last_error()}")
    ring = _ring()
    rng = np.random.default_rng(SEED + 5)
    digests = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(PATH_LANES)]
    items = [(ring[i % 32].public, d, ring[i % 32].sign_digest(d))
             for i, d in enumerate(digests)]
    for i in range(8):  # the signer's bytes are the oracle's
        if items[i][2] != host_ed.sign(ring[i % 32].seed, digests[i]):
            raise AssertionError("native signature differs from the oracle's")

    def sign_all():
        for i, d in enumerate(digests):
            ring[i % 32].sign_digest(d)

    fast = ted.Ed25519BatchHost(buckets=(PATH_LANES,))
    slow = ted.Ed25519BatchHost(buckets=(PATH_LANES,), use_native=False)
    got, want = fast.pack(items), slow.pack(items)
    if not (all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
            and np.array_equal(got[1], want[1])):
        raise AssertionError("native packer differs from the Python packer")
    host = HostVerifier()
    if not host.verify_signatures(items).all():
        raise AssertionError("native host verifier rejected a valid signature")
    sign_us = _host_us(sign_all, PATH_LANES)
    pack_us = _host_us(lambda: fast.pack(items), PATH_LANES)
    verify_us = _host_us(lambda: host.verify_signatures(items), PATH_LANES)
    py_sign_us = _host_us(lambda: [host_ed.sign(ring[i].seed, digests[i]) for i in range(16)],
                          16, reps=3)
    py_pack_us = _host_us(lambda: slow.pack(items[:16]), 16, reps=3)
    py_verify_us = _host_us(lambda: [host_ed.verify(*it) for it in items[:16]], 16, reps=3)
    print(f"native: loaded build_s={build_s:.2f} prebuilt={prebuilt} sign_us={sign_us:.1f} "
          f"pack_us_per_item={pack_us:.1f} verify_us={verify_us:.1f} "
          f"python_sign_us={py_sign_us:.1f} python_pack_us_per_item={py_pack_us:.1f} "
          f"python_verify_us={py_verify_us:.1f} (host CPU, {PATH_LANES} items of one "
          f"32-key ring; Python times over 16)", flush=True)


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


def _challenge_inputs(lanes: int, table, pool, rng, digests: int = 16):
    """A lanes-wide batch for the challenge kernel: table indices over
    every slot (the bogus one included), R rows from the wire pool (its
    raw edge lanes included) with lane 2 set to 0xff..., random digest
    rows with lane 0 all zero and lane 1 all 0xff, and a 16-row digest
    table whose first ``digests`` rows are live (the same two edge rows
    among them, the rest zero as ``group_digests`` pads them), at random
    digest indices."""
    dev = torch.device("cuda")
    idx = torch.from_numpy(rng.integers(0, table.n, lanes).astype(np.int32)).to(dev)
    pick = torch.from_numpy(rng.integers(0, POOL, lanes)).to(dev)
    r_rows = pool[1][pick].contiguous()
    r_rows[2] = 0xFF
    m_rows = torch.from_numpy(rng.integers(0, 256, (lanes, 32), dtype=np.uint8)).to(dev)
    m_rows[0], m_rows[1] = 0, 0xFF
    m_uniq = m_rows[:16].clone()
    m_uniq[digests:] = 0
    m_idx = torch.from_numpy(rng.integers(0, digests, lanes).astype(np.uint8)).to(dev)
    m_idx[0], m_idx[1] = 0, 1
    return idx, r_rows, m_rows, m_idx, m_uniq


def phase_challenge(state, clock_mhz: float, sms: int) -> dict:
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import bucketing, ed25519_cuda
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
    # The deployment capstone's 64-lane bucket, a sequential vote window, a
    # coalesced settle batch of the pipelined runs (its bucket and digest
    # count), and the largest default bucket.
    pipe_lanes = bucketing.bucket_for(PIPE_BATCH, PIPE_BUCKETS)
    for lanes, digests in ((SIZES[0], 16), (PATH_LANES, 16), (pipe_lanes, PIPE_DIGESTS),
                           (SIZES[-1], 16)):
        idx, r_rows, m_rows, m_idx, m_uniq = _challenge_inputs(lanes, table, pool, rng,
                                                               digests)
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
            print(f"kernel ed25519_challenge: form={form} lanes={lanes} "
                  f"digests={digests if uniq else lanes} threads_per_lane=1 "
                  f"launches=1 kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
                  f"lanes_per_s={lanes / k_ms * 1e3:.0f} bound_ms={b_ms:.6f} "
                  f"bound_by={b_by} bound_share={b_ms / k_ms:.4f} mismatches=0", flush=True)
            if form == "grouped":
                rows[lanes] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "err": err}
    return rows


#: The grid at the main path's shape: n replicas x V validators x R slots.
GRID_N, GRID_R = N_VALIDATORS, 4
#: Bytes of the grid read once: values [n, 2, R, V, 8] int32 + present
#: [n, 2, R, V] bool.
GRID_BYTES = GRID_N * 2 * GRID_R * N_VALIDATORS * (8 * 4 + 1)
#: Rows one two-launch tally scatters at the main path's shape: every
#: replica accepts one vote from every validator.
GRID_ROWS = GRID_N * N_VALIDATORS
VALUES = [b"\xaa" * 32, b"\x11" * 32, bytes(32), bytes(range(0x80, 0xA0))]


def _words(value: bytes) -> np.ndarray:
    return np.frombuffer(value, dtype="<i4").astype(np.int32)


def _grid_meta(rng, n, R):
    """Seeded per-replica metadata: targets from VALUES on most rounds,
    an L28 lane on about half the replicas, f = 85."""
    palette = np.stack([_words(v) for v in VALUES])
    targets = palette[rng.integers(0, 2, (n, R))]
    tvalid = rng.random((n, R)) < 0.7
    l28_slot = np.where(rng.random(n) < 0.5, rng.integers(0, R, n), -1).astype(np.int32)
    l28_target = palette[rng.integers(0, 4, n)]
    return targets, tvalid, l28_slot, l28_target, np.full(n, n // 3, dtype=np.int32)


def _scatter_args(rng, n, V, R, k):
    lanes = rng.choice(n * 2 * R * V, size=k, replace=False)
    idx = np.stack(np.unravel_index(lanes, (n, 2, R, V)), axis=1).astype(np.int32)
    words = np.stack([_words(v) for v in VALUES])[rng.integers(0, 4, k)]
    reset = rng.random(n) < 0.1
    return (idx, words, reset, *_grid_meta(rng, n, R))


def _fused_args(rng, n, V, R, lanes, present):
    """One fused launch's inputs: about ``lanes`` claimed grid lanes
    gated by verify lanes 0..255, some of them already present in the grid
    (the presence guard keeps the first vote)."""
    upd_lane = np.full((2, R, V), -1, dtype=np.int32)
    pick = rng.choice(2 * R * V, size=lanes, replace=False)
    upd_lane.reshape(-1)[pick] = rng.integers(0, PATH_LANES, lanes)
    again = np.argwhere(present.any(axis=0))[:64]
    upd_lane[tuple(again.T)] = rng.integers(0, PATH_LANES, len(again))
    upd_vals = np.stack([_words(v) for v in VALUES])[rng.integers(0, 4, (2, R, V))]
    reset = rng.random(n) < 0.1
    participate = rng.random(n) < 0.8
    targets, tvalid, l28_slot, l28_target, fs = _grid_meta(rng, n, R)
    return (upd_lane, upd_vals, reset, participate, targets, tvalid, l28_slot,
            l28_target, fs)


def _same_grids(step, cuda, cpu, got, want):
    for key in want:
        if not np.array_equal(np.asarray(got[key]), np.asarray(want[key])):
            raise AssertionError(f"votegrid step {step}: counts[{key}] differ cuda vs cpu")
    if not (torch.equal(cuda._values.cpu(), cpu._values)
            and torch.equal(cuda._present.cpu(), cpu._present)):
        raise AssertionError(f"votegrid step {step}: grids differ cuda vs cpu")


def _kernels_per_call(fn) -> str:
    """The CUDA kernels one call of ``fn`` launches, from torch.profiler
    (memory copies and sets not counted), as "N (name, ...)"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    if not names:
        return "not_measured (the profiler recorded no device events)"
    short = sorted({re.sub(r"<.*", "", n)[:48] for n in names})
    return f"{len(names)} ({'; '.join(short)})"


def phase_votegrid() -> None:
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.votegrid import VoteGrid

    n, V, R = GRID_N, N_VALIDATORS, GRID_R
    rng = np.random.default_rng(SEED + 3)
    cuda = VoteGrid(n, V, r_slots=R, device="cuda")
    cpu = VoteGrid(n, V, r_slots=R, device="cpu")
    zeros = ([np.zeros((PATH_LANES, 20), dtype=np.int32)] * 5
             + [np.zeros((PATH_LANES, 64), dtype=np.int32)] * 2)
    steps = [("scatter", 4096), ("scatter", 0), ("fused", 1500), ("scatter", GRID_ROWS),
             ("fused", 2 * R * V), ("scatter", 900), ("fused", 600)]
    for step, (kind, k) in enumerate(steps):
        if kind == "scatter":
            args = _scatter_args(rng, n, V, R, k)
            _same_grids(step, cuda, cpu, cuda.update_and_tally(*args),
                        cpu.update_and_tally(*args))
            continue
        mask = rng.random(PATH_LANES) < 0.8
        mask_cuda, mask_cpu = torch.from_numpy(mask).to("cuda"), torch.from_numpy(mask)
        cuda.attach_fused(lambda b: lambda *a: mask_cuda)
        cpu.attach_fused(lambda b: lambda *a: mask_cpu)
        args = _fused_args(rng, n, V, R, k, cpu._present.numpy())
        got = cuda.fused_update_and_tally(zeros, *args)
        want = cpu.fused_update_and_tally(zeros, *args)
        if not np.array_equal(got.mask(), want.mask()):
            raise AssertionError(f"votegrid step {step}: fused masks differ")
        _same_grids(step, cuda, cpu, got.counts(), want.counts())
    print(f"programs: votegrid n={n} V={V} R={R} grid_bytes={GRID_BYTES} "
          f"steps={len(steps)} (scatters of 4096/0/{GRID_ROWS}/900 rows with resets and "
          f"L28 lanes; fused merges with rewritten lanes and non-participants) "
          f"cuda_equals_cpu=True present_lanes={int(cuda._present.sum())}", flush=True)

    # The fused call with the row 1 kernel as its verify, on a mixed window.
    bv = ted.TorchBatchVerifier(device="cuda")
    cuda.attach_fused(bv.fused_inner)
    items = mixed_pool(PATH_LANES, np.random.default_rng(SEED + 4))
    arrays, prevalid, _ = bv.host.pack(items)
    upd_lane = np.full((2, R, V), -1, dtype=np.int32)
    upd_vals = np.zeros((2, R, V, 8), dtype=np.int32)
    for j in range(PATH_LANES):
        upd_lane[j % 2, j % R, j] = j
        upd_vals[j % 2, j % R, j] = _words(VALUES[j % 4])
    args = (upd_lane, upd_vals, np.zeros(n, bool), np.ones(n, bool),
            *_grid_meta(rng, n, R))
    ed25519_cuda.reset_stats()
    got = cuda.fused_update_and_tally(arrays, *args)
    mask = got.mask()
    if ed25519_cuda.stats["ed25519_verify"].launches != 1:
        raise AssertionError("the fused call did not launch ed25519_verify once")
    plain = ted.verify_plain(*(torch.from_numpy(a).to("cuda") for a in arrays)).cpu()
    if not np.array_equal(mask, plain.numpy()):
        raise AssertionError("fused mask != verify_plain's mask")
    cpu.attach_fused(lambda b: lambda *a: plain)
    _same_grids("fused+verify", cuda, cpu, got.counts(),
                cpu.fused_update_and_tally(arrays, *args).counts())
    print(f"programs: votegrid fused verify=ed25519_verify lanes={PATH_LANES} "
          f"mask_equals_verify_plain=True valid_lanes={int((mask & prevalid).sum())} "
          f"counts_equal_cpu_grid=True", flush=True)

    # Device times at the main path's shapes.
    dev_arrays = [torch.from_numpy(a).to("cuda") for a in arrays]
    stub = torch.ones(PATH_LANES, dtype=torch.bool, device="cuda")
    scatter = _scatter_args(rng, n, V, R, GRID_ROWS)
    b_ms = GRID_BYTES / HBM_BYTES_PER_S * 1e3
    stub_grid = VoteGrid(n, V, r_slots=R, device="cuda")
    stub_grid.attach_fused(lambda b: lambda *a: stub)
    calls = [
        ("update_and_tally", f"rows={GRID_ROWS} (one vote window, every replica)",
         lambda: cuda.update_and_tally(*scatter)["total"]),
        ("fused_update_and_tally", f"lanes={PATH_LANES} (verify + merge + tally)",
         lambda: cuda.fused_update_and_tally(arrays, *args).mask()),
        ("merge_tally", f"lanes={PATH_LANES} (fused call, verify a constant mask)",
         lambda: stub_grid.fused_update_and_tally(arrays, *args).mask()),
        ("verify", f"lanes={PATH_LANES} (ed25519_verify alone)",
         lambda: ed25519_cuda.verify(*dev_arrays)),
    ]
    for name, what, fn in calls:
        ms = time_ms(fn, 7)
        kern = _kernels_per_call(fn)
        bound = (f" bound_ms={b_ms:.6f} bound_by=bytes bound_share={b_ms / ms:.4f}"
                 if name != "verify" else "")
        print(f"programs: votegrid {name} {what} ms={ms:.4f}{bound} "
              f"cuda_kernels_per_call={kern}", flush=True)


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


def run_path(label: str, own: tuple, verifier, ref: dict, tally: bool = False,
             pipe: bool = False) -> dict:
    """One n=256 network run with ``verifier`` on every settle; checks it
    against the host-verifier result ``ref`` (digest, steps, heights) and
    the kernel counts (each kernel of ``own`` at least once per
    vote-bearing settle, no other kernel at all), prints the line. With
    ``tally`` the run keeps its counts in the device vote grid, every
    count checked against the host counters (``CheckedTallyView``), and
    its settle routes are checked: a verifier with ``fused_inner`` fuses
    every vote-bearing settle, any other verifies and then tallies in a
    launch of its own on every settle. With ``pipe`` the run pipelines
    heights: its digest, steps and heights must equal the host run's (an
    honest pipelined run is superstep-identical to the sequential one),
    its queue must have coalesced (fewer launches than commands), no
    batch may be larger, or hold more digests, than ``phase_challenge``
    checked the challenge kernel at, each own kernel must have
    launched once for every chunk of every queue launch, and a tallied
    run dispatches on the host counters (no fused settle, no tally
    launch, no host-routed settle; the grid is never read). Returns each
    own kernel's launches."""
    from hyperdrive_tpu_torch.crypto.keys import KeyPair
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import bucketing, ed25519_cuda
    from hyperdrive_tpu_torch.ops import votegrid

    views = []

    def check(view, proc):
        views.append(votegrid.CheckedTallyView(view, proc))
        return views[-1]

    sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                     burst=True, dedup_verify=True, small_window_host=False,
                     batch_verifier=verifier, pipeline_heights=pipe,
                     **(dict(device_tally=True, tally_check=check) if tally else {}))
    bv = sim.batch_verifier
    bv.warmup()
    torch.cuda.synchronize()
    spent: dict = {}
    depth: dict = {}
    calls: list = []  # items per verify_signatures call
    digests: list = []  # distinct digests per verify_signatures call
    verify_signatures = bv.verify_signatures

    def counted(items):
        calls.append(len(items))
        digests.append(len({d for _, d, _ in items}))
        return verify_signatures(items)

    bv.verify_signatures = counted
    for name in ("pack", "pack_wire", "pack_wire_challenge", "group_digests", "index_lanes"):
        if hasattr(bv.host, name):
            setattr(bv.host, name, _timed(spent, depth, "pack", getattr(bv.host, name)))
    for name in ("_chal", "_chal_grouped"):
        if hasattr(bv, name):
            setattr(bv, name, _timed(spent, depth, "chal", getattr(bv, name)))
    bv.verify_signatures = _timed(spent, depth, "verify", bv.verify_signatures)
    # The tally share: the grid calls and the waits for their results.
    patched = [(KeyPair, "sign_digest", "sign")]
    if tally:
        for name in ("update_and_tally", "fused_update_and_tally"):
            setattr(sim.vote_grid, name,
                    _timed(spent, depth, "tally", getattr(sim.vote_grid, name)))
        patched += [(votegrid._FusedOut, "mask", "tally"),
                    (votegrid.LazyCounts, "_materialize", "tally")]
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in patched]
    for cls, name, key in patched:
        setattr(cls, name, _timed(spent, depth, key, getattr(cls, name)))
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
        for cls, name, fn in saved:
            setattr(cls, name, fn)

    if not res.completed or min(res.heights) <= HEIGHT:
        raise AssertionError(f"{label}: network did not reach height {HEIGHT}: {res.heights}")
    res.assert_safety()
    if res.commit_digest(up_to=HEIGHT) != ref["digest"]:
        raise AssertionError(f"{label}: commit digest differs from the host-verifier run")
    if (res.steps, res.heights) != (ref["steps"], ref["heights"]):
        raise AssertionError(f"{label}: steps or heights differ from the host-verifier run")
    launches = {k: counts[k][0] for k in own}
    extra = ""
    if pipe:
        q = sim._sched
        cap = bucketing.launch_target(bv.host.buckets)
        chunks = sum(math.ceil(n / cap) for n in calls)
        if not (q.launches < q.submitted and q.coalesced > 0 and q.depth == 0):
            raise AssertionError(
                f"{label}: queue submitted={q.submitted} launches={q.launches} "
                f"coalesced={q.coalesced} depth={q.depth}: nothing coalesced")
        if len(calls) != q.launches or any(n != chunks for n in launches.values()):
            raise AssertionError(
                f"{label}: {launches} kernel launches for {q.launches} queue launches "
                f"({len(calls)} verify calls, {chunks} chunks)")
        if max(calls) > PIPE_BATCH or max(digests) > PIPE_DIGESTS:
            raise AssertionError(
                f"{label}: batches {calls} with {digests} digests exceed the "
                f"{PIPE_BATCH} items and {PIPE_DIGESTS} digests phase_challenge checked")
        extra = (f" queue_submitted={q.submitted} queue_launches={q.launches} "
                 f"queue_coalesced={q.coalesced} items_per_launch={calls} "
                 f"digests_per_launch={digests}")
    for k, n in launches.items():
        if not pipe and (n < sim.vote_settles or n == 0):
            raise AssertionError(
                f"{label}: {n} {k} launches for {sim.vote_settles} vote-bearing settles")
    moved = {k: c for k, c in counts.items() if k not in own and c[0]}
    if moved:
        raise AssertionError(f"{label}: other kernels launched: {moved}")
    if hasattr(bv, "stats"):
        key = "lanes_grouped" if bv.table is not None else "lanes_wire"
        if bv.stats[key] != sim.verified_sigs:
            raise AssertionError(
                f"{label}: {key}={bv.stats[key]} for {sim.verified_sigs} verified signatures")
        extra += (f" {key}={bv.stats[key]} bytes_per_lane={bv.bytes_per_lane():.2f}")
    if tally:
        hits = sum(v.hits for v in views)
        if not hits and not pipe:
            raise AssertionError(f"{label}: the device counts were never consulted")
        routes = (sim.fused_settles, sim.tally_launches, sim.host_routed_settles)
        want = ((0, 0, 0) if pipe
                else (sim.vote_settles, 0, 0) if sim._fused_ok
                else (0, sim.settle_passes, 0))
        if routes != want or not sim.vote_settles:
            raise AssertionError(
                f"{label}: (fused settles, tally launches, host-routed settles) = "
                f"{routes}, want {want}")
        extra += (f" fused_settles={sim.fused_settles} tally_launches={sim.tally_launches}"
                  f" host_routed_settles={sim.host_routed_settles} tally_views={len(views)}"
                  f" tally_hits={hits}")
    shares = " ".join(f"{k}_share={spent.get(k, 0.0) / wall:.3f}"
                      for k in ("sign", "pack", "chal", "verify", "tally"))
    print(f"main {label}: n={N_VALIDATORS} height={HEIGHT} completed={res.completed} "
          f"steps={res.steps} wall_s={wall:.2f} heights_per_s={HEIGHT / wall:.3f} "
          f"verified_sigs={sim.verified_sigs} "
          f"verified_sigs_per_s={sim.verified_sigs / wall:.0f} "
          f"settle_passes={sim.settle_passes} vote_settles={sim.vote_settles} "
          + "".join(f"{k}_launches={counts[k][0]} {k}_lanes={counts[k][1]} " for k in own)
          + f"launches_per_height={sum(launches.values()) / HEIGHT:.1f}{extra} {shares} "
          f"digest={res.commit_digest(up_to=HEIGHT)[:16]} matches_host=True", flush=True)
    return launches


def python_host_child(ref: dict) -> int:
    """``packed`` with the pure-Python host (run in a child process whose
    environment sets ``HD_NO_NATIVE=1``; the kernel library is the
    parent's build)."""
    from hyperdrive_tpu_torch import native
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    if native.available():
        raise AssertionError("the python-host run loaded the native runtime")
    run_path("packed (python host)", ("ed25519_verify",),
             TorchBatchVerifier(device="cuda"), ref)
    return 0


def run_python_host(ref: dict) -> None:
    env = dict(os.environ, HD_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--python-host", json.dumps(ref)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise AssertionError(f"packed (python host) failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")


def phase_main_path() -> dict:
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.verifier import HostVerifier

    t0 = time.perf_counter()
    host = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                      burst=True, dedup_verify=True, small_window_host=False,
                      batch_verifier=HostVerifier()).run()
    ref = {"digest": host.commit_digest(up_to=HEIGHT), "steps": host.steps,
           "heights": host.heights}
    print(f"main host: host_verifier_wall_s={time.perf_counter() - t0:.2f} "
          f"steps={host.steps} digest={ref['digest'][:16]}", flush=True)
    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
    table = ValidatorTable(ring.signatories, device="cuda")
    launches = {
        **run_path("packed", ("ed25519_verify",), TorchBatchVerifier(device="cuda"), ref),
        **run_path("chal", ("ed25519_challenge", "ed25519_semiwire"),
                   TorchWireVerifier(device="cuda", table=table), ref),
        **run_path("wire", ("ed25519_wire",), TorchWireVerifier(device="cuda"), ref),
    }
    # The device-tally path: fused on the packed verifier, two launches on
    # the challenge route. The kernel table keeps the runs above.
    run_path("packed+tally", ("ed25519_verify",), TorchBatchVerifier(device="cuda"), ref,
             tally=True)
    run_path("chal+tally", ("ed25519_challenge", "ed25519_semiwire"),
             TorchWireVerifier(device="cuda", table=table), ref, tally=True)
    run_python_host(ref)
    # Pipelined heights: settles coalesce in the device-work queue.
    run_path("packed+pipe", ("ed25519_verify",),
             TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda"), ref, pipe=True)
    run_path("chal+pipe", ("ed25519_challenge", "ed25519_semiwire"),
             TorchWireVerifier(buckets=PIPE_BUCKETS, device="cuda", table=table), ref,
             pipe=True)
    run_path("packed+tally+pipe", ("ed25519_verify",),
             TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda"), ref, tally=True,
             pipe=True)
    phase_pairs(ref)
    return launches


def phase_pairs(ref: dict, pairs: int = 3) -> None:
    """Wall of the sequential and the pipelined packed network in turns
    (sequential, pipelined, pipelined, sequential; ``pairs`` times), each
    run checked for the host digest: the two differ in launches and
    syncs, so their walls are compared only within one call."""
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    walls: dict = {False: [], True: []}
    verifiers = {False: TorchBatchVerifier(device="cuda"),
                 True: TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda")}
    for bv in verifiers.values():
        bv.warmup()
    for _ in range(pairs):
        for pipe in (False, True, True, False):
            sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                             burst=True, dedup_verify=True, small_window_host=False,
                             batch_verifier=verifiers[pipe], pipeline_heights=pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            walls[pipe].append(time.perf_counter() - t0)
            if res.commit_digest(up_to=HEIGHT) != ref["digest"]:
                raise AssertionError(f"pairs: digest differs (pipelined={pipe})")
    for pipe, label in ((False, "packed"), (True, "packed+pipe")):
        w = sorted(walls[pipe])
        q1, med, q3 = np.percentile(w, [25, 50, 75])
        print(f"pairs: {label} runs={len(w)} wall_s={[round(x, 4) for x in walls[pipe]]} "
              f"median_s={med:.4f} iqr_s={q3 - q1:.4f} heights_per_s={HEIGHT / med:.3f}",
              flush=True)


#: The deployment runs: (label, processes, replicas per process, heights,
#: seconds until an unfinished run fails, worker options).
DEPLOY_RUNS = (
    ("capstone", 2, 2, 10, 420, ("--buckets", "64", "--check-host")),
    ("full", 4, 64, 3, 300, ()),
)


def _free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_deploy(label: str, procs: int, per: int, heights: int, deadline: float,
               opts) -> None:
    """Start ``procs`` deployment workers on the card, wait for all of
    them, check them against each other, print their lines."""
    ports = _free_ports(procs)
    root = os.path.dirname(os.path.abspath(__file__))
    opts = ("--deadline", str(deadline), *opts)
    cmd = [sys.executable, "-m", "hyperdrive_tpu_torch.harness.deploy",
           *map(str, ports)]
    t0 = time.perf_counter()
    workers = [
        subprocess.Popen(cmd + [str(rank), str(per), str(heights), "card", *opts],
                         cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for rank in range(procs)
    ]
    end = t0 + deadline + 120
    outs = []
    try:
        for w in workers:
            outs.append(w.communicate(timeout=max(1.0, end - time.perf_counter()))[0])
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    wall = time.perf_counter() - t0
    fields = []
    for rank, (w, out) in enumerate(zip(workers, outs)):
        lines = out.strip().splitlines()
        if w.returncode != 0 or not lines or not lines[-1].startswith(
                f"TRANSPORT_OK rank={rank} heights={heights} "):
            raise AssertionError(f"deploy {label}: worker {rank} failed "
                                 f"({w.returncode}):\n" + "\n".join(lines[-40:]))
        for line in lines:
            if line.startswith(("DEPLOY_", "TRANSPORT_OK")):
                print(f"deploy {label}: {line}", flush=True)
        got = {}
        for line in lines:
            if line.startswith(("DEPLOY_STATS", "TRANSPORT_OK")):
                got.update(kv.split("=", 1) for kv in line.split()[1:])
        fields.append(got)
    digests = {f["digest"] for f in fields}
    if len(digests) != 1:
        raise AssertionError(f"deploy {label}: digests differ across processes: {digests}")
    for rank, f in enumerate(fields):
        if f["mode"] != "card" or int(f["consulted"]) <= 0 or int(f["grouped"]) <= 0:
            raise AssertionError(f"deploy {label}: worker {rank}: {f}")
        for k in ("ed25519_challenge", "ed25519_semiwire"):
            if int(f[f"{k}_launches"]) <= 0:
                raise AssertionError(f"deploy {label}: worker {rank} launched no {k}")
        if "--check-host" in opts and not (
                0 < int(f["flushes"]) == int(f["masks_checked"])):
            raise AssertionError(f"deploy {label}: worker {rank}: {f['masks_checked']} "
                                 f"masks held against the host for {f['flushes']} flushes")
    print(f"deploy {label}: n={procs * per} processes={procs} replicas_per_process={per} "
          f"heights={heights} phase_s={wall:.2f} digest={digests.pop()[:16]} "
          f"equal_digests=True", flush=True)


#: Rows of one flush's scatter and lanes of one flush's verify in the
#: in-process contention probe: about what a replica's flush carries at
#: n = 256 (the full run's grouped lanes over its flushes, ~100).
FLUSH_ROWS = FLUSH_LANES = 100


def _threaded_ms(threads: int, calls: int, make, call) -> list:
    """Per-thread host wall per call (ms): ``threads`` threads, each with
    its own state from ``make()`` and a CUDA stream of its own, start
    together and run ``call(state)`` ``calls`` times."""
    import threading

    states = [make() for _ in range(threads)]
    streams = [torch.cuda.Stream() for _ in range(threads)]
    torch.cuda.synchronize()
    start = threading.Barrier(threads)
    per: list = []
    errors: list = []

    def work(i):
        try:
            with torch.cuda.stream(streams[i]):
                call(states[i])
                start.wait()
                t0 = time.perf_counter()
                for _ in range(calls):
                    call(states[i])
                per.append((time.perf_counter() - t0) / calls * 1e3)
        except Exception as e:  # re-raised below
            errors.append(e)
            start.abort()

    workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if errors:
        raise errors[0]
    return per


def deploy_contention() -> None:
    """What one replica thread pays for a flush's grid call and verify
    call, alone and with 63 other threads of one process doing the same
    (each on its own grid and stream), as host wall per call: the
    deployment's in-process cost without sockets, consensus or other
    processes on the card."""
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.ops.votegrid import VoteGrid

    V, R = N_VALIDATORS, 8
    rng = np.random.default_rng(SEED + 7)
    scatter = _scatter_args(rng, 1, V, R, FLUSH_ROWS)
    ring = KeyRing.deterministic(V, namespace=b"deploy-probe")
    table = ValidatorTable(ring.signatories, device="cuda")
    digest = bytes(range(32))
    items = [(ring[i].public, digest, ring[i].sign_digest(digest))
             for i in range(FLUSH_LANES)]
    wv = TorchWireVerifier(table=table, device="cuda")
    wv.warmup()
    if not wv.verify_signatures(items).all():
        raise AssertionError("deploy contention: a valid signature was rejected")
    probes = (
        ("update_and_tally", f"n=1 V={V} R={R} rows={FLUSH_ROWS}",
         lambda: VoteGrid(1, V, r_slots=R, buckets=(256, 1024, 4096), device="cuda"),
         lambda g: g.update_and_tally(*scatter)["total"]),
        ("verify_signatures", f"grouped lanes={FLUSH_LANES} (one shared verifier)",
         lambda: wv, lambda v: v.verify_signatures(items)),
    )
    for name, shape, make, call in probes:
        alone = statistics.median(_threaded_ms(1, 20, make, call))
        crowd = _threaded_ms(64, 10, make, call)
        print(f"deploy contention: {name} {shape} threads=1 ms_per_call={alone:.3f} "
              f"threads=64 ms_per_call_median={statistics.median(crowd):.3f} "
              f"max={max(crowd):.3f} calls_per_s={64 * 1e3 / statistics.median(crowd):.0f}",
              flush=True)


def phase_deploy() -> None:
    deploy_contention()
    for run in DEPLOY_RUNS:
        run_deploy(*run)


# ------------------------------------------------ Shamir payloads, RLC, QCs

#: Config 5 (``BASELINE.json`` configs[4]) as the JAX package's bench runs
#: it (``benches/run_all.py`` ``config_5``): n = 256, k = 2f + 1 = 171,
#: 496-byte payloads, seed 1005, 20 s timeouts, burst. Signed here
#: (``sign=True, dedup_verify=True``, every settle on the batch verifier)
#: so that row 1 is on its path; the bench's 10 heights, uncut.
C5_N, C5_PAYLOAD, C5_SEED, C5_TIMEOUT, C5_HEIGHTS = 256, 496, 1005, 20.0, 10
#: Block counts of the standalone reconstruct: the bench's commit-sized
#: 16 blocks (a 496-byte payload with its 0x80 pad is 17), the bench's
#: 64-block launch, and a wide batch past the adaptive router's
#: calibration point (512 blocks).
SHAMIR_BLOCKS = (16, 64, 1024)
RLC_SIZES = (64, 256, 1024, 4096)
#: The main-path invariant (seed 1, n = 256, five heights).
MAIN_DIGEST, MAIN_STEPS = "215413db54656240", 656_640


def _solved_shares(secrets, xs, lams, rng):
    """Shares at ``xs`` of polynomials with the given secrets: every
    share but the last is random, the last solved so that the Lagrange
    sum at zero is the secret (any k points define one polynomial of
    degree k - 1). Costs k products a block, where splitting all n
    shares costs n Horner evaluations of degree k - 1 (17 s at 1,024
    blocks)."""
    from hyperdrive_tpu_torch.crypto.shamir import P

    inv_last = pow(lams[-1], P - 2, P)
    out = []
    for s in secrets:
        ys = [int.from_bytes(rng.bytes(32), "little") % P for _ in xs[:-1]]
        acc = sum(lam * y for lam, y in zip(lams, ys)) % P
        ys.append((s - acc) * inv_last % P)
        out.append(list(zip(xs, ys)))
    return out


def phase_shamir() -> None:
    """BatchReconstructor on the card at k = 171, byte-exact against the
    oracle; ms, CUDA kernels and bound of one reconstruct call; the host
    leg's time beside it; AdaptiveReconstructor's calibration record."""
    from hyperdrive_tpu_torch.crypto import shamir
    from hyperdrive_tpu_torch.ops import shamir as tshamir

    n = N_VALIDATORS
    k = 2 * (n // 3) + 1
    rng = np.random.default_rng(SEED + 5)
    xs = sorted(int(x) + 1 for x in rng.choice(n, size=k, replace=False))
    lams = shamir.lagrange_coeffs_at_zero(xs)
    recon = tshamir.BatchReconstructor(device="cuda")
    props = torch.cuda.get_device_properties(0)
    imad_s = IMAD_PER_SM_CLOCK * props.multi_processor_count * sm_clock_mhz() * 1e6
    for blocks in SHAMIR_BLOCKS:
        payload = rng.bytes(shamir.BLOCK_BYTES * blocks - 1)
        padded = payload + b"\x80"
        secrets = [int.from_bytes(padded[i:i + 31], "little")
                   for i in range(0, len(padded), 31)]
        shares = _solved_shares(secrets, xs, lams, rng)
        got = recon.reconstruct_payload_shares(shares)
        if blocks <= 64:
            want = shamir.reconstruct_payload(shares)
            oracle = "reconstruct_payload_equal=True"
        else:
            # The oracle recomputes the k weights for every block (~60 ms
            # a block at k = 171): 40 sampled blocks through it, all
            # blocks through the payload's own bytes and the host leg.
            picks = rng.choice(blocks, size=40, replace=False)
            if any(shamir.reconstruct_block(shares[b]) != secrets[b] for b in picks):
                raise AssertionError("shamir: oracle reconstruct_block != secret")
            want = payload
            oracle = "reconstruct_block_sample=40_equal=True"
        host = tshamir.AdaptiveReconstructor(recon)
        host_out = host.host_reconstruct(shares)  # weights cached from here on
        if not (got == want == payload == host_out):
            raise AssertionError(f"shamir: {blocks} blocks differ from the oracle")
        host_s = min(_host_s(lambda: host.host_reconstruct(shares)) for _ in range(3))
        wrap_s = min(_host_s(lambda: recon.reconstruct_payload_shares(shares))
                     for _ in range(3))
        y = torch.from_numpy(tshamir._limbs_of_ints(
            v for i in range(k) for v in (sh[i][1] for sh in shares))
            .reshape(k, blocks, 20)).to("cuda")
        lam_t = torch.from_numpy(tshamir._limbs_of_ints(lams)).to("cuda")
        fn = lambda: tshamir.reconstruct_kernel(y, lam_t)  # noqa: E731
        ms = time_ms(fn, 7)
        kern = _kernels_per_call(fn)
        # Bound: k x B field products and additions and B canonical
        # reductions, in the multiply instructions of the 8 x 32-bit field
        # (the unit of imad_per_signature), at the cc 9.0 rate; or the
        # shares and weights read once and the secrets written once, 32 B
        # a field element, at the memory rate; whichever is larger.
        ops_ms = (k * blocks * (MUL + ADD) + blocks * CANON) / imad_s * 1e3
        byt_ms = (k * blocks + k + blocks) * 32 / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = (ops_ms, "operations") if ops_ms >= byt_ms else (byt_ms, "bytes")
        print(f"programs: shamir reconstruct k={k} n={n} blocks={blocks} "
              f"{oracle} ms={ms:.4f} bound_ms={b_ms:.6f} bound_by={b_by} "
              f"bound_share={b_ms / ms:.5f} chunk_blocks={tshamir._chunk_blocks(k)} "
              f"cuda_kernels_per_call={kern} wrapper_s={wrap_s:.5f} "
              f"host_leg_s={host_s:.5f}", flush=True)
    adaptive = tshamir.AdaptiveReconstructor(tshamir.BatchReconstructor(device="cuda"))
    if adaptive.reconstruct_payload_shares(shares) != payload or not adaptive.calibrated:
        raise AssertionError("shamir: calibration run failed")
    r = adaptive.rates
    print(f"programs: shamir adaptive calibration blocks={len(shares)} "
          f"host_blocks_per_s={r['host_blocks_per_s']:.1f} "
          f"device_blocks_per_s={r['device_blocks_per_s']:.1f} "
          f"device_overhead_s={r['device_overhead_s']:.5f} "
          f"crossover_blocks={adaptive.crossover_blocks}", flush=True)


def _host_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _valid_items(lanes: int, rng) -> list:
    ring = _ring()
    out = []
    for i in range(lanes):
        kp = ring[i % 32]
        digest = rng.bytes(32)
        out.append((kp.public, digest, kp.sign_digest(digest)))
    return out


def _order8_item():
    """(pub, digest, sig) valid under the cofactored equation and invalid
    under the strict one: A = R = an order-8 point, s = 0 (the JAX
    package's ``tests/test_msm.py`` vector)."""
    from hyperdrive_tpu_torch.crypto import ed25519 as hed

    for seed in range(2, 50):
        p = hed.point_decompress(bytes([seed]) + bytes(31))
        if p is None:
            continue
        q = hed.scalar_mult(hed.L, p)
        o, acc = 1, q
        while not hed.point_equal(acc, hed.IDENTITY) and o <= 8:
            acc = hed.point_add(acc, q)
            o += 1
        if o == 8:
            break
    enc = hed.point_compress(q)
    for i in range(64):
        msg = b"small-order-%d" % i
        k = hed.challenge_scalar(enc, enc, msg)
        if not hed.point_equal(hed.IDENTITY, hed.point_add(q, hed.scalar_mult(k, q))):
            return enc, msg, enc + bytes(32)
    raise AssertionError("no diverging message found")


def phase_rlc() -> None:
    """TorchBatchVerifier(rlc=True) on the card: a clean batch in one
    rlc_check, a forged lane through the fallback (mask equal to the
    ladder's and the oracle's), the order-8 divergence, one MSM against
    the oracle's point sum; then ms and CUDA kernels of rlc_check beside
    the ladder's time at the same lanes."""
    from hyperdrive_tpu_torch.crypto import ed25519 as hed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda, msm
    from hyperdrive_tpu_torch.verifier import HostVerifier

    rng = np.random.default_rng(SEED + 6)
    oracle = HostVerifier()
    props = torch.cuda.get_device_properties(0)
    imad_s = IMAD_PER_SM_CLOCK * props.multi_processor_count * sm_clock_mhz() * 1e6

    # One 64-lane MSM against the oracle's sum (host points, any Z).
    pts = [hed.scalar_mult(int(rng.integers(1, 1 << 62)) * 977 + 5, hed.BASE)
           for _ in range(64)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % hed.L for _ in range(64)]
    scalars[7] = 0
    pts[9] = pts[3]
    nib = torch.tensor([[(v >> (4 * w)) & 0xF for w in range(64)] for v in scalars],
                       dtype=torch.int32, device="cuda")
    px, py, pt = (torch.from_numpy(a).to("cuda") for a in ted.pack_affine(pts))
    got = ted.affine_of(ted.msm_kernel(px, py, pt, ted._recode_signed(nib)))
    acc = hed.IDENTITY
    for p, v in zip(pts, scalars):
        acc = hed.point_add(acc, hed.scalar_mult(v, p))
    zi = pow(acc[2], hed.P - 2, hed.P)
    if got != (acc[0] * zi % hed.P, acc[1] * zi % hed.P):
        raise AssertionError("msm_kernel (64 lanes) != the oracle's point sum")
    print("programs: msm 64 lanes x 64 windows equals_oracle_sum=True", flush=True)

    for lanes in RLC_SIZES:
        bv = ted.TorchBatchVerifier(buckets=(lanes,), rlc=True, device="cuda")
        bv.warmup()
        items = _valid_items(lanes, rng)
        ed25519_cuda.reset_stats()
        if not bv.verify_signatures(items).all():
            raise AssertionError(f"rlc {lanes}: a clean batch was rejected")
        if (bv.rlc_calls, bv.rlc_fallbacks,
                ed25519_cuda.stats["ed25519_verify"].launches) != (1, 0, 0):
            raise AssertionError(f"rlc {lanes}: clean batch took {bv.rlc_calls} checks, "
                                 f"{bv.rlc_fallbacks} fallbacks")
        bad = list(items)
        j = lanes // 2
        sig = bad[j][2]
        bad[j] = (bad[j][0], bad[j][1], sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
        mask = bv.verify_signatures(bad)
        arrays, prevalid, _ = bv.host.pack(bad)
        ladder = ed25519_cuda.verify(*(torch.from_numpy(a).to("cuda") for a in arrays))
        ladder = ladder.cpu().numpy() & prevalid
        want = np.asarray(oracle.verify_signatures(bad), dtype=bool)
        sample = [j] + [int(i) for i in rng.choice(lanes, size=min(lanes, 32), replace=False)]
        if not (np.array_equal(mask, ladder[:lanes]) and np.array_equal(mask, want)
                and all(mask[i] == hed.verify(*bad[i]) for i in sample)
                and not mask[j] and int(mask.sum()) == lanes - 1):
            raise AssertionError(f"rlc {lanes}: fallback mask differs from the ladder's "
                                 f"or the oracle's")
        if (bv.rlc_calls, bv.rlc_fallbacks) != (2, 1):
            raise AssertionError(f"rlc {lanes}: the forged batch did not fall back once")
        extra = ""
        if lanes == RLC_SIZES[0]:
            batch = items[:3] + [_order8_item()]
            strict = ted.TorchBatchVerifier(buckets=(lanes,), device="cuda")
            if (strict.verify_signatures(batch).tolist() != [True, True, True, False]
                    or bv.verify_signatures(batch).tolist() != [True] * 4
                    or bv.rlc_fallbacks != 1 or hed.verify(*batch[3])):
                raise AssertionError("rlc: the order-8 vector did not show the "
                                     "cofactored divergence")
            extra = " order8_rlc_accepts=True order8_ladder_rejects=True"
        tensors = [torch.from_numpy(a).to("cuda") for a in arrays]
        m_nib, z_nib, c_nib = (torch.from_numpy(a).to("cuda") for a in ted.rlc_scalars(
            arrays[5], arrays[6], prevalid, ted.rlc_binder(items)))
        fn = lambda: ted.rlc_check(*tensors[:5], m_nib, z_nib, c_nib)  # noqa: E731
        ms = time_ms(fn, 3, warm=False)  # bv.warmup() ran it at this shape
        ladder_ms = time_ms(lambda: ed25519_cuda.verify(*tensors), 7)
        # The profiler's pass over ~10^5 kernels costs seconds: one size.
        kern = _kernels_per_call(fn) if lanes == RLC_SIZES[-1] else "-"
        G, g = msm.plan_groups(lanes)
        # Bound: the accumulation's mixed additions alone (one a lane a
        # window over 64 + 33 windows), in the multiply instructions of the
        # 8 x 32-bit field (the unit of imad_per_signature), at the cc 9.0
        # rate.
        b_ms = (msm.ED25519_FULL_WINDOWS + msm.ED25519_HALF_WINDOWS) * lanes \
            * _madd(True) / imad_s * 1e3
        print(f"programs: rlc lanes={lanes} clean_checks=1 clean_fallbacks=0 "
              f"forged_fallbacks=1 mask_equals_ladder=True mask_equals_oracle=True{extra} "
              f"rlc_check_ms={ms:.2f} ladder_ms={ladder_ms:.4f} "
              f"rlc_over_ladder={ms / ladder_ms:.1f} bound_ms={b_ms:.6f} "
              f"bound_by=operations bound_share={b_ms / ms:.6f} groups={G}x{g} "
              f"cuda_kernels_per_call={kern}", flush=True)


def _sim_run(**kw):
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    sim = Simulation(**kw)
    if hasattr(sim.batch_verifier, "warmup"):
        sim.batch_verifier.warmup()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run(max_steps=20_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ed25519_cuda.stats["ed25519_verify"].launches
    moved = {k: v.launches for k, v in ed25519_cuda.stats.items()
             if k != "ed25519_verify" and v.launches}
    if moved:
        raise AssertionError(f"other kernels launched: {moved}")
    res.assert_safety()
    return sim, res, wall, launches


def phase_config5() -> None:
    """Config 5, signed: the host run (HostVerifier, adaptive
    reconstructor), a run with BatchReconstructor pinned on the card (a
    reconstruct launch at every committed height) and one with the
    adaptive default (16-block commits on the host leg: no launch); each
    card run equal to the host run in digest, steps and every replica's
    reconstructed payloads, and row 1 launched at every vote settle."""
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.shamir import AdaptiveReconstructor, BatchReconstructor
    from hyperdrive_tpu_torch.verifier import HostVerifier

    base = dict(n=C5_N, target_height=C5_HEIGHTS, seed=C5_SEED, timeout=C5_TIMEOUT,
                sign=True, burst=True, dedup_verify=True, small_window_host=False,
                payload_bytes=C5_PAYLOAD, device="cuda")
    runs = [("host", dict(batch_verifier=HostVerifier())),
            ("pinned", dict(batch_verifier=TorchBatchVerifier(device="cuda"),
                            reconstructor=BatchReconstructor(device="cuda"))),
            ("adaptive", dict(batch_verifier=TorchBatchVerifier(device="cuda")))]
    ref = None
    for label, opts in runs:
        sim, res, wall, launches = _sim_run(**base, **opts)
        if not res.completed:
            raise AssertionError(f"config5 {label}: stalled at {res.heights}")
        got = (res.commit_digest(up_to=C5_HEIGHTS), res.steps, sim.reconstructed)
        if ref is None:
            ref = got
        elif got != ref:
            raise AssertionError(f"config5 {label}: digest, steps or payloads differ "
                                 f"from the host run")
        recon = sim.reconstructor
        if isinstance(recon, AdaptiveReconstructor):
            recon = recon.device
        committed = len(set(res.commits[0].values()))
        if label == "pinned" and not (
                recon.launches == len(sim.reconstruct_latency) == committed):
            raise AssertionError(f"config5 pinned: {recon.launches} reconstruct launches "
                                 f"for {committed} committed values")
        if label == "adaptive" and recon.launches:
            raise AssertionError("config5 adaptive: a 16-block commit went to the card")
        if label != "host" and launches < sim.vote_settles:
            raise AssertionError(f"config5 {label}: {launches} ed25519_verify launches "
                                 f"for {sim.vote_settles} vote settles")
        lat = sorted(sim.reconstruct_latency)
        blocks = -(-(C5_PAYLOAD + 1) // 31)
        print(f"config5 {label}: n={C5_N} k={sim.k} payload_bytes={C5_PAYLOAD} "
              f"blocks={blocks} heights={C5_HEIGHTS} completed={res.completed} "
              f"steps={res.steps} wall_s={wall:.2f} heights_per_s={C5_HEIGHTS / wall:.3f} "
              f"reconstructions={len(lat)} reconstruct_share={sum(lat) / wall:.4f} "
              f"reconstruct_p50_s={statistics.median(lat):.5f} "
              f"reconstruct_launches={recon.launches} ed25519_verify_launches={launches} "
              f"vote_settles={sim.vote_settles} payloads_equal_host=True "
              f"digest={got[0][:16]} matches_host=True", flush=True)


def phase_certs() -> None:
    """The main path with certificates=True: rlc=False (row 1 on every
    settle) and rlc=True (one rlc_check a settle); the main-path
    invariant, chain digests equal across replicas and to the host run's,
    every certificate re-verified and round-tripped through the codec."""
    from hyperdrive_tpu_torch.certificates import marshal_certificate, unmarshal_certificate
    from hyperdrive_tpu_torch.codec import Reader, Writer
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.verifier import HostVerifier

    base = dict(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True, burst=True,
                dedup_verify=True, small_window_host=False, certificates=True)
    _, host, _, _ = _sim_run(batch_verifier=HostVerifier(), **base)
    for rlc in (False, True):
        bv = TorchBatchVerifier(device="cuda", rlc=rlc)
        sim, res, wall, launches = _sim_run(batch_verifier=bv, **base)
        digest = res.commit_digest(up_to=HEIGHT)
        if digest[:16] != MAIN_DIGEST or res.steps != MAIN_STEPS or not res.completed:
            raise AssertionError(f"certs rlc={rlc}: digest {digest[:16]} in {res.steps} "
                                 f"steps, want {MAIN_DIGEST} in {MAIN_STEPS}")
        if len(set(res.cert_digests)) != 1 or res.cert_digests != host.cert_digests:
            raise AssertionError(f"certs rlc={rlc}: chain digests differ across replicas "
                                 f"or from the host run")
        certs = 0
        for c in sim.certifiers:
            for cert in c.certs.values():
                w = Writer()
                marshal_certificate(cert, w)
                if not c.verify(cert) or unmarshal_certificate(Reader(w.data())) != cert:
                    raise AssertionError(f"certs rlc={rlc}: a certificate failed")
                certs += 1
        if rlc and (launches or bv.rlc_fallbacks or not bv.rlc_calls):
            raise AssertionError(f"certs rlc=True: {bv.rlc_calls} checks, "
                                 f"{bv.rlc_fallbacks} fallbacks, {launches} ladder launches")
        if not rlc and launches < sim.vote_settles:
            raise AssertionError(f"certs rlc=False: {launches} ed25519_verify launches")
        print(f"certs rlc={rlc}: n={N_VALIDATORS} height={HEIGHT} steps={res.steps} "
              f"wall_s={wall:.2f} heights_per_s={HEIGHT / wall:.3f} certificates={certs} "
              f"reverified_and_roundtripped={certs} chain_digests_equal=True "
              f"chain_equals_host=True rlc_calls={bv.rlc_calls} "
              f"rlc_fallbacks={bv.rlc_fallbacks} ed25519_verify_launches={launches} "
              f"settle_passes={sim.settle_passes} digest={digest[:16]}", flush=True)


# ------------------------------------------------------ the execution layer

#: The JAX package's documented execution deployments, not cut. 65,536
#: accounts: the README "Trustless reads" ledger and the largest of
#: ``benches/proof_bench.py``'s sizes; blocks of 16,384 and 65,536 txs: the
#: smallest and largest of ``benches/exec_bench.py`` ``E2E_SIZES`` (:78),
#: with that bench's stake lane and amount cap.
EXEC_ACCOUNTS = 65_536
EXEC_PROBE_TXS = (16_384, 65_536)
EXEC_LEG_A = dict(accounts=EXEC_ACCOUNTS, txs_per_block=16_384, stake_every=4,
                  amount_cap=64)
EXEC_A_HEIGHTS = 3
#: Leg B: ``benches/exec_bench.py``'s apply ledger (4,096 accounts, :87),
#: signed, every 7th signature forged.
EXEC_LEG_B = dict(accounts=4096, txs_per_block=1024, stake_every=4, sign_txs=True,
                  bad_sig_every=7)
EXEC_B_HEIGHTS = 5
#: Leg B's commit digest as the JAX package's Simulation gives it for the
#: same call with its host verifier, fused and two-kind alike.
EXEC_B_DIGEST = "d9ddcebeaffe5645"


def exec_step_bytes(accounts: int, txs: int, branch: str) -> int:
    """Bytes one Merkleized apply step must move: the two int32 state
    arrays read and written, the [5, T] int32 columns read, and the tree
    levels at 4 B a uint32 word, written, and read too on the incremental
    branch (a full rebuild only writes them). The mix matrix is a
    splitmix function of the word index, which a kernel computes in
    registers: no bytes."""
    from hyperdrive_tpu_torch.ops import merkle

    nodes = 2 * merkle.leaf_count(accounts) - 1
    tree = nodes * merkle.NODE_WORDS * 4
    return (2 * 2 * accounts * 4 + 5 * txs * 4
            + (2 if branch == "incremental" else 1) * tree)


def phase_exec_probe() -> None:
    """One Merkleized apply step (``apply_block_chain_merkle_cols_torch``)
    on the card at 65,536 accounts for each probe block size, from the
    genesis ledger: every output (state, applied count, root, digest, every
    tree level) equal to the host reference executor stepping the same
    block; ms (CUDA events, best of five), CUDA kernels a call, the bound
    by bytes and its share."""
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor
    from hyperdrive_tpu_torch.ops import ledger
    from hyperdrive_tpu_torch.ops.rootmix import root_words

    dev = torch.device("cuda")
    for txs in EXEC_PROBE_TXS:
        cfg = ExecutionConfig(**dict(EXEC_LEG_A, txs_per_block=txs,
                                     stake_accounts=N_VALIDATORS))
        host = HostLedgerExecutor(cfg)
        state = (np.array(host.balances, np.int32), np.array(host.stakes, np.int32))
        tree, root = [lvl.copy() for lvl in host._tree], host._root_words.copy()
        cols = ledger.pack_block_cols(*host.source.block(1)._np)
        host.advance_to(1)
        args = ledger.from_reference(*state, root, tree, cols, device=dev)
        mix = ledger.mix_tensor(4 * cfg.accounts, dev)
        fn = lambda: ledger.apply_block_chain_merkle_cols_torch(  # noqa: E731
            *args[:4], 1, args[4], mix)
        bal, stk, count, new_root, digest, new_tree = fn()
        want_tree = [lvl.astype(np.int64) for lvl in host._tree]
        if not (np.array_equal(bal.cpu().numpy(), host.balances)
                and np.array_equal(stk.cpu().numpy(), host.stakes)
                and int(count) == host.applied_total
                and np.array_equal(new_root.cpu().numpy(), root_words(host.roots[1]))
                and np.array_equal(digest.cpu().numpy(), host._last_digest)
                and len(new_tree) == len(want_tree)
                and all(np.array_equal(g.cpu().numpy(), w)
                        for g, w in zip(new_tree, want_tree))):
            raise AssertionError(f"exec probe txs={txs}: the card's step differs from "
                                 f"the host executor")
        branch = "full" if 2 * cols.shape[1] >= len(tree[0]) else "incremental"
        ms = min(time_ms(fn, 1, warm=False) for _ in range(5))
        kern = _kernels_per_call(fn)
        b_ms = exec_step_bytes(cfg.accounts, cols.shape[1], branch) / HBM_BYTES_PER_S * 1e3
        print(f"programs: exec apply+merkle accounts={cfg.accounts} txs={txs} "
              f"branch={branch} applied={host.applied_total} equal_host=True ms={ms:.4f} "
              f"cuda_kernels_per_call={kern} bound_ms={b_ms:.6f} bound_by=bytes "
              f"bound_share={b_ms / ms:.5f}", flush=True)


class _ExecClock:
    """Seconds spent in the executors' ``advance_to``, ``speculate`` and
    ``resolve`` (apply, digest, tree, fold, rollback and the window's host
    copy, block synthesis included), in ``BlockSource.block``
    (synthesis) and in ``BlockSource.sig_items`` (signing the block's
    transactions), outermost calls only; and, per
    verify launcher launch, or (in a sequential run) per batch-verifier
    call, that carries a block's signature rows, the ``ed25519_verify``
    launches it made. Installed for one run."""

    def __init__(self):
        from hyperdrive_tpu_torch.devsched.queue import VerifyLauncher
        from hyperdrive_tpu_torch.exec.ledger import BlockSource, HostLedgerExecutor
        from hyperdrive_tpu_torch.ops import ed25519_cuda
        from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

        self.spent: dict = {}
        self.exec_rows = self.exec_launches = self.exec_kernels = 0
        self._lists: dict = {}
        depth: dict = {}
        in_launch = [0]
        sig_items = BlockSource.sig_items

        def register(src, blk):
            items = sig_items(src, blk)
            self._lists[id(items)] = items
            return items

        launch = VerifyLauncher.launch

        def count(rows, before):
            if rows:
                self.exec_rows += rows
                self.exec_launches += 1
                self.exec_kernels += ed25519_cuda.stats["ed25519_verify"].launches - before

        def counted(launcher, payloads):
            before = ed25519_cuda.stats["ed25519_verify"].launches
            in_launch[0] += 1
            try:
                out = launch(launcher, payloads)
            finally:
                in_launch[0] -= 1
            count(sum(len(p) for p in payloads if id(p) in self._lists), before)
            return out

        verify = TorchBatchVerifier.verify_signatures

        def verified(verifier, items):
            before = ed25519_cuda.stats["ed25519_verify"].launches
            out = verify(verifier, items)
            if not in_launch[0] and id(items) in self._lists:
                count(len(items), before)
            return out

        # The executors' entry points (DeviceLedgerExecutor inherits them).
        entry = ("advance_to", "speculate", "resolve")
        self._saved = [(cls, name, getattr(cls, name)) for cls, name in (
            *((HostLedgerExecutor, e) for e in entry), (BlockSource, "block"),
            (BlockSource, "sig_items"), (VerifyLauncher, "launch"),
            (TorchBatchVerifier, "verify_signatures"))]
        for name in entry:
            setattr(HostLedgerExecutor, name, _timed(
                self.spent, depth, "exec", getattr(HostLedgerExecutor, name)))
        BlockSource.block = _timed(self.spent, depth, "synth", BlockSource.block)
        BlockSource.sig_items = _timed(self.spent, depth, "txsign", register)
        VerifyLauncher.launch = counted
        TorchBatchVerifier.verify_signatures = verified

    def close(self) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _exec_run(label: str, **kw):
    """One n = 256 network with the execution layer on the card, timed and
    counted by an :class:`_ExecClock`; ``_sim_run`` checks safety and that
    no kernel but ``ed25519_verify`` launched."""
    clock = _ExecClock()
    try:
        sim, res, wall, launches = _sim_run(n=N_VALIDATORS, seed=1, sign=True,
                                            burst=True, device="cuda", **kw)
    finally:
        clock.close()
    if not res.completed:
        raise AssertionError(f"exec {label}: stalled at {res.heights}")
    return sim, res, wall, launches, clock


def phase_exec() -> None:
    """The execution layer on the card: the apply probe; leg A (sequential,
    a device executor a replica, 65,536 accounts, 16,384-tx blocks), every
    replica's commit record the value and the host executor's root; leg B
    (pipelined, speculative, signed: fused on the card, fused with the host
    executor, two-kind on the card), with rollbacks, no discarded root
    committed, equal commits, fewer verify launches fused, and
    ``ed25519_verify`` launched on the blocks' signature rows; leg C (leg
    B's signed blocks, sequential, a device executor a replica), the
    commits leg B's and each block verified once by ``ed25519_verify``,
    none by an executor; and a card executor without a height's
    signature verdicts refusing to verify them on the host."""
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
    from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor

    print(card_line(), flush=True)
    phase_exec_probe()

    cfg = ExecutionConfig(device=True, **EXEC_LEG_A)
    sim, res, wall, launches, clock = _exec_run(
        "A", target_height=EXEC_A_HEIGHTS, dedup_verify=True, execution=cfg,
        dedup_exec=False)
    host = HostLedgerExecutor(sim._execution)
    roots = {h: host.advance_to(h) for h in range(1, EXEC_A_HEIGHTS + 1)}
    if not (len(sim._exec_unique) == N_VALIDATORS
            and all(isinstance(ex, DeviceLedgerExecutor) for ex in sim._exec_unique)):
        raise AssertionError("exec A: not one device executor a replica")
    for i, commits in enumerate(res.commits):
        for h in range(1, EXEC_A_HEIGHTS + 1):
            v = commits.get(h)
            if v is None or len(v) != 64 or v[32:] != roots[h]:
                raise AssertionError(f"exec A: replica {i} height {h}: record is not "
                                     f"the value and the host executor's root")
    if launches < sim.vote_settles:
        raise AssertionError(f"exec A: {launches} ed25519_verify launches for "
                             f"{sim.vote_settles} vote settles")
    synth = clock.spent.get("synth", 0.0)
    apply_s = clock.spent["exec"] - synth
    print(f"exec A sequential: n={N_VALIDATORS} accounts={cfg.accounts} "
          f"txs_per_block={cfg.txs_per_block} heights={EXEC_A_HEIGHTS} "
          f"executors={len(sim._exec_unique)} applies={N_VALIDATORS * EXEC_A_HEIGHTS} "
          f"steps={res.steps} wall_s={wall:.2f} "
          f"heights_per_s={EXEC_A_HEIGHTS / wall:.3f} apply_share={apply_s / wall:.3f} "
          f"synthesis_share={synth / wall:.4f} ed25519_verify_launches={launches} "
          f"roots_equal_host=True digest={res.commit_digest(up_to=EXEC_A_HEIGHTS)[:16]}",
          flush=True)

    runs = {}
    for label, device, fused in (("device+fused", True, True), ("host+fused", False, True),
                                 ("device+two_kind", True, False)):
        cfg = ExecutionConfig(device=device, **EXEC_LEG_B)
        sim, res, wall, launches, clock = _exec_run(
            label, target_height=EXEC_B_HEIGHTS, pipeline_heights=True, execution=cfg,
            fused_exec_drain=fused)
        ex = sim._exec_unique[0]
        committed = {v[32:] for c in res.commits for v in c.values()}
        if not (ex.spec_rolled_back > 0 and ex.discarded_roots
                and not ex.discarded_roots & committed):
            raise AssertionError(f"exec B {label}: rollbacks={ex.spec_rolled_back}, "
                                 f"or a discarded root was committed")
        if not (clock.exec_launches and clock.exec_kernels):
            raise AssertionError(f"exec B {label}: no ed25519_verify launch on the "
                                 f"blocks' signature rows")
        runs[label] = (res.commits, launches)
        print(f"exec B {label}: n={N_VALIDATORS} accounts={cfg.accounts} "
              f"txs_per_block={cfg.txs_per_block} heights={EXEC_B_HEIGHTS} "
              f"steps={res.steps} wall_s={wall:.2f} heights_per_s={EXEC_B_HEIGHTS / wall:.3f} "
              f"apply_share={(clock.spent['exec'] - clock.spent['synth']) / wall:.3f} "
              f"synthesis_share={clock.spent['synth'] / wall:.4f} "
              f"tx_sign_share={clock.spent.get('txsign', 0.0) / wall:.3f} "
              f"rolled_back={ex.spec_rolled_back} confirmed={ex.spec_confirmed} "
              f"discarded_roots={len(ex.discarded_roots)} discarded_committed=0 "
              f"queue_submitted={sim._sched.submitted} queue_launches={sim._sched.launches} "
              f"ed25519_verify_launches={launches} exec_rows={clock.exec_rows} "
              f"exec_row_launches={clock.exec_launches} "
              f"exec_row_kernel_launches={clock.exec_kernels} "
              f"digest={res.commit_digest(up_to=EXEC_B_HEIGHTS)[:16]}", flush=True)
        if res.commit_digest(up_to=EXEC_B_HEIGHTS)[:16] != EXEC_B_DIGEST:
            raise AssertionError(f"exec B {label}: digest differs from the JAX package's "
                                 f"{EXEC_B_DIGEST}")
    want = runs["device+fused"][0]
    if any(r[0] != want for r in runs.values()):
        raise AssertionError("exec B: commits differ across device/host or fused/two-kind")
    if not runs["device+fused"][1] < runs["device+two_kind"][1]:
        raise AssertionError(f"exec B: fused {runs['device+fused'][1]} verify launches, "
                             f"two-kind {runs['device+two_kind'][1]}")
    print(f"exec B: commits_equal=True fused_verify_launches={runs['device+fused'][1]} "
          f"two_kind_verify_launches={runs['device+two_kind'][1]}", flush=True)

    cfg = ExecutionConfig(device=True, **EXEC_LEG_B)
    sim, res, wall, launches, clock = _exec_run(
        "C", target_height=EXEC_A_HEIGHTS, dedup_verify=True, execution=cfg,
        dedup_exec=False)
    heights = range(1, EXEC_A_HEIGHTS + 1)
    if any(c.get(h) != w[h] for c, w in zip(res.commits, want) for h in heights):
        raise AssertionError("exec C: commits differ from leg B's")
    if not (len(sim._exec_unique) == N_VALIDATORS
            and all(isinstance(ex, DeviceLedgerExecutor) and ex._verifier is None
                    for ex in sim._exec_unique)):
        raise AssertionError("exec C: not one device executor a replica, or an "
                             "executor verified a block itself")
    if not (clock.exec_launches == EXEC_A_HEIGHTS
            and clock.exec_rows == EXEC_A_HEIGHTS * cfg.txs_per_block
            and clock.exec_kernels >= EXEC_A_HEIGHTS):
        raise AssertionError(f"exec C: {clock.exec_launches} verifies of "
                             f"{clock.exec_rows} block rows ({clock.exec_kernels} "
                             f"ed25519_verify launches), not one a block on the card")
    print(f"exec C sequential signed: n={N_VALIDATORS} accounts={cfg.accounts} "
          f"txs_per_block={cfg.txs_per_block} heights={EXEC_A_HEIGHTS} "
          f"executors={len(sim._exec_unique)} steps={res.steps} wall_s={wall:.2f} "
          f"heights_per_s={EXEC_A_HEIGHTS / wall:.3f} "
          f"apply_share={(clock.spent['exec'] - clock.spent['synth']) / wall:.3f} "
          f"tx_sign_share={clock.spent.get('txsign', 0.0) / wall:.3f} "
          f"ed25519_verify_launches={launches} exec_rows={clock.exec_rows} "
          f"exec_row_verifies={clock.exec_launches} "
          f"exec_row_kernel_launches={clock.exec_kernels} commits_equal_leg_B=True",
          flush=True)
    bare = DeviceLedgerExecutor(ExecutionConfig(**EXEC_LEG_B, stake_accounts=N_VALIDATORS))
    try:
        bare.advance_to(1)
    except RuntimeError as e:
        if "no admission mask" not in str(e):
            raise
    else:
        raise AssertionError("exec: a card executor verified a signed block on the host")


# ------------------------------------------------------------ BLS12-381

#: Committee widths of the JAX package's BLS bench (``benches/bls_bench.py``
#: ``AGG_SIZES``), its odd widths and its batched launcher shape.
BLS_SIZES = (256, 1024, 4096)
BLS_ODD = (5, 255)
BLS_BATCH, BLS_BATCH_WIDTH = 8, 256
BLS_PRODUCTS = 4096
#: The certified sim: n = 16 (every certifier signs each counted partial in
#: pure Python, ~12 ms a signature on one x86 CPU core, so n = 256 would
#: take minutes a height); the n = 256 committee runs through Certifier
#: directly.
BLS_SIM = dict(n=16, target_height=5, seed=1, sign=True, burst=True, dedup_verify=True,
               small_window_host=False)
BLS_CERT_N = 256
#: Multiply instructions of a product of a 12 x 32-bit word field (2 * 12^2
#: for a * b, 2 * 12^2 for m * p, 12 for m), products a complete addition,
#: bytes a lane in (three 30-limb int32 coordinates and the mask word) and
#: a committee out.
G1_IMAD_PER_PRODUCT = 2 * 12 * 12 * 2 + 12
G1_PRODUCTS_PER_ADD = 12
G1_LANE_BYTES, G1_OUT_BYTES = 3 * 30 * 4 + 4, 3 * 30 * 4


def g1_bound_ms(selected, lanes: int, clock_mhz: float, sms: int):
    """(bound ms, bound_by) of masked sums: k - 1 complete additions for a
    committee with k selected lanes (what this run's masks need), each 12
    products, at the cc 9.0 multiply rate; or each input lane read once and
    each committee's sum written once, at the memory rate."""
    n_ops = sum(max(int(k) - 1, 0) for k in selected) * G1_PRODUCTS_PER_ADD \
        * G1_IMAD_PER_PRODUCT
    ops = n_ops / (sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6)
    byt = (lanes * G1_LANE_BYTES + len(selected) * G1_OUT_BYTES) / HBM_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= byt else (byt * 1e3, "bytes")


def derive_g1_points(n: int) -> list:
    """n distinct G1 points by a doubling/adding chain from the generator
    (``bls_bench._derive_points``)."""
    from hyperdrive_tpu_torch.crypto import bls

    pts, p = [], bls.G1_GEN
    for i in range(n):
        p = bls.g1_double(p) if i % 3 else bls.g1_add(p, bls.G1_GEN)
        pts.append(p)
    return pts


def _g1_compare(label: str, points_rows, masks: np.ndarray, timed: bool = False):
    """g1_aggregate against the plain aggregate_kernel on the card on one
    [B, N] batch: every coordinate equal after canonical (and limb for
    limb), every affine sum equal to the oracle's fold. Returns (max
    difference after canonical, kernel ms, plain ms, affine sums)."""
    from hyperdrive_tpu_torch.crypto import bls
    from hyperdrive_tpu_torch.ops import fp381 as fp
    from hyperdrive_tpu_torch.ops import g1

    coords = [np.stack([g1.pack_points(r)[c] for r in points_rows]) for c in range(3)]
    args = g1.from_reference(coords + [masks.astype(np.int32)], "cuda")
    got = g1.g1_aggregate(*args)
    p_ms = time_ms(lambda: g1.aggregate_kernel(*args), 1, warm=False, keep=(out := []))
    want = out[0]
    err = max(int((fp.canonical(a) - fp.canonical(b)).abs().max()) for a, b in zip(got, want))
    limbs_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    sums = g1.unpack_points(got[0][:, 0], got[1][:, 0], got[2][:, 0])
    folds = [bls.aggregate_signatures([p for p, m in zip(r, row) if m])
             for r, row in zip(points_rows, masks)]
    if err or sums != folds:
        raise AssertionError(f"bls {label}: kernel != plain (max {err}) or != the oracle")
    k_ms = time_ms(lambda: g1.g1_aggregate(*args), 5) if timed else None
    return err, k_ms, p_ms, sums, limbs_equal


def phase_bls(clock_mhz: float, sms: int):
    """BLS12-381 on the card: fp381.mul against Python ints; the g1_aggregate
    kernel against its plain version at the bench's widths, edge lanes, odd
    widths and the batched launcher; g1_msm_kernel against the oracle; the
    n = 256 certificate on the kernel and the host fold; the certified
    n = 16 sim, its counts zeroed before it and read after. Returns the
    kernel's rows by width and its launches on the sim."""
    from hyperdrive_tpu_torch.certificates import (
        Certifier, certificate_size, verify_bls_certificate,
    )
    from hyperdrive_tpu_torch.crypto import bls
    from hyperdrive_tpu_torch.devsched.queue import DeviceWorkQueue
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1, g1_cuda
    from hyperdrive_tpu_torch.ops import fp381 as fp
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.verifier import HostVerifier

    print(f"bls card: {card_line()}", flush=True)
    rng = np.random.default_rng(SEED + 13)

    # 1. The field product against Python ints.
    xs = [int.from_bytes(rng.bytes(48), "little") % fp.P_INT for _ in range(BLS_PRODUCTS)]
    ys = [int.from_bytes(rng.bytes(48), "little") % fp.P_INT for _ in range(BLS_PRODUCTS)]
    a, b = (fp.from_reference(fp.to_mont(v), "cuda") for v in (xs, ys))
    prod = fp.mul(a, b)
    if fp.from_mont(prod) != [x * y % fp.P_INT for x, y in zip(xs, ys)]:
        raise AssertionError("bls: fp381.mul on the card != Python ints")
    if not torch.equal(prod.cpu(), fp.mul(a.cpu(), b.cpu())):
        raise AssertionError("bls: fp381.mul on the card != on the CPU, limb for limb")
    mul_ms = time_ms(lambda: fp.mul(a, b), 5)
    mul_bound = BLS_PRODUCTS * G1_IMAD_PER_PRODUCT / (sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e3)
    print(f"programs: bls fp381.mul products={BLS_PRODUCTS} equals_python_ints=True "
          f"limbs_equal_cpu=True ms={mul_ms:.4f} bound_ms={mul_bound:.6f} "
          f"bound_by=operations bound_share={mul_bound / mul_ms:.6f} "
          f"cuda_kernels_per_call={_kernels_per_call(lambda: fp.mul(a, b))}", flush=True)

    # 2-3. The kernel against its plain version, with times and bounds.
    pts = derive_g1_points(max(*BLS_SIZES, BLS_BATCH * BLS_BATCH_WIDTH))
    rows, worst = {}, 0
    for width in BLS_SIZES:
        mask = (rng.random((1, width)) < 2 / 3).astype(np.int32)
        err, k_ms, p_ms, _, same = _g1_compare(f"{width} lanes", [pts[:width]], mask,
                                               timed=True)
        sel = [p for p, m in zip(pts[:width], mask[0]) if m]
        t0 = time.perf_counter()
        bls.aggregate_signatures(sel)
        host_s = time.perf_counter() - t0
        b_ms, b_by = g1_bound_ms(mask.sum(axis=1), width, clock_mhz, sms)
        rows[width] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "err": err}
        worst = max(worst, err)
        print(f"kernel g1_aggregate: lanes={width} selected={len(sel)} blocks=1 "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.2f} host_fold_s={host_s:.4f} "
              f"bound_ms={b_ms:.6f} bound_by={b_by} bound_share={b_ms / k_ms:.6f} "
              f"equal_after_canonical=True limbs_equal={same} equals_oracle=True",
              flush=True)
    args256 = g1.from_reference(
        [c[None] for c in g1.pack_points(pts[:256])] + [np.ones((1, 256), np.int32)], "cuda")
    print(f"programs: bls aggregate_kernel (plain) lanes=256 cuda_kernels_per_call="
          f"{_kernels_per_call(lambda: g1.aggregate_kernel(*args256))}", flush=True)

    # Edge lanes in one batch: all masked out, identity rows, P and -P, P twice.
    w = BLS_BATCH_WIDTH
    edge_rows = [pts[:w],
                 [None if i % 4 == 0 else p for i, p in enumerate(pts[:w])],
                 [bls.g1_neg(pts[i // 2]) if i % 2 else pts[i // 2] for i in range(w)],
                 [pts[i // 2] for i in range(w)]]
    edge_masks = np.ones((4, w), np.int32)
    edge_masks[0] = 0
    edge_masks[2, 5] = 0  # one unpaired lane
    err, _, _, sums, _ = _g1_compare("edges", edge_rows, edge_masks)
    worst = max(worst, err)
    if sums[0] is not None:
        raise AssertionError("bls edges: an all-masked committee is not the identity")
    for width in BLS_ODD:
        mask = (rng.random((1, width)) < 2 / 3).astype(np.int32)
        worst = max(worst, _g1_compare(f"odd {width}", [pts[:width]], mask)[0])
    # The batched launcher: 8 committees of 256 lanes, one drain, one launch.
    payloads = [pts[i::BLS_BATCH][: w - BLS_BATCH + i] for i in range(BLS_BATCH)]
    batch_masks = np.zeros((BLS_BATCH, w), np.int32)
    for i, pl in enumerate(payloads):
        batch_masks[i, : len(pl)] = 1
    padded = [pl + [None] * (w - len(pl)) for pl in payloads]
    worst = max(worst, _g1_compare("batched", padded, batch_masks)[0])
    queue = DeviceWorkQueue()
    launcher = g1.G1SumLauncher(width=w, device="cuda")
    g1_cuda.reset_stats()
    futs = [queue.submit(launcher, pl) for pl in payloads]
    queue.drain()
    got = [f.result() for f in futs]
    if (launcher.launched, g1_cuda.stats["g1_aggregate"].launches) != (1, 1) or got != [
            bls.aggregate_signatures(pl) for pl in payloads]:
        raise AssertionError("bls: G1SumLauncher did not fold 8 payloads in one launch")
    rows["edges"] = {"err": worst}
    print(f"bls edges: all_masked=identity identity_rows P_minus_P P_twice odd_widths="
          f"{','.join(map(str, BLS_ODD))} batched={BLS_BATCH}x{w} (G1SumLauncher: 1 "
          f"launch for {BLS_BATCH} payloads) equal_after_canonical=True "
          f"equals_oracle=True max_abs_err={worst}", flush=True)

    # 4. The MSM (PyTorch ops), 8 lanes, a zero scalar and an identity point.
    msm_pts = pts[:7] + [None]
    ks = [int.from_bytes(rng.bytes(32), "little") % bls.R_ORDER for _ in range(8)]
    ks[0] = 0
    mx, my, mz = g1.from_reference(g1.pack_points(msm_pts), "cuda")
    (digits,) = g1.from_reference([g1.recode_scalars(ks)], "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msum = g1.g1_msm_kernel(mx, my, mz, digits)
    torch.cuda.synchronize()
    msm_s = time.perf_counter() - t0
    acc = None
    for p, k in zip(msm_pts, ks):
        acc = bls.g1_add(acc, bls.g1_mul(p, k))
    if g1.unpack_points(*msum)[0] != acc:
        raise AssertionError("bls: g1_msm_kernel != the oracle's sum of g1_mul")
    print(f"programs: bls g1_msm_kernel lanes=8 windows={g1.G1_WINDOWS} wall_s={msm_s:.2f} "
          f"equals_oracle=True", flush=True)

    # 5. The n = 256 certificate, on the kernel and on the host fold.
    class _CachedSigner:
        # Bench set-up (benches/bls_bench.py bench_certificates): every
        # counted signer shares one of two keys and signs one message.
        def __init__(self, kp):
            self._kp, self._sigs = kp, {}
            self.pk_bytes = kp.pk_bytes

        def sign(self, msg):
            if msg not in self._sigs:
                self._sigs[msg] = self._kp.sign(msg)
            return self._sigs[msg]

    signers = [_CachedSigner(bls.bls_keypair_from_identity(b"bls-bench-%d" % i))
               for i in range(2)]
    n = BLS_CERT_N
    ids = [bytes([i & 0xFF, i >> 8]) * 16 for i in range(n)]
    keyring = {s: signers[1 - i % 2] for i, s in enumerate(ids)}
    quorum = 2 * ((n - 1) // 3) + 1
    certs = {}
    for label, fold in (("kernel", lambda parts: g1.aggregate_points(
            parts, width=n, device="cuda")), ("host", None)):
        c = Certifier(ids, (n - 1) // 3, transcript_source=lambda: b"\x5a" * 32,
                      bls_keyring=keyring, bls_aggregate_fn=fold)
        t0 = time.perf_counter()
        certs[label] = c.observe_commit(3, 0, b"block", ids[:quorum])
        certs[label + "_s"] = time.perf_counter() - t0
    cert = certs["kernel"]
    t0 = time.perf_counter()
    ok = verify_bls_certificate(cert, c.bls_pubkeys(), quorum)
    verify_s = time.perf_counter() - t0
    forged = verify_bls_certificate(dataclasses.replace(cert, height=cert.height + 1),
                                    c.bls_pubkeys(), quorum)
    if (cert.agg_sig != certs["host"].agg_sig or cert.binding != certs["host"].binding
            or not ok or forged
            or certificate_size(n, with_bls=True) != certificate_size(n) + 48):
        raise AssertionError("bls cert: kernel != host fold, or the light-client check failed")
    print(f"bls cert: n={n} quorum={quorum} agg_sig_equal_host=True "
          f"mint_kernel_s={certs['kernel_s']:.4f} mint_host_s={certs['host_s']:.4f} "
          f"light_client_verify_s={verify_s:.2f} verified=True forged_rejected=True "
          f"size_bytes={certificate_size(n, with_bls=True)} "
          f"plain_size_bytes={certificate_size(n)}", flush=True)

    # 6. The certified sim on the card against the host run.
    t0 = time.perf_counter()
    host_sim = Simulation(**BLS_SIM, batch_verifier=HostVerifier(), bls_certificates=True)
    host = host_sim.run(max_steps=20_000_000)
    host_wall = time.perf_counter() - t0
    sim = Simulation(**BLS_SIM, batch_verifier=TorchBatchVerifier(device="cuda"),
                     bls_certificates="device", device="cuda")
    spent = {"agg": 0.0, "bls": 0.0, "calls": 0}

    def timed(fn, key):
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[key] += time.perf_counter() - t
                spent["calls"] += key == "agg"
        return call

    for c in sim.certifiers:
        c._bls_aggregate_fn = timed(c._bls_aggregate_fn, "agg")
        c._bls_aggregate = timed(c._bls_aggregate, "bls")
    sim.batch_verifier.warmup()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    g1_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run(max_steps=20_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    agg_launches = g1_cuda.stats["g1_aggregate"].launches
    verify_launches = ed25519_cuda.stats["ed25519_verify"].launches
    others = {k: v.launches for k, v in ed25519_cuda.stats.items()
              if k != "ed25519_verify" and v.launches}
    res.assert_safety()
    minted = sum(len(c.certs) for c in sim.certifiers)
    heights = BLS_SIM["target_height"]
    if not res.completed or (res.commit_digest(up_to=heights), res.steps) != (
            host.commit_digest(up_to=heights), host.steps):
        raise AssertionError("bls sim: digest or steps differ from the host run")
    if len(set(res.cert_digests)) != 1 or res.cert_digests != host.cert_digests:
        raise AssertionError("bls sim: chain digests differ across replicas or from the "
                             "host fold's run")
    if others or verify_launches < sim.vote_settles or not (
            agg_launches == spent["calls"] == minted == BLS_SIM["n"] * heights):
        raise AssertionError(f"bls sim: g1_aggregate {agg_launches} launches for {minted} "
                             f"certificates, ed25519_verify {verify_launches}, others "
                             f"{others}")
    pks = sim.certifiers[0].bls_pubkeys()
    for h in range(1, heights + 1):
        cert = sim.certifiers[h % BLS_SIM["n"]].certs[h]
        if len(cert.agg_sig) != 48 or not verify_bls_certificate(cert, pks, 2 * sim.f + 1):
            raise AssertionError(f"bls sim: height {h}'s certificate fails verification")
    print(f"bls sim: n={BLS_SIM['n']} heights={heights} steps={res.steps} "
          f"wall_s={wall:.2f} heights_per_s={heights / wall:.3f} "
          f"host_run_wall_s={host_wall:.2f} certificates={minted} "
          f"g1_aggregate_launches={agg_launches} ed25519_verify_launches={verify_launches} "
          f"vote_settles={sim.vote_settles} aggregate_share={spent['agg'] / wall:.4f} "
          f"bls_share={spent['bls'] / wall:.4f} reverified_heights={heights} "
          f"chain_equals_host=True digest={res.commit_digest(up_to=heights)[:16]} "
          f"matches_host=True", flush=True)
    return rows, agg_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--python-host"]:
        return python_host_child(json.loads(sys.argv[2]))
    props = torch.cuda.get_device_properties(0)
    clock = sm_clock_mhz()
    sms = props.multi_processor_count
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    phase_card()
    phase_native()
    mark("card")
    rows = {"ed25519_verify": phase_verify_kernel(clock, sms)}
    rows["ed25519_wire"], rows["ed25519_semiwire"], state = phase_wire_kernels(clock, sms)
    base = rows["ed25519_verify"][PATH_LANES]["ms"]
    print(f"ratio: {PATH_LANES}-lane kernel time over ed25519_verify's in this run: "
          + " ".join(f"{k}={rows[k][PATH_LANES]['ms'] / base:.4f}"
                     for k in ("ed25519_wire", "ed25519_semiwire")), flush=True)
    rows["ed25519_challenge"] = phase_challenge(state, clock, sms)
    mark("kernels")
    phase_votegrid()
    mark("votegrid")
    launches = phase_main_path()
    mark("main")
    phase_deploy()
    mark("deploy")
    phase_shamir()
    mark("shamir")
    phase_rlc()
    mark("rlc")
    phase_config5()
    mark("config5")
    phase_certs()
    mark("certs")
    phase_exec()
    mark("exec")
    rows["g1_aggregate"], launches["g1_aggregate"] = phase_bls(clock, sms)
    mark("bls")
    print("phases_s: " + " ".join(f"{name}={t - marks[i][1]:.1f}"
                                  for i, (name, t) in enumerate(marks[1:]))
          + f" total={marks[-1][1] - marks[0][1]:.1f}", flush=True)
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
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
