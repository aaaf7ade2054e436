"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line:

1. card: the card's name and power limit as nvidia-smi prints them, then
   the nvcc build of every kernel of the main path from the sources in
   this checkout;
2. kernel: the Ed25519 ladder kernel against its plain PyTorch version on
   the card, mask for mask, at the verifier's bucket sizes (64, 256, 1024,
   4096) and one 65,536-lane batch (16 launches of 4096), on mixed lanes
   made from a fixed seed; a 256-lane sample against the host oracle;
   kernel and plain times (CUDA events), the operation bound, the packer's
   time;
3. main path: the signed 256-validator burst network
   (``Simulation(n=256, sign=True, burst=True, dedup_verify=True)``) to
   height 5 with every settle verified by the kernel, checked for safety
   and against the same run with the host verifier.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260
SIZES = (64, 256, 1024, 4096)
BIG = 65_536
HEIGHT = 5
N_VALIDATORS = 256
#: INT32 multiply-adds per SM per clock on compute capability 9.0 (the
#: CUDA C++ Programming Guide's arithmetic-instruction throughput table).
IMAD_PER_SM_CLOCK = 64


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out)


def imad_per_signature() -> int:
    """32-bit multiply(-add)s of one signature's ladder under the 20 x
    13-bit limbs of ``csrc/fe25519.cuh``, counted from its structure:
    fe_mul 400 products + 23 fold multiplies, fe_sqr 210 + 23, fe_mul_small
    20 + 4, add/sub/neg 2 fold multiplies, fe_is_zero_mod_p 22.
    Per signature: the [0..8]A' table (66 mul, 8 mul_small, 68 add-like),
    64 windows of 4 doublings, one projective and one affine addition (16
    sqr, 27 mul, 6 mul_small, 42 add-like each), and the check (2 mul, 2
    sub, 2 zero tests)."""
    mul, sqr, small, addlike, zero = 423, 233, 24, 2, 22
    table = 66 * mul + 8 * small + 68 * addlike
    window = 16 * sqr + 27 * mul + 6 * small + 42 * addlike
    check = 2 * mul + 2 * addlike + 2 * zero
    return table + 64 * window + check


def bound_ms(lanes: int, clock_mhz: float, sms: int) -> float:
    rate = sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6
    return lanes * imad_per_signature() / rate * 1e3


def time_ms(fn, reps: int) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def mixed_pool(size: int, rng):
    """Signed (pub, digest, sig) items of every verdict class: valid,
    flipped s bit, wrong digest, malformed point, s >= L."""
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.crypto.keys import KeyRing

    ring = KeyRing.deterministic(32, namespace=b"chip-smoke")
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


def phase_card():
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    lib = ed25519_cuda.build(force=True)
    build_s = time.perf_counter() - t0
    log = (lib.parent / "nvcc.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: nvcc {build_s:.2f} s for {lib.name}; ptxas: {' | '.join(ptxas)}",
          flush=True)


def phase_kernel(clock_mhz: float, sms: int) -> dict:
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    rng = np.random.default_rng(SEED)
    items = mixed_pool(512, rng)
    host = ted.Ed25519BatchHost(buckets=(512,))
    t0 = time.perf_counter()
    arrays, prevalid, _ = host.pack(items[:256])
    pack_ms = (time.perf_counter() - t0) * 1e3
    pool, pool_valid, _ = host.pack(items)
    # Raw lanes outside the packer's precondition (s nibbles of s + L on a
    # valid row) and explicit all-zero lanes join the pool: the kernel
    # must match the plain version on them too.
    pool = [a.copy() for a in pool]
    for j in range(0, 512, 50):
        if pool_valid[j]:
            s = sum(int(v) << (4 * k) for k, v in enumerate(pool[5][j])) + host_ed.L
            pool[5][j] = [(s >> (4 * k)) & 0xF for k in range(64)]
    for a in pool:
        a[511] = 0

    dev = torch.device("cuda")
    sample = [torch.from_numpy(a).to(dev) for a in arrays]
    got = ed25519_cuda.verify(*sample).cpu().numpy() & prevalid
    oracle = np.array([host_ed.verify(*it) for it in items[:256]])
    if not np.array_equal(got[:256], oracle):
        raise AssertionError("kernel disagrees with the host oracle")

    rows = {}
    for size in SIZES + (BIG,):
        idx = rng.integers(0, 512, size)
        batch = [torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev) for a in pool]
        chunk = min(size, SIZES[-1])
        parts = [[t[lo:lo + chunk] for t in batch] for lo in range(0, size, chunk)]

        def kernel(parts=parts):
            return [ed25519_cuda.verify(*p) for p in parts]

        def plain(parts=parts):
            return [ted.verify_plain(*p) for p in parts]

        k_mask = torch.cat(kernel()).cpu().numpy()
        p_mask = torch.cat(plain()).cpu().numpy()
        err = int(np.abs(k_mask.astype(np.int32) - p_mask.astype(np.int32)).max())
        if err:
            bad = int((k_mask != p_mask).sum())
            raise AssertionError(f"kernel != plain on {bad} of {size} lanes")
        k_ms = time_ms(kernel, 7)
        p_ms = time_ms(plain, 3 if size < BIG else 1)
        b_ms = bound_ms(size, clock_mhz, sms)
        rows[size] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "err": err,
                      "valid": int(k_mask.sum())}
        print(f"kernel: lanes={size} launches={len(parts)} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.2f} sigs_per_s={size / k_ms * 1e3:.0f} "
              f"bound_ms={b_ms:.4f} bound_share={b_ms / k_ms:.4f} "
              f"valid_lanes={rows[size]['valid']} mismatches=0", flush=True)
    print(f"kernel: oracle sample 256 lanes agree; pack_ms(256 items)={pack_ms:.1f}",
          flush=True)
    return rows


def phase_main_path(device: str = "cuda"):
    from hyperdrive_tpu_torch.crypto.keys import KeyPair
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.verifier import HostVerifier

    sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                     burst=True, dedup_verify=True, small_window_host=False,
                     device=device)
    bv = sim.batch_verifier
    spent = {"pack": 0.0, "verify": 0.0, "sign": 0.0}
    depth = {"pack": 0, "verify": 0, "sign": 0}

    def timed(key, fn):
        # Outermost calls only: the packer calls itself on a dedup fan-out.
        def run(*args, **kwargs):
            depth[key] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[key] -= 1
                if not depth[key]:
                    spent[key] += time.perf_counter() - t0
        return run

    bv.host.pack = timed("pack", bv.host.pack)
    bv.verify_signatures = timed("verify", bv.verify_signatures)
    bv.warmup()
    torch.cuda.synchronize()

    sign = KeyPair.sign_digest
    KeyPair.sign_digest = timed("sign", sign)
    try:
        ed25519_cuda.stats.reset()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, lanes = ed25519_cuda.stats.launches, ed25519_cuda.stats.lanes
    finally:
        KeyPair.sign_digest = sign

    if not res.completed or min(res.heights) <= HEIGHT:
        raise AssertionError(f"network did not reach height {HEIGHT}: {res.heights}")
    res.assert_safety()
    t1 = time.perf_counter()
    ref = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                     burst=True, dedup_verify=True, small_window_host=False,
                     batch_verifier=HostVerifier()).run()
    host_wall = time.perf_counter() - t1
    if res.commit_digest(up_to=HEIGHT) != ref.commit_digest(up_to=HEIGHT):
        raise AssertionError("commit digest differs from the host-verifier run")
    if (res.steps, res.heights) != (ref.steps, ref.heights):
        raise AssertionError("steps or heights differ from the host-verifier run")
    if launches < sim.vote_settles or launches == 0:
        raise AssertionError(
            f"{launches} kernel launches for {sim.vote_settles} vote-bearing settles")
    print(f"main: n={N_VALIDATORS} height={HEIGHT} completed={res.completed} "
          f"steps={res.steps} wall_s={wall:.2f} heights_per_s={HEIGHT / wall:.3f} "
          f"verified_sigs={sim.verified_sigs} "
          f"verified_sigs_per_s={sim.verified_sigs / wall:.0f} "
          f"settle_passes={sim.settle_passes} vote_settles={sim.vote_settles} "
          f"kernel_launches={launches} kernel_lanes={lanes} "
          f"launches_per_height={launches / HEIGHT:.1f} "
          f"pack_share={spent['pack'] / wall:.3f} "
          f"verify_share={spent['verify'] / wall:.3f} "
          f"sign_share={spent['sign'] / wall:.3f} "
          f"host_verifier_wall_s={host_wall:.2f} "
          f"digest={res.commit_digest(up_to=HEIGHT)[:16]} matches_host=True",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    props = torch.cuda.get_device_properties(0)
    clock = sm_clock_mhz()
    phase_card()
    rows = phase_kernel(clock, props.multi_processor_count)
    launches = phase_main_path()
    path_lanes = 256  # a vote window at n=256: one lane per validator
    row = rows[path_lanes]
    print(json.dumps({"kernels": [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "hyperdrive_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "hyperdrive_tpu/ops/ed25519_pallas.py:373",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows.values()),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
