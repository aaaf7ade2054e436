"""Ops kernel smokes: differential parity for the device crypto path.

Usage::

    python -m hyperdrive_tpu_torch.ops msm-parity [--n N] [--windows W]
        [--seed S] [--rlc] [--device DEV]
    python -m hyperdrive_tpu_torch.ops bls-parity [--n N] [--seed S]
        [--device DEV]

``msm-parity`` drives :func:`hyperdrive_tpu_torch.ops.ed25519.msm_kernel`
against the host curve reference (``crypto/ed25519.py``
scalar_mult/point_add) on random points and scalars: the Pippenger
bucketing, group combine, and window Horner must land on the exact affine
point the serial reference computes, or exit 1. ``--rlc`` adds the
end-to-end leg: real signatures through ``TorchBatchVerifier(rlc=True)``
(whose :func:`~hyperdrive_tpu_torch.ops.ed25519.rlc_check` drives two
MSMs, and whose ladder is row 1, ``ed25519_verify``) versus the
per-signature ladder, including a forged lane to prove the
culprit-isolation fallback masks identically.

``bls-parity`` is the same differential discipline for the BLS12-381
path: fp381 Montgomery products vs Python bigints, the G1 Pippenger MSM
and the masked aggregation tree (row 5, ``g1_aggregate``) vs the host
reference in ``crypto/bls.py`` (identity rows, zero scalars, and
masked-out lanes included), and one end-to-end k-of-k aggregate through
the host pairing with a forged-message rejection.

Both run on ``--device``: the card by default, ``cpu`` for the plain
versions; without CUDA they exit non-zero unless ``--device cpu`` is
given.

Port of the JAX package's ``ops/__main__.py``: the same subcommands,
flags and lines. Deliberate differences: the ``--device`` option; no
compilation-cache environment defaults (nothing here is jitted); the host
references are this package's ``crypto/`` copies, held in the module
attributes ``hed`` and ``bls`` so a test can swap in another oracle.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import random
import sys

import numpy as np
import torch

from hyperdrive_tpu_torch.crypto import bls
from hyperdrive_tpu_torch.crypto import ed25519 as hed
from hyperdrive_tpu_torch.utils.cli import add_device_arg, require_device

def _put(a, device) -> torch.Tensor:
    """A host int32 array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _host_affine(p):
    """Extended homogeneous (X, Y, Z, T) -> affine (x, y). The host
    curve ops keep Z != 1, so anything packed for the kernel (which
    assumes z = 1) or compared against it must normalize first."""
    x, y, z, _ = p
    zinv = pow(z, hed.P - 2, hed.P)
    return (x * zinv) % hed.P, (y * zinv) % hed.P


def _host_msm(points, scalars):
    """Serial reference: sum [s_i]P_i (affine inputs) via the host curve
    arithmetic; returns the affine sum."""
    acc = hed.IDENTITY
    for (x, y), s in zip(points, scalars):
        ext = (x, y, 1, x * y % hed.P)
        acc = hed.point_add(acc, hed.scalar_mult(s, ext))
    return _host_affine(acc)


def msm_parity(args) -> int:
    from hyperdrive_tpu_torch.ops import fe25519 as fe
    from hyperdrive_tpu_torch.ops.ed25519 import _recode_signed, msm_kernel
    from hyperdrive_tpu_torch.ops.msm import msm_plan

    dev = require_device(args.device)
    put = functools.partial(_put, device=dev)
    rng = random.Random(args.seed)
    n, windows = args.n, args.windows
    bits = 4 * windows

    points, scalars = [], []
    for _ in range(n):
        k = rng.randrange(1, hed.L)
        points.append(_host_affine(hed.scalar_mult(k, hed.BASE)))
        scalars.append(rng.randrange(0, min(1 << bits, 2**252)))

    px = put(np.stack([fe.to_limbs(p[0]) for p in points]))
    py = put(np.stack([fe.to_limbs(p[1]) for p in points]))
    pt = put(np.stack([fe.to_limbs(p[0] * p[1] % hed.P) for p in points]))
    # One extra zero nibble absorbs the signed-recode carry out of the
    # top window (same reason rlc_check runs 33 windows for 128-bit z).
    nibs = np.array(
        [
            [(s >> (4 * w)) & 0xF for w in range(windows + 1)]
            for s in scalars
        ],
        dtype=np.int32,
    )
    digits = _recode_signed(put(nibs))

    sx, sy, sz, _ = msm_kernel(px, py, pt, digits)
    zi = pow(int(fe.from_limbs(sz)[0]), hed.P - 2, hed.P)
    got = (
        int(fe.from_limbs(sx)[0]) * zi % hed.P,
        int(fe.from_limbs(sy)[0]) * zi % hed.P,
    )
    want = _host_msm(points, scalars)
    plan = msm_plan(n, windows)
    ok = got == want
    print(
        f"{'ok' if ok else 'FAIL'} msm-kernel: n={n} windows={windows} "
        f"groups={plan['groups']}x{plan['group_size']} "
        f"depth={plan['reduction_depth']} "
        f"{'matches host reference' if ok else f'{got} != {want}'}"
    )
    return 0 if ok else 1


def rlc_parity(args) -> int:
    from hyperdrive_tpu_torch.crypto.keys import KeyPair
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    dev = require_device(args.device)
    items = []
    for i in range(args.n):
        kp = KeyPair.deterministic(b"msm-parity-%d" % i)
        digest = hashlib.sha256(f"msg-{i}".encode()).digest()
        items.append((kp.public, digest, kp.sign_digest(digest)))
    # One forged lane — a WELL-FORMED signature over the wrong digest
    # (a mangled encoding would be caught by host prevalidation and
    # never reach the batch equation): the RLC combined check must fail
    # the chunk and the per-signature fallback must isolate exactly
    # this culprit.
    kp = KeyPair.deterministic(b"msm-parity-%d" % (args.n - 1))
    wrong = hashlib.sha256(b"msm-parity-forged").digest()
    items[-1] = (items[-1][0], items[-1][1], kp.sign_digest(wrong))

    buckets = (64,)
    ladder = TorchBatchVerifier(buckets=buckets, rlc=False, device=dev)
    rlc = TorchBatchVerifier(buckets=buckets, rlc=True, device=dev)
    m_ladder = np.asarray(ladder.verify_signatures(items))
    m_rlc = np.asarray(rlc.verify_signatures(items))
    ok = bool(
        (m_ladder == m_rlc).all()
        and m_ladder[:-1].all()
        and not m_ladder[-1]
        and rlc.rlc_fallbacks >= 1
        and len(rlc.last_transcript) == 32
    )
    print(
        f"{'ok' if ok else 'FAIL'} rlc-msm: n={len(items)} "
        f"masks {'==' if (m_ladder == m_rlc).all() else '!='} "
        f"fallbacks={rlc.rlc_fallbacks} "
        f"transcript={rlc.last_transcript.hex()[:16]}"
    )
    return 0 if ok else 1


def bls_parity(args) -> int:
    """Differential smoke for the BLS12-381 device path: fp381 field
    arithmetic vs Python ints, the G1 MSM and the masked aggregation tree
    vs the host reference (crypto/bls.py), and one end-to-end aggregate
    certificate check through the pairing."""
    from hyperdrive_tpu_torch.ops import fp381 as fp
    from hyperdrive_tpu_torch.ops import g1 as g1k

    dev = require_device(args.device)
    put = functools.partial(_put, device=dev)
    rng = random.Random(args.seed)
    n = args.n
    rc = 0

    # 1. Field: Montgomery mul against Python bigints, batched.
    xs = [rng.randrange(bls.P) for _ in range(n)]
    ys = [rng.randrange(bls.P) for _ in range(n)]
    got = fp.from_mont(
        fp.mul(put(np.stack([fp.to_mont(x) for x in xs])),
               put(np.stack([fp.to_mont(y) for y in ys])))
    )
    want = [x * y % bls.P for x, y in zip(xs, ys)]
    ok = list(got) == want
    print(f"{'ok' if ok else 'FAIL'} fp381-mul: {n} random products "
          f"{'match' if ok else 'MISMATCH'} Python ints")
    rc |= 0 if ok else 1

    # 2. Curve: Pippenger MSM over G1 vs serial host scalar-mults, with
    # an identity point and a zero scalar in the mix.
    scalars = [rng.randrange(bls.R_ORDER) for _ in range(n)]
    scalars[1] = 0
    points = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R_ORDER))
              for _ in range(n)]
    points[0] = None  # identity row
    px, py, pz = (put(c) for c in g1k.pack_points(points))
    digits = put(g1k.recode_scalars(scalars))
    got = g1k.unpack_points(*g1k.g1_msm_kernel(px, py, pz, digits))
    if isinstance(got, list):  # kernel keeps a leading batch dim of 1
        got = got[0]
    want = None
    for pt, s in zip(points, scalars):
        want = bls.g1_add(want, bls.g1_mul(pt, s))
    ok = got == want
    print(f"{'ok' if ok else 'FAIL'} g1-msm: n={n} windows={g1k.G1_WINDOWS} "
          f"{'matches host reference' if ok else f'{got} != {want}'}")
    rc |= 0 if ok else 1

    # 3. Aggregation tree: masked fixed-width sum vs the host fold.
    mask = [rng.random() < 0.8 for _ in range(n)]
    got = g1k.aggregate_points(
        [p if m else None for p, m in zip(points, mask)], device=dev
    )
    want = bls.aggregate_signatures(
        [p for p, m in zip(points, mask) if m and p is not None]
    )
    ok = got == want
    print(f"{'ok' if ok else 'FAIL'} g1-aggregate: width={n} "
          f"mask={sum(mask)}/{n} "
          f"{'matches host fold' if ok else f'{got} != {want}'}")
    rc |= 0 if ok else 1

    # 4. End to end: sign one commit digest under k keys, aggregate on
    # device, verify through the host pairing (the one O(pairing) step
    # a light client pays per certificate).
    k = min(n, 5)
    kps = [bls.bls_keypair_from_identity(b"bls-parity-%d" % i)
           for i in range(k)]
    msg = b"bls-parity-commit"
    agg = g1k.aggregate_points([kp.sign(msg) for kp in kps], device=dev)
    ok = bls.verify_aggregate_same_message([kp.pk for kp in kps], msg, agg)
    forged = bls.verify_aggregate_same_message(
        [kp.pk for kp in kps], b"bls-parity-forged", agg
    )
    ok = ok and not forged
    print(f"{'ok' if ok else 'FAIL'} bls-e2e: {k}-of-{k} device aggregate "
          f"{'verifies, forgery rejected' if ok else 'FAILED pairing check'}")
    rc |= 0 if ok else 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyperdrive_tpu_torch.ops")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "msm-parity",
        help="Pippenger MSM vs host curve reference differential smoke",
    )
    p.add_argument("--n", type=int, default=37)
    p.add_argument(
        "--windows", type=int, default=16,
        help="4-bit scalar windows (scalar width = 4*windows bits)",
    )
    p.add_argument("--seed", type=int, default=7)
    p.add_argument(
        "--rlc", action="store_true",
        help="also run real signatures through the RLC-MSM verifier vs "
        "the per-signature ladder",
    )
    add_device_arg(p)
    p.set_defaults(fn=msm_parity, banner="msm")

    p = sub.add_parser(
        "bls-parity",
        help="BLS12-381 device path (fp381, G1 MSM, aggregation tree) "
        "vs the host reference, plus one end-to-end pairing check",
    )
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    add_device_arg(p)
    p.set_defaults(fn=bls_parity, banner="bls")

    args = ap.parse_args(argv)
    rc = args.fn(args)
    if args.banner == "msm" and args.rlc:
        rc = rlc_parity(args) or rc
    if rc == 0:
        print(f"{args.banner} parity ok")
    else:
        print(f"{args.banner} parity FAILED", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
