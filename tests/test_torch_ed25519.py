"""The PyTorch port's Ed25519 batch verification against the JAX package's.

- the packer: array for array and prevalid for prevalid with the
  reference's pure-Python packer, dedup fan-out included;
- ``verify_plain`` (the CUDA kernel's plain version): the same masks as the
  Pallas kernel in interpret mode and as the host oracle; the kernel's
  in-kernel nibble recode, modelled in Python, against the plain one;
- ``TorchBatchVerifier`` on the CPU: the same verdicts as the reference's
  ``HostVerifier`` across multi-chunk, dedup and wrong-length batches;
- ``from_reference`` carries the reference packer's output over unchanged.

Verdicts are bool masks and inputs integer limbs: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.messages import Prevote
from hyperdrive_tpu.ops.ed25519_jax import Ed25519BatchHost as RefHost
from hyperdrive_tpu.ops.ed25519_pallas import verify_pallas
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.crypto import ed25519 as port_ed
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.messages import Prevote as PortPrevote
from hyperdrive_tpu_torch.ops import ed25519 as ted
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.verifier import HostVerifier

from test_ed25519_pallas import build_mixed

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)


def _items(n, seed, dup_every=0):
    """Seeded triples of every verdict class (reference signer, so item
    generation stays cheap), with wrong-length pubkeys and signatures."""
    items = build_mixed(n=n, seed=seed)
    items[1] = (items[1][0][:31], items[1][1], items[1][2])
    items[2] = (items[2][0], items[2][1], items[2][2][:63])
    if dup_every:
        items = [items[i - i % dup_every] for i in range(n)]
    return items


def _tensors(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dup_every", [0, 4])
def test_packer_matches_reference_array_for_array(dup_every):
    items = _items(96, seed=3, dup_every=dup_every)
    want, want_valid, want_n = RefHost(buckets=(64, 128), use_native=False).pack(items)
    got, got_valid, got_n = ted.Ed25519BatchHost(buckets=(64, 128)).pack(items)
    assert got_n == want_n == len(items)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_valid, want_valid)


def test_plain_ladder_matches_pallas_interpret_and_host_oracle():
    # One 64-lane interpret batch: 56 mixed lanes and 8 all-zero lanes.
    items = build_mixed(n=56, seed=7)
    arrays, prevalid, n = RefHost(buckets=(64,), use_native=False).pack(items)
    assert arrays[0].shape[0] == 64 and not prevalid[56:].any()
    pallas = np.asarray(
        verify_pallas(*(jnp.asarray(a) for a in arrays), block=64, interpret=True)
    )
    plain = ted.verify_plain(*_tensors(arrays)).numpy()
    np.testing.assert_array_equal(plain, pallas)
    oracle = np.array([ref_ed.verify(*it) for it in items])
    np.testing.assert_array_equal((plain & prevalid)[:n], oracle)
    np.testing.assert_array_equal(
        (plain & prevalid)[:n], [port_ed.verify(*it) for it in items]
    )
    assert oracle.any() and not oracle.all()


def test_plain_ladder_rejects_an_all_zero_batch():
    z20 = torch.zeros((64, 20), dtype=torch.int32)
    z64 = torch.zeros((64, 64), dtype=torch.int32)
    assert not ted.verify_plain(z20, z20, z20, z20, z20, z64, z64).any()


@pytest.mark.parametrize("case", ["multi_chunk", "dedup", "wrong_length"])
def test_batch_verifier_matches_host_verifier(case):
    if case == "multi_chunk":
        items = _items(150, seed=11)
    elif case == "dedup":
        items = _items(64, seed=12, dup_every=8)
    else:
        items = _items(20, seed=13)
        items += [(b"", b"", b""), (items[0][0], items[0][1], b"\x00" * 64)]
    bv = ted.TorchBatchVerifier(device="cpu", buckets=(64,))
    got = bv.verify_signatures(items)
    want = np.asarray(RefHostVerifier().verify_signatures(items), dtype=bool)
    assert got.dtype == bool and got.shape == (len(items),)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(HostVerifier().verify_signatures(items), want)
    assert ed25519_cuda.stats["ed25519_verify"].launches == 0  # the CPU runs the plain version


def test_verify_batch_rejects_unsigned_and_keeps_signed_verdicts():
    ring = KeyRing.deterministic(3, namespace=b"torch-test")
    ref_ring = RefKeyRing.deterministic(3, namespace=b"torch-test")
    assert ring.signatories == ref_ring.signatories
    window, ref_window = [], []
    for i in range(3):
        m = PortPrevote(height=1, round=0, value=b"v" * 32, sender=ring[i].public)
        rm = Prevote(height=1, round=0, value=b"v" * 32, sender=ref_ring[i].public)
        assert m.digest() == rm.digest()
        if i != 1:
            m, rm = ring[i].sign_message(m), ref_ring[i].sign_message(rm)
            assert m.signature == rm.signature
        window.append(m)
        ref_window.append(rm)
    bv = ted.TorchBatchVerifier(device="cpu", buckets=(64,))
    assert bv.verify_batch(window) == [True, False, True]
    assert bv.verify_batch(window) == RefHostVerifier().verify_batch(ref_window)


def test_from_reference_round_trips():
    items = build_mixed(n=40, seed=5)
    arrays, prevalid, _ = RefHost(buckets=(64,), use_native=False).pack(items)
    tensors, valid = ted.from_reference(arrays, prevalid, device="cpu")
    assert len(tensors) == 7
    for t, a in zip(tensors, arrays):
        assert t.dtype == torch.int32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)
    np.testing.assert_array_equal(valid.numpy(), prevalid)
    port_arrays, port_valid, _ = ted.Ed25519BatchHost(buckets=(64,)).pack(items)
    for t, a in zip(tensors, port_arrays):
        np.testing.assert_array_equal(t.numpy(), a)
    np.testing.assert_array_equal(valid.numpy(), port_valid)


# The four-thread schedule of csrc/ladder4.cuh in Python integers: thread j
# owns coordinate j of (X, Y, Z, T); each formula is one product a thread,
# then E, F, G, H from the four, then one product a thread again.
_P = ref_ed.P
_K2D = 2 * ref_ed.D % _P


def _round2(e, f, g, h):
    return tuple(l * r % _P for l, r in ((e, f), (g, h), (f, g), (e, h)))


def _sched_dbl(pt):
    x, y, z, _ = pt
    a, b, zz, s = (v * v % _P for v in (x, y, z, x + y))
    d = -a
    g = d + b
    return _round2(s - a - b, g - 2 * zz, g, d - b)


def _sched_add(pt, q):
    """``q``: the threads' components of the niels entry (ym, yp, 2z,
    2d t)."""
    x, y, z, t = pt
    a, b, d, c = (v * w % _P for v, w in zip((y - x, y + x, z, t), q))
    return _round2(b - a, d - c, d + c, b + a)


def _affine(pt):
    zi = pow(pt[2], _P - 2, _P)
    return pt[0] * zi % _P, pt[1] * zi % _P


def test_four_thread_schedule_matches_host_point_arithmetic():
    rng = np.random.default_rng(31)
    pts = [ref_ed.scalar_mult(int(rng.integers(1, 2**62)), ref_ed.BASE) for _ in range(3)]
    pts.append(ref_ed.IDENTITY)
    for p, q in zip(pts, pts[1:] + pts[:1]):
        qx, qy = _affine(q)
        niels = ((q[1] - q[0]) % _P, (q[1] + q[0]) % _P, 2 * q[2] % _P, _K2D * q[3] % _P)
        cases = [
            (_sched_dbl(p), ref_ed.point_double(p)),
            (_sched_add(p, niels), ref_ed.point_add(p, q)),
            # A negative digit: swap ym and yp, negate 2d t.
            (_sched_add(p, (niels[1], niels[0], niels[2], -niels[3] % _P)),
             ref_ed.point_add(p, ((-q[0]) % _P, q[1], q[2], (-q[3]) % _P))),
            # An affine entry (z = 1): thread 2 multiplies Z by 2.
            (_sched_add(p, ((qy - qx) % _P, (qy + qx) % _P, 2, _K2D * qx * qy % _P)),
             ref_ed.point_add(p, q)),
        ]
        for got, want in cases:
            assert _affine(got) == _affine(want)
            assert got[3] * got[2] % _P == got[0] * got[1] % _P  # T = XY/Z


def _model_recode_nibbles(row):
    """l4_recode_nibbles (csrc/ladder4.cuh) on one int32 nibble row: digits
    >= 8 borrow 16 and carry 1, the final carry dropped."""
    out, carry = [], 0
    for nib in row:
        d = int(nib) + carry
        carry = 1 if d >= 8 else 0
        out.append(d - 16 * carry)
    return out


def test_nibble_recode_model_matches_recode_signed():
    """The packed kernel's in-kernel recode against the plain version's, on
    the nibbles of valid scalars, of s + L (>= 2^253, outside the packer's
    precondition), of 2^256 - 1 (all 15) and of seeded random rows."""
    rng = np.random.default_rng(41)
    scalars = [int(v) for v in rng.integers(0, 2**62, 4)]
    scalars += [ref_ed.L - 1, 2 * ref_ed.L - 1, (1 << 253) + 5, (1 << 256) - 1]
    rows = [[(v >> (4 * i)) & 0xF for i in range(64)] for v in scalars]
    rows += rng.integers(0, 16, (8, 64)).tolist()
    nib = torch.tensor(rows, dtype=torch.int32)
    want = ted._recode_signed(nib).T.numpy()
    for row, w in zip(rows, want):
        digits = _model_recode_nibbles(row)
        assert digits == w.tolist()
        assert all(-8 <= d <= 7 for d in digits)
    # Dropping the final carry: the digits give scalar - 2^256 when the
    # top digit carries, the scalar itself below 2^255 - 2^251.
    for v, row in zip(scalars, rows):
        got = sum(d << (4 * i) for i, d in enumerate(_model_recode_nibbles(row)))
        assert got in (v, v - (1 << 256))


def test_wrapper_checks_inputs_and_refuses_rlc():
    z20 = torch.zeros((8, 20), dtype=torch.int32)
    z64 = torch.zeros((8, 64), dtype=torch.int32)
    assert not ed25519_cuda.verify(z20, z20, z20, z20, z20, z64, z64).any()
    with pytest.raises(TypeError):
        ed25519_cuda.verify(z20.long(), z20, z20, z20, z20, z64, z64)
    with pytest.raises(ValueError):
        ed25519_cuda.verify(z20, z20, z20, z20, z20, z64, z64[:4])
    with pytest.raises(ValueError):
        ed25519_cuda.verify(z20.t().contiguous().t(), z20, z20, z20, z20, z64, z64)
    # The RLC path is ported: rlc=True builds; a value that is neither
    # "auto" nor a bool is refused.
    assert ted.TorchBatchVerifier(device="cpu", rlc=True).rlc is True
    with pytest.raises(ValueError):
        ted.TorchBatchVerifier(device="cpu", rlc="on")
    assert ted.TorchBatchVerifier(device="cpu", rlc=False).rlc is False
