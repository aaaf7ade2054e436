"""The PyTorch port's device programs of the wire path against the JAX
package's: the two that the reference wrote in plain jnp and the port
writes as PyTorch ops.

- ``hyperdrive_tpu_torch.ops.sha512`` (int64 words, int32 limbs) against
  ``hyperdrive_tpu.ops.sha512_jax``, ``hashlib`` and the host
  ``challenge_scalar``: digests byte for byte, reduction limbs limb for
  limb, challenge scalars byte for byte;
- ``ed25519_wire.decompress_device`` against one jitted call of the JAX
  function and the host oracle, x limb for limb and ok lane for lane.

The JAX references run eagerly except ``decompress_device`` (eager it
takes longer than its jit here). Exact comparisons throughout.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.ops import ed25519_wire as ref_wire
from hyperdrive_tpu.ops import sha512_jax as ref
from hyperdrive_tpu_torch.crypto import ed25519 as port_ed
from hyperdrive_tpu_torch.ops import ed25519_wire as wire
from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops import sha512

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

L = port_ed.L
P = port_ed.P


def _rows(seed, n, w=32):
    return np.random.default_rng(seed).integers(0, 256, (n, w), dtype=np.uint8)


@pytest.mark.parametrize("width", [0, 1, 64, 96, 111])
def test_sha512_matches_hashlib(width):
    data = _rows(width, 8, width)
    got = sha512.sha512_cat((torch.from_numpy(data),)).numpy()
    assert got.dtype == np.uint8 and got.shape == (8, 64)
    for i in range(8):
        assert bytes(got[i]) == hashlib.sha512(bytes(data[i])).digest()


def test_sha512_concatenates_parts_and_refuses_two_blocks():
    r, a, m = (torch.from_numpy(_rows(s, 4)) for s in (1, 2, 3))
    got = sha512.sha512_cat((r, a, m)).numpy()
    for i in range(4):
        want = hashlib.sha512(bytes(r[i].numpy()) + bytes(a[i].numpy())
                              + bytes(m[i].numpy())).digest()
        assert bytes(got[i]) == want
    with pytest.raises(ValueError):
        sha512.sha512_cat((torch.zeros((2, 112), dtype=torch.uint8),))


def _edge_digests():
    top = ((1 << 512) - 1) // L
    vals = [0, 1, L - 1, L, L + 1, 2 * L, 2 * L - 1, (1 << 252) - 1, 1 << 252,
            (1 << 512) - 1, top * L, top * L - 1, (1 << 260) - 1, 1 << 384]
    h = np.stack([np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
                  for v in vals])
    return vals, np.concatenate([h, _rows(9, 8, 64)])


def test_sc_reduce_matches_reference_on_edge_values():
    vals, h = _edge_digests()
    limbs = sha512.limbs13_from_bytes(torch.from_numpy(h), 40)
    ref_limbs = ref.limbs13_from_bytes(jnp.asarray(h), 40)
    np.testing.assert_array_equal(limbs.numpy(), np.asarray(ref_limbs))
    k = sha512.sc_reduce_limbs(limbs)
    np.testing.assert_array_equal(k.numpy(), np.asarray(ref.sc_reduce_limbs(ref_limbs)))
    kb = sha512.bytes_from_limbs13(k)
    ref_kb = ref.bytes_from_limbs13(jnp.asarray(k.numpy()))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(ref_kb))
    for i, row in enumerate(h):
        want = int.from_bytes(bytes(row), "little") % L
        assert int.from_bytes(bytes(kb[i].numpy()), "little") == want
        if i < len(vals):
            assert want == vals[i] % L
    # 20 limbs cover 260 bits, so a 32-byte value round-trips.
    rows = _rows(4, 16)
    back = sha512.bytes_from_limbs13(sha512.limbs13_from_bytes(torch.from_numpy(rows), 20))
    np.testing.assert_array_equal(back.numpy(), rows)


def test_challenge_matches_reference_and_host():
    r, a, m = _rows(11, 64), _rows(12, 64), _rows(13, 64)
    r[:4] = 0xFF  # high bytes: the int64 words' sign bits
    got = sha512.challenge_scalar_device(
        *(torch.from_numpy(x) for x in (r, a, m))
    ).numpy()
    want = np.asarray(ref.challenge_scalar_device(
        jnp.asarray(r), jnp.asarray(a), jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    for i in range(64):
        k = ref_ed.challenge_scalar(bytes(r[i]), bytes(a[i]), bytes(m[i]))
        assert bytes(got[i]) == k.to_bytes(32, "little")


def _enc(y, sign=0):
    return int.to_bytes(y | (sign << 255), 32, "little")


def test_decompress_matches_jitted_reference_and_oracle():
    """One batch of 64 encodings: valid points of both parities, the edge
    encodings (identity, sign bit on x = 0, y = 0, y = p - 1, p, p + 1,
    2^255 - 1, a non-residue) and random bytes, raw (no prevalid mask)."""
    encs = []
    for kp in RefKeyRing.deterministic(8, namespace=b"torch-decompress").pairs:
        x, y = ref_ed.point_decompress(kp.public)[:2]
        encs += [_enc(y, x & 1), _enc(y, (x & 1) ^ 1)]
    nonres = next(_enc(y) for y in range(2, 50)
                  if ref_ed.point_decompress(_enc(y)) is None)
    encs += [_enc(1), _enc(1, 1), _enc(0), _enc(0, 1), _enc(P - 1), _enc(P),
             _enc(P + 1), _enc((1 << 255) - 1), nonres]
    encs += [bytes(r) for r in _rows(14, 64 - len(encs))]
    rows = np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32)
    y, sign = wire.limbs_from_rows(torch.from_numpy(rows.copy()))
    x, ok = wire.decompress_device(y, sign)
    rx, rok = jax.jit(ref_wire.decompress_device)(
        jnp.asarray(y.numpy()), jnp.asarray(sign.numpy()))
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    xc = fe.canonical(x)
    for i, e in enumerate(encs):
        if (int.from_bytes(e, "little") & ((1 << 255) - 1)) >= P:
            continue  # outside the packer's precondition: compared above only
        want = ref_ed.point_decompress(e)
        assert bool(ok[i]) == (want is not None), e.hex()
        if want is not None:
            assert fe.from_limbs(xc[i]) == want[0]
