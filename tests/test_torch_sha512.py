"""The PyTorch port's device programs of the wire path against the JAX
package's: the two that the reference wrote in plain jnp and the port
writes as PyTorch ops.

- ``hyperdrive_tpu_torch.ops.sha512`` (int64 words, int32 limbs; the
  plain version of the ``ed25519_challenge`` kernel) against
  ``hyperdrive_tpu.ops.sha512_jax``, ``hashlib`` and the host
  ``challenge_scalar``: digests byte for byte, reduction limbs limb for
  limb, challenge scalars byte for byte;
- the ``ed25519_challenge`` kernel's arithmetic, which runs only on the
  card, as a step-by-step Python model of its digest limbs and its three
  folds mod L on 32-bit limbs, against the host's ``challenge_scalar``,
  and its compiled-in SHA-512 tables against FIPS 180-4;
- ``ed25519_wire.decompress_device`` against one jitted call of the JAX
  function and the host oracle, x limb for limb and ok lane for lane.

The JAX references run eagerly except ``decompress_device`` (eager it
takes longer than its jit here). Exact comparisons throughout.
"""

import hashlib
import re

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
from hyperdrive_tpu_torch.ops import ed25519_cuda
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


# The challenge kernel's reduction (csrc/ed25519_challenge.cu, hd_sc_fold,
# hd_sc_sub_l, hd_sc_reduce) step by step on 32-bit limbs, its constants
# read from the kernel's constant block at the slots the CUDA code reads.
_M32 = 0xFFFFFFFF
_W = ed25519_cuda.W32_LIMBS
_SC_L = (4 + 3 * 9) * _W  # HD_W_SC_L: after p, 2d, d, sqrt(-1) and the B planes
_SC_DELTA, _SC_FOLD1, _SC_FOLD2, _SC_FOLD3 = (_SC_L + _W * i for i in range(1, 5))


def _limbs_value(limbs) -> int:
    return sum(v << (32 * i) for i, v in enumerate(limbs))


def _model_fold(block, x, nb, nr, top, coff):
    """hd_sc_fold<len(x), nb, nr>: r = a + c + delta * ~b."""
    r = [0] * nr
    acc = 0
    for k in range(nr):
        if k < 8:
            acc += (x[k] & 0x0FFFFFFF if k == 7 else x[k]) + block[coff + k]
        r[k] = acc & _M32
        acc >>= 32
    for i in range(nb):
        lo = x[7 + i] if 7 + i < len(x) else 0
        hi = x[8 + i] if 8 + i < len(x) else 0
        nbi = ~((lo >> 28) | (hi << 4)) & _M32 & (top if i == nb - 1 else _M32)
        carry = 0
        for j in range(4):
            t = nbi * block[_SC_DELTA + j] + r[i + j] + carry
            r[i + j], carry = t & _M32, t >> 32
        for k in range(i + 4, nr):
            t = r[k] + carry
            r[k], carry = t & _M32, t >> 32
        assert carry == 0  # the bound leaves nothing above limb nr - 1
    return r


def _model_sub_l(block, r):
    """hd_sc_sub_l: r - L unless that borrows."""
    d, borrow = [], 0
    for k in range(8):
        t = r[k] - block[_SC_L + k] + borrow
        d.append(t & _M32)
        borrow = t >> 32
    return r if borrow < 0 else d


def _model_challenge(block, digest: bytes) -> bytes:
    """The kernel from its hash value on: the big-endian words' halves
    byte-swapped into little-endian limbs, three folds (each checked
    against the bound the CUDA comments state), two subtractions of L."""
    x = []
    for i in range(8):
        h = int.from_bytes(digest[8 * i:8 * i + 8], "big")
        x += [int.from_bytes((h >> 32).to_bytes(4, "big"), "little"),
              int.from_bytes((h & _M32).to_bytes(4, "big"), "little")]
    r1 = _model_fold(block, x, 9, 13, 0xF, _SC_FOLD1)
    assert _limbs_value(r1) < 1 << 385
    r2 = _model_fold(block, r1, 5, 9, 0x1F, _SC_FOLD2)
    assert _limbs_value(r2) < 1 << 258
    k = _model_fold(block, r2, 1, 8, 0x3F, _SC_FOLD3)
    assert _limbs_value(k) < 3 * L
    k = _model_sub_l(block, _model_sub_l(block, k))
    return _limbs_value(k).to_bytes(32, "little")


def test_challenge_kernel_reduction_model_matches_host():
    block = [int(v) for v in ed25519_cuda.consts_block_w32()]
    assert _limbs_value(block[_SC_L:_SC_L + 8]) == L
    edges, h = _edge_digests()
    vals = edges + [2 * L + 1, 3 * L, (1 << 385) - 1, (1 << 258) - 1]
    vals += [int.from_bytes(bytes(row), "little") for row in h[len(edges):]]
    for v in vals:
        assert _model_challenge(block, v.to_bytes(64, "little")) == (v % L).to_bytes(32, "little")
    r, a, m = _rows(21, 48), _rows(22, 48), _rows(23, 48)
    m[0], m[1], r[2] = 0, 0xFF, 0xFF
    for i in range(48):
        pre = bytes(r[i]) + bytes(a[i]) + bytes(m[i])
        want = ref_ed.challenge_scalar(bytes(r[i]), bytes(a[i]), bytes(m[i]))
        assert _model_challenge(block, hashlib.sha512(pre).digest()) == want.to_bytes(32, "little")


def test_challenge_kernel_tables_match_fips_constants():
    src = (ed25519_cuda.CSRC / "ed25519_challenge.cu").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)ull", body)]

    assert table("hd_sha512_k") == [k % (1 << 64) for k in sha512._K]
    assert table("hd_sha512_h0") == [h % (1 << 64) for h in sha512._H0]
    assert "ed25519_challenge.cu" in ed25519_cuda.SOURCES


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
