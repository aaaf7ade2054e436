"""The port's native host runtime against its oracle and the JAX package.

``hyperdrive_tpu_torch/native`` (``hd_native.cc`` built by g++ at first
use) must give byte-identical keys and signatures, array-identical packer
output and prevalid masks, and the same verdicts as the pure-Python oracle
of the port and as the JAX package's own Python paths, on seeded and
adversarial inputs: wrong lengths, s >= L, undecodable points, edge
encodings and a duplicate-heavy window. Every comparison is exact.
"""

import hashlib
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hyperdrive_tpu.crypto.keys import KeyPair as RefKeyPair
from hyperdrive_tpu.ops.ed25519_jax import Ed25519BatchHost as RefHost
from hyperdrive_tpu.ops.ed25519_wire import Ed25519WireHost as RefWireHost
from hyperdrive_tpu_torch import native
from hyperdrive_tpu_torch.crypto import ed25519 as ed
from hyperdrive_tpu_torch.crypto.keys import KeyPair
from hyperdrive_tpu_torch.messages import Prevote
from hyperdrive_tpu_torch.ops.ed25519 import Ed25519BatchHost
from hyperdrive_tpu_torch.ops.ed25519_wire import Ed25519WireHost
from hyperdrive_tpu_torch.verifier import HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def packer():
    """The shared native packer. A machine without g++ skips; with g++ the
    build must succeed."""
    if shutil.which(native.CXX) is None:
        pytest.skip(f"{native.CXX} is not installed")
    p = native.instance()
    assert p is not None, native.last_error()
    p.cache_clear()
    return p


def _seed(i: int) -> bytes:
    return hashlib.sha256(b"native-test-%d" % i).digest()


def _items(packer, seed: int):
    """Seeded triples of every class the packers tell apart."""
    rng = random.Random(seed)
    items = []
    for i in range(12):
        s = _seed(i)
        pub = packer.public_from_seed(s)
        digest = hashlib.sha256(b"msg-%d-%d" % (seed, i)).digest()
        items.append((pub, digest, packer.sign(s, digest, pub=pub)))
    pub, digest, sig = items[0]
    items += [
        (pub, hashlib.sha256(b"fake").digest(), sig),  # packs, fails to verify
        (pub, digest, b"\x13" * 32 + sig[32:]),  # R not a point
        (pub, digest, sig[:32] + ed.L.to_bytes(32, "little")),  # s = L
        (pub, digest, sig[:32] + (ed.L - 1).to_bytes(32, "little")),  # s < L
        (b"\xff" * 32, digest, sig),  # A with y >= p
        (ed.P.to_bytes(32, "little"), digest, sig),  # y = p
        (pub[:31], digest, sig),  # wrong lengths
        (pub, digest[:16], sig),  # a short digest packs
        (pub, digest, sig[:63]),
        (b"", b"", b""),
    ]
    items += [
        (bytes(rng.randrange(256) for _ in range(32)),
         bytes(rng.randrange(256) for _ in range(32)),
         bytes(rng.randrange(256) for _ in range(64)))
        for _ in range(12)
    ]
    return items


def test_sha512_matches_hashlib(packer):
    rng = random.Random(1)
    for n in [0, 1, 63, 64, 111, 112, 127, 128, 129, 300, 1000]:
        data = bytes(rng.randrange(256) for _ in range(n))
        assert packer.sha512(data) == hashlib.sha512(data).digest()


def test_mod_l_matches_python(packer):
    rng = random.Random(2)
    cases = [b"\x00" * 64, b"\xff" * 64]
    cases += [bytes(rng.randrange(256) for _ in range(64)) for _ in range(100)]
    for m in (1, 2, 7, 1 << 200):  # values straddling multiples of L
        for delta in (-1, 0, 1):
            cases.append(((ed.L * m + delta) % (1 << 512)).to_bytes(64, "little"))
    for data in cases:
        assert packer.mod_l(data) == int.from_bytes(data, "little") % ed.L
    with pytest.raises(ValueError, match="64 bytes"):
        packer.mod_l(b"\x00" * 63)


def test_decompress_matches_oracle(packer):
    rng = random.Random(3)
    cases = []
    for i in range(10):
        pub = ed.public_key_from_seed(_seed(i))
        cases += [pub, bytes([*pub[:31], pub[31] ^ 0x80])]
    for y in (0, 1, 2, ed.P - 1, ed.P, ed.P + 1, (1 << 255) - 1):
        for sign in (0, 1):
            cases.append((y | (sign << 255)).to_bytes(32, "little"))
    cases += [bytes(rng.randrange(256) for _ in range(32)) for _ in range(100)]
    cases += [b"", b"\x01" * 31]
    for data in cases:
        want = ed.point_decompress(data) if len(data) == 32 else None
        got = packer.decompress(data)
        assert got == (None if want is None else (want[0], want[1])), data.hex()


def _pack_three(items, buckets=(64,)):
    """(native port, Python port, JAX package Python) packer outputs."""
    cc = Ed25519BatchHost(buckets=buckets)
    assert cc._native is not None
    py = Ed25519BatchHost(buckets=buckets, use_native=False)
    ref = RefHost(buckets=buckets, use_native=False)
    return cc.pack(items), py.pack(items), ref.pack(items)


def _same_packs(*packs):
    (arrays, valid, n) = packs[0]
    for other, other_valid, other_n in packs[1:]:
        assert other_n == n
        np.testing.assert_array_equal(other_valid, valid)
        for name, x, y in zip(
            ["ax", "ay", "at", "rx", "ry", "s_nib", "k_nib"], arrays, other
        ):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_pack_into_matches_python_and_reference(packer):
    items = _items(packer, seed=4)
    packs = _pack_three(items)
    _same_packs(*packs)
    valid = packs[0][1]
    assert 0 < valid.sum() < len(items)


def test_pack_duplicate_heavy_window(packer):
    # Majority duplicates: the dedup fan-out in front of the native call
    # packs each distinct triple once and copies its rows out by index.
    base = _items(packer, seed=5)[:20]
    items = [base[i % 7] for i in range(50)]
    _same_packs(*_pack_three(items))


def test_pack_cache_is_correct_across_batches(packer):
    # The pubkey cache must not confuse distinct keys or leak staleness.
    first = _items(packer, seed=6)[:12]
    second = _items(packer, seed=7)[:12]
    for items in (first, second, first):
        _same_packs(*_pack_three(items))
    packer.cache_clear()
    _same_packs(*_pack_three(second))


def test_pack_wire_into_matches_python_and_reference(packer):
    items = _items(packer, seed=8)
    cc = Ed25519WireHost(buckets=(64,))
    assert cc._native is not None
    outs = [h.pack_wire(items) for h in (
        cc, Ed25519WireHost(buckets=(64,), use_native=False),
        RefWireHost(buckets=(64,), use_native=False),
    )]
    rows, valid, n = outs[0]
    for other, other_valid, other_n in outs[1:]:
        assert other_n == n
        np.testing.assert_array_equal(other_valid, valid)
        for x, y in zip(rows, other):
            np.testing.assert_array_equal(x, y)


def test_out_arrays_are_validated(packer):
    items = _items(packer, seed=9)[:3]
    good = [np.zeros((4, 20), np.int32) for _ in range(5)]
    nib = [np.zeros((4, 64), np.int32) for _ in range(2)]
    with pytest.raises(ValueError, match="ax"):
        packer.pack_into(items, np.zeros((2, 20), np.int32), *good[1:], *nib)
    with pytest.raises(ValueError, match="k_nib"):
        packer.pack_into(items, *good, nib[0], np.zeros((4, 64), np.int64))
    with pytest.raises(ValueError, match="s_rows"):
        packer.pack_wire_into(items, *(np.zeros((4, 32), np.uint8),) * 2,
                              np.zeros((4, 32), np.uint8)[:, ::2],
                              np.zeros((4, 32), np.uint8))
    with pytest.raises(ValueError, match="seed"):
        packer.sign(b"\x00" * 31, b"m")


def test_keys_and_signatures_match_oracle_and_reference(packer):
    rng = random.Random(11)
    for i in range(6):
        tag = b"sp%d" % i
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 80)))
        kp, ref = KeyPair.deterministic(tag), RefKeyPair.deterministic(tag)
        assert kp.public == ref.public == ed.public_key_from_seed(kp.seed)
        want = ed.sign(kp.seed, msg)
        assert kp.sign_digest(msg) == ref.sign_digest(msg) == want
        assert packer.sign(kp.seed, msg) == want  # pub derived in C


def test_verify_matches_oracle_on_forged_and_malformed(packer):
    rng = random.Random(12)
    seed = _seed(50)
    pub = ed.public_key_from_seed(seed)
    msg = b"the vote digest"
    sig = ed.sign(seed, msg)
    cases = [
        (pub, msg, sig, True),
        (pub, msg + b"!", sig, False),
        (pub, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:], False),
        (pub, msg, bytes([sig[0] ^ 1]) + sig[1:], False),
        (b"\xff" * 32, msg, sig, False),
        (pub, msg, sig[:32] + ed.L.to_bytes(32, "little"), False),
        (pub[:31], msg, sig, False),
        (pub, msg, sig[:63], False),
    ]
    for p_, m, s, want in cases:
        assert packer.verify(p_, m, s) == ed.verify(p_, m, s) == want
    for _ in range(20):
        p_ = bytes(rng.randrange(256) for _ in range(32))
        s = bytes(rng.randrange(256) for _ in range(64))
        assert packer.verify(p_, msg, s) == ed.verify(p_, msg, s)
    batch = [(p_, m, s) for p_, m, s, _ in cases]
    assert packer.verify_batch(batch).tolist() == [w for *_, w in cases]


def test_verify_batch_matches_singles(packer):
    items = _items(packer, seed=13)
    mask = packer.verify_batch(items)
    assert mask.tolist() == [ed.verify(*it) for it in items]
    assert packer.verify_batch([]).shape == (0,)


def test_host_verifier_native_and_python_agree(packer):
    kp = KeyPair.deterministic(b"hv-native")
    good = kp.sign_message(
        Prevote(height=1, round=0, value=b"\x01" * 32, sender=kp.public)
    )
    forged = Prevote(
        height=1, round=0, value=b"\x02" * 32, sender=kp.public
    ).with_signature(good.signature)
    zero = Prevote(
        height=1, round=0, value=b"\x02" * 32, sender=kp.public
    ).with_signature(b"\x00" * 64)
    short = good.with_signature(good.signature[:10])
    unsigned = Prevote(height=1, round=0, value=b"\x03" * 32, sender=kp.public)
    window = [good, forged, zero, short, unsigned]
    hv = HostVerifier()
    assert hv._native is packer
    got = hv.verify_batch(window)
    items = [(m.sender, m.digest(), m.signature) for m in window]
    got_sigs = hv.verify_signatures(items).tolist()
    hv._native = None
    assert got == hv.verify_batch(window) == [True, False, False, False, False]
    assert got_sigs == hv.verify_signatures(items)


def test_use_native_false_and_env_switch_take_python(monkeypatch):
    assert Ed25519BatchHost(use_native=False)._native is None
    assert Ed25519WireHost(use_native=False)._native is None
    # load() caches per process: a fresh one (without torch, so it starts
    # fast) shows the switch from the first load on ...
    code = (
        "import hyperdrive_tpu_torch.native as n\n"
        "from hyperdrive_tpu_torch.crypto import keys\n"
        "from hyperdrive_tpu_torch.verifier import HostVerifier\n"
        "assert not n.available() and 'HD_NO_NATIVE' in n.last_error()\n"
        "assert keys._backend() is None and HostVerifier()._native is None\n"
        "assert 'torch' not in __import__('sys').modules\n"
    )
    env = dict(os.environ, HD_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, "-W", "error", "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # ... and the packers read the same switch, here with the cache reset.
    for name, value in (("_lib", None), ("_lib_err", None), ("_packer", None),
                        ("_packer_failed", False)):
        monkeypatch.setattr(native, name, value)
    monkeypatch.setenv("HD_NO_NATIVE", "1")
    assert Ed25519BatchHost()._native is None
    assert Ed25519WireHost()._native is None
    assert native.last_error() == "disabled by HD_NO_NATIVE"
