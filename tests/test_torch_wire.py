"""The PyTorch port's wire verify path against the JAX package's.

- the wire packer (``Ed25519WireHost``) array for array against the
  reference's pure-Python packer, on every packing entry point;
- ``ValidatorTable`` arrays and index, ``from_arrays`` and
  ``from_reference``;
- the device unpacking limb for limb (``decompress_device`` is held to
  the JAX function in ``test_torch_sha512.py``, beside the other device
  program of this path, so that the two files split the CPU time);
- the plain versions of the wire and semiwire kernels (what the CUDA
  kernels are held to on the card) against the host oracle on the
  reference's adversarial decompression lanes;
- the challenge kernel's wrappers on CPU tensors (the plain legs) and
  their input checks;
- ``TorchWireVerifier`` on the CPU on each of its three routes, with the
  reference's stats formulas, and the n=4 network through it.

The JAX wire verify itself (about a minute a batch on this CPU) is not
called: the JAX suite holds its Pallas kernels equal to their XLA twins,
the twins are ``decompress_device`` then ``verify_kernel``, the port's
ladder is held to Pallas row 1 in ``test_torch_ed25519.py``, and these
files hold decompression and the packer to the JAX functions. Every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperdrive_tpu.crypto import ed25519 as ref_ed
from hyperdrive_tpu.crypto.keys import KeyRing as RefKeyRing
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.ops import ed25519_wire as ref
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.crypto.keys import KeyRing
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.messages import Prevote
from hyperdrive_tpu_torch.ops import ed25519_cuda
from hyperdrive_tpu_torch.ops import ed25519_wire as wire

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)

P = ref_ed.P
BOGUS = b"\xff" * 32  # y >= p: never decompresses


def _enc(y, sign=0):
    return int.to_bytes(y | (sign << 255), 32, "little")


def _nonresidue():
    return next(_enc(y) for y in range(2, 50)
                if ref_ed.point_decompress(_enc(y)) is None)


EDGES = {
    "identity": _enc(1),
    "zero_sign": _enc(1, 1),
    "y_zero": _enc(0),
    "y_p": _enc(P),
    "y_max": _enc((1 << 255) - 1),
    "nonres": _nonresidue(),
}


@pytest.fixture(scope="module")
def ring():
    return RefKeyRing.deterministic(8, namespace=b"torch-wire")


def _mixed(ring, n, seed, digests=None):
    """Signed items of every verdict class: valid, flipped s bit, wrong
    digest, R = s = 0xff..., s >= L, wrong lengths."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        kp = ring[i % len(ring)]
        d = (digests[i % len(digests)] if digests
             else bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        sig = kp.sign_digest(d)
        kind = i % 6
        if kind == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif kind == 2:
            sig = kp.sign_digest(bytes(32))
        elif kind == 3 and i % 12 == 3:
            sig = b"\xff" * 64
        elif kind == 4 and i % 12 == 4:
            s = int.from_bytes(sig[32:], "little") + ref_ed.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 5 and i % 12 == 5:
            sig = sig[:63]
        items.append((kp.public, d, sig))
    return items


def _tables(pubs):
    return ref.ValidatorTable(pubs), wire.ValidatorTable(pubs, device="cpu")


def _assert_same(got, want):
    """Recursive exact equality of packer outputs (tuples of arrays, None,
    ints and bools), dtypes included."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif want is None or isinstance(want, (bool, int)):
        assert got == want and type(got) is type(want)
    else:
        w = np.asarray(want)
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_array_equal(got, w)


PACKERS = ["pack_wire", "challenge_m", "challenge_no_m", "group_digests",
           "group_digests_over_cap", "index_lanes", "pack_wire_indexed"]


@pytest.mark.parametrize("method", PACKERS)
def test_wire_packer_matches_reference_array_for_array(ring, method):
    items = _mixed(ring, 40, seed=3)
    stranger = RefKeyRing.deterministic(1, namespace=b"stranger")[0].public
    ref_table, port_table = _tables([kp.public for kp in ring.pairs] + [BOGUS])
    rh = ref.Ed25519WireHost(buckets=(16, 64), use_native=False)
    ph = wire.Ed25519WireHost(buckets=(16, 64))
    if method == "pack_wire":
        items[7] = (items[7][0][:31], items[7][1], items[7][2])
        items[8] = (_enc(P), items[8][1], items[8][2])
        calls = [lambda h, t: h.pack_wire(items)]
    elif method in ("challenge_m", "challenge_no_m"):
        with_m = method == "challenge_m"
        calls = [lambda h, t: h.pack_wire_challenge(items, t, with_m=with_m),
                 lambda h, t: h.pack_wire_challenge([], t)]
    elif method == "group_digests":
        items = _mixed(ring, 40, seed=4, digests=[b"\x01" * 32, b"\x02" * 32, b"\x03" * 32])
        calls = [lambda h, t: h.group_digests(items, 64)]
    elif method == "group_digests_over_cap":
        many = [(b"", bytes([i % 256, i // 256]) * 16, b"") for i in range(300)]
        calls = [lambda h, t: h.group_digests(many, 4096),
                 lambda h, t: h.group_digests(many[:256], 256)]
    elif method == "index_lanes":
        mixed = items[:5] + [(stranger, b"\x00" * 32, b"")] + items[5:9]
        calls = [lambda h, t: h.index_lanes(items, t),
                 lambda h, t: h.index_lanes(mixed, t),
                 lambda h, t: h.index_lanes([], t)]
    else:
        calls = [lambda h, t: h.pack_wire_indexed(items, t)]
    for call in calls:
        _assert_same(call(ph, port_table), call(rh, ref_table))
    if method == "index_lanes":
        assert not ph.index_lanes(mixed, port_table)[1]
    for m in ("pack_wire_challenge", "pack_wire_indexed"):
        with pytest.raises(ValueError):
            getattr(ph, m)([(stranger, b"\x00" * 32, b"")], port_table)
    with pytest.raises(ValueError):
        ph.pack_wire_challenge([(ring[0].public, b"\x00" * 20, b"")], port_table)


def test_validator_table_matches_reference_and_round_trips(ring):
    pubs = ([kp.public for kp in ring.pairs[:4]] + [BOGUS, ring[1].public,
            P.to_bytes(32, "little"), bytes(32), b"short"])
    ref_table, port_table = _tables(pubs)
    for got, want in zip(port_table.arrays_chal(), ref_table.arrays_chal()):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port_table.index == ref_table.index and port_table.n == ref_table.n
    assert port_table.index[ring[1].public] == 1  # first occurrence wins
    assert port_table.valid.numpy().tolist() == [1, 1, 1, 1, 0, 1, 0, 1, 0]
    np.testing.assert_array_equal(port_table.rows[4].numpy(), np.frombuffer(BOGUS, np.uint8))

    again = wire.ValidatorTable.from_arrays(
        *(np.asarray(a) for a in ref_table.arrays_chal()), device="cpu")
    for got, want in zip(again.arrays_chal(), port_table.arrays_chal()):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert again.index == {k: v for k, v in ref_table.index.items() if len(k) == 32}

    items = _mixed(ring, 20, seed=5)
    rows, prevalid, _ = ref.Ed25519WireHost(buckets=(32,), use_native=False) \
        .pack_wire_indexed(items[:4], ref_table)
    tensors, valid = wire.from_reference(rows, prevalid, device="cpu")
    assert [t.dtype for t in tensors] == [torch.int32] + [torch.uint8] * 3
    for t, a in zip(tensors, rows):
        np.testing.assert_array_equal(t.numpy(), a)
    np.testing.assert_array_equal(valid.numpy(), prevalid)
    with pytest.raises(ValueError):
        port_table.upload_index(np.array([0, 9], dtype=np.int32))
    assert port_table.upload_index(np.array([8, 0], dtype=np.int32)).tolist() == [8, 0]


def _edge_rows(ring, seed):
    """Valid points of both parities, the edge encodings and random
    bytes, as [B, 32] uint8."""
    encs = []
    for kp in ring.pairs:
        x, y = ref_ed.point_decompress(kp.public)[:2]
        encs += [_enc(y, x & 1), _enc(y, (x & 1) ^ 1)]
    encs += list(EDGES.values()) + [_enc(0, 1), _enc(P - 1), _enc(P + 1)]
    rng = np.random.default_rng(seed)
    encs += [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(64 - len(encs))]
    return encs, np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32).copy()


def test_unpacking_matches_reference(ring):
    _, rows = _edge_rows(ring, seed=6)
    y, sign = wire.limbs_from_rows(torch.from_numpy(rows))
    ry, rsign = ref.limbs_from_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(rsign))
    np.testing.assert_array_equal(
        wire.nibbles_from_rows(torch.from_numpy(rows)).numpy(),
        np.asarray(ref.nibbles_from_rows(jnp.asarray(rows))))


def _adversarial(ring):
    """The reference's decompression edge cases (tests/test_ed25519_wire.py)
    as R and as A, s >= L, wrong lengths, around one valid signature."""
    kp = ring[0]
    msg = bytes(range(32))
    sig = kp.sign_digest(msg)
    s_big = sig[:32] + (int.from_bytes(sig[32:], "little") + ref_ed.L).to_bytes(32, "little")
    cases = [(kp.public, msg, sig)]
    cases += [(kp.public, msg, e + sig[32:]) for e in EDGES.values()]
    cases += [(e, msg, sig) for k, e in EDGES.items() if k != "y_max"]
    cases += [(kp.public, msg, s_big), (kp.public[:31], msg, sig),
              (kp.public, msg, sig[:63]), (ring[1].public, msg, ring[1].sign_digest(msg))]
    return cases


@pytest.mark.parametrize("kernel", ["wire", "semiwire"])
def test_plain_kernel_versions_match_host_oracle(ring, kernel):
    cases = _adversarial(ring)
    host = wire.Ed25519WireHost(buckets=(32,))
    if kernel == "wire":
        rows, prevalid, n = host.pack_wire(cases)
        ok = wire.wire_verify_plain(*(torch.from_numpy(r) for r in rows))
    else:
        bogus_sig = ring[2].sign_digest(b"\x05" * 32)
        cases.append((BOGUS, b"\x05" * 32, bogus_sig))  # invalid table slot
        table = wire.ValidatorTable(dict.fromkeys(p for p, _, _ in cases), device="cpu")
        (idx, r, s, k), prevalid, n = host.pack_wire_indexed(cases, table)
        ok = wire.semiwire_verify_plain(
            torch.from_numpy(idx), *(torch.from_numpy(a) for a in (r, s, k)),
            *table.arrays())
        assert not table.valid[table.index[BOGUS]]
    got = (ok.numpy() & prevalid)[:n]
    want = [ref_ed.verify(*c) for c in cases]
    assert got.tolist() == want
    assert want[0] and want[-1 if kernel == "wire" else -2] and sum(want) == 2


def _verifier(ring, **kw):
    table = wire.ValidatorTable([kp.public for kp in ring.pairs], device="cpu")
    return wire.TorchWireVerifier(buckets=(64,), table=table, device="cpu", **kw)


@pytest.mark.parametrize("route", ["grouped", "chal", "wire"])
def test_wire_verifier_matches_host_verifier(ring, route):
    ed25519_cuda.reset_stats()
    uniq = [b"\x07" * 32, b"\x09" * 32]
    items = _mixed(ring, 30, seed=8, digests=uniq if route == "grouped" else None)
    wv = _verifier(ring)
    if route == "chal":
        wv.host.M_GROUP_CAP = 4  # force the per-lane digest rows
    if route == "wire":
        stranger = RefKeyRing.deterministic(1, namespace=b"stranger")[0]
        items[2] = (stranger.public, items[2][1], stranger.sign_digest(items[2][1]))
        got = wv.verify_signatures_begin(items, repeats=2).mask()
        assert got.shape == (60,)
        np.testing.assert_array_equal(got[:30], got[30:])
        got = got[:30]
    else:
        got = wv.verify_signatures(items)
    want = np.asarray(RefHostVerifier().verify_signatures(items), dtype=bool)
    assert got.dtype == bool and want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    n = len(items)
    lanes = {"grouped": (n, 0, 0), "chal": (0, n, 0), "wire": (0, 0, 2 * n)}[route]
    fbytes = {"grouped": 69 * n + 32 * 2, "chal": 100 * n, "wire": 128 * n}[route]
    assert (wv.stats["lanes_grouped"], wv.stats["lanes_chal"], wv.stats["lanes_wire"]) == lanes
    assert wv.stats["format_bytes"] == fbytes
    assert wv.bytes_per_lane() == fbytes / sum(lanes)
    wv.reset_stats()
    assert wv.bytes_per_lane() == 0.0
    assert all(st.launches == 0 for st in ed25519_cuda.stats.values())


def test_challenge_legs_give_the_host_challenge(ring):
    items = _mixed(ring, 24, seed=9, digests=[b"\x0a" * 32, b"\x0b" * 32, b"\x0c" * 32])
    table = wire.ValidatorTable([kp.public for kp in ring.pairs], device="cpu")
    host = wire.Ed25519WireHost(buckets=(32,))
    (idx, r, _, k), prevalid, _ = host.pack_wire_indexed(items, table)
    (_, _, _, m), _, _ = host.pack_wire_challenge(items, table)
    m_idx, m_uniq, u = host.group_digests(items, 32)
    assert u == 3
    t = [torch.from_numpy(a) for a in (idx, r, m, m_idx, m_uniq)]
    per_lane = wire.challenge(t[0], t[1], t[2], table.rows).numpy()
    grouped = wire.challenge_grouped(t[0], t[1], t[3], t[4], table.rows).numpy()
    np.testing.assert_array_equal(per_lane[prevalid], k[prevalid])
    np.testing.assert_array_equal(grouped[prevalid], k[prevalid])
    # The kernel's wrappers on CPU tensors run these plain legs.
    np.testing.assert_array_equal(
        ed25519_cuda.challenge(t[0], t[1], t[2], table.rows).numpy(), per_lane)
    np.testing.assert_array_equal(
        ed25519_cuda.challenge_grouped(t[0], t[1], t[3], t[4], table.rows).numpy(), grouped)
    # Challenge leg then semiwire ladder, as the per-lane route runs them.
    (_, _, s, _), chal_valid, n = host.pack_wire_challenge(items, table)
    ok = wire.chalwire_verify_plain(t[0], t[1], torch.from_numpy(s), t[2],
                                    *table.arrays_chal()).numpy()
    want = [ref_ed.verify(*it) for it in items]
    assert (ok & chal_valid)[:n].tolist() == want and any(want)


def test_challenge_wrappers_check_their_inputs():
    ed25519_cuda.reset_stats()
    i4 = torch.zeros(4, dtype=torch.int32)
    z = torch.zeros((4, 32), dtype=torch.uint8)
    trows = torch.zeros((3, 32), dtype=torch.uint8)
    m_idx = torch.zeros(4, dtype=torch.uint8)
    k = ed25519_cuda.challenge(i4, z, z, trows)
    assert k.dtype == torch.uint8 and k.shape == (4, 32)
    want = ref_ed.challenge_scalar(bytes(32), bytes(32), bytes(32))
    assert bytes(k[0].numpy()) == want.to_bytes(32, "little")
    np.testing.assert_array_equal(
        ed25519_cuda.challenge_grouped(i4, z, m_idx, z[:1], trows).numpy(), k.numpy())
    with pytest.raises(TypeError):
        ed25519_cuda.challenge(i4.long(), z, z, trows)
    with pytest.raises(ValueError):
        ed25519_cuda.challenge(i4, z, z[:2], trows)
    with pytest.raises(ValueError):
        ed25519_cuda.challenge(i4, z, z, trows[:, :16])
    with pytest.raises(TypeError):
        ed25519_cuda.challenge_grouped(i4, z, m_idx.int(), z, trows)
    with pytest.raises(ValueError):
        ed25519_cuda.challenge_grouped(i4, z, m_idx, z.to("meta"), trows)
    with pytest.raises(ValueError):
        ed25519_cuda.challenge(i4, z, z, trows.to("meta"))
    assert ed25519_cuda.stats["ed25519_challenge"].launches == 0


def test_network_through_the_wire_verifier_matches_reference():
    n, target, seed = 4, 3, 99
    ring = RefKeyRing.deterministic(n, namespace=b"sim-%d" % seed)
    table = wire.ValidatorTable(ring.signatories, device="cpu")
    wv = wire.TorchWireVerifier(buckets=(64,), table=table, device="cpu")
    args = dict(n=n, target_height=target, seed=seed, sign=True, burst=True)
    sim = Simulation(batch_verifier=wv, small_window_host=False, **args)
    got = sim.run()
    want = RefSimulation(batch_verifier=RefHostVerifier(), small_window_host=False, **args).run()
    assert got.completed and want.completed
    got.assert_safety()
    assert got.commit_digest(up_to=target) == want.commit_digest(up_to=target)
    assert (got.steps, got.heights) == (want.steps, want.heights)
    # Every settle went through the grouped challenge route.
    assert wv.stats["lanes_grouped"] == sim.verified_sigs > 0
    assert wv.stats["lanes_chal"] == wv.stats["lanes_wire"] == 0
    # The default small_window_host=None routes nothing to the host: the
    # wire verifier has no fused_inner, as in the reference.
    assert Simulation(batch_verifier=wv, **args)._small_win_host is None


def test_wire_verifier_defaults_to_the_card_and_checks_its_inputs(ring):
    pubs = [kp.public for kp in ring.pairs]
    if torch.cuda.is_available():
        assert wire.TorchWireVerifier().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wire.TorchWireVerifier()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wire.ValidatorTable(pubs)
    wv = _verifier(ring)
    first = wv.table
    second = wire.ValidatorTable(pubs[:4], device="cpu")
    wv.install_table(second)
    assert wv.generation == 1 and wv.table is second
    wv.set_generation(0)
    assert wv.table is first
    wv.install_table(first, generation=5)
    with pytest.raises(KeyError):
        wv.set_generation(1)  # evicted: only generations 0 and 5 stay
    wv.set_generation(0)
    z = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        ed25519_cuda.wire_verify(z, z, z, z.long())
    with pytest.raises(ValueError):
        ed25519_cuda.wire_verify(z, z, z, z[:2])
    i4 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        ed25519_cuda.semiwire_verify(i4.long(), z, z, z, *first.arrays())
    with pytest.raises(ValueError):
        ed25519_cuda.semiwire_verify(i4, z, z, z, *second.arrays()[:3], first.valid)
    assert wv.verify_batch([]) == []


def test_verify_batch_rejects_unsigned_and_keeps_signed_verdicts():
    ring = KeyRing.deterministic(3, namespace=b"torch-wire")
    window = []
    for i in range(3):
        m = Prevote(height=1, round=0, value=b"v" * 32, sender=ring[i].public)
        window.append(m if i == 1 else ring[i].sign_message(m))
    table = wire.ValidatorTable(ring.signatories, device="cpu")
    wv = wire.TorchWireVerifier(buckets=(16,), table=table, device="cpu")
    assert wv.verify_batch(window) == [True, False, True]
