"""The PyTorch port's Ed25519 batch verification against the JAX package's.

- the packer: array for array and prevalid for prevalid with the
  reference's pure-Python packer, dedup fan-out included;
- ``verify_plain`` (the CUDA kernel's plain version): the same masks as the
  Pallas kernel in interpret mode and as the host oracle;
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
    assert ed25519_cuda.stats.launches == 0  # the CPU runs the plain version


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
    with pytest.raises(NotImplementedError):
        ted.TorchBatchVerifier(device="cpu", rlc=True)
    assert ted.TorchBatchVerifier(device="cpu").rlc is False
