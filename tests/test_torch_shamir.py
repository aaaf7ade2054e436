"""The PyTorch port's Shamir payload path against the JAX package's.

- the bignum oracle and the share-bundle codec: the same seeded inputs
  give the same shares, weights, payloads and bundle bytes, and every
  malformed bundle raises ``ValueError`` on both sides;
- ``reconstruct_kernel`` (PyTorch ops on the CPU) against the JAX
  ``reconstruct_kernel`` limb for limb and against the oracle, chunked
  and unchunked, with the ``k * SLACK_MAX`` guard;
- ``BatchReconstructor`` and ``AdaptiveReconstructor``: weight caches,
  routing, calibration and its refusal to route on disagreeing legs;
- the signed burst ``Simulation(payload_bytes=62)`` at n = 4 and 7
  against the JAX run with the same options: digest, steps and every
  replica's reconstructed payloads.

Field elements, bytes and digests: every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyperdrive_tpu.crypto import shamir as ref_shamir
from hyperdrive_tpu.harness import Simulation as RefSimulation
from hyperdrive_tpu.ops import fe25519 as ref_fe
from hyperdrive_tpu.ops.shamir import reconstruct_kernel as ref_reconstruct_kernel
from hyperdrive_tpu.verifier import HostVerifier as RefHostVerifier
from hyperdrive_tpu_torch.crypto import shamir
from hyperdrive_tpu_torch.harness import Simulation
from hyperdrive_tpu_torch.ops import fe25519 as fe
from hyperdrive_tpu_torch.ops import shamir as tshamir
from hyperdrive_tpu_torch.ops.shamir import AdaptiveReconstructor, BatchReconstructor
from hyperdrive_tpu_torch.verifier import HostVerifier

# The port's tests work on small tensors, where torch's intra-op threads
# only spin: one thread leaves the cores to the other test workers.
torch.set_num_threads(1)


def _rng(seed=8):
    return random.Random(seed)


# ------------------------------------------------------ oracle and codec


@pytest.mark.parametrize("k,n", [(1, 4), (3, 5), (5, 7), (11, 16)])
def test_oracle_matches_reference(k, n):
    rng = _rng(k * 100 + n)
    secret = rng.getrandbits(248)
    tag = rng.randbytes(8)
    shares = shamir.split_block(secret, k, n, tag=tag)
    assert shares == ref_shamir.split_block(secret, k, n, tag=tag)
    xs = sorted(rng.sample(range(1, n + 1), k))
    assert shamir.lagrange_coeffs_at_zero(xs) == ref_shamir.lagrange_coeffs_at_zero(xs)
    subset = [shares[x - 1] for x in xs]
    assert shamir.reconstruct_block(subset) == ref_shamir.reconstruct_block(subset) == secret


@pytest.mark.parametrize("size", [0, 1, 30, 31, 62, 100, 496])
def test_payload_and_bundle_bytes_match_reference(size):
    rng = _rng(size)
    payload = rng.randbytes(size)
    tag = b"value-%d" % size
    blocks = shamir.split_payload(payload, 3, 5, tag=tag)
    assert blocks == ref_shamir.split_payload(payload, 3, 5, tag=tag)
    bundle = shamir.encode_share_bundle(blocks)
    assert bundle == ref_shamir.encode_share_bundle(blocks)
    back = shamir.decode_share_bundle(bundle)
    assert back == ref_shamir.decode_share_bundle(bundle) == blocks
    subset = [rng.sample(b, 3) for b in back]
    assert shamir.reconstruct_payload(subset) == ref_shamir.reconstruct_payload(subset) == payload


def _malformed_bundles():
    good = shamir.encode_share_bundle(shamir.split_payload(b"xyz" * 20, 2, 3, tag=b"m"))
    big_y = bytearray(good)
    big_y[8:40] = (shamir.P).to_bytes(32, "little")  # y == p: out of range
    return {
        "empty": b"",
        "short header": good[:7],
        "truncated": good[:-1],
        "trailing byte": good + b"\x00",
        "y >= p": bytes(big_y),
        "huge blocks": (1 << 21).to_bytes(4, "little") + (1).to_bytes(4, "little"),
        "huge n": (1).to_bytes(4, "little") + (1 << 21).to_bytes(4, "little"),
        "count mismatch": (3).to_bytes(4, "little") + good[4:],
    }


@pytest.mark.parametrize("case", sorted(_malformed_bundles()))
def test_malformed_bundles_raise_value_error(case):
    data = _malformed_bundles()[case]
    with pytest.raises(ValueError):
        shamir.decode_share_bundle(data)
    with pytest.raises(ValueError):
        ref_shamir.decode_share_bundle(data)


def test_codec_and_split_refusals_match_reference():
    bad_order = [[(2, 1), (1, 2)]]
    for mod in (shamir, ref_shamir):
        with pytest.raises(ValueError):
            mod.encode_share_bundle(bad_order)
        with pytest.raises(ValueError):
            mod.split_block(shamir.P, 2, 3)
        with pytest.raises(ValueError):
            mod.split_block(1, 4, 3)
        with pytest.raises(ValueError):
            mod.unpad_payload(b"\x01\x00")


# ---------------------------------------------------- reconstruct program


def _kernel_inputs(k, blocks, seed):
    rng = _rng(seed)
    secrets = [rng.getrandbits(248) for _ in range(blocks)]
    n = k + 2
    shares = [shamir.split_block(s, k, n, tag=bytes([i])) for i, s in enumerate(secrets)]
    xs = sorted(rng.sample(range(1, n + 1), k))
    y = np.stack([fe.to_limbs([sh[x - 1][1] for sh in shares]) for x in xs])
    lams = fe.to_limbs(shamir.lagrange_coeffs_at_zero(xs))
    return secrets, xs, y, lams


def test_reconstruct_kernel_matches_reference_limb_for_limb():
    secrets, _, y, lams = _kernel_inputs(5, 4, seed=3)
    got = tshamir.reconstruct_kernel(*tshamir.from_reference(y, lams, device="cpu"))
    want = np.asarray(ref_reconstruct_kernel(jnp.asarray(y), jnp.asarray(lams)))
    assert np.array_equal(got.numpy(), want)
    assert fe.from_limbs(got) == secrets
    assert ref_fe.from_limbs(want) == secrets


def test_reconstruct_kernel_chunks_the_block_axis(monkeypatch):
    secrets, _, y, lams = _kernel_inputs(4, 9, seed=4)
    whole = tshamir.reconstruct_kernel(torch.from_numpy(y), torch.from_numpy(lams))
    # A budget of two blocks a chunk at k = 4: chunks of 2, 2, 2, 2, 1.
    monkeypatch.setattr(tshamir, "CHUNK_ELEMS", 4 * 800 * 2)
    assert tshamir._chunk_blocks(4) == 2
    chunked = tshamir.reconstruct_kernel(torch.from_numpy(y), torch.from_numpy(lams))
    assert torch.equal(whole, chunked)
    assert fe.from_limbs(chunked) == secrets
    # At config 5's k = 171 the 64 MiB budget holds 122 blocks a chunk.
    monkeypatch.undo()
    assert tshamir._chunk_blocks(171) == 122


def test_raw_sum_guard_matches_reference():
    k = (1 << 31) // fe.SLACK_MAX + 1
    assert k * fe.SLACK_MAX >= 1 << 31 > (k - 1) * fe.SLACK_MAX
    y = torch.zeros((1, 1, fe.N_LIMBS), dtype=torch.int32).expand(k, 1, fe.N_LIMBS)
    lams = torch.zeros((1, fe.N_LIMBS), dtype=torch.int32).expand(k, fe.N_LIMBS)
    with pytest.raises(ValueError, match="k too large"):
        tshamir.reconstruct_kernel(y, lams)
    with pytest.raises(ValueError, match="k too large"):
        ref_reconstruct_kernel(
            jnp.zeros((k, 1, fe.N_LIMBS), jnp.int32), jnp.zeros((k, fe.N_LIMBS), jnp.int32)
        )


def test_limb_packing_equals_to_limbs():
    rng = _rng(11)
    vals = [rng.getrandbits(255) for _ in range(40)] + [0, shamir.P - 1, (1 << 256) - 1]
    assert np.array_equal(tshamir._limbs_of_ints(vals), fe.to_limbs(vals))
    canon = [v % shamir.P for v in vals]
    assert tshamir._ints_of_limbs(fe.to_limbs(canon)) == canon


def test_batch_reconstructor_matches_oracle_and_caches_weights():
    rng = _rng(5)
    recon = BatchReconstructor(device="cpu")
    assert recon.device.type == "cpu"
    payload = rng.randbytes(200)
    blocks = shamir.split_payload(payload, 4, 7, tag=b"dev")
    idx = sorted(rng.sample(range(7), 4))
    subset = [[b[i] for i in reversed(idx)] for b in blocks]  # sorted inside
    assert recon.reconstruct_payload_shares(subset) == payload
    assert recon.reconstruct_payload_shares(subset) == shamir.reconstruct_payload(subset)
    assert recon.launches == 2 and len(recon._lam_cache) == 1
    assert recon.reconstruct_payload_shares([]) == b"" and recon.launches == 2
    mixed = [blocks[0][:4], blocks[1][1:5]]
    with pytest.raises(ValueError, match="same contributor set"):
        recon.reconstruct_payload_shares(mixed)
    secrets, xs, y, _ = _kernel_inputs(3, 6, seed=6)
    assert recon.reconstruct_blocks(xs, y_blocks=[
        [fe.from_limbs(row) for row in y[i]] for i in range(len(xs))]) == secrets
    cache: dict = {}
    for key in range(70):
        tshamir._cache_put(cache, key, key)
    assert len(cache) == 64 and min(cache) == 6


class _Leg:
    """A device leg that counts its calls and can be told to lie."""

    def __init__(self, lie=False):
        self.inner = BatchReconstructor(device="cpu")
        self.calls = 0
        self.lie = lie

    def reconstruct_payload_shares(self, shares):
        self.calls += 1
        out = self.inner.reconstruct_payload_shares(shares)
        return out + b"!" if self.lie else out


def test_adaptive_routing_calibration_and_refusal():
    rng = _rng(9)
    payload = rng.randbytes(31 * 12)
    blocks = shamir.split_payload(payload, 3, 5, tag=b"route")
    subset = [b[1:4] for b in blocks]  # 13 blocks

    leg = _Leg()
    ad = AdaptiveReconstructor(leg, crossover_blocks=20, calibrate_at=100)
    assert ad.reconstruct_payload_shares(subset) == payload and leg.calls == 0
    assert ad.host_reconstruct(subset) == shamir.reconstruct_payload(subset)
    ad.crossover_blocks = 13
    assert ad.reconstruct_payload_shares(subset) == payload and leg.calls == 1

    leg = _Leg()
    ad = AdaptiveReconstructor(leg, calibrate_at=13)
    assert ad.reconstruct_payload_shares(subset) == payload
    assert ad.calibrated and set(ad.rates) == {
        "host_blocks_per_s", "device_blocks_per_s", "device_overhead_s"}
    assert leg.calls == 8  # warm, one-block warm, 3 full, 3 one-block
    assert ad.crossover_blocks >= 1

    ad = AdaptiveReconstructor(_Leg(lie=True), calibrate_at=13)
    with pytest.raises(RuntimeError, match="disagree"):
        ad.reconstruct_payload_shares(subset)
    assert AdaptiveReconstructor(_Leg()).reconstruct_payload_shares([]) == b""


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert BatchReconstructor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchReconstructor()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tshamir.from_reference(np.zeros((1, 1, 20)), np.zeros((1, 20)))


# ------------------------------------------------------------ the network

ARGS = dict(target_height=3, sign=True, burst=True, dedup_verify=True,
            small_window_host=False, payload_bytes=62)


@pytest.mark.parametrize("n,seed,pinned,dedup",
                         [(4, 1, True, True), (7, 5, False, True), (4, 1, True, False)])
def test_payload_network_matches_reference(n, seed, pinned, dedup):
    ref = RefSimulation(n=n, seed=seed, batch_verifier=RefHostVerifier(),
                        dedup_reconstruct=dedup, **ARGS)
    want = ref.run()
    recon = BatchReconstructor(device="cpu") if pinned else None
    sim = Simulation(n=n, seed=seed, batch_verifier=HostVerifier(), device="cpu",
                     reconstructor=recon, dedup_reconstruct=dedup, **ARGS)
    got = sim.run()
    assert got.completed and want.completed
    assert got.commit_digest(up_to=3) == want.commit_digest(up_to=3)
    assert (got.steps, got.heights) == (want.steps, want.heights)
    assert sim.reconstructed == ref.reconstructed
    assert all(set(r) >= {1, 2, 3} for r in sim.reconstructed)
    assert sim.reconstructed[0][2] == sim._payload_for_value(got.commits[0][2])
    # Each reconstruction timed: one a committed value with
    # dedup_reconstruct, else one a replica a commit.
    if dedup:
        assert len(sim.reconstruct_latency) == len(set(got.commits[0].values()))
    else:
        assert len(sim.reconstruct_latency) == sum(len(r) for r in sim.reconstructed)
        assert len(sim.reconstruct_latency) == n * len(got.commits[0])
    if pinned:
        assert recon.launches == len(sim.reconstruct_latency)
    else:
        # The adaptive default keeps 3-block commits on the host leg.
        assert isinstance(sim.reconstructor, AdaptiveReconstructor)
        assert sim.reconstructor.device.launches == 0


def test_payload_validator_rejects_a_foreign_bundle_and_pipelining_refuses():
    sim = Simulation(n=4, seed=2, batch_verifier=HostVerifier(), device="cpu", **ARGS)
    bundle = sim._bundle_for_value(b"v" * 32)
    assert bundle == ref_shamir.encode_share_bundle(ref_shamir.split_payload(
        sim._payload_for_value(b"v" * 32), 3, 4, tag=b"v" * 32))
    proposer = sim.replicas[0].proc.proposer
    validator = sim.replicas[0].proc.validator
    assert proposer.payload_for_value(b"v" * 32) == bundle

    class _P:
        value = b"v" * 32
        payload = bundle

    assert validator.valid_propose(_P())
    _P.payload = bundle[:-1] + bytes([bundle[-1] ^ 1])
    assert not validator.valid_propose(_P())
    with pytest.raises(ValueError, match="sequentially"):
        Simulation(n=4, pipeline_heights=True, batch_verifier=HostVerifier(),
                   device="cpu", **ARGS)
