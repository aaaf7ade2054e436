"""hyperdrive_tpu_torch — the PyTorch/CUDA port of ``hyperdrive_tpu``.

The consensus automaton, replica driver and burst-mode harness run on the
host, as in the JAX package; the batchable numeric work (Ed25519 vote
verification) runs on an NVIDIA card through kernels written by hand for
Hopper (``csrc/``), each beside its plain PyTorch version, and the quorum
tallies of ``device_tally=True`` run there as PyTorch ops over a
device-resident vote grid.

- ``process``, ``mq``, ``state``, ``scheduler``, ``timer``, ``replica`` —
  the consensus automaton and its driver (copies of the JAX package's).
- ``crypto`` — host Ed25519 oracle and deterministic keys; the BLS12-381
  oracle (``crypto.bls``).
- ``ops`` — the GF(2^255-19) field (``fe25519``), the packer, plain
  ladder and batch verifier (``ed25519``), the wire path with its
  validator table and verifier (``ed25519_wire``), the device challenge
  leg (``sha512``), the CUDA kernels' build and wrappers
  (``ed25519_cuda``), the quorum count reductions (``tally``) and the
  per-replica vote grid with its fused verify + merge + tally path
  (``votegrid``); the BLS12-381 field and G1 (``limbs``, ``fp381``,
  ``g1``) and the G1 aggregation kernel (``g1_cuda``), which folds a
  quorum certificate's BLS aggregate signature.
- ``harness`` — the network simulator (lock-step and burst delivery).
- ``overlay`` — the aggregation overlay (seeded binomial tree, partial
  aggregate frames, contribution scores); ``load`` — frame
  classification (``load.frames``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version.
The package imports nothing of ``hyperdrive_tpu`` and never imports JAX.
"""

from hyperdrive_tpu_torch.types import (
    DEFAULT_HEIGHT,
    DEFAULT_ROUND,
    INVALID_ROUND,
    NIL_VALUE,
    Step,
)

__all__ = ["DEFAULT_HEIGHT", "DEFAULT_ROUND", "INVALID_ROUND", "NIL_VALUE", "Step"]
