"""hyperdrive_tpu_torch — the PyTorch/CUDA port of ``hyperdrive_tpu``.

The consensus automaton, replica driver and burst-mode harness run on the
host, as in the JAX package; the batchable numeric work (Ed25519 vote
verification) runs on an NVIDIA card through kernels written by hand for
Hopper (``csrc/``), each beside its plain PyTorch version.

- ``process``, ``mq``, ``state``, ``scheduler``, ``timer``, ``replica`` —
  the consensus automaton and its driver (copies of the JAX package's).
- ``crypto`` — host Ed25519 oracle and deterministic keys.
- ``ops`` — the GF(2^255-19) field (``fe25519``), the packer, plain
  ladder and batch verifier (``ed25519``), the wire path with its
  validator table and verifier (``ed25519_wire``), the device challenge
  leg (``sha512``), and the CUDA kernels' build and wrappers
  (``ed25519_cuda``).
- ``harness`` — the burst-mode network simulator.

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
