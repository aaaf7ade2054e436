"""Host Ed25519 oracle and deterministic keys (copies of the JAX
package's ``crypto.ed25519`` and ``crypto.keys``)."""

from hyperdrive_tpu_torch.crypto.ed25519 import (
    point_decompress,
    sign,
    verify,
)
from hyperdrive_tpu_torch.crypto.keys import KeyPair, KeyRing

__all__ = ["KeyPair", "KeyRing", "point_decompress", "sign", "verify"]
