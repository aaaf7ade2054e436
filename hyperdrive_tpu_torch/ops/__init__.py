"""Device-side operations: the GF(2^255-19) field, batched Ed25519
verification on packed limbs (packer, plain ladder, batch verifier) and on
wire bytes (wire packer, validator table, decompression, plain versions,
wire verifier), the device challenge leg (SHA-512 and mod-L reduction),
and the CUDA kernels' build and wrappers."""
