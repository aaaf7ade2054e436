"""Device-side operations: the GF(2^255-19) field, batched Ed25519
verification (packer, plain ladder, batch verifier) and the CUDA kernel's
build and wrapper."""
