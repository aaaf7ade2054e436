"""Device-side operations: the GF(2^255-19) field, batched Ed25519
verification on packed limbs (packer, plain ladder, batch verifier) and on
wire bytes (wire packer, validator table, decompression, plain versions,
wire verifier), the device challenge leg (SHA-512 and mod-L reduction),
the CUDA kernels' build and wrappers, the quorum count reductions
(``tally``) and the device-resident vote grid (``votegrid``); the
BLS12-381 base field and G1 (``limbs``, ``fp381``, ``g1``) with the G1
aggregation kernel's build and wrapper (``g1_cuda``)."""
