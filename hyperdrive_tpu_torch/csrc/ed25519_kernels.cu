// The kernel library's one translation unit. The constant block hd_consts
// (fe25519.cuh) is a static __constant__, one copy per translation unit, so
// the three verify kernels compile together here: one build, one constant
// upload per device (hd_ed25519_set_consts), one copy of the out-of-line
// field and ladder functions.
#include "ed25519_verify.cu"
#include "ed25519_wire.cu"
