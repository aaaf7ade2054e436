// The kernel library's one translation unit. The constant block
// hd_consts_w32 (fe25519_w32.cuh) is a static __constant__, one copy per
// translation unit, so the four kernels compile together here: one build,
// one constant upload per device.
#include "ed25519_verify.cu"
#include "ed25519_wire.cu"
#include "ed25519_challenge.cu"

// Upload the constant block (layout in fe25519_w32.cuh) to `device`.
// Returns a cudaError_t. The library links its own CUDA runtime, whose
// current device is per runtime, so every entry point selects the device
// itself.
extern "C" int hd_ed25519_set_consts(int device, const uint32_t* host) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyToSymbol(hd_consts_w32, host, sizeof(uint32_t) * HD_W_TOTAL);
}
