// The kernel library's one translation unit. The constant blocks hd_consts
// (fe25519.cuh, read by ed25519_verify.cu) and hd_consts_w32
// (fe25519_w32.cuh, read by ed25519_wire.cu) are static __constant__s, one
// copy per translation unit, so the three verify kernels compile together
// here: one build, one constant upload per device.
#include "ed25519_verify.cu"
#include "ed25519_wire.cu"

// Upload both constant blocks (layouts in fe25519.cuh and fe25519_w32.cuh)
// to `device`. Returns a cudaError_t. The library links its own CUDA
// runtime, whose current device is per runtime, so every entry point
// selects the device itself.
extern "C" int hd_ed25519_set_consts(int device, const int32_t* host,
                                     const uint32_t* host_w32) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyToSymbol(hd_consts, host, sizeof(int32_t) * HD_C_TOTAL);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyToSymbol(hd_consts_w32, host_w32, sizeof(uint32_t) * HD_W_TOTAL);
}
