// Batched Ed25519 verification on Hopper: the port of the TPU kernel
// _verify_kernel_body / _verify_kernel_inner (hyperdrive_tpu/ops/
// ed25519_pallas.py:373/380, ladder _ladder_ok :402), on the field of
// fe25519_w32.cuh and the four-thread ladder of ladder4.cuh, as the
// semiwire kernel of ed25519_wire.cu runs them.
//
// Layout: the packer's batch-major rows go in as they are: ax, ay, at, rx,
// ry int32 [B, 20] (affine -A and R in 20 x 13-bit limbs, each limb at
// most SLACK_MAX) and s_nib, k_nib int32 [B, 64] (base-16 digits, each in
// [0, 15]). Four consecutive threads verify one signature; a block is one
// warp, 8 signatures, and there are ceil(B / 8) blocks. The four threads
// of a group read the group's five limb rows together (912 B a lane with
// the nibble rows) and convert them to the 8 x 32-bit field by value;
// threads 0 and 1 recode s and k into the group's signed digits in shared
// memory, beside the B planes and the [0..8]A' table. `at` is taken as
// given, never recomputed as x y, so a raw lane whose `at` is not x y
// gets the verdict the plain version gives it. The TPU layout (limb-major
// [20, block] tiles, the VMEM table scratch) is not carried over.
//
// What bounds it: 32-bit multiply instructions, about 357,000 a
// signature's ladder against 913 bytes a lane, so about 1e-3 of the time
// is bytes. At the main path's shape (a 256-lane window, 32 one-warp
// blocks) the time is one group's dependent chain of carry-chain
// products, adds and shuffles, far above the bound.
//
// No thread returns before the last shuffle: a lane past the batch works
// on lane 0's rows and only its store is dropped.
#include <cuda_runtime.h>

#include "ladder4.cuh"

__global__ void __launch_bounds__(L4_THREADS)
hd_ed25519_verify_kernel(const int32_t* __restrict__ ax,
                         const int32_t* __restrict__ ay,
                         const int32_t* __restrict__ at,
                         const int32_t* __restrict__ rx,
                         const int32_t* __restrict__ ry,
                         const int32_t* __restrict__ s_nib,
                         const int32_t* __restrict__ k_nib,
                         uint8_t* __restrict__ ok, int n) {
    __shared__ l4_shared sm;
    l4_stage_btab(sm);
    const int j = threadIdx.x & (L4_GROUP - 1);
    const int g = threadIdx.x / L4_GROUP;
    const int sig = blockIdx.x * L4_SIGS + g;
    const bool live = sig < n;
    const size_t row = (size_t)(live ? sig : 0);
    if (j < 2) l4_recode_nibbles(sm.dig[g][j], (j == 0 ? s_nib : k_nib) + row * 64);
    __syncthreads();

    const size_t r20 = row * 20;
    const fe8 fax = fe8_from_limbs13(ax + r20);
    const fe8 fay = fe8_from_limbs13(ay + r20);
    const fe8 fat = fe8_from_limbs13(at + r20);
    const fe8 frx = fe8_from_limbs13(rx + r20);
    const fe8 fry = fe8_from_limbs13(ry + r20);
    bool ok_l = l4_ladder_ok(fax, fay, fat, frx, fry, sm.dig[g][0], sm.dig[g][1],
                             sm.atab, sm.btab);
    if (j == 0 && live) ok[sig] = ok_l ? 1 : 0;
}

// Enqueue one verification of n lanes on `stream` of `device`; never
// synchronizes. `ok` receives 0/1 per lane. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int hd_ed25519_verify(int device, const int32_t* ax, const int32_t* ay,
                                 const int32_t* at, const int32_t* rx,
                                 const int32_t* ry, const int32_t* s_nib,
                                 const int32_t* k_nib, uint8_t* ok, int n,
                                 void* stream) {
    if (n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    hd_ed25519_verify_kernel<<<l4_blocks(n), L4_THREADS, 0, (cudaStream_t)stream>>>(
        ax, ay, at, rx, ry, s_nib, k_nib, ok, n);
    return (int)cudaGetLastError();
}
