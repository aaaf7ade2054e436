// Batched Ed25519 verification on Hopper: the port of the TPU kernel
// _verify_kernel_body / _verify_kernel_inner (hyperdrive_tpu/ops/
// ed25519_pallas.py:373/380, ladder _ladder_ok :402).
//
// Layout: the packer's batch-major rows (ax, ay, at, rx, ry int32 [B, 20];
// s_nib, k_nib int32 [B, 64]) go in as they are; one thread verifies one
// signature, HD_THREADS (32) threads a block, ceil(B / HD_THREADS) blocks
// with a masked tail. The signed-digit recode runs here. The TPU layout
// (limb-major [20, block] tiles, the VMEM table scratch, concatenation
// splicing) is not carried over: it was shaped by the Mosaic compiler.
//
// What bounds it: integer multiplies. Each signature costs about 2,800
// field multiplications or squarings (about 1.0M 32-bit multiply-adds with
// the carry folds) against about 912 bytes in and 1 byte out, so the
// operation bound is the card's INT32 multiply rate. At the main path's
// shapes (a 256-lane vote window is 8 warps) the card is nowhere near that
// bound: each thread's dependent chain of field operations and its
// per-thread table in local memory set the time. The design answers what
// it can without changing the one-thread-per-signature shape: the field
// loops are unrolled so product columns live in registers, blocks are one
// warp so a small batch spreads over as many SMs (and L1 caches) as it has
// warps, and the constant B table is staged into shared memory so
// divergent digit lookups do not serialize on the constant cache.
// Splitting a signature across threads, or fewer and wider limbs, is
// later work.
#include <cuda_runtime.h>

#include "ladder.cuh"

constexpr int HD_THREADS = 32;

__global__ void __launch_bounds__(HD_THREADS)
hd_ed25519_verify_kernel(const int32_t* __restrict__ ax,
                         const int32_t* __restrict__ ay,
                         const int32_t* __restrict__ at,
                         const int32_t* __restrict__ rx,
                         const int32_t* __restrict__ ry,
                         const int32_t* __restrict__ s_nib,
                         const int32_t* __restrict__ k_nib,
                         uint8_t* __restrict__ ok, int n) {
    __shared__ int32_t btab[HD_C_BTAB_LEN];
    for (int i = threadIdx.x; i < HD_C_BTAB_LEN; i += blockDim.x)
        btab[i] = hd_consts[HD_C_BTAB + i];
    __syncthreads();

    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    size_t r20 = (size_t)lane * FE_N;
    size_t r64 = (size_t)lane * 64;
    int32_t lax_[FE_N], lay[FE_N], lat[FE_N], lrx[FE_N], lry[FE_N];
    for (int i = 0; i < FE_N; ++i) {
        lax_[i] = ax[r20 + i];
        lay[i] = ay[r20 + i];
        lat[i] = at[r20 + i];
        lrx[i] = rx[r20 + i];
        lry[i] = ry[r20 + i];
    }
    int8_t sd[64], kd[64];
    hd_recode_signed(sd, s_nib + r64);
    hd_recode_signed(kd, k_nib + r64);
    ok[lane] = hd_ladder_ok(lax_, lay, lat, lrx, lry, sd, kd, btab) ? 1 : 0;
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
    int blocks = (n + HD_THREADS - 1) / HD_THREADS;
    hd_ed25519_verify_kernel<<<blocks, HD_THREADS, 0, (cudaStream_t)stream>>>(
        ax, ay, at, rx, ry, s_nib, k_nib, ok, n);
    return (int)cudaGetLastError();
}
