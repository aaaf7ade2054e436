// Probes of the card beside the challenge kernel (PERF.md section 6, row
// 4), built by chip_smoke.py as a unit of its own; no entry point of the
// package uses it.
//
// - hd_probe_empty: an empty kernel, whose device time at the challenge
//   kernel's grid is the launch floor.
// - hd_probe_chain<OP, CHAINS>: one warp runs CHAINS independent chains of
//   one integer instruction (OP below), 128 steps in all a loop iteration,
//   for `iters` iterations between two clock64 reads. With one chain the cycles a step are the instruction's
//   dependent latency; with eight, its issue interval. ptxas may fuse or
//   split steps (two PTX additions into one IADD3), so chip_smoke.py
//   divides by the instructions that cuobjdump shows in the loop, not by
//   the PTX steps.
// - The challenge kernel compiled with HD_CHAL_STAMPS: each warp stamps
//   clock64 at the ends of its phases (hd_chal_stamp, slots in
//   ed25519_challenge.cu) and %globaltimer at entry and exit; stamps are
//   kept for the first HD_PROBE_BLOCKS blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef HD_INL
#define HD_INL __device__ __forceinline__
#endif

#define HD_PROBE_BLOCKS 128
#define HD_PROBE_SLOTS 16
#define HD_PROBE_WARPS 4

// [block][warp][slot]: clock64 at a phase's end; slot 0 is the entry and
// slot 13 the exit, and slots 14 and 15 hold %globaltimer (ns) at entry
// and exit.
__device__ unsigned long long hd_probe_stamps[HD_PROBE_BLOCKS * HD_PROBE_WARPS * HD_PROBE_SLOTS];
// A zero the compiler cannot see: stamps depend on a phase's result
// through it, so the clock read waits for that result.
__device__ uint32_t hd_probe_zero;

HD_INL unsigned long long hd_probe_slot_ptr_index(int slot) {
    return ((unsigned long long)blockIdx.x * HD_PROBE_WARPS + (threadIdx.x >> 5)) *
               HD_PROBE_SLOTS + slot;
}

// Stamp `slot` once `dep` is computed: the clock read is predicated on
// dep times a zero, so it issues after dep's producer completes.
HD_INL void hd_chal_stamp(int slot, uint32_t dep) {
    if ((threadIdx.x & 31) != 0 || blockIdx.x >= HD_PROBE_BLOCKS) return;
    const uint32_t z = dep & *(volatile uint32_t*)&hd_probe_zero;
    unsigned long long t = 0;
    if (z == 0) asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
    hd_probe_stamps[hd_probe_slot_ptr_index(slot) + z] = t;
    if (slot == 0 || slot == 13) {
        unsigned long long g;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g) :: "memory");
        hd_probe_stamps[hd_probe_slot_ptr_index(slot == 0 ? 14 : 15) + z] = g;
    }
}

#define HD_CHAL_STAMPS 1
#include "ed25519_challenge.cu"

__global__ void hd_probe_empty() {}

// OP: 0 add.u32 (IADD3), 1 add.cc/addc pairs (IADD3 -> IADD3.X), 2 funnel
// shift (SHF), 3 three-input majority (LOP3), 4 mad.lo (IMAD), 5 LOP3 and
// IMAD chains interleaved (CHAINS / 2 each), 6 mad.hi (IMAD.HI).
template <int OP>
HD_INL void hd_probe_step(uint32_t& x, uint32_t& y, uint32_t a, uint32_t b, int c) {
    if (OP == 0) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(a));
    } else if (OP == 1) {
        asm volatile("add.cc.u32 %0, %1, %2;\n\taddc.u32 %1, %0, %3;"
                     : "+r"(x), "+r"(y) : "r"(a), "r"(b));
    } else if (OP == 2) {
        asm volatile("shf.r.wrap.b32 %0, %0, %1, 13;" : "+r"(x) : "r"(a));
    } else if (OP == 3) {
        asm volatile("lop3.b32 %0, %0, %1, %2, 0xE8;" : "+r"(x) : "r"(a), "r"(b));
    } else if (OP == 4) {
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
    } else if (OP == 6) {
        asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
    } else {
        if (c & 1)
            asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
        else
            asm volatile("lop3.b32 %0, %0, %1, %2, 0xE8;" : "+r"(x) : "r"(a), "r"(b));
    }
}

template <int OP, int CHAINS>
__global__ void __launch_bounds__(32)
hd_probe_chain(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               long long* __restrict__ cycles, int iters) {
    uint32_t x[CHAINS], y[CHAINS], a[4], b[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        a[i] = in[i] | 1u;
        b[i] = in[4 + i];
    }
    #pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
        x[c] = in[8 + c] + threadIdx.x;
        y[c] = in[16 + c];
    }
    __syncwarp();
    long long t0, t1;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0) :: "memory");
    #pragma unroll 1
    for (int i = 0; i < iters; ++i) {
        #pragma unroll
        for (int u = 0; u < 128 / CHAINS; ++u) {
            #pragma unroll
            for (int c = 0; c < CHAINS; ++c)
                hd_probe_step<OP>(x[c], y[c], a[u & 3], b[(u + c) & 3], c);
        }
    }
    uint32_t s = 0;
    #pragma unroll
    for (int c = 0; c < CHAINS; ++c) s ^= x[c] ^ y[c];
    const uint32_t z = s & *(volatile uint32_t*)&hd_probe_zero;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) :: "memory");
    out[threadIdx.x] = s;
    if (threadIdx.x == 0) cycles[z] = t1 - t0;
}

template <int OP>
static cudaError_t hd_probe_chain_launch(int chains, const uint32_t* in, uint32_t* out,
                                         long long* cycles, int iters, cudaStream_t s) {
    if (chains == 1)
        hd_probe_chain<OP, 1><<<1, 32, 0, s>>>(in, out, cycles, iters);
    else
        hd_probe_chain<OP, 8><<<1, 32, 0, s>>>(in, out, cycles, iters);
    return cudaGetLastError();
}

// Upload the constant block (as hd_ed25519_set_consts) and zero the stamps.
extern "C" int hd_probe_set_consts(int device, const uint32_t* host) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyToSymbol(hd_consts_w32, host, sizeof(uint32_t) * HD_W_TOTAL);
    if (err != cudaSuccess) return (int)err;
    const uint32_t zero = 0;
    return (int)cudaMemcpyToSymbol(hd_probe_zero, &zero, sizeof(zero));
}

// Enqueue the empty kernel on `blocks` x `threads`.
extern "C" int hd_probe_empty_launch(int device, int blocks, int threads, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    hd_probe_empty<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// Enqueue one chain probe (op 0..6, chains 1 or 8); cycles[0] receives the
// clock64 difference of thread 0.
extern "C" int hd_probe_chain_run(int device, int op, int chains, const uint32_t* in,
                                  uint32_t* out, long long* cycles, int iters,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case 0: return (int)hd_probe_chain_launch<0>(chains, in, out, cycles, iters, s);
        case 1: return (int)hd_probe_chain_launch<1>(chains, in, out, cycles, iters, s);
        case 2: return (int)hd_probe_chain_launch<2>(chains, in, out, cycles, iters, s);
        case 3: return (int)hd_probe_chain_launch<3>(chains, in, out, cycles, iters, s);
        case 4: return (int)hd_probe_chain_launch<4>(chains, in, out, cycles, iters, s);
        case 5: return (int)hd_probe_chain_launch<5>(chains, in, out, cycles, iters, s);
        default: return (int)hd_probe_chain_launch<6>(chains, in, out, cycles, iters, s);
    }
}

// Copy the stamps ([HD_PROBE_BLOCKS][HD_PROBE_WARPS][HD_PROBE_SLOTS]) out,
// after a synchronization; zero them for the next launch.
extern "C" int hd_probe_read_stamps(int device, unsigned long long* host) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyFromSymbol(host, hd_probe_stamps, sizeof(hd_probe_stamps));
    if (err != cudaSuccess) return (int)err;
    static unsigned long long zeros[HD_PROBE_BLOCKS * HD_PROBE_WARPS * HD_PROBE_SLOTS];
    return (int)cudaMemcpyToSymbol(hd_probe_stamps, zeros, sizeof(zeros));
}

extern "C" int hd_probe_stamp_geometry(int* blocks, int* warps, int* slots) {
    *blocks = HD_PROBE_BLOCKS;
    *warps = HD_PROBE_WARPS;
    *slots = HD_PROBE_SLOTS;
    return 0;
}
