// g1_aggregate: the masked sum of BLS12-381 G1 points, one committee a
// block.
//
// Replaces the JAX package's jnp program `aggregate_kernel`
// (hyperdrive_tpu/ops/g1.py:182; batched by `make_batched_aggregate_fn`,
// :246), which a quorum certificate's 48-byte aggregate signature comes
// from. Plain version: `aggregate_kernel` in
// hyperdrive_tpu_torch/ops/g1.py; wrapper: ops/g1_cuda.py.
//
// What it computes, exactly as the plain version does, limb for limb:
// deselected lanes (mask == 0) become the identity (0 : 1 : 0), then a
// halving tree of complete Renes-Costello-Batina a = 0 additions: at a
// level of n lanes, lane i (i < n/2) becomes lane i + lane i + n/2, and an
// odd level adds its last lane into lane n/2 - 1. Points are projective
// (X, Y, Z) in the Montgomery domain of GF(p381) with R = 2^390, as 30
// signed 13-bit limbs in int32 (the port's layout, [B, N, 30] a
// coordinate), and the field arithmetic is the plain version's: CIOS over
// 30 limbs, one carry pass a step, two closing passes; additions and
// subtractions with one pass that keeps the top limb. So every output limb
// equals the plain version's, and the affine sum equals the host fold's.
//
// What bounds it: 32-bit multiply instructions. The bound counts the work
// in the unit of the ed25519 kernels: a product of a 12 x 32-bit word
// field is ~588 multiply instructions (2 * 12^2 for a * b, 2 * 12^2 for
// m * p, 12 for m), a complete addition 12 products, and a committee with
// k selected lanes needs k - 1 additions; at 64 a SM a clock. Bytes (364 a
// lane in, 360 a committee out) bound it far below that.
//
// Design, simple first: one block per committee, the committee's lanes in
// a global scratch buffer the wrapper allocates ([B, 3, N, 30]), one tree
// level per __syncthreads step, each thread adding pairs in a strided
// loop. A thread's field elements live in local arrays; a product keeps
// its accumulator in registers. Making it fast (a 12 x 32-bit field on
// carry chains, several threads an addition, shared memory) is later work.
#include <cstdint>
#include <cuda_runtime.h>

#define G1_NL 30
#define G1_LB 13
#define G1_LM 0x1FFF
#define G1_B3 12
constexpr int G1_THREADS = 256;

typedef int32_t fe381[G1_NL];

struct G1Consts {
    int32_t p[G1_NL];    // the modulus, 13-bit limbs
    int32_t one[G1_NL];  // R mod p: 1 in the Montgomery domain
    int32_t n0p;         // -p^-1 mod 2^13
};

// One carry pass that leaves the top limb unmasked (limbs.carry_pass_keep_top).
__device__ __forceinline__ void g1_pass_keep_top(int32_t* x) {
    int32_t cp = 0;
#pragma unroll
    for (int j = 0; j < G1_NL - 1; ++j) {
        int32_t v = x[j];
        x[j] = (v & G1_LM) + cp;
        cp = v >> G1_LB;
    }
    x[G1_NL - 1] += cp;
}

__device__ __noinline__ void g1_fadd(int32_t* out, const int32_t* a, const int32_t* b) {
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) out[j] = a[j] + b[j];
    g1_pass_keep_top(out);
}

__device__ __noinline__ void g1_fsub(int32_t* out, const int32_t* a, const int32_t* b) {
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) out[j] = a[j] - b[j];
    g1_pass_keep_top(out);
}

__device__ __noinline__ void g1_fmul_small(int32_t* out, const int32_t* a, int32_t k) {
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) out[j] = a[j] * k;
    g1_pass_keep_top(out);
    g1_pass_keep_top(out);
}

// Montgomery product a * b / 2^390 (limbs.Montgomery.mul): out may alias a
// or b.
__device__ __noinline__ void g1_fmul(int32_t* out, const int32_t* a, const int32_t* b,
                                     const G1Consts* c) {
    int32_t bb[G1_NL], lo[G1_NL];
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) {
        bb[j] = b[j];
        lo[j] = 0;
    }
    int32_t top = 0;
    const int32_t n0p = c->n0p;
#pragma unroll 1
    for (int i = 0; i < G1_NL; ++i) {
        const int32_t ai = a[i];
#pragma unroll
        for (int j = 0; j < G1_NL; ++j) lo[j] += ai * bb[j];
        const int32_t m = ((lo[0] & G1_LM) * n0p) & G1_LM;
#pragma unroll
        for (int j = 0; j < G1_NL; ++j) lo[j] += m * c->p[j];
        // lo[0] is a multiple of 2^13: shift one limb down, exact; the top
        // slot moves into limb 29.
        const int32_t c0 = lo[0] >> G1_LB;
#pragma unroll
        for (int j = 0; j < G1_NL - 1; ++j) lo[j] = lo[j + 1];
        lo[G1_NL - 1] = top;
        lo[0] += c0;
        // One pass; its last carry is the new top slot.
        int32_t cp = 0;
#pragma unroll
        for (int j = 0; j < G1_NL; ++j) {
            int32_t v = lo[j];
            lo[j] = (v & G1_LM) + cp;
            cp = v >> G1_LB;
        }
        top = cp;
    }
    g1_pass_keep_top(lo);
    g1_pass_keep_top(lo);
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) out[j] = lo[j];
}

// Complete projective addition, a = 0 (g1.padd, step for step): r may
// alias p.
__device__ __noinline__ void g1_padd(fe381* r, const fe381* p, const fe381* q,
                                     const G1Consts* c) {
    fe381 t0, t1, t2, t3, t4, x3, y3, z3, u, v;
    g1_fmul(t0, p[0], q[0], c);
    g1_fmul(t1, p[1], q[1], c);
    g1_fmul(t2, p[2], q[2], c);
    g1_fadd(u, p[0], p[1]);
    g1_fadd(v, q[0], q[1]);
    g1_fmul(t3, u, v, c);
    g1_fadd(u, t0, t1);
    g1_fsub(t3, t3, u);
    g1_fadd(u, p[1], p[2]);
    g1_fadd(v, q[1], q[2]);
    g1_fmul(t4, u, v, c);
    g1_fadd(u, t1, t2);
    g1_fsub(t4, t4, u);
    g1_fadd(u, p[0], p[2]);
    g1_fadd(v, q[0], q[2]);
    g1_fmul(x3, u, v, c);
    g1_fadd(u, t0, t2);
    g1_fsub(y3, x3, u);
    g1_fadd(u, t0, t0);
    g1_fadd(t0, u, t0);  // 3 * X1X2
    g1_fmul_small(t2, t2, G1_B3);
    g1_fadd(z3, t1, t2);
    g1_fsub(t1, t1, t2);
    g1_fmul_small(y3, y3, G1_B3);
    g1_fmul(u, t3, t1, c);
    g1_fmul(v, t4, y3, c);
    g1_fsub(x3, u, v);
    g1_fmul(u, t1, z3, c);
    g1_fmul(v, y3, t0, c);
    g1_fadd(y3, u, v);
    g1_fmul(u, z3, t4, c);
    g1_fmul(v, t0, t3, c);
    g1_fadd(z3, u, v);
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) {
        r[0][j] = x3[j];
        r[1][j] = y3[j];
        r[2][j] = z3[j];
    }
}

// Scratch lane i of coordinate k: s + (k * n + i) * 30.
__device__ __forceinline__ int32_t* g1_lane(int32_t* s, int n, int k, int i) {
    return s + ((size_t)k * n + i) * G1_NL;
}

__device__ void g1_load(fe381* pt, int32_t* s, int n, int i) {
    for (int k = 0; k < 3; ++k) {
        const int32_t* src = g1_lane(s, n, k, i);
#pragma unroll
        for (int j = 0; j < G1_NL; ++j) pt[k][j] = src[j];
    }
}

__device__ void g1_store(int32_t* s, int n, int i, const fe381* pt) {
    for (int k = 0; k < 3; ++k) {
        int32_t* dst = g1_lane(s, n, k, i);
#pragma unroll
        for (int j = 0; j < G1_NL; ++j) dst[j] = pt[k][j];
    }
}

__global__ void __launch_bounds__(G1_THREADS)
hd_g1_aggregate_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                       const int32_t* __restrict__ pz, const int32_t* __restrict__ mask,
                       const int32_t* __restrict__ consts, int n, int32_t* scratch,
                       int32_t* ox, int32_t* oy, int32_t* oz) {
    __shared__ G1Consts c;
    const int tid = threadIdx.x;
    for (int j = tid; j < 2 * G1_NL + 1; j += blockDim.x) (&c.p[0])[j] = consts[j];
    const size_t base = (size_t)blockIdx.x * n;
    int32_t* s = scratch + base * 3 * G1_NL;
    __syncthreads();
    // The select: deselected lanes become the identity (0 : 1 : 0).
    const int32_t* in[3] = {px, py, pz};
    for (int e = tid; e < n * G1_NL; e += blockDim.x) {
        const int i = e / G1_NL, j = e % G1_NL;
        const bool on = mask[base + i] != 0;
        for (int k = 0; k < 3; ++k)
            g1_lane(s, n, k, i)[j] = on ? in[k][(base + i) * G1_NL + j]
                                        : (k == 1 ? c.one[j] : 0);
    }
    __syncthreads();
    // The halving tree: level by level, lane i += lane i + h; an odd level
    // folds its last lane into lane h - 1 on the same thread.
    for (int w = n; w > 1; w >>= 1) {
        const int h = w >> 1;
        for (int i = tid; i < h; i += blockDim.x) {
            fe381 a[3], b[3];
            g1_load(a, s, n, i);
            g1_load(b, s, n, i + h);
            g1_padd(a, a, b, &c);
            if ((w & 1) && i == h - 1) {
                g1_load(b, s, n, w - 1);
                g1_padd(a, a, b, &c);
            }
            g1_store(s, n, i, a);
        }
        __syncthreads();
    }
    int32_t* out[3] = {ox, oy, oz};
    for (int e = tid; e < 3 * G1_NL; e += blockDim.x)
        out[e / G1_NL][(size_t)blockIdx.x * G1_NL + e % G1_NL] =
            g1_lane(s, n, e / G1_NL, 0)[e % G1_NL];
}

// Launch one block per committee on `stream`: px, py, pz [batch, n, 30]
// and mask [batch, n] in, ox, oy, oz [batch, 1, 30] out, scratch [batch, 3,
// n, 30], consts the 61 words of G1Consts. Returns a cudaError_t.
extern "C" int hd_g1_aggregate(int device, const int32_t* px, const int32_t* py,
                               const int32_t* pz, const int32_t* mask,
                               const int32_t* consts, int batch, int n,
                               int32_t* scratch, int32_t* ox, int32_t* oy,
                               int32_t* oz, void* stream) {
    if (batch <= 0 || n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    hd_g1_aggregate_kernel<<<batch, G1_THREADS, 0, (cudaStream_t)stream>>>(
        px, py, pz, mask, consts, n, scratch, ox, oy, oz);
    return (int)cudaGetLastError();
}
