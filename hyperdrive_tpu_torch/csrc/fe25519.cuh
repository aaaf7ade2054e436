// GF(2^255 - 19) on 20 limbs of 13 bits in int32, limb for limb the
// arithmetic of hyperdrive_tpu_torch/ops/fe25519.py (itself a copy of the
// JAX package's ops/fe25519.py).
//
// Representation and overflow argument: value = sum(l_i * 2^(13 i)); every
// public result has limbs in [0, SLACK_MAX = 9400] and value < 2^256. A
// schoolbook column sums at most 20 limb products, so it stays below
// 20 * 9400^2 = 1.767e9 < 2^31 and never overflows int32. Columns 20..38
// fold back with 2^260 = 608 (mod p), bits 255..259 with 2^255 = 19. The
// bound holds only for this 20 x 13 layout with the same subtraction bias
// (the multiple of p whose limbs dominate any operand), which the constant
// block below carries from the Python module, so the two cannot drift.
#pragma once
#include <stdint.h>

#define HD_INL __device__ __forceinline__
#define HD_NOINL __device__ __noinline__

#define FE_N 20
#define FE_BITS 13
#define FE_MASK 0x1FFF
#define FE_FOLD_260 608
#define FE_FOLD_255 19
#define FE_TOP_SHIFT 8
#define FE_TOP_MASK 0xFF

// The constant block, uploaded once from Python (ops/ed25519_cuda.py,
// _consts_block) in exactly this layout: subtraction bias, 2d, the exact
// base-2^13 digits of p and 2p, then the 9-entry affine niels table of
// [0..8]B as three [9][20] planes (y+x, y-x, 2d*x*y).
#define HD_C_BIAS 0
#define HD_C_K2D 20
#define HD_C_P 40
#define HD_C_P2 60
#define HD_C_BTAB 80
#define HD_C_BTAB_LEN (3 * 9 * FE_N)
#define HD_C_TOTAL (HD_C_BTAB + HD_C_BTAB_LEN)

static __constant__ int32_t hd_consts[HD_C_TOTAL];

// One vectorized carry pass (limbs.carry_pass): every limb keeps its low 13
// bits and receives the carry of the limb below, all carries taken from
// the input. Returns the carry out of the top limb. Inputs on this path
// are non-negative; >> is arithmetic either way.
HD_INL int32_t fe_pass(int32_t* x, int n) {
    int32_t cprev = 0;
    #pragma unroll
    for (int i = 0; i < n; ++i) {
        int32_t xi = x[i];
        x[i] = (xi & FE_MASK) + cprev;
        cprev = xi >> FE_BITS;
    }
    return cprev;
}

// limbs.fold_carry_out with factor 608, then one micro ripple.
HD_INL void fe_fold_carry_out(int32_t* x, int32_t c) {
    int32_t c0 = x[0] + c * FE_FOLD_260;
    x[0] = c0 & FE_MASK;
    x[1] += c0 >> FE_BITS;
}

// fe25519._fold_top: bits 255..259 fold back as x19 -> 19 * (x19 >> 8).
HD_INL void fe_fold_top(int32_t* x) {
    int32_t hi = x[FE_N - 1] >> FE_TOP_SHIFT;
    x[FE_N - 1] &= FE_TOP_MASK;
    int32_t c0 = x[0] + hi * FE_FOLD_255;
    x[0] = c0 & FE_MASK;
    x[1] += c0 >> FE_BITS;
}

// fe25519._pass_fold: carry pass, the 2^260 carry-out folds into limb 0.
HD_INL void fe_pass_fold(int32_t* x) {
    int32_t c = fe_pass(x, FE_N);
    x[0] += c * FE_FOLD_260;
}

HD_INL void fe_copy(int32_t* o, const int32_t* a) {
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) o[i] = a[i];
}

HD_INL void fe_add(int32_t* o, const int32_t* a, const int32_t* b) {
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) o[i] = a[i] + b[i];
    int32_t c = fe_pass(o, FE_N);
    fe_fold_carry_out(o, c);
    fe_fold_top(o);
}

// a - b as a + (bias - b): every pre-carry limb is non-negative.
HD_INL void fe_sub(int32_t* o, const int32_t* a, const int32_t* b) {
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) o[i] = a[i] + (hd_consts[HD_C_BIAS + i] - b[i]);
    int32_t c = fe_pass(o, FE_N);
    fe_fold_carry_out(o, c);
    fe_fold_top(o);
}

HD_INL void fe_neg(int32_t* o, const int32_t* a) {
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) o[i] = hd_consts[HD_C_BIAS + i] - a[i];
    int32_t c = fe_pass(o, FE_N);
    fe_fold_carry_out(o, c);
    fe_fold_top(o);
}

// fe25519._reduce_cols: 39 product columns -> 20 invariant limbs.
HD_INL void fe_reduce_cols(int32_t* o, int32_t* cols) {
    int32_t c1 = fe_pass(cols, 2 * FE_N - 1);
    #pragma unroll
    for (int i = 0; i < FE_N - 1; ++i) o[i] = cols[i] + cols[FE_N + i] * FE_FOLD_260;
    o[FE_N - 1] = cols[FE_N - 1] + c1 * FE_FOLD_260;
    fe_pass_fold(o);
    fe_pass_fold(o);
    fe_fold_top(o);
}

// Schoolbook product; o may alias a or b (the columns are built first).
HD_NOINL void fe_mul(int32_t* o, const int32_t* a, const int32_t* b) {
    int32_t cols[2 * FE_N - 1];
    #pragma unroll
    for (int k = 0; k < 2 * FE_N - 1; ++k) cols[k] = 0;
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) {
        int32_t ai = a[i];
        #pragma unroll
        for (int j = 0; j < FE_N; ++j) cols[i + j] += ai * b[j];
    }
    fe_reduce_cols(o, cols);
}

// Squaring: the same columns as fe_mul(a, a) (cross products doubled),
// about half the multiplies.
HD_NOINL void fe_sqr(int32_t* o, const int32_t* a) {
    int32_t cols[2 * FE_N - 1];
    #pragma unroll
    for (int k = 0; k < 2 * FE_N - 1; ++k) cols[k] = 0;
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) {
        int32_t ai = a[i];
        int32_t ai2 = ai + ai;
        cols[2 * i] += ai * ai;
        #pragma unroll
        for (int j = i + 1; j < FE_N; ++j) cols[i + j] += ai2 * a[j];
    }
    fe_reduce_cols(o, cols);
}

// Multiply by a small constant (k < 2^17).
HD_INL void fe_mul_small(int32_t* o, const int32_t* a, int32_t k) {
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) o[i] = a[i] * k;
    fe_pass_fold(o);
    fe_pass_fold(o);
    fe_pass_fold(o);
    fe_fold_top(o);
}

// True iff d (value < 2^256, limbs in [0, SLACK_MAX]) is 0 mod p: settle
// to exact digits (N + 2 folding passes, the Pallas _is_zero_mod_p_L), then
// compare with the digits of 0, p and 2p (3p > 2^256).
HD_INL bool fe_is_zero_mod_p(const int32_t* d) {
    int32_t x[FE_N];
    fe_copy(x, d);
    #pragma unroll 1
    for (int k = 0; k < FE_N + 2; ++k) fe_pass_fold(x);
    bool z0 = true, zp = true, z2p = true;
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) {
        z0 = z0 && (x[i] == 0);
        zp = zp && (x[i] == hd_consts[HD_C_P + i]);
        z2p = z2p && (x[i] == hd_consts[HD_C_P2 + i]);
    }
    return z0 || zp || z2p;
}
