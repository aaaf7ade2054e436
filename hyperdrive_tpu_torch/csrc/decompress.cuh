// Point decompression for the wire kernels: RFC 8032 x-recovery on the
// 20 x 13-bit limbs of fe25519.cuh, step for step the plain version
// hyperdrive_tpu_torch/ops/ed25519_wire.py::decompress_device (the port of
// the TPU kernels' _decompress_L, hyperdrive_tpu/ops/ed25519_pallas.py:338,
// with its pow22523 chain :270, zero test :289 and parity :327).
//
// Cost: one decompression is 255 squarings and 18 multiplications (the
// pow22523 chain is 251 and 11 of them), three zero tests and one
// canonical reduction. Everything here stays out of line: the squaring
// loops are rolled, so the chain adds one call site per step, not 251
// copies of fe_sqr, to the kernel's code and registers.
#pragma once
#include "fe25519.cuh"

// x <- x^(2^n): n squarings in a rolled loop.
HD_NOINL void fe_nsqr(int32_t* x, int n) {
    #pragma unroll 1
    for (int i = 0; i < n; ++i) fe_sqr(x, x);
}

// a^((p-5)/8) = a^(2^252 - 3), the reference's addition chain
// (fe25519.pow22523), so the limbs out are the plain version's limbs.
HD_NOINL void fe_pow22523(int32_t* o, const int32_t* a) {
    int32_t z2[FE_N], z9[FE_N], t[FE_N];
    int32_t z_5_0[FE_N], z_10_0[FE_N], z_20_0[FE_N], z_50_0[FE_N], z_100_0[FE_N];
    fe_sqr(z2, a);
    fe_copy(t, z2);
    fe_nsqr(t, 2);
    fe_mul(z9, a, t);
    fe_mul(t, z2, z9);  // z11
    fe_sqr(t, t);       // z22
    fe_mul(z_5_0, z9, t);
    fe_copy(t, z_5_0);
    fe_nsqr(t, 5);
    fe_mul(z_10_0, t, z_5_0);
    fe_copy(t, z_10_0);
    fe_nsqr(t, 10);
    fe_mul(z_20_0, t, z_10_0);
    fe_copy(t, z_20_0);
    fe_nsqr(t, 20);
    fe_mul(t, t, z_20_0);  // z_40_0
    fe_nsqr(t, 10);
    fe_mul(z_50_0, t, z_10_0);
    fe_copy(t, z_50_0);
    fe_nsqr(t, 50);
    fe_mul(z_100_0, t, z_50_0);
    fe_copy(t, z_100_0);
    fe_nsqr(t, 100);
    fe_mul(t, t, z_100_0);  // z_200_0
    fe_nsqr(t, 50);
    fe_mul(t, t, z_50_0);  // z_250_0
    fe_nsqr(t, 2);
    fe_mul(o, t, a);
}

// Sequential signed carry (fe25519._carry): limbs -> [0, 2^13); returns the
// carry out of the top limb.
HD_INL int32_t fe_carry_seq(int32_t* x) {
    int32_t carry = 0;
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) {
        int32_t c = x[i] + carry;
        x[i] = c & FE_MASK;
        carry = c >> FE_BITS;
    }
    return carry;
}

// Subtract p if x >= p (fe25519._cond_sub_p): the borrow out of x - p is
// negative exactly when x < p.
HD_INL void fe_cond_sub_p(int32_t* x) {
    int32_t t[FE_N];
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) t[i] = x[i] - hd_consts[HD_C_P + i];
    if (fe_carry_seq(t) >= 0) fe_copy(x, t);
}

// The unique representative in [0, p) (fe25519.canonical): carry, fold the
// carry out and bits 255..259, then two conditional subtracts.
HD_NOINL void fe_canonical(int32_t* o, const int32_t* a) {
    fe_copy(o, a);
    int32_t c = fe_carry_seq(o);
    fe_fold_carry_out(o, c);
    fe_fold_top(o);
    fe_cond_sub_p(o);
    fe_cond_sub_p(o);
}

// RFC 8032 x-recovery: solve x^2 = (y^2 - 1) / (d y^2 + 1). y has bit 255
// cleared and limbs in [0, 2^13) (value < 2^255; a y >= p is worked on as
// y mod p, as the plain version does); sign is 0 or 1. Writes x (invariant
// limbs) and returns ok, case for case the oracle's _recover_x: x2 == 0
// gives x = 0, accepted iff sign == 0; a non-residue rejects; otherwise the
// root's canonical parity is flipped to the sign bit. The plain version's
// fe.eq(vx2, u) and fe.eq(vx2, -u) are the zero tests of vx2 - u and
// vx2 + u here: both exact, so the masks agree.
HD_NOINL bool hd_decompress(int32_t* x, const int32_t* y, int sign) {
    int32_t one[FE_N], y2[FE_N], u[FE_N], v[FE_N], v2[FE_N], uv3[FE_N], t[FE_N];
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) one[i] = i == 0;
    fe_sqr(y2, y);
    fe_sub(u, y2, one);
    fe_mul(v, &hd_consts[HD_C_D], y2);
    fe_add(v, v, one);
    fe_sqr(v2, v);
    fe_mul(t, v2, v);
    fe_mul(uv3, u, t);
    fe_sqr(t, v2);
    fe_mul(t, uv3, t);  // u v^7
    fe_pow22523(t, t);
    fe_mul(x, uv3, t);
    fe_sqr(t, x);
    fe_mul(t, v, t);  // v x^2
    fe_sub(y2, t, u);
    bool ok_direct = fe_is_zero_mod_p(y2);
    fe_add(y2, t, u);
    bool ok_flip = fe_is_zero_mod_p(y2);
    if (ok_flip && !ok_direct) fe_mul(x, x, &hd_consts[HD_C_SQRTM1]);
    bool ok = (ok_direct || ok_flip) && !(fe_is_zero_mod_p(x) && sign == 1);
    fe_canonical(t, x);
    if ((t[0] & 1) != sign) fe_neg(x, x);
    return ok;
}
