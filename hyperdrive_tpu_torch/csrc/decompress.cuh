// Point decompression for the wire kernels: RFC 8032 x-recovery on the
// 8 x 32-bit field of fe25519_w32.cuh, step for step the plain version
// hyperdrive_tpu_torch/ops/ed25519_wire.py::decompress_device (the port of
// the TPU kernels' _decompress_L, hyperdrive_tpu/ops/ed25519_pallas.py:338,
// with its pow22523 chain :270, zero test :289 and parity :327).
//
// Cost: one decompression is 255 squarings and 18 multiplications (the
// pow22523 chain is 251 and 11 of them), three zero tests and one
// canonical reduction. The sqrt(-1) multiply and the final negation run on
// every thread and a select keeps or drops them, so threads that
// decompress different points in one warp never diverge.
#pragma once
#include "fe25519_w32.cuh"

// x^(2^n): n squarings in a rolled loop.
HD_INL fe8 fe8_nsqr(fe8 x, int n) {
    #pragma unroll 1
    for (int i = 0; i < n; ++i) x = fe8_sqr(x);
    return x;
}

// a^((p-5)/8) = a^(2^252 - 3), the reference's addition chain
// (fe25519.pow22523).
HD_INL fe8 fe8_pow22523(const fe8& a) {
    fe8 z2 = fe8_sqr(a);
    fe8 z9 = fe8_mul(a, fe8_nsqr(z2, 2));
    fe8 z11 = fe8_mul(z2, z9);
    fe8 z_5_0 = fe8_mul(z9, fe8_sqr(z11));
    fe8 z_10_0 = fe8_mul(fe8_nsqr(z_5_0, 5), z_5_0);
    fe8 z_20_0 = fe8_mul(fe8_nsqr(z_10_0, 10), z_10_0);
    fe8 z_40_0 = fe8_mul(fe8_nsqr(z_20_0, 20), z_20_0);
    fe8 z_50_0 = fe8_mul(fe8_nsqr(z_40_0, 10), z_10_0);
    fe8 z_100_0 = fe8_mul(fe8_nsqr(z_50_0, 50), z_50_0);
    fe8 z_200_0 = fe8_mul(fe8_nsqr(z_100_0, 100), z_100_0);
    fe8 z_250_0 = fe8_mul(fe8_nsqr(z_200_0, 50), z_50_0);
    return fe8_mul(fe8_nsqr(z_250_0, 2), a);
}

// RFC 8032 x-recovery: solve x^2 = (y^2 - 1) / (d y^2 + 1). y has bit 255
// cleared (a y >= p is worked on as y mod p, as the plain version does);
// sign is 0 or 1. Writes x and returns ok, case for case the oracle's
// _recover_x: x2 == 0 gives x = 0, accepted iff sign == 0; a non-residue
// rejects; otherwise the root's canonical parity is flipped to the sign
// bit. The plain version's fe.eq(vx2, u) and fe.eq(vx2, -u) are the zero
// tests of vx2 - u and vx2 + u here: both exact, so the masks agree.
HD_INL bool fe8_decompress(fe8& x, const fe8& y, int sign) {
    const fe8 one = fe8_small(1);
    fe8 y2 = fe8_sqr(y);
    fe8 u = fe8_sub(y2, one);
    fe8 v = fe8_add(fe8_mul(fe8_const(HD_W_D), y2), one);
    fe8 v2 = fe8_sqr(v);
    fe8 uv3 = fe8_mul(u, fe8_mul(v2, v));
    fe8 uv7 = fe8_mul(uv3, fe8_sqr(v2));
    x = fe8_mul(uv3, fe8_pow22523(uv7));
    fe8 vx2 = fe8_mul(v, fe8_sqr(x));
    bool ok_direct = fe8_is_zero(fe8_sub(vx2, u));
    bool ok_flip = fe8_is_zero(fe8_add(vx2, u));
    x = fe8_select(ok_flip && !ok_direct, fe8_mul(x, fe8_const(HD_W_SQRTM1)), x);
    bool ok = (ok_direct || ok_flip) && !(fe8_is_zero(x) && sign == 1);
    int parity = (int)(fe8_canonical(x).v[0] & 1u);
    x = fe8_select(parity != sign, fe8_neg(x), x);
    return ok;
}
