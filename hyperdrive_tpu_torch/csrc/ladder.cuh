// The Ed25519 verification ladder shared by the verify kernels: per lane,
// [s]B + [k]A' == R (A' = -A) on pre-decompressed affine limbs, the joint
// Horner walk of the TPU kernel's _ladder_ok (hyperdrive_tpu/ops/
// ed25519_pallas.py:402-483) in the point formulas of the JAX package's
// ops/ed25519_jax.py (_madd, _padd, _dbl). One thread verifies one
// signature; the 9-entry table of [0..8]A' is a per-thread array indexed
// by the digit (local memory), never a branch on the digit.
#pragma once
#include "fe25519.cuh"

struct hd_point {
    int32_t x[FE_N], y[FE_N], z[FE_N], t[FE_N];
};

// Projective niels entry (y+x, y-x, 2d*t, z).
struct hd_niels {
    int32_t yp[FE_N], ym[FE_N], t2d[FE_N], z[FE_N];
};

// Extended point + affine niels entry (z2 = 1): _madd. out may alias p.
HD_NOINL void hd_madd(hd_point* out, const hd_point* p, const int32_t* yp2,
                      const int32_t* ym2, const int32_t* t2d2, bool need_t) {
    int32_t a[FE_N], b[FE_N], c[FE_N], d[FE_N], e[FE_N], f[FE_N], g[FE_N], h[FE_N];
    fe_sub(a, p->y, p->x);
    fe_mul(a, a, ym2);
    fe_add(b, p->y, p->x);
    fe_mul(b, b, yp2);
    fe_mul(c, p->t, t2d2);
    fe_mul_small(d, p->z, 2);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(out->x, e, f);
    fe_mul(out->y, g, h);
    fe_mul(out->z, f, g);
    if (need_t) fe_mul(out->t, e, h);
}

// Extended point + projective niels entry: _padd. out may alias p.
HD_NOINL void hd_padd(hd_point* out, const hd_point* p, const hd_niels* n) {
    int32_t a[FE_N], b[FE_N], c[FE_N], d[FE_N], e[FE_N], f[FE_N], g[FE_N], h[FE_N];
    fe_sub(a, p->y, p->x);
    fe_mul(a, a, n->ym);
    fe_add(b, p->y, p->x);
    fe_mul(b, b, n->yp);
    fe_mul(c, p->t, n->t2d);
    fe_mul(d, p->z, n->z);
    fe_mul_small(d, d, 2);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(out->x, e, f);
    fe_mul(out->y, g, h);
    fe_mul(out->z, f, g);
    fe_mul(out->t, e, h);
}

// Doubling on (x, y, z): _dbl; T only when asked. out may alias p.
HD_NOINL void hd_dbl(hd_point* out, const hd_point* p, bool need_t) {
    int32_t a[FE_N], b[FE_N], c[FE_N], d[FE_N], e[FE_N], f[FE_N], g[FE_N], h[FE_N];
    fe_sqr(a, p->x);
    fe_sqr(b, p->y);
    fe_sqr(c, p->z);
    fe_mul_small(c, c, 2);
    fe_neg(d, a);
    fe_add(e, p->x, p->y);
    fe_sqr(e, e);
    fe_sub(e, e, a);
    fe_sub(e, e, b);
    fe_add(g, d, b);
    fe_sub(f, g, c);
    fe_sub(h, d, b);
    fe_mul(out->x, e, f);
    fe_mul(out->y, g, h);
    fe_mul(out->z, f, g);
    if (need_t) fe_mul(out->t, e, h);
}

// Signed-window recode of 64 little-endian base-16 digits into [-8, 7]
// (the JAX package's _recode_signed): digits >= 8 borrow 16 and carry 1.
// The final carry is dropped, as there, so a scalar >= 2^253 verifies as
// (scalar - 2^256) exactly as it does in the reference.
HD_INL void hd_recode_signed(int8_t* out, const int32_t* nib) {
    int32_t carry = 0;
    #pragma unroll 4
    for (int i = 0; i < 64; ++i) {
        int32_t d = nib[i] + carry;
        int32_t ge = d >= 8 ? 1 : 0;
        out[i] = (int8_t)(d - 16 * ge);
        carry = ge;
    }
}

HD_INL void fe_select(int32_t* o, bool neg, const int32_t* when_neg,
                      const int32_t* otherwise) {
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) o[i] = neg ? when_neg[i] : otherwise[i];
}

// The joint-Horner ladder + projective R check. ax, ay, at: affine -A
// (t = x*y); rx, ry: affine R; sd, kd: signed digits of s and k; btab: the
// constant B niels planes ([3][9][20], see HD_C_BTAB), read from wherever
// the caller staged them. Returns the verdict.
HD_NOINL bool hd_ladder_ok(const int32_t* ax, const int32_t* ay,
                           const int32_t* at, const int32_t* rx,
                           const int32_t* ry, const int8_t* sd,
                           const int8_t* kd, const int32_t* btab) {
    const int32_t* k2d = &hd_consts[HD_C_K2D];
    int32_t anyp[FE_N], anym[FE_N], ant2[FE_N];
    fe_add(anyp, ay, ax);
    fe_sub(anym, ay, ax);
    fe_mul(ant2, at, k2d);

    // [0..8]A' in projective niels form.
    hd_niels tbl[9];
    hd_point pt;
    for (int i = 0; i < FE_N; ++i) {
        pt.x[i] = 0;
        pt.y[i] = i == 0;
        pt.z[i] = i == 0;
        pt.t[i] = 0;
    }
    for (int v = 0; v < 9; ++v) {
        fe_add(tbl[v].yp, pt.y, pt.x);
        fe_sub(tbl[v].ym, pt.y, pt.x);
        fe_mul(tbl[v].t2d, pt.t, k2d);
        fe_copy(tbl[v].z, pt.z);
        if (v < 8) hd_madd(&pt, &pt, anyp, anym, ant2, true);
    }

    hd_point acc;
    for (int i = 0; i < FE_N; ++i) {
        acc.x[i] = 0;
        acc.y[i] = i == 0;
        acc.z[i] = i == 0;
        acc.t[i] = 0;
    }
    for (int w = 63; w >= 0; --w) {
        hd_dbl(&acc, &acc, false);
        hd_dbl(&acc, &acc, false);
        hd_dbl(&acc, &acc, false);
        hd_dbl(&acc, &acc, true);

        int kdw = kd[w];
        bool kneg = kdw < 0;
        const hd_niels* ea = &tbl[kneg ? -kdw : kdw];
        hd_niels sa;
        fe_select(sa.yp, kneg, ea->ym, ea->yp);
        fe_select(sa.ym, kneg, ea->yp, ea->ym);
        fe_neg(sa.t2d, ea->t2d);
        fe_select(sa.t2d, kneg, sa.t2d, ea->t2d);
        fe_copy(sa.z, ea->z);
        hd_padd(&acc, &acc, &sa);

        int sdw = sd[w];
        bool sneg = sdw < 0;
        int mag = sneg ? -sdw : sdw;
        const int32_t* byp = btab + (0 * 9 + mag) * FE_N;
        const int32_t* bym = btab + (1 * 9 + mag) * FE_N;
        const int32_t* bt2 = btab + (2 * 9 + mag) * FE_N;
        int32_t yp[FE_N], ym[FE_N], t2[FE_N];
        fe_select(yp, sneg, bym, byp);
        fe_select(ym, sneg, byp, bym);
        fe_neg(t2, bt2);
        fe_select(t2, sneg, t2, bt2);
        hd_madd(&acc, &acc, yp, ym, t2, false);
    }

    int32_t tmp[FE_N];
    fe_mul(tmp, rx, acc.z);
    fe_sub(tmp, acc.x, tmp);
    bool ok_x = fe_is_zero_mod_p(tmp);
    fe_mul(tmp, ry, acc.z);
    fe_sub(tmp, acc.y, tmp);
    bool ok_y = fe_is_zero_mod_p(tmp);
    return ok_x && ok_y;
}
