// The Ed25519 verification ladder of all three verify kernels, four
// threads per signature: per signature, [s]B + [k]A' == R (A' = -A), the
// joint Horner walk of the TPU kernel's _ladder_ok (hyperdrive_tpu/ops/
// ed25519_pallas.py:402-483) in the point formulas of the reference
// (_dbl, _padd, _madd; port: ops/ed25519.py:78-111), on the field of
// fe25519_w32.cuh.
//
// Four consecutive threads of a warp (a group) share a signature; thread
// j of the group owns coordinate j of the extended accumulator (X, Y, Z,
// T). Each point formula is two rounds of four independent products, one
// per thread (Hisil, Wong, Carter and Dawson, "Twisted Edwards Curves
// Revisited", 2008):
//
//   doubling:  round 1  X^2, Y^2, Z^2, (X+Y)^2
//   addition:  round 1  (Y-X) ym, (Y+X) yp, Z (2z), T (2d t)
//   both:      round 2  E F, G H, F G, E H  ->  X', Y', Z', T'
//
// Between the rounds every thread gathers the four round-1 products by
// shuffles within its group and forms E, F, G, H itself. All threads run
// the same instructions on their own operands (selects, never branches on
// the thread's role), so the warp never diverges and every shuffle has
// the full mask. A thread's operand of an addition is its component of the
// entry: ym, yp, 2z and 2d t for threads 0..3; an affine entry (z = 1)
// gives 2. T is always computed; the formulas that do not need it ignore
// it, so X, Y and Z are the reference's values mod p.
#pragma once
#include "fe25519_w32.cuh"

#define L4_FULL 0xffffffffu

// Thread count of a group and entries of a window table.
#define L4_GROUP 4
#define L4_ENTRIES 9
// A block is one warp: L4_SIGS signatures.
#define L4_THREADS 32
#define L4_SIGS (L4_THREADS / L4_GROUP)

// The block's shared tables: the B planes, each thread's component of
// [0..8]A', and each group's signed digits of s and k.
struct l4_shared {
    uint32_t btab[HD_W_BTAB_LEN];
    uint32_t atab[L4_ENTRIES * 8 * L4_THREADS];
    int8_t dig[L4_SIGS][2][64];
};

// Blocks of a launch over n signatures.
static inline int l4_blocks(int n) { return (n + L4_SIGS - 1) / L4_SIGS; }

HD_INL void l4_stage_btab(l4_shared& sm) {
    for (int i = threadIdx.x; i < HD_W_BTAB_LEN; i += blockDim.x)
        sm.btab[i] = hd_consts_w32[HD_W_BTAB + i];
}

HD_INL fe8 l4_shfl(const fe8& a, int src) {
    fe8 r;
    #pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = __shfl_sync(L4_FULL, a.v[k], src, L4_GROUP);
    return r;
}

HD_INL fe8 l4_shfl_xor(const fe8& a, int mask) {
    fe8 r;
    #pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = __shfl_xor_sync(L4_FULL, a.v[k], mask, L4_GROUP);
    return r;
}

HD_INL bool l4_shfl_bool(bool b, int src) {
    return __shfl_sync(L4_FULL, (int)b, src, L4_GROUP) != 0;
}

// Round 2 of every formula: thread j returns coordinate j of the result,
// X' = E F, Y' = G H, Z' = F G, T' = E H.
HD_INL fe8 l4_round2(const fe8& e, const fe8& f, const fe8& g, const fe8& h, int j) {
    fe8 l = fe8_select(j == 1, g, fe8_select(j == 2, f, e));
    fe8 r = fe8_select(j == 0, f, fe8_select(j == 2, g, h));
    return fe8_mul(l, r);
}

// Doubling (_dbl): thread 3 squares X + Y, the others their own
// coordinate; Z^2 doubles after the gather.
HD_INL fe8 l4_dbl(const fe8& own, int j) {
    fe8 x = l4_shfl(own, 0);
    fe8 y = l4_shfl(own, 1);
    fe8 p = fe8_sqr(fe8_select(j == 3, fe8_add(x, y), own));
    fe8 a = l4_shfl(p, 0);
    fe8 b = l4_shfl(p, 1);
    fe8 zz = l4_shfl(p, 2);
    fe8 s = l4_shfl(p, 3);
    // The reference's D = -A, E = S - A - B, G = D + B, F = G - 2 Z^2,
    // H = D - B, in an order of two dependent steps.
    fe8 ab = fe8_add(a, b);
    fe8 g = fe8_sub(b, a);
    fe8 c = fe8_add(zz, zz);
    return l4_round2(fe8_sub(s, ab), fe8_sub(g, c), g, fe8_neg(ab), j);
}

// Addition of a niels entry (_padd; _madd when thread 2's q is 2): thread
// j multiplies Y - X, Y + X, Z, T by its component q of the entry.
// Threads 0 and 1 swap X and Y first.
HD_INL fe8 l4_add(const fe8& own, const fe8& q, int j) {
    fe8 other = l4_shfl_xor(own, 1);
    fe8 in = fe8_select(j == 0, fe8_sub(other, own),
                        fe8_select(j == 1, fe8_add(own, other), own));
    fe8 p = fe8_mul(in, q);
    fe8 a = l4_shfl(p, 0);
    fe8 b = l4_shfl(p, 1);
    fe8 d = l4_shfl(p, 2);
    fe8 c = l4_shfl(p, 3);
    return l4_round2(fe8_sub(b, a), fe8_sub(d, c), fe8_add(d, c), fe8_add(b, a), j);
}

// Signed-window recode of a scalar's 64 little-endian base-16 digits
// into digits in [-8, 7] (the reference's _recode_signed): digits >= 8
// borrow 16 and carry 1; the final carry is dropped, as there, so a scalar
// >= 2^253 verifies as (scalar - 2^256) exactly as it does in the
// reference. l4_recode reads a 32-byte row, l4_recode_nibbles the packed
// path's int32 nibble row (each nibble in [0, 15]).
HD_INL int8_t l4_signed_digit(int nibble, int& carry) {
    int d = nibble + carry;
    carry = d >= 8 ? 1 : 0;
    return (int8_t)(d - 16 * carry);
}

HD_INL void l4_recode(int8_t* out, const uint8_t* __restrict__ row) {
    int carry = 0;
    #pragma unroll 4
    for (int i = 0; i < 64; ++i)
        out[i] = l4_signed_digit((row[i >> 1] >> (4 * (i & 1))) & 0xF, carry);
}

HD_INL void l4_recode_nibbles(int8_t* out, const int32_t* __restrict__ nib) {
    int carry = 0;
    #pragma unroll 4
    for (int i = 0; i < 64; ++i) out[i] = l4_signed_digit(nib[i], carry);
}

// The ladder and the projective R check for the signature of this
// thread's group. nax, ay, nat: affine -A (t = x y); rx, ry: affine R;
// sd, kd: the group's signed digits of s and k; atab: the block's [0..8]A'
// table in shared memory, [9][8][32] (entry, limb, thread), where each
// thread keeps its own component; btab: the B planes ([3][9][8], see
// HD_W_BTAB) in shared memory. Every thread of the group returns the
// verdict.
HD_INL bool l4_ladder_ok(const fe8& nax, const fe8& ay, const fe8& nat,
                         const fe8& rx, const fe8& ry, const int8_t* sd,
                         const int8_t* kd, uint32_t* atab, const uint32_t* btab) {
    const int tid = threadIdx.x & 31;
    const int j = tid & (L4_GROUP - 1);
    const int base = tid - j;
    const fe8 k2d = fe8_const(HD_W_K2D);
    const fe8 two = fe8_small(2);
    const fe8 zero = fe8_small(0);
    const fe8 one = fe8_small(1);
    const fe8 ident = fe8_select(j == 1 || j == 2, one, zero);

    // A' in affine niels form, this thread's component.
    fe8 qa = fe8_select(j == 0, fe8_sub(ay, nax),
             fe8_select(j == 1, fe8_add(ay, nax),
             fe8_select(j == 2, two, fe8_mul(nat, k2d))));

    // [0..8]A' in projective niels form (ym, yp, 2z, 2d t), one component
    // a thread.
    fe8 pt = ident;
    #pragma unroll 1
    for (int e = 0; e < L4_ENTRIES; ++e) {
        fe8 other = l4_shfl_xor(pt, 1);
        fe8 comp = fe8_select(j == 0, fe8_sub(other, pt),
                   fe8_select(j == 1, fe8_add(pt, other),
                   fe8_select(j == 2, fe8_add(pt, pt), fe8_mul(pt, k2d))));
        #pragma unroll
        for (int k = 0; k < 8; ++k) atab[(e * 8 + k) * 32 + tid] = comp.v[k];
        if (e < L4_ENTRIES - 1) pt = l4_add(pt, qa, j);
    }
    __syncwarp();

    fe8 acc = ident;
    #pragma unroll 1
    for (int w = 63; w >= 0; --w) {
        #pragma unroll 1
        for (int i = 0; i < 4; ++i) acc = l4_dbl(acc, j);
        #pragma unroll 1
        for (int half = 0; half < 2; ++half) {
            int dig = half == 0 ? kd[w] : sd[w];
            bool neg = dig < 0;
            int mag = neg ? -dig : dig;
            fe8 q;
            if (half == 0) {
                // Negating the entry swaps ym and yp and negates 2d t.
                int slot = (neg && j < 2) ? (j ^ 1) : j;
                #pragma unroll
                for (int k = 0; k < 8; ++k) q.v[k] = atab[(mag * 8 + k) * 32 + base + slot];
            } else {
                int plane = j == 0 ? (neg ? 0 : 1) : j == 1 ? (neg ? 1 : 0) : 2;
                #pragma unroll
                for (int k = 0; k < 8; ++k) q.v[k] = btab[(plane * 9 + mag) * 8 + k];
                q = fe8_select(j == 2, two, q);
            }
            q = fe8_select(neg && j == 3, fe8_neg(q), q);
            acc = l4_add(acc, q, j);
        }
    }

    // R_x Z == X on thread 0, R_y Z == Y on thread 1.
    fe8 z = l4_shfl(acc, 2);
    bool zero_diff = fe8_is_zero(fe8_sub(acc, fe8_mul(fe8_select(j == 0, rx, ry), z)));
    // Both shuffles run on every thread: a short-circuit && would skip the
    // second on some.
    bool ok_x = l4_shfl_bool(zero_diff, 0);
    bool ok_y = l4_shfl_bool(zero_diff, 1);
    return ok_x && ok_y;
}
