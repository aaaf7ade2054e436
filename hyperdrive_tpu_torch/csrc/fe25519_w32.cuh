// GF(2^255 - 19) on 8 limbs of 32 bits in full radix, for the three
// verify kernels (ed25519_verify.cu, ed25519_wire.cu). The TPU's field (20
// x 13-bit limbs, ops/fe25519.py) exists because the TPU's vector unit has
// no 32 x 32 -> 64 multiply; Hopper has one, in PTX carry chains
// (mad.lo.cc / madc.hi.cc / addc), so a product is 64 low and 64 high
// halves instead of 400 limb products.
//
// Representation: a value v in [0, 2^256), congruent to the field element;
// nothing is reduced below 2^256 except where an exact value is needed
// (fe8_canonical: the zero tests and the decompression's parity). Since
// 2^256 = 38 (mod p), every carry out of the top limb folds back as 38.
// Every function takes and returns fe8 by value or reference and is
// inlined, so field elements stay in registers.
//
// The carry chains live in single asm statements: the condition code is
// not carried from one asm statement to the next. Each statement's
// operands are numbered outputs first, then inputs.
#pragma once
#include <stdint.h>

#ifndef HD_INL
#define HD_INL __device__ __forceinline__
#endif

struct fe8 {
    uint32_t v[8];
};

// The kernel library's one constant block, uploaded once a device from
// Python (ops/ed25519_cuda.py, consts_block_w32) in exactly this layout:
// p, 2d, d, sqrt(-1), then the 9-entry affine niels table of [0..8]B as
// three [9][8] planes (y+x, y-x, 2d*x*y), then the challenge kernel's
// scalar constants (ed25519_challenge.cu): the group order L, delta = L -
// 2^252 and the three fold constants -delta (2^w - 1) mod L for w = 260,
// 133 and 6. Every entry is a canonical value in 8 little-endian limbs.
#define HD_W_P 0
#define HD_W_K2D 8
#define HD_W_D 16
#define HD_W_SQRTM1 24
#define HD_W_BTAB 32
#define HD_W_BTAB_LEN (3 * 9 * 8)
#define HD_W_SC_L (HD_W_BTAB + HD_W_BTAB_LEN)
#define HD_W_SC_DELTA (HD_W_SC_L + 8)
#define HD_W_SC_FOLD1 (HD_W_SC_DELTA + 8)
#define HD_W_SC_FOLD2 (HD_W_SC_FOLD1 + 8)
#define HD_W_SC_FOLD3 (HD_W_SC_FOLD2 + 8)
#define HD_W_TOTAL (HD_W_SC_FOLD3 + 8)

static __constant__ uint32_t hd_consts_w32[HD_W_TOTAL];

HD_INL fe8 fe8_const(int offset) {
    fe8 r;
    #pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = hd_consts_w32[offset + k];
    return r;
}

HD_INL fe8 fe8_small(uint32_t x) {
    fe8 r;
    r.v[0] = x;
    #pragma unroll
    for (int k = 1; k < 8; ++k) r.v[k] = 0;
    return r;
}

HD_INL fe8 fe8_select(bool c, const fe8& a, const fe8& b) {
    fe8 r;
    #pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = c ? a.v[k] : b.v[k];
    return r;
}

// a + b: an 8-limb carry chain; the carry out folds back as 38, and the
// carry of that fold (possible only when the sum is below 38) once more.
HD_INL fe8 fe8_add(const fe8& a, const fe8& b) {
    fe8 r = a;
    uint32_t c = 0;
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mul.lo.u32 %8, %8, %17;\n\t"
        "add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, 0;\n\t"
        "addc.cc.u32 %2, %2, 0;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mul.lo.u32 %8, %8, %17;\n\t"
        "add.u32 %0, %0, %8;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
          "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(c)
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(38u));
    return r;
}

// a - b: an 8-limb borrow chain; a borrow out means 2^256 was added, which
// is 38 too many, so 38 is subtracted, and once more if that borrows too
// (possible only when the difference is below 38).
HD_INL fe8 fe8_sub(const fe8& a, const fe8& b) {
    fe8 r = a;
    uint32_t c = 0;
    asm("sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, 0, 0;\n\t"
        "and.b32 %8, %8, %17;\n\t"
        "sub.cc.u32 %0, %0, %8;\n\t"
        "subc.cc.u32 %1, %1, 0;\n\t"
        "subc.cc.u32 %2, %2, 0;\n\t"
        "subc.cc.u32 %3, %3, 0;\n\t"
        "subc.cc.u32 %4, %4, 0;\n\t"
        "subc.cc.u32 %5, %5, 0;\n\t"
        "subc.cc.u32 %6, %6, 0;\n\t"
        "subc.cc.u32 %7, %7, 0;\n\t"
        "subc.u32 %8, 0, 0;\n\t"
        "and.b32 %8, %8, %17;\n\t"
        "sub.u32 %0, %0, %8;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
          "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(c)
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(38u));
    return r;
}

HD_INL fe8 fe8_neg(const fe8& a) { return fe8_sub(fe8_small(0), a); }

// One row of the squaring's cross products: t[0..N] += x * y[0..N-1]
// (N <= 7), where t[N] holds no bits yet (so the row's final carry is
// zero). The low halves run in one carry chain, whose carry lands in t[N];
// the high halves, one limb up, in a second. Operands: %0..%7 the
// accumulator window t[0..7], %8 x, %9..%15 y[0..6]; a row of N < 7 leaves
// the window's upper limbs alone and reads zeros for y[N..6].
#define HD_LO0 "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
#define HD_LO1 "madc.lo.cc.u32 %1, %8, %10, %1;\n\t"
#define HD_LO2 "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
#define HD_LO3 "madc.lo.cc.u32 %3, %8, %12, %3;\n\t"
#define HD_LO4 "madc.lo.cc.u32 %4, %8, %13, %4;\n\t"
#define HD_LO5 "madc.lo.cc.u32 %5, %8, %14, %5;\n\t"
#define HD_LO6 "madc.lo.cc.u32 %6, %8, %15, %6;\n\t"
#define HD_HI0 "mad.hi.cc.u32 %1, %8, %9, %1;\n\t"
#define HD_HI1 "madc.hi.cc.u32 %2, %8, %10, %2;\n\t"
#define HD_HI2 "madc.hi.cc.u32 %3, %8, %11, %3;\n\t"
#define HD_HI3 "madc.hi.cc.u32 %4, %8, %12, %4;\n\t"
#define HD_HI4 "madc.hi.cc.u32 %5, %8, %13, %5;\n\t"
#define HD_HI5 "madc.hi.cc.u32 %6, %8, %14, %6;\n\t"
#define HD_HI6 "madc.hi.cc.u32 %7, %8, %15, %7;\n\t"
#define HD_TOP1 "addc.u32 %1, %1, 0;\n\t"
#define HD_TOP2 "addc.u32 %2, %2, 0;\n\t"
#define HD_TOP3 "addc.u32 %3, %3, 0;\n\t"
#define HD_TOP4 "addc.u32 %4, %4, 0;\n\t"
#define HD_TOP5 "addc.u32 %5, %5, 0;\n\t"
#define HD_TOP6 "addc.u32 %6, %6, 0;\n\t"
#define HD_TOP7 "addc.u32 %7, %7, 0;\n\t"
#define HD_LOS1 HD_LO0
#define HD_LOS2 HD_LOS1 HD_LO1
#define HD_LOS3 HD_LOS2 HD_LO2
#define HD_LOS4 HD_LOS3 HD_LO3
#define HD_LOS5 HD_LOS4 HD_LO4
#define HD_LOS6 HD_LOS5 HD_LO5
#define HD_LOS7 HD_LOS6 HD_LO6
#define HD_HIS1 HD_HI0
#define HD_HIS2 HD_HIS1 HD_HI1
#define HD_HIS3 HD_HIS2 HD_HI2
#define HD_HIS4 HD_HIS3 HD_HI3
#define HD_HIS5 HD_HIS4 HD_HI4
#define HD_HIS6 HD_HIS5 HD_HI5
#define HD_HIS7 HD_HIS6 HD_HI6
#define HD_ROW(N)                                                            \
    asm(HD_LOS##N HD_TOP##N HD_HIS##N                                        \
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),        \
          "+r"(t6), "+r"(t7)                                                 \
        : "r"(x), "r"(y0), "r"(y1), "r"(y2), "r"(y3), "r"(y4), "r"(y5),      \
          "r"(y6))

template <int N>
HD_INL void fe8_mac_row(uint32_t* t, uint32_t x, const uint32_t* y) {
    uint32_t pad[8];
    uint32_t& t0 = t[0];
    uint32_t& t1 = t[1];
    uint32_t& t2 = N >= 2 ? t[2] : pad[2];
    uint32_t& t3 = N >= 3 ? t[3] : pad[3];
    uint32_t& t4 = N >= 4 ? t[4] : pad[4];
    uint32_t& t5 = N >= 5 ? t[5] : pad[5];
    uint32_t& t6 = N >= 6 ? t[6] : pad[6];
    uint32_t& t7 = N >= 7 ? t[7] : pad[7];
    #pragma unroll
    for (int k = 2; k < 8; ++k) pad[k] = 0;
    const uint32_t y0 = y[0];
    const uint32_t y1 = N > 1 ? y[1] : 0u;
    const uint32_t y2 = N > 2 ? y[2] : 0u;
    const uint32_t y3 = N > 3 ? y[3] : 0u;
    const uint32_t y4 = N > 4 ? y[4] : 0u;
    const uint32_t y5 = N > 5 ? y[5] : 0u;
    const uint32_t y6 = N > 6 ? y[6] : 0u;
    if constexpr (N == 1) HD_ROW(1);
    if constexpr (N == 2) HD_ROW(2);
    if constexpr (N == 3) HD_ROW(3);
    if constexpr (N == 4) HD_ROW(4);
    if constexpr (N == 5) HD_ROW(5);
    if constexpr (N == 6) HD_ROW(6);
    if constexpr (N == 7) HD_ROW(7);
}

// t[0..15] (a 512-bit product) -> a value below 2^256: lo + 38 * hi in two
// chains (low halves of hi * 38 onto lo, high halves one limb up), which
// leaves a top limb of at most 38; it folds as 38 * top, and the carry of
// that (possible only when the result is below 38 * 39) once more.
HD_INL fe8 fe8_fold(const uint32_t* t) {
    fe8 r;
    #pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = t[k];
    uint32_t top = 0;
    asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
        "madc.hi.u32 %8, %16, %17, %8;\n\t"
        "mad.lo.cc.u32 %0, %8, %17, %0;\n\t"
        "addc.cc.u32 %1, %1, 0;\n\t"
        "addc.cc.u32 %2, %2, 0;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mad.lo.u32 %0, %8, %17, %0;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]),
          "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(top)
        : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]),
          "r"(t[12]), "r"(t[13]), "r"(t[14]), "r"(t[15]), "r"(38u));
    return r;
}

// t[0..8] += x * (a0 + a1 2^64 + a2 2^128 + a3 2^192), t[8] holding no
// bits yet: the four products' low and high halves sit side by side
// without overlap, so one carry chain adds them all.
HD_INL void fe8_mac_pairs(uint32_t* t, uint32_t x, uint32_t a0, uint32_t a1,
                          uint32_t a2, uint32_t a3) {
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(x), "r"(a0), "r"(a1), "r"(a2), "r"(a3));
}

// a * b: the products with the even limbs of a and those with the odd
// limbs go to two accumulators, two independent carry chains of 8 rows
// that the scheduler can overlap (64 low and 64 high halves in all); the
// odd one, a limb up, is added in, then the fold (16 + 2 multiplies): 146
// multiply instructions.
HD_INL fe8 fe8_mul(const fe8& a, const fe8& b) {
    uint32_t e[16], o[16];
    #pragma unroll
    for (int k = 0; k < 16; ++k) e[k] = o[k] = 0;
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
        fe8_mac_pairs(e + i, b.v[i], a.v[0], a.v[2], a.v[4], a.v[6]);
        fe8_mac_pairs(o + i, b.v[i], a.v[1], a.v[3], a.v[5], a.v[7]);
    }
    // e += o * 2^32 (o[15] is zero: the product is below 2^512): limbs
    // 1..8 with the carry run to the top, then limbs 9..15.
    asm("add.cc.u32 %0, %0, %15;\n\t"
        "addc.cc.u32 %1, %1, %16;\n\t"
        "addc.cc.u32 %2, %2, %17;\n\t"
        "addc.cc.u32 %3, %3, %18;\n\t"
        "addc.cc.u32 %4, %4, %19;\n\t"
        "addc.cc.u32 %5, %5, %20;\n\t"
        "addc.cc.u32 %6, %6, %21;\n\t"
        "addc.cc.u32 %7, %7, %22;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.cc.u32 %9, %9, 0;\n\t"
        "addc.cc.u32 %10, %10, 0;\n\t"
        "addc.cc.u32 %11, %11, 0;\n\t"
        "addc.cc.u32 %12, %12, 0;\n\t"
        "addc.cc.u32 %13, %13, 0;\n\t"
        "addc.u32 %14, %14, 0;"
        : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]),
          "+r"(e[11]), "+r"(e[12]), "+r"(e[13]), "+r"(e[14]), "+r"(e[15])
        : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]),
          "r"(o[6]), "r"(o[7]));
    asm("add.cc.u32 %0, %0, %7;\n\t"
        "addc.cc.u32 %1, %1, %8;\n\t"
        "addc.cc.u32 %2, %2, %9;\n\t"
        "addc.cc.u32 %3, %3, %10;\n\t"
        "addc.cc.u32 %4, %4, %11;\n\t"
        "addc.cc.u32 %5, %5, %12;\n\t"
        "addc.u32 %6, %6, %13;"
        : "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]),
          "+r"(e[14]), "+r"(e[15])
        : "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]), "r"(o[12]), "r"(o[13]),
          "r"(o[14]));
    return fe8_fold(e);
}

// a^2: the 28 cross products once (rows of 7 down to 1), doubled by a
// one-bit shift, plus the 8 squares on the diagonal in one chain, then the
// fold: 56 + 16 + 18 = 90 multiply instructions.
HD_INL fe8 fe8_sqr(const fe8& a) {
    uint32_t t[16];
    #pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = 0;
    fe8_mac_row<7>(t + 1, a.v[0], a.v + 1);
    fe8_mac_row<6>(t + 3, a.v[1], a.v + 2);
    fe8_mac_row<5>(t + 5, a.v[2], a.v + 3);
    fe8_mac_row<4>(t + 7, a.v[3], a.v + 4);
    fe8_mac_row<3>(t + 9, a.v[4], a.v + 5);
    fe8_mac_row<2>(t + 11, a.v[5], a.v + 6);
    fe8_mac_row<1>(t + 13, a.v[6], a.v + 7);
    #pragma unroll
    for (int k = 15; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
    t[0] = 0;
    asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
        "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
        "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
        "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
        "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
        "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
        "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
        "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
        "madc.hi.u32 %15, %23, %23, %15;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]),
          "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]),
          "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]),
          "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
    return fe8_fold(t);
}

// The unique representative in [0, p): bit 255 folds back as 19 (the value
// is then below 2^255 + 19 < 2p), then p is subtracted if that does not
// borrow. Off the hot path, so plain 64-bit arithmetic.
HD_INL fe8 fe8_canonical(fe8 a) {
    uint64_t acc = (uint64_t)(a.v[7] >> 31) * 19u;
    a.v[7] &= 0x7FFFFFFFu;
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
        acc += a.v[k];
        a.v[k] = (uint32_t)acc;
        acc >>= 32;
    }
    fe8 d;
    int64_t borrow = 0;
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
        int64_t x = (int64_t)a.v[k] - hd_consts_w32[HD_W_P + k] + borrow;
        d.v[k] = (uint32_t)x;
        borrow = x >> 32;
    }
    return fe8_select(borrow < 0, a, d);
}

HD_INL bool fe8_is_zero(const fe8& a) {
    fe8 c = fe8_canonical(a);
    uint32_t any = 0;
    #pragma unroll
    for (int k = 0; k < 8; ++k) any |= c.v[k];
    return any == 0;
}

// A 32-byte little-endian field encoding: the value with bit 255 cleared
// (below 2^255, so in range as it is); returns bit 255, the sign.
HD_INL int fe8_from_row(fe8& y, const uint8_t* __restrict__ row) {
    #pragma unroll
    for (int k = 0; k < 8; ++k)
        y.v[k] = (uint32_t)row[4 * k] | ((uint32_t)row[4 * k + 1] << 8) |
                 ((uint32_t)row[4 * k + 2] << 16) | ((uint32_t)row[4 * k + 3] << 24);
    int sign = (int)(y.v[7] >> 31);
    y.v[7] &= 0x7FFFFFFFu;
    return sign;
}

// 20 limbs of the TPU field (each in [0, 2^14), limb i weighing 2^(13 i))
// by value: a carry-propagating sum in 64 bits, which leaves the 8 limbs
// and bits 256..260 over; those fold back as 38 each.
HD_INL fe8 fe8_from_limbs13(const int32_t* __restrict__ l) {
    fe8 r;
    uint64_t acc = 0;
    int shift = 0, w = 0;
    #pragma unroll
    for (int i = 0; i < 20; ++i) {
        acc += (uint64_t)(uint32_t)l[i] << shift;
        shift += 13;
        if (shift >= 32) {
            r.v[w++] = (uint32_t)acc;
            acc >>= 32;
            shift -= 32;
        }
    }
    return fe8_add(r, fe8_small((uint32_t)acc * 38u));
}
