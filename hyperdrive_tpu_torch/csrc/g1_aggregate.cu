// g1_aggregate: the masked sum of BLS12-381 G1 points on Hopper, one
// thread-block cluster a committee.
//
// Replaces the JAX package's jnp program `aggregate_kernel`
// (hyperdrive_tpu/ops/g1.py:182; batched by `make_batched_aggregate_fn`,
// :246), which a quorum certificate's 48-byte aggregate signature comes
// from. Plain version: `aggregate_kernel` in
// hyperdrive_tpu_torch/ops/g1.py; wrapper: ops/g1_cuda.py.
//
// What it computes, as the plain version does: deselected lanes (mask ==
// 0) become the identity (0 : 1 : 0), then a halving tree of complete
// Renes-Costello-Batina a = 0 additions: at a level of w lanes, lane i (i <
// h = w/2) becomes lane i + lane i + h, and an odd level adds its last
// lane into lane h - 1. The tree and the formula are the plain version's,
// so every output coordinate is the plain version's field element; the
// field's representation is not, so the outputs are canonical limbs where
// the plain version's are redundant (compare after fp381.canonical).
//
// What bounds it: 32-bit multiply instructions, ~588 a product, 12
// products an addition, k - 1 additions for k selected lanes, at 64 a SM a
// clock (chip_smoke.py g1_bound_ms); the bytes (364 a lane in) bound it
// far below that. At the certificate widths (256 lanes) it is latency:
// the tree is log2(N) dependent additions deep, and an addition is two
// rounds of six products each.
//
// The design, against that:
// - The field is GF(p381) on 12 words of 32 bits, Montgomery with R =
//   2^384, products on PTX carry chains (mad.lo.cc / madc.hi.cc),
//   interleaved (CIOS) on two accumulators, one for the even words of a
//   and p and one for the odd ones (the pattern of fe25519_w32.cuh), so
//   each row runs two independent chains: 288 + 12 + 288 multiply
//   instructions, 12 rows of ~28 dependent ones. Invariant: every value
//   is below 2^384 and congruent to the element (p < 2^381 leaves 3
//   bits); a carry out of bit 384 folds back as 2^384 mod p, a borrow as
//   its negative, and a product ends with one conditional subtraction of
//   p. Only the exit makes a value canonical.
// - Entry: the 30 signed 13-bit limbs (Montgomery with R = 2^390) are
//   summed into 12 words and a signed top, the top folded back, then one
//   product by 2^378 mod p gives the value times 2^384. Exit: one product
//   by 2^390 mod p (below 2p), one conditional subtraction, 30 limbs.
// - Eight threads an addition (a group, shuffles of width 8): thread j
//   computes product j of each round (six of eight threads busy), so an
//   addition costs two products of latency. Field elements stay in
//   registers; every function is inlined.
// - A committee is a cluster of 8 blocks on 8 SMs. Lane i lives in block
//   i mod 8's shared memory (144 bytes: X, Y, Z in 12 words each). The
//   first level reads the inputs from device memory and converts them on
//   the way in, so shared memory holds only the N/2 sums. A level whose
//   pairs stay in their blocks (h a multiple of 8, w even) is separated
//   from the last by __syncthreads; any other level (the last three of a
//   power-of-two width, every odd width) by cluster.sync(), its partners
//   read through distributed shared memory. Lane 0 ends in block 0, which
//   writes the result.
// - Above 25,825 lanes the N/2 sums do not fit in 8 x 227 KB: the same
//   lanes then live in a global scratch the wrapper allocates
//   (hd_g1_scratch_words), with the same tree and syncs. One launch a
//   call, for any batch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define G1_INL __device__ __forceinline__

#define G1_NL 30          // limbs of the port's layout (13 bits each)
#define G1_W 12           // 32-bit words of the kernel's field
#define G1_LANE_WORDS 36  // X, Y, Z of one lane
#define G1_CLUSTER 8      // blocks a committee
#define G1_GROUP 8        // threads an addition
constexpr int G1_THREADS = 256;

// The constant block, uploaded once a device from Python
// (ops/g1_cuda.py, consts_block) in this layout, every entry 12
// little-endian words: p; n0' = -p^-1 mod 2^32 (one word); 2^384 mod p (1
// in the Montgomery domain, and the fold of a carry out of bit 384); p -
// (2^384 mod p) (the fold of a negative top); 2^378 mod p (entry); 2^390
// mod p (exit).
#define G1C_P 0
#define G1C_N0 12
#define G1C_ONE 13
#define G1C_NEG 25
#define G1C_TO 37
#define G1C_FROM 49
#define G1C_TOTAL 61

static __constant__ uint32_t g1_consts[G1C_TOTAL];

struct fe12 {
    uint32_t v[G1_W];
};

G1_INL fe12 g1_const(int off) {
    fe12 r;
#pragma unroll
    for (int k = 0; k < G1_W; ++k) r.v[k] = g1_consts[off + k];
    return r;
}

G1_INL fe12 g1_zero() {
    fe12 r;
#pragma unroll
    for (int k = 0; k < G1_W; ++k) r.v[k] = 0;
    return r;
}

G1_INL fe12 g1_sel(bool c, const fe12& a, const fe12& b) {
    fe12 r;
#pragma unroll
    for (int k = 0; k < G1_W; ++k) r.v[k] = c ? a.v[k] : b.v[k];
    return r;
}

G1_INL fe12 g1_masked(const fe12& a, uint32_t m) {
    fe12 r;
#pragma unroll
    for (int k = 0; k < G1_W; ++k) r.v[k] = a.v[k] & m;
    return r;
}

// r += b over 12 words; returns the carry out (0 or 1).
G1_INL uint32_t g1_add_chain(fe12& r, const fe12& b) {
    uint32_t c = 0;
    asm("add.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.cc.u32 %11, %11, %24;\n\t"
        "addc.u32 %12, 0, 0;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
          "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(r.v[8]), "+r"(r.v[9]),
          "+r"(r.v[10]), "+r"(r.v[11]), "+r"(c)
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
          "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]), "r"(b.v[9]),
          "r"(b.v[10]), "r"(b.v[11]));
    return c;
}

// r -= b over 12 words; returns the borrow out as a mask (0 or ~0).
G1_INL uint32_t g1_sub_chain(fe12& r, const fe12& b) {
    uint32_t c = 0;
    asm("sub.cc.u32 %0, %0, %13;\n\t"
        "subc.cc.u32 %1, %1, %14;\n\t"
        "subc.cc.u32 %2, %2, %15;\n\t"
        "subc.cc.u32 %3, %3, %16;\n\t"
        "subc.cc.u32 %4, %4, %17;\n\t"
        "subc.cc.u32 %5, %5, %18;\n\t"
        "subc.cc.u32 %6, %6, %19;\n\t"
        "subc.cc.u32 %7, %7, %20;\n\t"
        "subc.cc.u32 %8, %8, %21;\n\t"
        "subc.cc.u32 %9, %9, %22;\n\t"
        "subc.cc.u32 %10, %10, %23;\n\t"
        "subc.cc.u32 %11, %11, %24;\n\t"
        "subc.u32 %12, 0, 0;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
          "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(r.v[8]), "+r"(r.v[9]),
          "+r"(r.v[10]), "+r"(r.v[11]), "+r"(c)
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
          "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]), "r"(b.v[9]),
          "r"(b.v[10]), "r"(b.v[11]));
    return c;
}

// r += t * c (t a word): the low halves in one chain, whose carry starts
// the new top, the high halves one word up in a second; returns the new
// top (the value's bits from 384 up).
G1_INL uint32_t g1_fold(fe12& r, uint32_t t, const fe12& c) {
    uint32_t top = 0;
    asm("mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.lo.cc.u32 %1, %13, %15, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %16, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %13, %19, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %20, %6;\n\t"
        "madc.lo.cc.u32 %7, %13, %21, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %22, %8;\n\t"
        "madc.lo.cc.u32 %9, %13, %23, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %24, %10;\n\t"
        "madc.lo.cc.u32 %11, %13, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
          "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(r.v[8]), "+r"(r.v[9]),
          "+r"(r.v[10]), "+r"(r.v[11]), "+r"(top)
        : "r"(t), "r"(c.v[0]), "r"(c.v[1]), "r"(c.v[2]), "r"(c.v[3]), "r"(c.v[4]),
          "r"(c.v[5]), "r"(c.v[6]), "r"(c.v[7]), "r"(c.v[8]), "r"(c.v[9]),
          "r"(c.v[10]), "r"(c.v[11]));
    asm("mad.hi.cc.u32 %0, %12, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, %14, %1;\n\t"
        "madc.hi.cc.u32 %2, %12, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %16, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %12, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %20, %7;\n\t"
        "madc.hi.cc.u32 %8, %12, %21, %8;\n\t"
        "madc.hi.cc.u32 %9, %12, %22, %9;\n\t"
        "madc.hi.cc.u32 %10, %12, %23, %10;\n\t"
        "madc.hi.u32 %11, %12, %24, %11;"
        : "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
          "+r"(r.v[6]), "+r"(r.v[7]), "+r"(r.v[8]), "+r"(r.v[9]), "+r"(r.v[10]),
          "+r"(r.v[11]), "+r"(top)
        : "r"(t), "r"(c.v[0]), "r"(c.v[1]), "r"(c.v[2]), "r"(c.v[3]), "r"(c.v[4]),
          "r"(c.v[5]), "r"(c.v[6]), "r"(c.v[7]), "r"(c.v[8]), "r"(c.v[9]),
          "r"(c.v[10]), "r"(c.v[11]));
    return top;
}

// a + b (both below 2^384): a carry out folds back as 2^384 mod p, whose
// carry (possible only when the sum's low part is at least p) once more;
// the second fold leaves a value below 2 (2^384 mod p), so no third.
G1_INL fe12 g1_add(const fe12& a, const fe12& b) {
    const fe12 one = g1_const(G1C_ONE);
    fe12 r = a;
    uint32_t c = g1_add_chain(r, b);
    c = g1_add_chain(r, g1_masked(one, 0u - c));
    g1_add_chain(r, g1_masked(one, 0u - c));
    return r;
}

// a - b: a borrow means 2^384 was added, so 2^384 mod p is taken away,
// and once more if that borrows too (then the value is at least 2^384 -
// 2 (2^384 mod p), so no third).
G1_INL fe12 g1_sub(const fe12& a, const fe12& b) {
    const fe12 one = g1_const(G1C_ONE);
    fe12 r = a;
    uint32_t m = g1_sub_chain(r, b);
    m = g1_sub_chain(r, g1_masked(one, m));
    g1_sub_chain(r, g1_masked(one, m));
    return r;
}

// k * a for a small k (k <= 12): the low halves, then the high halves one
// word up into a top below k; one fold of the top as 2^384 mod p leaves a
// top of at most 1 (2^384 + 11 (2^384 mod p) < 2^385), which two masked
// additions of 2^384 mod p take to zero.
G1_INL fe12 g1_mul_small(const fe12& a, uint32_t k) {
    fe12 r = g1_zero();
    uint32_t top = 0;
    asm("mul.lo.u32 %0, %13, %25;\n\t"
        "mul.lo.u32 %1, %14, %25;\n\t"
        "mul.lo.u32 %2, %15, %25;\n\t"
        "mul.lo.u32 %3, %16, %25;\n\t"
        "mul.lo.u32 %4, %17, %25;\n\t"
        "mul.lo.u32 %5, %18, %25;\n\t"
        "mul.lo.u32 %6, %19, %25;\n\t"
        "mul.lo.u32 %7, %20, %25;\n\t"
        "mul.lo.u32 %8, %21, %25;\n\t"
        "mul.lo.u32 %9, %22, %25;\n\t"
        "mul.lo.u32 %10, %23, %25;\n\t"
        "mul.lo.u32 %11, %24, %25;\n\t"
        "mad.hi.cc.u32 %1, %13, %25, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %25, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %25, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %25, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %25, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %25, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %25, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %25, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %25, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %25, %10;\n\t"
        "madc.hi.cc.u32 %11, %23, %25, %11;\n\t"
        "madc.hi.u32 %12, %24, %25, %12;"
        : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
          "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(r.v[8]), "+r"(r.v[9]),
          "+r"(r.v[10]), "+r"(r.v[11]), "+r"(top)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
          "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[8]), "r"(a.v[9]),
          "r"(a.v[10]), "r"(a.v[11]), "r"(k));
    const fe12 one = g1_const(G1C_ONE);
    top = g1_fold(r, top, one);
    top = g1_add_chain(r, g1_masked(one, 0u - top));
    g1_add_chain(r, g1_masked(one, 0u - top));
    return r;
}

// t[0..12] += x * (a0 + a1 2^64 + a2 2^128 + a3 2^192 + a4 2^256 + a5
// 2^320): the six products' halves sit side by side, so one carry chain
// adds them all; its carry out of t[11] goes into t[12], which never
// overflows (the running value stays below 2^387 a word).
G1_INL void g1_mac_pairs(uint32_t* t, uint32_t x, uint32_t a0, uint32_t a1,
                         uint32_t a2, uint32_t a3, uint32_t a4, uint32_t a5) {
    asm("mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
          "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]),
          "+r"(t[12])
        : "r"(x), "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(a4), "r"(a5));
}

// e0 += c, then g1_mac_pairs on t in a chain that starts with the carry of
// that addition: t's word 0 weighs one word more than e0.
G1_INL void g1_mac_pairs_carry(uint32_t& e0, uint32_t c, uint32_t* t, uint32_t x,
                               uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                               uint32_t a4, uint32_t a5) {
    asm("add.cc.u32 %0, %0, %14;\n\t"
        "madc.lo.cc.u32 %1, %15, %16, %1;\n\t"
        "madc.hi.cc.u32 %2, %15, %16, %2;\n\t"
        "madc.lo.cc.u32 %3, %15, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %15, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %15, %19, %7;\n\t"
        "madc.hi.cc.u32 %8, %15, %19, %8;\n\t"
        "madc.lo.cc.u32 %9, %15, %20, %9;\n\t"
        "madc.hi.cc.u32 %10, %15, %20, %10;\n\t"
        "madc.lo.cc.u32 %11, %15, %21, %11;\n\t"
        "madc.hi.cc.u32 %12, %15, %21, %12;\n\t"
        "addc.u32 %13, %13, 0;"
        : "+r"(e0), "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]),
          "+r"(t[11]), "+r"(t[12])
        : "r"(c), "r"(x), "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(a4), "r"(a5));
}

// Montgomery product a * b / 2^384 for a, b below 2^384, interleaved
// (CIOS) on two accumulators: the running value is e + o 2^32 + c, and row
// i adds b_i times the even words of a and m_i times the even words of p
// into e, the odd words into o (two independent chains each step), m_i
// making word 0 zero; dividing by 2^32 is a renaming (e <- o, c <- e[1], o
// <- e[2..12]). The running value stays below a + p; the result, below
// 2^384 + p, loses p if it reaches 2^384, so it is below 2^384 again (and
// below 2p when b < p).
G1_INL fe12 g1_mul(const fe12& a, const fe12& b) {
    const fe12 p = g1_const(G1C_P);
    const uint32_t n0 = g1_consts[G1C_N0];
    uint32_t e[G1_W + 1], o[G1_W + 1], c = 0;
#pragma unroll
    for (int k = 0; k <= G1_W; ++k) e[k] = o[k] = 0;
#pragma unroll
    for (int i = 0; i < G1_W; ++i) {
        g1_mac_pairs_carry(e[0], c, o, b.v[i], a.v[1], a.v[3], a.v[5], a.v[7], a.v[9],
                           a.v[11]);
        g1_mac_pairs(e, b.v[i], a.v[0], a.v[2], a.v[4], a.v[6], a.v[8], a.v[10]);
        const uint32_t m = e[0] * n0;
        g1_mac_pairs(e, m, p.v[0], p.v[2], p.v[4], p.v[6], p.v[8], p.v[10]);
        g1_mac_pairs(o, m, p.v[1], p.v[3], p.v[5], p.v[7], p.v[9], p.v[11]);
        c = e[1];
#pragma unroll
        for (int k = 0; k <= G1_W; ++k) {
            const uint32_t next = k + 2 <= G1_W ? e[k + 2] : 0u;
            e[k] = o[k];
            o[k] = next;
        }
    }
    // r = e + c + o 2^32, its top word 0 or 1.
    asm("add.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.cc.u32 %11, %11, %24;\n\t"
        "addc.u32 %12, %12, %25;"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
          "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]),
          "+r"(e[12])
        : "r"(c), "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]),
          "r"(o[6]), "r"(o[7]), "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]));
    fe12 r;
#pragma unroll
    for (int k = 0; k < G1_W; ++k) r.v[k] = e[k];
    // At 2^384 or above: subtract p; the borrow cancels the top word.
    g1_sub_chain(r, g1_masked(p, 0u - e[G1_W]));
    return r;
}

// The unique representative in [0, p) of a value below 2p.
G1_INL fe12 g1_canonical_2p(const fe12& a) {
    fe12 d = a;
    const uint32_t borrow = g1_sub_chain(d, g1_const(G1C_P));
    return g1_sel(borrow != 0, a, d);
}

// 30 limbs (int32, limb i weighing 2^(13 i), signed, any redundant form
// within the plain version's bound |value| < 2^389.5) of a value v in the
// Montgomery domain of R = 2^390 -> v 2^-6 mod p, below 2p: the value of
// the kernel's domain. A 64-bit signed window packs 12 words and leaves a
// signed top (|top| <= 46), which folds back as 2^384 mod p, or as p minus
// it for a negative top; two more folds take the top to zero.
G1_INL fe12 g1_from_limbs(const int32_t* __restrict__ l) {
    fe12 r;
    int64_t acc = 0;
    int shift = 0, w = 0;
#pragma unroll
    for (int i = 0; i < G1_NL; ++i) {
        acc += (int64_t)l[i] * ((int64_t)1 << shift);
        shift += 13;
        if (shift >= 32) {
            r.v[w++] = (uint32_t)acc;
            acc >>= 32;
            shift -= 32;
        }
    }
    const int32_t top = (int32_t)acc;
    const fe12 one = g1_const(G1C_ONE);
    uint32_t t = g1_fold(r, top < 0 ? (uint32_t)-top : (uint32_t)top,
                         g1_sel(top < 0, g1_const(G1C_NEG), one));
    t = g1_fold(r, t, one);
    g1_fold(r, t, one);
    return g1_mul(r, g1_const(G1C_TO));
}

// The exit: x 2^384 -> x 2^390 mod p, canonical, as 30 limbs of 13 bits.
G1_INL void g1_to_limbs(int32_t* __restrict__ out, const fe12& a) {
    const fe12 y = g1_canonical_2p(g1_mul(a, g1_const(G1C_FROM)));
#pragma unroll
    for (int j = 0; j < G1_NL; ++j) {
        const int bit = 13 * j, w = bit >> 5, off = bit & 31;
        uint64_t win = y.v[w];
        if (w + 1 < G1_W) win |= (uint64_t)y.v[w + 1] << 32;
        out[j] = (int32_t)((win >> off) & 0x1FFF);
    }
}

G1_INL fe12 g1_shfl(const fe12& a, int src, unsigned gm) {
    fe12 r;
#pragma unroll
    for (int k = 0; k < G1_W; ++k) r.v[k] = __shfl_sync(gm, a.v[k], src, G1_GROUP);
    return r;
}

// Entry j (0..7) of a table of eight 4-bit entries.
G1_INL int g1_nib(uint32_t table, int j) { return (int)((table >> (4 * j)) & 0xF); }

// One complete addition (g1.padd, the Renes-Costello-Batina a = 0
// formulas) by a group of eight threads. On entry thread j holds
// coordinate j of P (j < 3) or coordinate j - 3 of Q (3 <= j < 6); on
// return threads 0..2 hold X, Y, Z of P + Q. Threads 6 and 7 run the same
// instructions on copies and their results are dropped. gm masks the
// group's lanes of the warp.
//
//   round 1, thread j: X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
//            (X1+Z1)(X2+Z2) = t0..t5;
//   between: every thread also forms 12 t_j and 3 t_j, then thread j
//            gathers d_j = t3 - t0 - t1, t4 - t1 - t2, t1 - 12 t2,
//            12 t5 - 12 t0 - 12 t2, t1 + 12 t2, 3 t0 (t3', t4', t1', y3',
//            z3', t0' of padd), so no multiple waits on a sum;
//   round 2, thread j: d_j times d_(2, 3, 4, 5, 1, 0)_j = P0..P5;
//   X = P0 - P1, Y = P2 + P3, Z = P4 + P5 on threads 0, 1, 2.
G1_INL fe12 g1_group_add(const fe12& own, int j, unsigned gm) {
    const bool pair = j >= 3 && j < 6;
    const int ja = g1_nib(0x00010210u, j), jb = g1_nib(0x00221000u, j);
    const fe12 zero = g1_zero();
    fe12 x = g1_add(g1_shfl(own, ja, gm), g1_sel(pair, g1_shfl(own, jb, gm), zero));
    fe12 y = g1_add(g1_shfl(own, 3 + ja, gm), g1_sel(pair, g1_shfl(own, 3 + jb, gm), zero));
    // The two rounds run one copy of the product's code (the kernel is
    // latency-bound: its instructions must stay in the instruction cache).
#pragma unroll 1
    for (int round = 0;; ++round) {
        const fe12 t = g1_mul(x, y);
        if (round == 1) {
            const int coord = j % 3;
            const fe12 lo = g1_shfl(t, 2 * coord, gm);
            const fe12 hi = g1_shfl(t, 2 * coord + 1, gm);
            return g1_sel(coord == 0, g1_sub(lo, hi), g1_add(lo, hi));
        }
        const fe12 q = g1_mul_small(t, 12), r = g1_mul_small(t, 3);
        // d_j = (A + E) - (C + D), each term some lane's t, 12 t or 3 t, or
        // zero: A = t3, t4, t1, 12 t5, t1, 3 t0; C = t0, t1, 12 t2, 12 t0;
        // D = t1, t2, -, 12 t2; E = 12 t2 for thread 4.
        const int la = g1_nib(0x00015143u, j), lc = g1_nib(0x00000210u, j);
        const int ld = g1_nib(0x00002021u, j);
        const fe12 a = g1_sel(j == 3, g1_shfl(q, la, gm),
                              g1_sel(j == 5, g1_shfl(r, la, gm), g1_shfl(t, la, gm)));
        const fe12 c = g1_sel(j < 2, g1_shfl(t, lc, gm),
                              g1_sel(j < 4, g1_shfl(q, lc, gm), zero));
        const fe12 d = g1_sel(j < 2, g1_shfl(t, ld, gm),
                              g1_sel(j == 3, g1_shfl(q, ld, gm), zero));
        const fe12 e = g1_sel(j == 4, g1_shfl(q, 2, gm), zero);
        x = g1_sub(g1_add(a, e), g1_add(c, d));
        y = g1_shfl(x, g1_nib(0x00015432u, j), gm);
    }
}

// Coordinate k of input lane `lane` in the kernel's domain; a deselected
// lane reads as the identity (0 : 1 : 0).
G1_INL fe12 g1_input(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, const int32_t* __restrict__ mask,
                     size_t lane, int k) {
    const int32_t* src = (k == 0 ? px : (k == 1 ? py : pz)) + lane * G1_NL;
    const fe12 v = g1_from_limbs(src);
    return g1_sel(mask[lane] != 0, v, k == 1 ? g1_const(G1C_ONE) : g1_zero());
}

// Where lane `lane` of a committee lives: block lane % 8's shared memory,
// or its part of the global scratch.
G1_INL uint32_t* g1_lane(cg::cluster_group& cl, uint32_t* smem, uint32_t* glob,
                         int slots, int lane) {
    const int rank = lane % G1_CLUSTER, slot = lane / G1_CLUSTER;
    uint32_t* base = glob ? glob + (size_t)rank * slots * G1_LANE_WORDS
                          : cl.map_shared_rank(smem, rank);
    return base + (size_t)slot * G1_LANE_WORDS;
}

G1_INL fe12 g1_ld(const uint32_t* p) {
    fe12 r;
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const uint4 x = q[k];
        r.v[4 * k] = x.x;
        r.v[4 * k + 1] = x.y;
        r.v[4 * k + 2] = x.z;
        r.v[4 * k + 3] = x.w;
    }
    return r;
}

G1_INL void g1_st(uint32_t* p, const fe12& a) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k)
        q[k] = make_uint4(a.v[4 * k], a.v[4 * k + 1], a.v[4 * k + 2], a.v[4 * k + 3]);
}

__global__ void __cluster_dims__(G1_CLUSTER, 1, 1) __launch_bounds__(G1_THREADS, 1)
hd_g1_aggregate_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                       const int32_t* __restrict__ pz, const int32_t* __restrict__ mask,
                       int n, int slots, uint32_t* scratch, int32_t* ox, int32_t* oy,
                       int32_t* oz) {
    extern __shared__ uint4 g1_smem[];
    uint32_t* smem = reinterpret_cast<uint32_t*>(g1_smem);
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int committee = blockIdx.x / G1_CLUSTER;
    const int tid = threadIdx.x, j = tid % G1_GROUP;
    const int group = tid / G1_GROUP, groups = blockDim.x / G1_GROUP;
    const unsigned gm = 0xFFu << (tid & 31 & ~(G1_GROUP - 1));
    uint32_t* glob = scratch ? scratch + (size_t)committee * G1_CLUSTER * slots * G1_LANE_WORDS
                             : nullptr;
    const size_t base = (size_t)committee * n;
    const bool pair = j >= 3 && j < 6;
    const int coord = j % 3;

    // A lone lane is only converted.
    if (n == 1 && rank == 0 && group == 0) {
        const fe12 own = g1_input(px, py, pz, mask, base, coord);
        if (j < 3) g1_st(g1_lane(cl, smem, glob, slots, 0) + j * G1_W, own);
    }
    // The tree, a level at a time: lane i < h becomes lane i plus lane i +
    // h, and for an odd width lane h - 1 then takes lane w - 1 too. The
    // first level reads the inputs, converting them on the way in; the
    // others read the stored sums. One copy of the addition's code serves
    // every level.
    for (int w = n; w > 1; w >>= 1) {
        const int h = w >> 1;
        const bool inputs = w == n;
        if (!inputs) {
            if ((h % G1_CLUSTER) || (w & 1))
                cl.sync();  // partners in other blocks
            else
                __syncthreads();
        }
        const int count = h > rank ? (h - rank + G1_CLUSTER - 1) / G1_CLUSTER : 0;
        for (int s = group; s < count; s += groups) {
            const int i = rank + s * G1_CLUSTER;
            const int steps = (w & 1) && i == h - 1 ? 2 : 1;
            fe12 own = g1_zero();
#pragma unroll 1
            for (int k = 0; k < steps; ++k) {
                // P is lane i (then the sum so far), Q lane i + h (then w - 1).
                const int src = k == 0 ? (pair ? i + h : i) : w - 1;
                const fe12 fresh =
                    inputs ? g1_input(px, py, pz, mask, base + src, coord)
                           : g1_ld(g1_lane(cl, smem, glob, slots, src) + coord * G1_W);
                own = g1_group_add(g1_sel(k == 0 || pair, fresh, own), j, gm);
            }
            if (j < 3) g1_st(g1_lane(cl, smem, glob, slots, i) + j * G1_W, own);
        }
    }

    // Lane 0 is in block 0, written by it.
    __syncthreads();
    if (rank == 0 && tid < 3) {
        const fe12 sum = g1_ld(g1_lane(cl, smem, glob, slots, 0) + tid * G1_W);
        g1_to_limbs((tid == 0 ? ox : (tid == 1 ? oy : oz)) + (size_t)committee * G1_NL, sum);
    }
    // No block leaves while another may still read its shared memory.
    cl.sync();
}

// Slots of level-1 sums a block holds for a committee of n lanes.
static int g1_slots(int n) {
    const int sums = n > 1 ? n / 2 : 1;
    return (sums + G1_CLUSTER - 1) / G1_CLUSTER;
}

// The shared memory a block may opt into, asked of each device once.
static int g1_limits[64];

// Whether a committee of n lanes keeps its sums in shared memory (else in
// the global scratch); *limit is the device's opt-in shared memory.
static cudaError_t g1_fits(int device, int n, bool* shared, int* limit) {
    const bool cached = device >= 0 && device < 64;
    if (cached && g1_limits[device] > 0) {
        *limit = g1_limits[device];
    } else {
        const cudaError_t err =
            cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err != cudaSuccess) return err;
        if (cached) g1_limits[device] = *limit;
    }
    *shared = (long long)g1_slots(n) * G1_LANE_WORDS * 4 <= *limit;
    return cudaSuccess;
}

extern "C" int hd_g1_set_consts(int device, const uint32_t* consts) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyToSymbol(g1_consts, consts, sizeof(uint32_t) * G1C_TOTAL);
}

// 32-bit words of global scratch a committee of n lanes needs: 0 when its
// sums fit in the cluster's shared memory; -1 if the device cannot be
// queried.
extern "C" long long hd_g1_scratch_words(int device, int n) {
    bool shared = true;
    int limit = 0;
    if (n <= 0) return 0;
    if (g1_fits(device, n, &shared, &limit) != cudaSuccess) return -1;
    return shared ? 0 : (long long)G1_CLUSTER * g1_slots(n) * G1_LANE_WORDS;
}

// Launch one cluster of 8 blocks per committee on `stream`: px, py, pz
// [batch, n, 30] and mask [batch, n] in, ox, oy, oz [batch, 1, 30] out;
// scratch [batch, hd_g1_scratch_words] when that is not 0, else unused.
// The constants must be set (hd_g1_set_consts). Returns a cudaError_t.
extern "C" int hd_g1_aggregate(int device, const int32_t* px, const int32_t* py,
                               const int32_t* pz, const int32_t* mask, int batch, int n,
                               uint32_t* scratch, int32_t* ox, int32_t* oy, int32_t* oz,
                               void* stream) {
    if (batch <= 0 || n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    bool shared = true;
    int limit = 0;
    if ((err = g1_fits(device, n, &shared, &limit)) != cudaSuccess) return (int)err;
    if (!shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int slots = g1_slots(n);
    const size_t dyn = shared ? (size_t)slots * G1_LANE_WORDS * 4 : 0;
    if (dyn > 48 * 1024) {
        err = cudaFuncSetAttribute(hd_g1_aggregate_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
        if (err != cudaSuccess) return (int)err;
    }
    hd_g1_aggregate_kernel<<<batch * G1_CLUSTER, G1_THREADS, dyn, (cudaStream_t)stream>>>(
        px, py, pz, mask, n, slots, shared ? nullptr : scratch, ox, oy, oz);
    return (int)cudaGetLastError();
}
