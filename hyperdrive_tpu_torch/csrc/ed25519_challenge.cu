// The challenge scalars of the wire verifier's challenge routes on
// Hopper: per lane, k = SHA-512(R || A || M) mod L, canonical, as 32
// little-endian bytes, byte for byte the host's challenge_scalar.
//
// It replaces the JAX package's device program of the challenge leg,
// sha512_cat and sc_reduce_limbs (hyperdrive_tpu/ops/sha512_jax.py:146,
// :345) under make_challenge_fn / make_challenge_grouped_fn
// (hyperdrive_tpu/ops/ed25519_wire.py:281/:328). The reference wrote it in
// jnp, not Pallas; its plain version here is ops/ed25519_wire.challenge /
// challenge_grouped on ops/sha512.py, PyTorch ops whose 80 rounds and
// carry loops run as thousands of small launches.
//
// What bounds it on this card: the instruction issue of one warp. A lane
// is one 96-byte SHA-512 block and a reduction mod L, about 4,600 32-bit
// integer instructions against about 130 bytes, and at the main path's 256
// lanes there are 8 groups of 32 lanes against the card's 528
// sub-partitions. A sub-partition issues one warp instruction a cycle, and
// add, logic and shift instructions hold their pipe for two (measured on
// an H100 by chip_smoke.py's chain probes: 1.97-2.34 cycles; dependent
// latency 3.96-5.06), so one warp's instruction stream sets the time: with
// one thread a lane, one warp would issue the message schedule (~1,400
// instructions) beside the rounds, behind two dependent loads (the index,
// then the A row).
//
// Layout: a block serves 32 lanes with two warps (warp specialisation), so
// a lane's work runs on two sub-partitions at once:
// - warp 1, the producer: lane j loads its rows (the index, the digest
//   index and the R row first, then the A row and the digest row, each a
//   16-byte vector read), computes the schedule W16..W79 in a rolling
//   window of 16 registers, and writes K[t] + W[t] for every t to shared
//   memory ([80][32] words, 20 KB), releasing them in six chunks (rounds
//   0-3, which need only R; 4-15; 16-31; 32-47; 48-63; 64-79), each through
//   a named barrier of its own (bar.arrive, ids 1-6);
// - warp 0, the round warp: lane j waits on each chunk's barrier
//   (bar.sync) and runs its rounds on K + W from shared memory, so it
//   starts rounds 0-3 while the A and digest rows are in flight; then the
//   feed-forward, the reduction and the store.
// The round warp executes about 2,750 instructions (a round is about 29:
// Sigma0 and Sigma1 six funnel shifts and one three-input xor each, Ch and
// Maj one LOP3 a half, h + (K + W), Sigma1 + Ch, + d and Sigma0 + Maj as
// three-input additions with their carries, one shared-memory load), the
// producer about 1,700: at ~2.15 cycles an instruction the round warp's
// issue takes ~3.0 us at 1,980 MHz, and its dependent chain is 5
// instructions a round (cuobjdump -sass of the sm_90a build; chip_smoke.py
// prints both). Rounds 0-15 are unrolled and rounds 16-79 are a loop over
// chunks 2-5 with 16 rounds unrolled in its body (16 rounds bring the state
// back to its registers); the producer's schedule is the same loop. Fully
// unrolled (4,408 instructions, 69 KB of code) the kernel ran 5.8 us at
// 256 lanes and 7.3 us at 4,096, against 4.3 and 4.4 us for the loop: the
// larger code stalls on instruction fetch.
//
// An index outside its table reads zeros; the wrapper's caller
// range-checks indices on the host, and the semiwire kernel rejects such a
// lane anyway. A lane past n computes on zero rows (both warps meet at
// every barrier; the producer leaves after its last release) and only its
// store is dropped, so one launch takes any n >= 1.
//
// SHA-512: one block (96 bytes, the 0x80 byte, the bit length 768), the
// round constants in __constant__ memory (read by the producer), each
// 64-bit rotation two funnel shifts on the 32-bit halves.
//
// Reduction mod L = 2^252 + delta on 32-bit limbs: since 2^252 = -delta
// (mod L), x = a + 2^252 b (a < 2^252, b < 2^w) is congruent to
// a + delta (2^w - 1 - b) + c with c = -delta (2^w - 1) mod L, a sum of
// non-negative terms: the complement of b's bits times delta (4 limbs,
// 32 x 32 -> 64-bit multiply-adds on PTX carry chains, hd_sc_fold) plus a
// constant. Three folds take the
// 512-bit digest below 2^385 (w = 260), 2^258 (w = 133) and 3L (w = 6);
// two conditional subtractions of L make it canonical. The folds need not
// match the reference's 13-bit limbs: only the canonical k must.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_w32.cuh"

// Lanes a block, warps a block (0: rounds, 1: producer), threads a block.
constexpr int HD_CHAL_LANES = 32;
constexpr int HD_CHAL_WARPS = 2;
constexpr int HD_CHAL_THREADS = HD_CHAL_LANES * HD_CHAL_WARPS;
// The K + W chunks: chunk c holds rounds [hd_chal_chunk(c),
// hd_chal_chunk(c + 1)) and is released through named barrier 1 + c;
// chunks 2 and on are 16 rounds each (the loops' bodies).
constexpr int HD_CHAL_NCHUNK = 6;
__host__ __device__ constexpr int hd_chal_chunk(int c) {
    return c == 0 ? 0 : c == 1 ? 4 : 16 * (c - 1);
}

#ifdef HD_CHAL_STAMPS
#define HD_CHAL_STAMP(slot, dep) hd_chal_stamp(slot, dep)
#else
#define HD_CHAL_STAMP(slot, dep) ((void)0)
#endif

// FIPS 180-4 SHA-512 round constants and initial hash value.
static __constant__ uint64_t hd_sha512_k[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};
// The initial hash value is a constant of the program, so the compiler
// folds round 0 (whose state is this value) and part of rounds 1-3.
static __constant__ const uint64_t hd_sha512_h0[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
    0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
    0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull,
};

HD_INL uint32_t hd_bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

HD_INL uint64_t hd_join(uint32_t hi, uint32_t lo) { return ((uint64_t)hi << 32) | lo; }

// Rotation right by N (0 < N < 64): swap the halves for N >= 32, then two
// funnel shifts, each taking its high bits from the other half.
template <int N>
HD_INL uint64_t hd_rotr(uint64_t x) {
    uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
    if (N >= 32) {
        const uint32_t t = lo;
        lo = hi;
        hi = t;
    }
    return hd_join(__funnelshift_r(hi, lo, N & 31), __funnelshift_r(lo, hi, N & 31));
}

// Logical shift right by N (0 < N < 32).
template <int N>
HD_INL uint64_t hd_shr(uint64_t x) {
    const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
    return hd_join(hi >> N, __funnelshift_r(lo, hi, N));
}

// Named barrier `id` among the block's HD_CHAL_THREADS threads: the
// producer arrives (its shared-memory writes before it are visible to the
// round warp once the barrier completes), the round warp waits.
HD_INL void hd_chal_release(int id) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(HD_CHAL_THREADS) : "memory");
}

HD_INL void hd_chal_wait(int id) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(HD_CHAL_THREADS) : "memory");
}

// The four big-endian message words of a 32-byte row (16-byte aligned),
// or zeros when `i` lies outside [0, n).
HD_INL void hd_load_words(uint64_t* w, const uint8_t* __restrict__ rows, int i, int n) {
    uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0;
    if (i >= 0 && i < n) {
        const uint4* q = reinterpret_cast<const uint4*>(rows + (size_t)i * 32);
        q0 = q[0];
        q1 = q[1];
    }
    w[0] = hd_join(hd_bswap32(q0.x), hd_bswap32(q0.y));
    w[1] = hd_join(hd_bswap32(q0.z), hd_bswap32(q0.w));
    w[2] = hd_join(hd_bswap32(q1.x), hd_bswap32(q1.y));
    w[3] = hd_join(hd_bswap32(q1.z), hd_bswap32(q1.w));
}

// The producer's W[t] for t >= 16, in place in the rolling window.
HD_INL void hd_chal_schedule(uint64_t (&w)[16], int t) {
    const uint64_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
    const uint64_t s0 = hd_rotr<1>(x15) ^ hd_rotr<8>(x15) ^ hd_shr<7>(x15);
    const uint64_t s1 = hd_rotr<19>(x2) ^ hd_rotr<61>(x2) ^ hd_shr<6>(x2);
    w[t & 15] += s0 + w[(t - 7) & 15] + s1;
}

// One round on the state s (a..h = s[0..7]) with kw = K[t] + W[t]: t1 =
// h + kw + Sigma1(e) + Ch(e, f, g), e' = d + t1, a' = t1 + Sigma0(a) +
// Maj(a, b, c); h + kw does not depend on this round's e or a.
HD_INL void hd_chal_round(uint64_t (&s)[8], uint64_t kw) {
    const uint64_t a = s[0], b = s[1], c = s[2], e = s[4], f = s[5], g = s[6];
    const uint64_t hk = s[7] + kw;
    const uint64_t t1 = hk + (hd_rotr<14>(e) ^ hd_rotr<18>(e) ^ hd_rotr<41>(e)) +
                        (g ^ (e & (f ^ g)));
    const uint64_t t2 = (hd_rotr<28>(a) ^ hd_rotr<34>(a) ^ hd_rotr<39>(a)) +
                        ((a & b) | (c & (a | b)));
    s[7] = g;
    s[6] = f;
    s[5] = e;
    s[4] = s[3] + t1;
    s[3] = c;
    s[2] = b;
    s[1] = a;
    s[0] = t1 + t2;
}

// t[0..4] += x * (y0 + y1 2^64) in one carry chain (the two products'
// low and high halves side by side), its carry into t[4], which holds no
// bits yet.
HD_INL void hd_sc_mac2(uint32_t* t, uint32_t x, uint32_t y0, uint32_t y1) {
    asm("mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4])
        : "r"(x), "r"(y0), "r"(y1));
}

// One fold: r = a + c + delta * ~b for x = a + 2^252 b, where ~b is the
// complement of b's NB limbs, the top one masked to `top` (b's width w),
// and c the fold constant for that w at `coff`. Bits 252.. of x sit at
// limb 7, bit 28. The product goes to two accumulators, rows of
// hd_sc_mac2 a limb apart: e takes the products with delta's limbs 0 and
// 2, o (one limb up) those with limbs 1 and 3, so each row's carry lands
// in a limb no earlier row reached and the two chains are independent;
// then one pass adds e, o and a + c with a 64-bit running carry. Each
// fold's bound (above and in hd_sc_reduce) leaves no carry out of limb
// NR - 1 and o's top limb zero.
template <int NX, int NB, int NR>
HD_INL void hd_sc_fold(uint32_t (&r)[NR], const uint32_t (&x)[NX], uint32_t top,
                       int coff) {
    uint32_t e[NB + 4], o[NB + 4];
    #pragma unroll
    for (int k = 0; k < NB + 4; ++k) e[k] = o[k] = 0;
    #pragma unroll
    for (int i = 0; i < NB; ++i) {
        const uint32_t lo = 7 + i < NX ? x[7 + i] : 0u;
        const uint32_t hi = 8 + i < NX ? x[8 + i] : 0u;
        const uint32_t nb = ~((lo >> 28) | (hi << 4)) & (i == NB - 1 ? top : 0xFFFFFFFFu);
        hd_sc_mac2(e + i, nb, hd_consts_w32[HD_W_SC_DELTA], hd_consts_w32[HD_W_SC_DELTA + 2]);
        hd_sc_mac2(o + i, nb, hd_consts_w32[HD_W_SC_DELTA + 1],
                   hd_consts_w32[HD_W_SC_DELTA + 3]);
    }
    uint64_t acc = 0;
    #pragma unroll
    for (int k = 0; k < NR; ++k) {
        if (k < NB + 4) acc += e[k];
        if (k >= 1 && k - 1 < NB + 4) acc += o[k - 1];
        if (k < 8) acc += (uint64_t)(k == 7 ? x[k] & 0x0FFFFFFFu : x[k]) + hd_consts_w32[coff + k];
        r[k] = (uint32_t)acc;
        acc >>= 32;
    }
}

// r - L if that does not borrow, else r: one borrow chain, its borrow as
// a mask, then selects.
HD_INL void hd_sc_sub_l(uint32_t (&r)[8]) {
    uint32_t d[8], b;
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
          "=r"(d[6]), "=r"(d[7]), "=r"(b)
        : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(r[4]), "r"(r[5]), "r"(r[6]),
          "r"(r[7]), "r"(hd_consts_w32[HD_W_SC_L]), "r"(hd_consts_w32[HD_W_SC_L + 1]),
          "r"(hd_consts_w32[HD_W_SC_L + 2]), "r"(hd_consts_w32[HD_W_SC_L + 3]),
          "r"(hd_consts_w32[HD_W_SC_L + 4]), "r"(hd_consts_w32[HD_W_SC_L + 5]),
          "r"(hd_consts_w32[HD_W_SC_L + 6]), "r"(hd_consts_w32[HD_W_SC_L + 7]));
    #pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = b ? r[k] : d[k];
}

// 16 little-endian limbs of a 512-bit value -> its canonical residue mod L.
HD_INL void hd_sc_reduce(uint32_t (&k)[8], const uint32_t (&x)[16]) {
    uint32_t r1[13], r2[9];
    hd_sc_fold<16, 9, 13>(r1, x, 0xFu, HD_W_SC_FOLD1);   // < 2^385
    hd_sc_fold<13, 5, 9>(r2, r1, 0x1Fu, HD_W_SC_FOLD2);  // < 2^258
    hd_sc_fold<9, 1, 8>(k, r2, 0x3Fu, HD_W_SC_FOLD3);    // < 3L
    hd_sc_sub_l(k);
    hd_sc_sub_l(k);
}

// k rows ([n, 32] uint8) from R rows ([n, 32]), the table's compressed A
// rows (trows, [n_table, 32]) at idx ([n] int32) and the digests: m_rows
// is [n, 32] when m_idx is null, else the [n_m, 32] digest table that
// m_idx ([n] uint8) indexes. Blocks of HD_CHAL_THREADS threads, one a 32
// lanes (the layout above).
__global__ void __launch_bounds__(HD_CHAL_THREADS)
hd_ed25519_challenge_kernel(const int32_t* __restrict__ idx,
                            const uint8_t* __restrict__ r_rows,
                            const uint8_t* __restrict__ m_rows,
                            const uint8_t* __restrict__ m_idx, int n_m,
                            const uint8_t* __restrict__ trows, int n_table,
                            uint8_t* __restrict__ k_rows, int n) {
    __shared__ uint64_t kw[80][HD_CHAL_LANES];
    const int j = threadIdx.x & (HD_CHAL_LANES - 1);
    const int lane = blockIdx.x * HD_CHAL_LANES + j;
    const bool live = lane < n;
    HD_CHAL_STAMP(0, lane);

    if (threadIdx.x >= HD_CHAL_LANES) {
        // The producer. Both indices and the R row are requested before
        // anything waits on them; the A and digest rows follow their index.
        const int ia = live ? idx[lane] : -1;
        const int im = m_idx == nullptr ? lane : live ? (int)m_idx[lane] : -1;
        uint64_t w[16];
        hd_load_words(w, r_rows, lane, n);
        hd_load_words(w + 4, trows, ia, n_table);
        hd_load_words(w + 8, m_rows, im, m_idx == nullptr ? n : n_m);
        w[12] = 0x8000000000000000ull;
        w[13] = 0;
        w[14] = 0;
        w[15] = 8 * 96;
        // Rounds 0-15's words as loaded: chunk 0 (R) first, then chunk 1.
        #pragma unroll
        for (int t = 0; t < 16; ++t) {
            kw[t][j] = hd_sha512_k[t] + w[t];
            if (t + 1 == hd_chal_chunk(1) || t + 1 == hd_chal_chunk(2)) {
                hd_chal_release(t < 4 ? 1 : 2);
                HD_CHAL_STAMP(t < 4 ? 1 : 2, (uint32_t)w[t]);
            }
        }
        // W16..W79, a chunk of 16 an iteration: window slot u holds W[t]
        // for t = u (mod 16), so the body's indices are constants and the
        // loop stays rolled (one copy of the code: 64 unrolled steps cost
        // more in instruction fetch than the loop does).
        #pragma unroll 1
        for (int c = 2; c < HD_CHAL_NCHUNK; ++c) {
            const int t0 = hd_chal_chunk(c);
            #pragma unroll
            for (int u = 0; u < 16; ++u) {
                hd_chal_schedule(w, 16 + u);
                kw[t0 + u][j] = hd_sha512_k[t0 + u] + w[u];
            }
            hd_chal_release(1 + c);
        }
        HD_CHAL_STAMP(3, (uint32_t)w[15]);
        HD_CHAL_STAMP(13, (uint32_t)w[0]);
        return;
    }

    // The round warp: one wait at the start of each chunk. Rounds 0-15
    // unrolled, then a chunk of 16 rounds an iteration (16 rounds move
    // the state a whole number of times round its 8 registers).
    uint64_t s[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = hd_sha512_h0[i];
    #pragma unroll
    for (int t = 0; t < 16; ++t) {
        if (t == hd_chal_chunk(0) || t == hd_chal_chunk(1)) {
            hd_chal_wait(t == 0 ? 1 : 2);
            HD_CHAL_STAMP(t == 0 ? 1 : 2, (uint32_t)kw[t][j]);
        }
        hd_chal_round(s, kw[t][j]);
    }
    #pragma unroll 1
    for (int c = 2; c < HD_CHAL_NCHUNK; ++c) {
        const int t0 = hd_chal_chunk(c);
        hd_chal_wait(1 + c);
        #pragma unroll
        for (int u = 0; u < 16; ++u) hd_chal_round(s, kw[t0 + u][j]);
    }
    HD_CHAL_STAMP(3, (uint32_t)(s[0] ^ s[7]));

    // The digest's bytes are the words big-endian; as a little-endian
    // integer its 32-bit limbs are the byte-swapped halves.
    uint32_t x[16];
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint64_t h = s[i] + hd_sha512_h0[i];
        x[2 * i] = hd_bswap32((uint32_t)(h >> 32));
        x[2 * i + 1] = hd_bswap32((uint32_t)h);
    }
    uint32_t k[8];
    hd_sc_reduce(k, x);
    HD_CHAL_STAMP(4, k[0] ^ k[7]);
    if (live) {
        uint4* out = reinterpret_cast<uint4*>(k_rows + (size_t)lane * 32);
        out[0] = make_uint4(k[0], k[1], k[2], k[3]);
        out[1] = make_uint4(k[4], k[5], k[6], k[7]);
    }
    HD_CHAL_STAMP(13, k[1]);
}

// Enqueue the kernel on `stream` of the current device (n >= 1).
static cudaError_t hd_challenge_enqueue(const int32_t* idx, const uint8_t* r_rows,
                                        const uint8_t* m_rows, const uint8_t* m_idx,
                                        int n_m, const uint8_t* trows, int n_table,
                                        uint8_t* k_rows, int n, cudaStream_t stream) {
    const int blocks = (n + HD_CHAL_LANES - 1) / HD_CHAL_LANES;
    hd_ed25519_challenge_kernel<<<blocks, HD_CHAL_THREADS, 0, stream>>>(
        idx, r_rows, m_rows, m_idx, n_m, trows, n_table, k_rows, n);
    return cudaGetLastError();
}

// Enqueue one challenge computation of n lanes on `stream` of `device`;
// never synchronizes. m_idx null selects the per-lane form (n_m is then
// ignored). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hd_ed25519_challenge(int device, const int32_t* idx,
                                    const uint8_t* r_rows, const uint8_t* m_rows,
                                    const uint8_t* m_idx, int n_m,
                                    const uint8_t* trows, int n_table,
                                    uint8_t* k_rows, int n, void* stream) {
    if (n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)hd_challenge_enqueue(idx, r_rows, m_rows, m_idx, n_m, trows, n_table,
                                     k_rows, n, (cudaStream_t)stream);
}
