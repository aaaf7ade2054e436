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
// Layout: one thread a lane, 32-thread blocks. The thread gathers its
// 96-byte preimage itself: its R row, the validator table's compressed A
// row at its index, and its message digest, either its own row (per-lane
// form) or the row of a deduplicated digest table at its digest index
// (grouped form). Rows are read as 16-byte vectors (the wrapper checks the
// alignment). An index outside its table reads zeros; the wrapper's
// caller range-checks indices on the host, and the semiwire kernel
// rejects such a lane anyway.
//
// SHA-512: one block (96 bytes, the 0x80 byte, the bit length 768), the
// message schedule a rolling window of 16 words in registers, the 80
// rounds unrolled, the round constants in __constant__ memory (every
// thread reads the same one at once: a broadcast), each 64-bit rotation
// two funnel shifts on the 32-bit halves.
//
// Reduction mod L = 2^252 + delta on 32-bit limbs: since 2^252 = -delta
// (mod L), x = a + 2^252 b (a < 2^252, b < 2^w) is congruent to
// a + delta (2^w - 1 - b) + c with c = -delta (2^w - 1) mod L, a sum of
// non-negative terms: the complement of b's bits times delta (4 limbs,
// 32 x 32 -> 64-bit multiply-adds) plus a constant. Three folds take the
// 512-bit digest below 2^385 (w = 260), 2^258 (w = 133) and 3L (w = 6);
// two conditional subtractions of L make it canonical. The folds need not
// match the reference's 13-bit limbs: only the canonical k must.
//
// What bounds it: integer instructions, about 4,600 a lane (chip_smoke.py
// counts them) against about 130 bytes a lane. At the main path's 256
// lanes the card is far from either bound: the time is one thread's
// dependent chain of 80 rounds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_w32.cuh"

constexpr int HD_CHAL_THREADS = 32;

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
static __constant__ uint64_t hd_sha512_h0[8] = {
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

// The compression of one block into the hash value h.
HD_INL void hd_sha512_block(uint64_t (&h)[8], uint64_t (&w)[16]) {
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
    #pragma unroll
    for (int t = 0; t < 80; ++t) {
        if (t >= 16) {
            const uint64_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
            const uint64_t s0 = hd_rotr<1>(x15) ^ hd_rotr<8>(x15) ^ hd_shr<7>(x15);
            const uint64_t s1 = hd_rotr<19>(x2) ^ hd_rotr<61>(x2) ^ hd_shr<6>(x2);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint64_t s1 = hd_rotr<14>(e) ^ hd_rotr<18>(e) ^ hd_rotr<41>(e);
        const uint64_t ch = g ^ (e & (f ^ g));
        const uint64_t t1 = hh + s1 + ch + hd_sha512_k[t] + w[t & 15];
        const uint64_t s0 = hd_rotr<28>(a) ^ hd_rotr<34>(a) ^ hd_rotr<39>(a);
        const uint64_t maj = (a & b) | (c & (a | b));
        hh = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + s0 + maj;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
}

// One fold: r = a + c + delta * ~b for x = a + 2^252 b, where ~b is the
// complement of b's NB limbs, the top one masked to `top` (b's width w),
// and c the fold constant for that w at `coff`. Bits 252.. of x sit at
// limb 7, bit 28. Each row of the product is one limb of ~b times the 4
// limbs of delta in 32 x 32 -> 64-bit multiply-adds, its carry run to
// the top. Each fold's bound (above and in hd_sc_reduce) leaves no carry
// out of limb NR - 1.
template <int NX, int NB, int NR>
HD_INL void hd_sc_fold(uint32_t (&r)[NR], const uint32_t (&x)[NX], uint32_t top,
                       int coff) {
    uint64_t acc = 0;
    #pragma unroll
    for (int k = 0; k < NR; ++k) {
        if (k < 8) acc += (uint64_t)(k == 7 ? x[k] & 0x0FFFFFFFu : x[k]) +
                          hd_consts_w32[coff + k];
        r[k] = (uint32_t)acc;
        acc >>= 32;
    }
    #pragma unroll
    for (int i = 0; i < NB; ++i) {
        const uint32_t lo = 7 + i < NX ? x[7 + i] : 0u;
        const uint32_t hi = 8 + i < NX ? x[8 + i] : 0u;
        const uint32_t nb = ~((lo >> 28) | (hi << 4)) & (i == NB - 1 ? top : 0xFFFFFFFFu);
        uint64_t carry = 0;
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint64_t t = (uint64_t)nb * hd_consts_w32[HD_W_SC_DELTA + j] + r[i + j] + carry;
            r[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
        #pragma unroll
        for (int k = i + 4; k < NR; ++k) {
            const uint64_t t = (uint64_t)r[k] + carry;
            r[k] = (uint32_t)t;
            carry = t >> 32;
        }
    }
}

// r - L if that does not borrow, else r.
HD_INL void hd_sc_sub_l(uint32_t (&r)[8]) {
    uint32_t d[8];
    int64_t borrow = 0;
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int64_t t = (int64_t)r[k] - hd_consts_w32[HD_W_SC_L + k] + borrow;
        d[k] = (uint32_t)t;
        borrow = t >> 32;
    }
    #pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = borrow < 0 ? r[k] : d[k];
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
// m_idx ([n] uint8) indexes.
__global__ void __launch_bounds__(HD_CHAL_THREADS)
hd_ed25519_challenge_kernel(const int32_t* __restrict__ idx,
                            const uint8_t* __restrict__ r_rows,
                            const uint8_t* __restrict__ m_rows,
                            const uint8_t* __restrict__ m_idx, int n_m,
                            const uint8_t* __restrict__ trows, int n_table,
                            uint8_t* __restrict__ k_rows, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    uint64_t w[16];
    hd_load_words(w, r_rows, lane, n);
    hd_load_words(w + 4, trows, idx[lane], n_table);
    if (m_idx != nullptr)
        hd_load_words(w + 8, m_rows, m_idx[lane], n_m);
    else
        hd_load_words(w + 8, m_rows, lane, n);
    w[12] = 0x8000000000000000ull;
    w[13] = 0;
    w[14] = 0;
    w[15] = 8 * 96;
    uint64_t h[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = hd_sha512_h0[i];
    hd_sha512_block(h, w);

    // The digest's bytes are the words big-endian; as a little-endian
    // integer its 32-bit limbs are the byte-swapped halves.
    uint32_t x[16];
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
        x[2 * i] = hd_bswap32((uint32_t)(h[i] >> 32));
        x[2 * i + 1] = hd_bswap32((uint32_t)h[i]);
    }
    uint32_t k[8];
    hd_sc_reduce(k, x);
    uint4* out = reinterpret_cast<uint4*>(k_rows + (size_t)lane * 32);
    out[0] = make_uint4(k[0], k[1], k[2], k[3]);
    out[1] = make_uint4(k[4], k[5], k[6], k[7]);
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
    const int blocks = (n + HD_CHAL_THREADS - 1) / HD_CHAL_THREADS;
    hd_ed25519_challenge_kernel<<<blocks, HD_CHAL_THREADS, 0, (cudaStream_t)stream>>>(
        idx, r_rows, m_rows, m_idx, n_m, trows, n_table, k_rows, n);
    return (int)cudaGetLastError();
}
