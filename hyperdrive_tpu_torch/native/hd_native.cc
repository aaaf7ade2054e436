// Native host-side runtime for the CUDA batch verifier.
//
// The card's verify kernel (hyperdrive_tpu_torch/ops/ed25519.py, kernel in
// hyperdrive_tpu_torch/csrc/ed25519_verify.cu) consumes packed limb
// tensors; producing them requires per-signature work that is bit-twiddly
// and branchy — exactly what the host should do, and exactly what pure
// Python does ~100x too slowly: Ed25519 point decompression (one field
// exponentiation per point), SHA-512 challenge scalars, reduction mod the
// group order, and 13-bit limb / 4-bit nibble packing.
//
// This file is a self-contained C++ implementation of that pipeline with a
// plain C ABI (ctypes-friendly). Semantics are bit-for-bit identical to the
// Python oracle (hyperdrive_tpu_torch/crypto/ed25519.py, RFC 8032 decoding
// rules including the x2 == 0 edge cases); differential tests enforce parity.
//
// Field arithmetic: GF(2^255 - 19) as 5 x 51-bit limbs in uint64, products
// via unsigned __int128 (standard radix-51 representation).

#include <cstdint>
#include <cstring>
#include <mutex>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

namespace {

// ------------------------------------------------------------------ fe25519

constexpr u64 MASK51 = ((u64)1 << 51) - 1;

struct Fe {
  u64 v[5];
};

inline Fe fe_zero() { return Fe{{0, 0, 0, 0, 0}}; }
inline Fe fe_one() { return Fe{{1, 0, 0, 0, 0}}; }

inline Fe fe_add(const Fe &a, const Fe &b) {
  Fe r;
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

// a - b with a pre-bias of 2p (limb-wise dominating), keeping limbs
// non-negative; inputs must have limbs < 2^52.
inline Fe fe_sub(const Fe &a, const Fe &b) {
  Fe r;
  r.v[0] = a.v[0] + 0xFFFFFFFFFFFDAULL - b.v[0];
  r.v[1] = a.v[1] + 0xFFFFFFFFFFFFEULL - b.v[1];
  r.v[2] = a.v[2] + 0xFFFFFFFFFFFFEULL - b.v[2];
  r.v[3] = a.v[3] + 0xFFFFFFFFFFFFEULL - b.v[3];
  r.v[4] = a.v[4] + 0xFFFFFFFFFFFFEULL - b.v[4];
  return r;
}

inline void fe_carry(Fe &r) {
  u64 c;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
  c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
  c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
  c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += c * 19;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

inline Fe fe_mul(const Fe &a, const Fe &b) {
  u128 t0, t1, t2, t3, t4;
  u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19, b4_19 = b4 * 19;

  t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
       (u128)a3 * b2_19 + (u128)a4 * b1_19;
  t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
       (u128)a3 * b3_19 + (u128)a4 * b2_19;
  t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
       (u128)a3 * b4_19 + (u128)a4 * b3_19;
  t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 + (u128)a3 * b0 +
       (u128)a4 * b4_19;
  t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 + (u128)a3 * b1 +
       (u128)a4 * b0;

  Fe r;
  u64 c;
  r.v[0] = (u64)t0 & MASK51; c = (u64)(t0 >> 51);
  t1 += c;
  r.v[1] = (u64)t1 & MASK51; c = (u64)(t1 >> 51);
  t2 += c;
  r.v[2] = (u64)t2 & MASK51; c = (u64)(t2 >> 51);
  t3 += c;
  r.v[3] = (u64)t3 & MASK51; c = (u64)(t3 >> 51);
  t4 += c;
  r.v[4] = (u64)t4 & MASK51; c = (u64)(t4 >> 51);
  r.v[0] += c * 19;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  return r;
}

inline Fe fe_sqr(const Fe &a) { return fe_mul(a, a); }

// Canonical little-endian 32 bytes (value in [0, p)).
inline void fe_tobytes(u8 out[32], const Fe &a) {
  Fe t = a;
  fe_carry(t);
  // Fully reduce: add 19, propagate, then drop bit 255 (classic trick).
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  t.v[4] &= MASK51;

  u64 w0 = t.v[0] | (t.v[1] << 51);
  u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
  u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
  u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(out, &w0, 8);
  memcpy(out + 8, &w1, 8);
  memcpy(out + 16, &w2, 8);
  memcpy(out + 24, &w3, 8);
}

inline Fe fe_frombytes(const u8 in[32]) {
  u64 w0, w1, w2, w3;
  memcpy(&w0, in, 8);
  memcpy(&w1, in + 8, 8);
  memcpy(&w2, in + 16, 8);
  memcpy(&w3, in + 24, 8);
  Fe r;
  r.v[0] = w0 & MASK51;
  r.v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
  r.v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
  r.v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
  r.v[4] = (w3 >> 12) & MASK51;  // drops bit 255 — callers handle the sign
  return r;
}

inline bool fe_iszero(const Fe &a) {
  u8 b[32];
  fe_tobytes(b, a);
  u8 acc = 0;
  for (int i = 0; i < 32; i++) acc |= b[i];
  return acc == 0;
}

inline bool fe_eq(const Fe &a, const Fe &b) {
  u8 x[32], y[32];
  fe_tobytes(x, a);
  fe_tobytes(y, b);
  return memcmp(x, y, 32) == 0;
}

inline bool fe_isodd(const Fe &a) {
  u8 b[32];
  fe_tobytes(b, a);
  return b[0] & 1;
}

// a^(2^n) in place helper.
inline Fe fe_nsqr(Fe a, int n) {
  for (int i = 0; i < n; i++) a = fe_sqr(a);
  return a;
}

// a^(p-5)/8 = a^(2^252 - 3), the exponent of the combined sqrt-division
// trick; standard curve25519 addition chain.
Fe fe_pow22523(const Fe &z) {
  Fe z2 = fe_sqr(z);               // 2
  Fe z8 = fe_nsqr(z2, 2);          // 8
  Fe z9 = fe_mul(z, z8);           // 9
  Fe z11 = fe_mul(z2, z9);         // 11
  Fe z22 = fe_sqr(z11);            // 22
  Fe z_5_0 = fe_mul(z9, z22);      // 2^5 - 2^0
  Fe z_10_0 = fe_mul(fe_nsqr(z_5_0, 5), z_5_0);
  Fe z_20_0 = fe_mul(fe_nsqr(z_10_0, 10), z_10_0);
  Fe z_40_0 = fe_mul(fe_nsqr(z_20_0, 20), z_20_0);
  Fe z_50_0 = fe_mul(fe_nsqr(z_40_0, 10), z_10_0);
  Fe z_100_0 = fe_mul(fe_nsqr(z_50_0, 50), z_50_0);
  Fe z_200_0 = fe_mul(fe_nsqr(z_100_0, 100), z_100_0);
  Fe z_250_0 = fe_mul(fe_nsqr(z_200_0, 50), z_50_0);
  return fe_mul(fe_nsqr(z_250_0, 2), z);  // 2^252 - 3
}

// a^(p-2), for the x2 = u * v^(p-2) edge-case-exact decompression.
Fe fe_invert(const Fe &z) {
  Fe z2 = fe_sqr(z);
  Fe z8 = fe_nsqr(z2, 2);
  Fe z9 = fe_mul(z, z8);
  Fe z11 = fe_mul(z2, z9);
  Fe z22 = fe_sqr(z11);
  Fe z_5_0 = fe_mul(z9, z22);
  Fe z_10_0 = fe_mul(fe_nsqr(z_5_0, 5), z_5_0);
  Fe z_20_0 = fe_mul(fe_nsqr(z_10_0, 10), z_10_0);
  Fe z_40_0 = fe_mul(fe_nsqr(z_20_0, 20), z_20_0);
  Fe z_50_0 = fe_mul(fe_nsqr(z_40_0, 10), z_10_0);
  Fe z_100_0 = fe_mul(fe_nsqr(z_50_0, 50), z_50_0);
  Fe z_200_0 = fe_mul(fe_nsqr(z_100_0, 100), z_100_0);
  Fe z_250_0 = fe_mul(fe_nsqr(z_200_0, 50), z_50_0);
  return fe_mul(fe_nsqr(z_250_0, 5), z11);  // 2^255 - 21 = p - 2
}

// Curve constant d = -121665/121666 mod p (value below computed offline and
// verified by the differential tests against the Python oracle).
const Fe FE_D = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
                  0x739c663a03cbbULL, 0x52036cee2b6ffULL}};
// sqrt(-1) mod p.
const Fe FE_SQRTM1 = {{0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL,
                       0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL,
                       0x2b8324804fc1dULL}};
// p as raw little-endian bytes, for the canonical y < p check.
const u8 P_BYTES[32] = {0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};

// Little-endian compare of 32-byte values: a < b.
inline bool lt_le32(const u8 a[32], const u8 b[32]) {
  for (int i = 31; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return false;
}

// RFC 8032 point decoding, matching the Python oracle exactly:
//   y = enc & (2^255-1); sign = enc >> 255; reject y >= p;
//   x2 = (y^2 - 1) * (d y^2 + 1)^(p-2);
//   if x2 == 0: sign -> reject, else x = 0;
//   else x = x2^((p+3)/8) (via the 22523 chain), fixed up with sqrt(-1);
//   reject if x^2 != x2; flip parity to match sign.
// Returns false if decoding fails; else writes affine x, y.
bool point_decompress(const u8 in[32], Fe &x, Fe &y) {
  u8 ybytes[32];
  memcpy(ybytes, in, 32);
  int sign = ybytes[31] >> 7;
  ybytes[31] &= 0x7f;
  if (!lt_le32(ybytes, P_BYTES)) return false;  // non-canonical y
  y = fe_frombytes(ybytes);

  Fe y2 = fe_sqr(y);
  Fe u = fe_sub(y2, fe_one());      // y^2 - 1
  Fe v = fe_add(fe_mul(FE_D, y2), fe_one());  // d y^2 + 1
  Fe x2 = fe_mul(u, fe_invert(v));  // matches Python: v==0 -> x2 = 0

  if (fe_iszero(x2)) {
    if (sign) return false;
    x = fe_zero();
    return true;
  }

  // Candidate root: x = x2^((p+3)/8) = x2 * x2^((p-5)/8).
  x = fe_mul(x2, fe_pow22523(x2));
  Fe xx = fe_sqr(x);
  if (!fe_eq(xx, x2)) {
    x = fe_mul(x, FE_SQRTM1);
    xx = fe_sqr(x);
    if (!fe_eq(xx, x2)) return false;
  }
  if ((int)fe_isodd(x) != sign) {
    x = fe_sub(fe_zero(), x);
    fe_carry(x);
  }
  return true;
}

// ------------------------------------------------------------------ sha512

const u64 K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

struct Sha512 {
  u64 h[8];
  u8 buf[128];
  u64 total;
  int buflen;

  Sha512() {
    h[0] = 0x6a09e667f3bcc908ULL; h[1] = 0xbb67ae8584caa73bULL;
    h[2] = 0x3c6ef372fe94f82bULL; h[3] = 0xa54ff53a5f1d36f1ULL;
    h[4] = 0x510e527fade682d1ULL; h[5] = 0x9b05688c2b3e6c1fULL;
    h[6] = 0x1f83d9abfb41bd6bULL; h[7] = 0x5be0cd19137e2179ULL;
    total = 0;
    buflen = 0;
  }

  void block(const u8 *p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
      w[i] = ((u64)p[8 * i] << 56) | ((u64)p[8 * i + 1] << 48) |
             ((u64)p[8 * i + 2] << 40) | ((u64)p[8 * i + 3] << 32) |
             ((u64)p[8 * i + 4] << 24) | ((u64)p[8 * i + 5] << 16) |
             ((u64)p[8 * i + 6] << 8) | (u64)p[8 * i + 7];
    }
    for (int i = 16; i < 80; i++) {
      u64 s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
      u64 s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = h[0], b = h[1], c = h[2], d = h[3];
    u64 e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 80; i++) {
      u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      u64 ch = (e & f) ^ (~e & g);
      u64 t1 = hh + S1 + ch + K512[i] + w[i];
      u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      u64 maj = (a & b) ^ (a & c) ^ (b & c);
      u64 t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const u8 *p, size_t n) {
    total += n;
    while (n > 0) {
      size_t take = 128 - buflen;
      if (take > n) take = n;
      memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      n -= take;
      if (buflen == 128) {
        block(buf);
        buflen = 0;
      }
    }
  }

  void final(u8 out[64]) {
    u64 bits = total * 8;
    u8 pad = 0x80;
    update(&pad, 1);
    u8 z = 0;
    while (buflen != 112) update(&z, 1);
    u8 len[16] = {0};
    for (int i = 0; i < 8; i++) len[15 - i] = (u8)(bits >> (8 * i));
    update(len, 16);
    for (int i = 0; i < 8; i++) {
      for (int j = 0; j < 8; j++) out[8 * i + j] = (u8)(h[i] >> (56 - 8 * j));
    }
  }
};

// ------------------------------------------------------------- scalars mod L

// L = 2^252 + 27742317777372353535851937790883648493, little-endian words.
const u64 L_WORDS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                        0x0000000000000000ULL, 0x1000000000000000ULL};

// r < L on 4 LE words.
inline bool sc_lt_l(const u64 r[4]) {
  for (int i = 3; i >= 0; i--) {
    if (r[i] != L_WORDS[i]) return r[i] < L_WORDS[i];
  }
  return false;
}

// Binary long division: 512-bit (8 LE words) mod L -> 4 LE words.
// ~512 cheap word ops per call; exactness over speed (this is a few percent
// of the packing cost; the exponentiations dominate).
//
// Constant-time: signing reduces the secret nonce r and challenge products
// through here, so the per-bit conditional subtract is a branch-free masked
// select — the instruction trace is identical for every input.
void sc_mod_l_512(const u64 x[8], u64 out[4]) {
  u64 r[4] = {0, 0, 0, 0};
  for (int bit = 511; bit >= 0; bit--) {
    // r = (r << 1) | x_bit
    u64 top = r[3] >> 63;
    r[3] = (r[3] << 1) | (r[2] >> 63);
    r[2] = (r[2] << 1) | (r[1] >> 63);
    r[1] = (r[1] << 1) | (r[0] >> 63);
    r[0] = (r[0] << 1) | ((x[bit >> 6] >> (bit & 63)) & 1);
    // top can only be set transiently right after shifting; since r < L <
    // 2^253 before each shift, r_new < 2^254, so top is always 0 — but the
    // masked subtract below is what maintains that invariant.
    u64 t[4], borrow = 0;
    for (int i = 0; i < 4; i++) {
      u128 d = (u128)r[i] - L_WORDS[i] - borrow;
      t[i] = (u64)d;
      borrow = (u64)(d >> 64) & 1;
    }
    // Use t iff the subtraction did not borrow (r >= L) or a bit shifted
    // out (top): mask = all-ones when subtracting.
    u64 mask = 0 - (top | (borrow ^ 1));
    for (int i = 0; i < 4; i++) r[i] ^= mask & (r[i] ^ t[i]);
  }
  memcpy(out, r, 32);
}

// ------------------------------------------------------------ limb packing

// 32-byte LE value -> 20 x 13-bit int32 limbs.
inline void pack_limbs13(const u8 bytes[32], int32_t *out) {
  u8 padded[34];
  memcpy(padded, bytes, 32);
  padded[32] = padded[33] = 0;
  for (int i = 0; i < 20; i++) {
    int bitpos = 13 * i;
    int byte = bitpos >> 3;
    int off = bitpos & 7;
    u32 v = (u32)padded[byte] | ((u32)padded[byte + 1] << 8) |
            ((u32)padded[byte + 2] << 16);
    out[i] = (int32_t)((v >> off) & 0x1FFF);
  }
}

// 32-byte LE scalar -> 64 x 4-bit nibbles (int32).
inline void pack_nibbles(const u8 bytes[32], int32_t *out) {
  for (int i = 0; i < 32; i++) {
    out[2 * i] = bytes[i] & 0xF;
    out[2 * i + 1] = bytes[i] >> 4;
  }
}

// ------------------------------------------------- decompressed-point cache
//
// Validator sets are small (hundreds) while batches are huge; pubkey
// decompression repeats endlessly. A tiny open-addressing cache keyed by the
// 32 raw bytes eliminates it. R points are per-signature (never cached).

struct CacheEntry {
  u8 key[32];
  u8 valid;    // entry holds a successful decompression
  u8 occupied;
  Fe x, y;
};

constexpr int CACHE_SLOTS = 1 << 12;  // 4096 entries, plenty for one set
CacheEntry g_cache[CACHE_SLOTS];
// ctypes releases the GIL during hd_pack_batch, and each replica may run on
// its own thread — all cache reads/writes happen under this mutex (the
// guarded work is a memcmp/memcpy; the expensive decompression of a missed
// key runs outside the lock).
std::mutex g_cache_mu;

inline u32 cache_hash(const u8 key[32]) {
  u32 h;
  memcpy(&h, key, 4);  // pubkeys are uniformly random — low bytes suffice
  return h & (CACHE_SLOTS - 1);
}

// Returns 1 valid / 0 invalid, filling x, y on success.
int cached_decompress(const u8 key[32], Fe &x, Fe &y) {
  u32 slot = cache_hash(key);
  int free_slot = -1;
  {
    std::lock_guard<std::mutex> lock(g_cache_mu);
    for (int probe = 0; probe < 8; probe++) {
      int idx = (slot + probe) & (CACHE_SLOTS - 1);
      CacheEntry &e = g_cache[idx];
      if (!e.occupied) {
        free_slot = idx;
        break;
      }
      if (memcmp(e.key, key, 32) == 0) {
        if (!e.valid) return 0;
        x = e.x;
        y = e.y;
        return 1;
      }
    }
  }
  bool ok = point_decompress(key, x, y);
  if (free_slot >= 0) {
    std::lock_guard<std::mutex> lock(g_cache_mu);
    CacheEntry &e = g_cache[free_slot];
    if (!e.occupied) {  // another thread may have claimed it meanwhile
      memcpy(e.key, key, 32);
      e.valid = ok ? 1 : 0;
      if (ok) {
        e.x = x;
        e.y = y;
      }
      e.occupied = 1;
    }
  }
  return ok ? 1 : 0;
}

// ------------------------------------------------------- point arithmetic
//
// Extended homogeneous coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z,
// T = XY/Z on -x^2 + y^2 = 1 + d x^2 y^2 — the same unified a = -1
// formulas as the Python oracle and the verify kernel.

struct Pt {
  Fe x, y, z, t;
};

const Fe FE_2D = {{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
                   0x6738cc7407977ULL, 0x2406d9dc56dffULL}};  // 2d mod p

inline Pt pt_identity() {
  return Pt{fe_zero(), fe_one(), fe_one(), fe_zero()};
}

Pt pt_add(const Pt &p, const Pt &q) {
  Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  Fe c = fe_mul(fe_mul(p.t, FE_2D), q.t);
  Fe zz = fe_mul(p.z, q.z);
  Fe d = fe_add(zz, zz);
  Fe e = fe_sub(b, a);
  Fe f = fe_sub(d, c);
  Fe g = fe_add(d, c);
  Fe h = fe_add(b, a);
  return Pt{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

Pt pt_double(const Pt &p) { return pt_add(p, p); }

inline void fe_cmov(Fe &r, const Fe &a, u64 mask) {
  for (int i = 0; i < 5; i++) r.v[i] ^= mask & (r.v[i] ^ a.v[i]);
}

inline void pt_cmov(Pt &r, const Pt &a, u64 mask) {
  fe_cmov(r.x, a.x, mask);
  fe_cmov(r.y, a.y, mask);
  fe_cmov(r.z, a.z, mask);
  fe_cmov(r.t, a.t, mask);
}

// Scalar multiplication, 4-bit fixed windows (Horner from the top digit):
// ~252 doublings + 63 additions + a 16-entry table. One ladder serves both
// trust models; only the table-lookup step differs:
//
// - kConstTime=false: direct indexed lookup. For public scalars only
//   (verification: s, k are attacker-known).
// - kConstTime=true: reads all 16 entries and selects with branch-free
//   masked moves, so neither the memory trace nor the branch pattern
//   depends on the scalar. For secret scalars (signing / key derivation).
//   The field arithmetic itself (fe_mul etc.) is already constant-time
//   (fixed-shape u64 limb schoolbook, no secret branches), and the only
//   branch in the ladder is on the loop index.
template <bool kConstTime>
Pt pt_scalar_mul_impl(const u8 scalar_le[32], const Pt &base) {
  Pt table[16];
  table[0] = pt_identity();
  for (int i = 1; i < 16; i++) table[i] = pt_add(table[i - 1], base);
  Pt acc = pt_identity();
  for (int i = 31; i >= 0; i--) {
    for (int half = 1; half >= 0; half--) {
      u64 digit = (u64)((scalar_le[i] >> (4 * half)) & 0xF);
      if (!(i == 31 && half == 1)) {  // loop-index branch, not secret
        acc = pt_double(acc);
        acc = pt_double(acc);
        acc = pt_double(acc);
        acc = pt_double(acc);
      }
      if constexpr (kConstTime) {
        Pt entry = table[0];
        for (u64 j = 1; j < 16; j++) {
          u64 eq = digit ^ j;  // 0 iff j == digit
          u64 mask = (u64)(((eq | (0 - eq)) >> 63) ^ 1) * ~0ULL;
          pt_cmov(entry, table[j], mask);
        }
        acc = pt_add(acc, entry);
      } else {
        acc = pt_add(acc, table[digit]);
      }
    }
  }
  return acc;
}

Pt pt_scalar_mul(const u8 scalar_le[32], const Pt &base) {
  return pt_scalar_mul_impl<false>(scalar_le, base);
}

Pt pt_scalar_mul_ct(const u8 scalar_le[32], const Pt &base) {
  return pt_scalar_mul_impl<true>(scalar_le, base);
}

// Projective equality: X1 Z2 == X2 Z1 && Y1 Z2 == Y2 Z1.
bool pt_equal(const Pt &p, const Pt &q) {
  return fe_eq(fe_mul(p.x, q.z), fe_mul(q.x, p.z)) &&
         fe_eq(fe_mul(p.y, q.z), fe_mul(q.y, p.z));
}

// Base point B (y = 4/5, even x), affine limbs precomputed offline and
// cross-checked by the differential tests.
const Pt PT_BASE = {
    {{0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL,
      0x1ff60527118feULL, 0x216936d3cd6e5ULL}},
    {{0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL,
      0x3333333333333ULL, 0x6666666666666ULL}},
    {{1, 0, 0, 0, 0}},
    {{0x68ab3a5b7dda3ULL, 0xeea2a5eadbbULL, 0x2af8df483c27eULL,
      0x332b375274732ULL, 0x67875f0fd78b7ULL}},
};

inline void pt_compress(u8 out[32], const Pt &p) {
  Fe zinv = fe_invert(p.z);
  Fe x = fe_mul(p.x, zinv);
  Fe y = fe_mul(p.y, zinv);
  fe_tobytes(out, y);
  out[31] |= (u8)(fe_isodd(x) << 7);
}

// s = (a + b * c) mod L on little-endian 32-byte scalars (all < L).
void sc_muladd(u8 out[32], const u8 a[32], const u8 b[32], const u8 c[32]) {
  // Schoolbook 256x256 -> 512-bit product of b*c, plus a, then mod L.
  u64 bw[4], cw[4], aw[4];
  memcpy(bw, b, 32);
  memcpy(cw, c, 32);
  memcpy(aw, a, 32);
  u64 prod[8] = {0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      carry += (u128)bw[i] * cw[j] + prod[i + j];
      prod[i + j] = (u64)carry;
      carry >>= 64;
    }
    prod[i + 4] = (u64)carry;
  }
  u128 carry = 0;
  for (int i = 0; i < 4; i++) {
    carry += (u128)prod[i] + aw[i];
    prod[i] = (u64)carry;
    carry >>= 64;
  }
  // Fixed-shape carry propagation (no early exit): the inputs are the
  // secret nonce and secret-key products, so whether the carry ripples
  // must not show in the branch pattern.
  for (int i = 4; i < 8; i++) {
    carry += prod[i];
    prod[i] = (u64)carry;
    carry >>= 64;
  }
  u64 r[4];
  sc_mod_l_512(prod, r);
  memcpy(out, r, 32);
}

// Full RFC 8032 verification of one signature (host CPU path).
bool verify_one(const u8 pub[32], const u8 *msg, size_t msg_len,
                const u8 sig[64]) {
  Fe ax, ay;
  if (!cached_decompress(pub, ax, ay)) return false;
  Fe rx, ry;
  if (!point_decompress(sig, rx, ry)) return false;
  u64 s_words[4];
  memcpy(s_words, sig + 32, 32);
  if (!sc_lt_l(s_words)) return false;

  Sha512 h;
  h.update(sig, 32);
  h.update(pub, 32);
  h.update(msg, msg_len);
  u8 kh[64];
  h.final(kh);
  u64 kw[8], kr[4];
  memcpy(kw, kh, 64);
  sc_mod_l_512(kw, kr);
  u8 kbytes[32];
  memcpy(kbytes, kr, 32);

  Pt a{ax, ay, fe_one(), fe_mul(ax, ay)};
  Pt r{rx, ry, fe_one(), fe_mul(rx, ry)};
  Pt sb = pt_scalar_mul(sig + 32, PT_BASE);
  Pt ka = pt_scalar_mul(kbytes, a);
  Pt rka = pt_add(r, ka);
  return pt_equal(sb, rka);
}

}  // namespace

// ------------------------------------------------------------------- C ABI

extern "C" {

// Self-test hook: decompress one point; returns 1 valid / 0 invalid and
// writes canonical affine x||y bytes (32+32).
int hd_decompress(const u8 *in, u8 *xy_out) {
  Fe x, y;
  if (!point_decompress(in, x, y)) return 0;
  fe_tobytes(xy_out, x);
  fe_tobytes(xy_out + 32, y);
  return 1;
}

// SHA-512 of a buffer (self-test hook).
void hd_sha512(const u8 *in, size_t n, u8 *out64) {
  Sha512 h;
  h.update(in, n);
  h.final(out64);
}

// 512-bit LE bytes mod L -> 32 LE bytes (self-test hook).
void hd_mod_l(const u8 *in64, u8 *out32) {
  u64 x[8];
  memcpy(x, in64, 64);
  u64 r[4];
  sc_mod_l_512(x, r);
  memcpy(out32, r, 32);
}

// Derive the public key (compressed point) from a 32-byte seed.
void hd_public_from_seed(const u8 *seed, u8 *pub_out) {
  u8 h[64];
  Sha512 sh;
  sh.update(seed, 32);
  sh.final(h);
  h[0] &= 248;
  h[31] &= 127;
  h[31] |= 64;
  pt_compress(pub_out, pt_scalar_mul_ct(h, PT_BASE));
}

// RFC 8032 Ed25519 signing: out = R (32B) || s (32B LE). ``pub_opt`` may
// carry the caller's cached public key (it is always derivable from the
// seed, but deriving costs a full base-point scalar multiplication —
// callers that hold a KeyPair skip it); pass NULL to derive.
void hd_sign(const u8 *seed, const u8 *pub_opt, const u8 *msg, size_t msg_len,
             u8 *sig_out) {
  u8 h[64];
  Sha512 sh;
  sh.update(seed, 32);
  sh.final(h);
  u8 a_scalar[32];
  memcpy(a_scalar, h, 32);
  a_scalar[0] &= 248;
  a_scalar[31] &= 127;
  a_scalar[31] |= 64;
  u8 pub[32];
  if (pub_opt) {
    memcpy(pub, pub_opt, 32);
  } else {
    pt_compress(pub, pt_scalar_mul_ct(a_scalar, PT_BASE));
  }

  // r = SHA-512(prefix || msg) mod L.
  Sha512 hr;
  hr.update(h + 32, 32);
  hr.update(msg, msg_len);
  u8 rh[64];
  hr.final(rh);
  u64 rw[8], rr[4];
  memcpy(rw, rh, 64);
  sc_mod_l_512(rw, rr);
  u8 rbytes[32];
  memcpy(rbytes, rr, 32);
  pt_compress(sig_out, pt_scalar_mul_ct(rbytes, PT_BASE));

  // k = SHA-512(R || A || msg) mod L.
  Sha512 hk;
  hk.update(sig_out, 32);
  hk.update(pub, 32);
  hk.update(msg, msg_len);
  u8 kh[64];
  hk.final(kh);
  u64 kw[8], kr[4];
  memcpy(kw, kh, 64);
  sc_mod_l_512(kw, kr);
  u8 kbytes[32];
  memcpy(kbytes, kr, 32);

  // s = (r + k * a) mod L. The clamped a is < 2^255 but not < L; reduce it
  // first so sc_muladd's inputs satisfy its contract.
  u64 aw8[8] = {0}, ar[4];
  memcpy(aw8, a_scalar, 32);
  sc_mod_l_512(aw8, ar);
  u8 abytes[32];
  memcpy(abytes, ar, 32);
  sc_muladd(sig_out + 32, rbytes, kbytes, abytes);
}

// Batch verification on the host CPU (the wire-speed fallback when no
// device is attached). Layout mirrors hd_pack_batch; out[i] = 1 iff item i
// is well-formed and its signature verifies.
int hd_verify_batch(const u8 *pubs, const u8 *digests, const int32_t *digest_lens,
                    int dstride, const u8 *sigs, const u8 *in_ok, int n,
                    u8 *out) {
  for (int i = 0; i < n; i++) {
    out[i] = 0;
    if (in_ok && !in_ok[i]) continue;
    out[i] = verify_one(pubs + 32 * i, digests + (size_t)dstride * i,
                        (size_t)digest_lens[i], sigs + 64 * i)
                 ? 1
                 : 0;
  }
  return 0;
}

// Single-shot verify (self-test hook / small paths).
int hd_verify_one(const u8 *pub, const u8 *msg, size_t msg_len, const u8 *sig) {
  return verify_one(pub, msg, msg_len, sig) ? 1 : 0;
}

// Reset the pubkey decompression cache (e.g. between unrelated tests).
void hd_cache_clear(void) {
  std::lock_guard<std::mutex> lock(g_cache_mu);
  memset(g_cache, 0, sizeof(g_cache));
}

// The batch packer. For each of n items (pub[i*32..], digest[i*dstride..]
// of length digest_lens[i], sig[i*64..]) with in_ok[i] != 0:
//   - decompress A (cached) and R; range-check s < L;
//   - compute k = SHA-512(R || A || digest) mod L;
//   - write -A (limbs of x(-A), y, t = x*y), R (x, y), s and k nibbles into
//     row i of the output arrays;
//   - prevalid[i] = 1.
// Rows that fail any host check (or have in_ok[i] == 0) are left untouched
// (callers pre-zero the buffers) with prevalid[i] = 0.
// Output layouts match Ed25519BatchHost.pack
// (hyperdrive_tpu_torch/ops/ed25519.py): limb arrays are int32
// [*, 20] rows, nibble arrays int32 [*, 64] rows.
int hd_pack_batch(const u8 *pubs, const u8 *digests, const int32_t *digest_lens,
                  int dstride, const u8 *sigs, const u8 *in_ok, int n,
                  int32_t *ax, int32_t *ay, int32_t *at, int32_t *rx,
                  int32_t *ry, int32_t *s_nib, int32_t *k_nib, u8 *prevalid) {
  for (int i = 0; i < n; i++) {
    prevalid[i] = 0;
    if (in_ok && !in_ok[i]) continue;
    const u8 *pub = pubs + 32 * i;
    const u8 *digest = digests + (size_t)dstride * i;
    const u8 *sig = sigs + 64 * i;

    Fe ax_f, ay_f;
    if (!cached_decompress(pub, ax_f, ay_f)) continue;
    Fe rx_f, ry_f;
    if (!point_decompress(sig, rx_f, ry_f)) continue;

    u64 s_words[4];
    memcpy(s_words, sig + 32, 32);
    if (!sc_lt_l(s_words)) continue;

    // k = SHA-512(R || A || M) mod L.
    Sha512 h;
    h.update(sig, 32);
    h.update(pub, 32);
    h.update(digest, (size_t)digest_lens[i]);
    u8 kh[64];
    h.final(kh);
    u64 kw[8];
    memcpy(kw, kh, 64);
    u64 kr[4];
    sc_mod_l_512(kw, kr);
    u8 kbytes[32];
    memcpy(kbytes, kr, 32);

    // Negate A: x -> p - x (0 stays 0 — fe_sub + carry is canonicalized by
    // fe_tobytes below).
    Fe nax = fe_sub(fe_zero(), ax_f);
    Fe nat = fe_mul(nax, ay_f);

    u8 b[32];
    fe_tobytes(b, nax);
    pack_limbs13(b, ax + (size_t)i * 20);
    fe_tobytes(b, ay_f);
    pack_limbs13(b, ay + (size_t)i * 20);
    fe_tobytes(b, nat);
    pack_limbs13(b, at + (size_t)i * 20);
    fe_tobytes(b, rx_f);
    pack_limbs13(b, rx + (size_t)i * 20);
    fe_tobytes(b, ry_f);
    pack_limbs13(b, ry + (size_t)i * 20);
    pack_nibbles(sig + 32, s_nib + (size_t)i * 64);
    pack_nibbles(kbytes, k_nib + (size_t)i * 64);
    prevalid[i] = 1;
  }
  return 0;
}

// The wire packer: the host half of the device-decompression verify path
// (hyperdrive_tpu_torch/ops/ed25519_wire.py). Point decompression — the
// expensive field exponentiations that dominate hd_pack_batch — moves to
// the device; this loop keeps only the cheap checks and the challenge
// hash. For each item with in_ok[i] != 0:
//   - reject non-canonical y encodings of A and R (y >= p, sign masked);
//   - range-check s < L;
//   - compute k = SHA-512(R || A || digest) mod L;
//   - copy pub/R/s/k into 32-byte rows of the four output arrays.
// Rows failing any check keep prevalid[i] = 0 (buffers pre-zeroed by the
// caller). Throughput is hash+mod-L bound: no Fe math at all.
int hd_pack_wire(const u8 *pubs, const u8 *digests, const int32_t *digest_lens,
                 int dstride, const u8 *sigs, const u8 *in_ok, int n,
                 u8 *a_rows, u8 *r_rows, u8 *s_rows, u8 *k_rows,
                 u8 *prevalid) {
  for (int i = 0; i < n; i++) {
    prevalid[i] = 0;
    if (in_ok && !in_ok[i]) continue;
    const u8 *pub = pubs + 32 * i;
    const u8 *sig = sigs + 64 * i;

    u8 ymasked[32];
    memcpy(ymasked, pub, 32);
    ymasked[31] &= 0x7f;
    if (!lt_le32(ymasked, P_BYTES)) continue;
    memcpy(ymasked, sig, 32);
    ymasked[31] &= 0x7f;
    if (!lt_le32(ymasked, P_BYTES)) continue;

    u64 s_words[4];
    memcpy(s_words, sig + 32, 32);
    if (!sc_lt_l(s_words)) continue;

    Sha512 h;
    h.update(sig, 32);
    h.update(pub, 32);
    h.update(digests + (size_t)dstride * i, (size_t)digest_lens[i]);
    u8 kh[64];
    h.final(kh);
    u64 kw[8], kr[4];
    memcpy(kw, kh, 64);
    sc_mod_l_512(kw, kr);

    memcpy(a_rows + (size_t)32 * i, pub, 32);
    memcpy(r_rows + (size_t)32 * i, sig, 32);
    memcpy(s_rows + (size_t)32 * i, sig + 32, 32);
    memcpy(k_rows + (size_t)32 * i, kr, 32);
    prevalid[i] = 1;
  }
  return 0;
}

}  // extern "C"
