// Batched Ed25519 verification from wire bytes on Hopper: the ports of the
// TPU kernels _wire_kernel_body / _wire_kernel_inner (hyperdrive_tpu/ops/
// ed25519_pallas.py:486/493) and _semiwire_kernel_body /
// _semiwire_kernel_inner (:522/529). Both run the ladder of ladder.cuh,
// the one shared with ed25519_verify.cu, after decompress.cuh.
//
// Layout: the wire packer's rows go in as they are, [B, 32] uint8 A, R, s
// and k rows (and for the semiwire kernel an int32 [B] table index plus the
// validator table's [V, 20] int32 -A coordinates and [V] bool valid mask).
// Each thread unpacks its own rows (limbs_from_rows: bit 255 cleared and
// taken as the sign; the nibble split; the signed recode), one thread per
// signature, HD_WIRE_THREADS threads a block, a masked tail. The TPU layout
// (limb-major [20, block] tiles, the VMEM table scratch, the block-multiple
// batch) is not carried over. The semiwire kernel reads its table row by
// index itself and ANDs the slot's valid bit; an index outside [0, V)
// reads nothing and rejects (the wrapper's caller checks indices on the
// host before upload, so this costs no synchronization).
//
// What bounds them: integer multiplies, as for ed25519_verify.cu. The
// ladder is about 1.0M 32-bit multiply-adds a signature; each
// decompression adds 255 squarings and 18 multiplications (about 67k
// more). The wire kernel decompresses two points, the semiwire kernel one.
// Bytes (128 B in a lane for the wire kernel, about 68 B plus the table
// row for the semiwire kernel, 1 B out) are negligible. At the main path's
// shapes (one 256-lane vote window, 8 warps) the time is set by each
// thread's dependent chain, far above that bound. The design keeps
// ed25519_verify.cu's answers (unrolled field loops, one-warp blocks so a
// small batch spreads over SMs, the B table staged into shared memory) and
// keeps the decompression and its pow22523 chain out of line with rolled
// squaring loops, so the kernels add little to the ladder's registers and
// code. Splitting a signature across threads is later work.
#include <cuda_runtime.h>

#include "decompress.cuh"
#include "ladder.cuh"

constexpr int HD_WIRE_THREADS = 32;

// limbs_from_rows for one 32-byte little-endian field encoding: 20 limbs of
// 13 bits with bit 255 cleared. Returns the sign (bit 255).
HD_INL int hd_limbs_from_row(int32_t* y, const uint8_t* __restrict__ row) {
    int32_t b[34];
    #pragma unroll
    for (int i = 0; i < 32; ++i) b[i] = row[i];
    int sign = b[31] >> 7;
    b[31] &= 0x7F;
    b[32] = 0;
    b[33] = 0;
    #pragma unroll
    for (int i = 0; i < FE_N; ++i) {
        const int bit = 13 * i, byte = bit >> 3, off = bit & 7;
        int32_t v = b[byte] | (b[byte + 1] << 8) | (b[byte + 2] << 16);
        y[i] = (v >> off) & FE_MASK;
    }
    return sign;
}

// nibbles_from_rows and the signed recode of one 32-byte little-endian
// scalar.
HD_INL void hd_recode_row(int8_t* out, const uint8_t* __restrict__ row) {
    int32_t nib[64];
    #pragma unroll
    for (int i = 0; i < 32; ++i) {
        int32_t b = row[i];
        nib[2 * i] = b & 0xF;
        nib[2 * i + 1] = b >> 4;
    }
    hd_recode_signed(out, nib);
}

// ok = ladder && ok_A && ok_R, with A and R decompressed here and A negated
// (x -> p - x, t = x' * y), as the packed path's host packer does.
__global__ void __launch_bounds__(HD_WIRE_THREADS)
hd_ed25519_wire_kernel(const uint8_t* __restrict__ a_rows,
                       const uint8_t* __restrict__ r_rows,
                       const uint8_t* __restrict__ s_rows,
                       const uint8_t* __restrict__ k_rows,
                       uint8_t* __restrict__ ok, int n) {
    __shared__ int32_t btab[HD_C_BTAB_LEN];
    for (int i = threadIdx.x; i < HD_C_BTAB_LEN; i += blockDim.x)
        btab[i] = hd_consts[HD_C_BTAB + i];
    __syncthreads();

    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    size_t r32 = (size_t)lane * 32;
    int32_t ay[FE_N], ry[FE_N], nax[FE_N], rx[FE_N], nat[FE_N];
    int a_sign = hd_limbs_from_row(ay, a_rows + r32);
    int r_sign = hd_limbs_from_row(ry, r_rows + r32);
    bool ok_a = hd_decompress(nax, ay, a_sign);
    bool ok_r = hd_decompress(rx, ry, r_sign);
    fe_neg(nax, nax);
    fe_mul(nat, nax, ay);
    int8_t sd[64], kd[64];
    hd_recode_row(sd, s_rows + r32);
    hd_recode_row(kd, k_rows + r32);
    bool ok_l = hd_ladder_ok(nax, ay, nat, rx, ry, sd, kd, btab);
    ok[lane] = (ok_l && ok_a && ok_r) ? 1 : 0;
}

// ok = ladder && ok_R && tvalid[idx], with -A read from the validator table
// row idx and R decompressed here.
__global__ void __launch_bounds__(HD_WIRE_THREADS)
hd_ed25519_semiwire_kernel(const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ r_rows,
                           const uint8_t* __restrict__ s_rows,
                           const uint8_t* __restrict__ k_rows,
                           const int32_t* __restrict__ tnax,
                           const int32_t* __restrict__ tay,
                           const int32_t* __restrict__ tnat,
                           const uint8_t* __restrict__ tvalid, int n_table,
                           uint8_t* __restrict__ ok, int n) {
    __shared__ int32_t btab[HD_C_BTAB_LEN];
    for (int i = threadIdx.x; i < HD_C_BTAB_LEN; i += blockDim.x)
        btab[i] = hd_consts[HD_C_BTAB + i];
    __syncthreads();

    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    int v = idx[lane];
    if (v < 0 || v >= n_table) {
        ok[lane] = 0;
        return;
    }
    size_t r32 = (size_t)lane * 32;
    size_t t20 = (size_t)v * FE_N;
    int32_t nax[FE_N], ay[FE_N], nat[FE_N], ry[FE_N], rx[FE_N];
    for (int i = 0; i < FE_N; ++i) {
        nax[i] = tnax[t20 + i];
        ay[i] = tay[t20 + i];
        nat[i] = tnat[t20 + i];
    }
    int r_sign = hd_limbs_from_row(ry, r_rows + r32);
    bool ok_r = hd_decompress(rx, ry, r_sign);
    int8_t sd[64], kd[64];
    hd_recode_row(sd, s_rows + r32);
    hd_recode_row(kd, k_rows + r32);
    bool ok_l = hd_ladder_ok(nax, ay, nat, rx, ry, sd, kd, btab);
    ok[lane] = (ok_l && ok_r && tvalid[v]) ? 1 : 0;
}

// Enqueue one wire verification of n lanes on `stream` of `device`; never
// synchronizes. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hd_ed25519_wire_verify(int device, const uint8_t* a_rows,
                                      const uint8_t* r_rows, const uint8_t* s_rows,
                                      const uint8_t* k_rows, uint8_t* ok, int n,
                                      void* stream) {
    if (n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n + HD_WIRE_THREADS - 1) / HD_WIRE_THREADS;
    hd_ed25519_wire_kernel<<<blocks, HD_WIRE_THREADS, 0, (cudaStream_t)stream>>>(
        a_rows, r_rows, s_rows, k_rows, ok, n);
    return (int)cudaGetLastError();
}

// Enqueue one indexed (semiwire) verification of n lanes against a table of
// n_table slots; as above.
extern "C" int hd_ed25519_semiwire_verify(int device, const int32_t* idx,
                                          const uint8_t* r_rows, const uint8_t* s_rows,
                                          const uint8_t* k_rows, const int32_t* tnax,
                                          const int32_t* tay, const int32_t* tnat,
                                          const uint8_t* tvalid, int n_table,
                                          uint8_t* ok, int n, void* stream) {
    if (n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n + HD_WIRE_THREADS - 1) / HD_WIRE_THREADS;
    hd_ed25519_semiwire_kernel<<<blocks, HD_WIRE_THREADS, 0, (cudaStream_t)stream>>>(
        idx, r_rows, s_rows, k_rows, tnax, tay, tnat, tvalid, n_table, ok, n);
    return (int)cudaGetLastError();
}
