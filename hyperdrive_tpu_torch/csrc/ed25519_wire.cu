// Batched Ed25519 verification from wire bytes on Hopper: the ports of the
// TPU kernels _wire_kernel_body / _wire_kernel_inner (hyperdrive_tpu/ops/
// ed25519_pallas.py:486/493) and _semiwire_kernel_body /
// _semiwire_kernel_inner (:522/529), on the field of fe25519_w32.cuh, the
// decompression of decompress.cuh and the four-thread ladder of
// ladder4.cuh.
//
// Layout: the wire packer's rows go in as they are, [B, 32] uint8 A, R, s
// and k rows (and for the semiwire kernel an int32 [B] table index plus the
// validator table's [V, 20] int32 -A coordinates, 13-bit limbs, and [V]
// bool valid mask). Four consecutive threads verify one signature; a block
// is one warp, 8 signatures, and there are ceil(B / 8) blocks. The TPU
// layout (limb-major [20, block] tiles, the VMEM table scratch, the
// block-multiple batch) is not carried over.
//
// What bounds them: 32-bit multiply instructions. A signature's ladder is
// about 2,800 field multiplications or squarings and a decompression 273
// more; bytes are 129 a lane (wire) and 342 (semiwire: idx, R, s, k rows,
// the table row and its valid byte), about 1e-3 of the time. The design
// cuts the multiplies and the dependent chain: full-radix 32-bit limbs on
// carry chains (146 multiply instructions a product against the TPU
// field's 423), the four products of each round of a point formula on four
// threads at once, the wire kernel's two decompressions side by side (A on
// threads 0 and 2, R on 1 and 3), and no local memory: field elements in
// registers, the [0..8]A' table, the B table and the signed digits in
// shared memory.
//
// Why not tensor cores or TMA: every signature multiplies its own pair of
// 256-bit numbers, a batch of independent products with no shared operand,
// not a matrix product; and the input bytes take about 1e-3 of the time.
//
// No thread returns before the last shuffle: a lane past the batch works
// on lane 0's rows and a semiwire lane whose index lies outside the table
// on zeros; only their store is dropped or their verdict forced to 0.
#include <cuda_runtime.h>

#include "decompress.cuh"
#include "ladder4.cuh"

// Threads 0 and 1 of the group recode s and k into the group's digits.
HD_INL void hd_stage_digits(l4_shared& sm, int g, int j,
                            const uint8_t* s_row, const uint8_t* k_row) {
    if (j < 2) l4_recode(sm.dig[g][j], j == 0 ? s_row : k_row);
}

// ok = ladder && ok_A && ok_R, with A and R decompressed here and A negated
// (x -> -x, t = x' y), as the packed path's host packer does.
__global__ void __launch_bounds__(L4_THREADS)
hd_ed25519_wire_kernel(const uint8_t* __restrict__ a_rows,
                       const uint8_t* __restrict__ r_rows,
                       const uint8_t* __restrict__ s_rows,
                       const uint8_t* __restrict__ k_rows,
                       uint8_t* __restrict__ ok, int n) {
    __shared__ l4_shared sm;
    l4_stage_btab(sm);
    const int j = threadIdx.x & (L4_GROUP - 1);
    const int g = threadIdx.x / L4_GROUP;
    const int sig = blockIdx.x * L4_SIGS + g;
    const bool live = sig < n;
    const size_t r32 = (size_t)(live ? sig : 0) * 32;
    hd_stage_digits(sm, g, j, s_rows + r32, k_rows + r32);
    __syncthreads();

    fe8 py, px;
    int sign = fe8_from_row(py, ((j & 1) ? r_rows : a_rows) + r32);
    bool pok = fe8_decompress(px, py, sign);
    fe8 nax = fe8_neg(l4_shfl(px, 0));
    fe8 ay = l4_shfl(py, 0);
    fe8 rx = l4_shfl(px, 1);
    fe8 ry = l4_shfl(py, 1);
    bool ok_a = l4_shfl_bool(pok, 0);
    bool ok_r = l4_shfl_bool(pok, 1);
    fe8 nat = fe8_mul(nax, ay);
    bool ok_l = l4_ladder_ok(nax, ay, nat, rx, ry, sm.dig[g][0], sm.dig[g][1],
                             sm.atab, sm.btab);
    if (j == 0 && live) ok[sig] = (ok_l && ok_a && ok_r) ? 1 : 0;
}

// ok = ladder && ok_R && tvalid[idx], with -A read from the validator table
// row idx (converted to the 8 x 32-bit field by value) and R decompressed
// here on all four threads of the group.
__global__ void __launch_bounds__(L4_THREADS)
hd_ed25519_semiwire_kernel(const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ r_rows,
                           const uint8_t* __restrict__ s_rows,
                           const uint8_t* __restrict__ k_rows,
                           const int32_t* __restrict__ tnax,
                           const int32_t* __restrict__ tay,
                           const int32_t* __restrict__ tnat,
                           const uint8_t* __restrict__ tvalid, int n_table,
                           uint8_t* __restrict__ ok, int n) {
    __shared__ l4_shared sm;
    l4_stage_btab(sm);
    const int j = threadIdx.x & (L4_GROUP - 1);
    const int g = threadIdx.x / L4_GROUP;
    const int sig = blockIdx.x * L4_SIGS + g;
    const bool live = sig < n;
    const size_t r32 = (size_t)(live ? sig : 0) * 32;
    hd_stage_digits(sm, g, j, s_rows + r32, k_rows + r32);
    __syncthreads();

    const int v = live ? idx[sig] : -1;
    const bool in_table = v >= 0 && v < n_table;
    fe8 nax = fe8_small(0), ay = fe8_small(0), nat = fe8_small(0);
    bool valid = false;
    if (in_table) {
        const size_t t20 = (size_t)v * 20;
        nax = fe8_from_limbs13(tnax + t20);
        ay = fe8_from_limbs13(tay + t20);
        nat = fe8_from_limbs13(tnat + t20);
        valid = tvalid[v] != 0;
    }
    fe8 ry, rx;
    int r_sign = fe8_from_row(ry, r_rows + r32);
    bool ok_r = fe8_decompress(rx, ry, r_sign);
    bool ok_l = l4_ladder_ok(nax, ay, nat, rx, ry, sm.dig[g][0], sm.dig[g][1],
                             sm.atab, sm.btab);
    if (j == 0 && live) ok[sig] = (ok_l && ok_r && valid) ? 1 : 0;
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
    hd_ed25519_wire_kernel<<<l4_blocks(n), L4_THREADS, 0, (cudaStream_t)stream>>>(
        a_rows, r_rows, s_rows, k_rows, ok, n);
    return (int)cudaGetLastError();
}

// Enqueue the semiwire kernel on `stream` of the current device (n >= 1).
static cudaError_t hd_semiwire_enqueue(const int32_t* idx, const uint8_t* r_rows,
                                       const uint8_t* s_rows, const uint8_t* k_rows,
                                       const int32_t* tnax, const int32_t* tay,
                                       const int32_t* tnat, const uint8_t* tvalid,
                                       int n_table, uint8_t* ok, int n,
                                       cudaStream_t stream) {
    hd_ed25519_semiwire_kernel<<<l4_blocks(n), L4_THREADS, 0, stream>>>(
        idx, r_rows, s_rows, k_rows, tnax, tay, tnat, tvalid, n_table, ok, n);
    return cudaGetLastError();
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
    return (int)hd_semiwire_enqueue(idx, r_rows, s_rows, k_rows, tnax, tay, tnat, tvalid,
                                    n_table, ok, n, (cudaStream_t)stream);
}
