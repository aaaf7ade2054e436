// The kernel library's one translation unit. The constant block
// hd_consts_w32 (fe25519_w32.cuh) is a static __constant__, one copy per
// translation unit, so the four kernels compile together here: one build,
// one constant upload per device. The challenge routes' host entry, which
// enqueues two of them in one call, lives here too.
#include "ed25519_verify.cu"
#include "ed25519_wire.cu"
#include "ed25519_challenge.cu"

// Upload the constant block (layout in fe25519_w32.cuh) to `device`.
// Returns a cudaError_t. The library links its own CUDA runtime, whose
// current device is per runtime, so every entry point selects the device
// itself.
extern "C" int hd_ed25519_set_consts(int device, const uint32_t* host) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyToSymbol(hd_consts_w32, host, sizeof(uint32_t) * HD_W_TOTAL);
}

// The challenge routes' one host call: enqueue the challenge kernel (k into
// the caller's k_rows, [n, 32]) and then the semiwire kernel on k_rows, on
// `stream` of `device`, with one cudaSetDevice; never synchronizes. The
// stream orders the two, so the semiwire kernel reads the k just written.
// m_idx null selects the per-lane digest form, as in hd_ed25519_challenge;
// trows and the coordinate tables share the table's n_table slots. Returns
// the first nonzero cudaGetLastError() (0 = both launched).
extern "C" int hd_ed25519_chal_semiwire_verify(
    int device, const int32_t* idx, const uint8_t* r_rows, const uint8_t* s_rows,
    const uint8_t* m_rows, const uint8_t* m_idx, int n_m, const uint8_t* trows,
    const int32_t* tnax, const int32_t* tay, const int32_t* tnat,
    const uint8_t* tvalid, int n_table, uint8_t* k_rows, uint8_t* ok, int n,
    void* stream) {
    if (n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    err = hd_challenge_enqueue(idx, r_rows, m_rows, m_idx, n_m, trows, n_table, k_rows, n, s);
    if (err != cudaSuccess) return (int)err;
    return (int)hd_semiwire_enqueue(idx, r_rows, s_rows, k_rows, tnax, tay, tnat, tvalid,
                                    n_table, ok, n, s);
}
