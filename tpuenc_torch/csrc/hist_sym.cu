// K9: single-band AC symbolization for a one-hot histogram.
//
// Replaces tpuenc/entropy/pallas_hist.py:_hist_sym_kernel (built by
// _build_sym_fn, entry ac_histogram_pallas).  For one band [ss, se) of a
// (64, n_blocks) stream, padded to Lp >= n_blocks columns, it writes per
// slot and block: run4 (int8) = run & 15 for a nonzero coefficient of the
// band in a real block, 16 for everything else (so the count after it
// drops those elements for free); size (int8) = the magnitude category of
// the band's coefficient (0 outside the band and for zeros); and per block
// the ZRL partial (sum of run >> 4 over its nonzeros) and the EOB flag
// (its last nonzero of the band lies below se - 1), as int32 rows 0 and 1
// of parts (2, Lp).  The joint count after it is plain PyTorch, as it is
// XLA in tpuenc.
//
// Bound on the card: memory traffic.  It reads 128 bytes and writes 136
// per block.  Design: one thread per block walks the 64 slots in order
// (the run needs the previous nonzero); row k of every array holds slot k
// of consecutive blocks, so loads and stores are coalesced across the
// warp.

#include "common.cuh"

namespace {

using tpuenc::bit_length;

__global__ void __launch_bounds__(128)
hist_sym_kernel(const int16_t* __restrict__ q, long long n_blocks,
                long long Lp, int ss, int se, int8_t* __restrict__ run4,
                int8_t* __restrict__ size, int32_t* __restrict__ parts) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= Lp) return;
    const bool valid = b < n_blocks;
    int prev = ss - 1;
    int zrl = 0;
#pragma unroll
    for (int k = 0; k < 64; ++k) {
        const int v = (valid && k >= ss && k < se) ? q[k * n_blocks + b] : 0;
        int r4 = 16;
        int sz = 0;
        if (v != 0) {
            const int run = k - prev - 1;
            r4 = run & 15;
            zrl += run >> 4;
            sz = bit_length(v < 0 ? -v : v);
            prev = k;
        }
        run4[k * Lp + b] = (int8_t)r4;
        size[k * Lp + b] = (int8_t)sz;
    }
    parts[b] = zrl;
    parts[Lp + b] = valid && prev < se - 1;
}

}  // namespace

TPUENC_API int tpuenc_hist_sym(const void* q, long long n_blocks,
                               long long Lp, int ss, int se, void* run4,
                               void* size, void* parts, void* stream) {
    if (ss < 0 || ss >= se || se > 64 || Lp < n_blocks)
        return (int)cudaErrorInvalidValue;
    if (Lp > 0) {
        const int threads = 128;
        const long long grid = (Lp + threads - 1) / threads;
        hist_sym_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, Lp, ss, se, (int8_t*)run4,
            (int8_t*)size, (int32_t*)parts);
    }
    return (int)cudaGetLastError();
}
