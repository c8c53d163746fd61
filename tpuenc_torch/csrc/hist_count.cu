// K7: AC symbol statistics of up to 8 spectral bands of one component.
//
// Replaces tpuenc/entropy/pallas_hist.py:_hist_count_kernel (built by
// _build_count_fn, entry ac_histograms_pallas_multiband).  For each band
// [ss, se) (ss < se) it counts, over every block's nonzero coefficients of
// the band, the joint (run & 15, size) pairs in a 16 x 17 table (run =
// zeros since the previous nonzero of the band, which starts at ss - 1;
// size = magnitude category, 0..16), the ZRL total (the sum of run >> 4:
// ZRL codes attached to the nonzero that ends the run) and the number of
// blocks that end the band with an EOB (last nonzero below se - 1).
// Output: int32 (n_bands, 274), per band 272 joint counts row-major, then
// the ZRL total and the EOB count, accumulated into a zeroed array.  The
// wrapper folds them into 257-bin histograms.
//
// Bound on the card: the read of the (64, B) int16 stream, once, and the
// counting.  The TPU kernel sums into one VMEM block across grid steps
// that run in order; here blocks run in parallel, so each thread block
// keeps a histogram per band in shared memory (8 x 274 int32), its
// threads walk whole blocks (one thread per block, grid-stride, loads
// coalesced across the warp) and add each symbol with a shared-memory
// atomic, and at the end the block adds its nonzero bins into the global
// output with one atomic each.  Integer addition commutes, so the result
// is exact and the same in every run.

#include "common.cuh"

namespace {

using tpuenc::bit_length;

constexpr int kMaxBands = 8;
constexpr int kBins = 16 * 17 + 2;  // joint counts, ZRL total, EOB count
constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 8;

struct HistBands {
    int n_bands;
    int ss_min, se_max;
    int ss[kMaxBands];
    int se[kMaxBands];
};

__global__ void __launch_bounds__(kThreads)
hist_count_kernel(const int16_t* __restrict__ q, long long n_blocks,
                  HistBands p, int32_t* __restrict__ out) {
    __shared__ int32_t hist[kMaxBands * kBins];
    for (int i = threadIdx.x; i < p.n_bands * kBins; i += blockDim.x)
        hist[i] = 0;
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         b < n_blocks; b += stride) {
        int c[64];
#pragma unroll
        for (int k = 0; k < 64; ++k)
            c[k] = (k >= p.ss_min && k < p.se_max) ? q[k * n_blocks + b] : 0;
#pragma unroll 1
        for (int bi = 0; bi < p.n_bands; ++bi) {
            const int ss = p.ss[bi];
            const int se = p.se[bi];
            int32_t* h = hist + bi * kBins;
            int prev = ss - 1;
            int zrl = 0;
#pragma unroll
            for (int k = 0; k < 64; ++k) {
                const int v = c[k];
                if (k >= ss && k < se && v != 0) {
                    const int run = k - prev - 1;
                    const int size = bit_length(v < 0 ? -v : v);
                    atomicAdd(h + (run & 15) * 17 + size, 1);
                    zrl += run >> 4;
                    prev = k;
                }
            }
            if (zrl) atomicAdd(h + 272, zrl);
            if (prev < se - 1) atomicAdd(h + 273, 1);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < p.n_bands * kBins; i += blockDim.x)
        if (hist[i]) atomicAdd(out + i, hist[i]);
}

}  // namespace

// bands: n_bands (ss, se) pairs; out: int32 (n_bands, 274), zeroed.
TPUENC_API int tpuenc_hist_count(const void* q, long long n_blocks,
                                 int n_bands, const int* bands, void* out,
                                 void* stream) {
    if (n_bands < 1 || n_bands > kMaxBands) return (int)cudaErrorInvalidValue;
    HistBands p;
    p.n_bands = n_bands;
    p.ss_min = 64;
    p.se_max = 0;
    for (int i = 0; i < n_bands; ++i) {
        p.ss[i] = bands[2 * i];
        p.se[i] = bands[2 * i + 1];
        if (p.ss[i] < 0 || p.ss[i] >= p.se[i] || p.se[i] > 64)
            return (int)cudaErrorInvalidValue;
        p.ss_min = p.ss[i] < p.ss_min ? p.ss[i] : p.ss_min;
        p.se_max = p.se[i] > p.se_max ? p.se[i] : p.se_max;
    }
    if (n_blocks > 0) {
        long long grid = (n_blocks + kThreads - 1) / kThreads;
        if (grid > kMaxGrid) grid = kMaxGrid;
        hist_count_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, p, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
