// K7: AC symbol statistics of up to 8 spectral bands of one component.
//
// Replaces tpuenc/entropy/pallas_hist.py:_hist_count_kernel (built by
// _build_count_fn, entry ac_histograms_pallas_multiband).  For each band
// [ss, se) (ss < se) it counts, over every block's nonzero coefficients of
// the band, the joint (run & 15, size) pairs in a 16 x 17 table (run =
// zeros since the previous nonzero of the band, which starts at ss - 1;
// size = magnitude category, 0..16), the ZRL total (the sum of run >> 4:
// ZRL codes attached to the nonzero that ends the run) and the number of
// blocks that end the band with an EOB (last nonzero below se - 1, that
// is, slot se - 1 zero).  The bands are disjoint (a slot belongs to one
// band only; the launcher refuses others) and may come in any order of
// slots: band i of the arguments is row i of the output.  Output: int32
// (n_bands, 274), per band 272 joint counts row-major, then the ZRL total
// and the EOB count, accumulated into a zeroed array.  The wrapper folds
// them into 257-bin histograms.
//
// Bound on the card: the read of the (64, B) int16 stream, once, and the
// counting.  The TPU kernel sums into one VMEM block across grid steps
// that run in order; here blocks run in parallel, so each thread block
// keeps a histogram per band in shared memory and adds its nonzero bins
// into the output at the end, one atomic each.  The first design walked a
// block's 64 slots, unrolled over registers, once per band; its grid was
// capped for a 132-SM card.
//
// Design: one thread per block, whole warps on consecutive blocks
// (grid-stride over one resident wave of thread blocks, from the card's
// SM count and the kernel's occupancy, asked once per device).  Each
// thread loads its block's coefficients of the bands' slots (coalesced
// across the warp) into its column of a shared 64 x kThreads int16 tile,
// then walks the bands in slot order and each band's slots once, in a
// loop whose band start and end lie outside it.  It adds each symbol with
// a shared-memory atomicAdd of 1, which the compiler turns into one
// aggregated add per distinct address of the warp (ATOMS.POPC.INC), so
// the common symbols colliding within a warp, such as (run 0, size 1) in
// the low slots, cost one add.  The ZRL total is kept per thread for the
// band in a register and the EOB flags are counted with a ballot; at the
// band's end both are summed over the warp and added once.  Integer
// addition commutes, so the result is exact and the same in every run.
//
// Measured against it at the flagship (NVIDIA H100 80GB HBM3, kernel time
// from torch.profiler, kernel_ab.py), each with the walk unrolled over the
// 64 slots in registers and the bands found from warp-uniform 64-bit masks
// of starts and ends, whose boundary work then ran at every slot: warp
// aggregation with __match_any_sync, 0.018 ms; a private histogram per
// warp, 0.014; per-thread packed counters of the common symbols, 0.019;
// the first design 0.015; this loop 0.011.  Adding zeros into a spare bin,
// so that the loop takes no branch, and 128-thread blocks were no faster.

#include "common.cuh"

namespace {

using tpuenc::bit_length;

constexpr int kMaxBands = 8;
constexpr int kBins = 16 * 17 + 2;  // joint counts, ZRL total, EOB count
constexpr int kThreads = 256;

struct HistBands {
    uint64_t in_band;          // bit k: slot k lies in a band
    int ss[kMaxBands];         // the bands in slot order: [ss, se)
    int se[kMaxBands];
    int out[kMaxBands];        // and their output rows
};

__global__ void __launch_bounds__(kThreads)
hist_count_kernel(const int16_t* __restrict__ q, long long n_blocks,
                  int n_bands, HistBands p, int32_t* __restrict__ out) {
    __shared__ int32_t hist[kMaxBands * kBins];
    __shared__ int band[kMaxBands][3];     // ss, se, first bin
    __shared__ int16_t coef[64 * kThreads];  // row k: slot k of the blocks
    const int t = threadIdx.x;
    for (int i = t; i < n_bands * kBins; i += kThreads) hist[i] = 0;
#pragma unroll
    for (int j = 0; j < kMaxBands; ++j) {
        if (j == t) {
            band[j][0] = p.ss[j];
            band[j][1] = p.se[j];
            band[j][2] = p.out[j] * kBins;
        }
    }
    __syncthreads();

    const int lane = t & 31;
    const long long stride = (long long)gridDim.x * kThreads;
    // The warp's first block: every lane runs every step below, so the
    // warp's votes see all 32.
    for (long long w0 = (long long)blockIdx.x * kThreads + (t & ~31);
         w0 < n_blocks; w0 += stride) {
        const long long b = w0 + lane;
        const bool valid = b < n_blocks;
        const int16_t* src = q + b;
#pragma unroll
        for (int k = 0; k < 64; ++k, src += n_blocks)
            coef[k * kThreads + t] =
                valid && ((p.in_band >> k) & 1) ? *src : (int16_t)0;
        for (int i = 0; i < n_bands; ++i) {
            const int ss = band[i][0], se = band[i][1];
            int32_t* h = hist + band[i][2];
            int prev = ss - 1, zrl = 0;
#pragma unroll 4
            for (int k = ss; k < se; ++k) {
                const int v = coef[k * kThreads + t];
                if (v != 0) {
                    const int run = k - prev - 1;
                    atomicAdd(h + (run & 15) * 17 +
                                  bit_length((uint32_t)(v < 0 ? -v : v)),
                              1);
                    zrl += run >> 4;
                    prev = k;
                }
            }
            // The band's ZRL total and EOB count over the warp, one add
            // each.
            const int z = __reduce_add_sync(0xFFFFFFFFu, zrl);
            const int e = __popc(__ballot_sync(0xFFFFFFFFu,
                                               valid && prev < se - 1));
            if (lane == 0) {
                if (z) atomicAdd(h + 272, z);
                if (e) atomicAdd(h + 273, e);
            }
        }
    }
    __syncthreads();
    for (int i = t; i < n_bands * kBins; i += kThreads)
        if (hist[i]) atomicAdd(out + i, hist[i]);
}

}  // namespace

// bands: n_bands (ss, se) pairs, disjoint, in any order of slots; out:
// int32 (n_bands, 274), zeroed.
TPUENC_API int tpuenc_hist_count(const void* q, long long n_blocks,
                                 int n_bands, const int* bands, void* out,
                                 void* stream) {
    if (n_bands < 1 || n_bands > kMaxBands) return (int)cudaErrorInvalidValue;
    // The bands in slot order; each keeps its place in `bands` as its
    // output row.
    int order[kMaxBands];
    for (int i = 0; i < n_bands; ++i) {
        int j = i;
        for (; j > 0 && bands[2 * order[j - 1]] > bands[2 * i]; --j)
            order[j] = order[j - 1];
        order[j] = i;
    }
    HistBands p = {};
    int prev_se = 0;
    for (int j = 0; j < n_bands; ++j) {
        const int ss = bands[2 * order[j]], se = bands[2 * order[j] + 1];
        if (ss < prev_se || ss >= se || se > 64)
            return (int)cudaErrorInvalidValue;
        prev_se = se;
        p.in_band |= (se >= 64 ? ~0ull : (1ull << se) - 1) & ~((1ull << ss) - 1);
        p.ss[j] = ss;
        p.se[j] = se;
        p.out[j] = order[j];
    }
    if (n_blocks > 0) {
        const tpuenc::CardLimits* card = tpuenc::card_limits();
        if (card == nullptr) return (int)cudaErrorInvalidDevice;
        static int per_sm[tpuenc::kMaxDevices];
        static std::once_flag once[tpuenc::kMaxDevices];
        std::call_once(once[card->device], [card] {
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[card->device], hist_count_kernel, kThreads, 0);
        });
        const int fit = per_sm[card->device];
        const long long wave = (long long)card->sms * (fit > 0 ? fit : 1);
        long long grid = (n_blocks + kThreads - 1) / kThreads;
        if (grid > wave) grid = wave;
        hist_count_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, n_bands, p, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
