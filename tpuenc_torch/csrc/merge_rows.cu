// K3 + K4: merge runs of consecutive bit strings into single rows.
//
// Replaces tpuenc/entropy/pallas_pack.py:_merge_chunks_kernel (K3, P2:
// built by _build_merge_chunks_fn) and _fold_rows_kernel (K4, P3: built
// by _build_fold_rows_fn).  On the TPU the two are separate kernels
// because their layouts differ (substreams on lanes vs. words on lanes);
// both compute the same thing: for each run of `run` consecutive input
// rows (MSB-aligned words, zero past their bit lengths), the bit
// concatenation of the run in one output row of cap_out words, its total
// length, and the overflow flag of the TPU's pairwise merge tree.  That
// flag is set when any aligned window of 2^(l+1) rows holds more than
// 32 x caps[l] bits (chunk_caps / fold_caps), exactly as _merge_ncT /
// _merge_nsc set it, since those never clip the lengths they add.  Rows at
// or past n_rows are empty, which stands in for the zero padding the TPU
// version materialises (Bp -> n_sub * n1p rows, n2 -> n2p chunk rows).
//
// Bound on the card: memory traffic.  Every output word is written once,
// its zero tail included (so the output needs no zero fill), and each
// input word that holds bits is read about once: 5-6 MB, under 3 us at
// the HBM rate, for the flagship's P2 and P3.  What bounds it in practice
// is latency: each thread block must build its run's prefix of lengths
// before it can place a word, and each word waits on a search of that
// prefix and a load of its source words.
//
// Design: a gather.  The grid covers (run, tile of output words), with as
// many tiles per run as fill the card's resident thread blocks once (P3's
// 128 runs of 10,496 words become ~1,000 thread blocks, not 128; the SM
// count and shared memory that decide it are asked once per device, by
// common.cuh's card_limits).  Each
// thread block loads its run's lengths into shared memory and turns them
// into the prefix with a block-wide scan: each thread sums a contiguous
// segment, warp shuffles scan the segment sums, one warp scans the warp
// totals.  Tile 0 of each run writes the run's length and evaluates the
// overflow windows, its threads splitting them.  Each thread then owns
// output words w = tile start + k x kThreads + thread, each built by
// common.cuh's gather_word (shared with K5): it binary-searches the
// prefix for the first row that ends past bit 32w, ORs in a register the
// bits of every row that overlaps [32w, 32w + 32) (one funnel shift of
// two adjacent source words per row; a word may span many short rows; a
// stretch of empty rows, such as the padding blocks at a stream's end, is
// crossed by one more search) and stores the word once.  A warp's stores,
// and within a row its loads, are consecutive words.  Rows never share
// bits, so the OR is the concatenation.  No atomics, no thread walks a
// run.

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 24;
constexpr int kMaxRun = 6000;  // (kMaxRun + 1) x 8 bytes of prefix < 48 KB
constexpr int kThreads = 256;
// Resident thread blocks per SM at most: 2048 threads an SM, which the
// launch bounds' 32 registers a thread allow.
constexpr int kMinBlocks = 8;
constexpr int kWarps = kThreads / 32;

struct MergeCaps {
    int n_levels;
    int cap[kMaxLevels];
};

// pref[i] <- the bits of rows [0, i) of the run that starts at row row0,
// for i in [0, run]; rows at or past n_rows are empty.
__device__ __forceinline__ void run_prefix(const int32_t* __restrict__ L,
                                           long long row0, long long n_rows,
                                           int run, long long* pref) {
    __shared__ long long warp_total[kWarps];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    for (int i = t; i < run; i += kThreads) {
        const long long row = row0 + i;
        pref[i + 1] = row < n_rows ? L[row] : 0;
    }
    if (t == 0) pref[0] = 0;
    __syncthreads();

    // Thread t owns rows [a, e): its segment sum, scanned across the warp.
    const int per = (run + kThreads - 1) / kThreads;
    const int a = min(run, t * per);
    const int e = min(run, a + per);
    long long seg = 0;
    for (int i = a; i < e; ++i) seg += pref[i + 1];
    long long incl = seg;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        long long v = lane < kWarps ? warp_total[lane] : 0;
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
            const long long y = __shfl_up_sync(0xFFFFFFFFu, v, o);
            if (lane >= o) v += y;
        }
        if (lane < kWarps) warp_total[lane] = v;
    }
    __syncthreads();
    long long acc = incl - seg + (warp > 0 ? warp_total[warp - 1] : 0);
    for (int i = a; i < e; ++i) {
        acc += pref[i + 1];
        pref[i + 1] = acc;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_rows_kernel(const uint32_t* __restrict__ X,
                  const int32_t* __restrict__ L, long long n_rows, int C_in,
                  int run, int tiles, int tile_words, MergeCaps caps,
                  uint32_t* __restrict__ out, int cap_out,
                  int32_t* __restrict__ out_len,
                  int32_t* __restrict__ overflow) {
    extern __shared__ long long pref[];  // run + 1 entries
    const long long r = (long long)blockIdx.x / tiles;
    const int tile = (int)((long long)blockIdx.x - r * tiles);
    const long long row0 = r * run;
    run_prefix(L, row0, n_rows, run, pref);
    const long long total = pref[run];

    if (tile == 0) {
        bool ovf = false;
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l) {
            if (l < caps.n_levels) {
                const int size = 2 << l;
                const long long lim = 32LL * caps.cap[l];
                const int n_windows = (run + size - 1) / size;
                for (int m = threadIdx.x; m < n_windows; m += kThreads) {
                    const int s = m * size;
                    ovf |= pref[min(s + size, run)] - pref[s] > lim;
                }
            }
        }
        if (__syncthreads_or(ovf) && threadIdx.x == 0) *overflow = 1;
        if (threadIdx.x == 0) out_len[r] = (int32_t)total;
    }

    const uint32_t* Xr = X + row0 * C_in;
    uint32_t* orow = out + r * cap_out;
    const int w_end = min(cap_out, (tile + 1) * tile_words);
    for (int w = tile * tile_words + threadIdx.x; w < w_end; w += kThreads) {
        const long long bit = 32LL * w;
        orow[w] = bit < total ? tpuenc::gather_word(Xr, pref, run, C_in, bit)
                              : 0u;
    }
}

}  // namespace

TPUENC_API int tpuenc_merge_rows(const void* X, const void* L,
                                 long long n_rows, int C_in, int run,
                                 long long n_runs, const int* caps,
                                 int n_levels, void* out, int cap_out,
                                 void* out_len, void* overflow, void* stream) {
    if (n_levels < 0 || n_levels > kMaxLevels || run < 1 || run > kMaxRun ||
        C_in < 0 || cap_out < 0 || n_runs < 0)
        return (int)cudaErrorInvalidValue;
    MergeCaps mc;
    mc.n_levels = n_levels;
    for (int l = 0; l < n_levels; ++l) mc.cap[l] = caps[l];
    const size_t smem = sizeof(long long) * (size_t)(run + 1);

    // Tiles per run: enough that the grid fills the card's resident
    // thread blocks once, at least one word per thread each.  A thread
    // block holds its prefix and the scan's warp totals.
    const tpuenc::CardLimits* card = tpuenc::card_limits();
    if (card == nullptr) return (int)cudaErrorInvalidDevice;
    const long long slots = tpuenc::resident_blocks(
        *card, smem + sizeof(long long) * kWarps, kMinBlocks);
    long long tiles = n_runs > 0 ? (slots + n_runs - 1) / n_runs : 1;
    const long long most = (cap_out + kThreads - 1) / kThreads;
    tiles = tiles < most ? tiles : most;
    tiles = tiles > 1 ? tiles : 1;  // tile 0 writes the length and flag
    const long long tile_words = (cap_out + tiles - 1) / tiles;
    const long long grid = n_runs * tiles;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    if (grid > 0) {
        merge_rows_kernel<<<(unsigned)grid, kThreads, smem,
                            (cudaStream_t)stream>>>(
            (const uint32_t*)X, (const int32_t*)L, n_rows, C_in, run,
            (int)tiles, (int)tile_words, mc, (uint32_t*)out, cap_out,
            (int32_t*)out_len, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
