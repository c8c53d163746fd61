// K5: P4 of the entropy packer, rows into one stream.
//
// Replaces tpuenc/entropy/pallas_pack.py:_concat_rows_kernel (built by
// _build_concat_rows_fn).  Row r (MSB-aligned words, zero past its
// length, bits[r] bits) lands at bit offset pos[r] of the single output
// stream of capW words; pos is the exclusive prefix of the row lengths,
// so rows never share bits.  Words past capW are dropped.
//
// Bound on the card: memory traffic.  The rows' words that hold bits are
// read once and the capW output words written once: 8.3 MB at the
// flagship's rung 5, 2.5 us at the HBM rate.
//
// Design: a gather with no atomics.  Every output word is stored exactly
// once, the zero tail up to capW included, so the wrapper allocates with
// torch.empty.  A word belongs to the row its first bit lies in: row r
// owns words [ceil(pos[r] / 32), ceil(end_r / 32)), where end_r is the
// next row's start (the stream's end, pos[R-1] + bits[R-1], for the last
// row); an empty row owns none.  The grid is (row, slice of its words),
// with as many slices per row as keep the grid within the card's resident
// thread blocks (asked once per device, common.cuh's card_limits), and
// every thread block also stores its share of the zero tail
// [ceil(end / 32), capW) in 16-byte stores.  A word inside its row is one
// funnel shift of two adjacent words of that row: no search and no
// branch, so a thread's loads pipeline, and a warp's loads and stores are
// consecutive words.  The row's last word, which may take bits of the
// rows after it (short or empty ones included), is common.cuh's
// gather_word, K3/K4's: a binary search of the prefix, then the OR of the
// funnel-shifted words of every row that overlaps it.  The prefix stays
// in device memory and is read a few times per row: no shared memory, no
// barrier, no bound on R.
//
// A first version of this gather searched the prefix for every word, as
// K3/K4 do: 8 dependent loads a word at the flagship (R = 128) and 14 at
// the no-P3 shape (R = 11,776, fold_plan None at the whole-image limit).
// kernel_ab.py timed it at 0.0095 and 0.197 ms with torch.profiler, slower
// than the atomicOr design it replaced (0.0068 and 0.076 ms, with a zero
// fill besides), on an NVIDIA H100 80GB HBM3 at 700 W.  Owning words by
// row drops the search for all but one word a row.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Resident thread blocks per SM at most: 2048 threads an SM, which the
// launch bounds' 32 registers a thread allow.
constexpr int kMinBlocks = 8;

// Start bit of row i for i in [0, R]: pos[i], and the stream's end at R.
struct RowStarts {
    const long long* pos;
    int R;
    long long end;

    __device__ __forceinline__ long long operator[](int i) const {
        return i < R ? __ldg(pos + i) : end;
    }
};

// Zeroes out[a, e): 16-byte stores where `out` is 16-byte aligned.
__device__ __forceinline__ void store_zeros(uint32_t* __restrict__ out,
                                            long long a, long long e) {
    long long head = e;  // the scalar stores cover [a, head)
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        head = min(e, (a + 3) & ~3LL);
        const long long n4 = (e - head) >> 2;
        uint4* out4 = reinterpret_cast<uint4*>(out + head);
#pragma unroll 4
        for (long long i = threadIdx.x; i < n4; i += kThreads)
            out4[i] = make_uint4(0, 0, 0, 0);
        for (long long w = head + 4 * n4 + threadIdx.x; w < e; w += kThreads)
            out[w] = 0u;
    }
    for (long long w = a + threadIdx.x; w < head; w += kThreads) out[w] = 0u;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
concat_rows_kernel(const uint32_t* __restrict__ rows,
                   const long long* __restrict__ pos,
                   const int32_t* __restrict__ bits, int R, int W,
                   int tiles, long long span, uint32_t* __restrict__ out,
                   long long capW) {
    const RowStarts pref{pos, R, R > 0 ? pos[R - 1] + bits[R - 1] : 0};
    const int r = (int)(blockIdx.x / tiles);
    const int k = (int)(blockIdx.x - (unsigned)r * tiles);
    if (r < R) {
        const long long start = pref[r];
        const long long end = pref[r + 1];
        const long long stop = min(capW, (end + 31) >> 5);
        const long long w0 = ((start + 31) >> 5) + k * span;
        const long long w1 = k == tiles - 1 ? stop : min(stop, w0 + span);
        // Word j of the row counts where 32j < its length and j < W.
        const long long n_words = min((long long)W, (end - start + 31) >> 5);
        const uint32_t* src = rows + (long long)r * W;
        // Words inside the row: no branch, so the loop's loads pipeline.
        const long long inner = min(w1, end >> 5);
#pragma unroll 4
        for (long long w = w0 + threadIdx.x; w < inner; w += kThreads) {
            const long long d = 32LL * w - start;
            const long long j = d >> 5;
            const int sh = (int)(d & 31);
            const uint32_t hi_w = j < n_words ? src[j] : 0u;
            const uint32_t lo_w = sh != 0 && j + 1 < n_words ? src[j + 1] : 0u;
            out[w] = __funnelshift_l(lo_w, hi_w, sh);
        }
        // The word that holds the row's end, where it is not a word
        // boundary: bits of this row and of the rows after it.
        const long long last = end >> 5;
        if (threadIdx.x == 0 && last >= w0 && last < w1)
            out[last] = tpuenc::gather_word(rows, pref, R, W, 32LL * last);
    }
    // This thread block's share of the zero tail [ceil(end / 32), capW),
    // in whole 16-byte groups.
    const long long z0 = min(capW, (pref.end + 31) >> 5);
    const long long share =
        ((capW - z0 + gridDim.x - 1) / gridDim.x + 3) & ~3LL;
    const long long a = min(capW, z0 + (long long)blockIdx.x * share);
    store_zeros(out, a, min(capW, a + share));
}

}  // namespace

TPUENC_API int tpuenc_concat_rows(const void* rows, const void* pos,
                                  const void* bits, long long R, int W,
                                  void* out, long long capW, void* stream) {
    if (R < 0 || R >= INT_MAX || W < 0 || capW < 0)
        return (int)cudaErrorInvalidValue;
    const tpuenc::CardLimits* card = tpuenc::card_limits();
    if (card == nullptr) return (int)cudaErrorInvalidDevice;
    // Slices per row: as many as keep the grid within the card's resident
    // thread blocks, at least a word a thread each.  A row owns at most
    // W + 1 words while its length fits its W words; the last slice takes
    // the rest of a longer one.
    const long long slots = tpuenc::resident_blocks(*card, 0, kMinBlocks);
    long long tiles = slots / (R > 0 ? R : 1);
    const long long most = (W + kThreads) / kThreads;
    tiles = tiles < most ? tiles : most;
    tiles = tiles > 1 ? tiles : 1;
    const long long span = (W + tiles) / tiles;
    const long long grid = (R > 0 ? R : 1) * tiles;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    if (capW > 0) {
        concat_rows_kernel<<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
            (const uint32_t*)rows, (const long long*)pos,
            (const int32_t*)bits, (int)R, W, (int)tiles, span,
            (uint32_t*)out, capW);
    }
    return (int)cudaGetLastError();
}
