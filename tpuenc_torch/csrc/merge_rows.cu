// K3 + K4: merge runs of consecutive bit strings into single rows.
//
// Replaces tpuenc/entropy/pallas_pack.py:_merge_chunks_kernel (K3, P2:
// built by _build_merge_chunks_fn) and _fold_rows_kernel (K4, P3: built
// by _build_fold_rows_fn).  On the TPU the two are separate kernels
// because their layouts differ (substreams on lanes vs. words on lanes);
// both compute the same thing: for each run of `run` consecutive input
// rows (MSB-aligned words + bit lengths), the bit concatenation of the
// run in one output row of cap_out words, its total length, and the
// overflow flag of the TPU's pairwise merge tree.  That flag is set when
// any aligned window of 2^(l+1) rows holds more than 32 x caps[l] bits
// (chunk_caps / fold_caps), exactly as _merge_ncT / _merge_nsc set it,
// since those never clip the lengths they add.  Rows at or past n_rows
// are empty, which stands in for the zero padding the TPU version
// materialises (Bp -> n_sub * n1p rows, n2 -> n2p chunk rows).
//
// Bound on the card: memory traffic and atomics.  Each input word is
// read once and ORed into at most two output words; the arithmetic per
// word is a handful of shifts.  Design: one thread block per run; the
// run's exclusive prefix of lengths goes to shared memory, the window
// sums for the overflow flag come from that prefix, and then the block's
// threads stride over the run's (row, word) pairs in row-major order, so a
// warp reads consecutive words, and scatter each word with atomicOr into
// the zeroed output row.  Rows never share bits, so the OR order does not
// change the result.

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 24;

struct MergeCaps {
    int n_levels;
    int cap[kMaxLevels];
};

__global__ void merge_rows_kernel(const uint32_t* __restrict__ X,
                                  const int32_t* __restrict__ L,
                                  long long n_rows, int C_in, int run,
                                  MergeCaps caps, uint32_t* __restrict__ out,
                                  int cap_out, int32_t* __restrict__ out_len,
                                  int32_t* __restrict__ overflow) {
    extern __shared__ long long pref[];  // run + 1 entries
    const long long r = blockIdx.x;
    const long long row0 = r * run;

    for (int i = threadIdx.x; i < run; i += blockDim.x) {
        const long long row = row0 + i;
        pref[i + 1] = row < n_rows ? L[row] : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        pref[0] = 0;
        for (int i = 1; i <= run; ++i) pref[i] += pref[i - 1];
        out_len[r] = (int32_t)pref[run];
        bool ovf = false;
        for (int l = 0; l < caps.n_levels; ++l) {
            const int size = 2 << l;
            const long long lim = 32LL * caps.cap[l];
            for (int m = 0; m < run; m += size) {
                const int e = m + size < run ? m + size : run;
                ovf |= pref[e] - pref[m] > lim;
            }
        }
        if (ovf) *overflow = 1;
    }
    __syncthreads();

    uint32_t* orow = out + r * cap_out;
    const int total = run * C_in;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int i = idx / C_in;
        const int j = idx - i * C_in;
        const long long row = row0 + i;
        if (row >= n_rows || 32LL * j >= pref[i + 1] - pref[i]) continue;
        tpuenc::or_at(orow, cap_out, pref[i] + 32LL * j, X[row * C_in + j]);
    }
}

}  // namespace

TPUENC_API int tpuenc_merge_rows(const void* X, const void* L,
                                 long long n_rows, int C_in, int run,
                                 long long n_runs, const int* caps,
                                 int n_levels, void* out, int cap_out,
                                 void* out_len, void* overflow, void* stream) {
    if (n_levels < 0 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(long long) * (size_t)(run + 1);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    MergeCaps mc;
    mc.n_levels = n_levels;
    for (int l = 0; l < n_levels; ++l) mc.cap[l] = caps[l];
    if (n_runs > 0) {
        merge_rows_kernel<<<(unsigned)n_runs, 256, smem,
                            (cudaStream_t)stream>>>(
            (const uint32_t*)X, (const int32_t*)L, n_rows, C_in, run, mc,
            (uint32_t*)out, cap_out, (int32_t*)out_len, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
