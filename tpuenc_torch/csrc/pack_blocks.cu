// K2: P1 of the entropy packer, one Huffman bit string per block.
//
// Replaces tpuenc/entropy/pallas_pack.py:_pack_tile_kernel (body
// _p1_tile_body; built by _build_pack_blocks_fn, entry scan_pack_blocks).
// Per block it emits the DC difference item, then the AC items of the
// band and the EOB (common.cuh's p1_block, shared with K8).  Output: words
// (Bp, capB) MSB-aligned, zero past the length; lens (Bp,); and one
// overflow flag, set exactly where the TPU kernel sets its own.  Padding
// blocks (b >= n_blocks) have length 0.
//
// Bound on the card: the serial dependency of a bit writer, and latency.
// A block is at most ~1.8 kbit and most are far shorter, so the work is
// ~64 short steps of integer arithmetic per block.  Design: one thread per
// block walks the 64 zigzag slots in order with a 64-bit accumulator.  The
// coefficient reads are coalesced across the warp (row k of the (64, B)
// input holds slot k of consecutive blocks), the slot loop is unrolled so
// the coefficients and the window sums stay in registers, and the Huffman
// tables are small enough to live in the L1 cache.

#include "common.cuh"

namespace {

using tpuenc::BitWriter;

constexpr int kMaxPattern = 16;

struct PackParams {
    int pat;                   // blocks per repeating table pattern
    int dc_tab[kMaxPattern];   // DC table id per pattern position
    int ac_tab[kMaxPattern];   // AC table id per pattern position
    int ss, se, emit_dc;       // spectral band [ss, se); DC item or not
    tpuenc::P1Caps caps;
};

__global__ void __launch_bounds__(128)
pack_blocks_kernel(const int16_t* __restrict__ q, long long n_blocks,
                   long long Bp, const int32_t* __restrict__ dcdiff,
                   const uint32_t* __restrict__ dc_tab,
                   const uint32_t* __restrict__ ac_tab, PackParams p,
                   uint32_t* __restrict__ words, int32_t* __restrict__ lens,
                   int32_t* __restrict__ overflow) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= Bp) return;
    BitWriter bw;
    bw.row = words + b * p.caps.cap_final;
    bw.cap = p.caps.cap_final;
    if (b >= n_blocks) {
        bw.finish();
        lens[b] = 0;
        return;
    }
    const int pos = (int)(b % p.pat);

    int c[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) c[k] = q[k * n_blocks + b];

    bool ovf = false;
    lens[b] = tpuenc::p1_block(c, p.emit_dc ? dcdiff[b] : 0, p.emit_dc, p.ss,
                               p.se, dc_tab + 16 * p.dc_tab[pos],
                               ac_tab + 256 * p.ac_tab[pos], p.caps, bw, ovf);
    if (ovf) *overflow = 1;
}

}  // namespace

TPUENC_API int tpuenc_pack_blocks(const void* q, long long n_blocks,
                                  long long Bp, const void* dcdiff,
                                  const void* dc_tab, const void* ac_tab,
                                  const int* pattern, int pat, int ss, int se,
                                  int emit_dc, const int* caps, void* words,
                                  void* lens, void* overflow, void* stream) {
    if (pat < 1 || pat > kMaxPattern) return (int)cudaErrorInvalidValue;
    PackParams p;
    p.pat = pat;
    for (int i = 0; i < pat; ++i) {
        p.dc_tab[i] = pattern[i];
        p.ac_tab[i] = pattern[pat + i];
    }
    p.ss = ss;
    p.se = se;
    p.emit_dc = emit_dc;
    p.caps = {caps[0], caps[1], caps[2], caps[3], caps[4]};
    if (Bp > 0) {
        const int threads = 128;
        const long long grid = (Bp + threads - 1) / threads;
        pack_blocks_kernel<<<(unsigned)grid, threads, 0,
                             (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, Bp, (const int32_t*)dcdiff,
            (const uint32_t*)dc_tab, (const uint32_t*)ac_tab, p,
            (uint32_t*)words, (int32_t*)lens, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
