// K8: fused sample -> packed bit strings, for one interleaved scan.
//
// Replaces tpuenc/entropy/pallas_pack.py:_fused_sample_pack_kernel (built
// by _build_fused_sample_pack_fn, entry fused_sample_pack_blocks).  Input
// is the MCU-ordered, level-shifted int16 sample stream x (64, n_blocks),
// row k = sample y*8+x of every block.  Per block, in one pass: the fDCT,
// zigzag and reciprocal quantize with the table of its MCU position
// (qtab[b % pat]), the DC difference against the previous block of the
// same component (reset at each restart segment start), and the whole P1
// body of K2.  Output is K2's contract: words (Bp, capB) MSB-aligned, zero
// past the length; lens (Bp,), 0 for b >= n_blocks; and the overflow flag
// where the TPU kernel sets it.  The (64, B) coefficient stream never goes
// to device memory.
//
// Bound on the card: bytes at the least (21.6 MB of samples read and
// 13.5 MB of strings written at the flagship), but in practice the serial
// bit writer's latency, as in K2, behind a transform of ~3,000 integer
// operations per block.  Design: one thread per block, as K1 and K2 (the
// transform, the quantizer and the P1 body are common.cuh's, shared with
// them); a warp's reads of row k are 32 consecutive samples (coalesced),
// and the kernel masks the ragged end itself, so the samples are not
// padded.
//
// The DC carry.  The TPU kernel carries the previous grid step's last DCs
// in VMEM, because its grid runs in order; thread blocks on the card run
// in parallel and in no order.  So each thread block also computes the DCs
// of the up to `pat` (<= 16) blocks just before its first block, the halo,
// keeps them with its own 128 DCs in shared memory, synchronises, and
// takes prev = dc[b - delta[b % pat]].  A halo block needs only its DC,
// which is the plain sum of its 64 samples: pass 1 of the LL&M transform
// puts 4 x each row sum in column 0, and pass 2 descales their sum by 4
// exactly, (4S + 2) >> 2 = S; the sum is then quantized as K1 quantizes
// slot 0.  One launch, no dependency between thread blocks, and at most
// pat x 64 extra loads per 128 blocks.

#include "common.cuh"

namespace {

using tpuenc::BitWriter;
using tpuenc::u32;

constexpr int kThreads = 128;
constexpr int kMaxPattern = 16;

struct FusedParams {
    int pat;                   // blocks per MCU (the table pattern)
    int dc_tab[kMaxPattern];   // DC Huffman table id per MCU position
    int ac_tab[kMaxPattern];   // AC Huffman table id per MCU position
    int qtab[kMaxPattern];     // quantization table (0 luma, 1 chroma)
    int delta[kMaxPattern];    // distance to the previous block of its component
    int ss, se;                // spectral band of the AC items
    long long seg_blocks;      // restart segment in blocks; 0: one segment
    tpuenc::P1Caps caps;
};

__global__ void __launch_bounds__(kThreads)
fused_sample_pack_kernel(const int16_t* __restrict__ x, long long n_blocks,
                         long long Bp, const int32_t* __restrict__ recip,
                         const int32_t* __restrict__ corr,
                         const uint32_t* __restrict__ dc_tab,
                         const uint32_t* __restrict__ ac_tab, FusedParams p,
                         uint32_t* __restrict__ words,
                         int32_t* __restrict__ lens,
                         int32_t* __restrict__ overflow) {
    // dc[kMaxPattern + t] is the DC of block base + t; the pat entries
    // before kMaxPattern are the halo's.
    __shared__ int dc[kMaxPattern + kThreads];
    const int t = threadIdx.x;
    const long long base = (long long)blockIdx.x * kThreads;
    const long long b = base + t;
    const bool valid = b < n_blocks;
    const int pos = (int)(b % p.pat);

    int c[64];
    if (valid) {
        const int qt = p.qtab[pos];
        u32 s[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) s[k] = (u32)(int)x[k * n_blocks + b];
        tpuenc::fdct_8x8(s);
        tpuenc::quantize_zigzag(s, recip + 64 * qt, corr + 64 * qt, c);
    }
    dc[kMaxPattern + t] = valid ? c[0] : 0;
    const long long h = base - p.pat + t;  // this thread's halo block
    if (t < p.pat && h >= 0 && h < n_blocks) {
        u32 sum = 0;
        for (int k = 0; k < 64; ++k) sum += (u32)(int)x[k * n_blocks + h];
        const int qt = p.qtab[(int)(h % p.pat)];
        dc[kMaxPattern - p.pat + t] = tpuenc::quantize(sum, recip[64 * qt],
                                                       corr[64 * qt]);
    }
    __syncthreads();
    if (b >= Bp) return;

    BitWriter bw;
    bw.row = words + b * p.caps.cap_final;
    bw.cap = p.caps.cap_final;
    if (!valid) {
        bw.finish();
        lens[b] = 0;
        return;
    }
    // dc_diffs_from_dc: 0-based at each restart segment start.
    const int d = p.delta[pos];
    const long long seg_pos = p.seg_blocks > 0 ? b % p.seg_blocks : b;
    const int prev = seg_pos >= d ? dc[kMaxPattern + t - d] : 0;
    bool ovf = false;
    lens[b] = tpuenc::p1_block(c, c[0] - prev, true, p.ss, p.se,
                               dc_tab + 16 * p.dc_tab[pos],
                               ac_tab + 256 * p.ac_tab[pos], p.caps, bw, ovf);
    if (ovf) *overflow = 1;
}

}  // namespace

// pattern: dc_tab[pat], ac_tab[pat], qtab[pat], delta[pat]; caps: the five
// P1 caps.
TPUENC_API int tpuenc_fused_sample_pack(
        const void* x, long long n_blocks, long long Bp, const void* recip,
        const void* corr, const void* dc_tab, const void* ac_tab,
        const int* pattern, int pat, int ss, int se, long long seg_blocks,
        const int* caps, void* words, void* lens, void* overflow,
        void* stream) {
    if (pat < 1 || pat > kMaxPattern) return (int)cudaErrorInvalidValue;
    FusedParams p;
    p.pat = pat;
    for (int i = 0; i < pat; ++i) {
        p.dc_tab[i] = pattern[i];
        p.ac_tab[i] = pattern[pat + i];
        p.qtab[i] = pattern[2 * pat + i];
        p.delta[i] = pattern[3 * pat + i];
        if (p.delta[i] < 1 || p.delta[i] > pat) return (int)cudaErrorInvalidValue;
    }
    p.ss = ss;
    p.se = se;
    p.seg_blocks = seg_blocks;
    p.caps = {caps[0], caps[1], caps[2], caps[3], caps[4]};
    if (Bp > 0) {
        const long long grid = (Bp + kThreads - 1) / kThreads;
        fused_sample_pack_kernel<<<(unsigned)grid, kThreads, 0,
                                   (cudaStream_t)stream>>>(
            (const int16_t*)x, n_blocks, Bp, (const int32_t*)recip,
            (const int32_t*)corr, (const uint32_t*)dc_tab,
            (const uint32_t*)ac_tab, p, (uint32_t*)words, (int32_t*)lens,
            (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
