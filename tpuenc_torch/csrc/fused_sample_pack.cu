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
// 13.5 MB of strings written at the flagship), in practice instructions:
// a transform of ~3,000 integer operations per block, then K2's ~64 slot
// steps.  The first design ran a serial bit writer that stored each
// block's row straight to device memory: divergent branches, stores to
// rows capB x 4 bytes apart (one sector per lane) and Huffman lookups as
// divergent gathers through L1, as K2's first design.
//
// Design: one thread per block, as K1 and K2; the transform and the
// quantizer are common.cuh's (shared with K1), and the P1 part is
// common.cuh's staged tile (shared with K2).  Each thread block stages the
// scan's Huffman tables in shared memory and zeroes a shared tile of
// kP1Threads x capB words (p1_stage); each thread loads its block's 64
// samples (a warp's reads of row k are 32 consecutive samples, coalesced;
// the kernel masks the ragged end itself, so the samples are not padded),
// transforms and quantizes them in registers, and takes its DC difference
// from the halo below; pack_block writes the string into its row of the
// tile (p1_pack), and after a barrier the tile goes out as 16-byte stores,
// zero tails and padding rows included (p1_store).  With the halo's DCs
// that is at most 42,560 bytes of shared memory (budget 224, the largest
// tile, and all eight AC tables), under the 48 KB a thread block takes by
// default.
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
// slot 0.  Eight threads share each halo block's sum, eight independent
// loads each, so the barrier does not wait on one thread's 64 loads in a
// row.  One launch, no dependency between thread blocks, and at most
// pat x 64 extra loads per 128 blocks.

#include "common.cuh"

namespace {

using tpuenc::kMaxPattern;
using tpuenc::kP1Threads;
using tpuenc::u32;

struct FusedParams {
    tpuenc::P1Scan scan;       // the tables per MCU position, band and caps
    int qtab[kMaxPattern];     // quantization table (0 luma, 1 chroma)
    int delta[kMaxPattern];    // distance to the previous block of its component
    long long seg_blocks;      // restart segment in blocks; 0: one segment
};

constexpr size_t kDcBytes = sizeof(int) * (kMaxPattern + kP1Threads);

__global__ void __launch_bounds__(kP1Threads)
fused_sample_pack_kernel(const int16_t* __restrict__ x, long long n_blocks,
                         long long Bp, const int32_t* __restrict__ recip,
                         const int32_t* __restrict__ corr,
                         const uint32_t* __restrict__ dc_tab,
                         const uint32_t* __restrict__ ac_tab, FusedParams p,
                         uint32_t* __restrict__ words,
                         int32_t* __restrict__ lens,
                         int32_t* __restrict__ overflow) {
    extern __shared__ __align__(16) uint32_t smem[];
    // dc[kMaxPattern + t] is the DC of block b0 + t; the pat entries
    // before kMaxPattern are the halo's.
    __shared__ int dc[kMaxPattern + kP1Threads];
    const tpuenc::P1Scan& s = p.scan;
    const tpuenc::P1Tile tile = tpuenc::p1_stage(smem, s, dc_tab, ac_tab);
    const int t = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * kP1Threads;
    const long long b = b0 + t;
    const bool valid = b < n_blocks;
    const int pos = (int)(b % s.pat);

    int c[64];
    if (valid) {
        const int qt = p.qtab[pos];
        u32 v[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) v[k] = (u32)(int)x[k * n_blocks + b];
        tpuenc::fdct_8x8(v);
        tpuenc::quantize_zigzag(v, recip + 64 * qt, corr + 64 * qt, c);
    }
    dc[kMaxPattern + t] = valid ? c[0] : 0;
    // Halo block i = t / 8 (i < pat): eight threads each sum eight of its
    // samples, and three shuffles within their aligned group of eight
    // lanes add the parts (mod 2^32, in any order).
    const int i = t >> 3;
    const long long h = b0 - s.pat + i;
    const bool halo = i < s.pat && h >= 0 && h < n_blocks;
    u32 sum = 0;
    if (halo) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
            sum += (u32)(int)x[((t & 7) * 8 + k) * n_blocks + h];
    }
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 4);
    if (halo && (t & 7) == 0) {
        const int qt = p.qtab[(int)(h % s.pat)];
        dc[kMaxPattern - s.pat + i] = tpuenc::quantize(sum, recip[64 * qt],
                                                       corr[64 * qt]);
    }
    __syncthreads();  // the DCs, the tables and the zeroed tile

    int32_t diff = 0;
    if (valid) {
        // dc_diffs_from_dc: 0-based at each restart segment start.
        const int d = p.delta[pos];
        const long long seg_pos = p.seg_blocks > 0 ? b % p.seg_blocks : b;
        diff = c[0] - (seg_pos >= d ? dc[kMaxPattern + t - d] : 0);
    }
    tpuenc::p1_pack(tile, s, c, diff, b, n_blocks, Bp, lens, overflow);
    __syncthreads();
    tpuenc::p1_store(tile.rows, kP1Threads, s.caps.cap_final, b0, Bp,
                     words);
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
    FusedParams p;
    if (!tpuenc::p1_scan(pattern, pat, ss, se, 1, caps, p.scan))
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < pat; ++i) {
        p.qtab[i] = pattern[2 * pat + i];
        p.delta[i] = pattern[3 * pat + i];
        if (p.qtab[i] < 0 || p.qtab[i] > 1 || p.delta[i] < 1 ||
            p.delta[i] > pat)
            return (int)cudaErrorInvalidValue;
    }
    p.seg_blocks = seg_blocks;
    const size_t smem = tpuenc::p1_smem(p.scan);
    if (smem + kDcBytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (Bp > 0) {
        const long long grid = (Bp + kP1Threads - 1) / kP1Threads;
        fused_sample_pack_kernel<<<(unsigned)grid, kP1Threads, smem,
                                   (cudaStream_t)stream>>>(
            (const int16_t*)x, n_blocks, Bp, (const int32_t*)recip,
            (const int32_t*)corr, (const uint32_t*)dc_tab,
            (const uint32_t*)ac_tab, p, (uint32_t*)words, (int32_t*)lens,
            (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
