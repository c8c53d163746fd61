// K6: P1 of several progressive AC band scans of one component in one pass.
//
// Replaces tpuenc/entropy/pallas_pack.py:_pack_tile_kernel_acbands (built
// by _build_pack_acbands_fn, entry scan_pack_blocks_acbands).  For each
// block and each band [ss, se) (ss < se; empty bands never reach the
// kernel) it emits the band's Huffman bit string: per nonzero coefficient
// its (run & 15, size) code and magnitude bits, with the zero run reset at
// the band start (the previous nonzero is clamped to ss - 1); a ZRL code in
// each zero slot whose run reaches 16/32/48 before the band's last nonzero
// (the slot with run % 16 == 15, where the TPU kernel places it); and EOB
// when the band's last nonzero lies below se - 1.  Output per band: words
// (Bp, cap_f) MSB-aligned and zero past the length, lens (Bp,); one
// overflow flag for all bands, set exactly where the TPU kernel sets its
// own, which follows band_tree_caps and not K2's windows:
//   * each aligned 8-slot chunk of the band rows [8*row0, 8*row1) against
//     32 x block_caps()[2] bits;
//   * the pairwise levels over the band's chunks, counted from row0 and
//     padded to a power of two, against 32 x gen_caps;
//   * the band with its EOB against 32 x cap_band.
// Each band's string is clipped at cap_band words, as the TPU's final
// merge clips it, and zero-padded to cap_f = max(cap_band).  Padding
// blocks (b >= n_blocks) have length 0 in every band.
//
// Bound on the card: as K2, the serial dependency of a bit writer and
// latency (a few dozen short integer steps per block and band).  Design:
// one thread per block.  The shared pass, done once per block for all
// bands, is the coefficient load (coalesced across the warp, rows outside
// every band skipped) and the nonzero mask from which each band's last
// nonzero is one count-leading-zeros.  Each band then walks the 64 slots
// in an unrolled loop, so the coefficients stay in registers; the
// magnitude category is recomputed per band from the register value (one
// clz), which is cheaper than holding 64 more registers.

#include "common.cuh"

namespace {

using tpuenc::bit_length;
using tpuenc::BitWriter;
using tpuenc::mask32;
using tpuenc::shl32;

constexpr int kMaxBands = 7;      // the TPU kernel's bound (lens rows 0..6)
constexpr int kMaxLevels = 3;     // 8 chunks of 8 slots: at most 3 levels
constexpr int kBandInts = 5 + kMaxLevels;

struct Band {
    int ss, se;                 // spectral band [ss, se), ss < se
    int row0;                   // first 8-slot chunk of the band
    int n_levels;               // pairwise levels over its chunks
    int gen_cap[kMaxLevels];    // their word capacities (band_tree_caps)
    int cap_band;               // band string with its EOB, in words
};

struct AcBandsParams {
    int n_bands;
    int ss_min, se_max;         // the slots any band reads
    int cap8;                   // block_caps()[2]: one 8-slot chunk
    int cap_f;                  // output row width: max of cap_band
    Band band[kMaxBands];
};

__global__ void __launch_bounds__(128)
pack_acbands_kernel(const int16_t* __restrict__ q, long long n_blocks,
                    long long Bp, const uint32_t* __restrict__ act,
                    AcBandsParams p, uint32_t* __restrict__ words,
                    int32_t* __restrict__ lens,
                    int32_t* __restrict__ overflow) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= Bp) return;
    if (b >= n_blocks) {
        for (int bi = 0; bi < p.n_bands; ++bi) {
            uint32_t* row = words + ((long long)bi * Bp + b) * p.cap_f;
            for (int w = 0; w < p.cap_f; ++w) row[w] = 0;
            lens[bi * Bp + b] = 0;
        }
        return;
    }

    int c[64];
    uint64_t nz = 0;
#pragma unroll
    for (int k = 0; k < 64; ++k) {
        c[k] = (k >= p.ss_min && k < p.se_max) ? q[k * n_blocks + b] : 0;
        if (c[k] != 0) nz |= 1ull << k;
    }

    const uint32_t zrl = act[0xF0];
    const int zrl_hs = (int)(zrl >> 16);
    const uint32_t zrl_w = shl32(zrl & 0xFFFF, 32 - zrl_hs);
    const uint32_t eob = act[0];
    const int eob_hs = (int)(eob >> 16);
    const int eob_put = eob_hs < 32 ? eob_hs : 32;
    const uint32_t eob_w = shl32(eob & 0xFFFF, 32 - eob_put);

    bool ovf = false;
#pragma unroll 1
    for (int bi = 0; bi < p.n_bands; ++bi) {
        const Band bd = p.band[bi];
        const uint64_t below_se = bd.se >= 64 ? ~0ull : (1ull << bd.se) - 1;
        const uint64_t in_band = nz & below_se & ~((1ull << bd.ss) - 1);
        const int last = in_band ? 63 - __clzll((long long)in_band) : -1;

        BitWriter bw;
        bw.row = words + ((long long)bi * Bp + b) * p.cap_f;
        bw.cap = bd.cap_band;
        int chunk[8];
        int s8 = 0;
        int prev = bd.ss - 1;
#pragma unroll
        for (int k = 0; k < 64; ++k) {
            int len = 0;
            uint32_t word = 0;
            if (k >= bd.ss && k < bd.se) {
                const int v = c[k];
                const int run = k - prev - 1;
                if (v != 0) {
                    const int size = bit_length(v < 0 ? -v : v);
                    const uint32_t extra = (uint32_t)(v - (v < 0)) & mask32(size);
                    const int sym = ((run & 15) << 4) | size;
                    // The TPU kernel looks the symbol up in two 128-entry
                    // halves, so sym 256 (size 16) reads entry 128.
                    const uint32_t lut = act[sym < 256 ? sym : 128 + (sym & 127)];
                    len = (int)(lut >> 16) + size;
                    word = shl32(shl32(lut & 0xFFFF, size) | extra, 32 - len);
                    prev = k;
                } else if ((run & 15) == 15 && k < last) {
                    len = zrl_hs;
                    word = zrl_w;
                }
            }
            bw.put(word, len);
            s8 += len;
            if ((k & 7) == 7) {
                chunk[k >> 3] = s8;
                s8 = 0;
            }
        }

        // The merge tree's windows.  Chunks outside the band hold no items,
        // so every aligned 8-slot window can be checked, and the chunks
        // from row0 on (rows past 8 are the zero padding) pair up level by
        // level.
        int total = 0;
        int rel[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            ovf |= chunk[j] > 32 * p.cap8;
            total += chunk[j];
            int v = 0;
#pragma unroll
            for (int r = 0; r < 8; ++r)
                if (r == bd.row0 + j) v = chunk[r];
            rel[j] = v;
        }
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l) {
            const int n = 8 >> (l + 1);
#pragma unroll
            for (int w = 0; w < n; ++w) rel[w] = rel[2 * w] + rel[2 * w + 1];
            if (l < bd.n_levels) {
#pragma unroll
                for (int w = 0; w < n; ++w) ovf |= rel[w] > 32 * bd.gen_cap[l];
            }
        }

        if (last < bd.se - 1) {
            bw.put(eob_w, eob_put);
            total += eob_hs;
        }
        ovf |= total > 32 * bd.cap_band;
        bw.finish();
        for (int w = bd.cap_band; w < p.cap_f; ++w) bw.row[w] = 0;
        lens[bi * Bp + b] = total;
    }
    if (ovf) *overflow = 1;
}

}  // namespace

// bands: per band kBandInts ints (ss, se, row0, n_levels, gen_cap[3],
// cap_band).  act: the component's AC table, 256 entries size << 16 | code.
TPUENC_API int tpuenc_pack_acbands(const void* q, long long n_blocks,
                                   long long Bp, const void* act,
                                   int n_bands, const int* bands, int cap8,
                                   int cap_f, void* words, void* lens,
                                   void* overflow, void* stream) {
    if (n_bands < 1 || n_bands > kMaxBands) return (int)cudaErrorInvalidValue;
    AcBandsParams p;
    p.n_bands = n_bands;
    p.ss_min = 64;
    p.se_max = 0;
    p.cap8 = cap8;
    p.cap_f = cap_f;
    for (int i = 0; i < n_bands; ++i) {
        const int* v = bands + i * kBandInts;
        Band& bd = p.band[i];
        bd.ss = v[0];
        bd.se = v[1];
        bd.row0 = v[2];
        bd.n_levels = v[3];
        for (int l = 0; l < kMaxLevels; ++l) bd.gen_cap[l] = v[4 + l];
        bd.cap_band = v[4 + kMaxLevels];
        if (bd.ss < 0 || bd.ss >= bd.se || bd.se > 64 || bd.n_levels < 0 ||
            bd.n_levels > kMaxLevels || bd.cap_band > cap_f)
            return (int)cudaErrorInvalidValue;
        p.ss_min = bd.ss < p.ss_min ? bd.ss : p.ss_min;
        p.se_max = bd.se > p.se_max ? bd.se : p.se_max;
    }
    if (Bp > 0) {
        const int threads = 128;
        const long long grid = (Bp + threads - 1) / threads;
        pack_acbands_kernel<<<(unsigned)grid, threads, 0,
                              (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, Bp, (const uint32_t*)act, p,
            (uint32_t*)words, (int32_t*)lens, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
