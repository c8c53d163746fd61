// K2: P1 of the entropy packer, one Huffman bit string per block.
//
// Replaces tpuenc/entropy/pallas_pack.py:_pack_tile_kernel (body
// _p1_tile_body; built by _build_pack_blocks_fn, entry scan_pack_blocks).
// Per block it emits the DC difference item, then for each nonzero AC
// coefficient of the band its (run, size) code and magnitude bits, a ZRL
// code in each zero slot whose run reaches 16/32/48 before the last
// nonzero, and EOB when the last nonzero lies below se-1.  Output: words
// (Bp, capB) MSB-aligned, zero past the length; lens (Bp,); and one
// overflow flag, set exactly where the TPU kernel sets its own: when an
// aligned window of 8/16/32/64 slot items exceeds 32 x block_caps()[2..5]
// bits, or the block with its EOB exceeds 32 x cap_final.  Padding blocks
// (b >= n_blocks) have length 0.
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

using tpuenc::bit_length;
using tpuenc::BitWriter;
using tpuenc::mask32;
using tpuenc::shl32;

constexpr int kMaxPattern = 16;

struct PackParams {
    int pat;                   // blocks per repeating table pattern
    int dc_tab[kMaxPattern];   // DC table id per pattern position
    int ac_tab[kMaxPattern];   // AC table id per pattern position
    int ss, se, emit_dc;       // spectral band [ss, se); DC item or not
    int cap8, cap16, cap32, cap64, cap_final;  // block_caps()[2..5], +1
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
    bw.row = words + b * p.cap_final;
    bw.cap = p.cap_final;
    if (b >= n_blocks) {
        bw.finish();
        lens[b] = 0;
        return;
    }
    const int pos = (int)(b % p.pat);
    const uint32_t* act = ac_tab + 256 * p.ac_tab[pos];

    int c[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) c[k] = q[k * n_blocks + b];

    int last = -1;  // last nonzero slot of the band
#pragma unroll
    for (int k = 0; k < 64; ++k)
        if (k >= p.ss && k < p.se && c[k] != 0) last = k;

    const uint32_t zrl = act[0xF0];
    const int zrl_hs = (int)(zrl >> 16);
    const uint32_t zrl_w = shl32(zrl & 0xFFFF, 32 - zrl_hs);

    bool ovf = false;
    int s8 = 0, s16 = 0, s32 = 0, s64 = 0;
    int prev = p.ss - 1;  // previous nonzero slot of the band
#pragma unroll
    for (int k = 0; k < 64; ++k) {
        int len = 0;
        uint32_t word = 0;
        if (k == 0 && p.emit_dc) {
            const int32_t diff = dcdiff[b];
            const int size = bit_length(diff < 0 ? 0u - (uint32_t)diff
                                                  : (uint32_t)diff);
            const uint32_t extra = (uint32_t)(diff - (diff < 0)) & mask32(size);
            const uint32_t lut =
                size < 16 ? dc_tab[p.dc_tab[pos] * 16 + size] : 0u;
            len = (int)(lut >> 16) + size;
            word = shl32(shl32(lut & 0xFFFF, size) | extra, 32 - len);
        } else if (k >= p.ss && k < p.se) {
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
            ovf |= s8 > 32 * p.cap8;
            s16 += s8;
            s8 = 0;
        }
        if ((k & 15) == 15) {
            ovf |= s16 > 32 * p.cap16;
            s32 += s16;
            s16 = 0;
        }
        if ((k & 31) == 31) {
            ovf |= s32 > 32 * p.cap32;
            s64 += s32;
            s32 = 0;
        }
    }
    ovf |= s64 > 32 * p.cap64;

    int total = s64;
    if (last < p.se - 1) {
        const uint32_t eob = act[0];
        int hs = (int)(eob >> 16);
        hs = hs < 32 ? hs : 32;
        bw.put(shl32(eob & 0xFFFF, 32 - hs), hs);
        total += (int)(eob >> 16);
    }
    ovf |= total > 32 * p.cap_final;
    bw.finish();
    lens[b] = total;
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
    p.cap8 = caps[0];
    p.cap16 = caps[1];
    p.cap32 = caps[2];
    p.cap64 = caps[3];
    p.cap_final = caps[4];
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
