// Helpers shared by the port's kernels.
//
// Bit words are MSB-aligned 32-bit words carried as uint32 here and as
// int32 tensors (the same bit pattern) on the PyTorch side.  Every entry
// point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() right after its launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#define TPUENC_API extern "C" __attribute__((visibility("default")))

namespace tpuenc {

typedef uint32_t u32;

// Shifts with the guards of pallas_pack._shl / _shr / _mask: an amount of
// 32 or more gives 0 (all ones for the mask); a negative amount counts as
// 0 (jnp.clip(n, 0, 31)).  A C++ shift by >= 32 is undefined.
__device__ __forceinline__ uint32_t shl32(uint32_t x, int n) {
    return n >= 32 ? 0u : x << (n < 0 ? 0 : n);
}

__device__ __forceinline__ uint32_t mask32(int n) {
    return n >= 32 ? 0xFFFFFFFFu : (1u << (n < 0 ? 0 : n)) - 1u;
}

// Magnitude category of a non-negative value: 0 for 0, else its bit
// length (pallas_pack._bit_length).
__device__ __forceinline__ int bit_length(uint32_t av) {
    return av == 0 ? 0 : 32 - __clz(av);
}

// OR a bit string that starts at bit `off` of `row` (capacity `cap`
// words): the word lands in words off>>5 and off>>5 + 1.  Words past the
// capacity are dropped; the callers' overflow flags report that case.
__device__ __forceinline__ void or_at(uint32_t* row, long long cap,
                                      long long off, uint32_t w) {
    const long long d = off >> 5;
    const int ph = (int)(off & 31);
    if (d < cap) atomicOr(row + d, w >> ph);
    if (ph != 0 && d + 1 < cap) atomicOr(row + d + 1, w << (32 - ph));
}

// Serial writer of one block's bit string into its own row of `cap`
// words (K6, K8): items are appended MSB first through a 64-bit
// accumulator; words past the capacity are dropped (the overflow flags
// report that case) and finish() zero-fills the rest of the row.
struct BitWriter {
    uint32_t* row;
    int cap;
    int w = 0;
    int n = 0;          // bits held in acc, MSB-aligned at bit 63
    uint64_t acc = 0;

    // Append an MSB-aligned item of `len` <= 32 bits.
    __device__ __forceinline__ void put(uint32_t word, int len) {
        if (len <= 0) return;
        acc |= (uint64_t)word << (32 - n);
        n += len;
        if (n >= 32) {
            if (w < cap) row[w] = (uint32_t)(acc >> 32);
            ++w;
            acc <<= 32;
            n -= 32;
        }
    }

    __device__ __forceinline__ void finish() {
        if (n > 0) {
            if (w < cap) row[w] = (uint32_t)(acc >> 32);
            ++w;
        }
        for (; w < cap; ++w) row[w] = 0;
    }
};

// ---------------------------------------------------------------------------
// fDCT + zigzag + quantize of one 8x8 block held in registers (K1, K8).
//
// libjpeg's islow LL&M transform (CONST_BITS 13, PASS1_BITS 2, round-half-up
// descale) and the reciprocal quantizer ((|v| + corr) * recip) >> 15 with
// the sign restored, all with the wrap-around of JAX's int32: sums and
// products are taken in uint32 (C++ signed overflow is undefined) and only
// shifts run on the signed value.
// ---------------------------------------------------------------------------

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

__device__ __forceinline__ u32 descale(u32 x, int n) {
    return (u32)((int32_t)(x + (1u << (n - 1))) >> n);
}

__device__ __forceinline__ u32 mul(u32 x, int c) { return x * (u32)c; }

// One 8-point LL&M butterfly in place (kernels/fdct.py:_dct_1d).
template <bool FIRST>
__device__ __forceinline__ void llm(u32 (&v)[8]) {
    const u32 tmp0 = v[0] + v[7], tmp7 = v[0] - v[7];
    const u32 tmp1 = v[1] + v[6], tmp6 = v[1] - v[6];
    const u32 tmp2 = v[2] + v[5], tmp5 = v[2] - v[5];
    const u32 tmp3 = v[3] + v[4], tmp4 = v[3] - v[4];
    const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const int shift = FIRST ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;

    if (FIRST) {
        v[0] = (tmp10 + tmp11) << PASS1_BITS;
        v[4] = (tmp10 - tmp11) << PASS1_BITS;
    } else {
        v[0] = descale(tmp10 + tmp11, PASS1_BITS);
        v[4] = descale(tmp10 - tmp11, PASS1_BITS);
    }
    u32 z1 = mul(tmp12 + tmp13, 4433);                      // FIX_0_541196100
    v[2] = descale(z1 + mul(tmp13, 6270), shift);            // FIX_0_765366865
    v[6] = descale(z1 + mul(tmp12, -15137), shift);          // FIX_1_847759065

    z1 = tmp4 + tmp7;
    u32 z2 = tmp5 + tmp6;
    u32 z3 = tmp4 + tmp6;
    u32 z4 = tmp5 + tmp7;
    const u32 z5 = mul(z3 + z4, 9633);                       // FIX_1_175875602
    const u32 t4 = mul(tmp4, 2446);                          // FIX_0_298631336
    const u32 t5 = mul(tmp5, 16819);                         // FIX_2_053119869
    const u32 t6 = mul(tmp6, 25172);                         // FIX_3_072711026
    const u32 t7 = mul(tmp7, 12299);                         // FIX_1_501321110
    z1 = mul(z1, -7373);                                     // FIX_0_899976223
    z2 = mul(z2, -20995);                                    // FIX_2_562915447
    z3 = mul(z3, -16069) + z5;                               // FIX_1_961570560
    z4 = mul(z4, -3196) + z5;                                // FIX_0_390180644

    v[7] = descale(t4 + z1 + z3, shift);
    v[5] = descale(t5 + z2 + z4, shift);
    v[3] = descale(t6 + z2 + z3, shift);
    v[1] = descale(t7 + z1 + z4, shift);
}

// The 2-D transform of a block in natural order (s[y*8 + x]), in place.
__device__ __forceinline__ void fdct_8x8(u32 (&s)[64]) {
    // Pass 1: rows of the block (combine the 8 x of each y).
#pragma unroll
    for (int y = 0; y < 8; ++y) {
        u32 d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = s[y * 8 + i];
        llm<true>(d);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[y * 8 + i] = d[i];
    }
    // Pass 2: columns (combine the 8 y of each x).
#pragma unroll
    for (int xi = 0; xi < 8; ++xi) {
        u32 d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = s[i * 8 + xi];
        llm<false>(d);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i * 8 + xi] = d[i];
    }
}

// One coefficient through the reciprocal quantizer, truncated to int16 as
// K1 stores it.
__device__ __forceinline__ int quantize(u32 s, int32_t recip, int32_t corr) {
    const int32_t v = (int32_t)s;
    const u32 absv = v < 0 ? 0u - s : s;
    const u32 prod = (absv + (u32)corr) * (u32)recip;
    const u32 q = (u32)((int32_t)prod >> 15);
    return (int16_t)(v < 0 ? 0u - q : q);
}

// Natural index of zigzag position j (core.tables.ZIGZAG).
__host__ __device__ constexpr int zigzag_natural(int j) {
    constexpr int t[64] = {
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    };
    return t[j];
}

// Evaluated by the compiler's front end, so every register index below is a
// constant and the arrays never go to local memory.
template <int J>
constexpr int kNatural = zigzag_natural(J);

template <int... J>
__device__ __forceinline__ void quantize_zigzag_(
        const u32 (&s)[64], const int32_t* __restrict__ recip,
        const int32_t* __restrict__ corr, int (&q)[64],
        std::integer_sequence<int, J...>) {
    ((q[J] = quantize(s[kNatural<J>], recip[J], corr[J])), ...);
}

// q[j] = the quantized coefficient at zigzag position j of the transformed
// block s; recip/corr are the table's 64 zigzag-ordered entries.
__device__ __forceinline__ void quantize_zigzag(
        const u32 (&s)[64], const int32_t* __restrict__ recip,
        const int32_t* __restrict__ corr, int (&q)[64]) {
    quantize_zigzag_(s, recip, corr, q, std::make_integer_sequence<int, 64>{});
}

// ---------------------------------------------------------------------------
// P1 of one block (K8): the body of pallas_pack._p1_tile_body.
// ---------------------------------------------------------------------------

struct P1Caps {
    int cap8, cap16, cap32, cap64, cap_final;  // block_caps()[2..5], +1
};

// Writes the block's bit string through `bw` and returns its length in
// bits: the DC difference item (when emit_dc), then for each nonzero
// coefficient of the band [ss, se) its (run, size) code and magnitude
// bits, a ZRL code in each zero slot whose run reaches 16/32/48 before the
// last nonzero, and EOB when the last nonzero lies below se-1.  Sets `ovf`
// where the TPU kernel sets its flag: when an aligned window of 8/16/32/64
// slot items exceeds 32 x its cap, or the block with its EOB exceeds
// 32 x cap_final.  `dct` is the block's DC table row (16 entries), `act`
// its AC table (256); entries are size << 16 | code.
__device__ __forceinline__ int p1_block(const int (&c)[64], int32_t diff,
                                        bool emit_dc, int ss, int se,
                                        const uint32_t* dct,
                                        const uint32_t* act, const P1Caps& cp,
                                        BitWriter& bw, bool& ovf) {
    int last = -1;  // last nonzero slot of the band
#pragma unroll
    for (int k = 0; k < 64; ++k)
        if (k >= ss && k < se && c[k] != 0) last = k;

    const uint32_t zrl = act[0xF0];
    const int zrl_hs = (int)(zrl >> 16);
    const uint32_t zrl_w = shl32(zrl & 0xFFFF, 32 - zrl_hs);

    int s8 = 0, s16 = 0, s32 = 0, s64 = 0;
    int prev = ss - 1;  // previous nonzero slot of the band
#pragma unroll
    for (int k = 0; k < 64; ++k) {
        int len = 0;
        uint32_t word = 0;
        if (k == 0 && emit_dc) {
            const int size = bit_length(diff < 0 ? 0u - (uint32_t)diff
                                                  : (uint32_t)diff);
            const uint32_t extra = (uint32_t)(diff - (diff < 0)) & mask32(size);
            const uint32_t lut = size < 16 ? dct[size] : 0u;
            len = (int)(lut >> 16) + size;
            word = shl32(shl32(lut & 0xFFFF, size) | extra, 32 - len);
        } else if (k >= ss && k < se) {
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
            ovf |= s8 > 32 * cp.cap8;
            s16 += s8;
            s8 = 0;
        }
        if ((k & 15) == 15) {
            ovf |= s16 > 32 * cp.cap16;
            s32 += s16;
            s16 = 0;
        }
        if ((k & 31) == 31) {
            ovf |= s32 > 32 * cp.cap32;
            s64 += s32;
            s32 = 0;
        }
    }
    ovf |= s64 > 32 * cp.cap64;

    int total = s64;
    if (last < se - 1) {
        const uint32_t eob = act[0];
        int hs = (int)(eob >> 16);
        hs = hs < 32 ? hs : 32;
        bw.put(shl32(eob & 0xFFFF, 32 - hs), hs);
        total += (int)(eob >> 16);
    }
    ovf |= total > 32 * cp.cap_final;
    bw.finish();
    return total;
}

// ---------------------------------------------------------------------------
// P1 of one block without branches (K2): p1_block's bit string, window sums
// and flag, written into a row that is zero beforehand.  K8 still runs
// p1_block; its redesign moves it to pack_block, so one P1 body is kept.
// ---------------------------------------------------------------------------

// Appends an MSB-aligned item of len <= 32 bits (zero past len) to the
// word being filled (`cur`, `nb` < 32 bits in it); a full word goes to
// row[w] while w < cap, and w counts it either way.
__device__ __forceinline__ void append(uint32_t word, int len, uint32_t& cur,
                                       int& nb, int& w, uint32_t* row,
                                       int cap) {
    cur |= word >> nb;
    const uint32_t spill = __funnelshift_lc(0u, word, 32 - nb);
    nb += len;
    const bool full = nb >= 32;
    if (full && w < cap) row[w] = cur;
    w += full;
    cur = full ? spill : cur;
    nb -= full ? 32 : 0;
}

// The block's bit string into `row` (cap_final words, zero beforehand) and
// its length in bits, with p1_block's items, window sums and flag.  Every
// slot's item is computed and selected, and its bits are appended to a
// 32-bit word by funnel shifts.  The symbol (run & 15) << 4 | size stays
// below 256 (size 16 only sets a bit the run's nibble already has), so it
// indexes the AC table directly.
__device__ __forceinline__ int pack_block(const int (&c)[64], int32_t diff,
                                          bool emit_dc, int ss, int se,
                                          const uint32_t* dct,
                                          const uint32_t* act,
                                          const P1Caps& cp, uint32_t* row,
                                          bool& ovf) {
    int last = -1;  // last nonzero slot of the band
#pragma unroll
    for (int k = 0; k < 64; ++k)
        if (k >= ss && k < se && c[k] != 0) last = k;

    const uint32_t zrl = act[0xF0];
    const int zrl_len = (int)(zrl >> 16);
    const uint32_t zrl_w = shl32(zrl & 0xFFFF, 32 - zrl_len);
    const int cap = cp.cap_final;

    uint32_t cur = 0;
    int nb = 0;
    int w = 0;
    int s8 = 0, s16 = 0, s32 = 0, s64 = 0;
    int prev = ss - 1;  // previous nonzero slot of the band
#pragma unroll
    for (int k = 0; k < 64; ++k) {
        int len = 0;
        uint32_t word = 0;
        if (k == 0 && emit_dc) {
            const int size = bit_length(diff < 0 ? 0u - (uint32_t)diff
                                                  : (uint32_t)diff);
            const uint32_t extra = (uint32_t)(diff - (diff < 0)) & mask32(size);
            const uint32_t lut = size < 16 ? dct[size] : 0u;
            len = (int)(lut >> 16) + size;
            word = shl32(shl32(lut & 0xFFFF, size) | extra, 32 - len);
        } else if (k >= ss && k < se) {
            const int v = c[k];
            const bool nz = v != 0;
            const int run = k - prev - 1;
            const int size = bit_length((uint32_t)(v < 0 ? -v : v));
            const uint32_t extra = (uint32_t)(v + (v >> 31)) & ((1u << size) - 1u);
            const uint32_t lut = nz ? act[((run & 15) << 4) | size] : 0u;
            const int ilen = (int)(lut >> 16) + size;
            // ilen is 0 only where v is 0; the funnel shift wraps 32 to 0.
            const uint32_t iword = __funnelshift_l(
                0u, ((lut & 0xFFFFu) << size) | extra, 32 - ilen);
            const bool zrl_here = !nz && (run & 15) == 15 && k < last;
            len = nz ? ilen : (zrl_here ? zrl_len : 0);
            word = nz ? iword : (zrl_here ? zrl_w : 0u);
            prev = nz ? k : prev;
        }
        append(word, len, cur, nb, w, row, cap);
        s8 += len;
        if ((k & 7) == 7) {
            ovf |= s8 > 32 * cp.cap8;
            s16 += s8;
            s8 = 0;
        }
        if ((k & 15) == 15) {
            ovf |= s16 > 32 * cp.cap16;
            s32 += s16;
            s16 = 0;
        }
        if ((k & 31) == 31) {
            ovf |= s32 > 32 * cp.cap32;
            s64 += s32;
            s32 = 0;
        }
    }
    ovf |= s64 > 32 * cp.cap64;

    int total = s64;
    if (last < se - 1) {
        const uint32_t eob = act[0];
        const int hs = min((int)(eob >> 16), 32);
        append(shl32(eob & 0xFFFF, 32 - hs), hs, cur, nb, w, row, cap);
        total += (int)(eob >> 16);
    }
    ovf |= total > 32 * cap;
    if (nb > 0 && w < cap) row[w] = cur;
    return total;
}

}  // namespace tpuenc
