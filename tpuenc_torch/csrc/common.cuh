// Helpers shared by the port's kernels.
//
// Bit words are MSB-aligned 32-bit words carried as uint32 here and as
// int32 tensors (the same bit pattern) on the PyTorch side.  Every entry
// point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() right after its launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>
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

// Serial writer of one block's bit string into its own row of `cap`
// words, used by K6 alone (K2 and K8 run pack_block below): items are
// appended MSB first through a 64-bit accumulator; words past the capacity
// are dropped (the overflow flags report that case) and finish()
// zero-fills the rest of the row.
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
// P1 of one block (K2, K8): the body of pallas_pack._p1_tile_body, without
// branches, written into a row that is zero beforehand.
// ---------------------------------------------------------------------------

struct P1Caps {
    int cap8, cap16, cap32, cap64, cap_final;  // block_caps()[2..5], +1
};

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

// The block's bit string into `row` (cap_final words, zero beforehand;
// words past it are dropped) and its length in bits: the DC difference
// item (when emit_dc), then for each nonzero coefficient of the band
// [ss, se) its (run, size) code and magnitude bits, a ZRL code in each zero
// slot whose run reaches 16/32/48 before the last nonzero, and EOB when the
// last nonzero lies below se-1.  Sets `ovf` where the TPU kernel sets its
// flag: when an aligned window of 8/16/32/64 slot items exceeds 32 x its
// cap, or the block with its EOB exceeds 32 x cap_final.  `dct` is the
// block's DC table row (16 entries), `act` its AC table (256); entries are
// size << 16 | code.  Every slot's item is computed and selected, and its
// bits are appended to a 32-bit word by funnel shifts.  The symbol
// (run & 15) << 4 | size stays below 256 (size 16 only sets a bit the run's
// nibble already has), so it indexes the AC table directly.
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


// ---------------------------------------------------------------------------
// The staged P1 tile (K2, K8).  A thread block packs kP1Threads consecutive
// blocks, one a thread.  It stages the scan's AC tables (those the pattern
// names, <= 8 x 256 entries) and DC table rows (128) in shared memory and
// zeroes a shared tile of kP1Threads x capB words (p1_stage); each thread
// writes its block's string with pack_block into its row of the tile
// (p1_pack); after a barrier the tile's rows, which are consecutive rows
// of `words`, go out, zero tails and padding rows (b >= n_blocks)
// included, as one contiguous run of 16-byte stores, consecutive across
// the threads (p1_store).  The kernels differ only in how a thread gets
// its 64 coefficients and its DC difference.  cap_final is odd at the
// budgets the encoder uses (19, 51, 65), so the threads' rows start on
// different banks.
// ---------------------------------------------------------------------------

constexpr int kP1Threads = 128;  // blocks per tile
constexpr int kMaxPattern = 16;
constexpr int kMaxTables = 8;
constexpr int kDcEntries = 16 * kMaxTables;

struct P1Scan {
    int pat;                   // blocks per repeating table pattern
    int dc_tab[kMaxPattern];   // DC table id per pattern position
    int ac_tab[kMaxPattern];   // AC table id per pattern position
    int n_ac;                  // AC tables staged: max(ac_tab) + 1
    int ss, se, emit_dc;       // spectral band [ss, se); DC item or not
    P1Caps caps;
};

// The scan of an entry point's arguments (pattern: dc_tab[pat], then
// ac_tab[pat]; caps: the five P1 caps); false where one is out of range.
inline bool p1_scan(const int* pattern, int pat, int ss, int se, int emit_dc,
                    const int* caps, P1Scan& s) {
    if (pat < 1 || pat > kMaxPattern || caps[4] < 1) return false;
    s.pat = pat;
    s.n_ac = 1;
    for (int i = 0; i < pat; ++i) {
        s.dc_tab[i] = pattern[i];
        s.ac_tab[i] = pattern[pat + i];
        if (s.dc_tab[i] < 0 || s.dc_tab[i] >= kMaxTables || s.ac_tab[i] < 0 ||
            s.ac_tab[i] >= kMaxTables)
            return false;
        s.n_ac = s.ac_tab[i] + 1 > s.n_ac ? s.ac_tab[i] + 1 : s.n_ac;
    }
    s.ss = ss;
    s.se = se;
    s.emit_dc = emit_dc;
    s.caps = {caps[0], caps[1], caps[2], caps[3], caps[4]};
    return true;
}

// Bytes of dynamic shared memory the tile takes: [AC tables: n_ac x 256]
// [DC rows: 128][rows: kP1Threads x capB], each part on a 16-byte
// boundary.  cap_final <= 65 (block_caps doubles from 1 six times), so it
// stays under 42 KB.
inline size_t p1_smem(const P1Scan& s) {
    return sizeof(uint32_t) * ((size_t)256 * s.n_ac + kDcEntries +
                               (size_t)kP1Threads * s.caps.cap_final);
}

struct P1Tile {
    uint32_t* act;   // AC tables
    uint32_t* dct;   // DC table rows
    uint32_t* rows;  // kP1Threads x capB
};

// Stages the tables and zeroes the rows; the caller's barrier publishes
// them.
__device__ __forceinline__ P1Tile p1_stage(uint32_t* smem, const P1Scan& s,
                                           const uint32_t* __restrict__ dc_tab,
                                           const uint32_t* __restrict__ ac_tab) {
    P1Tile tile;
    tile.act = smem;
    tile.dct = tile.act + 256 * s.n_ac;
    tile.rows = tile.dct + kDcEntries;
    const int t = threadIdx.x;
    for (int i = t; i < 256 * s.n_ac; i += kP1Threads) tile.act[i] = ac_tab[i];
    for (int i = t; i < kDcEntries; i += kP1Threads) tile.dct[i] = dc_tab[i];
    uint4* rows4 = reinterpret_cast<uint4*>(tile.rows);
    for (int i = t; i < kP1Threads * s.caps.cap_final / 4; i += kP1Threads)
        rows4[i] = make_uint4(0, 0, 0, 0);
    return tile;
}

// Block b (this thread's, in the tile starting at b - threadIdx.x) into
// its row of the tile, with its length; padding blocks n_blocks <= b < Bp
// get length 0.  After the barrier that follows p1_stage.
__device__ __forceinline__ void p1_pack(const P1Tile& tile, const P1Scan& s,
                                        const int (&c)[64], int32_t diff,
                                        long long b, long long n_blocks,
                                        long long Bp, int32_t* __restrict__ lens,
                                        int32_t* __restrict__ overflow) {
    if (b < n_blocks) {
        const int pos = (int)(b % s.pat);
        bool ovf = false;
        lens[b] = pack_block(c, diff, s.emit_dc, s.ss, s.se,
                             tile.dct + 16 * s.dc_tab[pos],
                             tile.act + 256 * s.ac_tab[pos], s.caps,
                             tile.rows + threadIdx.x * s.caps.cap_final, ovf);
        if (ovf) *overflow = 1;
    } else if (b < Bp) {
        lens[b] = 0;
    }
}

// The tile's rows [b0, min(b0 + kP1Threads, Bp)) out to `words` (Bp x
// capB); after the barrier that follows p1_pack.  b0 x capB is a multiple
// of 4 words, so the 16-byte stores stay aligned when `words` is.
__device__ __forceinline__ void p1_store(const P1Tile& tile, int capB,
                                         long long b0, long long Bp,
                                         uint32_t* __restrict__ words) {
    const int t = threadIdx.x;
    const long long rows = Bp - b0 < kP1Threads ? Bp - b0 : kP1Threads;
    const int n = (int)rows * capB;
    uint32_t* dst = words + b0 * capB;
    int head = 0;  // words stored by the 16-byte stores
    if ((reinterpret_cast<uintptr_t>(words) & 15) == 0) {
        const uint4* src4 = reinterpret_cast<const uint4*>(tile.rows);
        uint4* dst4 = reinterpret_cast<uint4*>(dst);
        for (int i = t; i < n / 4; i += kP1Threads) dst4[i] = src4[i];
        head = n / 4 * 4;
    }
    for (int i = head + t; i < n; i += kP1Threads) dst[i] = tile.rows[i];
}

// ---------------------------------------------------------------------------
// The bit gather of P2-P4 (K3/K4, K5): output word [bit, bit + 32) of rows
// that are concatenated in order, row i starting at bit pref[i] and ending
// at pref[i + 1].  `pref` is any type with a nondecreasing operator[] over
// [0, n_rows]: shared memory for K3/K4, device memory for K5.
// ---------------------------------------------------------------------------

// The largest m in [lo, hi] with pref[m] <= x (pref[lo] <= x).
template <class Prefix>
__device__ __forceinline__ int last_at_most(const Prefix& pref, int lo, int hi,
                                            long long x) {
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pref[mid] <= x) {
            lo = mid;
        } else {
            hi = mid - 1;
        }
    }
    return lo;
}

// Output word [bit, bit + 32) of the rows of `width` words at X, for
// pref[0] <= bit < pref[n_rows]: a binary search finds the first row that
// ends past bit, and the bits of every row that overlaps the word (one
// funnel shift of two adjacent source words per row; a word may span many
// short rows) are ORed in a register.  A stretch of empty rows is crossed
// by one more search.  Word j of a row counts where 32j < its length and
// j < width (merge_rows_ref's and concat_rows_ref's `active`); rows are
// zero past their lengths and never share bits, so the OR is the
// concatenation.
template <class Prefix>
__device__ __forceinline__ uint32_t gather_word(const uint32_t* __restrict__ X,
                                                const Prefix& pref, int n_rows,
                                                int width, long long bit) {
    int i = last_at_most(pref, 0, n_rows, bit);
    uint32_t word = 0;
    while (i < n_rows) {
        const long long start = pref[i];
        if (start >= bit + 32) break;
        const long long end = pref[i + 1];
        if (end == start) {
            // Rows i.. are empty up to the first that starts later.
            i = last_at_most(pref, i + 1, n_rows, start);
            continue;
        }
        // The row starts d bits before this word (d > -32; j = -1 where it
        // starts inside it).
        const long long n_words = min((long long)width, (end - start + 31) >> 5);
        const long long d = bit - start;
        const long long j = d >> 5;
        const int sh = (int)(d & 31);
        const uint32_t* src = X + (long long)i * width;
        const uint32_t hi_w = j >= 0 && j < n_words ? src[j] : 0u;
        const uint32_t lo_w = sh != 0 && j + 1 < n_words ? src[j + 1] : 0u;
        word |= __funnelshift_l(lo_w, hi_w, sh);
        ++i;
    }
    return word;
}

// What a launcher needs of a card to size a grid that fills it once,
// asked once per device: its SMs, the shared memory of one SM, and what
// the runtime reserves of it per thread block.
struct CardLimits {
    int sms = 0;
    int smem_per_sm = 0;
    int reserved_per_block = 0;
};

constexpr int kMaxDevices = 64;

// The current device's limits; nullptr for a device id past kMaxDevices.
inline const CardLimits* card_limits() {
    static CardLimits limits[kMaxDevices];
    static std::once_flag once[kMaxDevices];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= kMaxDevices) return nullptr;
    std::call_once(once[dev], [dev] {
        CardLimits& c = limits[dev];
        cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&c.smem_per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        cudaDeviceGetAttribute(&c.reserved_per_block,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
    });
    return &limits[dev];
}

// Thread blocks resident on the card at once, each holding `smem` bytes
// of shared memory, at most `max_per_sm` on an SM (at least one).
inline long long resident_blocks(const CardLimits& card, size_t smem,
                                 int max_per_sm) {
    long long per_sm = card.smem_per_sm / ((long long)smem + card.reserved_per_block);
    per_sm = per_sm < max_per_sm ? per_sm : max_per_sm;
    return (long long)card.sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace tpuenc
