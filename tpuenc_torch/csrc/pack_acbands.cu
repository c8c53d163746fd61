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
// when the band's last nonzero lies below se - 1.  The bands are disjoint
// (a slot belongs to one band only; the launcher refuses others) and may
// come in any order of slots: band i of the arguments is row i of the
// outputs.  Output per band: words (Bp, cap_f) MSB-aligned and zero past
// the length, lens (Bp,); one overflow flag for all bands, set exactly
// where the TPU kernel sets its own, which follows band_tree_caps and not
// K2's windows:
//   * each aligned 8-slot chunk of the band rows [8*row0, 8*row1) against
//     32 x block_caps()[2] bits; in a chunk two bands share, each band
//     counts only its own items;
//   * the pairwise levels over the band's chunks, counted from row0 and
//     padded to a power of two, against 32 x gen_caps;
//   * the band with its EOB against 32 x cap_band.
// Each band's string is clipped at cap_band words, as the TPU's final
// merge clips it, and zero-padded to cap_f = max(cap_band).  Padding
// blocks (b >= n_blocks) have length 0 in every band.
//
// Bound on the card: bytes at the least (7.2 MB of coefficients read and
// up to 8 MB of strings written at the flagship, 4.6 us), in practice the
// instructions of ~63 serial slot steps per block, one thread per block,
// as K2, at ~13 warps an SM (56,250 blocks at the flagship).  The first
// design ran K2's first design once per band: a serial bit writer storing
// each word straight to the block's row in device memory (32 rows
// cap_f x 4 bytes apart per warp), a data-dependent branch at every slot,
// Huffman lookups as divergent gathers through L1, and an unrolled walk
// over all 64 slots per band with the band as a predicate (3 x 64 slot
// steps a block at the flagship, where 63 do).
//
// Design: K2's staged tile, carried over to several bands, and one walk
// over a block's slots for all of them.  Each thread block packs kRows
// consecutive blocks, one a thread: it stages the AC table (256 entries)
// and the bands' plans in shared memory and zeroes a shared tile of
// n_bands x kRows x cap_f words, band i's rows being rows [b0, b0 + kRows)
// of words[i].  After the barrier each thread loads its block's
// coefficients of the bands' slots (row k of the input holds slot k of
// consecutive blocks, so each load is coalesced across the warp) into its
// column of a shared 64 x kRows int16 tile, with their nonzero mask.  It
// then walks the bands in slot order and each band's slots once, so the
// work at a band's start (the run resets, the row moves to the band's rows
// of the tile) and at its end (the EOB, the length, the band's windows,
// the last partial word) lies outside the loop over its slots; the band's
// last nonzero, below which a ZRL may go, is one count-leading-zeros of
// the mask.  Each slot's item is common.cuh's ac_item (K2's), appended by
// funnel shifts with a predicated store into the tile (append).  A chunk
// sum restarts at a band's start, so a band ending inside a chunk keeps
// its partial sum; the level sums count chunks from the band's row0.
// After a second barrier each band's rows, zero tails and padding rows
// included, go out as one contiguous run of 16-byte stores (common.cuh's
// p1_store, K2's and K8's).
//
// Why a loop over a staged column and not K2's unrolled walk over
// registers: with the coefficients in registers, the slot must be a
// constant, so the walk is unrolled over all 64 slots and the band's
// start and end are tests of warp-uniform 64-bit masks at every slot.
// That compiled to ~10,000 instructions with the band-boundary work
// predicated into every slot (about 100 instructions a slot), and took
// 0.028 ms of kernel time at the flagship's budget 16 against this loop's
// 0.020 (NVIDIA H100 80GB HBM3, torch.profiler, kernel_ab.py).
//
// Shared memory: 1,024 bytes of table, 8,192 of coefficients and a tile of
// 4 x n_bands x kRows x cap_f bytes: 8,448 at the flagship (3 bands,
// budget 16, cap_f 11), 20,736 at budget 48 (27), 25,344 at 224 (33), and
// 116,480 for seven bands, one of them 65 words wide.  kRows is 64, not
// K2's 128: with the staged coefficients, 128 rows at budget 48 take
// 58,880 bytes, three such blocks fill an SM, and the flagship's 440
// blocks took two waves (device time 0.041 ms against 0.027 with 64 rows,
// same card and script).  Tiles past the default 48 KB take the card's
// opt-in limit, which the launcher asks for once per device
// (cudaFuncSetAttribute).

#include "common.cuh"

namespace {

using tpuenc::shl32;

constexpr int kMaxBands = 7;      // the TPU kernel's bound (lens rows 0..6)
constexpr int kMaxLevels = 3;     // 8 chunks of 8 slots: at most 3 levels
constexpr int kBandInts = 5 + kMaxLevels;
constexpr int kRows = 64;         // blocks a thread block packs, one a thread

struct Band {
    int ss, se;                 // the band [ss, se), ss < se
    int out;                    // its row of words and lens
    int row0;                   // first 8-slot chunk of the band
    int n_levels;               // pairwise levels over its chunks
    int gen_cap[kMaxLevels];    // their word capacities (band_tree_caps)
    int cap_band;               // band string with its EOB, in words
};

struct AcBandsParams {
    int n_bands;
    int cap8;                   // block_caps()[2]: one 8-slot chunk
    int cap_f;                  // output row width: max of cap_band
    uint64_t in_band;           // bit k: slot k lies in a band
    Band band[kMaxBands];       // in slot order
};

__global__ void __launch_bounds__(kRows)
pack_acbands_kernel(const int16_t* __restrict__ q, long long n_blocks,
                    long long Bp, const uint32_t* __restrict__ ac_tab,
                    AcBandsParams p, uint32_t* __restrict__ words,
                    int32_t* __restrict__ lens,
                    int32_t* __restrict__ overflow) {
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ Band bands[kMaxBands];
    const int t = threadIdx.x;
    uint32_t* act = smem;
    uint32_t* tile = smem + 256;
    const int band_words = kRows * p.cap_f;
    // Row k: slot k of the tile's blocks.
    int16_t* coef = reinterpret_cast<int16_t*>(tile + p.n_bands * band_words);
    for (int i = t; i < 256; i += kRows) act[i] = ac_tab[i];
    uint4* tile4 = reinterpret_cast<uint4*>(tile);
    for (int i = t; i < p.n_bands * band_words / 4; i += kRows)
        tile4[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kMaxBands; ++j)
        if (j == t) bands[j] = p.band[j];
    const long long b0 = (long long)blockIdx.x * kRows;
    const long long b = b0 + t;
    // The loads follow the barrier, as K2's do.
    __syncthreads();

    if (b < n_blocks) {
        // The block's coefficients of the bands' slots into its column of
        // coef, and which of them are nonzero.
        uint64_t nz = 0;
        const int16_t* src = q + b;
#pragma unroll
        for (int k = 0; k < 64; ++k, src += n_blocks) {
            const int v = (p.in_band >> k) & 1 ? *src : 0;
            coef[k * kRows + t] = (int16_t)v;
            nz |= (uint64_t)(v != 0) << k;
        }

        const uint32_t zrl = act[0xF0];
        const int zrl_len = (int)(zrl >> 16);
        const uint32_t zrl_w = shl32(zrl & 0xFFFF, 32 - zrl_len);
        const uint32_t eob = act[0];
        const int eob_len = (int)(eob >> 16);
        const int eob_put = eob_len < 32 ? eob_len : 32;
        const uint32_t eob_w = shl32(eob & 0xFFFF, 32 - eob_put);

        bool ovf = false;
        for (int i = 0; i < p.n_bands; ++i) {
            const Band bd = bands[i];
            uint32_t* row = tile + bd.out * band_words + t * p.cap_f;
            const uint64_t below_se = bd.se >= 64 ? ~0ull : (1ull << bd.se) - 1;
            // The band's last nonzero slot, -1 where it has none.
            const int last = 63 - __clzll((long long)(nz & below_se &
                                                      ~((1ull << bd.ss) - 1)));
            uint32_t cur = 0;
            int nb = 0, w = 0, s8 = 0, total = 0, prev = bd.ss - 1;
            int lv[kMaxLevels] = {};  // the open window of each level
#pragma unroll 4
            for (int k = bd.ss; k < bd.se; ++k) {
                uint32_t word;
                const int len = tpuenc::ac_item(coef[k * kRows + t], k,
                                                k < last, act, zrl_w, zrl_len,
                                                prev, word);
                tpuenc::append(word, len, cur, nb, w, row, bd.cap_band);
                s8 += len;
                const bool end = k == bd.se - 1;
                if ((k & 7) == 7 || end) {
                    // The band's share of this chunk closes, and with it
                    // each level's window that ends here or at the band's
                    // end.
                    ovf |= s8 > 32 * p.cap8;
                    const int r = (k >> 3) - bd.row0;
#pragma unroll
                    for (int l = 0; l < kMaxLevels; ++l) {
                        lv[l] += s8;
                        if (end || ((r + 1) & ((2 << l) - 1)) == 0) {
                            ovf |= l < bd.n_levels && lv[l] > 32 * bd.gen_cap[l];
                            lv[l] = 0;
                        }
                    }
                    total += s8;
                    s8 = 0;
                }
            }
            // EOB where the band's last nonzero lies below se - 1.
            const bool with_eob = last < bd.se - 1;
            tpuenc::append(with_eob ? eob_w : 0u, with_eob ? eob_put : 0, cur,
                           nb, w, row, bd.cap_band);
            total += with_eob ? eob_len : 0;
            ovf |= total > 32 * bd.cap_band;
            if (nb > 0 && w < bd.cap_band) row[w] = cur;
            lens[bd.out * Bp + b] = total;
        }
        if (ovf) *overflow = 1;
    } else if (b < Bp) {
        for (int i = 0; i < p.n_bands; ++i) lens[i * Bp + b] = 0;
    }
    __syncthreads();
    for (int i = 0; i < p.n_bands; ++i)
        tpuenc::p1_store(tile + i * band_words, kRows, p.cap_f, b0, Bp,
                         words + i * Bp * p.cap_f);
}

// Dynamic shared memory of a thread block: the AC table, the bands'
// tiles and the coefficients.
size_t tile_smem(int n_bands, int cap_f) {
    return sizeof(uint32_t) * (256 + (size_t)n_bands * kRows * cap_f) +
           sizeof(int16_t) * 64 * kRows;
}

}  // namespace

// bands: per band kBandInts ints (ss, se, row0, n_levels, gen_cap[3],
// cap_band), disjoint, in any order of slots.  act: the component's AC
// table, 256 entries size << 16 | code.
TPUENC_API int tpuenc_pack_acbands(const void* q, long long n_blocks,
                                   long long Bp, const void* act,
                                   int n_bands, const int* bands, int cap8,
                                   int cap_f, void* words, void* lens,
                                   void* overflow, void* stream) {
    if (n_bands < 1 || n_bands > kMaxBands || cap_f < 1)
        return (int)cudaErrorInvalidValue;
    // The bands in slot order; each keeps its place in `bands` as its
    // output row.
    int order[kMaxBands];
    for (int i = 0; i < n_bands; ++i) {
        int j = i;
        for (; j > 0 && bands[order[j - 1] * kBandInts] > bands[i * kBandInts];
             --j)
            order[j] = order[j - 1];
        order[j] = i;
    }
    AcBandsParams p = {};
    p.n_bands = n_bands;
    p.cap8 = cap8;
    p.cap_f = cap_f;
    int prev_se = 0;
    for (int j = 0; j < n_bands; ++j) {
        const int* v = bands + order[j] * kBandInts;
        const int ss = v[0], se = v[1];
        Band& bd = p.band[j];
        bd.ss = ss;
        bd.se = se;
        bd.out = order[j];
        bd.row0 = v[2];
        bd.n_levels = v[3];
        for (int l = 0; l < kMaxLevels; ++l) bd.gen_cap[l] = v[4 + l];
        bd.cap_band = v[4 + kMaxLevels];
        if (ss < prev_se || ss >= se || se > 64 || bd.n_levels < 0 ||
            bd.n_levels > kMaxLevels || bd.cap_band > cap_f)
            return (int)cudaErrorInvalidValue;
        prev_se = se;
        p.in_band |= (se >= 64 ? ~0ull : (1ull << se) - 1) & ~((1ull << ss) - 1);
    }
    if (Bp > 0) {
        const tpuenc::CardLimits* card = tpuenc::card_limits();
        if (card == nullptr) return (int)cudaErrorInvalidDevice;
        // Once per device: the most dynamic shared memory the kernel may
        // take, the card's opt-in limit less the kernel's static shared
        // memory (the bands), and the request for it.
        static size_t limit[tpuenc::kMaxDevices];
        static cudaError_t opt_in[tpuenc::kMaxDevices];
        static std::once_flag once[tpuenc::kMaxDevices];
        const int dev = card->device;
        std::call_once(once[dev], [card, dev] {
            cudaFuncAttributes attr;
            opt_in[dev] = cudaFuncGetAttributes(&attr, pack_acbands_kernel);
            if (opt_in[dev] != cudaSuccess) return;
            limit[dev] = (size_t)card->smem_optin - attr.sharedSizeBytes;
            opt_in[dev] = cudaFuncSetAttribute(
                pack_acbands_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)limit[dev]);
        });
        if (opt_in[dev] != cudaSuccess) return (int)opt_in[dev];
        const size_t smem = tile_smem(n_bands, cap_f);
        if (smem > limit[dev]) return (int)cudaErrorInvalidValue;
        const long long grid = (Bp + kRows - 1) / kRows;
        pack_acbands_kernel<<<(unsigned)grid, kRows, smem,
                              (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, Bp, (const uint32_t*)act, p,
            (uint32_t*)words, (int32_t*)lens, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
