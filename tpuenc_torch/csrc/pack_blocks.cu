// K2: P1 of the entropy packer, one Huffman bit string per block.
//
// Replaces tpuenc/entropy/pallas_pack.py:_pack_tile_kernel (body
// _p1_tile_body; built by _build_pack_blocks_fn, entry scan_pack_blocks).
// Per block it emits the DC difference item, then the AC items of the
// band and the EOB: the bit string of common.cuh's p1_block (K8's body),
// bit for bit.  Output: words (Bp, capB) MSB-aligned, zero past the
// length; lens (Bp,); and one overflow flag, set exactly where the TPU
// kernel sets its own.  Padding blocks (b >= n_blocks) have length 0.
//
// Bound on the card: bytes at the least (21.6 MB of coefficients read and
// 12.8 MB of strings written at the flagship, 10.7 us), in practice the
// instructions of ~64 serial slot steps per block, one thread per block.
// The first design (p1_block writing each block's row straight to device
// memory) spent them on divergent branches, about 90 instructions a slot;
// its stores hit 32 rows capB x 4 bytes apart per warp, one sector per
// lane, and its Huffman lookups were divergent gathers through L1.
//
// Design: each thread block packs a tile of kThreads consecutive blocks.
// It stages the scan's AC tables (those the pattern names, <= 8 x 256
// entries) and DC table rows (128) in shared memory and zeroes a
// shared-memory tile of kThreads x capB words.  Each thread loads its
// block's 64 coefficients into registers (row k of the (64, B) input holds
// slot k of consecutive blocks, so each load is coalesced across the
// warp) and walks the slots with common.cuh's branch-free body
// (pack_block): every slot's item is computed and selected, and its bits
// are appended to a 32-bit word being filled, by funnel shifts, which a
// predicated store puts in the thread's row of the tile when it fills.  The tile's rows are
// consecutive rows of `words`, so once the block has synchronised, the
// whole tile, zero tails included, goes out as one contiguous run of
// 16-byte stores, consecutive across the threads.  cap_final is odd at
// the budgets the encoder uses (19, 51, 65), so the threads' rows start on
// different banks.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // blocks per tile
constexpr int kMaxPattern = 16;
constexpr int kMaxTables = 8;
constexpr int kDcEntries = 16 * kMaxTables;

struct PackParams {
    int pat;                   // blocks per repeating table pattern
    int dc_tab[kMaxPattern];   // DC table id per pattern position
    int ac_tab[kMaxPattern];   // AC table id per pattern position
    int n_ac;                  // AC tables staged: max(ac_tab) + 1
    int ss, se, emit_dc;       // spectral band [ss, se); DC item or not
    tpuenc::P1Caps caps;
};

__global__ void __launch_bounds__(kThreads)
pack_blocks_kernel(const int16_t* __restrict__ q, long long n_blocks,
                   long long Bp, const int32_t* __restrict__ dcdiff,
                   const uint32_t* __restrict__ dc_tab,
                   const uint32_t* __restrict__ ac_tab, PackParams p,
                   uint32_t* __restrict__ words, int32_t* __restrict__ lens,
                   int32_t* __restrict__ overflow) {
    // [AC tables: n_ac x 256][DC rows: 128][tile: kThreads x capB]; every
    // part starts on a 16-byte boundary.
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* act = smem;
    uint32_t* dct = act + 256 * p.n_ac;
    uint32_t* tile = dct + kDcEntries;
    const int t = threadIdx.x;
    const int capB = p.caps.cap_final;
    for (int i = t; i < 256 * p.n_ac; i += kThreads) act[i] = ac_tab[i];
    for (int i = t; i < kDcEntries; i += kThreads) dct[i] = dc_tab[i];
    uint4* tile4 = reinterpret_cast<uint4*>(tile);
    for (int i = t; i < kThreads * capB / 4; i += kThreads)
        tile4[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();

    const long long b0 = (long long)blockIdx.x * kThreads;
    const long long b = b0 + t;
    if (b < n_blocks) {
        const int pos = (int)(b % p.pat);
        int c[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) c[k] = q[k * n_blocks + b];
        bool ovf = false;
        lens[b] = tpuenc::pack_block(c, p.emit_dc ? dcdiff[b] : 0, p.emit_dc,
                                     p.ss, p.se, dct + 16 * p.dc_tab[pos],
                                     act + 256 * p.ac_tab[pos], p.caps,
                                     tile + t * capB, ovf);
        if (ovf) *overflow = 1;
    } else if (b < Bp) {
        lens[b] = 0;
    }
    __syncthreads();

    // Rows [b0, b0 + rows) of `words` are tile[0, rows x capB); b0 x capB
    // is a multiple of 4 words.
    const long long rows = Bp - b0 < kThreads ? Bp - b0 : kThreads;
    const int n = (int)rows * capB;
    uint32_t* dst = words + b0 * capB;
    int head = 0;  // words stored by the 16-byte stores
    if ((reinterpret_cast<uintptr_t>(words) & 15) == 0) {
        uint4* dst4 = reinterpret_cast<uint4*>(dst);
        for (int i = t; i < n / 4; i += kThreads) dst4[i] = tile4[i];
        head = n / 4 * 4;
    }
    for (int i = head + t; i < n; i += kThreads) dst[i] = tile[i];
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
    p.n_ac = 1;
    for (int i = 0; i < pat; ++i) {
        p.dc_tab[i] = pattern[i];
        p.ac_tab[i] = pattern[pat + i];
        if (p.dc_tab[i] < 0 || p.dc_tab[i] >= kMaxTables || p.ac_tab[i] < 0 ||
            p.ac_tab[i] >= kMaxTables)
            return (int)cudaErrorInvalidValue;
        p.n_ac = p.ac_tab[i] + 1 > p.n_ac ? p.ac_tab[i] + 1 : p.n_ac;
    }
    p.ss = ss;
    p.se = se;
    p.emit_dc = emit_dc;
    p.caps = {caps[0], caps[1], caps[2], caps[3], caps[4]};
    // cap_final <= 65 (block_caps doubles from 1 six times), so the tables
    // and the tile stay under the 48 KB a thread block may take by default.
    const size_t smem = sizeof(uint32_t) *
        ((size_t)256 * p.n_ac + kDcEntries + (size_t)kThreads * p.caps.cap_final);
    if (p.caps.cap_final < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (Bp > 0) {
        const long long grid = (Bp + kThreads - 1) / kThreads;
        pack_blocks_kernel<<<(unsigned)grid, kThreads, smem,
                             (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, Bp, (const int32_t*)dcdiff,
            (const uint32_t*)dc_tab, (const uint32_t*)ac_tab, p,
            (uint32_t*)words, (int32_t*)lens, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
