// K2: P1 of the entropy packer, one Huffman bit string per block.
//
// Replaces tpuenc/entropy/pallas_pack.py:_pack_tile_kernel (body
// _p1_tile_body; built by _build_pack_blocks_fn, entry scan_pack_blocks).
// Per block it emits the DC difference item, then the AC items of the
// band and the EOB: the bit string of common.cuh's pack_block, the one P1
// body of the port (K8 runs it too), bit for bit.  Output: words (Bp,
// capB) MSB-aligned, zero past the length; lens (Bp,); and one overflow
// flag, set exactly where the TPU kernel sets its own.  Padding blocks
// (b >= n_blocks) have length 0.
//
// Bound on the card: bytes at the least (21.6 MB of coefficients read and
// 12.8 MB of strings written at the flagship, 10.7 us), in practice the
// instructions of ~64 serial slot steps per block, one thread per block.
// The first design (a serial bit writer storing each block's row straight
// to device memory) spent them on divergent branches, about 90
// instructions a slot; its stores hit 32 rows capB x 4 bytes apart per
// warp, one sector per lane, and its Huffman lookups were divergent
// gathers through L1.
//
// Design: common.cuh's staged P1 tile, shared with K8.  Each thread block
// packs kP1Threads consecutive blocks: it stages the scan's tables in
// shared memory and zeroes a shared tile of kP1Threads x capB words
// (p1_stage).  Each thread loads its block's 64 coefficients into
// registers (row k of the (64, B) input holds slot k of consecutive
// blocks, so each load is coalesced across the warp) and its DC
// difference, and walks the slots with the branch-free pack_block
// (p1_pack): every slot's item is computed and selected, and its bits are
// appended to a 32-bit word by funnel shifts, which a predicated store
// puts in the thread's row of the tile when it fills.  After a barrier
// the tile, zero tails included, goes out as 16-byte stores, consecutive
// across the threads (p1_store).

#include "common.cuh"

namespace {

using tpuenc::kP1Threads;

__global__ void __launch_bounds__(kP1Threads)
pack_blocks_kernel(const int16_t* __restrict__ q, long long n_blocks,
                   long long Bp, const int32_t* __restrict__ dcdiff,
                   const uint32_t* __restrict__ dc_tab,
                   const uint32_t* __restrict__ ac_tab, tpuenc::P1Scan s,
                   uint32_t* __restrict__ words, int32_t* __restrict__ lens,
                   int32_t* __restrict__ overflow) {
    extern __shared__ __align__(16) uint32_t smem[];
    const tpuenc::P1Tile tile = tpuenc::p1_stage(smem, s, dc_tab, ac_tab);
    const long long b0 = (long long)blockIdx.x * kP1Threads;
    const long long b = b0 + threadIdx.x;
    // The loads follow the barrier: ahead of it the compiler hoists slot
    // work over them and holds it live across it (159 registers, not 93).
    __syncthreads();
    int c[64];
    int32_t diff = 0;
    if (b < n_blocks) {
#pragma unroll
        for (int k = 0; k < 64; ++k) c[k] = q[k * n_blocks + b];
        diff = s.emit_dc ? dcdiff[b] : 0;
    }
    tpuenc::p1_pack(tile, s, c, diff, b, n_blocks, Bp, lens, overflow);
    __syncthreads();
    tpuenc::p1_store(tile.rows, kP1Threads, s.caps.cap_final, b0, Bp,
                     words);
}

}  // namespace

TPUENC_API int tpuenc_pack_blocks(const void* q, long long n_blocks,
                                  long long Bp, const void* dcdiff,
                                  const void* dc_tab, const void* ac_tab,
                                  const int* pattern, int pat, int ss, int se,
                                  int emit_dc, const int* caps, void* words,
                                  void* lens, void* overflow, void* stream) {
    tpuenc::P1Scan s;
    if (!tpuenc::p1_scan(pattern, pat, ss, se, emit_dc, caps, s))
        return (int)cudaErrorInvalidValue;
    const size_t smem = tpuenc::p1_smem(s);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (Bp > 0) {
        const long long grid = (Bp + kP1Threads - 1) / kP1Threads;
        pack_blocks_kernel<<<(unsigned)grid, kP1Threads, smem,
                             (cudaStream_t)stream>>>(
            (const int16_t*)q, n_blocks, Bp, (const int32_t*)dcdiff,
            (const uint32_t*)dc_tab, (const uint32_t*)ac_tab, s,
            (uint32_t*)words, (int32_t*)lens, (int32_t*)overflow);
    }
    return (int)cudaGetLastError();
}
