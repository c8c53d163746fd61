// K1: fused forward DCT + zigzag + quantize.
//
// Replaces tpuenc/kernels/pallas_fdct.py:_kernel (built by _build, entry
// fdct_quantize_pallas_cm).  Input is coefficient-major: x (64, B) int32
// level-shifted samples, row k = sample y*8+x of every block; output is
// (64, B) int16, row j = the quantized coefficient at zigzag position j.
// The arithmetic is libjpeg's islow LL&M transform (common.cuh's llm) and
// the reciprocal quantizer with the wrap-around of JAX's int32.
//
// Bound on the card: memory, 384 bytes a block, but only just: the
// transform and the quantizer are ~1,600 instructions a block in the first
// design, about 4 a byte, against the H100's ~4.4 integer operations per
// byte of device memory.  So the loads of one part of the input have to
// run under the arithmetic of another, and every instruction spent on
// anything else counts.  The first design ran one thread per block with
// the whole block in registers (88 of them): at the flagship's 56,250
// blocks that is one partial wave, every warp loading, then transforming,
// then storing in step with the others (49.7% of the bound).
//
// Design: tiles of 32 x kPer consecutive blocks, kPer a lane (2 where B is
// even and the rows aligned: one 8-byte load and one 4-byte store a row
// for both, 256 and 128 bytes a warp), eight warps a thread block.  The
// thread blocks stay resident (one wave, from the card's SM count and the
// kernel's occupancy) and walk the tiles gridDim.x apart.  Warp w loads
// samples 8w..8w+7 of its lane's blocks (row y = w, coalesced), runs the
// row pass in registers and writes them to a shared 64-row tile,
// conflict-free.  After the one barrier of the tile, warp w reads column x
// = w (coefficients 8i + w), runs the column pass, quantizes each
// coefficient with the table entry of its zigzag position and stores it to
// that row of the output.  The loads of the next two tiles are in flight
// in registers under this tile's transform; two shared tiles alternate, so
// one barrier a tile orders both the tile's reads after its writes and the
// next writes after the reads.  What does not change from tile to tile is
// set up once per warp: its 8 zigzag positions, their table entries and
// output rows.  The quantizer folds the correction into the multiply:
// (|v| + corr) * recip = |v| * recip + corr * recip mod 2^32, the same
// bits.  Offsets are 32-bit where 64 * B fits (every shape the encoder
// makes), else 64-bit.
//
// Measured against it on one H100 (kernel_ab.py, device ms): the same
// tiles with one block a lane, 64-bit offsets and no prefetch spent 2.2x
// the first design's instructions a block and were slower; with one tile
// prefetched they beat it at the flagship by 10% and lost 2-3% at 450,000
// blocks; two blocks a lane took the flagship to -20% and still lost 2% at
// 450,000, where the second tile in flight (2 thread blocks an SM, 106
// registers) wins it back.  A cp.async ring of 4 stages was slower.

#include "common.cuh"

namespace {

using tpuenc::u32;

constexpr int kWarps = 8;   // warp w: row w in pass 1, column w in pass 2
constexpr int kThreads = 32 * kWarps;

// Zigzag position of natural index n: the inverse of zigzag_natural.
struct ZigzagPos {
    int v[64];
};

constexpr ZigzagPos zigzag_pos() {
    ZigzagPos p{};
    for (int j = 0; j < 64; ++j) p.v[tpuenc::zigzag_natural(j)] = j;
    return p;
}

__constant__ ZigzagPos kPos = zigzag_pos();

// kPer consecutive blocks a lane (2 where B is even: one 8-byte load and
// one 4-byte store a row for both), 32 x kPer blocks a tile.
template <int kPer>
struct Lane {
    u32 d[kPer][8];
};

// Samples 8w..8w+7 of the lane's blocks from b (clamped into the array: a
// lane past B loads the last blocks and stores nothing).
template <int kPer, typename Off>
__device__ __forceinline__ void load_rows(Lane<kPer>& v, const int32_t* x,
                                          Off B, Off b, int w) {
    const int32_t* src = x + (Off)(8 * w) * B + b;
#pragma unroll
    for (int i = 0; i < 8; ++i, src += B) {
        if (kPer == 2) {
            const int2 p = __ldg(reinterpret_cast<const int2*>(src));
            v.d[0][i] = (u32)p.x;
            v.d[kPer - 1][i] = (u32)p.y;
        } else {
            v.d[0][i] = (u32)__ldg(src);
        }
    }
}

// Row k, lane's blocks, of a shared tile of 32 x kPer blocks.
template <int kPer>
__device__ __forceinline__ void put(u32* tile, int k, int lane, const Lane<kPer>& v,
                                    int i) {
    if (kPer == 2)
        *reinterpret_cast<uint2*>(tile + k * 64 + 2 * lane) =
            make_uint2(v.d[0][i], v.d[kPer - 1][i]);
    else
        tile[k * 32 + lane] = v.d[0][i];
}

template <int kPer>
__device__ __forceinline__ void get(const u32* tile, int k, int lane,
                                    Lane<kPer>& v, int i) {
    if (kPer == 2) {
        const uint2 p = *reinterpret_cast<const uint2*>(tile + k * 64 + 2 * lane);
        v.d[0][i] = p.x;
        v.d[kPer - 1][i] = p.y;
    } else {
        v.d[0][i] = tile[k * 32 + lane];
    }
}

// The reciprocal quantizer, (|v| + corr) * recip >> 15 with the sign
// restored, with cq = corr * recip: |v| * recip + corr * recip is the
// same product mod 2^32.
__device__ __forceinline__ u32 quantize(u32 s, u32 rq, u32 cq) {
    const u32 a = (int32_t)s < 0 ? 0u - s : s;
    const u32 q = (u32)((int32_t)(a * rq + cq) >> 15);
    return (int32_t)s < 0 ? 0u - q : q;
}

template <typename Off, int kPer>
__global__ void __launch_bounds__(kThreads, kPer == 2 ? 2 : 3)
fdct_quantize_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ recip,
                     const int32_t* __restrict__ corr,
                     int16_t* __restrict__ out, Off B, Off n_tiles) {
    constexpr int kTile = 32 * kPer;
    __shared__ u32 mid[2][64 * kTile];  // row k: sample k after the row pass
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;

    // Column w's coefficients: natural index 8i + w at zigzag position
    // pos, its output row and its table entries.
    Off row[8];
    u32 rq[8], cq[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int pos = kPos.v[8 * i + w];
        row[i] = (Off)pos * B;
        rq[i] = (u32)__ldg(recip + pos);
        cq[i] = (u32)__ldg(corr + pos) * rq[i];
    }

    const Off stride = gridDim.x;
    Off t = blockIdx.x;
    Lane<kPer> next, next2;
    if (t < n_tiles)
        load_rows(next, x, B, min(t * kTile + kPer * lane, B - kPer), w);
    if (t + stride < n_tiles)
        load_rows(next2, x, B, min((t + stride) * kTile + kPer * lane, B - kPer), w);
    for (int buf = 0; t < n_tiles; t += stride, buf ^= 1) {
        Lane<kPer> v = next;
        next = next2;
        const Off tn = t + 2 * stride;
        if (tn < n_tiles)
            load_rows(next2, x, B, min(tn * kTile + kPer * lane, B - kPer), w);

        // Pass 1: row y = w of the lane's blocks.
        u32* tile = mid[buf];
#pragma unroll
        for (int j = 0; j < kPer; ++j) tpuenc::llm<true>(v.d[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) put(tile, 8 * w + i, lane, v, i);
        __syncthreads();

        // Pass 2: column x = w, then the quantizer.
#pragma unroll
        for (int i = 0; i < 8; ++i) get(tile, 8 * i + w, lane, v, i);
#pragma unroll
        for (int j = 0; j < kPer; ++j) tpuenc::llm<false>(v.d[j]);
        const Off b = t * kTile + kPer * lane;
        if (b < B) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const u32 q0 = quantize(v.d[0][i], rq[i], cq[i]);
                if (kPer == 2) {
                    const u32 q1 = quantize(v.d[kPer - 1][i], rq[i], cq[i]);
                    *reinterpret_cast<u32*>(out + row[i] + b) =
                        (q0 & 0xFFFFu) | (q1 << 16);
                } else {
                    out[row[i] + b] = (int16_t)q0;
                }
            }
        }
    }
}

// One wave of thread blocks (at most one a tile), from the card's SM count
// and the kernel's occupancy, asked once per device.
template <typename Off, int kPer>
int launch(const int32_t* x, const int32_t* recip, const int32_t* corr,
           int16_t* out, long long B, cudaStream_t stream) {
    const tpuenc::CardLimits* card = tpuenc::card_limits();
    if (card == nullptr) return (int)cudaErrorInvalidDevice;
    static int per_sm[tpuenc::kMaxDevices];
    static std::once_flag once[tpuenc::kMaxDevices];
    std::call_once(once[card->device], [card] {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[card->device], fdct_quantize_kernel<Off, kPer>, kThreads, 0);
    });
    const long long n_tiles = (B + 32 * kPer - 1) / (32 * kPer);
    const long long wave =
        (long long)card->sms * (per_sm[card->device] > 0 ? per_sm[card->device] : 1);
    const long long grid = n_tiles < wave ? n_tiles : wave;
    fdct_quantize_kernel<Off, kPer><<<(unsigned)grid, kThreads, 0, stream>>>(
        x, recip, corr, out, (Off)B, (Off)n_tiles);
    return (int)cudaGetLastError();
}

template <typename Off>
int launch_width(const int32_t* x, const int32_t* recip, const int32_t* corr,
                 int16_t* out, long long B, cudaStream_t stream) {
    // Two blocks a lane where every row of x and out starts 8 and 4 bytes
    // aligned.
    if (B % 2 == 0 && (uintptr_t)x % 8 == 0 && (uintptr_t)out % 4 == 0)
        return launch<Off, 2>(x, recip, corr, out, B, stream);
    return launch<Off, 1>(x, recip, corr, out, B, stream);
}

}  // namespace

TPUENC_API int tpuenc_fdct_quantize(const void* x, const void* recip,
                                    const void* corr, void* out, long long B,
                                    void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const auto* xx = (const int32_t*)x;
    const auto* r = (const int32_t*)recip;
    const auto* c = (const int32_t*)corr;
    auto* o = (int16_t*)out;
    auto st = (cudaStream_t)stream;
    // 32-bit offsets while every element index, 64 * B, fits.
    if (B <= (long long)(UINT32_MAX / 64))
        return launch_width<uint32_t>(xx, r, c, o, B, st);
    return launch_width<long long>(xx, r, c, o, B, st);
}
