// K9: single-band AC symbolization for a one-hot histogram.
//
// Replaces tpuenc/entropy/pallas_hist.py:_hist_sym_kernel (built by
// _build_sym_fn, entry ac_histogram_pallas).  For one band [ss, se) of a
// (64, n_blocks) stream, padded to Lp >= n_blocks columns, it writes per
// slot and block: run4 (int8) = run & 15 for a nonzero coefficient of the
// band in a real block, 16 for everything else (so the count after it
// drops those elements for free); size (int8) = the magnitude category of
// the band's coefficient (0 outside the band and for zeros); and per block
// the ZRL partial (sum of run >> 4 over its nonzeros) and the EOB flag
// (its last nonzero of the band lies below se - 1), as int32 rows 0 and 1
// of parts (2, Lp).  The joint count after it is plain PyTorch, as it is
// XLA in tpuenc.
//
// Bound on the card: memory traffic, 128 bytes read and 136 written a
// block, with ~10 integer operations a slot close behind.  The first
// design ran one thread per block over all 64 slots, unrolled: a test of
// the band at every slot and two 1-byte stores a slot (32 bytes a warp
// store), all warps loading, then walking, in one wave (35.3% of the
// bound at the flagship).
//
// Design: a thread walks four consecutive blocks, side by side as the
// four bytes of a word; a warp covers 128 blocks, so each of its loads of
// a slot is 256 consecutive bytes and each of its stores of run4 or size
// 128 (4 bytes a lane where Lp % 4 == 0, else four 1-byte stores).  The
// band's rows are staged first, each thread copying its own 8 bytes a row
// into shared memory with cp.async (4-byte copies, zero-filled past
// n_blocks), in groups of 8 rows; the walk waits for each group in turn,
// so it starts on the first rows while the later ones are still on their
// way, and needs no barrier, since a thread reads only what it copied.
// For an odd n_blocks a row's 8 bytes are not 4-byte aligned, so there
// the walk loads its coefficients itself (2-byte loads).  The walk is a
// rolled loop over the band's slots only; the rows outside the band are
// constant stores that test nothing.  Per slot, the highest set bit of
// each |v| goes into one byte of a word (0xFF for 0): + 1 in each byte is
// the four magnitude categories, and the bytes' top bits are the zero
// mask.  The run of each block is one byte of a word too: with P =
// previous nonzero + 1 (from ss) in each byte, the run is k - P (no
// borrow, P <= k); the mask selects run & 15 or 16, k + 1 into P, and
// (run >> 4) into the ZRL partial (at most 3 a block).  Two threads a
// quad, splitting the band's slots, were slower (waiting for every row
// before the walk cost more than the second thread gave).

#include "common.cuh"

namespace {

using tpuenc::u32;

constexpr int kPer = 4;                  // consecutive blocks a thread walks
constexpr int kThreads = 64;
constexpr int kTile = kPer * kThreads;   // blocks a thread block covers
constexpr int kGroup = 8;                // rows per cp.async group
constexpr u32 kOnes = 0x01010101u;       // 1 in each byte

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(live ? 4 : 0)
                 : "memory");
}

// Waits until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
    switch (n) {
#define TPUENC_WAIT(N) \
    case N:            \
        asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); \
        break;
        TPUENC_WAIT(0) TPUENC_WAIT(1) TPUENC_WAIT(2) TPUENC_WAIT(3)
        TPUENC_WAIT(4) TPUENC_WAIT(5) TPUENC_WAIT(6)
#undef TPUENC_WAIT
        default:
            asm volatile("cp.async.wait_group 7;\n" ::: "memory");
    }
}

// Byte i = the highest set bit of |int16 i| of (x, y), x's low half
// first: the magnitude category - 1, 0xFF for 0.
__device__ __forceinline__ u32 flo_bytes(uint2 v) {
    const int f0 = 31 - __clz(abs((int)(int16_t)(v.x & 0xFFFFu)));
    const int f1 = 31 - __clz(abs((int)v.x >> 16));
    const int f2 = 31 - __clz(abs((int)(int16_t)(v.y & 0xFFFFu)));
    const int f3 = 31 - __clz(abs((int)v.y >> 16));
    return __byte_perm(__byte_perm(f0, f1, 0x0040), __byte_perm(f2, f3, 0x0040),
                       0x5410);
}

// Byte i = 0xFF where byte i of f has its top bit set (prmt with the
// selector's top bit replicates a byte's top bit): the zero coefficients.
__device__ __forceinline__ u32 zero_bytes(u32 f) {
    u32 z;
    asm("prmt.b32 %0, %1, %2, 0xBA98;" : "=r"(z) : "r"(f), "r"(0u));
    return z;
}

// The quad's 4 bytes of an output row at dst; left = Lp - b (>= 1) bytes
// of the row remain from dst.
template <bool kWide>
__device__ __forceinline__ void store4(int8_t* dst, long long left, u32 word) {
    if (kWide) {
        *reinterpret_cast<u32*>(dst) = word;
    } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
            if (i < left) dst[i] = (int8_t)(word >> (8 * i));
    }
}

// kStaged: n_blocks is even and q 4-byte aligned (each thread's 8 bytes of
// a row are two aligned words); kWide: Lp % 4 == 0 and the outputs aligned
// (its 4 bytes of an output row are one aligned word).
template <bool kStaged, bool kWide>
__global__ void __launch_bounds__(kThreads)
hist_sym_kernel(const int16_t* __restrict__ q, long long n_blocks,
                long long Lp, int ss, int se, int8_t* __restrict__ run4,
                int8_t* __restrict__ size, int32_t* __restrict__ parts) {
    extern __shared__ uint2 coef[];  // row r: slot ss + r, kThreads x 8 bytes
    const int t = threadIdx.x;
    const long long b = (long long)blockIdx.x * kTile + kPer * t;
    if (b >= Lp) return;
    const int rows = se - ss;

    if (kStaged) {
        // Two words a row: blocks (b, b + 1) and (b + 2, b + 3), each in or
        // past n_blocks as a whole, since n_blocks is even.
        // A word past n_blocks copies nothing from q (zero fill).
        const bool live0 = b < n_blocks, live1 = b + 2 < n_blocks;
        const int16_t* src = q + (long long)ss * n_blocks + b;
        for (int r = 0; r < rows; ++r, src += n_blocks) {
            uint2* dst = coef + r * kThreads + t;
            cp_async4(&dst->x, live0 ? src : q, live0);
            cp_async4(&dst->y, live1 ? src + 2 : q, live1);
            if (r % kGroup == kGroup - 1 || r == rows - 1)
                asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
    }

    // The rows outside the band: run4 16, size 0.
    const long long left = Lp - b;
    int8_t* r4p = run4 + b;
    int8_t* szp = size + b;
    for (int k = 0; k < ss; ++k, r4p += Lp, szp += Lp) {
        store4<kWide>(r4p, left, 16 * kOnes);
        store4<kWide>(szp, left, 0u);
    }
    r4p = run4 + (long long)se * Lp + b;
    szp = size + (long long)se * Lp + b;
    for (int k = se; k < 64; ++k, r4p += Lp, szp += Lp) {
        store4<kWide>(r4p, left, 16 * kOnes);
        store4<kWide>(szp, left, 0u);
    }

    const int groups = (rows + kGroup - 1) / kGroup;
    u32 p = (u32)ss * kOnes;   // previous nonzero slot + 1, per block
    u32 zrl = 0;               // the ZRL partials, per block
    u32 kw = (u32)ss * kOnes;  // the slot, in each byte
    r4p = run4 + (long long)ss * Lp + b;
    szp = size + (long long)ss * Lp + b;
    for (int g = 0; g < groups; ++g) {
        if (kStaged) cp_async_wait(groups - 1 - g);
        const int r1 = min(rows, (g + 1) * kGroup);
#pragma unroll 4
        for (int r = g * kGroup; r < r1; ++r, r4p += Lp, szp += Lp) {
            uint2 v;
            if (kStaged) {
                v = coef[r * kThreads + t];
            } else {
                const int16_t* src = q + (long long)(ss + r) * n_blocks + b;
                int c[kPer];
#pragma unroll
                for (int i = 0; i < kPer; ++i)
                    c[i] = b + i < n_blocks ? src[i] : 0;
                v = make_uint2((c[0] & 0xFFFF) | ((u32)c[1] << 16),
                               (c[2] & 0xFFFF) | ((u32)c[3] << 16));
            }
            const u32 f = flo_bytes(v);
            const u32 zero = zero_bytes(f);
            const u32 run = kw - p;
            store4<kWide>(r4p, left,
                          (run & ~zero & 0x0F0F0F0Fu) | (zero & 16 * kOnes));
            // f + 1 in each byte, 0xFF + 1 wrapping to 0 in its own byte.
            store4<kWide>(szp, left,
                          ((f & 0x7F7F7F7Fu) + kOnes) ^ (f & 0x80808080u));
            zrl += (run >> 4) & ~zero & 0x03030303u;
            kw += kOnes;
            p = (p & zero) | (kw & ~zero);
        }
    }

    int z[kPer], e[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        z[i] = (int)((zrl >> (8 * i)) & 0xFF);
        e[i] = b + i < n_blocks && (int)((p >> (8 * i)) & 0xFF) < se;
    }
    if (kWide) {
        *reinterpret_cast<int4*>(parts + b) = make_int4(z[0], z[1], z[2], z[3]);
        *reinterpret_cast<int4*>(parts + Lp + b) =
            make_int4(e[0], e[1], e[2], e[3]);
    } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            if (b + i < Lp) {
                parts[b + i] = z[i];
                parts[Lp + b + i] = e[i];
            }
        }
    }
}

template <bool kStaged, bool kWide>
void launch(const int16_t* q, long long n_blocks, long long Lp, int ss, int se,
            int8_t* run4, int8_t* size, int32_t* parts, cudaStream_t stream) {
    const long long grid = (Lp + kTile - 1) / kTile;
    const size_t smem = kStaged ? sizeof(uint2) * kThreads * (se - ss) : 0;
    hist_sym_kernel<kStaged, kWide><<<(unsigned)grid, kThreads, smem, stream>>>(
        q, n_blocks, Lp, ss, se, run4, size, parts);
}

}  // namespace

TPUENC_API int tpuenc_hist_sym(const void* q, long long n_blocks,
                               long long Lp, int ss, int se, void* run4,
                               void* size, void* parts, void* stream) {
    if (ss < 0 || ss >= se || se > 64 || Lp < n_blocks)
        return (int)cudaErrorInvalidValue;
    if (Lp > 0) {
        const auto* qq = (const int16_t*)q;
        auto* r = (int8_t*)run4;
        auto* s = (int8_t*)size;
        auto* p = (int32_t*)parts;
        auto st = (cudaStream_t)stream;
        // Alignment of the rows: q's and the outputs' own, and the row
        // strides.
        const auto aligned = [](const void* ptr, uintptr_t to) {
            return (uintptr_t)ptr % to == 0;
        };
        const bool staged = n_blocks > 0 && n_blocks % 2 == 0 && aligned(q, 4);
        const bool wide = Lp % 4 == 0 && aligned(run4, 4) &&
                          aligned(size, 4) && aligned(parts, 16);
        if (staged && wide)
            launch<true, true>(qq, n_blocks, Lp, ss, se, r, s, p, st);
        else if (staged)
            launch<true, false>(qq, n_blocks, Lp, ss, se, r, s, p, st);
        else if (wide)
            launch<false, true>(qq, n_blocks, Lp, ss, se, r, s, p, st);
        else
            launch<false, false>(qq, n_blocks, Lp, ss, se, r, s, p, st);
    }
    return (int)cudaGetLastError();
}
