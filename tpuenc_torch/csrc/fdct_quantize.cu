// K1: fused forward DCT + zigzag + quantize.
//
// Replaces tpuenc/kernels/pallas_fdct.py:_kernel (built by _build, entry
// fdct_quantize_pallas_cm).  Input is coefficient-major: x (64, B) int32
// level-shifted samples, row k = sample y*8+x of every block; output is
// (64, B) int16, row j = the quantized coefficient at zigzag position j.
// The arithmetic is libjpeg's islow LL&M transform (CONST_BITS 13,
// PASS1_BITS 2, round-half-up descale) and the reciprocal quantizer
// ((|v| + corr) * recip) >> 15 with the sign restored, all with the
// wrap-around of JAX's int32: sums and products are taken in uint32 (C++
// signed overflow is undefined) and only shifts run on the signed value.
//
// Bound on the card: memory.  Each block reads 256 bytes and writes 128,
// against ~50 integer operations per coefficient, far under the H100's
// operations-per-byte balance.  Design: one thread per block, so the 64
// reads and the 64 writes of a warp are each 32 consecutive words of one
// row (coalesced) and the whole 8x8 transform stays in registers.  The
// zigzag is applied on the store side (natural index n goes to row
// kUnzig[n]), so the register array is only ever indexed by constants.

#include "common.cuh"

namespace {

typedef uint32_t u32;

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

// Natural index n -> zigzag position (inverse of core.tables.ZIGZAG).
__constant__ int kUnzig[64] = {
    0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
};

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

__global__ void fdct_quantize_kernel(const int32_t* __restrict__ x,
                                     const int32_t* __restrict__ recip,
                                     const int32_t* __restrict__ corr,
                                     int16_t* __restrict__ out,
                                     long long B) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

    u32 s[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) s[k] = (u32)x[k * B + b];

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

    // Zigzag + quantize: natural index n is stored at row kUnzig[n].
#pragma unroll
    for (int n = 0; n < 64; ++n) {
        const int j = kUnzig[n];
        const int32_t v = (int32_t)s[n];
        const u32 absv = v < 0 ? 0u - s[n] : s[n];
        const u32 prod = (absv + (u32)corr[j]) * (u32)recip[j];
        const u32 q = (u32)((int32_t)prod >> 15);
        out[j * B + b] = (int16_t)(v < 0 ? 0u - q : q);
    }
}

}  // namespace

TPUENC_API int tpuenc_fdct_quantize(const void* x, const void* recip,
                                    const void* corr, void* out, long long B,
                                    void* stream) {
    if (B > 0) {
        const int threads = 128;
        const long long grid = (B + threads - 1) / threads;
        fdct_quantize_kernel<<<(unsigned)grid, threads, 0,
                               (cudaStream_t)stream>>>(
            (const int32_t*)x, (const int32_t*)recip, (const int32_t*)corr,
            (int16_t*)out, B);
    }
    return (int)cudaGetLastError();
}
