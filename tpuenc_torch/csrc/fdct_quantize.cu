// K1: fused forward DCT + zigzag + quantize.
//
// Replaces tpuenc/kernels/pallas_fdct.py:_kernel (built by _build, entry
// fdct_quantize_pallas_cm).  Input is coefficient-major: x (64, B) int32
// level-shifted samples, row k = sample y*8+x of every block; output is
// (64, B) int16, row j = the quantized coefficient at zigzag position j.
// The arithmetic is libjpeg's islow LL&M transform and the reciprocal
// quantizer with the wrap-around of JAX's int32 (common.cuh).
//
// Bound on the card: memory.  Each block reads 256 bytes and writes 128,
// against ~50 integer operations per coefficient, far under the H100's
// operations-per-byte balance.  Design: one thread per block, so the 64
// reads and the 64 writes of a warp are each 32 consecutive words of one
// row (coalesced) and the whole 8x8 transform stays in registers.  The
// transform and the quantizer are common.cuh's, shared with K8; the zigzag
// is resolved at compile time, so the register arrays are only ever
// indexed by constants.

#include "common.cuh"

namespace {

using tpuenc::u32;

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
    tpuenc::fdct_8x8(s);
    int q[64];
    tpuenc::quantize_zigzag(s, recip, corr, q);
#pragma unroll
    for (int j = 0; j < 64; ++j) out[j * B + b] = (int16_t)q[j];
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
