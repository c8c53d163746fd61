// Helpers shared by the port's kernels.
//
// Bit words are MSB-aligned 32-bit words carried as uint32 here and as
// int32 tensors (the same bit pattern) on the PyTorch side.  Every entry
// point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() right after its launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TPUENC_API extern "C" __attribute__((visibility("default")))

namespace tpuenc {

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
// words (K2, K6): items are appended MSB first through a 64-bit
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

}  // namespace tpuenc
