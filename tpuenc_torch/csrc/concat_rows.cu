// K5: P4 of the entropy packer, rows into one stream.
//
// Replaces tpuenc/entropy/pallas_pack.py:_concat_rows_kernel (built by
// _build_concat_rows_fn).  Row r (MSB-aligned words, bits[r] bits) lands
// at bit offset pos[r] of the single output stream; pos is the exclusive
// prefix of the row lengths, so rows never share bits.
//
// Bound on the card: memory traffic.  The TPU kernel runs the rows in
// order on one core, carrying the boundary word group from row to row and
// double-buffering its DMAs.  Here rows are independent: one thread block
// per row shifts the row's words by pos & 31 and ORs each into the zeroed
// output at word pos >> 5 (and the next word) with atomicOr.  Only the
// boundary words of adjacent rows see two writers, and OR is commutative,
// so the result does not depend on the order the blocks run in.  A warp
// reads and writes consecutive words.

#include "common.cuh"

namespace {

__global__ void concat_rows_kernel(const uint32_t* __restrict__ rows,
                                   const long long* __restrict__ pos,
                                   const int32_t* __restrict__ bits, int W,
                                   uint32_t* __restrict__ out,
                                   long long capW) {
    const long long r = blockIdx.x;
    const long long p = pos[r];
    int nw = (bits[r] + 31) >> 5;
    nw = nw < W ? nw : W;
    for (int j = threadIdx.x; j < nw; j += blockDim.x)
        tpuenc::or_at(out, capW, p + 32LL * j, rows[r * W + j]);
}

}  // namespace

TPUENC_API int tpuenc_concat_rows(const void* rows, const void* pos,
                                  const void* bits, long long R, int W,
                                  void* out, long long capW, void* stream) {
    if (R > 0) {
        concat_rows_kernel<<<(unsigned)R, 256, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)rows, (const long long*)pos,
            (const int32_t*)bits, W, (uint32_t*)out, capW);
    }
    return (int)cudaGetLastError();
}
