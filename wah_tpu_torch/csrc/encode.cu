// K1: WAH block encoder (encode_tiles).
//
// Replaces the TPU kernel wah_tpu/ops/pallas/encode_kernel.py::encode_tiles
// (body _encode_body). Same contract: (nb, 992) uint32 ints + nv = [bound,
// chunk_base, pos_mask] -> staging (nb, 1024) with each block's words as a
// dense prefix and zeros after it, counts (nb, 1).
//
// Bound: memory by its bytes. Per block it reads 3,968 B of ints and writes
// 4,096 B of staging plus a 4 B count; everything else stays in registers
// and shared memory (about 12 KB per CTA). What a simple kernel waits for
// is latency: a load, a few barriers and a store in a row for every block.
//
// Design: CTAs of 128 threads, several to an SM, each walking the blocks
// blockIdx.x, + gridDim.x, ... The per-block encode is encode_block
// (encode_block.cuh, shared with K5): it takes the block's ints from a
// two-stage cp.async staging, so block b + gridDim.x is on its way while
// block b is encoded, and leaves the staging row in shared memory, which
// goes out as 256 uint4 stores: each row is written once, 16 B a thread. nv
// is read once a CTA. The grid is 8 CTAs for each one the card holds at
// once: neighbouring CTAs work on neighbouring blocks, and CTAs that start
// at different times keep loads, arithmetic and stores overlapping. The TPU
// kernel's log-shift compaction and static pass counts have no counterpart:
// a GPU scatters (here inside shared memory).
#include "encode_block.cuh"

namespace {

using namespace wah;

constexpr int kEncodeWaves = 8;  // K1's grid, in CTAs for each resident one

__global__ void __launch_bounds__(kEncodeThreads)
encode_tiles_kernel(const uint32_t* __restrict__ ints, const int32_t* __restrict__ nv,
                    uint4* __restrict__ staging, int32_t* __restrict__ counts, int nb) {
  __shared__ __align__(16) EncodeShared s;
  __shared__ __align__(16) uint32_t s_row[kBlockChunks];  // the block's staging row
  const int bound = nv[0], base = nv[1], pos_mask = nv[2];
  const int step = gridDim.x;
  int b = blockIdx.x;
  copy_block_ints(s, 0, ints, b);
  for (int stage = 0; b < nb; b += step, stage ^= 1) {
    if (b + step < nb) copy_block_ints(s, stage ^ 1, ints, b + step);
    else cp_async_commit();  // an empty group, so that the wait below counts the same
    cp_async_wait<1>();
    const int count = encode_block(s, stage, s_row, b, bound, base, pos_mask);
#pragma unroll
    for (int v = threadIdx.x; v < kBlockChunks / 4; v += kEncodeThreads)
      staging[(size_t)b * (kBlockChunks / 4) + v] = ((const uint4*)s_row)[v];
    if (threadIdx.x == 0) counts[b] = count;
  }
}

}  // namespace

// The grid is kEncodeWaves CTAs for each one the device holds at once (and
// never more than nb).
extern "C" int wah_encode_tiles(const void* ints, const void* nv, void* staging,
                                void* counts, int nb, void* stream) {
  int resident = 0;
  const cudaError_t err = resident_ctas(encode_tiles_kernel, kEncodeThreads, &resident);
  if (err != cudaSuccess) return (int)err;
  encode_tiles_kernel<<<min(nb, resident * kEncodeWaves), kEncodeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)ints, (const int32_t*)nv, (uint4*)staging, (int32_t*)counts, nb);
  return (int)cudaGetLastError();
}

extern "C" const char* wah_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
