// K1: WAH block encoder (encode_tiles).
//
// Replaces the TPU kernel wah_tpu/ops/pallas/encode_kernel.py::encode_tiles
// (body _encode_body). Same contract: (nb, 992) uint32 ints + nv = [bound,
// chunk_base, pos_mask] -> staging (nb, 1024) with each block's words as a
// dense prefix and zeros after it, counts (nb, 1).
//
// Design: one CTA of 1024 threads per block, one chunk per thread; the
// per-block encode is encode_block (encode_block.cuh, shared with K5). Every
// word is written straight to its slot. The TPU kernel's log-shift
// compaction and static pass counts have no counterpart: a GPU scatters.
//
// Bound: memory. Per block it reads 3,968 B of ints and writes 4,096 B of
// staging plus a 4 B count; everything else stays in registers and shared
// memory (about 3 KB per CTA).
#include "encode_block.cuh"

namespace {

using namespace wah;

__global__ void __launch_bounds__(kBlockChunks)
encode_tiles_kernel(const uint32_t* __restrict__ ints, const int32_t* __restrict__ nv,
                    uint32_t* __restrict__ staging, int32_t* __restrict__ counts) {
  const int b = blockIdx.x;
  const int c = threadIdx.x;
  int count;
  const BlockWord w = encode_block(ints, b, nv[0], nv[1], nv[2], &count);

  uint32_t* row = staging + (size_t)b * kBlockChunks;
  if (w.start) row[w.slot] = w.word;
  if (c >= count) row[c] = 0u;
  if (c == 0) counts[b] = count;
}

}  // namespace

extern "C" int wah_encode_tiles(const void* ints, const void* nv, void* staging,
                                void* counts, int nb, void* stream) {
  encode_tiles_kernel<<<nb, kBlockChunks, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ints, (const int32_t*)nv, (uint32_t*)staging, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* wah_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
