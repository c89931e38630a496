// K2: stitch the per-block word prefixes into one dense stream.
//
// Replaces the TPU kernel wah_tpu/ops/pallas/stitch2.py::stitch_tiles_v2
// (body _body_v4 on the API path). Same contract: staging (nb, 1024) +
// exclusive offsets (nb+1,) [+ optional counts (nb,)] -> (nb*1024,) words;
// row b's first counts[b] words land at offsets[b]; words past the total
// are unspecified (never written). The exclusive scan of the counts stays
// outside, as torch.cumsum, as it does in wah_tpu (jnp.cumsum).
//
// Design: a move, out[off[b] + j] = staging[b, j] for j < counts[b], one
// CTA of 256 threads per row with consecutive threads on consecutive
// words. The TPU kernel's phase rotations, tile read-modify-writes and
// carry tiles exist only because TPU stores are tile-aligned.
//
// Bound: memory. Per block it reads 8 B of offsets and counts[b] * 4 B of
// staging, and writes counts[b] * 4 B (at most 4,096 B each way).
#include "common.cuh"

namespace {

using namespace wah;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stitch_kernel(const uint32_t* __restrict__ staging, const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ counts, uint32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int off = offsets[b];
  const int n = min(max(counts != nullptr ? counts[b] : offsets[b + 1] - off, 0), kBlockChunks);
  const uint32_t* row = staging + (size_t)b * kBlockChunks;
  uint32_t* dst = out + off;
  for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = row[j];
}

}  // namespace

extern "C" int wah_stitch_tiles(const void* staging, const void* offsets, const void* counts,
                                void* out, int nb, void* stream) {
  stitch_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)staging, (const int32_t*)offsets, (const int32_t*)counts,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
