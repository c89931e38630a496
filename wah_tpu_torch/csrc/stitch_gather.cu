// K6: stitch the per-block word prefixes into one dense stream, tile by
// output tile.
//
// Replaces the TPU kernel wah_tpu/ops/pallas/encode_kernel.py::stitch_tiles
// (body _stitch_body, the streaming accumulator). Same contract: staging
// (nb, 1024) + exclusive offsets (nb+1,) with offsets[nb] = total ->
// (nb*1024,) words; row b's first offsets[b+1] - offsets[b] words land at
// offsets[b]; the words of the last partial 1,024-word tile past the total
// are zero; words past that tile are unspecified (never written).
//
// What the TPU kernel is for: its cost follows the OUTPUT (one flush per
// 1,024 words written), where K2's follows the input rows (one CTA per
// staging row, however few words each holds). The GPU form of that is an
// output-indexed gather: one CTA per 1,024-word output tile.
//   1. The CTA reads the total on the device and leaves at once if its tile
//      starts at or past it, so the wrapper launches nb CTAs without a host
//      sync.
//   2. Warps 0 and 1 find the rows of the tile's first and last word,
//      b(p) = max{b : offsets[b] <= p}, by the 32-way search of common.cuh;
//      taking the largest b on ties skips rows that hold no words.
//   3. Each thread handles 4 words of the tile, 256 apart (consecutive
//      threads on consecutive words): it binary-searches the row range of
//      step 2 for each word's row, starting from the previous word's row,
//      and copies staging[b, p - offsets[b]], or writes 0 past the total.
// The accumulator's rotations, pending window and double-buffered flush
// DMAs exist because TPU stores are tile-aligned; a GPU writes words.
//
// Bound: memory. Per written tile it writes 4 KB and reads the <= 4 KB of
// staging behind it plus 4 B of offsets per row the tile covers (a sparse
// stream covers up to 1,024 rows a tile). Tiles past the total cost one
// 4 B read each.
#include "common.cuh"

namespace {

using namespace wah;

constexpr int kThreads = 256;
constexpr int kWordsPerThread = kBlockChunks / kThreads;  // 4

__global__ void __launch_bounds__(kThreads)
stitch_gather_kernel(const uint32_t* __restrict__ staging, const int32_t* __restrict__ offsets,
                     uint32_t* __restrict__ out, int nb) {
  __shared__ int s_rows[2];
  const int total = offsets[nb];
  const int tile0 = blockIdx.x * kBlockChunks;
  if (tile0 >= total) return;  // the whole CTA leaves together
  const int t = threadIdx.x, warp = t >> 5;

  // 2. rows of the tile's first and last word (offsets[0] == 0 <= tile0)
  if (warp < 2) {
    const int key = warp == 0 ? tile0 : min(tile0 + kBlockChunks, total) - 1;
    const int b = warp_search_last_le(offsets, 0, nb, key);
    if (lane_id() == 0) s_rows[warp] = b;
  }
  __syncthreads();

  // 3. gather; invariant offsets[lo] <= p and row(p) <= s_rows[1]
  int lo = s_rows[0];
  const int hi_row = s_rows[1] + 1;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    const int p = tile0 + i * kThreads + t;
    uint32_t w = 0u;
    if (p < total) {
      int hi = hi_row;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (offsets[mid] <= p) lo = mid;
        else hi = mid;
      }
      w = staging[(size_t)lo * kBlockChunks + (p - offsets[lo])];
    }
    out[p] = w;  // p < (blockIdx.x + 1) * 1024 <= nb * 1024
  }
}

}  // namespace

extern "C" int wah_stitch_gather(const void* staging, const void* offsets, void* out, int nb,
                                 void* stream) {
  stitch_gather_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)staging, (const int32_t*)offsets, (uint32_t*)out, nb);
  return (int)cudaGetLastError();
}
