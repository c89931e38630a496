// K3: word prescan (prescan_words) and K4: block decoder (decode).
//
// K3 replaces wah_tpu/ops/pallas/decode_kernel.py::prescan_words (body
// _prescan_body). Same contract: words (rows_in * 128,) + vc (out_rows,)
// -> words_t (out_rows, 128) with lane k of granule row r kept iff
// k < vc[r] (zero otherwise, and zero for rows past the input), and
// g_sums (out_rows,), each 128-word granule's expanded size (fill -> run
// length, literal -> 1, masked -> 0).
// Design: one warp per granule, each lane loading 4 words as one 16 B
// vector, a shuffle reduction for the sum.
// Bound: memory. Per 1,024-word block of stream it reads 4,096 B of words
// and 32 B of vc, and writes 4,096 B of words_t and 32 B of sums.
//
// K4 replaces wah_tpu/ops/pallas/decode_kernel.py::decode -> _run_decode
// (body _decode_body). Same contract: words_t, the exclusive granule bases
// g_base = cumsum(g_sums) - g_sums (computed outside, as in wah_tpu), and
// meta = [n_chunks, m, chunk_base, pos_mask] -> (nbo, 992) ints, block bo
// holding chunks [chunk_base + 1024 bo, + 1024) merged back to 32 bits.
// Design: one CTA of 1024 threads per output block.
//   1. warp 0 finds the covering granule, max{g : g_base[g] <= base}, by
//      the 32-way search of common.cuh (a ballot per step, ~5 steps); on
//      ties it takes the largest g, so a batched column that fills its
//      capacity hands the next column's first block to that column;
//   2. the 9-granule (1,152-word) window from it goes to shared memory:
//      the covering word of the block's first chunk lies in its first
//      granule and the block consumes at most 1,024 words;
//   3. a block scan of the window's word counts gives each word's offset;
//   4. each thread binary-searches the offsets for its chunk's covering
//      word, expands it (fill -> 0 or 0x7FFFFFFF, literal -> payload) and
//      masks it by n_chunks;
//   5. the fused 31 -> 32-bit merge, int[x] = (c[x] >> x) | (c[x+1] <<
//      (31-x)) inside each 32-chunk group; blocks are group-aligned, so no
//      carry crosses a block.
// The TPU kernel's DMA windows, lane rotations and log-shift expansion are
// TPU mechanics; the window idea remains, sized by the same bound.
// Bound: memory. Per block it reads the 4,608 B window (neighbouring
// blocks' windows overlap, so from device memory about the block's own
// ~4 KB of words) plus ~5 g_base probes, and writes 3,968 B of ints.
#include "common.cuh"

namespace {

using namespace wah;

constexpr int kPrescanWarps = 8;
constexpr int kWindow = 9 * kGranule;  // 1,152 words

__device__ __forceinline__ uint32_t expanded_size(uint32_t w) {
  return (w & kBit31) ? (w & kLenMask) : 1u;
}

__global__ void __launch_bounds__(kPrescanWarps * 32)
prescan_kernel(const uint4* __restrict__ words, const int32_t* __restrict__ vc,
               uint4* __restrict__ words_t, int32_t* __restrict__ g_sums,
               int rows_in, int out_rows) {
  const int r = blockIdx.x * kPrescanWarps + (threadIdx.x >> 5);
  const int lane = lane_id();
  if (r >= out_rows) return;  // whole warps leave together
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < rows_in) v = words[(size_t)r * 32 + lane];
  const int keep = vc[r] - lane * 4;  // lanes k < vc[r] stay
  uint32_t e[4] = {v.x, v.y, v.z, v.w};
  uint32_t sum = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= keep) e[i] = 0u;
    else sum += expanded_size(e[i]);
  }
  words_t[(size_t)r * 32 + lane] = make_uint4(e[0], e[1], e[2], e[3]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFullMask, sum, d);
  if (lane == 0) g_sums[r] = (int32_t)sum;
}

__global__ void __launch_bounds__(kBlockChunks)
decode_blocks_kernel(const uint32_t* __restrict__ words_t, const int32_t* __restrict__ g_base,
                     const int32_t* __restrict__ meta, uint32_t* __restrict__ out,
                     int n_rows) {
  __shared__ uint32_t s_word[kWindow];
  __shared__ int32_t s_off[kWindow];
  __shared__ uint32_t s_chunk[kBlockChunks];
  __shared__ int s_scan_a[33], s_scan_b[33];
  __shared__ int s_granule;

  const int t = threadIdx.x;
  const int n_chunks = meta[0], m = meta[1], pos_mask = meta[3];
  const int base = meta[2] + blockIdx.x * kBlockChunks;

  // 1. covering granule (g_base[0] == 0 <= base)
  if (t < 32) {
    const int g = warp_search_last_le(g_base, 0, n_rows, base);
    if (t == 0) s_granule = g;
  }
  __syncthreads();
  const int g = s_granule;

  // 2. the window and its word counts (words at or past m count 0)
  const size_t w0 = (size_t)g * kGranule;
  const size_t n_words = (size_t)n_rows * kGranule;
  const size_t ia = w0 + t, ib = w0 + kBlockChunks + t;
  const bool has_b = t < kWindow - kBlockChunks;
  const uint32_t wa = ia < n_words ? words_t[ia] : 0u;
  const uint32_t wb = has_b && ib < n_words ? words_t[ib] : 0u;
  const int ca = ia < (size_t)m ? (int)expanded_size(wa) : 0;
  const int cb = has_b && ib < (size_t)m ? (int)expanded_size(wb) : 0;
  s_word[t] = wa;
  if (has_b) s_word[kBlockChunks + t] = wb;

  // 3. word offsets inside the window
  int total_a, total_b;
  const int ea = block_exclusive_scan_1024(ca, s_scan_a, &total_a);
  const int eb = block_exclusive_scan_1024(cb, s_scan_b, &total_b);
  const int off0 = g_base[g];
  s_off[t] = off0 + ea;
  if (has_b) s_off[kBlockChunks + t] = off0 + total_a + eb;
  __syncthreads();

  // 4. expand this thread's chunk: last window word starting at or before it
  const int pos = base + t;
  uint32_t chunk = 0u;
  if ((pos & pos_mask) < n_chunks) {
    int lo = 0, hi = kWindow;  // s_off[0] = g_base[g] <= base <= pos
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= pos) lo = mid;
      else hi = mid;
    }
    const uint32_t w = s_word[lo];
    chunk = (w & kBit31) ? ((w & kBit30) ? kOnes31 : 0u) : w;
  }
  s_chunk[t] = chunk;
  __syncthreads();

  // 5. fused 31 -> 32-bit merge (reference mergeWords, kernels.cu:369-385)
  if (t < kBlockInts) {
    const int grp = t / 31, x = t - grp * 31;
    const uint32_t c0 = s_chunk[grp * 32 + x], c1 = s_chunk[grp * 32 + x + 1];
    out[(size_t)blockIdx.x * kBlockInts + t] = (c0 >> x) | (c1 << (31 - x));
  }
}

}  // namespace

extern "C" int wah_prescan_words(const void* words, const void* vc, void* words_t,
                                 void* g_sums, int rows_in, int out_rows, void* stream) {
  const int grid = (out_rows + kPrescanWarps - 1) / kPrescanWarps;
  prescan_kernel<<<grid, kPrescanWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const int32_t*)vc, (uint4*)words_t, (int32_t*)g_sums, rows_in,
      out_rows);
  return (int)cudaGetLastError();
}

extern "C" int wah_decode_blocks(const void* words_t, const void* g_base, const void* meta,
                                 void* out, int n_rows, int nbo, void* stream) {
  decode_blocks_kernel<<<nbo, kBlockChunks, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words_t, (const int32_t*)g_base, (const int32_t*)meta, (uint32_t*)out,
      n_rows);
  return (int)cudaGetLastError();
}
