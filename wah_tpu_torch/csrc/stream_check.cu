// V1: check and count a WAH stream in one pass (check_stream).
//
// Replaces no TPU kernel: wah_tpu validates a stream on the host
// (wah_tpu/api.py::checked_stream, the C++ host codec's wah_validate) and
// counts its chunks there too, one thread over the whole stream before the
// stream is sent. The port sends the stream as it is and runs this pass over
// the copy in device memory instead. Contract: words[0, m) and out = [m, 0]
// (int64) -> out = [first_bad, n_chunks]: first_bad the index of the first
// word that breaks the format (0x0, 0x7FFFFFFF, a fill whose length is
// outside [1, 1024]) or m if none does; n_chunks the expanded chunk count (a
// fill counts its length, a literal 1), summed in 64 bits.
//
// Bound: memory. It reads 4 m bytes and writes 16; a word costs a few
// integer operations, far below the card's rate. So the design is about
// keeping enough loads in flight to fill HBM, and about doing nothing else:
//   * A persistent grid, as many 256-thread CTAs as the card holds at once,
//     walks the stream in 16 B vectors (the stream tensor is 16 B-aligned):
//     each thread issues kUnroll independent vector loads, grid-strided so
//     that a warp's loads are 512 contiguous bytes, before it reads any.
//   * The 0-3 words past the last whole vector are taken by the first
//     threads of the grid, one word each, with 4 B loads.
//   * Each thread keeps its count in 64 bits and the least index of a bad word
//     it saw. Counts are summed by warp shuffles, then across the CTA's
//     warps in shared memory, then by one 64-bit atomicAdd per CTA. A bad
//     word is recorded by a 64-bit atomicMin on its index, from the thread
//     that saw it, so a valid stream issues no atomics beyond the per-CTA add.
#include <algorithm>

#include "common.cuh"

namespace {

using namespace wah;

constexpr int kCheckThreads = 256;
constexpr int kCheckWarps = kCheckThreads / 32;
constexpr int kUnroll = 4;  // vector loads a thread has in flight

typedef unsigned long long u64;

__device__ __forceinline__ void check_word(uint32_t w, u64 i, u64& count, u64& bad) {
  const uint32_t len = w & kLenMask;
  const bool fill = (w & kBit31) != 0u;
  count += fill ? len : 1u;
  // len - 1 wraps for a zero-length fill
  if (w == 0u || w == kOnes31 || (fill && len - 1u >= (uint32_t)kBlockChunks)) bad = min(bad, i);
}

__device__ __forceinline__ void check_vec(const uint4& q, u64 i, u64& count, u64& bad) {
  check_word(q.x, i, count, bad);
  check_word(q.y, i + 1, count, bad);
  check_word(q.z, i + 2, count, bad);
  check_word(q.w, i + 3, count, bad);
}

__global__ void __launch_bounds__(kCheckThreads)
check_stream_kernel(const uint4* __restrict__ vecs, const uint32_t* __restrict__ words, u64 m,
                    u64* __restrict__ out) {
  const u64 n_vecs = m >> 2;
  const u64 stride = (u64)gridDim.x * kCheckThreads;
  const u64 tid = (u64)blockIdx.x * kCheckThreads + threadIdx.x;
  u64 count = 0, bad = m;
  u64 v = tid;
  for (; v + (kUnroll - 1) * stride < n_vecs; v += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) q[k] = __ldg(vecs + v + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) check_vec(q[k], 4 * (v + k * stride), count, bad);
  }
  for (; v < n_vecs; v += stride) check_vec(__ldg(vecs + v), 4 * v, count, bad);
  const u64 t = 4 * n_vecs + tid;  // the unaligned tail
  if (t < m) check_word(__ldg(words + t), t, count, bad);

  if (bad < m) atomicMin(out, bad);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_xor_sync(kFullMask, count, d);
  __shared__ u64 warp_counts[kCheckWarps];
  if (lane_id() == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 sum = 0;
#pragma unroll
    for (int w = 0; w < kCheckWarps; ++w) sum += warp_counts[w];
    atomicAdd(out + 1, sum);
  }
}

}  // namespace

// The grid: as many CTAs as the device holds at once, fewer for a stream
// too short to give each thread a vector.
extern "C" int wah_check_stream(const void* words, long long m, void* out, void* stream) {
  int resident = 0;
  const cudaError_t err = resident_ctas(check_stream_kernel, kCheckThreads, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((m >> 2) + kCheckThreads - 1) / kCheckThreads;
  const int grid = (int)std::max(1LL, std::min((long long)resident, want));
  check_stream_kernel<<<grid, kCheckThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const uint32_t*)words, (u64)m, (u64*)out);
  return (int)cudaGetLastError();
}
