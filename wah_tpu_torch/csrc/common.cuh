// Shared definitions of the WAH kernels: format constants (copied from
// wah_tpu_torch/constants.py), the warp scans, the block scans of threads
// that own several elements each, the warp search, the
// asynchronous global -> shared copies (cp.async) and the grid sizing of the
// kernels whose CTAs walk several blocks.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace wah {

constexpr uint32_t kOnes31 = 0x7FFFFFFFu;   // one-fill chunk payload
constexpr uint32_t kBit31 = 0x80000000u;    // fill-word flag
constexpr uint32_t kBit30 = 0x40000000u;    // one-fill flag
constexpr uint32_t kBit3130 = 0xC0000000u;  // one-fill word prefix
constexpr uint32_t kLenMask = 0x3FFFFFFFu;  // 30-bit run length
constexpr int kBlockChunks = 1024;          // chunks per coalescing block
constexpr int kBlockInts = 992;             // input ints per block
constexpr int kGranule = 128;               // words per granule (decode tables)
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Asynchronous copy of 16 bytes (both addresses 16 B-aligned) or 4 bytes
// from device memory to shared memory. With `fill` false nothing is read
// and the 16 bytes are zero-filled. A thread's copies are grouped by
// cp_async_commit(); cp_async_wait<N>() returns once all but its N newest
// groups have landed. The data is then visible to the thread that copied
// it; other threads need a barrier (or __syncwarp) after the wait.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool fill = true) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Inclusive prefix sum across the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = lane_id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Inclusive prefix maximum across the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive_max(int x) {
  const int lane = lane_id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x = max(x, y);
  }
  return x;
}

// Largest i in [lo, hi) with a[i] <= key, for a non-decreasing `a` with
// a[lo] <= key (on ties, the largest such i). A 32-way search: each step
// probes 32 evenly spaced entries with one ballot and keeps the span after
// the last probe at or below `key`, so ~log32(hi - lo) steps. All 32 lanes
// of the warp must call it; each gets the result.
__device__ __forceinline__ int warp_search_last_le(const int32_t* __restrict__ a, int lo,
                                                   int hi, int key) {
  const int lane = lane_id();
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned le = __ballot_sync(kFullMask, p < hi && a[p] <= key);
    // `a` is sorted, so `le` is a prefix of lanes that holds lane 0
    lo += (le ? 31 - __clz(le) : 0) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// Block scans over threads that each own several consecutive elements in
// registers: K4's scan of its window's word counts and its forward fill
// (decode.cu), and T1, which runs every one of them over whole rows
// (scan_check.cu). A thread scans its own elements serially; the thread
// totals are scanned across the warp (warp_inclusive_scan,
// warp_exclusive_max); lane 31 stores the warp's total to shared memory, one
// __syncthreads() publishes all of them, and every thread combines the warps
// before its own itself:
//   a thread's exclusive prefix = sum_of_warps_before + warp inclusive - own total.

// In-place inclusive running maximum of a thread's own elements.
template <int kPer>
__device__ __forceinline__ void thread_inclusive_max(int (&v)[kPer]) {
#pragma unroll
  for (int i = 1; i < kPer; ++i) v[i] = max(v[i - 1], v[i]);
}

// Exclusive prefix maximum across the 32 lanes of a warp: the maximum of the
// lanes below, `identity` in lane 0.
__device__ __forceinline__ int warp_exclusive_max(int x, int identity) {
  const int left = __shfl_up_sync(kFullMask, warp_inclusive_max(x), 1);
  return lane_id() == 0 ? identity : left;
}

// The sum (maximum) of the totals of the warps before this thread's, in a
// block of kWarps warps. Call after the barrier that publishes
// warp_totals[0 .. kWarps - 1).
template <int kWarps>
__device__ __forceinline__ int sum_of_warps_before(const int* warp_totals) {
  const int warp = threadIdx.x >> 5;
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
    if (w < warp) before += warp_totals[w];
  return before;
}
template <int kWarps>
__device__ __forceinline__ int max_of_warps_before(const int* warp_totals, int identity) {
  const int warp = threadIdx.x >> 5;
  int before = identity;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
    if (w < warp) before = max(before, warp_totals[w]);
  return before;
}

// Host side: *ctas gets how many CTAs of `kernel` (with `threads` threads and
// static shared memory only) the current device holds at once. The answer is
// kept for each device (one table for each kernel); a failed query is
// returned as its CUDA error and nothing is kept, so the caller can refuse
// the launch instead of sizing a grid from a guess.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int threads, int* ctas) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*ctas = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0)) !=
          cudaSuccess)
    return err;
  if (sms * per_sm <= 0) return cudaErrorLaunchOutOfResources;  // the kernel fits no SM
  *ctas = sms * per_sm;
  if (keep) known[dev].store(*ctas, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace wah
