// Shared definitions of the WAH kernels: format constants (copied from
// wah_tpu_torch/constants.py), warp / block scans, the warp search, the
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

// Exclusive prefix sum over a block of exactly 1024 threads (32 warps).
// `buf` is 33 ints of shared memory, free for this call; *total gets the
// block's sum. Contains two __syncthreads(): every thread must call it.
__device__ __forceinline__ int block_exclusive_scan_1024(int x, int* buf, int* total) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(x);
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = buf[lane];
    const int si = warp_inclusive_scan(s);
    buf[lane] = si - s;
    if (lane == 31) buf[32] = si;
  }
  __syncthreads();
  *total = buf[32];
  return buf[warp] + incl - x;
}

// Inclusive prefix maximum over a block of exactly 1024 threads (32 warps).
// `buf` is 33 ints of shared memory, free for this call; *total gets the
// block's maximum. Contains two __syncthreads(): every thread must call it.
__device__ __forceinline__ int block_inclusive_max_1024(int x, int* buf, int* total) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_max(x);
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int mi = warp_inclusive_max(buf[lane]);
    buf[lane] = mi;
    if (lane == 31) buf[32] = mi;
  }
  __syncthreads();
  *total = buf[32];
  return warp == 0 ? incl : max(buf[warp - 1], incl);
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
