// Shared definitions of the WAH kernels: format constants (copied from
// wah_tpu_torch/constants.py), warp / block scans and the warp search.
#pragma once

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

}  // namespace wah
