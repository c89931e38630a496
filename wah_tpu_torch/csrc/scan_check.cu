// T1: the shared in-kernel scans and the warp search, run inside a kernel.
//
// Replaces the test-local TPU kernel of tests/test_pallas.py
// (test_wide_scans_match_flat), which runs the Pallas kernels' shared scan
// helpers inside a pallas_call and holds them against the flat result. Its
// counterpart runs the scan and search functions of common.cuh over whole
// rows: x (R, 2048) int32 -> the inclusive cumsum and cummax of each row,
// and, for keys (R, Q), the index warp_search_last_le returns in [lo, hi) of
// each row's cumsum (the largest i with cumsum[i] <= key).
//
// Who shares what: warp_inclusive_scan, sum_of_warps_before,
// thread_inclusive_max and warp_exclusive_max (with warp_inclusive_max
// beneath it) are K4's scan of its window's word counts and its forward fill
// (decode.cu); warp_search_last_le is K4's and K6's search (decode.cu,
// stitch_gather.cu). max_of_warps_before has this kernel as its only caller:
// K4's running maximum never crosses a warp (each output warp fills its own
// span), a whole row's does. K1 and K5 scan by ballots (encode_block.cuh) and
// use none of them.
//
// Design: the shape those kernels have. A CTA of 256 threads takes one row
// in one pass, 8 consecutive elements a thread (two int4 loads), and lane j
// of warp w loads key w + 8 j with them, so no search waits for its key.
// The thread scans its 8 elements serially, sum and maximum together; the
// thread totals are scanned across the warp, both warp totals go to shared
// memory under one barrier, and every thread adds the warps before its own
// itself. The sums and maxima leave as int4; the cumsum row also goes to
// 8 KB of shared memory, and after a second barrier warp w searches keys w,
// w + 8, ... there, one after the other, each by all 32 lanes; the results
// are gathered in the lanes that loaded the keys and stored from there. Two
// barriers a row. A grid of one CTA a row was the fastest (at 32,768 rows
// and 64 keys a row on an H100, 0.416 ms against 0.430-0.452 for CTAs that
// walk rows with the next row's loads in flight, from 16 CTAs down to one
// for each the card holds): the hardware's own scheduling of short CTAs
// hides the loads better than a register prefetch. What is left above the
// bound is the search, bound by issue (64 keys a row at three 32-way steps
// each: 0.10 of the 0.416 ms). (The first version:
// 1,024 threads a row, one element a thread, two passes with a carry,
// thirteen barriers of 32 warps, the keys loaded and the row searched in
// device memory.)
//
// Bound: memory. Per row it reads 8,192 B and writes 16,384 B, plus 4 B in
// and 4 B out per key.
#include <climits>

#include "common.cuh"

namespace {

using namespace wah;

constexpr int kRowLen = 2 * kBlockChunks;       // 2,048
constexpr int kPer = 8;                         // elements a thread
constexpr int kScanThreads = kRowLen / kPer;    // 256
constexpr int kScanWarps = kScanThreads / 32;   // 8
static_assert(kPer == 8, "a thread's elements are two int4");

__global__ void __launch_bounds__(kScanThreads)
rows_scan_kernel(const int4* __restrict__ x, const int32_t* __restrict__ keys,
                 int4* __restrict__ csum, int4* __restrict__ cmax, int32_t* __restrict__ idx,
                 int q, int lo, int hi) {
  __shared__ __align__(16) int32_t s_row[kRowLen];  // the row's cumsum, searched here
  __shared__ int s_sum[kScanWarps], s_max[kScanWarps];  // warp totals
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row = blockIdx.x;
  const size_t v = row * (kRowLen / 4) + 2 * t;  // this thread's two int4 of the row

  const int4 a = x[v], b = x[v + 1];
  // key k of the row belongs to warp k % 8: lane j of warp w holds key w + 8 j
  // of each round of 256 keys. The first round's keys are loaded with the row.
  const int kk = warp + kScanWarps * lane;
  const int first_key = kk < q ? keys[row * q + kk] : 0;

  // the thread's own elements, then the thread totals across the warp
  int s[kPer] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int m[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) m[i] = s[i];
  thread_inclusive_max(m);
#pragma unroll
  for (int i = 1; i < kPer; ++i) s[i] += s[i - 1];  // wraps in int32, as the flat scan does
  const int incl = warp_inclusive_scan(s[kPer - 1]);
  const int left = warp_exclusive_max(m[kPer - 1], INT_MIN);
  if (lane == 31) {
    s_sum[warp] = incl;
    s_max[warp] = max(left, m[kPer - 1]);
  }
  __syncthreads();  // warp totals published
  const int add = sum_of_warps_before<kScanWarps>(s_sum) + incl - s[kPer - 1];
  const int top = max(max_of_warps_before<kScanWarps>(s_max, INT_MIN), left);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    s[i] += add;
    m[i] = max(m[i], top);
  }
  const int4 s0 = make_int4(s[0], s[1], s[2], s[3]), s1 = make_int4(s[4], s[5], s[6], s[7]);
  csum[v] = s0, csum[v + 1] = s1;
  cmax[v] = make_int4(m[0], m[1], m[2], m[3]), cmax[v + 1] = make_int4(m[4], m[5], m[6], m[7]);
  if (q == 0) return;

  ((int4*)s_row)[2 * t] = s0, ((int4*)s_row)[2 * t + 1] = s1;
  __syncthreads();  // the row's cumsum is searched below
  for (int c = 0; c < q; c += kScanThreads) {
    const bool mine = c + kk < q;
    const size_t at = row * q + c + kk;
    const int round_key = c == 0 ? first_key : mine ? keys[at] : 0;
    // the warp's keys of this round one after the other, each by all 32 lanes
    const int n_mine = min(32, (q - c - warp + kScanWarps - 1) / kScanWarps);
    int found = 0;
    for (int j = 0; j < n_mine; ++j) {
      const int r = warp_search_last_le(s_row, lo, hi, __shfl_sync(kFullMask, round_key, j));
      if (lane == j) found = r;
    }
    if (mine) idx[at] = found;
  }
}

}  // namespace

extern "C" int wah_rows_scan(const void* x, const void* keys, void* csum, void* cmax, void* idx,
                             int rows, int q, int lo, int hi, void* stream) {
  rows_scan_kernel<<<rows, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)x, (const int32_t*)keys, (int4*)csum, (int4*)cmax, (int32_t*)idx, q, lo, hi);
  return (int)cudaGetLastError();
}
