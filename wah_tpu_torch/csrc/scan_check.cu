// T1: the shared in-kernel scans and the warp search, run inside a kernel.
//
// Replaces the test-local TPU kernel of tests/test_pallas.py
// (test_wide_scans_match_flat), which runs the Pallas kernels' shared scan
// helpers inside a pallas_call and holds them against the flat result. Its
// counterpart runs the device functions of common.cuh that K1, K4, K5 and K6
// share: x (R, 2048) int32 -> the inclusive cumsum and cummax of each row,
// and, for keys (R, Q), the index warp_search_last_le returns in [lo, hi) of
// each row's cumsum (the largest i with cumsum[i] <= key).
//
// Design: one CTA of 1024 threads per row, two 1,024-element passes with a
// carry, through block_exclusive_scan_1024 and block_inclusive_max_1024
// (warp_inclusive_scan / warp_inclusive_max beneath them); then warp w
// searches keys w, w + 32, ... in the row's cumsum as the CTA wrote it.
//
// Bound: memory. Per row it reads 8,192 B and writes 16,384 B, plus 4 B in
// and 4 B out per key.
#include <climits>

#include "common.cuh"

namespace {

using namespace wah;

constexpr int kRowLen = 2 * kBlockChunks;

__global__ void __launch_bounds__(kBlockChunks)
rows_scan_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ keys,
                 int32_t* csum, int32_t* __restrict__ cmax, int32_t* __restrict__ idx,
                 int q, int lo, int hi) {
  __shared__ int s_buf[33];
  const size_t row = blockIdx.x;
  const int t = threadIdx.x;
  int carry_sum = 0, carry_max = INT_MIN;
  for (int pass = 0; pass < kRowLen / kBlockChunks; ++pass) {
    const size_t i = row * kRowLen + pass * kBlockChunks + t;
    const int v = x[i];
    int total, top;
    const int excl = block_exclusive_scan_1024(v, s_buf, &total);
    __syncthreads();  // s_buf is read until here and written by the next scan
    const int m = block_inclusive_max_1024(v, s_buf, &top);
    __syncthreads();
    csum[i] = carry_sum + excl + v;
    cmax[i] = max(carry_max, m);
    carry_sum += total;
    carry_max = max(carry_max, top);
  }
  __syncthreads();  // the row's cumsum, written above, is searched below
  const int32_t* a = csum + row * kRowLen;
  for (int k = t >> 5; k < q; k += kBlockChunks / 32) {
    const int r = warp_search_last_le(a, lo, hi, keys[row * q + k]);
    if (lane_id() == 0) idx[row * q + k] = r;
  }
}

}  // namespace

extern "C" int wah_rows_scan(const void* x, const void* keys, void* csum, void* cmax, void* idx,
                             int rows, int q, int lo, int hi, void* stream) {
  rows_scan_kernel<<<rows, kBlockChunks, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)keys, (int32_t*)csum, (int32_t*)cmax, (int32_t*)idx,
      q, lo, hi);
  return (int)cudaGetLastError();
}
