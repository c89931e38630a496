// K5: encode and stitch in one kernel (encode_fused).
//
// Replaces the TPU kernel wah_tpu/ops/pallas/encode_kernel.py::encode_fused
// (body _fused_body). Same contract: (nb, 992) uint32 ints + nv = [bound,
// chunk_base] -> words (nb*1024,), the dense stream as a prefix (words past
// the total are never written), and counts (nb, 1).
//
// On the TPU the grid runs in order, so a running word total in scalar
// memory is the scan, and a pending window with double-buffered flushes
// exists because stores are tile-aligned. Neither carries over. Here it is
// a single-pass encode with a decoupled look-back scan:
//   1. A CTA of 128 threads (the shape of encode_block.cuh) takes its logical
//      block index from an atomic ticket, never from blockIdx: CTAs are not
//      scheduled in blockIdx order, and a CTA may wait only for CTAs that are
//      already running. It takes one block, so it waits only for tickets
//      below its own.
//   2. It copies the block's ints to shared memory and encodes them with
//      encode_block (shared with K1), which leaves the block's words as a
//      dense row in shared memory, and publishes the block's word count as
//      an AGGREGATE descriptor.
//   3. Warp 0 looks back over the predecessors' descriptors, 32 per step
//      (lane l polls block b-1-l, then b-33-l, ...): it waits until none of
//      the 32 is empty, adds the aggregates up to and including the nearest
//      INCLUSIVE one, and stops there, else steps back 32 more. Blocks before
//      block 0 count as inclusive 0. It then publishes its own inclusive
//      prefix, so a successor seldom looks further back than one step.
//   4. The row goes to out[prefix .. prefix + count) in order, neighbouring
//      threads on neighbouring words.
// A descriptor is one 64-bit word, status in the high half and value in the
// low half, stored and loaded as one access so it cannot tear; a
// __threadfence() precedes each store and the loads are volatile.
//
// Workspace (64-bit words, zeroed by the wrapper before every launch):
// [0] the ticket counter, [1] the error flag, [2 + b] block b's descriptor.
// A wait is bounded: after kMaxSpins polls a warp raises the error flag and
// its CTA leaves without writing; every other CTA sees the flag at its next
// poll or at its start and leaves too. The caller reads the flag after a
// sync. The last block's inclusive prefix, desc[nb-1], is the total.
//
// Bound: memory by its bytes. Per block it reads 3,968 B of ints and writes
// its words (at most 4,096 B), a 4 B count and an 8 B descriptor; no staging
// array. What it waits for is the look-back: dependent round trips to L2.
#include "encode_block.cuh"

namespace {

using namespace wah;

using desc_t = unsigned long long;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;  // 0: empty
constexpr int kMaxSpins = 1 << 22;

__device__ __forceinline__ desc_t make_desc(unsigned status, int value) {
  return ((desc_t)status << 32) | (unsigned)value;
}
__device__ __forceinline__ unsigned desc_status(desc_t d) { return (unsigned)(d >> 32); }
__device__ __forceinline__ int desc_value(desc_t d) { return (int)(unsigned)d; }

__device__ __forceinline__ void publish(volatile desc_t* desc, int b, unsigned status, int value) {
  __threadfence();
  desc[b] = make_desc(status, value);
}

// Sum of the word counts of blocks [0, b), b >= 1; -1 if a wait ran past its
// bound (the error flag is then set). All 32 lanes of one warp call it.
__device__ __forceinline__ int look_back(volatile desc_t* desc, volatile int* err, int b) {
  const int lane = lane_id();
  int prefix = 0, spins = 0;
  for (int j = b - 1 - lane;; j -= 32) {
    desc_t d = j >= 0 ? desc[j] : make_desc(kInclusive, 0);
    while (__any_sync(kFullMask, desc_status(d) == 0u)) {
      if (__any_sync(kFullMask, ++spins > kMaxSpins || ((spins & 63) == 0 && *err != 0))) {
        if (lane == 0) *err = 1;
        return -1;
      }
      if (desc_status(d) == 0u) d = desc[j];
    }
    // lanes up to the nearest inclusive predecessor contribute
    const unsigned incl = __ballot_sync(kFullMask, desc_status(d) == kInclusive);
    const int last = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= last ? desc_value(d) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    prefix += v;
    if (incl) return prefix;
  }
}

__global__ void __launch_bounds__(kEncodeThreads)
encode_fused_kernel(const uint32_t* __restrict__ ints, const int32_t* __restrict__ nv,
                    uint32_t* __restrict__ out, int32_t* __restrict__ counts, desc_t* ws) {
  __shared__ __align__(16) EncodeShared s;
  __shared__ int s_block, s_prefix;
  volatile int* err = (volatile int*)(ws + 1);
  volatile desc_t* desc = ws + 2;

  if (threadIdx.x == 0) s_block = *err ? -1 : (int)atomicAdd((unsigned*)ws, 1u);
  __syncthreads();
  const int b = s_block;
  if (b < 0) return;  // an earlier CTA failed: the whole CTA leaves

  copy_block_ints(s, 0, ints, b);
  cp_async_wait<0>();
  const int count = encode_block(s, 0, b, nv[0], nv[1], (int)kOnes31);

  if (threadIdx.x < 32) {
    int prefix = 0;
    if (b > 0) {
      if (threadIdx.x == 0) publish(desc, b, kAggregate, count);
      prefix = look_back(desc, err, b);
    }
    if (threadIdx.x == 0) {
      publish(desc, b, kInclusive, max(prefix, 0) + count);
      counts[b] = count;
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const int prefix = s_prefix;
  if (prefix < 0) return;
  // the block's words lie dense in s.row: they go out in order
  for (int j = threadIdx.x; j < count; j += kEncodeThreads) out[(size_t)prefix + j] = s.row[j];
}

}  // namespace

extern "C" int wah_encode_fused(const void* ints, const void* nv, void* out, void* counts,
                                void* ws, int nb, void* stream) {
  encode_fused_kernel<<<nb, kEncodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ints, (const int32_t*)nv, (uint32_t*)out, (int32_t*)counts,
      (desc_t*)ws);
  return (int)cudaGetLastError();
}
