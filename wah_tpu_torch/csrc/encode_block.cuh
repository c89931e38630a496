// The per-block WAH encode shared by K1 (encode.cu) and K5 (encode_fused.cu).
//
// One CTA of 1024 threads encodes one 992-int block, one chunk per thread.
// Warp w is the 31-int group w, so a chunk's two source ints are the lane's
// own int and its left neighbour's (one shuffle). Run starts are numbered by
// a block scan (ballot + popc inside a warp, the 32 warp sums in shared
// memory); each start records its position in shared memory, so a fill's
// length is the next start (or the block's valid end) minus its own.
#pragma once

#include "common.cuh"

namespace wah {

// What thread c (chunk c of the block) holds after encode_block: whether its
// chunk starts a word, that word, and the word's slot in the block's stream.
struct BlockWord {
  bool start;
  uint32_t word;
  int slot;
};

// Encode block `b` of `ints` (rows of 992). Chunk k is valid when
// ((base + 1024 b + k) & pos_mask) < bound; invalid chunks start no word.
// *count gets the block's word count. All 1024 threads of the CTA must call
// it (it holds __syncthreads()); about 3 KB of static shared memory.
__device__ __forceinline__ BlockWord encode_block(const uint32_t* __restrict__ ints, int b,
                                                  int bound, int base, int pos_mask,
                                                  int* count) {
  __shared__ int8_t s_type[kBlockChunks];
  __shared__ int16_t s_start_pos[kBlockChunks];
  __shared__ int s_warp_starts[32];
  __shared__ int s_warp_valid[32];
  __shared__ int s_count, s_valid_end;

  const int c = threadIdx.x;    // chunk within the block
  const int lane = c & 31;      // chunk within its 31-int group
  const int warp = c >> 5;      // the group

  // 32 -> 31-bit repartition (reference kernels.cu:79); the right shift is
  // split so lane 0 never shifts by 32 (wah_tpu/ops/bits.py:38).
  const uint32_t* grp = ints + (size_t)b * kBlockInts + warp * 31;
  const uint32_t own = lane < 31 ? grp[lane] : 0u;
  uint32_t prev = __shfl_up_sync(kFullMask, own, 1);
  if (lane == 0) prev = 0u;
  const uint32_t chunk = kOnes31 & (((prev >> (31 - lane)) >> 1) | (own << lane));

  // classify: 0 zero, 1 ones, 2 literal (reference kernels.cu:93-112)
  const int type = chunk == 0u ? 0 : (chunk == kOnes31 ? 1 : 2);
  // validity from the global chunk position (int32 wrap as in the TPU kernel)
  const int gpos = (int)((uint32_t)base + (uint32_t)b * kBlockChunks + (uint32_t)c);
  const bool valid = (gpos & pos_mask) < bound;

  s_type[c] = (int8_t)type;
  __syncthreads();
  const int prev_type = c == 0 ? -1 : s_type[c - 1];
  const bool start = valid && (type != prev_type || type == 2);

  // block scan of run starts; count of valid chunks (validity is a prefix)
  const unsigned starts = __ballot_sync(kFullMask, start);
  const unsigned valids = __ballot_sync(kFullMask, valid);
  if (lane == 0) {
    s_warp_starts[warp] = __popc(starts);
    s_warp_valid[warp] = __popc(valids);
  }
  __syncthreads();
  if (warp == 0) {
    const int n = s_warp_starts[lane];
    const int incl = warp_inclusive_scan(n);
    s_warp_starts[lane] = incl - n;
    const int nvalid = warp_inclusive_scan(s_warp_valid[lane]);
    if (lane == 31) {
      s_count = incl;
      s_valid_end = nvalid;
    }
  }
  __syncthreads();
  const int slot = s_warp_starts[warp] + __popc(starts & ((1u << lane) - 1u));
  *count = s_count;
  if (start) s_start_pos[slot] = (int16_t)c;
  __syncthreads();

  uint32_t word = chunk;
  if (start && type != 2) {
    const int next = slot + 1 < s_count ? s_start_pos[slot + 1] : s_valid_end;
    word = (type == 1 ? kBit3130 : kBit31) | (uint32_t)(next - c);
  }
  return {start, word, slot};
}

}  // namespace wah
