// The per-block WAH encode shared by K1 (encode.cu) and K5 (encode_fused.cu).
//
// Bound: memory by its bytes (3,968 B of ints in, at most 4,096 B of words
// out), but a block is little work behind a load, so a CTA that loads,
// synchronises and stores one block at a time waits on latency, and a thread
// that owns one chunk pays every index computation and every barrier for that
// one chunk. The body gives a thread much work, waits little, and lets a CTA
// keep a second block in flight:
//   * A CTA is 128 threads. Warp w owns the eight 31-int groups 8w .. 8w+7,
//     lane l chunk l of each, so a chunk's two source ints are the lane's
//     own int and its left neighbour's (one shuffle).
//   * The warp's 248 ints are 992 contiguous, 16 B-aligned bytes: its lanes
//     copy them to shared memory with cp.async (62 uint4), lane 31 also the
//     one int before them (a warp's first chunk continues a run iff it has
//     the type of the chunk before it, which is that int >> 1). The staging
//     is private to the warp, two stages of it, so a CTA that walks several
//     blocks copies the next block's ints while this one is encoded, with no
//     CTA barrier.
//   * Zero chunks, ones chunks and valid chunks are ballots, and run starts
//     follow from them by warp-uniform bit operations. One barrier publishes
//     each warp's start count, valid count and first start; every thread
//     sums the four it needs itself. A fill's length is the next start minus
//     its own: the next set bit of its ballot, else the warp's later
//     ballots, else the first start of a later warp, else the valid end.
//   * Each start writes its word to its slot of a 4 KB row in shared
//     memory, which the caller provides, and chunks at or past the count
//     write zeros, so the row is the block's staging row: dense words, zeros
//     after. K1 stores it as 256 uint4; K5 lays the rows of a tile of blocks
//     end to end (each row starts where the words of the one before end) and
//     stores the tile as out[prefix .. prefix + the tile's count).
// Two __syncthreads() of four warps a block. (The first version: 1,024
// threads a block, one chunk each, four barriers of 32 warps, the types and
// the start positions through shared memory, a scattered 4 B store a word.)
#pragma once

#include "common.cuh"

namespace wah {

constexpr int kWarpGroups = 8;                      // 31-int groups a warp owns
constexpr int kEncodeWarps = 32 / kWarpGroups;      // a block is 32 groups: 4 warps
constexpr int kEncodeThreads = 32 * kEncodeWarps;   // 128
constexpr int kWarpInts = 31 * kWarpGroups;         // 248: 992 B, a multiple of 16
constexpr int kWarpStride = (kWarpInts + 4) & ~3;   // and room for the int before them
static_assert(kWarpInts % 4 == 0, "a warp copies its ints as 16 B vectors");
constexpr int kNoStart = kBlockChunks;              // "no start here": past every chunk

struct EncodeShared {
  // [stage][warp]: the warp's ints, then at [kWarpInts] the int before them
  uint32_t ints[2][kEncodeWarps][kWarpStride];
  // per warp: run starts | valid chunks << 16, and its first start's chunk
  int warp_info[kEncodeWarps], warp_first[kEncodeWarps];
};

// Start the copy of block b's ints into `stage` (rows of 992 ints, `ints`
// 16 B-aligned) and commit it as one cp.async group. Every thread of the CTA
// calls it. The stage must not be the one this warp is still reading.
__device__ __forceinline__ void copy_block_ints(EncodeShared& s, int stage,
                                                const uint32_t* __restrict__ ints, int b) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const uint32_t* src = ints + (size_t)b * kBlockInts + warp * kWarpInts;
  uint32_t* dst = s.ints[stage][warp];
#pragma unroll
  for (int v = lane; v < kWarpInts / 4; v += 32) cp_async_16(dst + 4 * v, src + 4 * v);
  if (lane == 31 && warp > 0) cp_async_4(dst + kWarpInts, src - 1);
  cp_async_commit();
}

// Encode block b from the ints in `stage`, whose copy this thread has waited
// for (cp_async_wait). Chunk k is valid when ((base + 1024 b + k) & pos_mask)
// < bound; invalid chunks start no word. Returns the block's word count and
// leaves the words in `row` (1,024 words of shared memory: the count's words,
// then zeros), readable by every thread. All threads of the CTA must call it
// (it holds two __syncthreads(), the second at its end); nothing is written
// to `row` before the first.
__device__ __forceinline__ int encode_block(EncodeShared& s, int stage, uint32_t* row, int b,
                                            int bound, int base, int pos_mask) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  __syncwarp();  // the warp's copies have all been waited for
  const uint32_t* mine = s.ints[stage][warp];

  uint32_t chunk[kWarpGroups], starts[kWarpGroups], fills[kWarpGroups], ones[kWarpGroups];
  int info = 0, first = kNoStart;
  // whether the chunk before the warp's first (chunk 31 of the group before,
  // the int before the warp's >> 1) is a zero or a ones chunk
  uint32_t zero_before = 0u, ones_before = 0u;
  if (warp > 0) {
    const uint32_t before = mine[kWarpInts] >> 1;
    zero_before = before == 0u, ones_before = before == kOnes31;
  }
#pragma unroll
  for (int i = 0; i < kWarpGroups; ++i) {
    // 32 -> 31-bit repartition (reference kernels.cu:79); the right shift is
    // split so lane 0 never shifts by 32 (wah_tpu/ops/bits.py:38)
    const uint32_t own = lane < 31 ? mine[31 * i + lane] : 0u;
    uint32_t prev = __shfl_up_sync(kFullMask, own, 1);
    if (lane == 0) prev = 0u;
    chunk[i] = kOnes31 & (((prev >> (31 - lane)) >> 1) | (own << lane));
    // validity from the global chunk position (int32 wrap as in the TPU kernel)
    const int c = 32 * (kWarpGroups * warp + i) + lane;
    const int gpos = (int)((uint32_t)base + (uint32_t)b * kBlockChunks + (uint32_t)c);
    const uint32_t valid = __ballot_sync(kFullMask, (gpos & pos_mask) < bound);
    // classify (reference kernels.cu:93-112) as ballots: a chunk starts a word
    // unless it is a zero (ones) chunk behind a zero (ones) chunk
    const uint32_t zero = __ballot_sync(kFullMask, chunk[i] == 0u);
    ones[i] = __ballot_sync(kFullMask, chunk[i] == kOnes31);
    fills[i] = zero | ones[i];
    starts[i] = valid & ~((zero & ((zero << 1) | zero_before)) |
                          (ones[i] & ((ones[i] << 1) | ones_before)));
    zero_before = zero >> 31, ones_before = ones[i] >> 31;
    info += __popc(starts[i]) + (__popc(valid) << 16);
    if (first == kNoStart && starts[i])
      first = 32 * (kWarpGroups * warp + i) + __ffs(starts[i]) - 1;
  }
  if (lane == 0) {
    s.warp_info[warp] = info;
    s.warp_first[warp] = first;
  }
  __syncthreads();  // also: every thread is done with the row of the block before

  // this warp's first slot, the block's count and valid end (validity is a
  // prefix), and the first start past this warp
  int below = 0, total = 0, next_warp = kNoStart;
#pragma unroll
  for (int w = 0; w < kEncodeWarps; ++w) {
    const int n = s.warp_info[w];
    if (w < warp) below += n;
    total += n;
    if (w > warp) next_warp = min(next_warp, s.warp_first[w]);
  }
  int slot = below & 0xFFFF;
  const int count = total & 0xFFFF, valid_end = total >> 16;
  // next_group[i]: the first start past group i of this warp, or the valid end
  int next_group[kWarpGroups];
  next_group[kWarpGroups - 1] = min(next_warp, valid_end);
#pragma unroll
  for (int i = kWarpGroups - 1; i > 0; --i)
    next_group[i - 1] = starts[i] ? 32 * (kWarpGroups * warp + i) + __ffs(starts[i]) - 1
                                  : next_group[i];
#pragma unroll
  for (int i = 0; i < kWarpGroups; ++i) {
    const int c = 32 * (kWarpGroups * warp + i) + lane;
    if ((starts[i] >> lane) & 1u) {
      uint32_t word = chunk[i];
      if ((fills[i] >> lane) & 1u) {
        // a fill's length: the next start (or the block's valid end) minus its own
        const uint32_t above = starts[i] & ~lanes_below & ~(1u << lane);
        const int next = above ? c - lane + __ffs(above) - 1 : next_group[i];
        word = (((ones[i] >> lane) & 1u) ? kBit3130 : kBit31) | (uint32_t)(next - c);
      }
      row[slot + __popc(starts[i] & lanes_below)] = word;
    }
    if (c >= count) row[c] = 0u;
    slot += __popc(starts[i]);
  }
  __syncthreads();
  return count;
}

}  // namespace wah
