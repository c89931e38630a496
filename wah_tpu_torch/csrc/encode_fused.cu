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
// a single-pass encode with a decoupled look-back scan over TILES of
// kTileBlocks consecutive blocks, the look-back of a tile deferred behind the
// encode of the CTA's next tile:
//   1. A persistent grid: as many CTAs of 128 threads (the shape of
//      encode_block.cuh) as the card holds at once, and never more than
//      there are tiles. A CTA takes tile indices from an atomic ticket in a
//      loop until they run out, never from blockIdx: CTAs are not scheduled
//      in blockIdx order. It takes the ticket of its next tile when it starts
//      on the current one, so that tile's first copy can be started early.
//   2. It encodes the tile's blocks one after the other with encode_block
//      (shared with K1) from the two-stage cp.async staging, block i + 1's
//      ints in flight while block i is encoded, each block's row starting in
//      shared memory where the words of the one before end: after the last
//      block the tile's words lie dense in shared memory and their number is
//      the tile's aggregate, which thread 0 publishes as the tile's
//      descriptor. The rows must outlive the look-back, so they are kept
//      (the alternative, a count pass first and the emit after the prefix is
//      known, would keep as many bytes, the staged ints, and classify
//      twice), and there are two tile buffers:
//   3. only now, one tile's encode after its aggregate went out, the CTA
//      resolves the tile it encoded BEFORE this one. Warp 0 looks back over
//      that tile's predecessors, 32 descriptors a step (lane l polls tile
//      t-1-l, then t-33-l, ...): it waits until none of the lanes up to the
//      nearest INCLUSIVE one is empty, adds their aggregates and that
//      inclusive prefix, and stops there, else steps back 32 more. Tiles
//      before tile 0 count as inclusive 0. By then the predecessors'
//      aggregates have long been published, so the wait is a round trip to
//      L2, and CTAs do not fall into step with each other (when a tile was
//      resolved right after its own encode, every CTA waited for the slowest
//      of its predecessors and then all stored at once: 0.19 ms against
//      0.14 at 32,768 blocks on an H100). It then publishes the tile's
//      inclusive prefix and
//   4. the tile goes to out[prefix .. prefix + aggregate) in order,
//      neighbouring threads on neighbouring words (the destination is
//      aligned only by chance, so these are 4 B stores, a warp to a line;
//      16 B stores with a head and a tail apart measured the same).
// Tickets, descriptors and look-backs are a kTileBlocks-th of one a block.
// kTileBlocks = 3 by sweep over 2, 3, 4, 5, 6, 8 (16 without the deferral):
// two buffers of 3 rows and the staging are 32 KB, which fits as many CTAs
// on an SM (6) as the kernel's registers allow.
//
// No deadlock: a CTA waits only in the look-back of a tile t, and only for
// descriptors of tiles below t. Every ticket below t was taken by a CTA that
// is running. By induction on k, tile k's aggregate is published: its holder
// publishes it after the encode, without waiting, once it is through the
// look-backs of the tiles it took earlier (lower tickets), and each of those
// waits only for aggregates of tiles below it, so below k, which by
// induction are published. Holding the next ticket early, and resolving a
// tile after the next one's encode, do not break this: a CTA's tickets rise,
// and it publishes every aggregate before it waits for anything lower.
//
// A descriptor is one 64-bit word, status in the high half and value in the
// low half, stored and loaded as one access so it cannot tear. The stores
// and polls are st.relaxed.gpu / ld.relaxed.gpu: strong accesses that go to
// L2, with no fence. No ordering with other memory is needed, because the
// only data a descriptor publishes is the descriptor itself: no CTA reads
// what another wrote to `out` or `counts`. (st.release.gpu / ld.acquire.gpu
// would also be right and measured 8-11% slower, 0.158 against 0.142 ms at
// 32,768 blocks on an H100: a release waits for the thread's earlier stores.) A poll that finds an empty
// descriptor backs off with __nanosleep before the next.
//
// Workspace (64-bit words, zeroed by the wrapper before every launch):
// [0] the ticket counter, [1] the error flag, [2 + t] tile t's descriptor.
// A wait is bounded: after kMaxSpins polls a warp raises the error flag and
// its CTA leaves without writing; every other CTA sees the flag at its next
// poll or when it takes a ticket and leaves too (the flag is set before any
// CTA leaves, so a successor that still waits finds it). The caller reads
// the flag after a sync. The last tile's inclusive prefix is the total.
//
// Bound: memory by its bytes. Per block it reads 3,968 B of ints and writes
// its words (at most 4,096 B) and a 4 B count, per tile an 8 B descriptor;
// no staging array.
#include "encode_block.cuh"

namespace {

using namespace wah;

constexpr int kTileBlocks = 3;  // FUSED_TILE_BLOCKS of ops/cuda/encode_kernel.py
constexpr int kTileWords = kTileBlocks * kBlockChunks;

using desc_t = unsigned long long;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;  // 0: empty
constexpr int kMaxSpins = 1 << 22;
constexpr unsigned kMaxSleepNs = 256;

__device__ __forceinline__ desc_t make_desc(unsigned status, int value) {
  return ((desc_t)status << 32) | (unsigned)value;
}
__device__ __forceinline__ unsigned desc_status(desc_t d) { return (unsigned)(d >> 32); }
__device__ __forceinline__ int desc_value(desc_t d) { return (int)(unsigned)d; }

__device__ __forceinline__ void publish(desc_t* p, desc_t d) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;\n" ::"l"(p), "l"(d) : "memory");
}
__device__ __forceinline__ desc_t poll(const desc_t* p) {
  desc_t d;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];\n" : "=l"(d) : "l"(p) : "memory");
  return d;
}

// Sum of the word counts of tiles [0, t), t >= 1; -1 if a wait ran past its
// bound or another CTA's did (the error flag is then set). All 32 lanes of
// one warp call it.
__device__ __forceinline__ int look_back(const desc_t* desc, volatile int* err, int t) {
  const int lane = lane_id();
  int prefix = 0, spins = 0;
  unsigned sleep_ns = 32;
  for (int j = t - 1 - lane;; j -= 32) {
    desc_t d = j >= 0 ? poll(desc + j) : make_desc(kInclusive, 0);
    unsigned incl;
    for (;;) {
      // only the lanes up to the nearest inclusive predecessor are needed
      incl = __ballot_sync(kFullMask, desc_status(d) == kInclusive);
      const unsigned need = incl ? (2u << (__ffs(incl) - 1)) - 1u : kFullMask;
      const unsigned empty = __ballot_sync(kFullMask, desc_status(d) == 0u);
      if (!(empty & need)) break;
      if (__any_sync(kFullMask, ++spins > kMaxSpins || ((spins & 15) == 0 && *err != 0))) {
        if (lane == 0) *err = 1;
        return -1;
      }
      __nanosleep(sleep_ns);
      sleep_ns = min(2 * sleep_ns, kMaxSleepNs);
      if (desc_status(d) == 0u) d = poll(desc + j);
    }
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
                    uint32_t* __restrict__ out, int32_t* __restrict__ counts, desc_t* ws, int nb,
                    int n_tiles) {
  __shared__ __align__(16) EncodeShared s;
  // two tiles' words, each dense from its start: one is encoded while the
  // other waits for its prefix
  __shared__ __align__(16) uint32_t s_tile[2][kTileWords];
  __shared__ int s_first, s_next, s_prefix[2];
  volatile int* err = (volatile int*)(ws + 1);
  desc_t* desc = ws + 2;
  const int bound = nv[0], base = nv[1];

  // the next tile index, or -1 once a CTA has failed
  auto take_ticket = [&]() { return *err ? -1 : (int)atomicAdd((unsigned*)ws, 1u); };
  auto is_tile = [&](int t) { return (unsigned)t < (unsigned)n_tiles; };

  if (threadIdx.x == 0) s_first = take_ticket();
  __syncthreads();
  int tile = s_first, stage = 0;  // `stage` holds the ints of the next block to encode
  if (is_tile(tile)) copy_block_ints(s, stage, ints, tile * kTileBlocks);

  int prev = -1, prev_agg = 0;  // the tile encoded before this one, not yet stored
  for (int p = 0;; p ^= 1) {
    const bool have = is_tile(tile);
    int agg = 0, next = -1;  // agg: the words of the tile's blocks so far
    if (have) {
      if (threadIdx.x == 0) s_next = take_ticket();
      const int b0 = tile * kTileBlocks, n_blocks = min(kTileBlocks, nb - b0);
      for (int i = 0; i < n_blocks; ++i, stage ^= 1) {
        if (i + 1 < n_blocks) copy_block_ints(s, stage ^ 1, ints, b0 + i + 1);
        else cp_async_commit();  // an empty group, so that the wait below counts the same
        cp_async_wait<1>();
        // the row starts where the words of the block before end
        const int count = encode_block(s, stage, s_tile[p] + agg, b0 + i, bound, base,
                                       (int)kOnes31);
        if (threadIdx.x == 0) counts[b0 + i] = count;
        agg += count;
      }
      // thread 0 wrote s_next at least two barriers ago; the next tile's first
      // block is copied behind the look-back and the stores below
      next = s_next;
      if (is_tile(next)) copy_block_ints(s, stage, ints, next * kTileBlocks);
      if (threadIdx.x == 0)  // tile 0's prefix is known: 0
        publish(desc + tile, make_desc(tile == 0 ? kInclusive : kAggregate, agg));
    }
    if (prev >= 0) {
      if (threadIdx.x < 32) {
        int prefix = 0;
        if (prev > 0) {
          prefix = look_back(desc, err, prev);
          if (threadIdx.x == 0 && prefix >= 0)
            publish(desc + prev, make_desc(kInclusive, prefix + prev_agg));
        }
        if (threadIdx.x == 0) s_prefix[p] = prefix;
      }
      __syncthreads();
      const int prefix = s_prefix[p];  // by parity: thread 0 may write the next before all read
      if (prefix < 0) return;  // a wait gave up, here or elsewhere: the whole CTA leaves
      uint32_t* dst = out + (size_t)prefix;
      for (int j = threadIdx.x; j < prev_agg; j += kEncodeThreads) dst[j] = s_tile[p ^ 1][j];
    }
    if (!have) break;
    prev = tile, prev_agg = agg, tile = next;
  }
}

}  // namespace

// The workspace holds ws_words 64-bit words: at least 2 + the number of
// tiles. The grid is one CTA for each the device holds at once (and never
// more than there are tiles).
extern "C" int wah_encode_fused(const void* ints, const void* nv, void* out, void* counts,
                                void* ws, int nb, int ws_words, void* stream) {
  const int n_tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  if (ws_words < n_tiles + 2) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = resident_ctas(encode_fused_kernel, kEncodeThreads, &resident);
  if (err != cudaSuccess) return (int)err;
  encode_fused_kernel<<<min(n_tiles, resident), kEncodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ints, (const int32_t*)nv, (uint32_t*)out, (int32_t*)counts, (desc_t*)ws,
      nb, n_tiles);
  return (int)cudaGetLastError();
}
