// K3: word prescan (prescan_words) and K4: block decoder (decode).
//
// K3 replaces wah_tpu/ops/pallas/decode_kernel.py::prescan_words (body
// _prescan_body). Same contract: words (rows_in * 128,) + vc (out_rows,)
// -> words_t (out_rows, 128) with lane k of granule row r kept iff
// k < vc[r] (zero otherwise, and zero for rows past the input), and
// g_sums (out_rows,), each 128-word granule's expanded size (fill -> run
// length, literal -> 1, masked -> 0).
// Design: one warp per granule, each lane loading 4 words as one 16 B
// vector, a shuffle reduction for the sum.
// Bound: memory. Per 1,024-word block of stream it reads 4,096 B of words
// and 32 B of vc, and writes 4,096 B of words_t and 32 B of sums.
//
// K4 replaces wah_tpu/ops/pallas/decode_kernel.py::decode -> _run_decode
// (body _decode_body). Same contract: words_t, the exclusive granule bases
// g_base = cumsum(g_sums) - g_sums (computed outside, as in wah_tpu), and
// meta = [n_chunks, m, chunk_base, pos_mask] -> (nbo, 992) ints, block bo
// holding chunks [chunk_base + 1024 bo, + 1024) merged back to 32 bits.
// chunk_base is a multiple of 1024 and pos_mask has its low 10 bits set, so
// a block's valid chunks are a prefix of it.
//
// Bound: memory by its bytes (per block the 4,608 B window, of which about
// the block's own ~4 KB come from device memory since neighbouring windows
// overlap, and 3,968 B of ints out), but a block's work is a chain of
// dependent steps (granule -> window -> offsets -> covering words -> merge),
// so what a simple kernel waits for is latency, not bytes. The design keeps
// the chain off the critical path and keeps many blocks in flight:
//   * A CTA is 160 threads, of which 144 hold 8 words each of the
//     1,152-word window, and walks a contiguous range of output blocks
//     (about 9 at 32,768 blocks: 4 CTAs for each one the card holds at
//     once); several CTAs share an SM, so one block's loads overlap
//     another's arithmetic. Few threads with much work each: the per-thread
//     cost of a scan, a barrier or an index computation is paid once for 8
//     words.
//   * The covering granule, max{g : g_base[g] <= base}, is searched once at
//     the start of the range. Output blocks are consecutive and a block
//     consumes at most 1,024 words, so the next block's granule lies at most
//     8 past this one's: every warp probes the 32 entries of g_base from the
//     last granule with one coalesced load and a ballot, and falls back to
//     the 32-way search of common.cuh only when the probe does not bracket
//     (a batched column's boundary). On ties the largest g wins, so a column
//     that fills its capacity hands the next column's first block to that
//     column. g_base[g] comes out of the probe by a shuffle. Every warp does
//     this itself: no broadcast through shared memory, no barrier.
//   * The window (9 granules, 16 B-aligned) of block bo+1 is copied into the
//     other half of a two-stage ring by cp.async while block bo is expanded.
//   * One scan over the window's word counts (8 words a thread, a warp scan,
//     5 warp sums: the block scan of common.cuh, which T1 checks) gives each
//     word's first chunk. Each word that starts
//     inside the block writes its index at its start's slot, and each word
//     that reaches over the first slot of one of the 4 output warps'
//     256-slot spans writes its index there; a forward fill by a warp-wide
//     running maximum then hands every chunk its covering word. No search.
//     (The first version: 1,024 threads a block, the granule by a full
//     search a block, two scans, an 11-step binary search a chunk.)
//   * Each of 4 warps expands 256 chunks (8 a thread), merges 31 -> 32 bits
//     in registers with one shuffle (int[x] = (c[x] >> x) | (c[x+1] <<
//     (31-x)) inside each 32-chunk group; blocks are group-aligned, so no
//     carry crosses a block), stages its 248 ints in shared memory and
//     stores them as 62 uint4 (a row is 248 uint4).
//   * A block with no valid chunk (capacity past the stream's or a column's
//     end) is written as zeros without touching the stream.
// Two __syncthreads() a block; the rest is warp-local.
// The TPU kernel maps every grid step to its granule with one searchsorted
// outside and scalar prefetch; here the probe does that inside, as a block
// loads its own indices on a GPU. Its DMA windows, lane rotations and
// log-shift expansion are TPU mechanics; the window idea remains.
#include "common.cuh"

namespace {

using namespace wah;

constexpr int kPrescanWarps = 8;
constexpr int kWindow = 9 * kGranule;  // 1,152 words
constexpr int kDecodeWaves = 4;        // K4's grid, in CTAs for each resident one

__device__ __forceinline__ uint32_t expanded_size(uint32_t w) {
  return (w & kBit31) ? (w & kLenMask) : 1u;
}

__global__ void __launch_bounds__(kPrescanWarps * 32)
prescan_kernel(const uint4* __restrict__ words, const int32_t* __restrict__ vc,
               uint4* __restrict__ words_t, int32_t* __restrict__ g_sums,
               int rows_in, int out_rows) {
  const int r = blockIdx.x * kPrescanWarps + (threadIdx.x >> 5);
  const int lane = lane_id();
  if (r >= out_rows) return;  // whole warps leave together
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < rows_in) v = words[(size_t)r * 32 + lane];
  const int keep = vc[r] - lane * 4;  // lanes k < vc[r] stay
  uint32_t e[4] = {v.x, v.y, v.z, v.w};
  uint32_t sum = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= keep) e[i] = 0u;
    else sum += expanded_size(e[i]);
  }
  words_t[(size_t)r * 32 + lane] = make_uint4(e[0], e[1], e[2], e[3]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFullMask, sum, d);
  if (lane == 0) g_sums[r] = (int32_t)sum;
}

constexpr int kW = 8;                             // window words, and chunks, a thread
constexpr int kWinThreads = kWindow / kW;         // 144 threads hold the window
constexpr int kWinWarps = (kWinThreads + 31) / 32;
constexpr int kDecodeThreads = 32 * kWinWarps;    // 160
constexpr int kSpan = 32 * kW;                    // chunks an output warp expands: 256
constexpr int kSpanShift = 8;                     // log2(kSpan)
constexpr int kOutWarps = kBlockChunks / kSpan;   // 4
constexpr int kGroupThreads = 32 / kW;            // threads to a 32-chunk group
constexpr int kRowVecs = kBlockInts / 4;          // an output row is 248 uint4
static_assert(kSpan == 1 << kSpanShift && kOutWarps <= kWinWarps && kW % 4 == 0, "K4 shape");

// The covering granule of chunk position `key`, max{g : g_base[g] <= key},
// given a granule `hint` with g_base[hint] <= key and `probe`, this lane's
// entry g_base[hint + lane] (anything where hint + lane >= n_rows). *off0
// gets g_base[g]. All 32 lanes of a warp call it; each gets the result.
__device__ __forceinline__ int covering_granule(const int32_t* __restrict__ g_base, int hint,
                                                int probe, int key, int n_rows, int* off0) {
  const int lane = lane_id();
  const unsigned le = __ballot_sync(kFullMask, hint + lane < n_rows && probe <= key);
  if (le == kFullMask && hint + 32 < n_rows) {  // not bracketed: the full search
    const int g = warp_search_last_le(g_base, hint + 31, n_rows, key);
    *off0 = g_base[g];
    return g;
  }
  // g_base is sorted, so `le` is a prefix of lanes that holds lane 0
  const int k = le ? 31 - __clz(le) : 0;
  *off0 = __shfl_sync(kFullMask, probe, k);
  return hint + k;
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_blocks_kernel(const uint32_t* __restrict__ words_t, const int32_t* __restrict__ g_base,
                     const int32_t* __restrict__ meta, uint4* __restrict__ out, int n_rows,
                     int nbo, int per_cta) {
  __shared__ __align__(16) uint32_t s_win[2][kWindow];
  // slot k: the window index of the word that starts at chunk k of the block
  // (0 where none does); then, per output warp, its merged ints
  __shared__ __align__(16) uint32_t s_slot[kBlockChunks];
  __shared__ int s_warp_sum[kWinWarps];
  // the word that starts before chunk kSpan w of the block and covers it (0: none)
  __shared__ int s_cover[kOutWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool holds = t < kWinThreads;  // this thread holds kW words of the window
  const int n_chunks = meta[0], m = meta[1], pos_mask = meta[3];
  const uint32_t chunk_base = (uint32_t)meta[2];
  const int bo0 = blockIdx.x * per_cta, bo1 = min(bo0 + per_cta, nbo);
  const size_t n_words = (size_t)n_rows * kGranule;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  if (t < kOutWarps) s_cover[t] = 0;
  for (int v = t; v < kBlockChunks / 4; v += kDecodeThreads) ((uint4*)s_slot)[v] = zero4;

  auto block_base = [&](int bo) { return chunk_base + (uint32_t)bo * kBlockChunks; };
  // validity is a prefix of a block: none of its chunks is valid iff the first is not
  auto block_valid = [&](int bo) { return (int)(block_base(bo) & (uint32_t)pos_mask) < n_chunks; };
  auto probe_at = [&](int hint) { return hint + lane < n_rows ? g_base[hint + lane] : 0; };
  auto copy_window = [&](int stage, int g) {
    if (holds) {
#pragma unroll
      for (int v = 0; v < kW / 4; ++v) {
        const size_t w = (size_t)g * kGranule + kW * t + 4 * v;
        const bool inside = w < n_words;  // n_words is a multiple of 4
        cp_async_16(&s_win[stage][kW * t + 4 * v], words_t + (inside ? w : 0), inside);
      }
    }
    cp_async_commit();
  };

  int hint = 0;  // the last granule found: g_base[hint] <= every later base
  bool cur_valid = block_valid(bo0);
  int cur_g = 0, cur_off0 = 0;
  if (cur_valid) {
    cur_g = covering_granule(g_base, 0, probe_at(0), (int)block_base(bo0), n_rows, &cur_off0);
    hint = cur_g;
    copy_window(0, cur_g);
  }

  for (int bo = bo0; bo < bo1; ++bo) {
    const int stage = (bo - bo0) & 1;
    const uint32_t base = block_base(bo);
    const bool nxt_valid = bo + 1 < bo1 && block_valid(bo + 1);
    // the next block's probe is loaded now and used after the barrier
    const int probe = nxt_valid ? probe_at(hint) : 0;

    // 1. this thread's window words' counts (words at or past m count 0),
    //    scanned across the warp
    int cnt[kW];
    int sum = 0, incl = 0;
    if (cur_valid) {
      cp_async_wait<0>();
      // how many of this thread's words lie below m
      const long long live = (long long)m - ((long long)cur_g * kGranule + kW * t);
      const int n_live = holds ? (int)max(0ll, min((long long)kW, live)) : 0;
#pragma unroll
      for (int v = 0; v < kW / 4; ++v) {
        const uint4 x = holds ? ((const uint4*)s_win[stage])[(kW / 4) * t + v] : zero4;
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cnt[4 * v + i] = 4 * v + i < n_live ? (int)expanded_size(w[i]) : 0;
          sum += cnt[4 * v + i];
        }
      }
      incl = warp_inclusive_scan(sum);
      if (lane == 31) s_warp_sum[warp] = incl;
    }
    __syncthreads();  // warp sums published; every warp is done with the block before

    // 2. find the next block's granule and start its window's copy into the
    //    stage the block before this one used
    int nxt_g = 0, nxt_off0 = 0;
    if (nxt_valid) {
      nxt_g = covering_granule(g_base, hint, probe, (int)(base + kBlockChunks), n_rows, &nxt_off0);
      hint = nxt_g;
      copy_window(stage ^ 1, nxt_g);
    }

    if (!cur_valid) {
      for (int v = t; v < kRowVecs; v += kDecodeThreads) out[(size_t)bo * kRowVecs + v] = zero4;
    } else {
      // 3. each word's first chunk relative to the block (the sums fit int32
      //    for a valid stream; they wrap harmlessly past a batch's end), its
      //    slot, and the output spans it reaches into from before
      const int before = sum_of_warps_before<kWinWarps>(s_warp_sum);
      int rel = (int)((uint32_t)cur_off0 - base + (uint32_t)(before + incl - sum));
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (cnt[i] > 0) {
          const int end = (int)((uint32_t)rel + (uint32_t)cnt[i]);
          if ((unsigned)rel < (unsigned)kBlockChunks) s_slot[rel] = kW * t + i;
          if (cnt[i] > 1 && end > 0 && rel < kBlockChunks) {
            // a fill: the spans whose first chunk lies inside it, past its start
            const int k_hi = min(kOutWarps - 1, (end - 1) >> kSpanShift);
            for (int k = rel < 0 ? 0 : (rel >> kSpanShift) + 1; k <= k_hi; ++k)
              s_cover[k] = kW * t + i;
          }
          rel = end;
        }
      }
      __syncthreads();  // slots and covers written

      if (warp < kOutWarps) {
        // 4. forward fill: chunk kW t + i takes the last word that starts at
        //    or before it
        int r[kW];
#pragma unroll
        for (int v = 0; v < kW / 4; ++v) {
          const uint4 x = ((const uint4*)s_slot)[(kW / 4) * t + v];
          r[4 * v] = (int)x.x, r[4 * v + 1] = (int)x.y, r[4 * v + 2] = (int)x.z, r[4 * v + 3] = (int)x.w;
        }
        if (lane == 0) {
          r[0] = max(r[0], s_cover[warp]);
          s_cover[warp] = 0;  // for the next block
        }
        thread_inclusive_max(r);
        const int left = warp_exclusive_max(r[kW - 1], 0);
        // 5. expand (fill -> 0 or 0x7FFFFFFF, literal -> payload), mask by
        //    n_chunks: the block's valid chunks are its first n_chunks -
        //    (base & pos_mask), of which this thread keeps n_keep of its kW
        const int n_keep = n_chunks - (int)(base & (uint32_t)pos_mask) - kW * t;
        uint32_t c[kW + 1];
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const uint32_t x = s_win[stage][max(left, r[i])];
          c[i] = (x & kBit31) ? ((x & kBit30) ? kOnes31 : 0u) : x;
          if (i >= n_keep) c[i] = 0u;
        }
        c[kW] = __shfl_down_sync(kFullMask, c[0], 1);
        // 6. fused 31 -> 32-bit merge (reference mergeWords,
        //    kernels.cu:369-385): kGroupThreads threads a group, ints kW q ..
        //    kW q + kW - 1 each (the last thread of a group has one fewer)
        const int q = lane % kGroupThreads, x0 = kW * q;
        uint32_t* o = s_slot + kSpan * warp + 31 * (lane / kGroupThreads) + x0;
        __syncwarp();  // every lane has read its slots
#pragma unroll
        for (int i = 0; i < kW; ++i)
          if (i < kW - 1 || q < kGroupThreads - 1)
            o[i] = (c[i] >> (x0 + i)) | (c[i + 1] << (31 - x0 - i));
        __syncwarp();
        // the warp's 31 kW ints leave as uint4, and its slots are zeroed for
        // the next block
        const uint4* mine = (const uint4*)s_slot + (kSpan / 4) * warp;
        for (int v = lane; v < 31 * kW / 4; v += 32)
          out[(size_t)bo * kRowVecs + (31 * kW / 4) * warp + v] = mine[v];
        __syncwarp();
        for (int v = lane; v < kSpan / 4; v += 32) ((uint4*)s_slot)[(kSpan / 4) * warp + v] = zero4;
      }
    }
    cur_valid = nxt_valid, cur_g = nxt_g, cur_off0 = nxt_off0;
  }
}

}  // namespace

extern "C" int wah_prescan_words(const void* words, const void* vc, void* words_t,
                                 void* g_sums, int rows_in, int out_rows, void* stream) {
  const int grid = (out_rows + kPrescanWarps - 1) / kPrescanWarps;
  prescan_kernel<<<grid, kPrescanWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const int32_t*)vc, (uint4*)words_t, (int32_t*)g_sums, rows_in,
      out_rows);
  return (int)cudaGetLastError();
}

// The grid is kDecodeWaves CTAs for each one the device holds at once, each
// walking the same number of consecutive output blocks.
extern "C" int wah_decode_blocks(const void* words_t, const void* g_base, const void* meta,
                                 void* out, int n_rows, int nbo, void* stream) {
  int resident = 0;
  const cudaError_t err = resident_ctas(decode_blocks_kernel, kDecodeThreads, &resident);
  if (err != cudaSuccess) return (int)err;
  const int ctas = resident * kDecodeWaves;
  const int per_cta = (nbo + ctas - 1) / ctas;
  const int grid = (nbo + per_cta - 1) / per_cta;
  decode_blocks_kernel<<<grid, kDecodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words_t, (const int32_t*)g_base, (const int32_t*)meta, (uint4*)out,
      n_rows, nbo, per_cta);
  return (int)cudaGetLastError();
}
