// K1: WAH block encoder (encode_tiles).
//
// Replaces the TPU kernel wah_tpu/ops/pallas/encode_kernel.py::encode_tiles
// (body _encode_body). Same contract: (nb, 992) uint32 ints + nv = [bound,
// chunk_base, pos_mask] -> staging (nb, 1024) with each block's words as a
// dense prefix and zeros after it, counts (nb, 1).
//
// Design: one CTA of 1024 threads per block, one chunk per thread. Warp w
// is the 31-int group w, so a chunk's two source ints are the lane's own
// int and its left neighbour's (one shuffle). Run starts are numbered by a
// block scan (ballot + popc inside a warp, the 32 warp sums in shared
// memory); each start records its position in shared memory, so a fill's
// length is the next start (or the block's valid end) minus its own. Every
// word is written straight to its slot. The TPU kernel's log-shift
// compaction and static pass counts have no counterpart: a GPU scatters.
//
// Bound: memory. Per block it reads 3,968 B of ints and writes 4,096 B of
// staging plus a 4 B count; everything else stays in registers and shared
// memory (about 3 KB per CTA).
#include "common.cuh"

namespace {

using namespace wah;

__global__ void __launch_bounds__(kBlockChunks)
encode_tiles_kernel(const uint32_t* __restrict__ ints, const int32_t* __restrict__ nv,
                    uint32_t* __restrict__ staging, int32_t* __restrict__ counts) {
  __shared__ int8_t s_type[kBlockChunks];
  __shared__ int16_t s_start_pos[kBlockChunks];
  __shared__ int s_warp_starts[32];
  __shared__ int s_warp_valid[32];
  __shared__ int s_count, s_valid_end;

  const int b = blockIdx.x;
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
  const int gpos = (int)((uint32_t)nv[1] + (uint32_t)b * kBlockChunks + (uint32_t)c);
  const bool valid = (gpos & nv[2]) < nv[0];

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
  const int count = s_count;
  if (start) s_start_pos[slot] = (int16_t)c;
  __syncthreads();

  uint32_t* row = staging + (size_t)b * kBlockChunks;
  if (start) {
    uint32_t word = chunk;
    if (type != 2) {
      const int next = slot + 1 < count ? s_start_pos[slot + 1] : s_valid_end;
      word = (type == 1 ? kBit3130 : kBit31) | (uint32_t)(next - c);
    }
    row[slot] = word;
  }
  if (c >= count) row[c] = 0u;
  if (c == 0) counts[b] = count;
}

}  // namespace

extern "C" int wah_encode_tiles(const void* ints, const void* nv, void* staging,
                                void* counts, int nb, void* stream) {
  encode_tiles_kernel<<<nb, kBlockChunks, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ints, (const int32_t*)nv, (uint32_t*)staging, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* wah_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
