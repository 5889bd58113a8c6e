// K8: order-preserving partition of the depth-ordered Gaussians into
// per-tile segments, with the exact cull at the last level.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_cascade.py::
// _partition_kernel (pallas_call at :376 in _run_level, driven by
// cascade_binning :411). There, each level compacts 256-entry chunks per
// child with an MXU one-hot matmul and streams 32-float rows through VMEM
// rings flushed at 128-lane offsets, because a TPU core has no gather or
// scatter, and needs four levels (8-tile bands, supertile columns, tile
// rows, tiles) to keep the fan-out of one pass small. Hopper scatters
// natively, so a level here is: a count pass (one block a 256-item chunk of
// a bucket, the children's counts summed in shared memory), an exclusive
// scan of the [children, chunks] counts (torch, in ops/cascade.py, as JAX
// scans its counts in XLA), and a write pass that scatters each item's
// 4-byte Gaussian id to base + its rank among the chunk's items of that
// child, ranks taken with warp ballots in item order. Every pass keeps the
// input order, so each tile's segment comes out in depth order. Two levels
// suffice: the depth-ordered stream to tile rows (children y in the
// Gaussian's rect), then each row to its tiles (children x in the rect,
// kept only where the exact cull of csrc/cull.cuh keeps the (Gaussian,
// tile) pair, the same code and -fmad=false build as K1, so the decisions
// are K1's bit for bit). Row-major (y, x) buckets are the blend's tile
// order, so no permutation follows. Children whose segment would end past
// the budget are disabled (offset -1) and write nothing, as JAX's _bases
// disables buckets; the wrapper reports that as an overflow.
//
// Bound on this card: bytes (the ids read and written once a level, the
// per-Gaussian rect and cull state gathered once an item, the counts) and
// the cull's ~60 f32 operations a (Gaussian, tile) pair of the rect, taken
// once a pass (each item decides its first 64 tiles into a bit mask that
// both ballot sweeps of the write pass read). Each warp sweeps only the
// children between its items' smallest and largest rect bound; a sweep is
// one ballot a child.
#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

using lsv2::TileCull;

constexpr int kChunk = 256;            // items a block, one a thread
constexpr int kWarps = kChunk / 32;
constexpr int kMaxFan = 1024;          // children a bucket (tiles a side)

struct LevelArgs {
  const int* in_ids;       // [E_in] Gaussian ids, buckets contiguous
  const int* bucket_base;  // [B] first item of each bucket in in_ids
  const int* bucket_count; // [B] items of each bucket
  const int* chunk_first;  // [B + 1] first chunk of each bucket (scan)
  int buckets, fan;        // B, children a bucket
  const int* rect_min;     // [N, 2] tile rect, inclusive
  const int* rect_max;     // [N, 2] exclusive
  const int* tiles_touched;
  const float* xy;         // cull state (last level)
  const float* conic;
  const float* opacity;
  float inv_cull_alpha;
  int* counts;             // count pass: [fan, chunks]
  const int* offsets;      // write pass: [fan, chunks], -1 = disabled
  int* out;                // write pass: ids at their final positions
};

// One item's membership in the children of its bucket: the children
// [lo, hi) along the level's axis, and at the last level the cull, decided
// once for the first 64 children (`keep`, bit i for child lo + i) and on
// the fly beyond them.
template <bool kLast>
struct Item {
  int g = -1, lo = 0, hi = 0, row = 0;
  TileCull cull{};
  unsigned long long keep = 0;

  __device__ void decide() {
    const int n = min(hi - lo, 64);
    for (int i = 0; i < n; ++i)
      if (cull.keeps(lo + i, row)) keep |= 1ull << i;
  }

  __device__ bool member(int f) const {
    if (f < lo || f >= hi) return false;
    if (!kLast) return true;
    const int i = f - lo;
    return i < 64 ? (keep >> i) & 1ull : cull.keeps(f, row);
  }
};

// Locate this block's chunk: its bucket, and the item this thread holds.
template <bool kLast>
__device__ bool load_item(const LevelArgs& a, int chunk, Item<kLast>& it) {
  int lo = 0, hi = a.buckets;  // bucket b: chunk_first[b] <= chunk
  if (chunk >= a.chunk_first[a.buckets]) return false;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (a.chunk_first[mid] <= chunk) lo = mid; else hi = mid;
  }
  const int b = lo;
  const int pos = (chunk - a.chunk_first[b]) * kChunk + threadIdx.x;
  if (pos >= a.bucket_count[b]) return true;
  const int g = a.in_ids[a.bucket_base[b] + pos];
  it.g = g;
  if (kLast) {  // bucket b is tile row b; children are the rect's columns
    it.row = b;
    it.lo = a.rect_min[2 * g];
    it.hi = a.rect_max[2 * g];
    it.cull = TileCull::of(a.xy, a.conic, a.opacity, g, a.inv_cull_alpha);
    it.decide();
  } else if (a.tiles_touched[g] > 0) {  // children are the rect's rows
    it.lo = a.rect_min[2 * g + 1];
    it.hi = a.rect_max[2 * g + 1];
  }
  return true;
}

template <bool kLast>
__global__ void __launch_bounds__(kChunk) count_kernel(const LevelArgs a) {
  __shared__ int cnt[kMaxFan];
  for (int f = threadIdx.x; f < a.fan; f += kChunk) cnt[f] = 0;
  __syncthreads();
  Item<kLast> it;
  const bool present = load_item<kLast>(a, blockIdx.x, it);
  if (!present) return;  // a chunk past the last bucket: counts stay 0
  if (it.g >= 0)
    for (int f = max(it.lo, 0); f < min(it.hi, a.fan); ++f)
      if (it.member(f)) atomicAdd(&cnt[f], 1);
  __syncthreads();
  for (int f = threadIdx.x; f < a.fan; f += kChunk)
    a.counts[(size_t)f * gridDim.x + blockIdx.x] = cnt[f];
}

template <bool kLast>
__global__ void __launch_bounds__(kChunk) write_kernel(const LevelArgs a) {
  __shared__ int base[kWarps][kMaxFan];  // per warp: count, then its base
  for (int i = threadIdx.x; i < kWarps * a.fan; i += kChunk)
    base[i / a.fan][i % a.fan] = 0;
  __syncthreads();
  Item<kLast> it;
  const bool present = load_item<kLast>(a, blockIdx.x, it);
  if (!present) return;  // uniform over the block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  const bool live = it.g >= 0 && it.lo < it.hi;
  // The warp sweeps the children between its items' smallest and largest
  // bound, one ballot a child.
  const int f0 = max(__reduce_min_sync(0xffffffffu, live ? it.lo : a.fan),
                     0);
  const int f1 = min(__reduce_max_sync(0xffffffffu, live ? it.hi : 0),
                     a.fan);
  for (int f = f0; f < f1; ++f) {
    const unsigned m = __ballot_sync(0xffffffffu, live && it.member(f));
    if (lane == 0) base[warp][f] = __popc(m);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < a.fan; f += kChunk) {
    int run = a.offsets[(size_t)f * gridDim.x + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int c = base[w][f];
      base[w][f] = run;
      if (run >= 0) run += c;
    }
  }
  __syncthreads();
  for (int f = f0; f < f1; ++f) {
    const bool m_f = live && it.member(f);
    const unsigned m = __ballot_sync(0xffffffffu, m_f);
    const int b = base[warp][f];
    if (m_f && b >= 0) a.out[b + __popc(m & lt)] = it.g;
  }
}

template <bool kLast>
int launch_level(const LevelArgs& a, int chunks, int write, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (a.fan < 1 || a.fan > kMaxFan)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (write)
      write_kernel<kLast><<<chunks, kChunk, 0, s>>>(a);
    else
      count_kernel<kLast><<<chunks, kChunk, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pass of one level. level 0: the depth-ordered stream into tile rows
// (children y of the rect, Gaussians with tiles_touched > 0); level 1:
// each tile row (bucket y) into its tiles (children x of the rect that the
// exact cull keeps). write = 0: counts [fan, chunks]; write = 1: ids to out
// at offsets [fan, chunks] (-1: a disabled child), child-major so that the
// scan between the passes runs along rows. chunks: the launch's blocks, at
// least chunk_first[buckets]; blocks past it do nothing.
extern "C" int lsv2_cascade_level(
    const int* in_ids, const int* bucket_base, const int* bucket_count,
    const int* chunk_first, int buckets, int fan, int chunks, int level,
    int write, const int* rect_min, const int* rect_max,
    const int* tiles_touched, const float* xy, const float* conic,
    const float* opacity, float inv_cull_alpha, int* counts,
    const int* offsets, int* out, void* stream) {
  LevelArgs a{in_ids, bucket_base, bucket_count, chunk_first, buckets, fan,
              rect_min, rect_max, tiles_touched, xy, conic, opacity,
              inv_cull_alpha, counts, offsets, out};
  return level ? launch_level<true>(a, chunks, write, stream)
               : launch_level<false>(a, chunks, write, stream);
}
