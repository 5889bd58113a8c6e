// K1: tile-entry expansion with the exact conic-vs-tile cull.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_binning.py::_expand_kernel
// (+ _expand_one_chunk; pallas_call at :498, wrapper expand_entries_pallas).
// Gaussian g owns the slots [ends[g] - tiles[g], ends[g]) (ends: the
// inclusive scan of tiles_touched, computed outside by torch.cumsum); its
// slot k names the tile of its rect in row-major order. The exact cull
// (cull.cuh) keeps or kills the entry; a killed entry, and every slot at or
// past total = min(ends[n - 1], max_entries), is the dead entry (sentinel
// tile, depth 0, gauss 0). The kernel writes all max_entries slots and
// total, so the wrapper allocates its outputs uninitialised.
//
// with_alpha (the `subdiv` branch of _expand_one_chunk, :327-348): a
// compile-time SUBDIV in {1, 2, 4, 8, 16} adds, for each kept entry,
// SUBDIV^2 values lm = log1p(-min(min(op, 1) exp(-q_min / 2), 0.99)) with
// q_min the conic's minimum over one sub-box of the tile, written
// sub-box-major ([SUBDIV^2, max_entries], one contiguous row a sub-box, as
// JAX returns them); culled and dead slots get 0.
//
// Bound on this card: bytes. 12 B read per Gaussian (tile count, scan),
// 44 B more per Gaussian that touches a tile, 12 B written per slot (+4 B a
// sub-box with with_alpha); the cull is ~60 f32 operations an entry and a
// sub-box bound ~45 more, far below the card's f32 rate.
//
// Design: slots, not Gaussians, go to threads. The first version gave each
// thread one Gaussian and looped over its rect, so a warp took as long as
// its largest rect, its 32 lanes stored to 32 unrelated addresses at each
// step, and the wrapper pre-filled every output first. Here a block of 256
// threads takes kSlots consecutive slots:
//  1. two warps find the owners of the block's first and last live slot by
//     a 32-ary search of the scan (the owner of slot e is the first g with
//     ends[g] > e, which skips runs of zero-tile Gaussians: they share
//     their predecessor's end);
//  2. the owners between them are staged in shared memory, kStage a pass:
//     their rect, depth and cull state (the logf of the threshold once a
//     Gaussian, not once a slot; the same bits as computing it per slot);
//  3. each staged owner marks its first slot in a per-slot map of the
//     block, and a block-wide running maximum fills in the rest, so every
//     slot reads its owner with one load (a binary search a slot cost
//     more than the cull);
//  4. thread t takes slots t, t + 256, ...: the cull decides, and the warp
//     stores 32 consecutive slots of each output at once (coalesced); with
//     SUBDIV the slot's SUBDIV^2 sub-box bounds follow, one lm row after
//     another, each row again 32 consecutive slots. Every thread has the
//     same 8 slots, so no lane carries a large rect alone (spreading the
//     (sub-box, slot) pairs over the block instead, with a second pass
//     through shared memory, was 8% slower at s = 2).
// A Gaussian over the whole grid spreads over many blocks; slots past
// total, of this block or of blocks wholly past it, are written dead.
//
// Numerics: compiled with -fmad=false, so every f32 op rounds on its own, in
// the order of the plain PyTorch version (ops/expand.py) and of the Pallas
// kernel: the entry sets agree exactly; lm goes through expf and log1pf,
// within 2 f32 ulps of torch's.
#include <cuda_runtime.h>

#include "cull.cuh"
#include "phase_marks.cuh"

// Phases (profile_expand.py): 0 dead slots, 1 owner search, 2 staging, 3
// entries (with their sub-box bounds).
PHASE_STORAGE(g_expand_phase, lsv2_expand_phases)

namespace {

using lsv2::kTileSide;
using lsv2::TileCull;

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                // slots a thread
constexpr int kSlots = kThreads * kPerThread;  // slots a block
constexpr int kStage = 512;                  // owners staged a pass
constexpr unsigned kFull = 0xffffffffu;

// The staged owners of one pass (struct of arrays, index j = g - pass start).
struct Owners {
  int first[kStage];   // ends[g] - tiles[g] - s0: the rect's first slot
  int x0[kStage], y0[kStage], rw[kStage];
  float depth[kStage], op[kStage];
  float cx[kStage], cy[kStage], ca[kStage], cb[kStage], cc[kStage],
      thresh[kStage];
};

// The first g in [0, n) with ends[g] > e (ends non-decreasing, ends[n - 1]
// > e), by one warp: each step probes 32 evenly spaced ends and keeps the
// interval of the first hit.
__device__ int find_owner(const long long* __restrict__ ends, int n,
                          long long e, int lane) {
  long long lo = 0, hi = n;
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = min(lo + (lane + 1) * step, hi) - 1;
    const unsigned hit = __ballot_sync(kFull, ends[p] > e);
    const int k = __ffs((int)hit) - 1;  // lane 31 probes hi - 1, always a hit
    hi = min(lo + (k + 1) * step, hi);
    lo += k * step;
  }
  return (int)lo;
}

// a[0, kSlots) := its inclusive running maximum, by the block (thread t
// scans a[8 t, 8 t + 8), then the warps' and the block's prefixes).
__device__ __forceinline__ void max_scan(int* a, int* s_warp, int tid) {
  static_assert(kPerThread == 8, "two int4 a thread");
  const int lane = tid & 31, warp = tid >> 5;
  int4* a4 = reinterpret_cast<int4*>(a + kPerThread * tid);
  const int4 x = a4[0], y = a4[1];
  int v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 1; i < 8; ++i) v[i] = max(v[i], v[i - 1]);
  int t = v[7];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, t, off);
    if (lane >= off) t = max(t, u);
  }
  if (lane == 31) s_warp[warp] = t;
  int prefix = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) prefix = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) prefix = max(prefix, s_warp[w]);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = max(v[i], prefix);
  a4[0] = make_int4(v[0], v[1], v[2], v[3]);
  a4[1] = make_int4(v[4], v[5], v[6], v[7]);
  __syncthreads();
}

// lm of sub-box i of a kept entry's tile (JAX's operation order: the
// sub-box offset is added after the mean is subtracted).
template <int SUBDIV>
__device__ __forceinline__ float sub_box_lm(const TileCull& cull, float op_c,
                                            int tile_x, int tile_y, int i) {
  constexpr int side = kTileSide / SUBDIV;
  const int sy = i / SUBDIV, sx = i - sy * SUBDIV;
  const float lx = (float)tile_x * (float)kTileSide - cull.cx;
  const float ly = (float)tile_y * (float)kTileSide - cull.cy;
  const float blx = lx + (float)(sx * side);
  const float bly = ly + (float)(sy * side);
  const float qm = cull.k.box_qmin(blx, blx + (float)(side - 1), bly,
                                   bly + (float)(side - 1));
  const float am = fminf(op_c * expf(-0.5f * fmaxf(qm, 0.0f)), 0.99f);
  return log1pf(-am);
}

__device__ __forceinline__ TileCull staged_cull(const Owners& o, int j) {
  TileCull c;
  c.k.ca = o.ca[j];
  c.k.cb = o.cb[j];
  c.k.cc = o.cc[j];
  c.cx = o.cx[j];
  c.cy = o.cy[j];
  c.thresh = o.thresh[j];
  return c;
}

template <int SUBDIV>
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const float* __restrict__ xy,
                  const float* __restrict__ depth,
                  const float* __restrict__ conic,
                  const float* __restrict__ opacity,
                  const int* __restrict__ rect_min,
                  const int* __restrict__ rect_max,
                  const int* __restrict__ tiles,
                  const long long* __restrict__ ends, int n, int grid_x,
                  int max_entries, int sentinel, int exact_cull,
                  float inv_cull_alpha, int* __restrict__ tile_out,
                  float* __restrict__ depth_out, int* __restrict__ gauss_out,
                  float* __restrict__ lm_out, int* __restrict__ total_out) {
  constexpr int kBoxes = SUBDIV * SUBDIV;
  __shared__ Owners so;
  // Per slot of the block, the staged owner: each owner's index at its
  // first slot (-1 elsewhere), then their running maximum.
  __shared__ __align__(16) int owner[kSlots];
  __shared__ int s_range[2], s_warp[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PHASE_BEGIN

  const long long total =
      n > 0 ? min(ends[n - 1], (long long)max_entries) : 0LL;
  if (blockIdx.x == 0 && tid == 0) *total_out = (int)total;
  const long long s0 = (long long)blockIdx.x * kSlots;
  const int n_slots = (int)max(0LL, min((long long)kSlots, max_entries - s0));
  const int n_live = (int)max(0LL, min((long long)n_slots, total - s0));
  const size_t row = (size_t)max_entries;   // lm's row stride

  // Slots past total: the dead entry, lm 0.
  for (int r = n_live + tid; r < n_slots; r += kThreads) {
    const long long e = s0 + r;
    tile_out[e] = sentinel;
    depth_out[e] = 0.0f;
    gauss_out[e] = 0;
#pragma unroll 4
    for (int i = 0; i < kBoxes; ++i) lm_out[i * row + e] = 0.0f;
  }
  PHASE_MARK(0)
  if (n_live == 0) {
    PHASE_END(g_expand_phase)
    return;
  }

  for (int r = tid; r < kSlots; r += kThreads) owner[r] = -1;
  if (warp < 2) {
    const int g = find_owner(ends, n, s0 + (warp ? n_live - 1 : 0), lane);
    if (lane == 0) s_range[warp] = g;
  }
  __syncthreads();
  const int g_lo = s_range[0], g_hi = s_range[1];
  unsigned todo = 0u;   // this thread's slots whose owner is not found yet
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (tid + k * kThreads < n_live) todo |= 1u << k;
  PHASE_MARK(1)

  for (int gc = g_lo; gc <= g_hi; gc += kStage) {   // block-uniform
    PHASE_COUNT()
    const int m = min(kStage, g_hi - gc + 1);
    if (gc != g_lo) {
      __syncthreads();   // the last pass's readers are done
      for (int r = tid; r < kSlots; r += kThreads) owner[r] = -1;
      __syncthreads();
    }
    for (int j = tid; j < m; j += kThreads) {
      const int g = gc + j;
      const long long end = ends[g];
      const int cnt = tiles[g];
      so.first[j] = (int)(end - cnt - s0);
      if (cnt > 0) {   // a possible owner
        const int x0 = rect_min[2 * g];
        so.x0[j] = x0;
        so.y0[j] = rect_min[2 * g + 1];
        so.rw[j] = max(rect_max[2 * g] - x0, 1);
        so.depth[j] = depth[g];
        if (exact_cull) {
          const TileCull c = TileCull::of(xy, conic, opacity, g,
                                          inv_cull_alpha);
          so.cx[j] = c.cx;
          so.cy[j] = c.cy;
          so.ca[j] = c.k.ca;
          so.cb[j] = c.k.cb;
          so.cc[j] = c.k.cc;
          so.thresh[j] = c.thresh;
        }
        if (SUBDIV > 0) so.op[j] = fminf(opacity[g], 1.0f);
        owner[max(so.first[j], 0)] = j;
      }
    }
    __syncthreads();
    // The owner of slot r: the last staged owner whose rect starts at or
    // before r (zero-tile Gaussians own no slot and mark none).
    max_scan(owner, s_warp, tid);
    PHASE_MARK(2)

    // Slots below last_end whose owner is not found yet are owned here.
    const long long last_end = ends[gc + m - 1] - s0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = tid + k * kThreads;
      const bool here = ((todo >> k) & 1u) && r < last_end;
      if (here) {
        todo &= ~(1u << k);
        const int j = owner[r];
        const int slot = r - so.first[j];
        const int rw = so.rw[j];
        const int ty = slot / rw;
        const int tile_x = so.x0[j] + (slot - ty * rw);
        const int tile_y = so.y0[j] + ty;
        const bool owned =
            !exact_cull || staged_cull(so, j).keeps(tile_x, tile_y);
        const long long e = s0 + r;
        tile_out[e] = owned ? tile_y * grid_x + tile_x : sentinel;
        depth_out[e] = owned ? so.depth[j] : 0.0f;
        gauss_out[e] = owned ? gc + j : 0;
        if constexpr (SUBDIV > 0) {
          // The slot's row of each sub-box: lane-consecutive slots, so
          // each row is written coalesced.
          const TileCull c = staged_cull(so, j);
          const float op_c = so.op[j];
#pragma unroll 4
          for (int i = 0; i < kBoxes; ++i)
            lm_out[i * row + e] =
                owned ? sub_box_lm<SUBDIV>(c, op_c, tile_x, tile_y, i)
                      : 0.0f;
        }
      }
    }
    PHASE_MARK(3)
  }
  PHASE_END(g_expand_phase)
}

template <int SUBDIV>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&expand_kernel<SUBDIV>);
}

const void* kernel_for(int subdiv) {
  switch (subdiv) {
    case 0: return kernel_of<0>();
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 4: return kernel_of<4>();
    case 8: return kernel_of<8>();
    case 16: return kernel_of<16>();
    default: return nullptr;
  }
}

}  // namespace

// ends: the inclusive scan of tiles (int64); total_out: one int32.
extern "C" int lsv2_expand_entries(
    const float* xy, const float* depth, const float* conic,
    const float* opacity, const int* rect_min, const int* rect_max,
    const int* tiles, const long long* ends, int n, int grid_x,
    int max_entries, int sentinel, int exact_cull, float inv_cull_alpha,
    int* tile_out, float* depth_out, int* gauss_out, int subdiv,
    float* lm_out, int* total_out, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (kernel_for(subdiv) == nullptr || n < 0 || max_entries < 0 ||
      total_out == nullptr || (subdiv && !exact_cull) ||
      (subdiv && lm_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = max(1, (int)(((long long)max_entries + kSlots - 1) /
                                  kSlots));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LSV2_EXPAND(S)                                                    \
  expand_kernel<S><<<blocks, kThreads, 0, st>>>(                          \
      xy, depth, conic, opacity, rect_min, rect_max, tiles, ends, n,     \
      grid_x, max_entries, sentinel, exact_cull, inv_cull_alpha,          \
      tile_out, depth_out, gauss_out, lm_out, total_out)
  switch (subdiv) {
    case 0: LSV2_EXPAND(0); break;
    case 1: LSV2_EXPAND(1); break;
    case 2: LSV2_EXPAND(2); break;
    case 4: LSV2_EXPAND(4); break;
    case 8: LSV2_EXPAND(8); break;
    default: LSV2_EXPAND(16); break;
  }
#undef LSV2_EXPAND
  return static_cast<int>(cudaGetLastError());
}

// K1's occupancy for one SUBDIV: blocks an SM, static shared bytes,
// registers a thread, local bytes a thread, threads a block.
extern "C" int lsv2_expand_occupancy(int subdiv, int* out) {
  cudaGetLastError();
  const void* fn = kernel_for(subdiv);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
