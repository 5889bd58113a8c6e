// K5: feature backward of the budget-capped blend, projected onto each
// entry's own top-k channels. Tile t's entries sit in the window of slots
// [t * cap, t * cap + kept[t]) (the capped layout of ops/budget.py); with W
// the forward's blend weights and g the cotangent of the tile's [256, C]
// feature map, for each slot e < kept[t] and j < topk
//
//   dproj[e, j] = sum_p W[p, e] * g[p, idx_j(e)],
//
// idx_j(e) the j-th codebook index of the slot's Gaussian. Slots at or past
// kept[t], and slots after the block's early exit, are 0, so one index_add_
// by the window's Gaussian ids gives d(quick_weights).
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_train.py::
// _feature_bwd_topk_kernel (pallas_call at :449 in feature_grads_topk_pallas).
// The Pallas kernel forms the dense [K, cap] product W^T g on the MXU per
// tile and masks it down to the top-k rows. Here the projection comes
// first, and the kernel replays the port's K2 (csrc/blend.cu) op for op,
// as K4 does (same -fmad=false build, same gather of the per-Gaussian
// state, same alpha and termination tests, same running-product
// transmittance, same early exit), so W is K2's bit for bit.
//
// Bound on this card: bytes, the [T, 256, C] f32 cotangent read once (134 MB
// at 2040 tiles, C = 64: 0.04 ms at 3.35 TB/s), against 14 f32 operations an
// evaluated pair and 2 * topk + 3 an included one. The first version (one
// thread a pixel) reduced each entry's topk sums over the warp one entry at
// a time: 5 shuffles a value, 20 an entry and warp at topk = 4, 640 a batch.
//
// Design: a block of 128 threads takes a tile, a lane two pixels of one
// column (rows 4w, 4w + 1 and 4w + 2, 4w + 3 for warp w), a batch of 32
// entries at a time:
//  - the tile's cotangent is staged once in shared memory (row stride
//    C + 1: the 32 pixels of a warp read one column without bank
//    conflicts; column C is a zero pad) by 4-byte cp.async with the row
//    and column stepped, not divided; the copies overlap the first batch's
//    replay;
//  - each lane replays its two pixels one after the other (the 32 alpha
//    tests first, branch-free, then the walk in depth order carrying T),
//    keeping the 2 x 32 weights in registers (K4's replay; both pixels'
//    alpha tests fused into one loop took 190 registers, 3% slower);
//  - for each j < topk and each half of the batch the lane forms
//    v[e] = W[a, e] g[a, idx_j(e)] + W[b, e] g[b, idx_j(e)] for 16
//    entries, and the warp reduces them with one transposed butterfly
//    (reduce-scatter: 8 + 4 + 2 + 1 shuffles, then one across the
//    half-warps), after which lane e holds entry e's sum over the warp's
//    64 pixels: 32 shuffles a j and batch, 128 at topk = 4, for twice the
//    pixels the first version reduced with 640; a warp that includes no
//    pair of the batch skips its products;
//  - the indices are checked against C once an entry and batch (an index
//    out of range reads the pad column), so a product is two loads and a
//    multiply;
//  - the 4 warp partials meet in a double-buffered shared array, and after
//    one block barrier a batch thread t sums rows t / topk and
//    (t + 128) / topk (the live warps in warp order) and stores them: the
//    batch's rows are one coalesced run;
//  - warp 0 gathers the next batch's state and indices with cp.async into
//    a second buffer while this batch is replayed.
// Every loop runs to a warp-uniform bound (a `break` out of a lane's walk
// dropped the reconvergence point in K2). The dense product on the tensor
// cores (K4's design, csrc/feature_bwd.cu) is not used: it would do
// C / topk = 16 times the work at C = 64, topk = 4. Any C whose stage fits
// in shared memory (C <= 217 at topk = 4, 212 at topk = 8) and any topk
// in 1..8.
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "phase_marks.cuh"

// Phases (profile_train_bwd.py): 0 staging wait, 1 replay, 2 products and
// reductions, 3 cross-warp sum and writes.
PHASE_STORAGE(g_feature_bwd_topk_phase, lsv2_feature_bwd_topk_phases)

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // pixels a tile
constexpr int kThreads = kPix / 2;      // two pixels a lane
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;              // entries a batch
constexpr int kHalf = kBatch / 2;       // entries a reduction
constexpr int kMaxTopk = 8;
constexpr int kGeom = 9;                // x y ca cb cc op r g b
constexpr int kGeomW = 8;               // x y ca cb cc op, 2 pad
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// Offsets (in floats) of the dynamic shared arrays for C channels and
// topk: the cotangent [kPix][C + 1] (column C is a zero pad), the state
// [2][kBatch][kGeomW], the indices [2][topk][kBatch] (int), the warp
// partials [2][kWarps][kBatch][topk | 1] (an odd row stride: lane e's
// store is conflict-free) and the warps' live flags [2][kWarps] (int).
struct Layout {
  int geom, idx, part, live, size;
  __host__ __device__ Layout(int channels, int topk) {
    geom = (kPix * (channels + 1) + 3) & ~3;
    idx = geom + 2 * kBatch * kGeomW;
    part = idx + 2 * topk * kBatch;
    live = part + 2 * kWarps * kBatch * (topk | 1);
    size = live + 2 * kWarps;
  }
};

// Entry `id`'s six blend fields into dst_geom and its topk codebook
// indices into dst_idx[j * kBatch], 4 bytes a copy.
__device__ __forceinline__ void gather(const float* __restrict__ geom,
                                       const int* __restrict__ qi, int id,
                                       int topk, float* dst_geom,
                                       int* dst_idx) {
  const float* row = geom + (size_t)id * kGeom;
#pragma unroll
  for (int f = 0; f < 6; ++f) cp_async4(dst_geom + f, row + f);
  const int* q = qi + (size_t)id * topk;
  for (int j = 0; j < topk; ++j) cp_async4(dst_idx + j * kBatch, q + j);
}

// The (unsigned)c < channels guard, once an entry and batch: an index out
// of range reads the zero pad column C of the staged cotangent.
__device__ __forceinline__ void clamp_indices(int* idx, int topk,
                                              int channels) {
  for (int j = 0; j < topk; ++j) {
    const int c = idx[j * kBatch];
    idx[j * kBatch] = (unsigned)c < (unsigned)channels ? c : channels;
  }
}

// One pixel's walk: position, transmittance, whether it ended.
struct Walk {
  float px, py, T;
  bool done;
};

// K2's per-pixel walk over one batch (nb entries of sg) with the weights
// W = alpha * T of the included pairs (0 elsewhere) left in w. The alpha
// tests of the batch come first, branch-free, so that they overlap; then
// the walk in depth order carries T and done (the same ops as K2 for an
// included pair, so W is K2's). Returns the included entries as a bit mask.
__device__ __forceinline__ unsigned replay(const float (*sg)[kGeomW], int nb,
                                           Walk& p, float (&w)[kBatch]) {
  unsigned acts = 0u;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const float4 g = *reinterpret_cast<const float4*>(sg[j]);
    const float2 h = *reinterpret_cast<const float2*>(sg[j] + 4);
    const float dx = p.px - g.x;
    const float dy = p.py - g.y;
    const float power =
        -0.5f * (g.z * dx * dx + h.x * dy * dy) - g.w * dx * dy;
    w[j] = fminf(kAlphaMax, h.y * expf(power));
    if (j < nb && power <= 0.0f && w[j] >= kAlphaMin) acts |= 1u << j;
  }
  unsigned incs = 0u;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool act = ((acts >> j) & 1u) && !p.done;
    const float test_t = p.T * (1.0f - w[j]);
    const bool ends = act && test_t < kTEps;
    const bool inc = act && !ends;
    p.done = p.done || ends;
    w[j] = inc ? w[j] * p.T : 0.0f;
    p.T = inc ? test_t : p.T;
    incs |= (unsigned)inc << j;
  }
  return incs;
}

// One reduce-scatter step: the lanes with `upper` keep the upper half of
// v[0, 2 kN), the others the lower; each adds its partner's copy of the
// half it keeps, into v[0, kN).
template <int kN>
__device__ __forceinline__ void scatter_step(float* v, bool upper) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float send = upper ? v[i] : v[i + kN];
    const float keep = upper ? v[i + kN] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kN);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    feature_bwd_topk_kernel(const int* __restrict__ g_win,
                            const int* __restrict__ kept,
                            const float* __restrict__ geom,
                            const int* __restrict__ qi,
                            const float* __restrict__ cot, int grid_x,
                            int cap, int channels, int topk,
                            float* __restrict__ dproj) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(channels, topk);
  const int stride = channels + 1;
  const int ps = topk | 1;
  float* s_cot = smem;
  auto s_geom = reinterpret_cast<float(*)[kBatch][kGeomW]>(smem + lay.geom);
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  float* s_part = smem + lay.part;
  int* s_live = reinterpret_cast<int*>(smem + lay.live);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = min(kept[tile], cap);
  const size_t base = (size_t)tile * cap;           // the tile's window
  // This thread's elements of a batch's [kBatch, topk] rows: tid and
  // tid + kThreads.
  const int te0 = tid / topk, tj0 = tid - te0 * topk;
  const int te1 = (tid + kThreads) / topk, tj1 = tid + kThreads - te1 * topk;
  PHASE_BEGIN

  int b0 = 0;
  if (count > 0) {
    // The pad column reads 0, and so does every index not gathered yet.
    s_cot[tid * stride + channels] = 0.0f;
    s_cot[(tid + kThreads) * stride + channels] = 0.0f;
    for (int i = tid; i < 2 * topk * kBatch; i += kThreads)
      s_idx[i] = channels;
    __syncthreads();
    // Batch 0's state (warp 0, lane e: entry e), then the cotangent.
    int id_next = 0;
    if (warp == 0) {
      if (lane < count)
        gather(geom, qi, g_win[base + lane], topk, s_geom[0][lane],
               s_idx + lane);
      id_next = kBatch + lane < count ? g_win[base + kBatch + lane] : 0;
    }
    cp_async_commit();
    {
      const float* src = cot + (size_t)tile * kPix * channels;
      const int dp = kThreads / channels, dc = kThreads - dp * channels;
      int p = tid / channels, c = tid - p * channels;
      for (int i = tid; i < kPix * channels; i += kThreads) {
        cp_async4(s_cot + p * stride + c, src + i);
        c += dc;
        p += dp;
        if (c >= channels) {
          c -= channels;
          ++p;
        }
      }
    }
    cp_async_commit();
    cp_async_wait<1>();   // batch 0's state
    if (warp == 0 && lane < count)
      clamp_indices(s_idx + lane, topk, channels);
    __syncthreads();
    PHASE_MARK(0)

    // Pixels p and p + 32 (two rows apart, one column) of the tile.
    const int p = 64 * warp + lane;
    Walk pa{(float)((tile % grid_x) * kBlock + p % kBlock),
            (float)((tile / grid_x) * kBlock + p / kBlock), 1.0f, false};
    Walk pb{pa.px, pa.py + 2.0f, 1.0f, false};
    const float* ga = s_cot + p * stride;
    const float* gb = ga + 32 * stride;
    for (int it = 0;; ++it, b0 += kBatch) {
      const int buf = it & 1;
      const int nb = min(kBatch, count - b0);
      PHASE_COUNT()
      // Batch it + 1's state into the buffer batch it - 1 was replayed
      // from (its readers passed the last barrier).
      if (warp == 0) {
        const int nxt = b0 + kBatch;
        if (nxt + lane < count)
          gather(geom, qi, id_next, topk, s_geom[buf ^ 1][lane],
                 s_idx + (buf ^ 1) * topk * kBatch + lane);
        id_next = nxt + kBatch + lane < count
                      ? g_win[base + nxt + kBatch + lane] : 0;
      }
      cp_async_commit();
      float wa[kBatch], wb[kBatch];
      // The entries some pixel of the warp includes.
      const unsigned wmask =
          __any_sync(kFull, !(pa.done && pb.done))
              ? __reduce_or_sync(kFull, replay(s_geom[buf], nb, pa, wa) |
                                            replay(s_geom[buf], nb, pb, wb))
              : 0u;
      PHASE_MARK(1)
      if (it == 0) {   // the cotangent (all but the newest group) landed
        cp_async_wait<1>();
        __syncthreads();
      }
      PHASE_MARK(0)
      float* part = s_part + ((buf * kWarps + warp) * kBatch + lane) * ps;
      if (wmask) {
        const int* sidx = s_idx + buf * topk * kBatch;
#pragma unroll 1
        for (int j = 0; j < topk; ++j) {
          float sum[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // entries 16 h .. 16 h + 15
            float v[kHalf];
#pragma unroll
            for (int q = 0; q < kHalf / 4; ++q) {
              const int4 c4 = *reinterpret_cast<const int4*>(
                  sidx + j * kBatch + kHalf * h + 4 * q);
              const int c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int e = kHalf * h + 4 * q + r;
                v[4 * q + r] = wa[e] * ga[c[r]] + wb[e] * gb[c[r]];
              }
            }
            scatter_step<8>(v, lane & 8);
            scatter_step<4>(v, lane & 4);
            scatter_step<2>(v, lane & 2);
            scatter_step<1>(v, lane & 1);
            // Lane l holds entry 16 h + l % 16 over its half-warp.
            sum[h] = v[0] + __shfl_xor_sync(kFull, v[0], 16);
          }
          part[j] = lane < 16 ? sum[0] : sum[1];   // entry `lane`
        }
      }
      if (lane == 0) s_live[buf * kWarps + warp] = wmask != 0u;
      PHASE_MARK(2)
      cp_async_wait<0>();   // batch it + 1's state
      if (warp == 0 && b0 + kBatch + lane < count)
        clamp_indices(s_idx + (buf ^ 1) * topk * kBatch + lane, topk,
                      channels);
      // All partials and the next state written; the other buffers' last
      // readers are done.
      const bool all_done =
          __syncthreads_count(pa.done && pb.done) == kThreads;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = tid + h * kThreads;
        const int e = h ? te1 : te0, j = h ? tj1 : tj0;
        if (i < nb * topk) {
          float sum = 0.0f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp)
            if (s_live[buf * kWarps + wp])
              sum += s_part[((buf * kWarps + wp) * kBatch + e) * ps + j];
          dproj[(base + b0) * topk + i] = sum;
        }
      }
      PHASE_MARK(3)
      if (all_done || b0 + kBatch >= count) {
        b0 += kBatch;
        break;
      }
    }
    b0 = min(b0, count);
  }
  // Slots after the early exit, past kept[t], or of an empty tile: 0.
  for (size_t i = (base + b0) * topk + tid; i < (base + cap) * topk;
       i += kThreads)
    dproj[i] = 0.0f;
  PHASE_MARK(3)
  PHASE_END(g_feature_bwd_topk_phase)
}

}  // namespace

extern "C" int lsv2_feature_bwd_topk(const int* g_win, const int* kept,
                                     const float* geom, const int* qi,
                                     const float* cot, int num_tiles,
                                     int grid_x, int cap, int channels,
                                     int topk, float* dproj, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (topk < 1 || topk > kMaxTopk || cap < 1 || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)Layout(channels, topk).size;
  cudaError_t err = cudaFuncSetAttribute(
      feature_bwd_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    feature_bwd_topk_kernel<<<num_tiles, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        g_win, kept, geom, qi, cot, grid_x, cap, channels, topk, dproj);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5's occupancy at C channels and topk: blocks an SM, dynamic shared
// bytes, registers a thread, local bytes a thread, threads a block.
extern "C" int lsv2_feature_bwd_topk_occupancy(int channels, int topk,
                                               int* out) {
  cudaGetLastError();
  if (topk < 1 || topk > kMaxTopk || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)Layout(channels, topk).size;
  cudaError_t err = cudaFuncSetAttribute(
      feature_bwd_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, feature_bwd_topk_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, feature_bwd_topk_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
