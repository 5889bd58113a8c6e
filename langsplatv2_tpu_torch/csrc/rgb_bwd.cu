// K7: geometry (RGB) backward of the tile blend. For pixel p and entry i of
// the tile's depth-sorted segment, with c_i the entry's colour, g_p the
// cotangent of the pixel's (background-free) colour, T_i the transmittance
// before i and w_i = alpha_i T_i:
//
//   dL/dalpha_i = [incl] T_i (c_i . g_p) - [incl] (S_i . g_p) / (1 - alpha_i)
//               - [incl] gT_p T_final,p / (1 - alpha_i)
//   S_i . g_p   = sdot_p - sum_{j <= i, incl} w_j (c_j . g_p)
//
// with sdot_p = C_p . g_p (the forward's colour) and gT_p = dL/dT_final,
// which already carries the background path. Chained through
// alpha = min(0.99, op exp(power)) and the conic quadratic, each pixel gives
// the entry d(x, y, ca, cb, cc, op) and d(rgb) = w_i g_p; the rows [E, 9]
// are these summed over the tile's 256 pixels. Columns follow the
// per-Gaussian state rows (ops/blend.py::pack_gaussian_state), so one
// index_add_ by g_sorted reduces them to the Gaussians.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_rgb_train.py::
// _rgb_bwd_kernel (pallas_call at :290 in rgb_grads_pallas). The Pallas
// kernel builds [P, chunk] alpha matrices, scans T and the colour prefix in
// log depth across lanes, takes two MXU products per chunk and pads each row
// to 128 lanes; its per-pixel pack carries gT and T_final apart, with two pad
// columns, where this one carries their product. Here each pixel replays
// the port's K2 (csrc/blend.cu) op for op: same -fmad=false build, same
// gather of the per-Gaussian state by g_sorted, same alpha and termination
// tests, same running-product transmittance, carrying T and the running
// colour prefix. A pixel stops at its termination, as K2 does; the Pallas
// kernel goes on computing -suffix / (1 - alpha) for later valid entries,
// where the suffix is the rounding noise of sdot_p minus the full prefix.
//
// Bound on this card: neither bytes (the [T, 256, 5] cotangent pack read
// once, the [E, 9] rows written once) nor the ~60 f32 operations of an
// included pair, but the per-entry sums over the tile's pixels and the
// walk's latency. One thread a pixel, 8 warps, one entry at a time (the
// first version), each warp that includes an entry reduced its 9 values
// with a 5-step shuffle tree (45 shuffles and adds), and each entry's
// chain ended in that warp-wide step, so no two entries' walks overlapped:
// the chain 48% and the reductions 38% of a block's cycles.
//
// Design. A block of 4 warps takes one tile; a lane walks two pixels (rows
// 4w, 4w + 1 and 4w + 2, 4w + 3 for warp w), so the two walks overlap and
// the lane adds its two pixels' values before any shuffle: a warp reduces
// 64 pixels. Entries go in groups of kGroup = 4: (a) the group's alpha
// tests at both pixels, branch-free; (b) in depth order, for the entries
// some pixel of the warp still walking passes (a warp-uniform test), the
// transmittance step and the chain, the same ops as K2's walk for an
// included pair. A group's 36 values a lane are then reduced together by
// a transposed butterfly (reduce-scatter): 18 + 9 shuffles halve what a
// lane holds, after which it holds the 9 partial sums of entry lane / 8
// over 4 lanes, and three butterfly steps of 9 finish them over the warp:
// 54 shuffles for 4 entries of 64 pixels. A group that no pixel of the
// warp includes is skipped. One lane of each 8 writes each (entry, field)
// of the warp's partial; after one block barrier a batch of 64 entries the
// 4 partials are summed in warp order and the batch's rows written
// coalesced. The next batch's per-Gaussian state is gathered with cp.async
// into a second buffer while this batch is walked, and the partials are
// double-buffered, so a batch costs one barrier. Rows of entries after the
// block's early exit are written as zeros, so the caller's
// [sum(tile_count), 9] output is fully defined without a memset.
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "phase_marks.cuh"

// Phases (profile_train_bwd.py): 0 staging wait, 1 chain, 2 reductions, 3
// writes.
PHASE_STORAGE(g_rgb_bwd_phase, lsv2_rgb_bwd_phases)

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // pixels a tile
constexpr int kLanePix = 2;             // pixels a lane
constexpr int kThreads = kPix / kLanePix;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;              // entries staged per batch
constexpr int kGroup = 4;               // entries reduced together
constexpr int kGeom = 9;                // x y ca cb cc op r g b
constexpr int kGrad = 9;                // d of the same 9 fields
constexpr int kPack = 5;                // g_rgb(3) sdot gT*t_final
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// Entry `id`'s state into column j of the field-major buffer dst.
__device__ __forceinline__ void gather(const float* __restrict__ geom,
                                       int id, float (*dst)[kBatch], int j) {
  const float* row = geom + (size_t)id * kGeom;
#pragma unroll
  for (int f = 0; f < kGeom; ++f) cp_async4(&dst[f][j], row + f);
}

// One reduce-scatter step: the lanes with `upper` keep the upper half of
// v[0, 2 kHalf), the others the lower; each adds its partner's copy of the
// half it keeps, into v[0, kHalf).
template <int kHalf>
__device__ __forceinline__ void scatter_step(float* v, bool upper, int off) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// One pixel's walk state and cotangent pack.
struct Pixel {
  float px, py, gr, gg, gb, sdot, gtt;  // gtt = dL/dT_final * T_final
  float T, pref;
  bool done;
};

__global__ void __launch_bounds__(kThreads)
    rgb_bwd_kernel(const int* __restrict__ g_sorted,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   const float* __restrict__ geom,
                   const float* __restrict__ pack, int grid_x,
                   float* __restrict__ dgrad) {
  __shared__ __align__(16) float s_geom[2][kGeom][kBatch];
  __shared__ float s_part[2][kWarps][kBatch * kGrad];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  if (count <= 0) return;
  PHASE_BEGIN

  // Batch 0's state (thread j: entry j), the id of batch 1's.
  const bool gl = tid < kBatch;
  if (gl && tid < count) gather(geom, g_sorted[start + tid], s_geom[0], tid);
  cp_async_commit();
  int id_next = gl && kBatch + tid < count
                    ? g_sorted[start + kBatch + tid] : 0;

  // Lane l of warp w walks pixels 32 (kLanePix w + k) + l, k <
  // kLanePix: 2 kLanePix whole rows of the tile a warp.
  Pixel q[kLanePix];
#pragma unroll
  for (int k = 0; k < kLanePix; ++k) {
    const int p = 32 * (kLanePix * warp + k) + lane;
    q[k].px = (float)((tile % grid_x) * kBlock + p % kBlock);
    q[k].py = (float)((tile / grid_x) * kBlock + p / kBlock);
    const float* pk = pack + ((size_t)tile * kPix + p) * kPack;
    q[k].gr = pk[0];
    q[k].gg = pk[1];
    q[k].gb = pk[2];
    q[k].sdot = pk[3];
    q[k].gtt = pk[4];
    q[k].T = 1.0f;
    q[k].pref = 0.0f;
    q[k].done = false;
  }
  cp_async_wait<0>();
  __syncthreads();
  PHASE_MARK(0)

  int b0 = 0;
  for (int it = 0; b0 < count; b0 += kBatch, ++it) {
    const int buf = it & 1;
    const int nb = min(kBatch, count - b0);
    PHASE_COUNT()
    // The next batch's state, into the buffer the last batch read.
    if (gl && b0 + kBatch + tid < count)
      gather(geom, id_next, s_geom[buf ^ 1], tid);
    cp_async_commit();
    id_next = gl && b0 + 2 * kBatch + tid < count
                  ? g_sorted[start + b0 + 2 * kBatch + tid] : 0;
    const float(*sg)[kBatch] = s_geom[buf];
    float* part = s_part[buf][warp];
    for (int j0 = 0; j0 < nb; j0 += kGroup) {
      // v[9 jj + f]: field f of entry j0 + jj, summed over the lane's
      // pixels.
      float v[kGroup * kGrad];
#pragma unroll
      for (int i = 0; i < kGroup * kGrad; ++i) v[i] = 0.0f;
      bool hit = false;
      bool walking = false;
#pragma unroll
      for (int k = 0; k < kLanePix; ++k) walking = walking || !q[k].done;
      if (__any_sync(kFull, walking)) {
        // (a) Each entry's alpha test, branch-free (the group's entries
        // and the lane's pixels overlap): bit jj of acts[k] if entry
        // j0 + jj passes it at pixel k.
        float ex[kLanePix][kGroup];
        unsigned acts[kLanePix];
#pragma unroll
        for (int k = 0; k < kLanePix; ++k) acts[k] = 0u;
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int j = j0 + jj;
#pragma unroll
          for (int k = 0; k < kLanePix; ++k) {
            const float dx = q[k].px - sg[0][j];
            const float dy = q[k].py - sg[1][j];
            const float power =
                -0.5f * (sg[2][j] * dx * dx + sg[4][j] * dy * dy) -
                sg[3][j] * dx * dy;
            ex[k][jj] = expf(power);
            const float alpha = fminf(kAlphaMax, sg[5][j] * ex[k][jj]);
            if (j < nb && power <= 0.0f && alpha >= kAlphaMin)
              acts[k] |= 1u << jj;
          }
        }
        // (b) The walk and the chain, in depth order, for the entries
        // that some pixel of the warp that has not ended passes: the same
        // ops as K2's walk for an included pair.
        unsigned mine = 0u;
#pragma unroll
        for (int k = 0; k < kLanePix; ++k) mine |= q[k].done ? 0u : acts[k];
        const unsigned any = __reduce_or_sync(kFull, mine);
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          if (any & (1u << jj)) {
            const int j = j0 + jj;
            float* vj = v + jj * kGrad;
#pragma unroll
            for (int k = 0; k < kLanePix; ++k) {
              Pixel& c = q[k];
              const float dx = c.px - sg[0][j];
              const float dy = c.py - sg[1][j];
              const float ca = sg[2][j];
              const float cb = sg[3][j];
              const float cc = sg[4][j];
              const float expp = ex[k][jj];
              const float raw = sg[5][j] * expp;
              const float alpha = fminf(kAlphaMax, raw);
              const bool act = ((acts[k] >> jj) & 1u) && !c.done;
              const float test_t = c.T * (1.0f - alpha);
              const bool ends = act && test_t < kTEps;
              const bool inc = act && !ends;
              c.done = c.done || ends;
              const float cg =
                  sg[6][j] * c.gr + sg[7][j] * c.gg + sg[8][j] * c.gb;
              const float w = alpha * c.T;
              const float pref_n = c.pref + w * cg;
              const float inv_om = 1.0f / (1.0f - alpha);
              const float d_alpha =
                  c.T * cg - (c.sdot - pref_n) * inv_om - c.gtt * inv_om;
              const float d_pow = d_alpha * raw;
              const bool chain = inc && raw < kAlphaMax;
              vj[0] += chain ? d_pow * (ca * dx + cb * dy) : 0.0f;
              vj[1] += chain ? d_pow * (cb * dx + cc * dy) : 0.0f;
              vj[2] += chain ? d_pow * (-0.5f * dx * dx) : 0.0f;
              vj[3] += chain ? d_pow * (-dx * dy) : 0.0f;
              vj[4] += chain ? d_pow * (-0.5f * dy * dy) : 0.0f;
              vj[5] += chain ? d_alpha * expp : 0.0f;
              vj[6] += inc ? w * c.gr : 0.0f;
              vj[7] += inc ? w * c.gg : 0.0f;
              vj[8] += inc ? w * c.gb : 0.0f;
              c.pref = inc ? pref_n : c.pref;
              c.T = inc ? test_t : c.T;
              hit = hit || inc;
            }
          }
        }
      }
      PHASE_MARK(1)
      if (__any_sync(kFull, hit)) {
        // 36 -> 18 -> 9 values a lane: entry j0 + lane / 8's fields,
        // summed over the 4 lanes that share lane % 8; then over 8 lanes.
        scatter_step<18>(v, lane & 16, 16);
        scatter_step<9>(v, lane & 8, 8);
#pragma unroll
        for (int f = 0; f < kGrad; ++f) {
          v[f] += __shfl_xor_sync(kFull, v[f], 4);
          v[f] += __shfl_xor_sync(kFull, v[f], 2);
          v[f] += __shfl_xor_sync(kFull, v[f], 1);
        }
        float* row = part + (j0 + (lane >> 3)) * kGrad;
#pragma unroll
        for (int f = 0; f < kGrad; ++f)
          if (f == (lane & 7) || f == (lane & 7) + 8) row[f] = v[f];
      } else {
        for (int i = lane; i < kGroup * kGrad; i += 32)
          part[j0 * kGrad + i] = 0.0f;
      }
      PHASE_MARK(2)
    }
    cp_async_wait<0>();
    // The partials are complete and the next batch's state has landed.
    bool ended = true;
#pragma unroll
    for (int k = 0; k < kLanePix; ++k) ended = ended && q[k].done;
    const bool all_done = __syncthreads_count(ended) == kThreads;
    PHASE_MARK(0)
    // The batch's rows: the warp partials of each (entry, field), in warp
    // order, written coalesced.
    float* dst = dgrad + (size_t)(start + b0) * kGrad;
    for (int i = tid; i < nb * kGrad; i += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_part[buf][w][i];
      dst[i] = s;
    }
    PHASE_MARK(3)
    if (all_done) {
      b0 += kBatch;
      break;
    }
  }
  // Rows after the early exit: every pixel has ended, so they are 0.
  for (long long i = (long long)(start + b0) * kGrad + tid;
       i < (long long)(start + count) * kGrad; i += kThreads)
    dgrad[i] = 0.0f;
  PHASE_MARK(3)
  PHASE_END(g_rgb_bwd_phase)
}

}  // namespace

extern "C" int lsv2_rgb_bwd(const int* g_sorted, const int* tile_start,
                            const int* tile_count, const float* geom,
                            const float* pack, int num_tiles, int grid_x,
                            float* dgrad, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (num_tiles > 0) {
    rgb_bwd_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        g_sorted, tile_start, tile_count, geom, pack, grid_x, dgrad);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7's occupancy: blocks an SM, static shared bytes, registers a thread,
// local bytes a thread, threads a block.
extern "C" int lsv2_rgb_bwd_occupancy(int* out) {
  cudaGetLastError();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rgb_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                      rgb_bwd_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
