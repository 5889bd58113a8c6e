// K1: per-Gaussian tile-entry expansion with the exact conic-vs-tile cull.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_binning.py::_expand_kernel
// (+ _expand_one_chunk; pallas_call at :498, wrapper expand_entries_pallas).
// That kernel recovers each entry's Gaussian with a one-hot ownership matmul
// over DMA'd field-major row windows, because a TPU core cannot gather. Hopper
// gathers natively, so the design is direct: one thread per Gaussian reads its
// own state once and writes its rect's entries (tile, depth, gauss) at its
// exclusive-scan offset (computed outside by torch.cumsum), in row-major rect
// order. Entries at or past max_entries are not written; the wrapper fills the
// outputs with the dead entry (sentinel tile, depth 0, gauss 0) first.
//
// with_alpha (the `subdiv` branch of _expand_one_chunk, :327-348): a
// compile-time SUBDIV in {1, 2, 4, 8, 16} adds, for each entry the thread
// keeps, SUBDIV^2 values lm = log1p(-min(min(op, 1) exp(-q_min / 2), 0.99))
// with q_min the conic's minimum over one sub-box of the tile, written
// sub-box-major ([SUBDIV^2, max_entries], one contiguous array a sub-box, as
// JAX returns them); a culled entry gets 0 (the wrapper zero-fills, so
// entries at or past the total stay 0).
//
// Bound on this card: bytes. 12 B read per Gaussian (tile count, offset), 44 B
// more per Gaussian that touches a tile, 12 B written per entry slot (+4 B
// a sub-box with with_alpha); the cull is ~60 f32 operations an entry and a
// sub-box bound ~45 more, far below the card's f32 rate. The design reads
// each Gaussian's state once (no per-entry search) and writes each entry
// once. Load balance follows rect size (one thread loops over its rect); a
// warp per Gaussian for large rects is later work.
//
// Numerics: compiled with -fmad=false, so every f32 op rounds on its own, in
// the order of the plain PyTorch version (ops/expand.py) and of the Pallas
// kernel: the entry sets agree exactly; lm goes through expf and log1pf,
// within 2 f32 ulps of torch's.
#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

using lsv2::kTileSide;
using lsv2::TileCull;

// lm of the sub-boxes of one kept entry's tile; lx, ly are the tile box's
// corner relative to the mean (JAX's operation order: the sub-box offset is
// added after the mean is subtracted).
template <int SUBDIV>
__device__ void write_sub_box_lm(const TileCull& cull, float op_c, float lx,
                                 float ly, long long e, int max_entries,
                                 float* __restrict__ lm_out) {
  constexpr int side = kTileSide / SUBDIV;
#pragma unroll 4
  for (int i = 0; i < SUBDIV * SUBDIV; ++i) {
    const int sy = i / SUBDIV, sx = i - sy * SUBDIV;
    const float blx = lx + (float)(sx * side);
    const float bly = ly + (float)(sy * side);
    const float qm = cull.k.box_qmin(blx, blx + (float)(side - 1), bly,
                                     bly + (float)(side - 1));
    const float am = fminf(op_c * expf(-0.5f * fmaxf(qm, 0.0f)), 0.99f);
    lm_out[(long long)i * max_entries + e] = log1pf(-am);
  }
}

template <int SUBDIV>
__global__ void expand_kernel(const float* __restrict__ xy,
                              const float* __restrict__ depth,
                              const float* __restrict__ conic,
                              const float* __restrict__ opacity,
                              const int* __restrict__ rect_min,
                              const int* __restrict__ rect_max,
                              const int* __restrict__ tiles,
                              const long long* __restrict__ offsets, int n,
                              int grid_x, int max_entries, int sentinel,
                              int exact_cull, float inv_cull_alpha,
                              int* __restrict__ tile_out,
                              float* __restrict__ depth_out,
                              int* __restrict__ gauss_out,
                              float* __restrict__ lm_out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int count = tiles[g];
  const long long base = offsets[g];
  if (count <= 0 || base >= max_entries) return;
  const int x0 = rect_min[2 * g], y0 = rect_min[2 * g + 1];
  const int rect_w = max(rect_max[2 * g] - x0, 1);
  const float d = depth[g];
  TileCull cull{};
  if (exact_cull)
    cull = TileCull::of(xy, conic, opacity, g, inv_cull_alpha);
  const float op_c = SUBDIV ? fminf(opacity[g], 1.0f) : 0.0f;
  const long long end = base + count;
  const long long stop = end < max_entries ? end : (long long)max_entries;
  for (long long e = base; e < stop; ++e) {
    const int slot = (int)(e - base);
    const int ty = slot / rect_w;
    const int tx = slot - ty * rect_w;
    const int tile_x = x0 + tx, tile_y = y0 + ty;
    const bool owned = !exact_cull || cull.keeps(tile_x, tile_y);
    tile_out[e] = owned ? tile_y * grid_x + tile_x : sentinel;
    depth_out[e] = owned ? d : 0.0f;
    gauss_out[e] = owned ? g : 0;
    if constexpr (SUBDIV > 0) {
      if (owned)
        write_sub_box_lm<SUBDIV>(
            cull, op_c, (float)tile_x * (float)kTileSide - cull.cx,
            (float)tile_y * (float)kTileSide - cull.cy, e, max_entries,
            lm_out);
    }
  }
}

template <int SUBDIV>
void launch_expand(int blocks, int threads, cudaStream_t stream,
                   const float* xy, const float* depth, const float* conic,
                   const float* opacity, const int* rect_min,
                   const int* rect_max, const int* tiles,
                   const long long* offsets, int n, int grid_x,
                   int max_entries, int sentinel, int exact_cull,
                   float inv_cull_alpha, int* tile_out, float* depth_out,
                   int* gauss_out, float* lm_out) {
  expand_kernel<SUBDIV><<<blocks, threads, 0, stream>>>(
      xy, depth, conic, opacity, rect_min, rect_max, tiles, offsets, n,
      grid_x, max_entries, sentinel, exact_cull, inv_cull_alpha, tile_out,
      depth_out, gauss_out, lm_out);
}

}  // namespace

extern "C" int lsv2_expand_entries(
    const float* xy, const float* depth, const float* conic,
    const float* opacity, const int* rect_min, const int* rect_max,
    const int* tiles, const long long* offsets, int n, int grid_x,
    int max_entries, int sentinel, int exact_cull, float inv_cull_alpha,
    int* tile_out, float* depth_out, int* gauss_out, int subdiv,
    float* lm_out, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if ((subdiv && !exact_cull) || (subdiv && lm_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int threads = 256, blocks = (n + threads - 1) / threads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LSV2_EXPAND(S)                                                      \
  launch_expand<S>(blocks, threads, st, xy, depth, conic, opacity, rect_min, \
                   rect_max, tiles, offsets, n, grid_x, max_entries,        \
                   sentinel, exact_cull, inv_cull_alpha, tile_out,          \
                   depth_out, gauss_out, lm_out)
    switch (subdiv) {
      case 0: LSV2_EXPAND(0); break;
      case 1: LSV2_EXPAND(1); break;
      case 2: LSV2_EXPAND(2); break;
      case 4: LSV2_EXPAND(4); break;
      case 8: LSV2_EXPAND(8); break;
      case 16: LSV2_EXPAND(16); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LSV2_EXPAND
  }
  return static_cast<int>(cudaGetLastError());
}
