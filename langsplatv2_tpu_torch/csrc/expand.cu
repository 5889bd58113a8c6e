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
// Bound on this card: bytes. 12 B read per Gaussian (tile count, offset), 44 B
// more per Gaussian that touches a tile, 12 B written per entry slot;
// the cull is ~60 f32 operations an entry, far below the card's f32 rate. The
// design reads each Gaussian's state once (no per-entry search) and writes
// each entry once. Load balance follows rect size (one thread loops over its
// rect); a warp per Gaussian for large rects is later work.
//
// Numerics: compiled with -fmad=false, so every f32 op rounds on its own, in
// the order of the plain PyTorch version (ops/expand.py) and of the Pallas
// kernel: the entry sets agree exactly.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;  // tile side in pixels

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // jnp.clip / torch.clamp order
}

struct Conic {
  float ca, cb, cc;
  __device__ float q(float u, float v) const {
    return ca * u * u + 2.0f * cb * u * v + cc * v * v;
  }
  __device__ float edge_u(float ufix, float ly, float hy) const {
    return q(ufix, clampf(-cb * ufix / cc, ly, hy));
  }
  __device__ float edge_v(float vfix, float lx, float hx) const {
    return q(clampf(-cb * vfix / ca, lx, hx), vfix);
  }
  // Min of q over the box [lx, hx] x [ly, hy] (mean-relative pixels).
  __device__ float box_qmin(float lx, float hx, float ly, float hy) const {
    const bool inside = lx <= 0.0f && 0.0f <= hx && ly <= 0.0f && 0.0f <= hy;
    const float m = fminf(fminf(edge_u(lx, ly, hy), edge_u(hx, ly, hy)),
                          fminf(edge_v(ly, lx, hx), edge_v(hy, lx, hx)));
    return inside ? 0.0f : m;
  }
};

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
                              int* __restrict__ gauss_out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int count = tiles[g];
  const long long base = offsets[g];
  if (count <= 0 || base >= max_entries) return;
  const int x0 = rect_min[2 * g], y0 = rect_min[2 * g + 1];
  const int rect_w = max(rect_max[2 * g] - x0, 1);
  const float d = depth[g];
  Conic k{};
  float cx = 0.f, cy = 0.f, thresh = 0.f;
  if (exact_cull) {
    cx = xy[2 * g];
    cy = xy[2 * g + 1];
    k.ca = fmaxf(conic[3 * g], 1e-12f);
    k.cb = conic[3 * g + 1];
    k.cc = fmaxf(conic[3 * g + 2], 1e-12f);
    thresh = 2.0f * logf(fmaxf(opacity[g], 1e-12f) * inv_cull_alpha) + 1e-4f;
  }
  const long long end = base + count;
  const long long stop = end < max_entries ? end : (long long)max_entries;
  for (long long e = base; e < stop; ++e) {
    const int slot = (int)(e - base);
    const int ty = slot / rect_w;
    const int tx = slot - ty * rect_w;
    const int tile_x = x0 + tx, tile_y = y0 + ty;
    bool owned = true;
    if (exact_cull) {
      const float lx = (float)tile_x * (float)kBlock - cx;
      const float ly = (float)tile_y * (float)kBlock - cy;
      const float qmin = k.box_qmin(lx, lx + (float)(kBlock - 1), ly,
                                    ly + (float)(kBlock - 1));
      owned = qmin <= thresh;
    }
    tile_out[e] = owned ? tile_y * grid_x + tile_x : sentinel;
    depth_out[e] = owned ? d : 0.0f;
    gauss_out[e] = owned ? g : 0;
  }
}

}  // namespace

extern "C" int lsv2_expand_entries(
    const float* xy, const float* depth, const float* conic,
    const float* opacity, const int* rect_min, const int* rect_max,
    const int* tiles, const long long* offsets, int n, int grid_x,
    int max_entries, int sentinel, int exact_cull, float inv_cull_alpha,
    int* tile_out, float* depth_out, int* gauss_out, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (n > 0) {
    const int threads = 256;
    expand_kernel<<<(n + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        xy, depth, conic, opacity, rect_min, rect_max, tiles, offsets, n,
        grid_x, max_entries, sentinel, exact_cull, inv_cull_alpha, tile_out,
        depth_out, gauss_out);
  }
  return static_cast<int>(cudaGetLastError());
}
