// The exact conic-vs-tile cull, shared by K1 (expand.cu) and K8
// (cascade.cu) so that both take bit-identical decisions: keep an entry iff
// the Gaussian's alpha can reach the cull threshold somewhere in the tile's
// pixel box. Op for op in the order of the Pallas kernels
// (pallas_binning.py:292-322, pallas_cascade.py::_tile_cull_pass) and of
// ops/expand.py::_cull_mask; both sources are compiled with -fmad=false.
#pragma once

#include <cuda_runtime.h>

namespace lsv2 {

constexpr int kTileSide = 16;  // tile side in pixels

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

// One Gaussian's cull state: its centre, clamped conic and threshold.
struct TileCull {
  Conic k;
  float cx, cy, thresh;

  __device__ static TileCull of(const float* __restrict__ xy,
                                const float* __restrict__ conic,
                                const float* __restrict__ opacity, int g,
                                float inv_cull_alpha) {
    TileCull c;
    c.cx = xy[2 * g];
    c.cy = xy[2 * g + 1];
    c.k.ca = fmaxf(conic[3 * g], 1e-12f);
    c.k.cb = conic[3 * g + 1];
    c.k.cc = fmaxf(conic[3 * g + 2], 1e-12f);
    c.thresh =
        2.0f * logf(fmaxf(opacity[g], 1e-12f) * inv_cull_alpha) + 1e-4f;
    return c;
  }

  __device__ bool keeps(int tile_x, int tile_y) const {
    const float lx = (float)tile_x * (float)kTileSide - cx;
    const float ly = (float)tile_y * (float)kTileSide - cy;
    return k.box_qmin(lx, lx + (float)(kTileSide - 1), ly,
                      ly + (float)(kTileSide - 1)) <= thresh;
  }
};

}  // namespace lsv2
