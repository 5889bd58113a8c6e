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
// columns, where this one carries their product. Here one block of 256 threads takes one tile, one thread per
// pixel, and replays the port's K2 (csrc/blend.cu) op for op: same
// -fmad=false build, same gather of the per-Gaussian state by g_sorted into
// shared memory, same alpha and termination tests, same running-product
// transmittance. Each thread carries T and the running colour prefix. A pixel
// stops at its termination, as K2 does; the Pallas kernel goes on computing
// -suffix / (1 - alpha) for later valid entries, where the suffix is the
// rounding noise of sdot_p minus the full prefix.
//
// Per staged batch of kBatch entries, each entry's 9 values are reduced over
// the block: warp shuffles (skipped when no lane of the warp includes the
// entry), then the 8 warp partials through shared memory, and the batch's
// rows are written coalesced. Rows of entries after the block's early exit
// are written as zeros, so the caller's [sum(tile_count), 9] output is fully
// defined without a memset.
//
// Bound on this card: neither bytes (the [T, 256, 5] cotangent pack read once,
// the [E, 9] rows written once) nor the ~60 f32 operations of an included
// pair, but the per-entry block reductions: 45 shuffles per warp and entry
// touched, plus a shared-memory pass. Skipping untouched warps is all this
// first version does about it; reducing several entries per shuffle step
// (a transposed butterfly) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per block = pixels per tile
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;              // entries staged per batch
constexpr int kGeom = 9;                // x y ca cb cc op r g b
constexpr int kGrad = 9;                // d of the same 9 fields
constexpr int kPack = 5;                // g_rgb(3) sdot gT*t_final
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
    rgb_bwd_kernel(const int* __restrict__ g_sorted,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   const float* __restrict__ geom,
                   const float* __restrict__ pack, int grid_x,
                   float* __restrict__ dgrad) {
  __shared__ float s_geom[kGeom][kBatch];
  __shared__ float s_part[kWarps][kBatch * kGrad];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31;
  const int warp = pix >> 5;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  if (count <= 0) return;

  const float px = (float)((tile % grid_x) * kBlock + pix % kBlock);
  const float py = (float)((tile / grid_x) * kBlock + pix / kBlock);
  const float* pk = pack + ((size_t)tile * kPix + pix) * kPack;
  const float gr = pk[0], gg = pk[1], gb = pk[2];
  const float sdot = pk[3];
  const float gtt = pk[4];              // dL/dT_final * T_final
  float T = 1.0f, pref = 0.0f;
  bool done = false;

  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    const int nb = min(kBatch, count - b0);
    __syncthreads();  // the previous batch's state and partials are consumed
    if (pix < nb) {
      const float* row = geom + (size_t)g_sorted[start + b0 + pix] * kGeom;
      for (int f = 0; f < kGeom; ++f) s_geom[f][pix] = row[f];
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      float v[kGrad];
#pragma unroll
      for (int f = 0; f < kGrad; ++f) v[f] = 0.0f;
      bool hit = false;
      if (!done) {
        const float dx = px - s_geom[0][j];
        const float dy = py - s_geom[1][j];
        const float ca = s_geom[2][j];
        const float cb = s_geom[3][j];
        const float cc = s_geom[4][j];
        const float power =
            -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float expp = expf(power);
          const float raw = s_geom[5][j] * expp;
          const float alpha = fminf(kAlphaMax, raw);
          if (alpha >= kAlphaMin) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < kTEps) {
              done = true;
            } else {
              hit = true;
              const float cg =
                  s_geom[6][j] * gr + s_geom[7][j] * gg + s_geom[8][j] * gb;
              const float w = alpha * T;
              pref += w * cg;
              const float inv_om = 1.0f / (1.0f - alpha);
              const float d_alpha =
                  T * cg - (sdot - pref) * inv_om - gtt * inv_om;
              if (raw < kAlphaMax) {
                const float d_pow = d_alpha * raw;
                v[0] = d_pow * (ca * dx + cb * dy);
                v[1] = d_pow * (cb * dx + cc * dy);
                v[2] = d_pow * (-0.5f * dx * dx);
                v[3] = d_pow * (-dx * dy);
                v[4] = d_pow * (-0.5f * dy * dy);
                v[5] = d_alpha * expp;
              }
              v[6] = w * gr;
              v[7] = w * gg;
              v[8] = w * gb;
              T = test_t;
            }
          }
        }
      }
      float* part = &s_part[warp][j * kGrad];
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int f = 0; f < kGrad; ++f) {
          float x = v[f];
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, off);
          if (lane == 0) part[f] = x;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kGrad; ++f) part[f] = 0.0f;
      }
    }
    __syncthreads();
    // The batch's rows: the 8 warp partials of each (entry, field), written
    // coalesced.
    float* dst = dgrad + (size_t)(start + b0) * kGrad;
    for (int i = pix; i < nb * kGrad; i += kPix) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_part[w][i];
      dst[i] = s;
    }
    if (__syncthreads_count(done) == kPix) {
      b0 += kBatch;
      break;
    }
  }
  // Rows after the early exit: every pixel has ended, so they are 0.
  for (long long i = (long long)(start + b0) * kGrad + pix;
       i < (long long)(start + count) * kGrad; i += kPix)
    dgrad[i] = 0.0f;
}

}  // namespace

extern "C" int lsv2_rgb_bwd(const int* g_sorted, const int* tile_start,
                            const int* tile_count, const float* geom,
                            const float* pack, int num_tiles, int grid_x,
                            float* dgrad, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (num_tiles > 0) {
    rgb_bwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        g_sorted, tile_start, tile_count, geom, pack, grid_x, dgrad);
  }
  return static_cast<int>(cudaGetLastError());
}
