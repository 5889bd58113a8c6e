// K5: feature backward of the budget-capped blend, projected onto each
// entry's own top-k channels. Tile t's entries sit in the window of slots
// [t * cap, t * cap + kept[t]) (the capped layout of ops/budget.py); with W
// the forward's blend weights and g the cotangent of the tile's [256, C]
// feature map, for each slot e < kept[t] and j < topk
//
//   dproj[e, j] = sum_p W[p, e] * g[p, idx_j(e)],
//
// idx_j(e) the j-th codebook index of the slot's Gaussian. Slots at or past
// kept[t] are 0, so one index_add_ by the window's Gaussian ids gives
// d(quick_weights).
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_train.py::
// _feature_bwd_topk_kernel (pallas_call at :449 in feature_grads_topk_pallas).
// The Pallas kernel forms the dense [K, cap] product W^T g on the MXU per
// tile and masks it down to the top-k rows. Here the projection comes first:
// one block of 256 threads takes one tile, one thread per pixel, and replays
// the port's K2 (csrc/blend.cu) op for op, as K4 does (same -fmad=false
// build, same gather of the per-Gaussian state, same alpha and termination
// tests, same running-product transmittance, same early exit). Each included
// (entry, pixel) pair reads only its entry's topk cotangent values, from the
// tile's cotangent staged once in shared memory (row stride C + 1: the 32
// pixels of a warp read one column without bank conflicts), instead of all C.
// The sum over the 256 pixels is a block reduction, as in K7: warp shuffles,
// skipped when no lane of the warp includes the entry, then the 8 warp
// partials through shared memory; the batch's rows are written coalesced.
//
// Bound on this card: bytes, the [T, 256, C] f32 cotangent read once (134 MB
// at 2040 tiles, C = 64: 0.04 ms at 3.35 TB/s), against 14 f32 operations an
// evaluated pair and 2 * topk + 3 an included one. As written the per-entry
// reductions (5 * topk shuffles per touched warp and entry) cost more than
// either; reducing several entries per shuffle step is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per block = pixels per tile
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 32;              // entries staged per batch
constexpr int kMaxTopk = 8;
constexpr int kGeom = 9;                // x y ca cb cc op r g b
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
    feature_bwd_topk_kernel(const int* __restrict__ g_win,
                            const int* __restrict__ kept,
                            const float* __restrict__ geom,
                            const int* __restrict__ qi,
                            const float* __restrict__ cot, int grid_x,
                            int cap, int channels, int topk,
                            float* __restrict__ dproj) {
  extern __shared__ float smem[];
  const int stride = channels + 1;
  float* s_cot = smem;                              // [kPix][stride]
  float* s_geom = s_cot + kPix * stride;            // [6][kBatch]
  float* s_part = s_geom + 6 * kBatch;              // [kWarps][kBatch][topk]
  int* s_idx = reinterpret_cast<int*>(s_part + kWarps * kBatch * topk);

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int lane = pix & 31;
  const int warp = pix >> 5;
  const int count = min(kept[tile], cap);
  const size_t base = (size_t)tile * cap;           // the tile's window

  int b0 = 0;
  if (count > 0) {
    const float* src = cot + (size_t)tile * kPix * channels;
    for (int i = pix; i < kPix * channels; i += kPix) {
      const int q = i / channels;
      s_cot[q * stride + (i - q * channels)] = src[i];
    }
    const float px = (float)((tile % grid_x) * kBlock + pix % kBlock);
    const float py = (float)((tile / grid_x) * kBlock + pix / kBlock);
    const float* g_pix = s_cot + pix * stride;
    float T = 1.0f;
    bool done = false;
    for (; b0 < count; b0 += kBatch) {
      const int nb = min(kBatch, count - b0);
      __syncthreads();  // the previous batch's state and partials are read
      if (pix < nb) {
        const int gi = g_win[base + b0 + pix];
        const float* row = geom + (size_t)gi * kGeom;
        for (int f = 0; f < 6; ++f) s_geom[f * kBatch + pix] = row[f];
        for (int j = 0; j < topk; ++j)
          s_idx[j * kBatch + pix] = qi[(size_t)gi * topk + j];
      }
      __syncthreads();
      for (int e = 0; e < nb; ++e) {  // uniform over the block
        float w = 0.0f;
        if (!done) {
          const float dx = px - s_geom[0 * kBatch + e];
          const float dy = py - s_geom[1 * kBatch + e];
          const float ca = s_geom[2 * kBatch + e];
          const float cb = s_geom[3 * kBatch + e];
          const float cc = s_geom[4 * kBatch + e];
          const float power =
              -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
          if (power <= 0.0f) {
            const float alpha =
                fminf(kAlphaMax, s_geom[5 * kBatch + e] * expf(power));
            if (alpha >= kAlphaMin) {
              const float test_t = T * (1.0f - alpha);
              if (test_t < kTEps) {
                done = true;
              } else {
                w = alpha * T;
                T = test_t;
              }
            }
          }
        }
        float* part = s_part + (warp * kBatch + e) * topk;
        if (__any_sync(0xffffffffu, w != 0.0f)) {
#pragma unroll
          for (int j = 0; j < kMaxTopk; ++j) {
            if (j < topk) {
              const int c = s_idx[j * kBatch + e];
              float v = (w != 0.0f && (unsigned)c < (unsigned)channels)
                            ? w * g_pix[c]
                            : 0.0f;
              for (int off = 16; off > 0; off >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, off);
              if (lane == 0) part[j] = v;
            }
          }
        } else if (lane < topk) {
          part[lane] = 0.0f;
        }
      }
      __syncthreads();
      // The batch's rows: the sum of the 8 warp partials.
      for (int i = pix; i < nb * topk; i += kPix) {
        float s = 0.0f;
        for (int wp = 0; wp < kWarps; ++wp) s += s_part[wp * kBatch * topk + i];
        dproj[(base + b0) * topk + i] = s;
      }
      if (__syncthreads_count(done) == kPix) {
        b0 += kBatch;
        break;
      }
    }
    b0 = min(b0, count);
  }
  // Slots after the early exit, past kept[t], or of an empty tile: 0.
  for (size_t i = (base + b0) * topk + pix; i < (base + cap) * topk;
       i += kPix)
    dproj[i] = 0.0f;
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
  const size_t smem =
      sizeof(float) * ((size_t)kPix * (channels + 1) + 6 * (size_t)kBatch +
                       (size_t)kWarps * kBatch * topk +
                       (size_t)topk * kBatch);
  cudaError_t err = cudaFuncSetAttribute(
      feature_bwd_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    feature_bwd_topk_kernel<<<num_tiles, kPix, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        g_win, kept, geom, qi, cot, grid_x, cap, channels, topk, dproj);
  }
  return static_cast<int>(cudaGetLastError());
}
