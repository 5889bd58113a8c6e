// K4: feature backward of the tile blend for frozen geometry. With
//   feat[p, c] = sum_e W[p, e] * F[e, c],   W = alpha * T (included pairs),
// the weights W do not depend on the per-entry features F, so
//   dF[e, c] = sum_p W[p, e] * g[p, c]
// for the cotangent g [256, C] of the tile's feature map.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_train.py::
// _feature_bwd_kernel (pallas_call at :241 in feature_grads_pallas). The
// Pallas kernel rebuilds W per 256-entry chunk from an exclusive cumprod in
// log space and contracts it with one MXU matmul per chunk. Here one block of
// 256 threads takes one tile, one thread per pixel, and replays the port's K2
// (csrc/blend.cu) op for op: same -fmad=false build, same gather of the
// per-Gaussian state by g_sorted, same alpha and termination tests, same
// running-product transmittance. W is then the forward's weight bit for bit
// (the staging batch size only moves the block's early exit, after which
// every W is 0). Against the JAX package the weights are allclose, not equal:
// the Pallas kernel carries T as exp(sum log1p(-alpha)).
//
// Per staged batch of kBatch entries, each pixel writes its W row into shared
// memory ([256][kWStride]); the block then forms the [kBatch, C] product
// W^T g (the tile's cotangent [256, C] staged once in shared memory where it
// fits beside W, C <= 180) and writes the batch's rows of dF coalesced. Rows of entries after the block's
// early exit are written as zeros, and so is the tail of dF past the last
// tile's range (entries that no tile blends), so every row is defined.
//
// Bound on this card: bytes (the [E, C] f32 dF write, the [T, 256, C]
// cotangent read) against the f32 work of 2*C operations per included pair
// plus the replay. The product runs on CUDA cores from shared memory, each
// thread keeping kRows accumulators and reading W as float4 broadcasts;
// wgmma tiles and an overlap of staging with the product are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads per block = pixels per tile
constexpr int kBatch = 32;              // entries staged per batch
constexpr int kWStride = kBatch + 4;    // W row stride: float4-aligned, 4-way
constexpr int kRows = 8;                // dF rows a thread accumulates
constexpr int kGeom = 9;                // x y ca cb cc op r g b
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

__global__ void __launch_bounds__(kPix)
    feature_bwd_kernel(const int* __restrict__ g_sorted,
                       const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count,
                       const float* __restrict__ geom,
                       const float* __restrict__ cot, int num_tiles,
                       int grid_x, int channels, int stage_cot,
                       long long num_entries, float* __restrict__ dfeat) {
  extern __shared__ float smem[];
  float* s_cot = smem;                          // [kPix][channels] if staged
  float* s_w = s_cot + (stage_cot ? kPix * channels : 0);  // [kPix][kWStride]
  float* s_geom = s_w + kPix * kWStride;        // [6][kBatch]

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  // The tail past the last tile's range belongs to no tile: zero it,
  // spread over all blocks.
  {
    const long long end =
        (long long)tile_start[num_tiles - 1] + tile_count[num_tiles - 1];
    const long long total = num_entries * channels;
    for (long long i = end * channels + (long long)tile * kPix + pix;
         i < total; i += (long long)num_tiles * kPix)
      dfeat[i] = 0.0f;
  }
  if (count <= 0) return;

  // The tile's cotangent, staged once where it fits beside W (C <= 180),
  // else read through L1 from device memory (reads are coalesced either way).
  const float* src = cot + (size_t)tile * kPix * channels;
  if (stage_cot)
    for (int i = pix; i < kPix * channels; i += kPix) s_cot[i] = src[i];
  const float* g_tile = stage_cot ? s_cot : src;

  const float px = (float)((tile % grid_x) * kBlock + pix % kBlock);
  const float py = (float)((tile / grid_x) * kBlock + pix / kBlock);
  float T = 1.0f;
  bool done = false;
  const int groups = kBatch / kRows;
  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    const int nb = min(kBatch, count - b0);
    __syncthreads();  // the previous batch's W and state are consumed
    if (pix < nb) {
      const float* row = geom + (size_t)g_sorted[start + b0 + pix] * kGeom;
      for (int f = 0; f < 6; ++f) s_geom[f * kBatch + pix] = row[f];
    }
    __syncthreads();
    // Replay: K2's per-pixel loop, recording W instead of accumulating.
    float* w_row = s_w + pix * kWStride;
    for (int j = 0; j < kBatch; ++j) {
      float w = 0.0f;
      if (j < nb && !done) {
        const float dx = px - s_geom[0 * kBatch + j];
        const float dy = py - s_geom[1 * kBatch + j];
        const float ca = s_geom[2 * kBatch + j];
        const float cb = s_geom[3 * kBatch + j];
        const float cc = s_geom[4 * kBatch + j];
        const float power =
            -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float alpha =
              fminf(kAlphaMax, s_geom[5 * kBatch + j] * expf(power));
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
      w_row[j] = w;
    }
    __syncthreads();
    // dF[b0 + e, c] = sum_p W[p, e] * g[p, c] for the batch's rows.
    for (int task = pix; task < groups * channels; task += kPix) {
      const int grp = task / channels;
      const int c = task - grp * channels;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int p = 0; p < kPix; ++p) {
        const float gv = g_tile[p * channels + c];
        const float4 wa = *reinterpret_cast<const float4*>(
            s_w + p * kWStride + grp * kRows);
        const float4 wb = *reinterpret_cast<const float4*>(
            s_w + p * kWStride + grp * kRows + 4);
        acc[0] = __fmaf_rn(wa.x, gv, acc[0]);
        acc[1] = __fmaf_rn(wa.y, gv, acc[1]);
        acc[2] = __fmaf_rn(wa.z, gv, acc[2]);
        acc[3] = __fmaf_rn(wa.w, gv, acc[3]);
        acc[4] = __fmaf_rn(wb.x, gv, acc[4]);
        acc[5] = __fmaf_rn(wb.y, gv, acc[5]);
        acc[6] = __fmaf_rn(wb.z, gv, acc[6]);
        acc[7] = __fmaf_rn(wb.w, gv, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int e = grp * kRows + r;
        if (e < nb)
          dfeat[(size_t)(start + b0 + e) * channels + c] = acc[r];
      }
    }
    if (__syncthreads_count(done) == kPix) {
      b0 += kBatch;
      break;
    }
  }
  // Rows after the early exit carry W = 0.
  for (long long i = (long long)(start + b0) * channels + pix;
       i < (long long)(start + count) * channels; i += kPix)
    dfeat[i] = 0.0f;
}

}  // namespace

extern "C" int lsv2_feature_bwd(const int* g_sorted, const int* tile_start,
                                const int* tile_count, const float* geom,
                                const float* cot, int num_tiles, int grid_x,
                                int channels, long long num_entries,
                                float* dfeat, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  const size_t base = sizeof(float) * ((size_t)kPix * kWStride +
                                       6 * (size_t)kBatch);
  const size_t cot_bytes = sizeof(float) * (size_t)kPix * channels;
  const int stage_cot = base + cot_bytes <= kMaxSmem;
  const size_t smem = base + (stage_cot ? cot_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      feature_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    feature_bwd_kernel<<<num_tiles, kPix, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        g_sorted, tile_start, tile_count, geom, cot, num_tiles, grid_x,
        channels, stage_cot, num_entries, dfeat);
  }
  return static_cast<int>(cudaGetLastError());
}
