// K2: front-to-back blend of each 16x16 tile's depth-sorted entry segment,
// RGB plus (quick mode) the top-k (weight, index) pairs expanded to channels.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_blend.py::_blend_kernel
// (pallas_call at :695 in _blend_call; wrapper blend_tiles_pallas) in its f32
// "rgb" and "quick" modes. The Pallas kernel builds [P, chunk] alpha matrices,
// scans the transmittance in log depth and accumulates with one MXU matmul per
// chunk, from 128-aligned field-major rows that an XLA gather packed before.
// None of that is needed here: one block of 256 threads takes one tile, one
// thread per pixel, and walks the segment in batches of kBatch entries. Each
// batch's per-Gaussian state (xy, conic, opacity, rgb, top-k weights and
// indices) is gathered straight from the per-Gaussian arrays by g_sorted into
// shared memory, so no packed entry rows are ever written. Each pixel then runs
// the sequential CUDA-rasterizer loop:
//   not power <= 0 (NaN too) or alpha < 1/255 -> skip (does not count);
//   T * (1 - alpha) < 1e-4      -> the pixel ends, this entry not included;
//   else acc += alpha * T * feature, T *= 1 - alpha.
// The block leaves once every pixel has ended (__syncthreads_count).
//
// Bound on this card: bytes (the [T, 256, 3 + C + 1] f32 output write and the
// gathered entry state) and, in quick mode, the f32 pair work (entries x 256
// pixels of alpha tests, top-k accumulates per included pair). The 192 channel
// accumulators per pixel live in shared memory ([C][257] f32, 197 KB at C=192,
// padded so that both the per-pixel updates and the coalesced write-out are
// free of bank conflicts); one block fits an SM, and the rest of the 227 KB
// holds a batch of 128 entries. Making it faster (more blocks per SM, register
// accumulators for a level's band) is later work.
//
// Numerics: compiled with -fmad=false; the plain PyTorch version (ops/blend.py)
// runs the same sequence of f32 ops, so the two agree to the last bit on the
// alpha and termination tests.
//
// fast16 mode (the serving rows of precision="bf16", replacing the Pallas
// kernel's rowfmt="fast16"): the per-Gaussian state comes from one 64-byte
// row (ops/blend.py::pack_fast16_rows: xy f32, conic, opacity and rgb as
// bf16, 12 u8 codebook indices, 12 bf16 weights), read as four 16-byte loads
// and widened to f32 in shared memory; the blend that follows is the f32
// mode's, op for op, on the rounded state. With out_bf16 (feat_bf16) the
// feature tiles are stored as bf16 (round to nearest even) and the colour as
// bf16(acc_rgb) + T * bg in f32, as the Pallas kernel stores its bf16
// accumulator and adds the background outside; the final T stays f32. The
// row halves the gathered bytes (64 B against 132 B an entry) and bf16 tiles
// halve the output write, the two byte terms of this kernel's bound.
//
// query mode (K2q, replacing the Pallas kernel with query=True: wrapper
// pallas_blend.py::blend_tiles_query, epilogue :483-501): the fast16 blend
// with f32 outputs, then per pixel, from the channel accumulators in shared
// memory, the Gram relevancy query of kernel K3:
//   raw[l*PQ + q] = sum_k bf16(wm[l,k]) phi[l,k,q]
//   nrm2[l]       = sum_k (sum_m bf16(wm[l,m]) gram[l,m,k]) wm[l,k]
// with phi and gram rounded to bf16 by the wrapper, as the TPU kernel's MXU
// pass rounds its operands; the last factor and the band sum use the f32
// accumulator, as there. The [T, 256, L*K] map is never written: the
// outputs are rgb, raw, nrm2 and T. The accumulators fill the shared memory,
// so each level's phi and then gram (16 KB) are staged, one after the
// other, in the entry-staging area that the finished blend leaves free
// (grown to 16 KB in this mode). Each thread keeps its pixel's 64 rounded
// weights of the level in registers and runs 8 independent sums at once,
// fed by 16-byte loads of gram that every thread of a warp reads at the
// same address (a broadcast): one block of 8 warps an SM is too few warps
// to hide the latency of a single dependent chain of loads. The epilogue
// adds 2 * L * K * (PQ + K + 1) flops a pixel on CUDA cores (~0.8 ms at
// 1080p at the H100's 67 TFLOP/s f32 rate); tensor-core products are later
// work. Products of bf16 values are exact in f32, so the kernel and its
// plain version differ only in the order of the sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;  // threads per block = pixels per tile
constexpr int kPad = kPix + 1;         // accumulator row stride
constexpr int kBatch = 128;            // entries staged per batch
constexpr int kGeom = 9;               // x y ca cb cc op r g b
constexpr int kFast16Pairs = 12;       // (index, weight) slots of a fast16 row
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kLevelK = 64;            // codebook rows a level (query mode)
constexpr int kMaxLevels = 3;
constexpr int kMaxPQ = 16;             // prompts a level (query mode)
constexpr int kChains = 8;             // independent sums of the epilogue

__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          unsigned long long n_eval,
                                          unsigned long long n_inc) {
  for (int off = 16; off > 0; off >>= 1) {
    n_eval += __shfl_down_sync(0xffffffffu, n_eval, off);
    n_inc += __shfl_down_sync(0xffffffffu, n_inc, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats, n_eval);
    atomicAdd(stats + 1, n_inc);
  }
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage Gaussian gi's state at batch slot `slot`: from the f32 arrays, or
// (kFast16) from its 64-byte row, widened to f32.
template <bool kFast16>
__device__ __forceinline__ void stage_entry(
    int gi, int slot, const float* __restrict__ geom,
    const float* __restrict__ qw, const int* __restrict__ qi,
    const uint4* __restrict__ rows, int topk, float* s_geom, float* s_w,
    int* s_idx) {
  if (kFast16) {
    const uint4* row = rows + (size_t)gi * 4;
    const uint4 a = row[0], b = row[1], c = row[2], d = row[3];
    const unsigned w[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                            c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
    s_geom[0 * kBatch + slot] = __uint_as_float(w[0]);
    s_geom[1 * kBatch + slot] = __uint_as_float(w[1]);
#pragma unroll
    for (int f = 0; f < 7; ++f)  // ca cb cc op r g b
      s_geom[(2 + f) * kBatch + slot] =
          (f & 1) ? bf16_hi(w[2 + f / 2]) : bf16_lo(w[2 + f / 2]);
#pragma unroll
    for (int k = 0; k < kFast16Pairs; ++k) {  // constant indices: registers
      if (k < topk) {
        s_idx[k * kBatch + slot] = (w[6 + k / 4] >> (8 * (k % 4))) & 0xFF;
        s_w[k * kBatch + slot] =
            (k & 1) ? bf16_hi(w[9 + k / 2]) : bf16_lo(w[9 + k / 2]);
      }
    }
  } else {
    const float* row = geom + (size_t)gi * kGeom;
    for (int f = 0; f < kGeom; ++f) s_geom[f * kBatch + slot] = row[f];
    for (int k = 0; k < topk; ++k) {
      s_w[k * kBatch + slot] = qw[(size_t)gi * topk + k];
      s_idx[k * kBatch + slot] = qi[(size_t)gi * topk + k];
    }
  }
}

// Query mode's epilogue for pixel `pix` of the tile: raw [levels * pq] and
// nrm2 [levels] from the channel accumulators (see the header). `stage` is
// the free staging area, at least kLevelK * kLevelK floats, 16-byte
// aligned; every thread of the block calls this.
__device__ __forceinline__ void query_epilogue(
    const float* acc, float* stage, int pix, int levels, int pq,
    const float* __restrict__ phi, const float* __restrict__ gram,
    float* __restrict__ raw, float* __restrict__ nrm2) {
  for (int l = 0; l < levels; ++l) {
    const float* a = acc + l * kLevelK * kPad + pix;
    float w[kLevelK];
#pragma unroll
    for (int m = 0; m < kLevelK; ++m) w[m] = round_bf16(a[m * kPad]);

    __syncthreads();  // the staging area is free
    for (int i = pix; i < kLevelK * pq; i += kPix)
      stage[i] = phi[l * kLevelK * pq + i];
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < pq; ++q) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < kLevelK; ++m)  // exact products: fma == mul + add
        s = __fmaf_rn(w[m], stage[m * pq + q], s);
      raw[l * pq + q] = s;
    }

    __syncthreads();
    for (int i = pix; i < kLevelK * kLevelK; i += kPix)
      stage[i] = gram[l * kLevelK * kLevelK + i];
    __syncthreads();
    float n2 = 0.0f;
    for (int k0 = 0; k0 < kLevelK; k0 += kChains) {
      float s[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) s[c] = 0.0f;
#pragma unroll
      for (int m = 0; m < kLevelK; ++m) {
        const float4* g =
            reinterpret_cast<const float4*>(stage + m * kLevelK + k0);
#pragma unroll
        for (int v = 0; v < kChains / 4; ++v) {
          const float4 gv = g[v];
          s[4 * v + 0] = __fmaf_rn(w[m], gv.x, s[4 * v + 0]);
          s[4 * v + 1] = __fmaf_rn(w[m], gv.y, s[4 * v + 1]);
          s[4 * v + 2] = __fmaf_rn(w[m], gv.z, s[4 * v + 2]);
          s[4 * v + 3] = __fmaf_rn(w[m], gv.w, s[4 * v + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < kChains; ++c) n2 += s[c] * a[(k0 + c) * kPad];
    }
    nrm2[l] = n2;
  }
}

template <bool kFast16, bool kQuery>
__global__ void __launch_bounds__(kPix)
    blend_kernel(const int* __restrict__ g_sorted,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count,
                 const float* __restrict__ geom, const float* __restrict__ qw,
                 const int* __restrict__ qi, const uint4* __restrict__ rows,
                 const float* __restrict__ bg, int grid_x, int topk,
                 const float* __restrict__ phi,
                 const float* __restrict__ gram, int channels, int out_bf16,
                 int levels, int pq, float* __restrict__ rgb_out,
                 void* __restrict__ feat_out, float* __restrict__ nrm2_out,
                 float* __restrict__ t_out,
                 unsigned long long* __restrict__ stats) {
  extern __shared__ float smem[];
  float* acc = smem;                               // [channels][kPad]
  float* s_geom = acc + channels * kPad;           // [kGeom][kBatch]
  float* s_w = s_geom + kGeom * kBatch;            // [topk][kBatch]
  int* s_idx = reinterpret_cast<int*>(s_w + topk * kBatch);  // [topk][kBatch]

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const float px = (float)((tile % grid_x) * kBlock + pix % kBlock);
  const float py = (float)((tile / grid_x) * kBlock + pix / kBlock);

  for (int c = 0; c < channels; ++c) acc[c * kPad + pix] = 0.0f;
  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  bool done = false;
  unsigned long long n_eval = 0, n_inc = 0;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int nb = min(kBatch, count - b0);
    __syncthreads();  // the previous batch is consumed
    if (pix < nb)
      stage_entry<kFast16>(g_sorted[start + b0 + pix], pix, geom, qw, qi,
                           rows, topk, s_geom, s_w, s_idx);
    __syncthreads();
    for (int j = 0; j < nb && !done; ++j) {
      const float dx = px - s_geom[0 * kBatch + j];
      const float dy = py - s_geom[1 * kBatch + j];
      const float ca = s_geom[2 * kBatch + j];
      const float cb = s_geom[3 * kBatch + j];
      const float cc = s_geom[4 * kBatch + j];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      ++n_eval;
      if (!(power <= 0.0f)) continue;
      const float alpha = fminf(kAlphaMax, s_geom[5 * kBatch + j] * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      r += w * s_geom[6 * kBatch + j];
      g += w * s_geom[7 * kBatch + j];
      b += w * s_geom[8 * kBatch + j];
      for (int k = 0; k < topk; ++k) {
        const int c = s_idx[k * kBatch + j];
        if ((unsigned)c < (unsigned)channels)
          acc[c * kPad + pix] += w * s_w[k * kBatch + j];
      }
      T = test_t;
      ++n_inc;
    }
    if (__syncthreads_count(done) == kPix) break;
  }

  const size_t p = (size_t)tile * kPix + pix;
  if (out_bf16) {
    r = round_bf16(r);
    g = round_bf16(g);
    b = round_bf16(b);
  }
  rgb_out[3 * p + 0] = r + T * bg[0];
  rgb_out[3 * p + 1] = g + T * bg[1];
  rgb_out[3 * p + 2] = b + T * bg[2];
  t_out[p] = T;
  if (stats != nullptr) add_stats(stats, n_eval, n_inc);
  if (kQuery) {  // feat_out is raw [T, 256, levels * pq]
    query_epilogue(acc, s_geom, pix, levels, pq, phi, gram,
                   static_cast<float*>(feat_out) + p * levels * pq,
                   nrm2_out + p * levels);
    return;
  }
  if (channels > 0) {
    __syncthreads();
    // Coalesced write of the tile's [kPix, channels] block.
    const size_t base = (size_t)tile * kPix * channels;
    for (int i = pix; i < kPix * channels; i += kPix) {
      const int q = i / channels;
      const int c = i - q * channels;
      const float v = acc[c * kPad + q];
      if (out_bf16)
        static_cast<__nv_bfloat16*>(feat_out)[base + i] =
            __float2bfloat16_rn(v);
      else
        static_cast<float*>(feat_out)[base + i] = v;
    }
  }
}

template <bool kFast16, bool kQuery>
int launch_blend(const int* g_sorted, const int* tile_start,
                 const int* tile_count, const float* geom, const float* qw,
                 const int* qi, const uint4* rows, const float* bg,
                 const float* phi, const float* gram, int num_tiles,
                 int grid_x, int topk, int channels, int out_bf16, int levels,
                 int pq, float* rgb_out, void* feat_out, float* nrm2_out,
                 float* t_out, unsigned long long* stats, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  size_t stage = (size_t)kGeom * kBatch + 2 * (size_t)topk * kBatch;
  if (kQuery && stage < (size_t)kLevelK * kLevelK)  // the epilogue's gram
    stage = (size_t)kLevelK * kLevelK;
  const size_t smem = sizeof(float) * ((size_t)channels * kPad + stage);
  cudaError_t err = cudaFuncSetAttribute(
      blend_kernel<kFast16, kQuery>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    blend_kernel<kFast16, kQuery>
        <<<num_tiles, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
            g_sorted, tile_start, tile_count, geom, qw, qi, rows, bg, grid_x,
            topk, phi, gram, channels, out_bf16, levels, pq, rgb_out,
            feat_out, nrm2_out, t_out, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsv2_blend_tiles(const int* g_sorted, const int* tile_start,
                                const int* tile_count, const float* geom,
                                const float* qw, const int* qi,
                                const float* bg, int num_tiles, int grid_x,
                                int topk, int channels, float* rgb_out,
                                float* feat_out, float* t_out,
                                unsigned long long* stats, void* stream) {
  return launch_blend<false, false>(
      g_sorted, tile_start, tile_count, geom, qw, qi, nullptr, bg, nullptr,
      nullptr, num_tiles, grid_x, topk, channels, 0, 0, 0, rgb_out,
      feat_out, nullptr, t_out, stats, stream);
}

// rows: [N, 16] 32-bit words, 64 bytes a Gaussian, 16-byte aligned.
extern "C" int lsv2_blend_tiles_fast16(const int* g_sorted,
                                       const int* tile_start,
                                       const int* tile_count,
                                       const void* rows, const float* bg,
                                       int num_tiles, int grid_x, int topk,
                                       int channels, int out_bf16,
                                       float* rgb_out, void* feat_out,
                                       float* t_out,
                                       unsigned long long* stats,
                                       void* stream) {
  return launch_blend<true, false>(
      g_sorted, tile_start, tile_count, nullptr, nullptr, nullptr,
      static_cast<const uint4*>(rows), bg, nullptr, nullptr, num_tiles,
      grid_x, topk, channels, out_bf16, 0, 0, rgb_out, feat_out, nullptr,
      t_out, stats, stream);
}

// Query mode on fast16 rows: phi [levels, 64, pq] and gram [levels, 64, 64]
// f32 on the device, already rounded to bf16; raw [T, 256, levels * pq],
// nrm2 [T, 256, levels].
extern "C" int lsv2_blend_tiles_query(const int* g_sorted,
                                      const int* tile_start,
                                      const int* tile_count, const void* rows,
                                      const float* bg, const float* phi,
                                      const float* gram, int num_tiles,
                                      int grid_x, int topk, int levels,
                                      int pq, float* rgb_out, float* raw_out,
                                      float* nrm2_out, float* t_out,
                                      unsigned long long* stats,
                                      void* stream) {
  if (levels < 1 || levels > kMaxLevels || pq < 1 || pq > kMaxPQ)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_blend<true, true>(
      g_sorted, tile_start, tile_count, nullptr, nullptr, nullptr,
      static_cast<const uint4*>(rows), bg, phi, gram, num_tiles, grid_x,
      topk, levels * kLevelK, 0, levels, pq, rgb_out, raw_out, nrm2_out,
      t_out, stats, stream);
}
