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
//
// Level bands (fast16 and query modes, `per_level` > 0; the Pallas kernel's
// banded=True, pallas_blend.py:386-401): slot k of a row belongs to level
// k / per_level, and its pair is added only when its index lies in that
// level's band [64 l, 64 l + 64); an index outside it is dropped. The
// wrappers set it where JAX's callers do (channels % 64 == 0 and topk a
// multiple of channels / 64, the merged 3-level model's rows). The rule is
// applied where a batch is staged: an out-of-band index becomes -1, which
// the channel test then skips.
//
// bf16 cells (fast16 and query modes, `cells_bf16`; the Pallas kernel's
// cellbf16, pallas_blend.py:282-299, :323-336, :373-385, :436-441): the
// per-pair cell math rounded to bf16 at the Pallas kernel's rounding
// points, its transmittance kept as that kernel keeps it, an f32 sum of
// bf16-rounded log1p(-alpha) with one bf16 exp:
//   valid   : power <= 0 in f32 (the exact test, on the f32 power);
//   alpha   = min(bf16(0.99), bf16(op) * bf16(exp(bf16(power)))), each
//             product, exp and min rounded to bf16 (exp in f32, then
//             rounded); skipped if float(alpha) < 1/255;
//   T       = bf16(exp(bf16(S))), S the f32 sum of bf16(log1p(-alpha))
//             over the pixel's included pairs so far (0 at the start);
//   test    = bf16(T * bf16(1 - alpha)); the pixel ends if float(test)
//             < 1e-4 (the f32 include test on the bf16 product);
//   w       = bf16(alpha * T); acc += w * weight in f32 (a product of two
//             bf16 values, exact in f32); S += bf16(log1p(-alpha)).
// The final T is exp(S) in f32, as the Pallas kernel's t_carry. Within one
// of its 256-entry chunks that kernel's exclusive sum is this S; across
// chunks it carries T in f32 and rounds once more, bf16(T_chunk) *
// bf16(exp(bf16(S_chunk))), where this kernel rounds the whole sum once.
// The one-hot of the Pallas kernel, relu(1 - |idx - ch|), is exact for its
// integer operands, so it is the index compare here. The plain version
// (ops/blend.py) rounds at the same points with torch's bf16 arithmetic;
// the two can differ only where an f32 exp or log1p lands on the two sides
// of a bf16 rounding boundary.
//
// dense mode (replacing the Pallas kernel's mode="dense", :342-346, reached
// through pallas_train.py::rasterize_dense_vjp): the f32 mode's blend of
// each entry's own feature row F[g, c0:c0 + D'] (F [N, D] f32, gathered by
// g_sorted) into [T, 256, D] at columns c0.., with rgb and final T; same
// alpha, skip and termination tests, op for op. D' <= 192 channels a launch
// (the [D'][257] accumulators); the wrapper launches channel groups for a
// wider D and writes rgb and T from the first group only (rgb_out null
// after it). The feature row is D * 4 bytes an entry against 36 of
// geometry, so each batch of 32 entries (kDenseBatch) stages its rows in
// shared memory, field-major, with 16-byte loads where the row and the
// group are 16-byte aligned; at D' = 192 the accumulators and the staged
// rows take 223 KB of the 227 KB. Bound: bytes (the rows gathered, the
// [T, 256, D] write) and 2 f32 operations a channel an included pair.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;  // threads per block = pixels per tile
constexpr int kPad = kPix + 1;         // accumulator row stride
constexpr int kBatch = 128;            // entries staged per batch
constexpr int kDenseBatch = 32;        // dense mode: entries staged per batch
constexpr int kGeom = 9;               // x y ca cb cc op r g b
constexpr int kFast16Pairs = 12;       // (index, weight) slots of a fast16 row
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kLevelK = 64;            // codebook rows a level (query mode)
constexpr int kMaxLevels = 3;
constexpr int kMaxPQ = 16;             // prompts a level (query mode)
constexpr int kChains = 8;             // independent sums of the epilogue
constexpr int kMaxDense = 192;         // dense channels a launch

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
// (kFast16) from its 64-byte row, widened to f32, with the level-band rule
// applied to its indices when per_level > 0.
template <bool kFast16, int kB>
__device__ __forceinline__ void stage_entry(
    int gi, int slot, const float* __restrict__ geom,
    const float* __restrict__ qw, const int* __restrict__ qi,
    const uint4* __restrict__ rows, int topk, int per_level, float* s_geom,
    float* s_w, int* s_idx) {
  if (kFast16) {
    const uint4* row = rows + (size_t)gi * 4;
    const uint4 a = row[0], b = row[1], c = row[2], d = row[3];
    const unsigned w[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                            c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
    s_geom[0 * kB + slot] = __uint_as_float(w[0]);
    s_geom[1 * kB + slot] = __uint_as_float(w[1]);
#pragma unroll
    for (int f = 0; f < 7; ++f)  // ca cb cc op r g b
      s_geom[(2 + f) * kB + slot] =
          (f & 1) ? bf16_hi(w[2 + f / 2]) : bf16_lo(w[2 + f / 2]);
    int band = 0, left = per_level;  // slot k's level band, no division
#pragma unroll
    for (int k = 0; k < kFast16Pairs; ++k) {  // constant indices: registers
      if (k < topk) {
        int idx = (w[6 + k / 4] >> (8 * (k % 4))) & 0xFF;
        if (per_level > 0) {
          if (left == 0) {
            band += kLevelK;
            left = per_level;
          }
          --left;
          if (idx < band || idx >= band + kLevelK) idx = -1;
        }
        s_idx[k * kB + slot] = idx;
        s_w[k * kB + slot] =
            (k & 1) ? bf16_hi(w[9 + k / 2]) : bf16_lo(w[9 + k / 2]);
      }
    }
  } else {
    const float* row = geom + (size_t)gi * kGeom;
    for (int f = 0; f < kGeom; ++f) s_geom[f * kB + slot] = row[f];
    for (int k = 0; k < topk; ++k) {
      s_w[k * kB + slot] = qw[(size_t)gi * topk + k];
      s_idx[k * kB + slot] = qi[(size_t)gi * topk + k];
    }
  }
}

// Dense mode: the batch's nb feature rows F[g, c0:c0 + ch] into s_feat
// [ch][kDenseBatch], the Gaussian ids already in s_gid.
__device__ __forceinline__ void stage_dense_rows(
    const float* __restrict__ feat, int stride, int c0, int ch, int nb,
    const int* s_gid, float* s_feat) {
  const int pix = threadIdx.x;
  const bool vec4 = (stride % 4 == 0) && (c0 % 4 == 0) && (ch % 4 == 0) &&
                    (reinterpret_cast<size_t>(feat) % 16 == 0);
  if (vec4) {
    const int quads = ch / 4;
    for (int i = pix; i < nb * quads; i += kPix) {
      const int e = i / quads;
      const int q = i - e * quads;
      const float4 v = *reinterpret_cast<const float4*>(
          feat + (size_t)s_gid[e] * stride + c0 + 4 * q);
      s_feat[(4 * q + 0) * kDenseBatch + e] = v.x;
      s_feat[(4 * q + 1) * kDenseBatch + e] = v.y;
      s_feat[(4 * q + 2) * kDenseBatch + e] = v.z;
      s_feat[(4 * q + 3) * kDenseBatch + e] = v.w;
    }
  } else {
    for (int i = pix; i < nb * ch; i += kPix) {
      const int e = i / ch;
      const int c = i - e * ch;
      s_feat[c * kDenseBatch + e] = feat[(size_t)s_gid[e] * stride + c0 + c];
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

// kFast16: state from fast16 rows; kQuery: the fused query epilogue;
// kCells: bf16 cell math (fast16 rows only); kDense: each entry's own
// feature row. The modes are template flags and each pointer a __restrict__
// parameter, so that each instantiation compiles only its own code: with
// the pointers in a struct parameter the f32 blend's accumulate loop
// rebuilt its shared-memory address for every pair and ran ~45% slower at
// 1080p on the card. The launch bounds ask for one block an SM (what 192
// channels' accumulators leave room for), which lets the compiler use up
// to 255 registers a thread: held to 128, the query epilogue ran ~10%
// slower, and with two blocks asked for the f32 blend ran ~45% slower.
template <bool kFast16, bool kQuery, bool kCells, bool kDense>
__global__ void __launch_bounds__(kPix, 1)
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
                 unsigned long long* __restrict__ stats, int per_level,
                 const float* __restrict__ feat_in, int feat_stride,
                 int feat_c0) {
  constexpr int kB = kDense ? kDenseBatch : kBatch;
  extern __shared__ float smem[];
  float* acc = smem;                               // [channels][kPad]
  float* s_geom = acc + channels * kPad;           // [kGeom][kB]
  // quick modes: weights [topk][kB], then indices [topk][kB];
  // dense mode: feature rows [channels][kB], then Gaussian ids [kB]
  float* s_w = s_geom + kGeom * kB;
  int* s_idx = reinterpret_cast<int*>(s_w + (kDense ? channels : topk) * kB);

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const float px = (float)((tile % grid_x) * kBlock + pix % kBlock);
  const float py = (float)((tile / grid_x) * kBlock + pix / kBlock);

  for (int c = 0; c < channels; ++c) acc[c * kPad + pix] = 0.0f;
  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  float S = 0.0f;  // kCells: the log-sum of the included pairs' 1 - alpha
  bool done = false;
  unsigned long long n_eval = 0, n_inc = 0;

  for (int b0 = 0; b0 < count; b0 += kB) {
    const int nb = min(kB, count - b0);
    __syncthreads();  // the previous batch is consumed
    if (pix < nb) {
      const int gi = g_sorted[start + b0 + pix];
      stage_entry<kFast16, kB>(gi, pix, geom, qw, qi, rows, topk, per_level,
                               s_geom, s_w, s_idx);
      if constexpr (kDense) s_idx[pix] = gi;
    }
    __syncthreads();
    if constexpr (kDense) {
      stage_dense_rows(feat_in, feat_stride, feat_c0, channels, nb, s_idx,
                       s_w);
      __syncthreads();
    }
    for (int j = 0; j < nb && !done; ++j) {
      const float dx = px - s_geom[0 * kB + j];
      const float dy = py - s_geom[1 * kB + j];
      const float ca = s_geom[2 * kB + j];
      const float cb = s_geom[3 * kB + j];
      const float cc = s_geom[4 * kB + j];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      ++n_eval;
      if (!(power <= 0.0f)) continue;
      float alpha, test_t, w, lm = 0.0f;
      if constexpr (kCells) {
        const __nv_bfloat16 e = __float2bfloat16_rn(
            expf(__bfloat162float(__float2bfloat16_rn(power))));
        const __nv_bfloat16 ab =
            __hmin(__float2bfloat16_rn(kAlphaMax),
                   __hmul(__float2bfloat16_rn(s_geom[5 * kB + j]), e));
        alpha = __bfloat162float(ab);
        if (alpha < kAlphaMin) continue;
        const __nv_bfloat16 tb = __float2bfloat16_rn(expf(round_bf16(S)));
        test_t = __bfloat162float(
            __hmul(tb, __hsub(__float2bfloat16_rn(1.0f), ab)));
        if (test_t < kTEps) {
          done = true;
          break;
        }
        w = __bfloat162float(__hmul(ab, tb));
        lm = round_bf16(log1pf(-alpha));
      } else {
        alpha = fminf(kAlphaMax, s_geom[5 * kB + j] * expf(power));
        if (alpha < kAlphaMin) continue;
        test_t = T * (1.0f - alpha);
        if (test_t < kTEps) {
          done = true;
          break;
        }
        w = alpha * T;
      }
      r += w * s_geom[6 * kB + j];
      g += w * s_geom[7 * kB + j];
      b += w * s_geom[8 * kB + j];
      if constexpr (kDense) {
        for (int c = 0; c < channels; ++c)
          acc[c * kPad + pix] += w * s_w[c * kB + j];
      } else {
        for (int k = 0; k < topk; ++k) {
          const int c = s_idx[k * kB + j];
          if ((unsigned)c < (unsigned)channels)
            acc[c * kPad + pix] += w * s_w[k * kB + j];
        }
      }
      if constexpr (kCells)
        S += lm;
      else
        T = test_t;
      ++n_inc;
    }
    if (__syncthreads_count(done) == kPix) break;
  }
  if constexpr (kCells) T = expf(S);

  const size_t p = (size_t)tile * kPix + pix;
  if (out_bf16) {
    r = round_bf16(r);
    g = round_bf16(g);
    b = round_bf16(b);
  }
  if (!kDense || rgb_out != nullptr) {
    rgb_out[3 * p + 0] = r + T * bg[0];
    rgb_out[3 * p + 1] = g + T * bg[1];
    rgb_out[3 * p + 2] = b + T * bg[2];
    t_out[p] = T;
  }
  if (stats != nullptr) add_stats(stats, n_eval, n_inc);
  if constexpr (kQuery) {  // feat_out is raw [T, 256, levels * pq]
    query_epilogue(acc, s_geom, pix, levels, pq, phi, gram,
                   static_cast<float*>(feat_out) + p * levels * pq,
                   nrm2_out + p * levels);
    return;
  }
  if constexpr (kDense) {
    __syncthreads();
    // The tile's [kPix, channels] block at columns feat_c0.. of its
    // [kPix, feat_stride] rows.
    float* out = static_cast<float*>(feat_out) +
                 (size_t)tile * kPix * feat_stride + feat_c0;
    for (int i = pix; i < kPix * channels; i += kPix) {
      const int q = i / channels;
      const int c = i - q * channels;
      out[(size_t)q * feat_stride + c] = acc[c * kPad + q];
    }
  } else if (channels > 0) {
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

// Typed nulls for the parameters a mode does not read.
constexpr const float* kNoF32 = nullptr;
constexpr const int* kNoIdx = nullptr;
constexpr const uint4* kNoRows = nullptr;
constexpr float* kNoOut = nullptr;

// Sets the shared-memory size of one instantiation for `channels` and
// `topk` and launches it with the kernel's argument list `args`.
template <bool kFast16, bool kQuery, bool kCells, bool kDense,
          typename... Args>
int launch_blend(int num_tiles, int channels, int topk, void* stream,
                 Args... args) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  constexpr int kB = kDense ? kDenseBatch : kBatch;
  size_t stage = (size_t)kGeom * kB;
  if (kDense)
    stage += (size_t)channels * kB + kB;
  else
    stage += 2 * (size_t)topk * kB;
  if (kQuery && stage < (size_t)kLevelK * kLevelK)
    stage = (size_t)kLevelK * kLevelK;  // the epilogue's gram
  const size_t smem = sizeof(float) * ((size_t)channels * kPad + stage);
  auto kernel = blend_kernel<kFast16, kQuery, kCells, kDense>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0)
    kernel<<<num_tiles, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
        args...);
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
  return launch_blend<false, false, false, false>(
      num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
      geom, qw, qi, kNoRows, bg, grid_x, topk, kNoF32, kNoF32, channels, 0,
      0, 0, rgb_out, static_cast<void*>(feat_out), kNoOut, t_out, stats, 0,
      kNoF32, 0, 0);
}

// rows: [N, 16] 32-bit words, 64 bytes a Gaussian, 16-byte aligned.
extern "C" int lsv2_blend_tiles_fast16(const int* g_sorted,
                                       const int* tile_start,
                                       const int* tile_count,
                                       const void* rows, const float* bg,
                                       int num_tiles, int grid_x, int topk,
                                       int channels, int out_bf16,
                                       int per_level, int cells_bf16,
                                       float* rgb_out, void* feat_out,
                                       float* t_out,
                                       unsigned long long* stats,
                                       void* stream) {
  auto go = [&](auto cells) {
    return launch_blend<true, false, decltype(cells)::value, false>(
        num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
        kNoF32, kNoF32, kNoIdx, static_cast<const uint4*>(rows), bg, grid_x,
        topk, kNoF32, kNoF32, channels, out_bf16, 0, 0, rgb_out, feat_out,
        kNoOut, t_out, stats, per_level, kNoF32, 0, 0);
  };
  return cells_bf16 ? go(std::true_type{}) : go(std::false_type{});
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
                                      int pq, int per_level, int cells_bf16,
                                      float* rgb_out, float* raw_out,
                                      float* nrm2_out, float* t_out,
                                      unsigned long long* stats,
                                      void* stream) {
  if (levels < 1 || levels > kMaxLevels || pq < 1 || pq > kMaxPQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int channels = levels * kLevelK;
  auto go = [&](auto cells) {
    return launch_blend<true, true, decltype(cells)::value, false>(
        num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
        kNoF32, kNoF32, kNoIdx, static_cast<const uint4*>(rows), bg, grid_x,
        topk, phi, gram, channels, 0, levels, pq, rgb_out,
        static_cast<void*>(raw_out), nrm2_out, t_out, stats, per_level,
        kNoF32, 0, 0);
  };
  return cells_bf16 ? go(std::true_type{}) : go(std::false_type{});
}

// Dense mode: features [N, stride] f32; this launch blends columns
// [c0, c0 + channels) (channels <= 192) into feat_out [T, 256, stride] at
// the same columns. rgb_out and t_out null: only the feature columns.
extern "C" int lsv2_blend_tiles_dense(const int* g_sorted,
                                      const int* tile_start,
                                      const int* tile_count,
                                      const float* geom, const float* feats,
                                      const float* bg, int num_tiles,
                                      int grid_x, int stride, int c0,
                                      int channels, float* rgb_out,
                                      float* feat_out, float* t_out,
                                      unsigned long long* stats,
                                      void* stream) {
  if (channels < 1 || channels > kMaxDense || c0 < 0 ||
      c0 + channels > stride || (rgb_out == nullptr) != (t_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_blend<false, false, false, true>(
      num_tiles, channels, 0, stream, g_sorted, tile_start, tile_count, geom,
      kNoF32, kNoIdx, kNoRows, bg, grid_x, 0, kNoF32, kNoF32, channels, 0, 0,
      0, rgb_out, static_cast<void*>(feat_out), kNoOut, t_out, stats, 0,
      feats, stride, c0);
}
