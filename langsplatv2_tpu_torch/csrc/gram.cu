// K6a / K6b: the Gram-space cosine loss of feature training, forward and
// backward, per 16x16 tile of the [T, 256, C] weight map.
//
// Replaces the TPU kernels langsplatv2_tpu/ops/pallas_gram.py::_fwd_kernel
// (pallas_call at :175) and ::_bwd_kernel (pallas_call at :205). For pixel p
// with segment s = seg[p] (-1: masked or padding) and coefficients w [M]
// (layers 0..lay, M = (lay+1)*K), from rhs [S, M+1] (per-segment phi columns,
// then the GT norm) and G [M, M] (the block Gram matrix of the codebooks):
//   num = w . rhs[s, :M],  n2 = w^T G w,  gtn = rhs[s, M]   (0 when s < 0)
//   nrm = n2 > 0 ? sqrt(n2) : 0,  sim = num / (max(nrm, eps) * max(gtn, eps))
// K6a writes each tile's sum of sim (the wrapper adds the tiles up); K6b
// recomputes the chain and writes d_w [T, 256, C] (non-zero only in the
// trained layer's K columns [lay*K, lay*K + K)), d_phi [S, K] and
// d_G [M, K] for the upstream gradient d_sim = -g / hw, with the guards of
// the Pallas `_chain` / `_dmax` (d max(x, c)/dx = 0.5 at the tie).
//
// The Pallas kernels look rhs up with a one-hot [256, S] MXU matmul and
// accumulate d_phi / d_G in a block revisited by every grid step. Here one
// block of 256 threads takes one tile, one thread per pixel. The tile's w is
// staged transposed in shared memory ([M][257], conflict-free per pixel) and
// G beside it ([M][M+1]) where both fit (M <= 128; at M = 192 G is read from
// device memory through L1/L2, its reads uniform across a warp). Each pixel
// reads its rhs row from device memory by segment id (S rows of M+1 floats
// stay in L2). n2 runs as 16-row register blocks of G w. K6b writes d_w
// coalesced (one thread per element, recomputing (G w)_i from shared memory),
// adds d_phi with global atomics (one per warp and column where the warp's 32
// pixels share a segment, as in segment masks; else one per pixel) and sums
// d_G per block in registers before one atomic add per element. Sums across
// blocks therefore change order from run to run.
//
// Bound on this card: bytes at the slice's shapes (the w read, and in K6b the
// d_w write, 134 MB each at 544x960 with C = 64) against 2*M*(M+2) f32
// operations a pixel forward; K6b about doubles both. Tensor-core products
// are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 256;          // threads per block = pixels per tile
constexpr int kPad = kPix + 1;     // stride of the transposed w stage
constexpr int kRowBlock = 16;      // rows of G w a thread keeps in registers
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

struct Chain {
  bool covered;
  float n2g, nrm, a, b, num;
};

// Stage the tile's w [256, M] (row stride C) transposed into w_s and, when
// g_s is given, G into g_s with row stride M+1.
__device__ void stage(const float* __restrict__ w, int C, int M,
                      const float* __restrict__ gfull, float* w_s,
                      float* g_s) {
  const int t = threadIdx.x;
  for (int i = t; i < kPix * M; i += kPix) {
    const int q = i / M;
    const int j = i - q * M;
    w_s[j * kPad + q] = w[(size_t)q * C + j];
  }
  if (g_s != nullptr)
    for (int i = t; i < M * M; i += kPix) {
      const int r = i / M;
      g_s[r * (M + 1) + (i - r * M)] = gfull[i];
    }
}

// The forward chain of pixel p (threadIdx.x); g points at G with row stride gs.
__device__ Chain pixel_chain(const float* w_s, const float* g, int gs, int M,
                             const float* row, float eps) {
  const int p = threadIdx.x;
  float num = 0.0f;
  if (row != nullptr)
    for (int j = 0; j < M; ++j) num += w_s[j * kPad + p] * row[j];
  float n2 = 0.0f;
  for (int ib = 0; ib < M; ib += kRowBlock) {
    float acc[kRowBlock];
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) acc[r] = 0.0f;
    for (int j = 0; j < M; ++j) {
      const float wj = w_s[j * kPad + p];
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) acc[r] += g[(ib + r) * gs + j] * wj;
    }
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) n2 += w_s[(ib + r) * kPad + p] * acc[r];
  }
  const float gtn = row != nullptr ? row[M] : 0.0f;
  Chain c;
  c.covered = n2 > 0.0f;
  c.n2g = c.covered ? n2 : 1.0f;
  c.nrm = c.covered ? sqrtf(c.n2g) : 0.0f;
  c.a = fmaxf(c.nrm, eps);
  c.b = fmaxf(gtn, eps);
  c.num = num;
  return c;
}

__global__ void __launch_bounds__(kPix)
    gram_fwd_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                    const float* __restrict__ rhs,
                    const float* __restrict__ gfull, int C, int M,
                    int g_in_smem, float eps, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* w_s = smem;                              // [M][kPad]
  float* g_s = g_in_smem ? w_s + M * kPad : nullptr;
  __shared__ float s_red[kPix / 32];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  stage(w + (size_t)tile * kPix * C, C, M, gfull, w_s, g_s);
  __syncthreads();
  const int s = seg[(size_t)tile * kPix + p];
  const float* row = s >= 0 ? rhs + (size_t)s * (M + 1) : nullptr;
  const Chain c = g_in_smem ? pixel_chain(w_s, g_s, M + 1, M, row, eps)
                            : pixel_chain(w_s, gfull, M, M, row, eps);
  float sim = c.num / (c.a * c.b);
  for (int off = 16; off > 0; off >>= 1)
    sim += __shfl_down_sync(0xffffffffu, sim, off);
  if ((p & 31) == 0) s_red[p >> 5] = sim;
  __syncthreads();
  if (p == 0) {
    float total = 0.0f;
    for (int i = 0; i < kPix / 32; ++i) total += s_red[i];
    partial[tile] = total;
  }
}

__global__ void __launch_bounds__(kPix)
    gram_bwd_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                    const float* __restrict__ rhs,
                    const float* __restrict__ gfull, int C, int M, int K,
                    int lay, int g_in_smem, float eps, float inv_hw,
                    const float* __restrict__ upstream,
                    float* __restrict__ dw, float* __restrict__ dphi,
                    float* __restrict__ dg) {
  extern __shared__ float smem[];
  float* w_s = smem;                                   // [M][kPad]
  float* g_s = g_in_smem ? w_s + M * kPad : nullptr;   // [M][M+1]
  float* s_dnum = w_s + M * kPad + (g_in_smem ? M * (M + 1) : 0);
  float* s_dn2 = s_dnum + kPix;
  int* s_seg = reinterpret_cast<int*>(s_dn2 + kPix);
  const float* g = g_in_smem ? g_s : gfull;
  const int gs = g_in_smem ? M + 1 : M;
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lo = lay * K;
  stage(w + (size_t)tile * kPix * C, C, M, gfull, w_s, g_s);
  __syncthreads();
  const int s = seg[(size_t)tile * kPix + p];
  const float* row = s >= 0 ? rhs + (size_t)s * (M + 1) : nullptr;
  const Chain c = pixel_chain(w_s, g, gs, M, row, eps);

  const float d_sim = -inv_hw * upstream[0];
  const float inv_ab = 1.0f / (c.a * c.b);
  const float d_num = d_sim * inv_ab;
  const float d_a = -d_sim * c.num * inv_ab / c.a;
  const float dmax = c.nrm > eps ? 1.0f : (c.nrm == eps ? 0.5f : 0.0f);
  const float d_nrm = d_a * dmax;
  const float d_n2 = c.covered ? d_nrm * 0.5f / sqrtf(c.n2g) : 0.0f;
  s_dnum[p] = d_num;
  s_dn2[p] = d_n2;
  s_seg[p] = s;
  // d_phi: a warp whose 32 pixels share one segment (two pixel rows of a
  // segment mask) sums in registers and adds once; otherwise each pixel
  // adds its own row.
  const bool warp_uniform =
      __all_sync(0xffffffffu, s == __shfl_sync(0xffffffffu, s, 0));
  if (warp_uniform) {
    if (s >= 0)
      for (int k = 0; k < K; ++k) {
        float v = d_num * w_s[(lo + k) * kPad + p];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if ((p & 31) == 0) atomicAdd(dphi + (size_t)s * K + k, v);
      }
  } else if (s >= 0) {
    for (int k = 0; k < K; ++k)
      atomicAdd(dphi + (size_t)s * K + k, d_num * w_s[(lo + k) * kPad + p]);
  }
  __syncthreads();

  // d_w, one element a thread per step, coalesced.
  float* dst = dw + (size_t)tile * kPix * C;
  for (int idx = p; idx < kPix * C; idx += kPix) {
    const int q = idx / C;
    const int i = idx - q * C;
    float v = 0.0f;
    if (i >= lo && i < lo + K) {
      float wg = 0.0f;
      for (int j = 0; j < M; ++j) wg += g[i * gs + j] * w_s[j * kPad + q];
      const int sq = s_seg[q];
      const float phi = sq >= 0 ? rhs[(size_t)sq * (M + 1) + i] : 0.0f;
      v = s_dnum[q] * phi + 2.0f * s_dn2[q] * wg;
    }
    dst[idx] = v;
  }

  // d_G[i, k] = sum_q w[q, i] * (d_n2[q] * w[q, lo + k]), one atomic each.
  for (int idx = p; idx < M * K; idx += kPix) {
    const int i = idx / K;
    const int k = idx - i * K;
    float acc = 0.0f;
    for (int q = 0; q < kPix; ++q)
      acc += w_s[i * kPad + q] * (s_dn2[q] * w_s[(lo + k) * kPad + q]);
    atomicAdd(dg + idx, acc);
  }
}

size_t stage_bytes(int M, bool g_in_smem) {
  return sizeof(float) * ((size_t)M * kPad +
                          (g_in_smem ? (size_t)M * (M + 1) : 0) + 3 * kPix);
}

}  // namespace

// G goes to shared memory where it fits beside the w stage; M must be a
// multiple of 16 (the register blocks of G w).
extern "C" int lsv2_gram_fwd(const int* seg, const float* w, const float* rhs,
                             const float* gfull, int num_tiles, int C, int M,
                             float eps, float* partial, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (M % kRowBlock != 0 || M > C) return static_cast<int>(cudaErrorInvalidValue);
  const int g_in_smem = stage_bytes(M, true) <= kMaxSmem;
  const size_t smem = stage_bytes(M, g_in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      gram_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    gram_fwd_kernel<<<num_tiles, kPix, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        seg, w, rhs, gfull, C, M, g_in_smem, eps, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

// dphi [S, K] and dg [M, K] are accumulated into: the caller zeroes them.
extern "C" int lsv2_gram_bwd(const int* seg, const float* w, const float* rhs,
                             const float* gfull, int num_tiles, int C, int M,
                             int K, int lay, float eps, float inv_hw,
                             const float* upstream, float* dw, float* dphi,
                             float* dg, void* stream) {
  cudaGetLastError();
  if (M % kRowBlock != 0 || M > C || (lay + 1) * K != M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g_in_smem = stage_bytes(M, true) <= kMaxSmem;
  const size_t smem = stage_bytes(M, g_in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      gram_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    gram_bwd_kernel<<<num_tiles, kPix, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        seg, w, rhs, gfull, C, M, K, lay, g_in_smem, eps, inv_hw, upstream,
        dw, dphi, dg);
  }
  return static_cast<int>(cudaGetLastError());
}
