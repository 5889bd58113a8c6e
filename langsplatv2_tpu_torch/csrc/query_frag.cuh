// The Gram relevancy query's products at any codebook width K, prompt
// count PQ and level count L: the general path of K3 (query.cu,
// query_any_kernel) and of K2q's epilogue (blend.cu), beside their code for
// K = 64, L <= 3, PQ <= 16.
//
// Per level l and pixel, B_l = [gram_l | phi_l] is [Kp, Kp + PQ8]: Kp = K
// rounded up to the mma k-step (8 for TF32, 16 for bf16), gram_l in its
// first Kp columns and phi_l after them, PQ8 = PQ rounded up to 8, zero past
// K and PQ. W_l . B_l gives raw (the phi columns) and W_l . gram_l, whose
// columns m times w[m], summed, give nrm2. The fragments of B are written
// once a call by qf_split_kernel into scratch, in the order a warp reads
// them, and read from there (L1 / L2: a few KB a level); each warp walks
// its 16 rows' level n-tiles four at a time (the prompts in chunks of 32,
// gram's columns in chunks of 32), every k-step, so no width is bounded by
// registers or shared memory. A comes from the caller (the map at its true row stride,
// loads predicated to zero past K; or K2q's accumulators).
//
// k order. TF32 (m16n8k8): the lane (g, t) of k-step ks holds A[g][8ks + 2t]
// and A[g][8ks + 2t + 1] (the mma's k = t and t + 4; k is summed, so a
// permutation applied alike to A and B changes nothing); bf16 (m16n8k16):
// mma_bf16's own order, A[g][16ks + 2t, +1] and A[g][16ks + 8 + 2t, +1].
// Either way a lane's accumulator columns 8nt + 2t, + 1 are level columns
// whose weights it reads for nrm2 with no shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

// The widths of a call: L levels of K rows, PQ prompts a level; Kp = K
// rounded up to the k-step; NTg = Kp / 8 gram n-tiles and NT = NTg +
// ceil(PQ / 8) n-tiles a level; KS k-steps.
struct QShape {
  int L, K, PQ, Kp, NTg, NT, KS;
};

__host__ __device__ __forceinline__ QShape qf_shape(bool bf16, int L, int K,
                                                    int PQ) {
  const int step = bf16 ? 16 : 8;
  const int kp = (K + step - 1) / step * step;
  return {L, K, PQ, kp, kp / 8, kp / 8 + (PQ + 7) / 8, kp / step};
}

// 32-bit words of the fragments of all L levels.
__host__ __device__ __forceinline__ long long qf_words(bool bf16,
                                                       const QShape& s) {
  return (long long)s.L * s.NT * s.KS * 32 * (bf16 ? 2 : 4);
}

// B_l[k][n] from phi [L, K, PQ] and gram [L, K, K].
__device__ __forceinline__ float qf_b(const float* __restrict__ phi,
                                      const float* __restrict__ gram,
                                      const QShape& s, int l, int k, int n) {
  if (k >= s.K) return 0.0f;
  if (n < s.Kp) return n < s.K ? gram[((size_t)l * s.K + k) * s.K + n] : 0.0f;
  const int q = n - s.Kp;
  return q < s.PQ ? phi[((size_t)l * s.K + k) * s.PQ + q] : 0.0f;
}

// Fragment i = ((l * NT + nt) * KS + ks) * 32 + lane, n = 8nt + g: bf16
// (uint2) the pairs (B[16ks + 2t][n], B[16ks + 2t + 1][n]) and (B[16ks + 8 +
// 2t][n], B[16ks + 9 + 2t][n]); TF32 (uint4) big b0, big b1, small b0,
// small b1 with b0 = B[8ks + 2t][n], b1 = B[8ks + 2t + 1][n].
template <bool kBf16>
__global__ void qf_split_kernel(const float* __restrict__ phi,
                                const float* __restrict__ gram, QShape s,
                                void* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.L * s.NT * s.KS * 32) return;
  const int lane = i & 31, r = i >> 5;
  const int ks = r % s.KS, nt = (r / s.KS) % s.NT, l = r / (s.KS * s.NT);
  const int n = 8 * nt + (lane >> 2), t = lane & 3;
  if (kBf16) {
    const int k = 16 * ks + 2 * t;
    static_cast<uint2*>(out)[i] = make_uint2(
        pack_bf16(qf_b(phi, gram, s, l, k, n), qf_b(phi, gram, s, l, k + 1, n)),
        pack_bf16(qf_b(phi, gram, s, l, k + 8, n),
                  qf_b(phi, gram, s, l, k + 9, n)));
  } else {
    const int k = 8 * ks + 2 * t;
    unsigned bb0, bs0, bb1, bs1;
    split_tf32(qf_b(phi, gram, s, l, k, n), bb0, bs0);
    split_tf32(qf_b(phi, gram, s, l, k + 1, n), bb1, bs1);
    static_cast<uint4*>(out)[i] = make_uint4(bb0, bb1, bs0, bs1);
  }
}

template <bool kBf16>
int qf_split(const float* phi, const float* gram, const QShape& s,
             void* frag, cudaStream_t stream) {
  const long long n = (long long)s.L * s.NT * s.KS * 32;
  if (n > 0)
    qf_split_kernel<kBf16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        phi, gram, s, frag);
  return static_cast<int>(cudaGetLastError());
}

// One level of a warp's 16 rows (the lane's rows g and g + 8): a_frag(ks,
// a) fills the lane's A words of k-step ks (bf16: packed pairs; TF32: f32
// bits) in mma order; w_at(h, m) is row g + 8h's f32 weight at level
// column m (0 past K); raw_at(h, q, v) stores prompt q < PQ of row g + 8h.
// Adds the lane's share of nrm2 of rows g and g + 8 to n2a, n2b (the caller
// sums the quad). `frag` points at the level's fragments.
template <bool kBf16, class AFrag, class WAt, class RawAt>
__device__ __forceinline__ void qf_level(const void* __restrict__ frag,
                                         const QShape& s, AFrag a_frag,
                                         WAt w_at, RawAt raw_at, float& n2a,
                                         float& n2b) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  for (int nt0 = 0; nt0 < s.NT; nt0 += 4) {   // warp-uniform
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;
    for (int ks = 0; ks < s.KS; ++ks) {
      unsigned a[4];
      a_frag(ks, a);
      const size_t at = ((size_t)nt0 * s.KS + ks) * 32 + lane;
      const size_t step = (size_t)s.KS * 32;
      if constexpr (kBf16) {
        const uint2* b = static_cast<const uint2*>(frag) + at;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < s.NT) {
            const uint2 v = __ldg(b + j * step);
            mma_bf16(d[j], a, v.x, v.y);
          }
      } else {
        unsigned ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ab[e], as[e]);
        const uint4* b = static_cast<const uint4*>(frag) + at;
        uint4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < s.NT) v[j] = __ldg(b + j * step);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < s.NT) mma_tf32(d[j], as, v[j].x, v[j].y);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < s.NT) mma_tf32(d[j], ab, v[j].z, v[j].w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < s.NT) mma_tf32(d[j], ab, v[j].x, v[j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = nt0 + j;
      if (nt >= s.NT) continue;
      if (nt < s.NTg) {
        const int m = 8 * nt + 2 * t4;
        n2a += d[j][0] * w_at(0, m) + d[j][1] * w_at(0, m + 1);
        n2b += d[j][2] * w_at(1, m) + d[j][3] * w_at(1, m + 1);
      } else {
        const int q = 8 * (nt - s.NTg) + 2 * t4;
        if (q < s.PQ) {
          raw_at(0, q, d[j][0]);
          raw_at(1, q, d[j][2]);
        }
        if (q + 1 < s.PQ) {
          raw_at(0, q + 1, d[j][1]);
          raw_at(1, q + 1, d[j][3]);
        }
      }
    }
  }
}

}  // namespace
