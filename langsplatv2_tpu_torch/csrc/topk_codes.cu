// The top-k codes of the feature step: for each Gaussian and each level of
// its language logits [N, L·K], the k largest logits, their indices in
// ascending order (plus the level's offset l·K) and a softmax over them;
// and the backward of that softmax, written to the logits' gradient.
//
// Replaces no Pallas kernel: the JAX package selects with XLA code
// (langsplatv2_tpu/utils/sparse_codes.py, `_topk_onehots` and
// `get_weights_and_indices`), which XLA fuses on the TPU. The port ran it
// as ~28 plain-torch launches a step (utils/sparse_codes.py::
// get_weights_and_indices_plain: k rounds of a full-width max, compare,
// where against an int64 iota, min and scatter over a clone, then a sort,
// a gather, a softmax, the level offsets and two cats), about 1.7 GB of
// traffic a round at [1M, 64]; autograd's backward added the softmax's
// backward, a zero fill and a scatter-add a level and the slice's fill and
// copy.
//
// Bound on this card: bytes. The forward reads each row's L·K logits once
// (256 B at K = 64) and writes k f32 weights and k int64 indices a level
// (48 B at k = 4); the backward reads the k gradients, weights and indices
// of a level (64 B) and writes the row's L·K gradients once. Both do a few
// operations a byte.
//
// Design: the segments of [N, L·K] (a row's K logits of one level) are the
// rows of [N·L, K]. A group of G lanes of one warp takes a segment: G a
// power of two, K/16 rounded up, at least pow2(k) (the softmax's width), at
// most 32 (4 at K = 64, k = 4: 8 segments a warp). Each lane holds 16
// columns in registers, 4 chunks of 4 (chunk t at column 4 (lane + G t):
// a 16-byte load each where K allows, each load instruction reading 64 B
// of a row, and only once); a segment wider than 16G streams its other
// columns again each round (L1). Nothing goes through shared memory. Few
// lanes a segment keep the shuffles (two a butterfly step) and the work
// every lane repeats (the look-back, the sort, the softmax) small: 16
// lanes of 4 columns ran 3x slower on an H100 SXM (0.47 against 0.15 ms
// at [1M, 64], k = 4).
// Forward: k rounds of the plain path's masked max. Each lane takes the
// best of its columns, the taken ones as -inf, then a butterfly over the
// group on (value, column), the larger value winning and on a tie the lower
// column; the owner sets the winner to -inf in its registers. The k
// selections (column and original logit) stay in registers on every lane
// of the group, are put in ascending column order by an odd-even
// transposition network, and lane j < k forms weight j and writes it
// with index j.
// Backward: lane j < k forms the softmax's backward of entry j; the group
// shares the k results by shuffles, and each lane writes its chunks of the
// row (16-byte stores where K allows): 0 where no index falls, the sum
// over the entries (ascending j, from 0) where some do, as the gather's
// scatter-add into zeros gives.
//
// Numerics, the plain path's on the card: the selection only compares
// floats, so the indices are the plain path's bit for bit, ties, ±inf and
// the repeated indices of rows with fewer than k finite logits included.
// The softmax replays PyTorch's warp softmax for a row of k <= 32
// (ATen/native/cuda/PersistentSoftmax.cuh): the max, expf(x - max), a
// butterfly sum over pow2(k) lanes from 0 (lanes past k add 0), then the
// quotient; its backward (softmax_backward_cuda_out) t = g·w, s the
// butterfly sum of t from 0, t - w·s as one fused multiply-add, as nvcc
// contracts it in PyTorch's build. Compiled without -fmad=false, as
// PyTorch's kernels are; expf is the CUDA math library's.
// A row that holds a NaN faults the plain path (scatter_ at column K);
// here every index stays in [0, K), and the values are unspecified.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 4;        // 4-column chunks a lane holds
constexpr int kRegCols = 4 * kChunks;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  // (v, j) wins over (bv, bj): a larger value, or an equal one at a lower
  // column. bj == INT_MAX: nothing held.
  return bj == INT_MAX || v > bv || (v == bv && j < bj);
}

__device__ __forceinline__ int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The group a thread belongs to: its segment, its lane in the group and
// whether the segment exists (a group past the last runs on the last one
// for the warp's shuffles and stores nothing).
struct Group {
  int seg;
  int lg;
  bool live;
};

__device__ __forceinline__ Group group_of(int segs, int G) {
  Group g;
  g.seg = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  g.lg = threadIdx.x & (G - 1);
  g.live = g.seg < segs;
  if (!g.live) g.seg = segs - 1;
  return g;
}

// Chunk t of lane lg: columns 4 (lg + G t) .. + 3.
__device__ __forceinline__ int chunk_col(int lg, int G, int t) {
  return 4 * (lg + G * t);
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
topk_codes_kernel(const float* __restrict__ logits, int segs, int K, int L,
                  int k, int G, bool vec, float* __restrict__ weights,
                  long long* __restrict__ indices) {
  const Group gr = group_of(segs, G);
  const int lg = gr.lg;
  const float* row = logits + (long long)gr.seg * K;

  // The lane's chunks: one 16-byte load each where the rows allow it.
  float v[kRegCols];
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = chunk_col(lg, G, t);
    if (vec) {
      const float4 q = c < K ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * t] = q.x;
      v[4 * t + 1] = q.y;
      v[4 * t + 2] = q.z;
      v[4 * t + 3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * t + e] = c + e < K ? __ldg(row + c + e) : 0.0f;
    }
  }
  const int tail = kRegCols * G;   // the first column not in registers

  int sel[KMAX];
  float val[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    sel[r] = INT_MAX;
    val[r] = 0.0f;
    if (r < k) {
      // The lane's best: its columns ascend, so a strictly larger value
      // alone displaces the held one.
      float bv = 0.0f;
      int bj = INT_MAX;
      if (4 * lg < K) {
        bv = v[0];
        bj = 4 * lg;
      }
#pragma unroll
      for (int i = 1; i < kRegCols; ++i) {
        const int j = chunk_col(lg, G, i / 4) + i % 4;
        if (j < K && v[i] > bv) {
          bv = v[i];
          bj = j;
        }
      }
      for (int j = tail + lg; j < K; j += G) {
        float x = __ldg(row + j);
#pragma unroll
        for (int q = 0; q < r; ++q)
          if (sel[q] == j) x = -CUDART_INF_F;
        if (better(x, j, bv, bj)) {
          bv = x;
          bj = j;
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (oj != INT_MAX && better(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      // bv is the masked value; a column taken before keeps the logit it
      // was taken with.
      float orig = bv;
#pragma unroll
      for (int q = 0; q < r; ++q)
        if (sel[q] == bj) orig = val[q];
      sel[r] = bj;
      val[r] = orig;
#pragma unroll
      for (int i = 0; i < kRegCols; ++i)
        if (bj == chunk_col(lg, G, i / 4) + i % 4) v[i] = -CUDART_INF_F;
    }
  }

  // Ascending columns (the unused slots hold INT_MAX and stay last).
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
#pragma unroll
    for (int i = p & 1; i + 1 < KMAX; i += 2) {
      if (sel[i] > sel[i + 1]) {
        const int s = sel[i];
        sel[i] = sel[i + 1];
        sel[i + 1] = s;
        const float x = val[i];
        val[i] = val[i + 1];
        val[i + 1] = x;
      }
    }
  }

  // The softmax over val[0, k): PyTorch's warp softmax, lane j holding
  // entry j.
  float m = val[0];
#pragma unroll
  for (int r = 1; r < KMAX; ++r)
    if (r < k) m = m > val[r] ? m : val[r];
  int mine = 0;
  float x = 0.0f;
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r == lg) {
      mine = sel[r];
      x = val[r];
    }
  }
  const float e = lg < k ? expf(x - m) : 0.0f;
  float s = 0.0f + e;
  for (int off = pow2_at_least(k) >> 1; off > 0; off >>= 1)
    s = s + __shfl_xor_sync(kFull, s, off);
  if (gr.live && lg < k) {
    const long long o = (long long)gr.seg * k + lg;
    weights[o] = e / s;
    indices[o] = mine + (long long)(gr.seg % L) * K;
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
topk_codes_bwd_kernel(const float* __restrict__ dweights,
                      const float* __restrict__ weights,
                      const long long* __restrict__ indices, int segs, int K,
                      int L, int k, int G, bool vec,
                      float* __restrict__ dlogits) {
  const Group gr = group_of(segs, G);
  const int lg = gr.lg;
  float g = 0.0f, w = 0.0f;
  int col = -1;
  if (lg < k) {
    const long long o = (long long)gr.seg * k + lg;
    g = dweights[o];
    w = weights[o];
    col = (int)(indices[o] - (long long)(gr.seg % L) * K);
  }
  const float t = g * w;
  float s = 0.0f + t;
  for (int off = pow2_at_least(k) >> 1; off > 0; off >>= 1)
    s = s + __shfl_xor_sync(kFull, s, off);
  const float d = __fmaf_rn(-w, s, t);

  const int base = (threadIdx.x & 31) & ~(G - 1);
  float dv[KMAX];
  int cv[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    dv[r] = 0.0f;
    cv[r] = -1;
    if (r < k) {
      dv[r] = __shfl_sync(kFull, d, base + r);
      cv[r] = __shfl_sync(kFull, col, base + r);
    }
  }
  if (!gr.live) return;
  float* out = dlogits + (long long)gr.seg * K;
  for (int c = 4 * lg; c < K; c += 4 * G) {
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = 0.0f;
#pragma unroll
      for (int r = 0; r < KMAX; ++r)
        if (cv[r] == c + e) a[e] = a[e] + dv[r];
    }
    if (vec) {
      *reinterpret_cast<float4*>(out + c) = make_float4(a[0], a[1], a[2],
                                                        a[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < K) out[c + e] = a[e];
    }
  }
}

// The group width for K columns and top k (the design note).
int group_width(int K, int k) {
  int g = 1;
  while (g < (K + kRegCols - 1) / kRegCols) g <<= 1;
  while (g < k) g <<= 1;
  return g < 32 ? g : 32;
}

template <int KMAX>
const void* kernel_of(bool backward) {
  return backward ? reinterpret_cast<const void*>(&topk_codes_bwd_kernel<KMAX>)
                  : reinterpret_cast<const void*>(&topk_codes_kernel<KMAX>);
}

// The instantiation for top k: KMAX 4, 8 or 16.
const void* kernel_for(int k, bool backward) {
  if (k < 1) return nullptr;
  if (k <= 4) return kernel_of<4>(backward);
  if (k <= 8) return kernel_of<8>(backward);
  if (k <= 16) return kernel_of<16>(backward);
  return nullptr;
}

bool launch_shape(long long segs, int K, int L, int k, int* G,
                  int* blocks) {
  if (segs < 0 || segs > INT_MAX - kThreads || K < 1 || L < 1 || k < 1 ||
      k > 16 || k > K)
    return false;
  *G = group_width(K, k);
  *blocks = (int)((segs * *G + kThreads - 1) / kThreads);
  return true;
}

// Rows of 16-byte chunks: K a multiple of 4 and the base 16-byte aligned.
bool vector_rows(const void* p, int K) {
  return K % 4 == 0 && reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// logits [segs, K] f32 (segs = N·L: each row of [N, L·K] is L segments);
// weights and indices [segs, k], the indices offset by (segment % L)·K.
extern "C" int lsv2_topk_codes(const float* logits, long long segs, int K,
                               int L, int k, float* weights,
                               long long* indices, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  int G = 0, blocks = 0;
  if (!launch_shape(segs, K, L, k, &G, &blocks) || logits == nullptr ||
      weights == nullptr || indices == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segs == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_rows(logits, K);
#define LSV2_TOPK(KM)                                        \
  topk_codes_kernel<KM><<<blocks, kThreads, 0, st>>>(        \
      logits, (int)segs, K, L, k, G, vec, weights, indices)
  if (k <= 4) LSV2_TOPK(4);
  else if (k <= 8) LSV2_TOPK(8);
  else LSV2_TOPK(16);
#undef LSV2_TOPK
  return static_cast<int>(cudaGetLastError());
}

// dweights, weights, indices [segs, k] (the forward's outputs and the
// weights' gradient); dlogits [segs, K], every element written.
extern "C" int lsv2_topk_codes_bwd(const float* dweights,
                                   const float* weights,
                                   const long long* indices, long long segs,
                                   int K, int L, int k, float* dlogits,
                                   void* stream) {
  cudaGetLastError();
  int G = 0, blocks = 0;
  if (!launch_shape(segs, K, L, k, &G, &blocks) || dweights == nullptr ||
      weights == nullptr || indices == nullptr || dlogits == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segs == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_rows(dlogits, K);
#define LSV2_TOPK_BWD(KM)                                                 \
  topk_codes_bwd_kernel<KM><<<blocks, kThreads, 0, st>>>(                 \
      dweights, weights, indices, (int)segs, K, L, k, G, vec, dlogits)
  if (k <= 4) LSV2_TOPK_BWD(4);
  else if (k <= 8) LSV2_TOPK_BWD(8);
  else LSV2_TOPK_BWD(16);
#undef LSV2_TOPK_BWD
  return static_cast<int>(cudaGetLastError());
}

// The occupancy of the instantiation for top k, forward or backward.
extern "C" int lsv2_topk_codes_occupancy(int k, int backward, int* out) {
  cudaGetLastError();
  const void* fn = kernel_for(k, backward != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
