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
// accumulate d_phi / d_G in a block revisited by every grid step.
//
// Both are one kernel, gram_kernel<kPk, kBwd, kAny>; K6a is its first stage
// alone. On this card K6a is bound by the bytes of the map (134 MB at
// 544x960, M = 64: 0.04 ms) and K6b by those and the d_w write at M = 64 and
// by its products at M = 192 (2 M^2 + 2 M K operations a pixel). As scalar
// loops the products (W.G and W^T.(d_n2 w_l)) cost a shared-memory load an
// FMA (a one-thread-a-pixel K6a spent ~0.26 of its 0.385 ms so on an H100
// at 544x960, M = 64); they run on the tensor cores, f32-accurate with the
// 3xTF32 split (mma.sync m16n8k8 TF32; x = big + small, a.b ~ as.bb +
// ab.bs + ab.bb).
// Persistent blocks of 8 warps walk 128-pixel chunks (half tiles: d_phi and
// d_G are sums over pixels, so the tile is only a layout; K6a adds each
// chunk's sum onto its tile's zeroed entry, two addends onto 0 in either
// order give the same float). A chunk's w [128, M] is copied with cp.async
// into a shared stage of row stride 64 kPk + 8; with one k-panel (kPk = 1)
// two stages, the next chunk's copy running while this one computes.
// Per chunk:
//  (1) each warp forms WG = W.G for its 16 pixels a 64-column panel at a
//      time, A from the stage, B from G's split fragments (64 x 64 blocks
//      of G, below); n2 and num come from the accumulators (quad
//      shuffles), then the chain. K6a: each pixel's sim, summed by warp
//      shuffles and across the 8 warps in a fixed order. K6b: d_w[p, lo+k]
//      = d_num phi[s, lo+k] + 2 d_n2 WG[p, lo+k] from the last panel's
//      accumulators (the output columns are ordered so that layer lay's
//      come last), zeros outside layer lay's columns;
//  (2) d_phi (K6b): each warp takes 32 of the chunk's pixels and 32 of the
//      layer's columns; __match_any_sync groups the 32 pixels by segment
//      (-1 pixels take no part), and for each group a lane sums its
//      column's d_num w[lo+k] over the group's pixels in pixel order and
//      adds once: one atomic per (segment, 32 pixels, column);
//  (3) d_G[i, k] += sum_q w[q, i] d_n2[q] w[q, lo+k] on the tensor cores
//      (K6b), the chunk's pixels the reduction: warp w owns columns
//      [8w, 8w+8) and every 16-row tile of d_G, its accumulators in
//      registers across all of the block's chunks; at the end one atomic
//      add per d_G element per block (sums across blocks change order from
//      run to run).
// Where G lives: a first small kernel writes G's B fragments, split, to a
// scratch buffer in 64 x 64 blocks of 32 KB. With one block (M <= 64) each
// block of threads copies G into shared memory once; else its blocks stream
// from L2 through a ring of two 32 KB slots, the next block's cp.async
// running while this one multiplies, so a chunk reads G once from L2
// (288 KB at M = 192) where a warp reading its fragments alone would read
// it eight times. K6b: one block of 8 warps an SM at kPk >= 2 (the stage,
// the ring and the 4 kPk d_G accumulators a warp), two at kPk = 1 (one
// with run-time widths, whose registers would not fit two); K6a: two at
// kPk = 1.
//
// Shapes (every M and K the Pallas kernels take; ops/gram.py::kernel_plan
// plans the launches, the `Pass` below carries one). kAny = false is the
// code for K = 64 and M = 64 kPk (K6a: any M = 64 kPk) on a map width that
// is a multiple of 4, with its widths compile-time. kAny = true reads them
// at run time: M is padded to the kPk k-panels with zeros (the stage's
// columns past M are zeroed once and G's split blocks are zero past M); the
// output columns are reordered, others first and layer lay's block last,
// each group padded to 64; the map is copied 4 bytes at a time where its
// row is not a whole number of 16-byte vectors, and d_w is stored a float
// at a time. Layer lay's columns go in blocks of at most 64, one launch
// each (K > 64), and M > 256 runs unstaged (kPk = 0: A fragments read from
// device memory, zero past M) with d_G in row blocks of 128, one launch
// each; a launch that is not the first of its layer block writes only d_G.
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "phase_marks.cuh"

// Phases (profile_query_gram.py): K6b: 0 prologue, 1 waiting for the
// chunk's stage, 2 (1) W.G + chain + d_w, 3 barriers, 4 (2) d_phi, 5 (3)
// d_G, 6 the d_G flush; K6a: 0 prologue, 1 stage wait, 2 (1) W.G + chain +
// sim, 3 the chunk's sum and its barrier.
PHASE_STORAGE(g_gram_phase, lsv2_gram_phases)

namespace {

constexpr int kChunk = 128;        // pixels a chunk (half a tile)
constexpr int kThreads = 256;      // 8 warps: 16 pixels each in W.G
constexpr int kPanel = 64;         // G's split blocks are kPanel^2
constexpr int kMaxStagePanels = 4; // widest stage: 256 columns
constexpr int kRowBlock = 128;     // d_G rows of an unstaged launch

// One launch's widths (kAny; the fast instantiations use their constants).
struct Pass {
  int M;          // G [M, M]
  int K;          // row stride of d_phi and d_G (the layer's width)
  int n_k;        // contraction k-panels: ceil(M / 64)
  int n_out;      // output column panels
  int no, po;     // output columns before layer lay's block, padded to 64
  int c0, kb;     // the block: map columns [c0, c0 + kb), kb <= 64
  int j0;         // its first column in d_phi and d_G
  int r0;         // the first d_G row this launch accumulates (unstaged)
  int dw;         // write d_w and d_phi (the launch of row block 0)
  int zero_rest;  // write d_w's zeros outside [c0, c0 + kb) (the first)
};

template <int kPk, bool kBwd, bool kAny>
struct Cfg {
  static_assert(kAny || kPk > 0, "the fast instantiations are staged");
  static constexpr bool kStaged = kPk > 0;
  static constexpr int kW = kPanel * kPk;          // stage columns
  static constexpr int kStride = kW + 8;           // stage row stride
  static constexpr int kStages = kPk == 1 ? 2 : (kStaged ? 1 : 0);
  static constexpr bool kGRes = kPk == 1;          // G's one block resident
  static constexpr int kRT = kStaged ? 4 * kPk : kRowBlock / 16;  // d_G rows
  static constexpr int kMinBlocks = kPk == 1 && !(kAny && kBwd) ? 2 : 1;
  static constexpr int kLo = kW - kPanel;          // fast K6b: layer lay
  static constexpr int kStageFloats = kChunk * kStride;
  // A 64 x 64 block of G, split into big and small: 2048 uint4 (32 KB).
  static constexpr int kBlockVec = kPanel * kPanel * 2 / 4;
  static constexpr int kGVec = kGRes ? kBlockVec : 2 * kBlockVec;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kStages * kStageFloats + 4 * kGVec +
                       (kBwd ? 3 * kChunk : kThreads / 32));
};

// Map column of output column n (-1: padding): the columns outside layer
// lay's block in order, padded to po, then the block, padded to 64.
__host__ __device__ __forceinline__ int out_col(const Pass& p, int n) {
  if (n < p.po) return n < p.no ? (n < p.c0 ? n : n + p.kb) : -1;
  const int j = n - p.po;
  return j < p.kb ? p.c0 + j : -1;
}

// G [M, M] as W.G's B fragments, split for 3xTF32, in 64 x 64 blocks
// (output panel np, k-panel kp) of 32 KB: entry ((np * n_k + kp) * 64 +
// ks8 * 8 + nt8) * 32 + lane holds (big b0, big b1, small b0, small b1)
// with b0 = G[8ks + t4][col(8nt + g)], b1 = G[8ks + t4 + 4][col(8nt + g)],
// ks = 8kp + ks8, nt = 8np + nt8; 0 past M and in padded columns.
__global__ void gram_split_kernel(const float* __restrict__ gfull, Pass p,
                                  uint4* __restrict__ gs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_out * p.n_k * 64 * 32) return;
  const int lane = i & 31, r = i >> 5;
  const int blk = r >> 6, kp = blk % p.n_k, np = blk / p.n_k;
  const int ks = 8 * kp + ((r >> 3) & 7), nt = 8 * np + (r & 7);
  const int g = lane >> 2, t4 = lane & 3;
  const int col = out_col(p, 8 * nt + g);
  const int k0 = 8 * ks + t4, k1 = k0 + 4;
  unsigned bb0, bs0, bb1, bs1;
  split_tf32(col >= 0 && k0 < p.M ? gfull[(size_t)k0 * p.M + col] : 0.0f,
             bb0, bs0);
  split_tf32(col >= 0 && k1 < p.M ? gfull[(size_t)k1 * p.M + col] : 0.0f,
             bb1, bs1);
  gs[i] = make_uint4(bb0, bb1, bs0, bs1);
}

struct Grads {
  float d_num, d_n2;
};

// The chain of pallas_gram._chain for one pixel.
__device__ __forceinline__ float pixel_sim(float n2, float num, float gtn,
                                           float eps) {
  const bool covered = n2 > 0.0f;
  const float n2g = covered ? n2 : 1.0f;
  const float nrm = covered ? sqrtf(n2g) : 0.0f;
  return num / (fmaxf(nrm, eps) * fmaxf(gtn, eps));
}

// The chain's gradients for one pixel, as the Pallas `_chain` / `_dmax`.
__device__ __forceinline__ Grads chain_grads(float n2, float num, float gtn,
                                             float eps, float d_sim) {
  const bool covered = n2 > 0.0f;
  const float n2g = covered ? n2 : 1.0f;
  const float nrm = covered ? sqrtf(n2g) : 0.0f;
  const float a = fmaxf(nrm, eps), b = fmaxf(gtn, eps);
  const float inv_ab = 1.0f / (a * b);
  const float d_a = -d_sim * num * inv_ab / a;
  const float dmax = nrm > eps ? 1.0f : (nrm == eps ? 0.5f : 0.0f);
  return {d_sim * inv_ab, covered ? d_a * dmax * 0.5f / sqrtf(n2g) : 0.0f};
}

// G's split block `blk` (32 KB) into a ring slot, 16 bytes a thread.
template <class B>
__device__ __forceinline__ void load_gblock(const uint4* __restrict__ gsplit,
                                            int blk, uint4* dst) {
  const uint4* src = gsplit + (size_t)blk * B::kBlockVec;
  for (int i = threadIdx.x; i < B::kBlockVec; i += kThreads)
    cp_async16(dst + i, src + i);
}

// Chunk `chunk`'s w [128, M] (row stride C) into a stage: 16 bytes a copy
// where every row is whole 16-byte vectors (`vec`), else 4.
template <class B>
__device__ __forceinline__ void load_chunk(const float* __restrict__ w,
                                           int C, int M, bool vec, int chunk,
                                           float* dst) {
  const float* src = w + (size_t)chunk * kChunk * C;
  if (vec) {
    const int m4 = M / 4;
    for (int i = threadIdx.x; i < kChunk * m4; i += kThreads) {
      const int r = i / m4, c4 = i - r * m4;
      cp_async16(dst + r * B::kStride + 4 * c4, src + (size_t)r * C + 4 * c4);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * M; i += kThreads) {
      const int r = i / M, c = i - r * M;
      cp_async4(dst + r * B::kStride + c, src + (size_t)r * C + c);
    }
  }
}

// K6a (kBwd = false) / K6b (see the header). n_chunks = T * 2; each block
// walks chunks with a grid stride. K6a adds each chunk's sum of sim onto
// out[tile] (zeroed by the caller); K6b writes d_w into out and adds into
// dphi and dg.
template <int kPk, bool kBwd, bool kAny>
__global__ void __launch_bounds__(kThreads, Cfg<kPk, kBwd, kAny>::kMinBlocks)
    gram_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                const float* __restrict__ rhs,
                const uint4* __restrict__ gsplit, int n_chunks, int C, Pass p,
                float eps, float inv_hw, const float* __restrict__ upstream,
                float* __restrict__ out, float* __restrict__ dphi,
                float* __restrict__ dg) {
  using B = Cfg<kPk, kBwd, kAny>;
  constexpr int kS = B::kStride, kLo = B::kLo;
  const int M = kAny ? p.M : B::kW;
  const int n_k = kAny ? p.n_k : kPk;
  const int n_out = kAny ? p.n_out : kPk;
  const int n_steps = n_out * n_k;            // G's blocks a chunk
  extern __shared__ __align__(16) float smem[];
  uint4* s_g = reinterpret_cast<uint4*>(smem + B::kStages * B::kStageFloats);
  float* s_dnum = reinterpret_cast<float*>(s_g + B::kGVec);
  float* s_dn2 = s_dnum + kChunk;
  int* s_seg = reinterpret_cast<int*>(s_dn2 + kChunk);
  float* s_part = s_dnum;                     // K6a: the warps' sums
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float d_sim = kBwd ? -inv_hw * upstream[0] : 0.0f;
  const bool vec = !kAny || (C % 4 == 0 && M % 4 == 0 &&
                              (reinterpret_cast<size_t>(w) & 15) == 0);
  PHASE_BEGIN

  if (kAny && B::kStaged) {
    // The stages' columns past M stay zero (the copies write [0, M)).
    for (int i = tid; i < B::kStages * B::kStageFloats; i += kThreads)
      smem[i] = 0.0f;
    __syncthreads();
  }
  if (B::kStages == 2 && blockIdx.x < n_chunks) {
    load_chunk<B>(w, C, M, vec, blockIdx.x, smem);
    cp_async_commit();
  }
  if (B::kGRes)
    for (int i = tid; i < B::kBlockVec; i += kThreads) s_g[i] = gsplit[i];

  // d_G [M, K]: warp w owns columns [8w, 8w + 8), every row tile.
  float dga[kBwd ? B::kRT : 1][4];
#pragma unroll
  for (int mt = 0; mt < (kBwd ? B::kRT : 1); ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dga[mt][e] = 0.0f;

  PHASE_MARK(0)
  int it = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
    float* ws = smem + (B::kStages == 2 ? (it & 1) * B::kStageFloats : 0);
    const float* wg_rows = w + (size_t)c * kChunk * C;  // unstaged reads
    // w[q, k] of this chunk: the stage, or device memory (0 past M).
    auto W = [&](int q, int k) -> float {
      if constexpr (B::kStaged) {
        return ws[q * kS + k];
      } else {
        return k < M ? __ldg(wg_rows + (size_t)q * C + k) : 0.0f;
      }
    };
    if (B::kStages == 2) {
      const int nxt = c + gridDim.x;
      if (nxt < n_chunks) {
        load_chunk<B>(w, C, M, vec, nxt,
                      smem + ((it + 1) & 1) * B::kStageFloats);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {   // the stage and G's first block, one group (awaited below)
      if (B::kStaged) load_chunk<B>(w, C, M, vec, c, ws);
      load_gblock<B>(gsplit, 0, s_g);
      cp_async_commit();
    }
    if (B::kGRes) __syncthreads();
    PHASE_MARK(1)
    PHASE_COUNT()

    // (1) W.G for rows ra = 16 warp + g and rb = ra + 8, a 64-column panel
    // at a time; the last panel (K6b: layer lay's block) stays in
    // registers.
    const int ra = warp * 16 + g, rb = ra + 8;
    const size_t pa = (size_t)c * kChunk + ra, pb = pa + 8;
    const int sa = seg[pa], sb = seg[pb];
    const float* rowa = sa >= 0 ? rhs + (size_t)sa * (M + 1) : nullptr;
    const float* rowb = sb >= 0 ? rhs + (size_t)sb * (M + 1) : nullptr;
    float n2a = 0.0f, n2b = 0.0f, numa = 0.0f, numb = 0.0f;
    float acc[kPanel / 8][4];
#pragma unroll 1
    for (int panel = 0; panel < n_out; ++panel) {
#pragma unroll
      for (int nt = 0; nt < kPanel / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 1
      for (int kp = 0; kp < n_k; ++kp) {
        const uint4* gblk = s_g;
        if (!B::kGRes) {
          // G's blocks in a ring of two: block s + 1 is copied while block
          // s multiplies (its slot freed by the barrier after block s - 1).
          const int step = panel * n_k + kp;
          if (step + 1 < n_steps) {
            load_gblock<B>(gsplit, step + 1,
                           s_g + ((step + 1) & 1) * B::kBlockVec);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          if (step == 0) {
            PHASE_MARK(1)
          }
          gblk = s_g + (step & 1) * B::kBlockVec;
        }
#pragma unroll 2
        for (int ks8 = 0; ks8 < 8; ++ks8) {
          const int k0 = kPanel * kp + 8 * ks8 + t4;
          const float a[4] = {W(ra, k0), W(rb, k0), W(ra, k0 + 4),
                              W(rb, k0 + 4)};
          unsigned ab[4], as[4];
          split4(a, ab, as);
          const uint4* bp = gblk + ks8 * 8 * 32 + lane;
          // 3xTF32 (a.b ~ as.bb + ab.bs + ab.bb), four n-tiles at a time:
          // each product runs over the four before the next, so no mma
          // waits on the one before.
#pragma unroll
          for (int n0 = 0; n0 < kPanel / 8; n0 += 4) {
            uint4 b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = bp[(n0 + j) * 32];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(acc[n0 + j], as, b[j].x, b[j].y);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(acc[n0 + j], ab, b[j].z, b[j].w);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(acc[n0 + j], ab, b[j].x, b[j].y);
          }
        }
        if (!B::kGRes) __syncthreads();   // the block's slot is free
      }
#pragma unroll
      for (int nt = 0; nt < kPanel / 8; ++nt) {
        if constexpr (!kAny) {
          const int m = panel * kPanel + 8 * nt + 2 * t4;
          const float2 wa = *reinterpret_cast<const float2*>(ws + ra * kS + m);
          const float2 wb = *reinterpret_cast<const float2*>(ws + rb * kS + m);
          n2a += acc[nt][0] * wa.x + acc[nt][1] * wa.y;
          n2b += acc[nt][2] * wb.x + acc[nt][3] * wb.y;
          if (rowa != nullptr) numa += wa.x * rowa[m] + wa.y * rowa[m + 1];
          if (rowb != nullptr) numb += wb.x * rowb[m] + wb.y * rowb[m + 1];
        } else {
          const int n = panel * kPanel + 8 * nt + 2 * t4;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = out_col(p, n + e);
            if (m < 0) continue;
            const float wa = W(ra, m), wb = W(rb, m);
            n2a += acc[nt][e] * wa;
            n2b += acc[nt][2 + e] * wb;
            if (rowa != nullptr) numa += wa * rowa[m];
            if (rowb != nullptr) numb += wb * rowb[m];
          }
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      n2a += __shfl_xor_sync(0xffffffffu, n2a, off);
      n2b += __shfl_xor_sync(0xffffffffu, n2b, off);
      numa += __shfl_xor_sync(0xffffffffu, numa, off);
      numb += __shfl_xor_sync(0xffffffffu, numb, off);
    }
    const float gta = rowa ? rowa[M] : 0.0f, gtb = rowb ? rowb[M] : 0.0f;

    if constexpr (!kBwd) {
      // K6a: the chunk's sum of sim, in a fixed order: the warp's rows by
      // shuffles, then the 8 warps' sums.
      float sim = t4 == 0 ? pixel_sim(n2a, numa, gta, eps) +
                                pixel_sim(n2b, numb, gtb, eps)
                          : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sim += __shfl_down_sync(0xffffffffu, sim, off);
      if (lane == 0) s_part[warp] = sim;
      PHASE_MARK(2)
      __syncthreads();
      if (tid == 0) {
        float total = 0.0f;
#pragma unroll
        for (int i = 0; i < kThreads / 32; ++i) total += s_part[i];
        atomicAdd(out + c / 2, total);
      }
      PHASE_MARK(3)
    } else {
      const Grads ga = chain_grads(n2a, numa, gta, eps, d_sim);
      const Grads gb = chain_grads(n2b, numb, gtb, eps, d_sim);
      if (t4 == 0) {
        s_dnum[ra] = ga.d_num;
        s_dnum[rb] = gb.d_num;
        s_dn2[ra] = ga.d_n2;
        s_dn2[rb] = gb.d_n2;
        s_seg[ra] = sa;
        s_seg[rb] = sb;
      }
      float* dw = out;
      if constexpr (!kAny) {
        // d_w in layer lay's columns from the accumulators, 8 bytes a lane
        // (whole 32-byte sectors a row); zeros elsewhere.
#pragma unroll
        for (int nt = 0; nt < kPanel / 8; ++nt) {
          const int col = kLo + 8 * nt + 2 * t4;
          const float2 pa2 = rowa ? make_float2(rowa[col], rowa[col + 1])
                                  : make_float2(0.0f, 0.0f);
          const float2 pb2 = rowb ? make_float2(rowb[col], rowb[col + 1])
                                  : make_float2(0.0f, 0.0f);
          *reinterpret_cast<float2*>(dw + pa * C + col) =
              make_float2(ga.d_num * pa2.x + 2.0f * ga.d_n2 * acc[nt][0],
                          ga.d_num * pa2.y + 2.0f * ga.d_n2 * acc[nt][1]);
          *reinterpret_cast<float2*>(dw + pb * C + col) =
              make_float2(gb.d_num * pb2.x + 2.0f * gb.d_n2 * acc[nt][2],
                          gb.d_num * pb2.y + 2.0f * gb.d_n2 * acc[nt][3]);
        }
        if (C > kPanel) {
          float* rows = dw + ((size_t)c * kChunk + warp * 16) * C;
          for (int i = lane; i < 16 * (C / 4); i += 32) {
            const int r = i / (C / 4), c4 = 4 * (i - r * (C / 4));
            if (c4 < kLo || c4 >= kLo + kPanel)
              *reinterpret_cast<float4*>(rows + (size_t)r * C + c4) =
                  make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      } else {
        // The block's kb columns a float at a time; the launch of the
        // first block writes the zeros of every other column.
        if (p.dw) {
#pragma unroll
          for (int nt = 0; nt < kPanel / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * nt + 2 * t4 + e;
              if (j >= p.kb) continue;
              const int col = p.c0 + j;
              dw[pa * C + col] = ga.d_num * (rowa ? rowa[col] : 0.0f) +
                                 2.0f * ga.d_n2 * acc[nt][e];
              dw[pb * C + col] = gb.d_num * (rowb ? rowb[col] : 0.0f) +
                                 2.0f * gb.d_n2 * acc[nt][2 + e];
            }
        }
        if (p.zero_rest) {
          float* rows = dw + ((size_t)c * kChunk + warp * 16) * C;
          for (int i = lane; i < 16 * C; i += 32) {
            const int r = i / C, col = i - r * C;
            if (col < p.c0 || col >= p.c0 + p.kb)
              rows[(size_t)r * C + col] = 0.0f;
          }
        }
      }
      PHASE_MARK(2)
      __syncthreads();
      PHASE_MARK(3)

      // (2) d_phi: warp w takes the chunk's pixels [32 (w % 4), + 32) and
      // the block's columns [32 (w / 4), + 32), a column a lane.
      // __match_any_sync groups the 32 pixels by segment (-1 pixels take no
      // part); for each group every lane sums d_num * w[lo + k] over the
      // group's pixels in pixel order and adds once: one atomic per
      // (segment, 32 pixels, column).
      if (!kAny || p.dw) {
        const int q0 = 32 * (warp & 3);
        const int k = 32 * (warp >> 2) + lane;
        const bool kv = !kAny || k < p.kb;
        const int col = kAny ? p.c0 + k : kLo + k;
        const int s = s_seg[q0 + lane];
        const unsigned grp =
            __match_any_sync(0xffffffffu, s >= 0 ? s : -1 - lane);
        unsigned leaders =
            __ballot_sync(0xffffffffu, s >= 0 && __ffs(grp) - 1 == lane);
        while (leaders != 0u) {
          const int ld = __ffs(leaders) - 1;
          leaders &= leaders - 1u;
          const unsigned grp_l = __shfl_sync(0xffffffffu, grp, ld);
          const int s_l = __shfl_sync(0xffffffffu, s, ld);
          float v = 0.0f;
          if (kv) {
            if (grp_l == 1u << ld) {
              v = s_dnum[q0 + ld] * W(q0 + ld, col);
            } else {
#pragma unroll
              for (int j = 0; j < 32; ++j)
                if (grp_l & (1u << j)) v += s_dnum[q0 + j] * W(q0 + j, col);
            }
            atomicAdd(dphi + (size_t)s_l * (kAny ? p.K : kPanel) +
                          (kAny ? p.j0 : 0) + k,
                      v);
          }
        }
      }

      PHASE_MARK(4)
      // (3) d_G[i, k] += sum_q w[q, i] (d_n2[q] w[q, lo + k]): the chunk's
      // pixels are the reduction; warp w's columns k = 8w + n.
      const int kcol = 8 * warp + g;
      const bool kcv = !kAny || kcol < p.kb;
      const int wcol = kAny ? p.c0 + kcol : kLo + kcol;
      const int r0 = kAny ? p.r0 : 0;
#pragma unroll 2
      for (int ps = 0; ps < kChunk / 8; ++ps) {
        const int q0 = 8 * ps + t4, q1 = q0 + 4;
        unsigned ub0, us0, ub1, us1;
        split_tf32(kcv ? s_dn2[q0] * W(q0, wcol) : 0.0f, ub0, us0);
        split_tf32(kcv ? s_dn2[q1] * W(q1, wcol) : 0.0f, ub1, us1);
        // Row tiles kGroup at a time (fewer where the row-tile
        // accumulators leave few registers), each product over the group
        // before the next.
        constexpr int kGroup = kPk == 1 ? 4 : 2;
#pragma unroll
        for (int m0 = 0; m0 < B::kRT; m0 += kGroup) {
          unsigned ab[kGroup][4], as[kGroup][4];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int i = r0 + 16 * (m0 + j) + g;
            const float a[4] = {W(q0, i), W(q0, i + 8), W(q1, i),
                                W(q1, i + 8)};
            split4(a, ab[j], as[j]);
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            mma_tf32(dga[m0 + j], as[j], ub0, ub1);
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            mma_tf32(dga[m0 + j], ab[j], us0, us1);
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            mma_tf32(dga[m0 + j], ab[j], ub0, ub1);
        }
      }
      PHASE_MARK(5)
      __syncthreads();   // the stage and the arrays are free
      PHASE_MARK(3)
    }
  }
  if constexpr (kBwd) {
    if (blockIdx.x < n_chunks) {
#pragma unroll
      for (int mt = 0; mt < B::kRT; ++mt) {
        if constexpr (!kAny) {
          float* r0 = dg + (size_t)(16 * mt + g) * kPanel + 8 * warp + 2 * t4;
          float* r1 = r0 + 8 * kPanel;
          atomicAdd(r0, dga[mt][0]);
          atomicAdd(r0 + 1, dga[mt][1]);
          atomicAdd(r1, dga[mt][2]);
          atomicAdd(r1 + 1, dga[mt][3]);
        } else {
          const int j = 8 * warp + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = p.r0 + 16 * mt + g + 8 * h;
            if (i >= M) continue;
            float* row = dg + (size_t)i * p.K + p.j0;
            if (j < p.kb) atomicAdd(row + j, dga[mt][2 * h]);
            if (j + 1 < p.kb) atomicAdd(row + j + 1, dga[mt][2 * h + 1]);
          }
        }
      }
    }
    PHASE_MARK(6)
  }
  PHASE_END(g_gram_phase)
}

template <int kPk, bool kBwd, bool kAny>
int occupancy(int* out) {
  using B = Cfg<kPk, kBwd, kAny>;
  cudaGetLastError();
  auto kernel = gram_kernel<kPk, kBwd, kAny>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)B::kSmem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  return 0;
}

template <int kPk, bool kBwd, bool kAny>
int launch(const int* seg, const float* w, const float* rhs,
           const float* gfull, int num_tiles, int C, const Pass& p,
           float eps, float inv_hw, const float* upstream, float* out,
           float* dphi, float* dg, float* gsplit, cudaStream_t stream) {
  int occ[5];
  int err = occupancy<kPk, kBwd, kAny>(occ);
  if (err != 0) return err;
  if (occ[0] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_split = p.n_out * p.n_k * 64 * 32;
  gram_split_kernel<<<(n_split + 255) / 256, 256, 0, stream>>>(
      gfull, p, reinterpret_cast<uint4*>(gsplit));
  const int n_chunks = num_tiles * (256 / kChunk);
  const int grid = n_chunks < sms * occ[0] ? n_chunks : sms * occ[0];
  if (grid > 0) {
    gram_kernel<kPk, kBwd, kAny>
        <<<grid, kThreads, Cfg<kPk, kBwd, kAny>::kSmem, stream>>>(
            seg, w, rhs, reinterpret_cast<const uint4*>(gsplit), n_chunks, C,
            p, eps, inv_hw, upstream, out, dphi, dg);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation (kpk, bwd, any) of f, or cudaErrorInvalidValue.
template <template <int, bool, bool> class F, typename... Args>
int dispatch(int kpk, int bwd, int any, Args... args) {
  switch ((any ? 100 : 0) + (bwd ? 10 : 0) + kpk) {
    case 1: return F<1, false, false>::run(args...);
    case 2: return F<2, false, false>::run(args...);
    case 3: return F<3, false, false>::run(args...);
    case 4: return F<4, false, false>::run(args...);
    case 11: return F<1, true, false>::run(args...);
    case 12: return F<2, true, false>::run(args...);
    case 13: return F<3, true, false>::run(args...);
    case 14: return F<4, true, false>::run(args...);
    case 100: return F<0, false, true>::run(args...);
    case 101: return F<1, false, true>::run(args...);
    case 102: return F<2, false, true>::run(args...);
    case 103: return F<3, false, true>::run(args...);
    case 104: return F<4, false, true>::run(args...);
    case 110: return F<0, true, true>::run(args...);
    case 111: return F<1, true, true>::run(args...);
    case 112: return F<2, true, true>::run(args...);
    case 113: return F<3, true, true>::run(args...);
    case 114: return F<4, true, true>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kPk, bool kBwd, bool kAny>
struct Launch {
  template <typename... Args>
  static int run(Args... args) { return launch<kPk, kBwd, kAny>(args...); }
};

template <int kPk, bool kBwd, bool kAny>
struct Occupancy {
  static int run(int* out) { return occupancy<kPk, kBwd, kAny>(out); }
};

}  // namespace

// One launch of K6a (bwd = 0) or K6b (bwd = 1), instantiation (kpk, any),
// with the widths pass[12] = M, K, n_k, n_out, no, po, c0, kb, j0, r0, dw,
// zero_rest (ops/gram.py::kernel_plan). K6a adds into out [T] (zeroed by
// the caller); K6b writes d_w into out [T, 256, C] where pass says and adds
// into dphi [S, K] and dg [M, K] (zeroed by the caller). gsplit: scratch of
// 2 * 64^2 * n_out * n_k floats (G's split B fragments).
extern "C" int lsv2_gram(int bwd, int kpk, int any, const int* seg,
                         const float* w, const float* rhs, const float* gfull,
                         int num_tiles, int C, const int* pass, float eps,
                         float inv_hw, const float* upstream, float* out,
                         float* dphi, float* dg, float* gsplit,
                         void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  const Pass p{pass[0], pass[1], pass[2], pass[3], pass[4], pass[5],
               pass[6], pass[7], pass[8], pass[9], pass[10], pass[11]};
  const bool staged = kpk > 0;
  const bool fast_ok = !any && C % 4 == 0 && p.M == kPanel * kpk &&
                       p.n_k == kpk && p.n_out == kpk &&
                       (!bwd || (p.K == kPanel && p.c0 == p.M - kPanel &&
                                 p.kb == kPanel && p.dw && p.zero_rest));
  if (p.M < 1 || p.M > C || kpk < 0 || kpk > kMaxStagePanels ||
      p.n_k != (p.M + kPanel - 1) / kPanel || (staged && p.n_k > kpk) ||
      (!staged && !any) || (!any && !fast_ok) ||
      (kpk == 1 && p.n_out * p.n_k != 1) ||
      (bwd && (p.kb < 1 || p.kb > kPanel || p.c0 < 0 || p.c0 + p.kb > p.M ||
               p.j0 + p.kb > p.K || p.n_out != p.po / kPanel + 1 ||
               (!staged && (p.r0 < 0 || p.r0 >= p.M)))) ||
      (!bwd && p.n_out != p.n_k))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Launch>(kpk, bwd, any, seg, w, rhs, gfull, num_tiles, C, p,
                          eps, inv_hw, upstream, out, dphi, dg, gsplit,
                          static_cast<cudaStream_t>(stream));
}

// The occupancy of instantiation (kpk, bwd, any): blocks an SM, dynamic
// shared bytes, registers a thread, local bytes a thread, threads a block.
extern "C" int lsv2_gram_occupancy(int bwd, int kpk, int any, int* out) {
  return dispatch<Occupancy>(kpk, bwd, any, out);
}
