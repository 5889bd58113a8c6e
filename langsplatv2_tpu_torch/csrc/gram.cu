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
// K6a: one block of 256 threads takes one tile, one thread per pixel. The
// tile's w is staged transposed in shared memory ([M][257], conflict-free
// per pixel) and G beside it ([M][M+1]) where both fit (M <= 128; at M = 192
// G is read from device memory through L1/L2, its reads uniform across a
// warp). Each pixel reads its rhs row from device memory by segment id (S
// rows of M+1 floats stay in L2). n2 runs as 16-row register blocks of G w.
//
// K6b is bound on this card by bytes at M = 64 (the w read and the d_w
// write, 134 MB each at 544x960 with C = 64) and by its products at M = 192
// (2 M^2 + 2 M K operations a pixel). As scalar loops its two products
// (W.G and W^T.(d_n2 w_l)) would cost a shared-memory load an FMA; they run
// on the tensor cores, f32-accurate with the 3xTF32 split (mma.sync
// m16n8k8 TF32; x = big + small, a.b ~ as.bb + ab.bs + ab.bb).
// Persistent blocks of 8 warps walk 128-pixel chunks (half tiles: d_phi and
// d_G are sums over pixels, so the tile is only a layout). A chunk's w
// [128, M] is copied with cp.async into a shared stage of row stride M + 8;
// at M = 64 two stages, the next chunk's copy running while this one
// computes. Per chunk:
//  (1) each warp forms WG = W.G for its 16 pixels a 64-column panel at a
//      time, A from the stage, B from G's split fragments (64 x 64 blocks
//      of G, below); n2 and num come from the accumulators (quad
//      shuffles), then the chain, and d_w[p, lo+k] = d_num phi[s, lo+k] +
//      2 d_n2 WG[p, lo+k] from the last panel's accumulators, stored 8
//      bytes a lane (whole sectors a row), zeros outside layer lay's
//      columns;
//  (2) d_phi: each warp takes 32 of the chunk's pixels and 32 of the K
//      columns; __match_any_sync groups the 32 pixels by segment (-1
//      pixels take no part), and for each group a lane sums its column's
//      d_num w[lo+k] over the group's pixels in pixel order and adds once:
//      one atomic per (segment, 32 pixels, column);
//  (3) d_G[i, k] += sum_q w[q, i] d_n2[q] w[q, lo+k] on the tensor cores,
//      the chunk's pixels the reduction: warp w owns columns [8w, 8w+8) and
//      every 16-row tile of d_G, its accumulators in registers across all
//      of the block's chunks; at the end one atomic add per d_G element
//      per block (sums across blocks change order from run to run).
// Where G lives: a first small kernel writes G's B fragments, split, to a
// scratch buffer (2 M^2 floats) in 64 x 64 blocks of 32 KB. At M = 64 (one
// block) each block of threads copies G into shared memory once. At M = 128
// (128 KB split) and 192 (288 KB) G does not fit beside the stage: its
// blocks stream from L2 through a ring of two 32 KB slots, the next block's
// cp.async running while this one multiplies, so a chunk reads G once from
// L2 (288 KB at M = 192) where a warp reading its fragments alone would
// read it eight times. One block of 8 warps an SM there (the stage, the
// ring and the M/16 d_G accumulators a warp), two at M = 64.
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "phase_marks.cuh"

// K6b's phases (profile_query_gram.py): 0 prologue, 1 waiting for the
// chunk's stage, 2 (1) W.G + chain + d_w, 3 barriers, 4 (2) d_phi, 5 (3)
// d_G, 6 the d_G flush.
PHASE_STORAGE(g_gram_phase, lsv2_gram_phases)

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

// ---------------------------------------------------------------- K6b
constexpr int kChunk = 128;        // pixels a chunk (half a tile)
constexpr int kBwdThreads = 256;   // 8 warps: 16 pixels each in W.G
constexpr int kLayerK = 64;        // K: codebook rows a layer

template <int kM>
struct Bwd {
  static constexpr int kStride = kM + 8;   // W stage row stride (floats)
  static constexpr int kStages = kM == 64 ? 2 : 1;
  static constexpr int kPanels = kM / 64;  // 64-wide panels of G's rows / columns
  static constexpr int kMinBlocks = kM == 64 ? 2 : 1;
  static constexpr int kLo = kM - kLayerK;  // layer lay = kM / 64 - 1
  static constexpr int kStageFloats = kChunk * kStride;
  // A 64 x 64 block of G, split into big and small: 2048 uint4 (32 KB).
  static constexpr int kBlockVec = 64 * 64 * 2 / 4;
  // M = 64: G whole; else a ring of two blocks.
  static constexpr int kGVec = kM == 64 ? kBlockVec : 2 * kBlockVec;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kStages * kStageFloats + 4 * kGVec +
                       3 * kChunk);
};

// G [M, M] as W.G's B fragments, split for 3xTF32, in 64 x 64 blocks
// (column panel np, row panel kp) of 32 KB: entry ((np * M/64 + kp) * 64 +
// ks8 * 8 + nt8) * 32 + lane holds (big b0, big b1, small b0, small b1)
// with b0 = G[8ks + t4][8nt + g], b1 = G[8ks + t4 + 4][8nt + g], ks = 8kp
// + ks8, nt = 8np + nt8.
__global__ void gram_split_kernel(const float* __restrict__ gfull, int M,
                                  uint4* __restrict__ gs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int panels = M / 64;
  if (i >= (M / 8) * (M / 8) * 32) return;
  const int lane = i & 31, r = i >> 5;
  const int blk = r >> 6, kp = blk % panels, np = blk / panels;
  const int ks = 8 * kp + ((r >> 3) & 7), nt = 8 * np + (r & 7);
  const int g = lane >> 2, t4 = lane & 3;
  unsigned bb0, bs0, bb1, bs1;
  split_tf32(gfull[(8 * ks + t4) * M + 8 * nt + g], bb0, bs0);
  split_tf32(gfull[(8 * ks + t4 + 4) * M + 8 * nt + g], bb1, bs1);
  gs[i] = make_uint4(bb0, bb1, bs0, bs1);
}

struct Grads {
  float d_num, d_n2;
};

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
template <int kM>
__device__ __forceinline__ void load_gblock(const uint4* __restrict__ gsplit,
                                            int blk, uint4* dst) {
  const uint4* src = gsplit + (size_t)blk * Bwd<kM>::kBlockVec;
  for (int i = threadIdx.x; i < Bwd<kM>::kBlockVec; i += kBwdThreads)
    cp_async16(dst + i, src + i);
}

template <int kM>
__device__ __forceinline__ void load_chunk(const float* __restrict__ w,
                                           int C, int chunk, float* dst) {
  using B = Bwd<kM>;
  const float* src = w + (size_t)chunk * kChunk * C;
  for (int i = threadIdx.x; i < kChunk * (kM / 4); i += kBwdThreads) {
    const int r = i / (kM / 4), c4 = i - r * (kM / 4);
    cp_async16(dst + r * B::kStride + 4 * c4, src + (size_t)r * C + 4 * c4);
  }
}

// K6b (see the header). n_chunks = T * 2; each block walks chunks with a
// grid stride; dphi and dg are accumulated into.
template <int kM>
__global__ void __launch_bounds__(kBwdThreads, Bwd<kM>::kMinBlocks)
    gram_bwd_kernel(const int* __restrict__ seg, const float* __restrict__ w,
                    const float* __restrict__ rhs,
                    const uint4* __restrict__ gsplit, int n_chunks, int C,
                    float eps, float inv_hw, const float* __restrict__ upstream,
                    float* __restrict__ dw, float* __restrict__ dphi,
                    float* __restrict__ dg) {
  using B = Bwd<kM>;
  constexpr int kS = B::kStride, kLo = B::kLo;
  extern __shared__ __align__(16) float smem[];
  uint4* s_g = reinterpret_cast<uint4*>(smem + B::kStages * B::kStageFloats);
  float* s_dnum = reinterpret_cast<float*>(s_g + B::kGVec);
  float* s_dn2 = s_dnum + kChunk;
  int* s_seg = reinterpret_cast<int*>(s_dn2 + kChunk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float d_sim = -inv_hw * upstream[0];
  PHASE_BEGIN

  if (B::kStages == 2 && blockIdx.x < n_chunks) {
    load_chunk<kM>(w, C, blockIdx.x, smem);
    cp_async_commit();
  }
  if (B::kPanels == 1)
    for (int i = tid; i < B::kBlockVec; i += kBwdThreads) s_g[i] = gsplit[i];

  // d_G [M, K]: warp w owns columns [8w, 8w + 8), every M/16 row tile.
  float dga[kM / 16][4];
#pragma unroll
  for (int mt = 0; mt < kM / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dga[mt][e] = 0.0f;

  PHASE_MARK(0)
  int it = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
    float* ws = smem + (B::kStages == 2 ? (it & 1) * B::kStageFloats : 0);
    if (B::kStages == 2) {
      const int nxt = c + gridDim.x;
      if (nxt < n_chunks) {
        load_chunk<kM>(w, C, nxt, smem + ((it + 1) & 1) * B::kStageFloats);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {   // the stage and G's first block, one group (awaited below)
      load_chunk<kM>(w, C, c, ws);
      load_gblock<kM>(gsplit, 0, s_g);
      cp_async_commit();
    }
    if (B::kPanels == 1) __syncthreads();
    PHASE_MARK(1)
    PHASE_COUNT()

    // (1) W.G for rows ra = 16 warp + g and rb = ra + 8, a 64-column panel
    // (a layer) at a time; the last panel (layer lay) stays in registers.
    const int ra = warp * 16 + g, rb = ra + 8;
    const size_t pa = (size_t)c * kChunk + ra, pb = pa + 8;
    const int sa = seg[pa], sb = seg[pb];
    const float* rowa = sa >= 0 ? rhs + (size_t)sa * (kM + 1) : nullptr;
    const float* rowb = sb >= 0 ? rhs + (size_t)sb * (kM + 1) : nullptr;
    float n2a = 0.0f, n2b = 0.0f, numa = 0.0f, numb = 0.0f;
    float acc[kLayerK / 8][4];
#pragma unroll 1
    for (int panel = 0; panel < B::kPanels; ++panel) {
#pragma unroll
      for (int nt = 0; nt < kLayerK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 1
      for (int kp = 0; kp < B::kPanels; ++kp) {
        const uint4* gblk = s_g;
        if (B::kPanels > 1) {
          // G's blocks in a ring of two: block s + 1 is copied while block
          // s multiplies (its slot freed by the barrier after block s - 1).
          const int step = panel * B::kPanels + kp;
          if (step + 1 < B::kPanels * B::kPanels) {
            load_gblock<kM>(gsplit, step + 1,
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
          const int k0 = 64 * kp + 8 * ks8 + t4;
          const float a[4] = {ws[ra * kS + k0], ws[rb * kS + k0],
                              ws[ra * kS + k0 + 4], ws[rb * kS + k0 + 4]};
          unsigned ab[4], as[4];
          split4(a, ab, as);
          const uint4* bp = gblk + ks8 * 8 * 32 + lane;
          // 3xTF32 (a.b ~ as.bb + ab.bs + ab.bb), four n-tiles at a time:
          // each product runs over the four before the next, so no mma
          // waits on the one before.
#pragma unroll
          for (int n0 = 0; n0 < kLayerK / 8; n0 += 4) {
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
        if (B::kPanels > 1) __syncthreads();   // the block's slot is free
      }
#pragma unroll
      for (int nt = 0; nt < kLayerK / 8; ++nt) {
        const int m = panel * kLayerK + 8 * nt + 2 * t4;
        const float2 wa = *reinterpret_cast<const float2*>(ws + ra * kS + m);
        const float2 wb = *reinterpret_cast<const float2*>(ws + rb * kS + m);
        n2a += acc[nt][0] * wa.x + acc[nt][1] * wa.y;
        n2b += acc[nt][2] * wb.x + acc[nt][3] * wb.y;
        if (rowa != nullptr) numa += wa.x * rowa[m] + wa.y * rowa[m + 1];
        if (rowb != nullptr) numb += wb.x * rowb[m] + wb.y * rowb[m + 1];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      n2a += __shfl_xor_sync(0xffffffffu, n2a, off);
      n2b += __shfl_xor_sync(0xffffffffu, n2b, off);
      numa += __shfl_xor_sync(0xffffffffu, numa, off);
      numb += __shfl_xor_sync(0xffffffffu, numb, off);
    }
    const Grads ga = chain_grads(n2a, numa, rowa ? rowa[kM] : 0.0f, eps, d_sim);
    const Grads gb = chain_grads(n2b, numb, rowb ? rowb[kM] : 0.0f, eps, d_sim);
    if (t4 == 0) {
      s_dnum[ra] = ga.d_num;
      s_dnum[rb] = gb.d_num;
      s_dn2[ra] = ga.d_n2;
      s_dn2[rb] = gb.d_n2;
      s_seg[ra] = sa;
      s_seg[rb] = sb;
    }
    // d_w in layer lay's columns from the accumulators, 8 bytes a lane
    // (whole 32-byte sectors a row); zeros elsewhere.
#pragma unroll
    for (int nt = 0; nt < kLayerK / 8; ++nt) {
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
    if (C > kLayerK) {
      float* rows = dw + ((size_t)c * kChunk + warp * 16) * C;
      for (int i = lane; i < 16 * (C / 4); i += 32) {
        const int r = i / (C / 4), c4 = 4 * (i - r * (C / 4));
        if (c4 < kLo || c4 >= kLo + kLayerK)
          *reinterpret_cast<float4*>(rows + (size_t)r * C + c4) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    PHASE_MARK(2)
    __syncthreads();
    PHASE_MARK(3)

    // (2) d_phi: warp w takes the chunk's pixels [32 (w % 4), + 32) and
    // columns [32 (w / 4), + 32), a column a lane. __match_any_sync groups
    // the 32 pixels by segment (-1 pixels take no part); for each group
    // every lane sums d_num * w[lo + k] over the group's pixels in pixel
    // order and adds once: one atomic per (segment, 32 pixels, column).
    {
      const int q0 = 32 * (warp & 3);
      const int k = 32 * (warp >> 2) + lane;
      const int s = s_seg[q0 + lane];
      const unsigned grp =
          __match_any_sync(0xffffffffu, s >= 0 ? s : -1 - lane);
      unsigned leaders =
          __ballot_sync(0xffffffffu, s >= 0 && __ffs(grp) - 1 == lane);
      const float* col = ws + q0 * kS + kLo + k;
      while (leaders != 0u) {
        const int ld = __ffs(leaders) - 1;
        leaders &= leaders - 1u;
        const unsigned grp_l = __shfl_sync(0xffffffffu, grp, ld);
        const int s_l = __shfl_sync(0xffffffffu, s, ld);
        float v;
        if (grp_l == 1u << ld) {
          v = s_dnum[q0 + ld] * col[ld * kS];
        } else {
          v = 0.0f;
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (grp_l & (1u << j)) v += s_dnum[q0 + j] * col[j * kS];
        }
        atomicAdd(dphi + (size_t)s_l * kLayerK + k, v);
      }
    }

    PHASE_MARK(4)
    // (3) d_G[i, k] += sum_q w[q, i] (d_n2[q] w[q, lo + k]): the chunk's
    // pixels are the reduction; warp w's columns k = 8w + n.
#pragma unroll 2
    for (int ps = 0; ps < kChunk / 8; ++ps) {
      const int q0 = 8 * ps + t4, q1 = q0 + 4;
      unsigned ub0, us0, ub1, us1;
      split_tf32(s_dn2[q0] * ws[q0 * kS + kLo + 8 * warp + g], ub0, us0);
      split_tf32(s_dn2[q1] * ws[q1 * kS + kLo + 8 * warp + g], ub1, us1);
      // Row tiles kGroup at a time (fewer where the M / 16 accumulators
      // leave few registers), each product over the group before the next.
      constexpr int kGroup = kM == 64 ? 4 : 2;
#pragma unroll
      for (int m0 = 0; m0 < kM / 16; m0 += kGroup) {
        unsigned ab[kGroup][4], as[kGroup][4];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int i = 16 * (m0 + j) + g;
          const float a[4] = {ws[q0 * kS + i], ws[q0 * kS + i + 8],
                              ws[q1 * kS + i], ws[q1 * kS + i + 8]};
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
  if (blockIdx.x < n_chunks) {
#pragma unroll
    for (int mt = 0; mt < kM / 16; ++mt) {
      float* r0 = dg + (size_t)(16 * mt + g) * kLayerK + 8 * warp + 2 * t4;
      float* r1 = r0 + 8 * kLayerK;
      atomicAdd(r0, dga[mt][0]);
      atomicAdd(r0 + 1, dga[mt][1]);
      atomicAdd(r1, dga[mt][2]);
      atomicAdd(r1 + 1, dga[mt][3]);
    }
  }
  PHASE_MARK(6)
  PHASE_END(g_gram_phase)
}

template <int kM>
int bwd_occupancy(int* out) {
  cudaGetLastError();
  auto kernel = gram_bwd_kernel<kM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Bwd<kM>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kBwdThreads, Bwd<kM>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)Bwd<kM>::kSmem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kBwdThreads;
  return 0;
}

template <int kM>
int launch_bwd(const int* seg, const float* w, const float* rhs,
               const float* gfull, int num_tiles, int C, float eps,
               float inv_hw, const float* upstream, float* dw, float* dphi,
               float* dg, float* gsplit, cudaStream_t stream) {
  int occ[5];
  int err = bwd_occupancy<kM>(occ);
  if (err != 0) return err;
  if (occ[0] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_split = (kM / 8) * (kM / 8) * 32;
  gram_split_kernel<<<(n_split + 255) / 256, 256, 0, stream>>>(
      gfull, kM, reinterpret_cast<uint4*>(gsplit));
  const int n_chunks = num_tiles * (kPix / kChunk);
  const int grid = n_chunks < sms * occ[0] ? n_chunks : sms * occ[0];
  if (grid > 0) {
    gram_bwd_kernel<kM><<<grid, kBwdThreads, Bwd<kM>::kSmem, stream>>>(
        seg, w, rhs, reinterpret_cast<const uint4*>(gsplit), n_chunks, C, eps,
        inv_hw, upstream, dw, dphi, dg);
  }
  return static_cast<int>(cudaGetLastError());
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
// K = 64 and M = 64, 128 or 192 (layer lay = M / 64 - 1); C a multiple of 4;
// gsplit: scratch of 2 * M * M floats (G's split B fragments).
extern "C" int lsv2_gram_bwd(const int* seg, const float* w, const float* rhs,
                             const float* gfull, int num_tiles, int C, int M,
                             int K, int lay, float eps, float inv_hw,
                             const float* upstream, float* dw, float* dphi,
                             float* dg, float* gsplit, void* stream) {
  cudaGetLastError();
  if (M % kRowBlock != 0 || M > C || (lay + 1) * K != M || K != kLayerK ||
      C % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 64:
      return launch_bwd<64>(seg, w, rhs, gfull, num_tiles, C, eps, inv_hw,
                            upstream, dw, dphi, dg, gsplit, st);
    case 128:
      return launch_bwd<128>(seg, w, rhs, gfull, num_tiles, C, eps, inv_hw,
                             upstream, dw, dphi, dg, gsplit, st);
    case 192:
      return launch_bwd<192>(seg, w, rhs, gfull, num_tiles, C, eps, inv_hw,
                             upstream, dw, dphi, dg, gsplit, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6b's occupancy at M (64, 128 or 192): blocks an SM, dynamic shared
// bytes, registers a thread, local bytes a thread, threads a block.
extern "C" int lsv2_gram_bwd_occupancy(int M, int* out) {
  switch (M) {
    case 64: return bwd_occupancy<64>(out);
    case 128: return bwd_occupancy<128>(out);
    case 192: return bwd_occupancy<192>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
