// K3: Gram relevancy query over weight-map tiles.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_query.py::_query_kernel
// (pallas_call at :92, wrapper query_map_tiles). Per tile of the [T, 256, L*K]
// weight map and per level l:
//   raw[t, p, l*PQ + q] = sum_k w[k] phi[l, k, q]
//   nrm2[t, p, l]       = sum_m w[m] (sum_k w[k] gram[l, k, m])
// without writing w @ gram anywhere. The Pallas kernel lifts phi and gram to
// block-diagonal [L*K, .] matrices so that each contraction is one MXU matmul;
// here each level is its own [16 pixels x 64] . [64 x (64 + PQ')] product on
// the tensor cores (PQ' = PQ rounded up to 8), the same function without the
// zero blocks.
//
// Bound on this card: bytes, the one read of the map (1080p, L = 3: 0.80 GB
// in bf16, 1.6 GB in f32) and the small raw / nrm2 write. The products are
// 2*L*K*(K + PQ + 1) operations a pixel: ~0.03 ms at 1080p on the bf16
// tensor cores, ~0.3 ms with f32-accurate 3xTF32 tensor-core products (three
// TF32 products a product, a third of the 495 TFLOP/s TF32 rate), against
// ~0.8 ms on the CUDA cores (which is what bounded the first version).
//
// Design. A warp owns 16 pixels (one m16 row block) of a tile at a time and
// walks such items with a grid stride over all T*16 of them; the blocks are
// persistent (as many as fit on the card). The product runs on mma.sync:
//   bf16 map: m16n8k16, bf16 operands, f32 sums: the Pallas kernel's
//     function exactly (bf16 x bf16 products, f32 accumulation), with phi
//     and gram rounded to bf16 by the wrapper as the Pallas kernel casts
//     them to the map's type;
//   f32 map: m16n8k8 TF32 with the 3xTF32 split (x = big + small, both
//     TF32; a.b ~ as.bb + ab.bs + ab.bb), which keeps f32 accuracy.
// The contraction index k is permuted inside each level (k is summed, so a
// permutation applied alike to A and B changes nothing) so that a lane's A
// fragments are 16 consecutive bytes of its pixel row: each lane loads its
// two rows straight from device memory into registers, every load 16 bytes
// and every warp load whole 32-byte sectors, with no shared stage, no bank
// conflict and no barrier. The next level (or the next item's first level)
// is loaded into a second register set while this one multiplies.
// The gram product's output columns are permuted the same way, so a lane's
// accumulator columns are the k of its own A values: nrm2 = sum_m WG[p,m]
// w[p,m] is formed from registers (f32 products, as the Pallas kernel's
// HIGHEST-precision band sum) and reduced over the quad with two shuffles.
// B ([gram_l | phi_l], zero-padded to PQ') is staged once per block in
// shared memory in fragment order (one 8- or 16-byte load a lane an mma;
// in f32 mode already split into big and small). The outputs of a warp's
// 16 pixels (60 bytes a pixel at L = 3, PQ = 5) go through a per-warp
// shared stage and leave as 16-byte coalesced stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "phase_marks.cuh"

// Phases (profile_query_gram.py): 0 the B stage, 1 waiting for a level's
// loads, 2 the products, 3 nrm2's shuffles and the output stores.
PHASE_STORAGE(g_query_phase, lsv2_query_phases)

namespace {

constexpr int kK = 64;          // codebook rows per level
constexpr int kMaxPQ = 16;
constexpr int kMaxLevels = 3;
constexpr int kRows = 16;       // pixels a warp item
constexpr int kGramTiles = kK / 8;

template <bool kBf16>
struct Mode {
  static constexpr int kThreads = kBf16 ? 256 : 384;
  static constexpr int kMinBlocks = kBf16 ? 3 : 1;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kKSteps = kBf16 ? 4 : 8;  // k-steps of 16 / 8
  static constexpr int kWords = kBf16 ? 8 : 16;  // 32-bit words a row a level
  static constexpr int kBWords = kBf16 ? 2 : 4;  // a lane's B words an mma
};

// Physical k of a lane's j-th value (j < 16) of a 64-wide level slice, for
// quad lane t: bf16: two 16-byte runs at 8t and 32 + 8t; f32: four 16-byte
// runs at 4t + 16i.
template <bool kBf16>
__device__ __forceinline__ int phys(int t, int j) {
  return kBf16 ? (j >> 3) * 32 + 8 * t + (j & 7)
               : (j >> 2) * 16 + 4 * t + (j & 3);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// d += a . b: A 16x16 bf16 (row), B 16x8 bf16 (col), f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A phi n-tile's accumulators (columns q0 + 2 t4, + 1 of rows g, g + 8)
// into the warp's raw stage [16][lpq] at column c0 + q.
__device__ __forceinline__ void store_raw(float* o_raw, int g, int t4,
                                          int lpq, int c0, int q0, int pq,
                                          const float* d) {
  const int q = q0 + 2 * t4;
  float* r0 = o_raw + g * lpq + c0 + q;
  float* r1 = r0 + 8 * lpq;
  if (q < pq) {
    r0[0] = d[0];
    r1[0] = d[2];
  }
  if (q + 1 < pq) {
    r0[1] = d[1];
    r1[1] = d[3];
  }
}

// B element (k, column n) of level l's [gram | phi] block for the mode's
// permutation; column n < 64 is gram's permuted column, then phi's.
template <bool kBf16>
__device__ __forceinline__ float b_elem(const float* __restrict__ phi,
                                        const float* __restrict__ gram,
                                        int l, int pq, int nt, int gq,
                                        int k) {
  if (nt < kGramTiles) {
    const int m = phys<kBf16>(gq >> 1, 2 * nt + (gq & 1));
    return gram[(l * kK + k) * kK + m];
  }
  const int q = 8 * (nt - kGramTiles) + gq;
  return q < pq ? phi[(l * kK + k) * pq + q] : 0.0f;
}

// One level's A words of rows g and g + 8 of item rows `src` (row stride C
// elements).
template <bool kBf16, typename MapT>
__device__ __forceinline__ void load_level(const MapT* __restrict__ src,
                                           int C, int l, int g, int t4,
                                           unsigned (&v)[2][Mode<kBf16>::kWords]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const MapT* row = src + (size_t)(g + 8 * h) * C + l * kK;
#pragma unroll
    for (int i = 0; i < Mode<kBf16>::kWords / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(
          row + phys<kBf16>(t4, i * (kBf16 ? 8 : 4))));
      v[h][4 * i] = x.x;
      v[h][4 * i + 1] = x.y;
      v[h][4 * i + 2] = x.z;
      v[h][4 * i + 3] = x.w;
    }
  }
}

template <bool kBf16, typename MapT>
__global__ void __launch_bounds__(Mode<kBf16>::kThreads,
                                  Mode<kBf16>::kMinBlocks)
    query_kernel(const MapT* __restrict__ wm, const float* __restrict__ phi,
                 const float* __restrict__ gram, int n_tiles, int levels,
                 int pq, float* __restrict__ raw, float* __restrict__ nrm2) {
  using Md = Mode<kBf16>;
  extern __shared__ __align__(16) unsigned smem[];
  const int nt_all = kGramTiles + (pq + 7) / 8;   // n-tiles a level
  const int lpq = levels * pq;
  unsigned* s_b = smem;   // [L][nt][ks][lane] (bf16) / [L][ks][nt][lane]
  float* s_out = reinterpret_cast<float*>(
      s_b + (size_t)levels * nt_all * Md::kKSteps * 32 * Md::kBWords);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  PHASE_BEGIN

  // B in fragment order, once per block.
  const int n_frag = levels * nt_all * Md::kKSteps * 32;
  for (int i = tid; i < n_frag; i += Md::kThreads) {
    const int ln = i & 31;
    const int rest = i >> 5;
    const int gq = ln >> 2, tq = ln & 3;
    int l, nt, ks;
    if (kBf16) {
      ks = rest % Md::kKSteps;
      nt = (rest / Md::kKSteps) % nt_all;
      l = rest / (Md::kKSteps * nt_all);
      const float e0 = b_elem<true>(phi, gram, l, pq, nt, gq,
                                    phys<true>(tq, 4 * ks));
      const float e1 = b_elem<true>(phi, gram, l, pq, nt, gq,
                                    phys<true>(tq, 4 * ks + 1));
      const float e2 = b_elem<true>(phi, gram, l, pq, nt, gq,
                                    phys<true>(tq, 4 * ks + 2));
      const float e3 = b_elem<true>(phi, gram, l, pq, nt, gq,
                                    phys<true>(tq, 4 * ks + 3));
      reinterpret_cast<uint2*>(s_b)[i] =
          make_uint2(pack_bf16(e0, e1), pack_bf16(e2, e3));
    } else {
      nt = rest % nt_all;
      ks = (rest / nt_all) % Md::kKSteps;
      l = rest / (Md::kKSteps * nt_all);
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(b_elem<false>(phi, gram, l, pq, nt, gq,
                               phys<false>(tq, 2 * ks)), bb0, bs0);
      split_tf32(b_elem<false>(phi, gram, l, pq, nt, gq,
                               phys<false>(tq, 2 * ks + 1)), bb1, bs1);
      reinterpret_cast<uint4*>(s_b)[i] = make_uint4(bb0, bb1, bs0, bs1);
    }
  }
  __syncthreads();
  PHASE_MARK(0)

  float* o_raw = s_out + (size_t)warp * kRows * (lpq + levels);
  float* o_nrm = o_raw + kRows * lpq;
  const long long n_items = (long long)n_tiles * (256 / kRows);
  const long long stride = (long long)gridDim.x * Md::kWarps;
  long long item = (long long)blockIdx.x * Md::kWarps + warp;
  if (item >= n_items) {
    PHASE_END(g_query_phase)
    return;
  }

  unsigned cur[2][Md::kWords], nxt[2][Md::kWords];
  load_level<kBf16>(wm + item * kRows * (levels * kK), levels * kK, 0, g, t4,
                    cur);
  const int C = levels * kK;
  while (true) {
    for (int l = 0; l < levels; ++l) {
      // Prefetch the next level, or the next item's first level.
      const long long n_item = l + 1 < levels ? item : item + stride;
      if (n_item < n_items)
        load_level<kBf16>(wm + n_item * kRows * C, C,
                          l + 1 < levels ? l + 1 : 0, g, t4, nxt);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < Md::kWords; i += 4) {
          PHASE_TOUCH(cur[h][i])
        }
      PHASE_MARK(1)
      PHASE_COUNT()
      float n2a = 0.0f, n2b = 0.0f;   // rows g and g + 8
      if (kBf16) {
        const uint2* b = reinterpret_cast<const uint2*>(s_b) +
                         (size_t)l * nt_all * Md::kKSteps * 32 + lane;
        // Four gram n-tiles at a time, their mma chains interleaved.
#pragma unroll
        for (int n0 = 0; n0 < kGramTiles; n0 += 4) {
          float d[4][4] = {};
#pragma unroll
          for (int ks = 0; ks < Md::kKSteps; ++ks) {
            const unsigned a[4] = {cur[0][2 * ks], cur[1][2 * ks],
                                   cur[0][2 * ks + 1], cur[1][2 * ks + 1]};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint2 bv = b[((n0 + j) * Md::kKSteps + ks) * 32];
              mma_bf16(d[j], a, bv.x, bv.y);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = n0 + j;
            n2a += d[j][0] * bf16_lo(cur[0][nt]) + d[j][1] * bf16_hi(cur[0][nt]);
            n2b += d[j][2] * bf16_lo(cur[1][nt]) + d[j][3] * bf16_hi(cur[1][nt]);
          }
        }
        float d[kMaxPQ / 8][4] = {};
#pragma unroll
        for (int ks = 0; ks < Md::kKSteps; ++ks) {
          const unsigned a[4] = {cur[0][2 * ks], cur[1][2 * ks],
                                 cur[0][2 * ks + 1], cur[1][2 * ks + 1]};
#pragma unroll
          for (int u = 0; u < kMaxPQ / 8; ++u)
            if (kGramTiles + u < nt_all) {
              const uint2 bv = b[((kGramTiles + u) * Md::kKSteps + ks) * 32];
              mma_bf16(d[u], a, bv.x, bv.y);
            }
        }
#pragma unroll
        for (int u = 0; u < kMaxPQ / 8; ++u)
          if (kGramTiles + u < nt_all)
            store_raw(o_raw, g, t4, lpq, l * pq, 8 * u, pq, d[u]);
      } else {
        const uint4* b = reinterpret_cast<const uint4*>(s_b) +
                         (size_t)l * Md::kKSteps * nt_all * 32 + lane;
        float acc[kGramTiles + kMaxPQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < kGramTiles + kMaxPQ / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < Md::kKSteps; ++ks) {
          unsigned ab[4], as[4];
          split_tf32(__uint_as_float(cur[0][2 * ks]), ab[0], as[0]);
          split_tf32(__uint_as_float(cur[1][2 * ks]), ab[1], as[1]);
          split_tf32(__uint_as_float(cur[0][2 * ks + 1]), ab[2], as[2]);
          split_tf32(__uint_as_float(cur[1][2 * ks + 1]), ab[3], as[3]);
          // Five n-tiles at a time: each of the three products runs over
          // all five before the next, so no mma waits on the one before.
#pragma unroll
          for (int n0 = 0; n0 < kGramTiles + kMaxPQ / 8; n0 += 5) {
            uint4 bv[5];
#pragma unroll
            for (int j = 0; j < 5; ++j)
              if (n0 + j < nt_all) bv[j] = b[(ks * nt_all + n0 + j) * 32];
#pragma unroll
            for (int j = 0; j < 5; ++j)
              if (n0 + j < nt_all) mma_tf32(acc[n0 + j], as, bv[j].x, bv[j].y);
#pragma unroll
            for (int j = 0; j < 5; ++j)
              if (n0 + j < nt_all) mma_tf32(acc[n0 + j], ab, bv[j].z, bv[j].w);
#pragma unroll
            for (int j = 0; j < 5; ++j)
              if (n0 + j < nt_all) mma_tf32(acc[n0 + j], ab, bv[j].x, bv[j].y);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kGramTiles; ++nt) {
          n2a += acc[nt][0] * __uint_as_float(cur[0][2 * nt]) +
                 acc[nt][1] * __uint_as_float(cur[0][2 * nt + 1]);
          n2b += acc[nt][2] * __uint_as_float(cur[1][2 * nt]) +
                 acc[nt][3] * __uint_as_float(cur[1][2 * nt + 1]);
        }
#pragma unroll
        for (int u = 0; u < kMaxPQ / 8; ++u)
          if (kGramTiles + u < nt_all)
            store_raw(o_raw, g, t4, lpq, l * pq, 8 * u, pq,
                      acc[kGramTiles + u]);
      }
      PHASE_MARK(2)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        n2a += __shfl_xor_sync(0xffffffffu, n2a, off);
        n2b += __shfl_xor_sync(0xffffffffu, n2b, off);
      }
      if (t4 == 0) {
        o_nrm[g * levels + l] = n2a;
        o_nrm[(g + 8) * levels + l] = n2b;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < Md::kWords; ++i) cur[h][i] = nxt[h][i];
      PHASE_MARK(3)
    }
    // The item's 16 rows of raw and nrm2 are contiguous: 16-byte stores.
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(raw + item * kRows * lpq);
    const float4* s4 = reinterpret_cast<const float4*>(o_raw);
    for (int i = lane; i < kRows * lpq / 4; i += 32) dst[i] = s4[i];
    float4* dn = reinterpret_cast<float4*>(nrm2 + item * kRows * levels);
    const float4* n4 = reinterpret_cast<const float4*>(o_nrm);
    for (int i = lane; i < kRows * levels / 4; i += 32) dn[i] = n4[i];
    __syncwarp();
    PHASE_MARK(3)
    item += stride;
    if (item >= n_items) break;
  }
  PHASE_END(g_query_phase)
}

template <bool kBf16>
size_t query_smem(int levels, int pq) {
  using Md = Mode<kBf16>;
  const int nt_all = kGramTiles + (pq + 7) / 8;
  return sizeof(unsigned) * (size_t)levels * nt_all * Md::kKSteps * 32 *
             Md::kBWords +
         sizeof(float) * (size_t)Md::kWarps * kRows * levels * (pq + 1);
}

template <bool kBf16, typename MapT>
int launch_query(const MapT* wm, const float* phi, const float* gram,
                 int n_tiles, int levels, int pq, float* raw, float* nrm2,
                 void* stream) {
  using Md = Mode<kBf16>;
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (pq < 1 || pq > kMaxPQ || levels < 1 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = query_smem<kBf16>(levels, pq);
  auto kernel = query_kernel<kBf16, MapT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      Md::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = (long long)n_tiles * (256 / kRows);
  const long long need = (items + Md::kWarps - 1) / Md::kWarps;
  const int grid = (int)(need < (long long)sms * per_sm ? need
                                                         : (long long)sms * per_sm);
  if (grid > 0) {
    kernel<<<grid, Md::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wm, phi, gram, n_tiles, levels, pq, raw, nrm2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, typename MapT>
int occupancy(int levels, int pq, int* out) {
  using Md = Mode<kBf16>;
  cudaGetLastError();
  const size_t smem = query_smem<kBf16>(levels, pq);
  auto kernel = query_kernel<kBf16, MapT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      Md::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = Md::kThreads;
  return 0;
}

}  // namespace

extern "C" int lsv2_query_map_tiles(const float* wm, const float* phi,
                                    const float* gram, int n_tiles,
                                    int levels, int pq, float* raw,
                                    float* nrm2, void* stream) {
  return launch_query<false>(wm, phi, gram, n_tiles, levels, pq, raw, nrm2,
                             stream);
}

// wm: bf16 [T, 256, L*64]; phi and gram: f32 holding bf16-rounded values.
extern "C" int lsv2_query_map_tiles_bf16(const void* wm, const float* phi,
                                         const float* gram, int n_tiles,
                                         int levels, int pq, float* raw,
                                         float* nrm2, void* stream) {
  return launch_query<true>(static_cast<const __nv_bfloat16*>(wm), phi, gram,
                            n_tiles, levels, pq, raw, nrm2, stream);
}

// out: blocks an SM, dynamic shared bytes, registers a thread, local
// (spill and stack) bytes a thread, threads a block; bf16 selects the mode.
extern "C" int lsv2_query_occupancy(int bf16, int levels, int pq, int* out) {
  if (pq < 1 || pq > kMaxPQ || levels < 1 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? occupancy<true, __nv_bfloat16>(levels, pq, out)
              : occupancy<false, float>(levels, pq, out);
}
