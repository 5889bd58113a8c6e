// K4: feature backward of the tile blend for frozen geometry. With
//   feat[p, c] = sum_e W[p, e] * F[e, c],   W = alpha * T (included pairs),
// the weights W do not depend on the per-entry features F, so
//   dF[e, c] = sum_p W[p, e] * g[p, c]
// for the cotangent g [256, C] of the tile's feature map.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_train.py::
// _feature_bwd_kernel (pallas_call at :241 in feature_grads_pallas). The
// Pallas kernel rebuilds W per 256-entry chunk from an exclusive cumprod in
// log space and contracts it with one MXU matmul per chunk. Here W is the
// replay of the port's K2 (csrc/blend.cu) op for op, one thread a pixel:
// same -fmad=false build, same gather of the per-Gaussian state by
// g_sorted, same alpha and termination tests, same running-product
// transmittance. W is then the forward's weight bit for bit (the batch
// size only moves the block's early exit, after which every W is 0).
// Against the JAX package the weights are allclose, not equal: the Pallas
// kernel carries T as exp(sum log1p(-alpha)).
//
// Bound on this card: bytes (the [T, 256, C] cotangent read, the [E, C]
// dF write) against 2C operations an included pair. What costs is the
// dense product W^T g over all 256 pixels of every entry, 2 * 256 * C
// operations an entry and three times that for f32 accuracy: on the CUDA
// cores from shared memory (the first version) the shared-memory pipe set
// its pace (58% of a block's cycles). Here it runs on the tensor cores as
// dF^T = g^T W (mma.sync m16n8k8 TF32 with the 3xTF32 split of
// mma_tf32.cuh), and the replay of K2's walk is what is left to hide.
//
// Design. A block takes one tile and one chunk of up to 64 channels (grid
// [T, ceil(C / 64)]; a narrower last chunk computes 16-channel m-tiles
// with zero rows past C), 8 warps of 32 pixels, one block an SM (247
// registers a thread: the A fragments below). The product's contraction
// is split by warp:
//  - a warp's A fragments (g^T for its 32 pixels and the chunk's channels)
//    are loaded from device memory into registers once, while the first
//    batch replays, and split into big and small once: every batch reuses
//    them and the cotangent needs no shared stage;
//  - per batch of 32 entries each lane replays its pixel (the 32 alpha
//    tests first, branch-free, so that they overlap; then the walk in
//    depth order carrying T) and writes W into the warp's own
//    [entry][pixel] stage (row stride 36: B fragments conflict-free);
//    then, after __syncwarp only, the warp multiplies its 32 pixels'
//    share of dF^T [64 x 32] (192 mma.sync); a warp with no included pair
//    in the batch skips its product;
//  - the 8 partials meet in a double-buffered shared array, and after one
//    block barrier a batch each thread sums row quads of dF (the live
//    warps' partials in warp order) and stores them, 16 bytes a thread
//    where C is a multiple of 4.
// Each warp gathers its own copy of a batch's geometry with cp.async, two
// batches ahead, into the buffer the last replay read, before the batch's
// stores are issued (behind them the copies wait). Rows of
// entries after the block's early exit are written as zeros, and so is
// the tail of dF past the last tile's range (entries that no tile
// blends), a few float4s a thread a batch so that those writes spread
// over the run, and the head before the first tile's range, so every row
// is defined.
//
// A launch covers num_tiles slots from grid tile tile_base on (a strip of
// the grid: the Gaussian-sharded path's tile owner); the pixel coordinates
// are the grid tile's, and a slot at or past the grid's last tile blends
// nothing (its rows are zeros). The whole grid is tile_base 0.
#include <cuda_runtime.h>

#include <climits>

#include "mma_tf32.cuh"
#include "phase_marks.cuh"

// Phases (profile_train_bwd.py): 0 staging wait, 1 replay, 2 product, 3
// cross-warp sum, 4 writes.
PHASE_STORAGE(g_feature_bwd_phase, lsv2_feature_bwd_phases)

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;   // threads a block = pixels a tile
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 32;              // entries a batch
constexpr int kChunk = 64;              // channels a block
constexpr int kMT = kChunk / 16;        // m16 tiles of channels
constexpr int kKS = 4;                  // k8 steps over a warp's 32 pixels
constexpr int kNT = kBatch / 8;         // n8 tiles of entries
constexpr int kWStride = 36;            // W stage [entry][pixel]
constexpr int kPStride = kChunk + 4;    // partials [entry][channel]
constexpr int kGeomW = 8;               // x y ca cb cc op, 2 pad
constexpr int kGeom = 9;                // x y ca cb cc op r g b
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float geom[kWarps][2][kBatch][kGeomW];     // each warp's own gather
  float w[kWarps][kBatch][kWStride];         // each warp's W
  float part[2][kWarps][kBatch][kPStride];   // the warps' partial dF
  int live[2][kWarps];
};

// Entry `id`'s six blend fields into dst, 4 bytes a copy.
__device__ __forceinline__ void gather(const float* __restrict__ geom,
                                       int id, float* dst) {
  const float* row = geom + (size_t)id * kGeom;
#pragma unroll
  for (int f = 0; f < 6; ++f) cp_async4(dst + f, row + f);
}

// K2's per-pixel walk over one batch (nb entries of sg), recording W in
// sw [entry][pixel] instead of accumulating. Returns whether any lane of
// the warp has an included pair in the batch; a warp none of whose lanes
// passes an alpha test writes nothing. The alpha tests of the batch's
// entries come first, branch-free, so that they overlap; then the walk in
// depth order carries T and done (the same ops as K2 for an included
// pair, so its W is K2's).
__device__ __forceinline__ bool replay(const float (*sg)[kGeomW], float* sw,
                                       int lane, int nb, float px, float py,
                                       float& T, bool& done) {
  if (!__any_sync(kFull, !done)) return false;
  float al[kBatch];
  unsigned acts = 0u;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(sg[j]);
    const float2 b = *reinterpret_cast<const float2*>(sg[j] + 4);
    const float dx = px - a.x;
    const float dy = py - a.y;
    const float ca = a.z, cb = a.w, cc = b.x;
    const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
    al[j] = fminf(kAlphaMax, b.y * expf(power));
    if (j < nb && power <= 0.0f && al[j] >= kAlphaMin) acts |= 1u << j;
  }
  if (!__reduce_or_sync(kFull, done ? 0u : acts)) return false;
  bool any = false;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool act = ((acts >> j) & 1u) && !done;
    const float test_t = T * (1.0f - al[j]);
    const bool ends = act && test_t < kTEps;
    const bool inc = act && !ends;
    done = done || ends;
    sw[j * kWStride + lane] = inc ? al[j] * T : 0.0f;
    T = inc ? test_t : T;
    any = any || inc;
  }
  return __any_sync(kFull, any);
}

// The tail of dF past the last tile's range belongs to no tile; block
// `blk` zeroes every `stride`-th float4 (or float, where C is not a
// multiple of 4) of it from its own offset, a few a batch, so the writes
// spread over the kernel's run.
struct Tail {
  float* d;
  long long i, n, stride;
  bool vec;

  __device__ Tail(const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, int num_tiles,
                  int channels, long long num_entries, float* dfeat) {
    const long long end =
        (long long)tile_start[num_tiles - 1] + tile_count[num_tiles - 1];
    const long long blk = (long long)blockIdx.y * num_tiles + blockIdx.x;
    vec = (channels & 3) == 0;
    const int w = vec ? 4 : 1;
    d = dfeat;
    n = num_entries * channels / w;
    i = end * channels / w + blk * kPix + threadIdx.x;
    stride = (long long)num_tiles * gridDim.y * kPix;
  }

  __device__ __forceinline__ void zero(int k) {
    for (int q = 0; q < k && i < n; ++q, i += stride) {
      if (vec)
        reinterpret_cast<float4*>(d)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else
        d[i] = 0.0f;
    }
  }
};

// Zeroes rows [start, start + count) of the block's channel chunk.
__device__ __forceinline__ void zero_rows(float* __restrict__ dfeat,
                                          long long start, int count,
                                          int channels, int c0, int cw) {
  const long long n = (long long)max(count, 0) * cw;
  for (long long i = threadIdx.x; i < n; i += kPix) {
    const long long r = i / cw;
    dfeat[(start + r) * channels + c0 + (i - r * cw)] = 0.0f;
  }
}

__global__ void __launch_bounds__(kPix, 1)
    feature_bwd_kernel(const int* __restrict__ g_sorted,
                       const int* __restrict__ tile_start,
                       const int* __restrict__ tile_count,
                       const float* __restrict__ geom,
                       const float* __restrict__ cot, int num_tiles,
                       int grid_x, int tile_base, int grid_tiles,
                       int channels, long long num_entries,
                       float* __restrict__ dfeat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int cw = min(kChunk, channels - c0);
  const int n_mt = (cw + 15) / 16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  PHASE_BEGIN

  Tail tail(tile_start, tile_count, num_tiles, channels, num_entries,
            dfeat);
  // Slot `tile` is grid tile tile_base + tile; one at or past the grid's
  // grid_tiles blends nothing, and its range's rows are zeros.
  const int gtile = tile_base + tile;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  // Rows before slot 0's range (a strip of a larger entry list) belong to
  // no slot: slot 0's blocks zero them.
  if (tile == 0) zero_rows(dfeat, 0, start, channels, c0, cw);
  if (count <= 0 || gtile >= grid_tiles) {
    zero_rows(dfeat, start, count, channels, c0, cw);
    tail.zero(INT_MAX);
    return;
  }

  // This warp's A = g^T fragments (channel c0 + 16 mt + g (+8), pixel
  // 32 warp + 8 ks + t4 (+4)), raw; split after the first replay.
  const float* gw = cot + ((size_t)tile * kPix + 32 * warp) * channels + c0;
  float araw[kMT][kKS][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 8 * ks + t4 + (r >> 1) * 4;
        const int c = 16 * mt + g + (r & 1) * 8;
        araw[mt][ks][r] = c < cw ? gw[(size_t)p * channels + c] : 0.0f;
      }

  // Batch 0's geometry; the ids of batches 1 and 2 (lane j: entry j).
  const bool gl = lane < kBatch;
  if (gl && lane < count)
    gather(geom, g_sorted[start + lane], sm.geom[warp][0][lane]);
  cp_async_commit();
  int id_next = gl && kBatch + lane < count
                    ? g_sorted[start + kBatch + lane] : 0;
  if (gl && kBatch + lane < count)
    gather(geom, id_next, sm.geom[warp][1][lane]);
  cp_async_commit();
  id_next = gl && 2 * kBatch + lane < count
                ? g_sorted[start + 2 * kBatch + lane] : 0;

  const int p = 32 * warp + lane;
  const float px = (float)((gtile % grid_x) * kBlock + p % kBlock);
  const float py = (float)((gtile / grid_x) * kBlock + p / kBlock);
  float T = 1.0f;
  bool done = false;
  float* sw = &sm.w[warp][0][0];

  cp_async_wait<1>();
  __syncwarp();
  PHASE_MARK(0)
  bool live = replay(sm.geom[warp][0], sw, lane, min(kBatch, count), px,
                     py, T, done);
  PHASE_MARK(1)
  unsigned ab[kMT][kKS][4], as[kMT][kKS][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
      split4(araw[mt][ks], ab[mt][ks], as[mt][ks]);
  PHASE_MARK(0)

  int b0 = 0;
  for (int it = 0;; ++it, b0 += kBatch) {
    const int buf = it & 1;
    const int nb = min(kBatch, count - b0);
    PHASE_COUNT()
    // Gather batch it + 2's geometry into the buffer batch it was replayed
    // from, ahead of this batch's stores.
    const int nxt = b0 + 2 * kBatch;
    if (gl && nxt + lane < count)
      gather(geom, id_next, sm.geom[warp][buf][lane]);
    cp_async_commit();
    id_next = gl && nxt + kBatch + lane < count
                  ? g_sorted[start + nxt + kBatch + lane] : 0;
    __syncwarp();   // W of this batch is in the warp's stage
    // dF^T[c][e] over this warp's 32 pixels: rows 16 mt + g (+8), columns
    // 8 nt + 2 t4 (+1).
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;
    if (live) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        unsigned bb[kNT][2], bs[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float* col = sw + (8 * nt + g) * kWStride + 8 * ks + t4;
          split_tf32(col[0], bb[nt][0], bs[nt][0]);
          split_tf32(col[4], bb[nt][1], bs[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (mt < n_mt) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              mma_tf32(acc[mt][nt], as[mt][ks], bb[nt][0], bb[nt][1]);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              mma_tf32(acc[mt][nt], ab[mt][ks], bs[nt][0], bs[nt][1]);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              mma_tf32(acc[mt][nt], ab[mt][ks], bb[nt][0], bb[nt][1]);
          }
        }
      }
    }
    PHASE_MARK(2)
    // The warp's partial [entry][channel] (conflict-free: bank 8 t4 + g).
    float* pw = &sm.part[buf][warp][0][0];
    if (live) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt < n_mt) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              pw[(8 * nt + 2 * t4 + (r & 1)) * kPStride + 16 * mt + g +
                 (r >> 1) * 8] = acc[mt][nt][r];
        }
      }
    }
    if (lane == 0) sm.live[buf][warp] = live;
    // All partials written; the other buffer's last reader is done.
    const bool all_done = __syncthreads_count(done) == kPix;
    // dF rows b0 + e, channels c0 + c4 .. + 3: the live warps' partials
    // in warp order.
#pragma unroll
    for (int task = tid; task < kBatch * kChunk / 4; task += kPix) {
      const int e = task / (kChunk / 4), c4 = (task % (kChunk / 4)) * 4;
      if (e < nb && c4 < cw) {
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (sm.live[buf][w]) {
            const float4 v =
                *reinterpret_cast<const float4*>(&sm.part[buf][w][e][c4]);
            s.x += v.x;
            s.y += v.y;
            s.z += v.z;
            s.w += v.w;
          }
        }
        float* dst = dfeat + (size_t)(start + b0 + e) * channels + c0 + c4;
        if ((channels & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = s;
        } else {
          const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c4 + q < cw) dst[q] = v[q];
        }
      }
    }
    PHASE_MARK(3)
    tail.zero(4);
    PHASE_MARK(4)
    if (all_done || b0 + kBatch >= count) {
      b0 += kBatch;
      break;
    }
    // The next batch: its geometry landed while this one multiplied (the
    // newest group, batch it + 2's, may still be in flight).
    cp_async_wait<1>();
    __syncwarp();
    PHASE_MARK(0)
    live = replay(sm.geom[warp][buf ^ 1], sw, lane,
                  min(kBatch, count - b0 - kBatch), px, py, T, done);
    PHASE_MARK(1)
  }
  cp_async_wait<0>();   // a gather the early exit left in flight
  // Rows after the early exit carry W = 0.
  if (b0 < count) zero_rows(dfeat, start + b0, count - b0, channels, c0, cw);
  tail.zero(INT_MAX);
  PHASE_MARK(4)
  PHASE_END(g_feature_bwd_phase)
}

}  // namespace

extern "C" int lsv2_feature_bwd(const int* g_sorted, const int* tile_start,
                                const int* tile_count, const float* geom,
                                const float* cot, int num_tiles, int grid_x,
                                int tile_base, int grid_tiles, int channels,
                                long long num_entries, float* dfeat,
                                void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  cudaError_t err = cudaFuncSetAttribute(
      feature_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0 && channels > 0) {
    const dim3 grid(num_tiles, (channels + kChunk - 1) / kChunk);
    feature_bwd_kernel<<<grid, kPix, sizeof(Smem),
                         static_cast<cudaStream_t>(stream)>>>(
        g_sorted, tile_start, tile_count, geom, cot, num_tiles, grid_x,
        tile_base, grid_tiles, channels, num_entries, dfeat);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's occupancy: blocks an SM, dynamic shared bytes, registers a thread,
// local bytes a thread, threads a block.
extern "C" int lsv2_feature_bwd_occupancy(int* out) {
  cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      feature_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, feature_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, feature_bwd_kernel, kPix, sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)sizeof(Smem);
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kPix;
  return 0;
}
