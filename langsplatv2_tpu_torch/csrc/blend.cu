// K2: front-to-back blend of each 16x16 tile's depth-sorted entry segment,
// RGB plus (quick mode) the top-k (weight, index) pairs expanded to channels.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_blend.py::_blend_kernel
// (pallas_call at :695 in _blend_call; wrappers blend_tiles_pallas and
// blend_tiles_query) in its modes f32 ("rgb", "quick", and "combined" on
// the cascade's segments), fast16, query, bf16 cells and dense. The Pallas
// kernel builds [P, chunk] alpha matrices, scans the transmittance in log
// depth and accumulates with one MXU matmul per chunk, from 128-aligned
// field-major rows that an XLA gather packed before. None of that is needed
// here: one block takes one tile and walks its segment in batches, each
// batch's per-Gaussian state gathered straight from the per-Gaussian arrays
// by g_sorted, so no packed entry rows are ever written.
//
// What bounds it on this card. Its bound (each input byte once, the pair
// work at the f32 rate) is the output write and the gathered state, or
// the pair work; the first design (one thread a pixel, one block of 8
// warps an SM) ran at 12-47x it, paced by the latency of each pixel's
// chain of shared-memory loads and stores. The 192 channel accumulators
// of a pixel stay in shared memory, [C][257] f32 (197 KB at C = 192): a
// slot's channel is a data-dependent index, and registers cannot be
// indexed by one. So one block fits an SM, and the lever is more warps
// over the same accumulators. With channels, three threads a pixel (768
// threads, 24 warps) split a batch of kB entries into three phases
// between block barriers:
//   (a) alpha, all 768 threads: each (entry, pixel) pair of the batch gets
//       its alpha, or 0 where the pair is skipped (power <= 0 fails or is
//       NaN, alpha < 1/255), into a [kB][256] word buffer; pixels already
//       done are skipped. With bf16 cells the word holds bf16 alpha and
//       bf16 log1p(-alpha).
//   (b) the transmittance walk, one thread a pixel (8 warps), in entry
//       order and without branches: the termination test, T's update (or
//       S's sum with bf16 cells) and the blend weight w = alpha * T, written
//       over the pair's word; the pair counts, up to and including the
//       terminating entry. Meanwhile one idle warp sorts each entry's slots
//       by owner (unbanded rows of up to 12 slots).
//   (c) accumulate, all 768 threads: thread (pixel, owner o) owns a third
//       of the channels (level o's band [64 o, 64 o + 64) in the banded
//       192-channel rows, where it reads only level o's slots; elsewhere
//       ceil(C / 3) channels and its own sorted slots; dense: a third of
//       the columns, rounded to 4) and colour channel o, and adds
//       w * value in entry order, then slot order.
// No two threads touch one accumulator, and each channel gets the same
// additions in the same order as in a one-thread-a-pixel loop, so rgb, T,
// the feature tiles and the pair counts are that loop's bit for bit (K4,
// K5 and K7 replay these blend weights op for op). A warp is 32 pixels of
// one owner: a slot's index and weight are broadcast reads and
// acc[c * 257 + pixel] is free of bank conflicts. The block leaves once
// every pixel has ended (__syncthreads_count). Without channels (rgb only)
// there is nothing to share: one thread a pixel walks batches of
// kRgbBatch entries with alpha inline, four blocks of 256 an SM.
//
// Measured (profile_blend.py --phases, fast16 at 1080p on an H100): phase
// (c) takes ~49% of a block's cycles, bound by the issue of its per-slot
// loop (reading two slots a 16-byte load did not move it); (b), with the
// next batch's staging, ~22%, serial on 8 warps; (a) ~19%; the tile's
// write-out ~7%. Every loop a lane can leave early runs to a warp-uniform
// bound (the batch) with the lane predicated off: a lane that left by
// `break` split the warp with no point to rejoin (ptxas emitted none),
// several times slower.
//
// Gather. The next batch's raw words (a fast16 row's 16, the f32 mode's 9
// of state and 2 * topk of slots, the dense mode's 9 and D') are loaded
// into registers while this batch blends (their Gaussian ids a batch
// earlier still), then widened to f32 (bf16 halves), band rule applied,
// into the other of two staging buffers, each entry's geometry as float4s.
// TMA does not serve: the rows are a gather by g_sorted, not a tile.
//
// The per-pair rules (the CUDA rasterizer's loop):
//   not power <= 0 (NaN too) or alpha < 1/255 -> skip (does not count);
//   T * (1 - alpha) < 1e-4      -> the pixel ends, this entry not included;
//   else acc += alpha * T * feature, T *= 1 - alpha.
// Compiled with -fmad=false; the plain PyTorch version (ops/blend.py) runs
// the same sequence of f32 ops, so the two agree to the last bit on the
// alpha and termination tests.
//
// fast16 mode (the serving rows of precision="bf16", the Pallas kernel's
// rowfmt="fast16"): the per-Gaussian state comes from one 64-byte row
// (ops/blend.py::pack_fast16_rows: xy f32, conic, opacity and rgb as bf16,
// 12 u8 codebook indices, 12 bf16 weights), widened to f32 in shared
// memory; the blend that follows is the f32 mode's, op for op. With
// out_bf16 the feature tiles are stored as bf16 (round to nearest even)
// and the colour as bf16(acc_rgb) + T * bg in f32, as the Pallas kernel
// stores its bf16 accumulator and adds the background outside.
//
// query mode (K2q, the Pallas kernel with query=True, epilogue :483-501):
// the fast16 blend, then per pixel, from the channel accumulators, the
// Gram relevancy query of kernel K3:
//   raw[l*PQ + q] = sum_k bf16(wm[l,k]) phi[l,k,q]
//   nrm2[l]       = sum_k (sum_m bf16(wm[l,m]) gram[l,m,k]) wm[l,k]
// with phi and gram rounded to bf16 by the wrapper. For each level the
// block computes [256 pixels x 64] . [64 x (PQ' + 64)] on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums; PQ' = PQ rounded up to 8):
// A is the accumulators rounded to bf16, B phi and gram staged in the free
// alpha buffer (the next level's loaded into registers while this one
// multiplies). nrm2 multiplies each gram product by the unrounded f32
// accumulator at the same (pixel, k) and sums over the 4 lanes of a row
// with shuffles. Products of bf16 values are exact in f32, so the kernel
// and its plain version differ only in the order of the sums. That
// epilogue is for K = 64, L <= 3 and PQ <= 16; every other shape up to
// fast16's 256 channels takes query_frag.cuh's general products (kQA = 1:
// warps of 16 pixels, B's fragments from a scratch copy written once a
// call, A the accumulators read a pair at a time, zero past K). 256
// channels of f32 accumulators do not fit a block's shared memory, so past
// 192 (kQA = 2) a tile takes a cluster of two blocks: both walk the tile,
// each accumulates half the channels (a pair outside its half is dropped
// where the batch is staged, as an out-of-band one), rank 0 alone writes rgb,
// T and the pair counts, and after a cluster barrier rank r runs the
// epilogue for pixels [128 r, 128 r + 128), reading the partner's half of
// the accumulators through distributed shared memory (a level may straddle
// the halves: K = 256 at L = 1).
//
// Level bands (fast16 and query modes, `per_level` > 0; the Pallas
// kernel's banded=True, :386-401): slot k belongs to level k / per_level
// and its pair is added only when its index lies in [64 l, 64 l + 64); the
// rule is applied where a batch is staged (an out-of-band index becomes
// the offset -1, which no owner's range holds).
//
// bf16 cells (fast16 and query modes, `cells_bf16`; the Pallas kernel's
// cellbf16, :282-299, :323-336, :373-385, :436-441): the cell math rounded
// to bf16 at the Pallas kernel's rounding points, its transmittance an f32
// sum of bf16 log1p(-alpha) with one bf16 exp:
//   valid   : power <= 0 in f32 (the exact test, on the f32 power);
//   alpha   = min(bf16(0.99), bf16(op) * bf16(exp(bf16(power)))), each
//             product, exp and min rounded to bf16; skipped if
//             float(alpha) < 1/255;
//   T       = bf16(exp(bf16(S))), S the f32 sum of bf16(log1p(-alpha))
//             over the pixel's included pairs so far (0 at the start);
//   test    = bf16(T * bf16(1 - alpha)); the pixel ends if float(test)
//             < 1e-4;
//   w       = bf16(alpha * T); acc += w * weight in f32; S +=
//             bf16(log1p(-alpha)).
// The final T is exp(S) in f32, as the Pallas kernel's t_carry. Within one
// of its 256-entry chunks that kernel's exclusive sum is this S; across
// chunks it carries T in f32 and rounds once more, where this kernel
// rounds the whole sum once. The plain version rounds at the same points
// with torch's bf16 arithmetic.
//
// dense mode (the Pallas kernel's mode="dense", :342-346, reached through
// pallas_train.py::rasterize_dense_vjp): the f32 blend of each entry's own
// feature row F[g, c0:c0 + D'] (F [N, D] f32) into [T, 256, D] at columns
// c0.., D' <= 192 a launch; the wrapper launches channel groups for a wider
// D and writes rgb and T from the first group only (rgb_out null after
// it). Batches of kDenseBatch entries, so that two staging buffers of
// D' = 192 rows fit beside the accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "mma_tf32.cuh"
#include "query_frag.cuh"

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;  // pixels per tile
constexpr int kOwners = 3;             // threads a pixel with channels
constexpr int kThreads = kOwners * kPix;
constexpr int kPad = kPix + 1;         // accumulator row stride
constexpr int kQuickBatch = 24;        // entries a batch, quick modes
constexpr int kDenseBatch = 8;         // entries a batch, dense mode
constexpr int kRgbBatch = 96;          // entries a batch, rgb only
constexpr int kNarrowBatch = 32;       // entries a batch, narrow dense
constexpr int kNarrowDense = 64;       // widest dense launch on 1 owner
constexpr int kChunk = 8;              // batch words a thread holds at once
constexpr int kGeom = 9;               // x y ca cb cc op r g b
constexpr int kGeomStride = 12;        // staged floats an entry (float4s)
constexpr int kFast16Words = 16;       // 32-bit words of a fast16 row
constexpr int kFast16Pairs = 12;       // (index, weight) slots of a fast16 row
constexpr float kAlphaMin = 0.003921569f;  // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kLevelK = 64;            // codebook rows a level (query mode)
constexpr int kMaxLevels = 3;
constexpr int kMaxPQ = 16;             // prompts a level (query mode)
constexpr int kMaxDense = 192;         // dense channels a launch
constexpr int kBRow = kLevelK + 8;     // bf16 row stride of the staged B
// The epilogue's B ([PQ' + 64][kBRow] bf16) fits in the alpha buffer.
static_assert((kMaxPQ + kLevelK) * kBRow * 2 <= kQuickBatch * kPix * 4,
              "query epilogue staging does not fit the alpha buffer");

// Entries a batch.
template <bool kDense, int kOwn>
__host__ __device__ constexpr int batch_entries() {
  return kOwn == 1 ? (kDense ? kNarrowBatch : kRgbBatch)
                   : (kDense ? kDenseBatch : kQuickBatch);
}

// Registers a thread holds of the next batch's raw words.
template <bool kFast16, bool kDense, int kOwn>
__host__ __device__ constexpr int prefetch_words() {
  return kOwn == 1 ? (kDense ? 10 : 4) : (kDense ? 3 : (kFast16 ? 1 : 2));
}

// 32-bit words of one entry's raw state.
template <bool kFast16, bool kDense>
__host__ __device__ __forceinline__ int entry_words(int channels, int topk) {
  return kFast16 ? kFast16Words : kGeom + (kDense ? channels : 2 * topk);
}

// Dynamic shared memory of one launch; the kernel's layout, in order:
// acc [channels][kPad] f32 (rounded up to 16 bytes); the alpha buffer
// [kB][kPix] (one owner: [kPix]; the final T once the walk is over); two
// staging buffers, each the geometry [kB][kGeomStride] f32 (x y ca cb |
// cc op r g | b) then the slots [kB][topk] (accumulator offset, weight
// bits) or the dense rows [kB][dp] f32 (dp = channels rounded up to 4);
// quick modes: each entry's owner ends [kB] (see partition_slots); three
// owners: the done flags [kPix] and the entries each pixel accumulates
// [kPix] (bytes).
__host__ __device__ __forceinline__ int dense_stride(int channels) {
  return (channels + 3) & ~3;
}

template <bool kDense, int kOwn>
__host__ __device__ __forceinline__ int stage_floats(int channels, int topk) {
  constexpr int kB = batch_entries<kDense, kOwn>();
  return kB * kGeomStride + kB * (kDense ? dense_stride(channels) : 2 * topk);
}

__host__ __device__ __forceinline__ int acc_floats(int channels) {
  return (channels * kPad + 3) & ~3;
}

template <bool kDense, int kOwn>
size_t blend_smem(int channels, int topk) {
  constexpr int kB = batch_entries<kDense, kOwn>();
  constexpr int kAlpha = kOwn == 1 ? kPix : kB * kPix;
  return sizeof(float) * ((size_t)acc_floats(channels) + kAlpha +
                          2 * (size_t)stage_floats<kDense, kOwn>(channels, topk) +
                          (kDense ? 0 : kB)) +
         (kOwn == 1 ? 0 : 2 * kPix);
}

__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          unsigned n_eval, unsigned n_inc) {
  unsigned long long e = n_eval, i = n_inc;
  for (int off = 16; off > 0; off >>= 1) {
    e += __shfl_down_sync(0xffffffffu, e, off);
    i += __shfl_down_sync(0xffffffffu, i, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats, e);
    atomicAdd(stats + 1, i);
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

// Accumulator offset of slot k's index, or -1 where the pair is dropped:
// outside the channels [cb, cb + channels) the block holds, or (per_level >
// 0) outside its level's band.
__device__ __forceinline__ int slot_offset(int idx, int k, int cb,
                                           int channels, int per_level) {
  if ((unsigned)(idx - cb) >= (unsigned)channels) return -1;
  if (per_level > 0) {
    const int band = (k / per_level) * kLevelK;
    if (idx < band || idx >= band + kLevelK) return -1;
  }
  return (idx - cb) * kPad;
}

// Field f of Gaussian gi's raw state.
template <bool kFast16, bool kDense>
__device__ __forceinline__ unsigned load_word(
    int gi, int f, const float* __restrict__ geom,
    const float* __restrict__ qw, const int* __restrict__ qi,
    const unsigned* __restrict__ rows, int topk,
    const float* __restrict__ feat, int stride, int c0) {
  if (kFast16) return __ldg(rows + (size_t)gi * kFast16Words + f);
  if (f < kGeom) return __float_as_uint(__ldg(geom + (size_t)gi * kGeom + f));
  f -= kGeom;
  if (kDense) return __float_as_uint(__ldg(feat + (size_t)gi * stride + c0 + f));
  if (f < topk) return __float_as_uint(__ldg(qw + (size_t)gi * topk + f));
  return (unsigned)__ldg(qi + (size_t)gi * topk + f - topk);
}

// Widen raw word v (field f of batch entry e) into staging buffer sg.
template <bool kFast16, bool kDense, int kB>
__device__ __forceinline__ void store_word(unsigned v, int e, int f,
                                           float* sg, int topk, int channels,
                                           int per_level, int cb) {
  float* s_geom = sg + e * kGeomStride;
  int2* s_slot = reinterpret_cast<int2*>(sg + kB * kGeomStride) + e * topk;
  if (kFast16) {
    switch (f) {
      case 0:
      case 1:
        s_geom[f] = __uint_as_float(v);
        break;
      case 2:
      case 3:
      case 4:
        s_geom[2 * f - 2] = bf16_lo(v);  // ca, cc, r
        s_geom[2 * f - 1] = bf16_hi(v);  // cb, op, g
        break;
      case 5:
        s_geom[8] = bf16_lo(v);          // b
        break;
      case 6:
      case 7:
      case 8:
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 4 * (f - 6) + b;
          if (k < topk)
            s_slot[k].x = slot_offset((v >> (8 * b)) & 0xFF, k, cb,
                                      channels, per_level);
        }
        break;
      case 15:
        break;
      default:  // 9..14: weights 2 (f - 9), 2 (f - 9) + 1
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int k = 2 * (f - 9) + b;
          if (k < topk)
            s_slot[k].y = __float_as_int(b ? bf16_hi(v) : bf16_lo(v));
        }
    }
    return;
  }
  if (f < kGeom) {
    s_geom[f] = __uint_as_float(v);
    return;
  }
  f -= kGeom;
  if (kDense) {
    sg[kB * kGeomStride + e * dense_stride(channels) + f] = __uint_as_float(v);
  } else if (f < topk) {
    s_slot[f].y = (int)v;
  } else {
    f -= topk;
    s_slot[f].x = slot_offset((int)v, f, cb, channels, per_level);
  }
}

// Phase (a)'s word for batch entry j at pixel (px, py): 0 where the pair
// is skipped, else f32 alpha, or (kCells) bf16 alpha in the high half and
// bf16 log1p(-alpha) in the low one. Valid alpha is >= 1/255, so a valid
// word is never 0.
template <bool kCells>
__device__ __forceinline__ unsigned alpha_word(const float* sg, int j,
                                               float px, float py) {
  const float4 g0 = *reinterpret_cast<const float4*>(sg + j * kGeomStride);
  const float4 g1 =
      *reinterpret_cast<const float4*>(sg + j * kGeomStride + 4);
  const float dx = px - g0.x;
  const float dy = py - g0.y;
  const float ca = g0.z, cb = g0.w, cc = g1.x, op = g1.y;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  if (!(power <= 0.0f)) return 0u;
  if constexpr (kCells) {
    const __nv_bfloat16 e = __float2bfloat16_rn(
        expf(__bfloat162float(__float2bfloat16_rn(power))));
    const __nv_bfloat16 ab =
        __hmin(__float2bfloat16_rn(kAlphaMax),
               __hmul(__float2bfloat16_rn(op), e));
    const float alpha = __bfloat162float(ab);
    if (alpha < kAlphaMin) return 0u;
    return ((unsigned)__bfloat16_as_ushort(ab) << 16) |
           __bfloat16_as_ushort(__float2bfloat16_rn(log1pf(-alpha)));
  } else {
    const float alpha = fminf(kAlphaMax, op * expf(power));
    if (alpha < kAlphaMin) return 0u;
    return __float_as_uint(alpha);
  }
}

// One step of a pixel's transmittance walk, without branches: `live` if
// the pixel has not ended and the pair is not skipped (its word is not
// 0). Returns whether the pair is included, with its blend weight in w
// and T (kCells: S and its bf16 exp tb) past it; `ends` if the pixel ends
// on this pair instead.
template <bool kCells>
__device__ __forceinline__ bool walk_step(unsigned word, bool live, float& T,
                                          float& S, __nv_bfloat16& tb,
                                          float& w, bool& ends) {
  bool inc;
  if constexpr (kCells) {
    const __nv_bfloat16 ab = __ushort_as_bfloat16((unsigned short)(word >> 16));
    const __nv_bfloat16 test =
        __hmul(tb, __hsub(__float2bfloat16_rn(1.0f), ab));
    ends = live && __bfloat162float(test) < kTEps;
    inc = live && !ends;
    w = __bfloat162float(__hmul(ab, tb));
    const float s_next = S + __bfloat162float(__ushort_as_bfloat16(
                                 (unsigned short)(word & 0xFFFFu)));
    S = inc ? s_next : S;
    const __nv_bfloat16 tb_next = __float2bfloat16_rn(expf(round_bf16(S)));
    tb = inc ? tb_next : tb;
  } else {
    const float alpha = __uint_as_float(word);
    const float test_t = T * (1.0f - alpha);
    ends = live && test_t < kTEps;
    inc = live && !ends;
    w = alpha * T;
    T = inc ? test_t : T;
  }
  return inc;
}

// Sorts one entry's slots [topk] (topk <= kFast16Pairs) in place by
// owner, keeping slot order within an owner: first the valid slots of
// owner 0's channels (offsets below b1), then owner 1's (below b2), then
// owner 2's; dropped slots (offset -1) go. Returns the owners' ends, one
// a byte.
__device__ __forceinline__ unsigned partition_slots(int2* slot, int topk,
                                                    int b1, int b2) {
  int2 v[kFast16Pairs];
  int n0 = 0, n1 = 0, n2 = 0;
#pragma unroll
  for (int k = 0; k < kFast16Pairs; ++k) {
    v[k] = k < topk ? slot[k] : make_int2(-1, 0);
    if (v[k].x >= 0) {
      if (v[k].x < b1)
        ++n0;
      else if (v[k].x < b2)
        ++n1;
      else
        ++n2;
    }
  }
  int p0 = 0, p1 = n0, p2 = n0 + n1;
#pragma unroll
  for (int k = 0; k < kFast16Pairs; ++k) {
    if (v[k].x < 0) continue;
    if (v[k].x < b1)
      slot[p0++] = v[k];
    else if (v[k].x < b2)
      slot[p1++] = v[k];
    else
      slot[p2++] = v[k];
  }
  return (unsigned)n0 | (unsigned)(n0 + n1) << 8 |
         (unsigned)(n0 + n1 + n2) << 16;
}

// Query mode's epilogue (see the header): raw [kPix][levels * pq] and
// nrm2 [kPix][levels] of the tile from the channel accumulators. `bt` is
// the free alpha buffer. Every thread of the block calls this; warp w < 16
// takes pixels [16 w, 16 w + 16).
__device__ __forceinline__ void query_epilogue(
    const float* acc, __nv_bfloat16* bt, int levels, int pq,
    const float* __restrict__ phi, const float* __restrict__ gram,
    float* __restrict__ raw, float* __restrict__ nrm2) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pqp = (pq + 7) & ~7;        // phi's columns, padded to 8
  const int np = pqp + kLevelK;         // B's columns: phi, then gram
  const int lpq = levels * pq;
  // bt[n][m] = B[m][n]: phi[l, m, n] for n < pq, 0 up to pqp, then
  // gram[l, m, n - pqp]. Element i of a level, in phi's and gram's own
  // (coalesced) order, i < kLevelK * np: phi [m][n] (i < 64 pq), the zero
  // columns, gram [m][k]. A level's elements are loaded into registers
  // while the level before multiplies.
  constexpr int kRegs = ((kMaxPQ + kLevelK) * kLevelK + kThreads - 1) / kThreads;
  float breg[kRegs];
  auto load_b = [&](int l) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = tid + r * kThreads;
      float v = 0.0f;
      if (i < kLevelK * pq)
        v = phi[l * kLevelK * pq + i];
      else if (i >= kLevelK * pqp && i < kLevelK * np)
        v = gram[l * kLevelK * kLevelK + i - kLevelK * pqp];
      breg[r] = v;
    }
  };
  load_b(0);
  for (int l = 0; l < levels; ++l) {
    __syncthreads();  // the staging area is free
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = tid + r * kThreads;
      int n, m;
      if (i < kLevelK * pq) {
        n = i % pq;
        m = i / pq;
      } else if (i < kLevelK * pqp) {
        n = pq + (i - kLevelK * pq) / kLevelK;
        m = (i - kLevelK * pq) % kLevelK;
      } else {
        n = pqp + (i - kLevelK * pqp) % kLevelK;
        m = (i - kLevelK * pqp) / kLevelK;
      }
      if (i < kLevelK * np) bt[n * kBRow + m] = __float2bfloat16_rn(breg[r]);
    }
    if (l + 1 < levels) load_b(l + 1);
    __syncthreads();
    if (warp < kPix / 16) {
      const int p0 = warp * 16;
      const float* a = acc + l * kLevelK * kPad + p0 + g;
      unsigned af[4][4];  // A fragments of the 4 k-steps
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k0 = ks * 16 + 2 * t4;
        af[ks][0] = pack_bf16(a[k0 * kPad], a[(k0 + 1) * kPad]);
        af[ks][1] = pack_bf16(a[k0 * kPad + 8], a[(k0 + 1) * kPad + 8]);
        af[ks][2] = pack_bf16(a[(k0 + 8) * kPad], a[(k0 + 9) * kPad]);
        af[ks][3] = pack_bf16(a[(k0 + 8) * kPad + 8], a[(k0 + 9) * kPad + 8]);
      }
      float n2a = 0.0f, n2b = 0.0f;  // rows g and g + 8
#pragma unroll 2
      for (int nt = 0; nt < np / 8; ++nt) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const __nv_bfloat16* b = bt + (nt * 8 + g) * kBRow + 2 * t4;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_bf16(d, af[ks], *reinterpret_cast<const unsigned*>(b + ks * 16),
                   *reinterpret_cast<const unsigned*>(b + ks * 16 + 8));
        const int n = nt * 8 + 2 * t4;  // d[0], d[2] at column n; d[1], d[3]
        if (n < pqp) {                  // at n + 1
          float* r0 = raw + (size_t)(p0 + g) * lpq + l * pq + n;
          float* r1 = r0 + 8 * (size_t)lpq;
          if (n < pq) {
            r0[0] = d[0];
            r1[0] = d[2];
          }
          if (n + 1 < pq) {
            r0[1] = d[1];
            r1[1] = d[3];
          }
        } else {
          const float* f = acc + (l * kLevelK + n - pqp) * kPad + p0 + g;
          n2a += d[0] * f[0] + d[1] * f[kPad];
          n2b += d[2] * f[8] + d[3] * f[kPad + 8];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        n2a += __shfl_xor_sync(0xffffffffu, n2a, off);
        n2b += __shfl_xor_sync(0xffffffffu, n2b, off);
      }
      if (t4 == 0) {
        nrm2[(p0 + g) * levels + l] = n2a;
        nrm2[(p0 + g + 8) * levels + l] = n2b;
      }
    }
  }
}

// Both blocks of a cluster meet: every thread of each arrives and waits
// (release / acquire: shared-memory writes before it are seen after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of p (in this block's shared memory) in the shared
// memory of the cluster's block `rank`.
__device__ __forceinline__ const float* cluster_map(const float* p,
                                                    unsigned rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// The query epilogue at any K, L and PQ (see the header; query_frag.cuh):
// warp w of the block takes 16 pixels, A the accumulators rounded to bf16
// and nrm2's last factor the f32 accumulator, as query_epilogue. kQA = 2:
// this block (cluster rank `rank`) holds channels [rank * half, ...) and
// its partner the others; it takes pixels [128 rank, 128 rank + 128).
template <int kQA>
__device__ __forceinline__ void query_any_epilogue(
    const float* acc, const QShape& s, const void* __restrict__ frag,
    int half, int rank, float* __restrict__ raw, float* __restrict__ nrm2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* acc_lo = acc;   // channels [0, half) (kQA = 2), else all
  const float* acc_hi = acc;   // channels [half, ...) (kQA = 2)
  int p_first = 0, n_warps = kPix / 16;
  if constexpr (kQA == 2) {
    cluster_sync();   // both halves of the tile's accumulators are complete
    const float* other = cluster_map(acc, rank ^ 1);
    acc_lo = rank == 0 ? acc : other;
    acc_hi = rank == 0 ? other : acc;
    p_first = rank * (kPix / 2);
    n_warps = kPix / 32;
  }
  if (warp < n_warps) {
    const int pa = p_first + warp * 16 + g, pb = pa + 8;
    const size_t level_bytes = (size_t)s.NT * s.KS * 32 * sizeof(uint2);
    for (int l = 0; l < s.L; ++l) {
      // Level column k of pixel p (0 past K).
      auto v = [&](int p, int k) -> float {
        if (k >= s.K) return 0.0f;
        const int c = l * s.K + k;
        if constexpr (kQA == 2) {
          return c < half ? acc_lo[c * kPad + p]
                          : acc_hi[(c - half) * kPad + p];
        } else {
          return acc[c * kPad + p];
        }
      };
      auto a_frag = [&](int ks, unsigned* a) {
        const int k = 16 * ks + 2 * t4;
        a[0] = pack_bf16(v(pa, k), v(pa, k + 1));
        a[1] = pack_bf16(v(pb, k), v(pb, k + 1));
        a[2] = pack_bf16(v(pa, k + 8), v(pa, k + 9));
        a[3] = pack_bf16(v(pb, k + 8), v(pb, k + 9));
      };
      auto w_at = [&](int h, int m) -> float { return v(h ? pb : pa, m); };
      auto raw_at = [&](int h, int q, float val) {
        raw[(size_t)(h ? pb : pa) * s.L * s.PQ + l * s.PQ + q] = val;
      };
      float n2a = 0.0f, n2b = 0.0f;
      qf_level<true>(static_cast<const char*>(frag) + l * level_bytes, s,
                     a_frag, w_at, raw_at, n2a, n2b);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        n2a += __shfl_xor_sync(0xffffffffu, n2a, off);
        n2b += __shfl_xor_sync(0xffffffffu, n2b, off);
      }
      if (t4 == 0) {
        nrm2[pa * s.L + l] = n2a;
        nrm2[pb * s.L + l] = n2b;
      }
    }
  }
  if constexpr (kQA == 2) {
    cluster_sync();   // the partner is done with this block's accumulators
  }
}

// Coalesced write of the tile's [kPix, width] block from acc [width][kPad]
// into rows of `stride` elements: element i = q * width + c; bf16 two
// channels a store where width and stride are even.
template <int kT, typename Out>
__device__ __forceinline__ void write_tile(const float* acc, int width,
                                           Out* out, size_t stride) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<Out, __nv_bfloat16>::value) {
    if (width % 2 == 0 && stride % 2 == 0) {
      const int hw = width / 2;
      int q = tid / hw, c = tid % hw;
      const int dq = kT / hw, dc = kT % hw;
      while (q < kPix) {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)q * stride + 2 * c) =
            __floats2bfloat162_rn(acc[2 * c * kPad + q],
                                  acc[(2 * c + 1) * kPad + q]);
        c += dc;
        q += dq;
        if (c >= hw) {
          c -= hw;
          ++q;
        }
      }
      return;
    }
  }
  int q = tid / width, c = tid % width;
  const int dq = kT / width, dc = kT % width;
  while (q < kPix) {
    const float v = acc[c * kPad + q];
    if constexpr (std::is_same<Out, __nv_bfloat16>::value)
      out[(size_t)q * stride + c] = __float2bfloat16_rn(v);
    else
      out[(size_t)q * stride + c] = v;
    c += dc;
    q += dq;
    if (c >= width) {
      c -= width;
      ++q;
    }
  }
}

// kFast16: state from fast16 rows; kQuery: the fused query epilogue (kQA:
// 0 the K = 64 one, 1 any shape, 2 any shape with a cluster of two blocks a
// tile); kCells: bf16 cell math (fast16 rows only); kDense: each entry's
// own feature row. The modes are template flags and each pointer a __restrict__
// parameter, so that each instantiation compiles only its own code: with
// the pointers in a struct parameter the f32 blend's accumulate loop
// rebuilt its shared-memory address for every pair and ran ~45% slower at
// 1080p on the card. kOwn threads a pixel: 3 where there are channels,
// one block of 768 threads an SM (what 192 channels' accumulators leave
// room for), at most 80 registers a thread; 1 for rgb only and dense
// launches of at most 64 columns, several blocks of 256 an SM (4 and 2),
// so that several tiles' walks overlap.
template <bool kFast16, bool kQuery, bool kCells, bool kDense, int kOwn,
          int kQA>
__global__ void __launch_bounds__(kOwn * kPix, kOwn == 1 ? 3 : 1)
    blend_kernel(const int* __restrict__ g_sorted,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count,
                 const float* __restrict__ geom, const float* __restrict__ qw,
                 const int* __restrict__ qi, const unsigned* __restrict__ rows,
                 const float* __restrict__ bg, int grid_x, int topk,
                 const float* __restrict__ phi,
                 const float* __restrict__ gram, int channels, int out_bf16,
                 int levels, int pq, float* __restrict__ rgb_out,
                 void* __restrict__ feat_out, float* __restrict__ nrm2_out,
                 float* __restrict__ t_out,
                 unsigned long long* __restrict__ stats, int per_level,
                 const float* __restrict__ feat_in, int feat_stride,
                 int feat_c0, const void* __restrict__ qfrag, QShape qs,
                 int tile_base, int grid_tiles) {
  constexpr int kB = batch_entries<kDense, kOwn>();
  constexpr int kPre = prefetch_words<kFast16, kDense, kOwn>();
  constexpr int kT = kOwn * kPix;                     // threads
  constexpr int kPer = (kB + kOwn - 1) / kOwn;        // phase (a) entries
  extern __shared__ __align__(16) unsigned char smem[];
  // kQA = 2: cluster rank `rank` holds channels [cb, cb + cw) of tile
  // blockIdx.x / 2 (its half, `half` wide for the layout); else all.
  const int rank = kQA == 2 ? (int)(blockIdx.x & 1) : 0;
  const int half = (channels + 1) / 2;
  const int held = kQA == 2 ? half : channels;
  const int cb = kQA == 2 ? rank * half : 0;
  const int cw = kQA == 2 ? (rank ? channels - half : half) : channels;
  float* acc = reinterpret_cast<float*>(smem);          // [held][kPad]
  unsigned* abuf = reinterpret_cast<unsigned*>(acc + acc_floats(held));
  float* stage = reinterpret_cast<float*>(
      abuf + (kOwn == 1 ? kPix : kB * kPix));           // 2 buffers
  const int stage_n = stage_floats<kDense, kOwn>(channels, topk);
  unsigned* s_ends = reinterpret_cast<unsigned*>(stage + 2 * stage_n);
  unsigned char* s_done =
      reinterpret_cast<unsigned char*>(s_ends + (kDense ? 0 : kB));
  unsigned char* s_nacc = s_done + kPix;

  const int tile = kQA == 2 ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tid & (kPix - 1);
  const int own = tid / kPix;  // owner: channel third and colour channel
  // Slot `tile` of the launch is grid tile tile_base + tile; one at or
  // past the grid's grid_tiles blends as empty (a strip's padding).
  const int gtile = tile_base + tile;
  const int start = tile_start[tile];
  const int count = gtile < grid_tiles ? tile_count[tile] : 0;
  const float px = (float)((gtile % grid_x) * kBlock + pix % kBlock);
  const float py = (float)((gtile / grid_x) * kBlock + pix / kBlock);

  // This owner's channels [c_lo, c_hi): a third (dense: rounded up to 4
  // columns, for float4 reads of the rows).
  int third = (cw + kOwn - 1) / kOwn;
  if (kDense) third = (third + 3) & ~3;
  const int c_lo = min(cw, own * third);
  const int c_hi = min(cw, c_lo + third);
  // The slots it reads: in the banded 3-level rows level own's, whose
  // valid offsets all lie in its band; else (up to 12 slots) each batch's
  // slots are sorted by owner (`part`) and it reads its own; else every
  // slot. All range-checked.
  int k_lo = 0, k_hi = topk;
  const bool banded3 = per_level > 0 && cw == kMaxLevels * kLevelK;
  if (banded3) {
    k_lo = own * per_level;
    k_hi = k_lo + per_level;
  }
  const bool part =
      !kDense && kOwn == kOwners && !banded3 && topk <= kFast16Pairs;
  const int lo_off = c_lo * kPad;
  const unsigned span_off = (unsigned)((c_hi - c_lo) * kPad);

  for (int i = tid; i < acc_floats(held) / 4; i += kT)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kOwn > 1 && own == 0) s_done[pix] = 0;

  // The raw-word prefetch: word s of this thread is word tid + s * kT
  // of a batch, entry e = that / nw, field f = that % nw.
  const int nw = entry_words<kFast16, kDense>(channels, topk);
  unsigned pw[kPre];
  int pg[kPre];
  auto load_ids = [&](int b0) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int e = (tid + s * kT) / nw;
      pg[s] = (e < kB && b0 + e < count) ? g_sorted[start + b0 + e] : -1;
    }
  };
  auto load_words = [&]() {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int w = tid + s * kT;
      pw[s] = pg[s] < 0 ? 0u
                        : load_word<kFast16, kDense>(
                              pg[s], w % nw, geom, qw, qi, rows, topk,
                              feat_in, feat_stride, feat_c0);
    }
  };
  auto store_words = [&](int b0, float* sg) {
#pragma unroll
    for (int s = 0; s < kPre; ++s) {
      const int w = tid + s * kT;
      const int e = w / nw;
      if (e < kB && b0 + e < count)
        store_word<kFast16, kDense, kB>(pw[s], e, w - e * nw, sg, topk,
                                        cw, per_level, cb);
    }
  };
  // The next batch into the other buffer; the words of the one after and
  // the ids of the one after that into registers.
  auto stage_next = [&](int it, int b0) {
    if (b0 + kB < count) {
      store_words(b0 + kB, stage + ((it + 1) & 1) * stage_n);
      load_words();
      load_ids(b0 + 3 * kB);
    }
  };
  load_ids(0);
  load_words();
  store_words(0, stage);
  load_ids(kB);
  load_words();
  load_ids(2 * kB);
  __syncthreads();

  float T = 1.0f;
  float col[kOwn == 1 ? 3 : 1] = {};  // this thread's colour channels
  float S = 0.0f;  // kCells: the log-sum of the included pairs' 1 - alpha
  __nv_bfloat16 tb = __float2bfloat16_rn(expf(round_bf16(S)));
  bool done = false;
  unsigned n_eval = 0, n_inc = 0;

  for (int it = 0, b0 = 0; b0 < count; ++it, b0 += kB) {
    const int nb = min(kB, count - b0);
    const float* sg = stage + (it & 1) * stage_n;

    if constexpr (kOwn == 1) {
      // No channels: one thread a pixel walks the batch, alpha inline.
      stage_next(it, b0);
      // Every lane runs all nb steps (done ones idle): a lane that left
      // the loop early would split the warp with no point to rejoin.
      float* a = acc + pix;
      for (int j = 0; j < nb; ++j) {
        if (done) continue;
        ++n_eval;
        const unsigned word = alpha_word<kCells>(sg, j, px, py);
        float w;
        bool ends;
        const bool inc =
            walk_step<kCells>(word, word != 0u, T, S, tb, w, ends);
        done = ends;
        n_inc += inc;
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const float c = col[o] + w * sg[j * kGeomStride + 6 + o];
          col[o] = inc ? c : col[o];
        }
        if (kDense && inc) {  // narrow dense: every column
          const float* f = sg + kB * kGeomStride + j * dense_stride(channels);
          for (int c = 0; c < channels; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(f + c);
            a[c * kPad] += w * v.x;
            if (c + 1 < channels) a[(c + 1) * kPad] += w * v.y;
            if (c + 2 < channels) a[(c + 2) * kPad] += w * v.z;
            if (c + 3 < channels) a[(c + 3) * kPad] += w * v.w;
          }
        }
      }
      if (__syncthreads_count(done) == kT) break;
      continue;
    }

    // (a) alpha of every (entry, pixel) pair of the batch: this thread's
    // kPer entries computed side by side, then stored.
    if (!s_done[pix]) {
      unsigned wd[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = own + i * kOwn;
        wd[i] = j < nb ? alpha_word<kCells>(sg, j, px, py) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = own + i * kOwn;
        if (j < nb) abuf[j * kPix + pix] = wd[i];
      }
    }
    __syncthreads();

    // (b) the transmittance walk, one thread a pixel, in entry order, on
    // the batch's words in registers: w over each included pair's word.
    if (own == 0) {
      int jend = 0;  // entries to accumulate; 0 for a pixel done before
      if (!done) {
        jend = nb;
        for (int j0 = 0; j0 < nb; j0 += kChunk) {  // nb: warp-uniform
          unsigned wv[kChunk];
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            wv[i] = j0 + i < jend ? abuf[(j0 + i) * kPix + pix] : 0u;
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            float w;
            bool ends;
            const bool inc = walk_step<kCells>(wv[i], !done && wv[i] != 0u,
                                               T, S, tb, w, ends);
            jend = ends ? j0 + i : jend;
            done = done || ends;
            n_inc += inc;
            wv[i] = inc ? __float_as_uint(w) : 0u;
          }
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            if (j0 + i < nb) abuf[(j0 + i) * kPix + pix] = wv[i];
        }
        n_eval += done ? jend + 1 : nb;
        s_done[pix] = done;
      }
      s_nacc[pix] = (unsigned char)jend;
    } else if (part && own == 1 && pix < nb) {
      // Meanwhile one idle warp sorts each entry's slots by owner.
      s_ends[pix] = partition_slots(
          reinterpret_cast<int2*>(stage + (it & 1) * stage_n +
                                  kB * kGeomStride) + pix * topk,
          topk, third * kPad, 2 * third * kPad);
    }
    const bool all_done = __syncthreads_count(own == 0 && done) == kPix;
    if (!all_done) stage_next(it, b0);

    // (c) accumulate this owner's channels and colour channel, entry by
    // entry, the batch's weights in registers.
    {
      const int nacc = s_nacc[pix];
      float* a = acc + pix;
      for (int j0 = 0; j0 < nb; j0 += kChunk) {  // nb: warp-uniform
        float wv[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          wv[i] = j0 + i < nacc ? __uint_as_float(abuf[(j0 + i) * kPix + pix])
                                : 0.0f;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const int j = j0 + i;
          const float w = wv[i];
          if (w == 0.0f) continue;  // skipped, or past the pixel's end
          col[0] += w * sg[j * kGeomStride + 6 + own];
          if constexpr (kDense) {
            const float* f =
                sg + kB * kGeomStride + j * dense_stride(channels);
            for (int c = c_lo; c < c_hi; c += 4) {
              const float4 v = *reinterpret_cast<const float4*>(f + c);
              a[c * kPad] += w * v.x;
              if (c + 1 < c_hi) a[(c + 1) * kPad] += w * v.y;
              if (c + 2 < c_hi) a[(c + 2) * kPad] += w * v.z;
              if (c + 3 < c_hi) a[(c + 3) * kPad] += w * v.w;
            }
          } else {
            const int2* slot =
                reinterpret_cast<const int2*>(sg + kB * kGeomStride) + j * topk;
            int k0 = k_lo, k1 = k_hi;
            if (part) {
              const unsigned ends = s_ends[j];
              k1 = (ends >> (8 * own)) & 0xFF;
              k0 = own == 0 ? 0 : (ends >> (8 * own - 8)) & 0xFF;
            }
#pragma unroll 4
            for (int k = k0; k < k1; ++k) {
              const int2 v = slot[k];
              if ((unsigned)(v.x - lo_off) < span_off)
                a[v.x] += w * __int_as_float(v.y);
            }
          }
        }
      }
    }
    __syncthreads();
    if (all_done) break;
  }
  if constexpr (kCells) T = expf(S);
  if (own == 0) {  // the final T, in the alpha buffer the walk left free
    reinterpret_cast<float*>(abuf)[pix] = T;
    if (stats != nullptr && rank == 0) add_stats(stats, n_eval, n_inc);
  }
  __syncthreads();

  const size_t p = (size_t)tile * kPix + pix;
  if ((!kDense || rgb_out != nullptr) && rank == 0) {
    const float t = reinterpret_cast<const float*>(abuf)[pix];
#pragma unroll
    for (int o = 0; o < (kOwn == 1 ? 3 : 1); ++o) {
      const int ch = kOwn == 1 ? o : own;
      const float c = out_bf16 ? round_bf16(col[o]) : col[o];
      rgb_out[3 * p + ch] = c + t * bg[ch];
    }
    if (own == 0) t_out[p] = t;
  }
  if constexpr (kQuery && kQA == 0) {  // feat_out: raw [T, 256, levels * pq]
    query_epilogue(acc, reinterpret_cast<__nv_bfloat16*>(abuf), levels, pq,
                   phi, gram,
                   static_cast<float*>(feat_out) +
                       (size_t)tile * kPix * levels * pq,
                   nrm2_out + (size_t)tile * kPix * levels);
  } else if constexpr (kQuery) {
    query_any_epilogue<kQA>(acc, qs, qfrag, half, rank,
                            static_cast<float*>(feat_out) +
                                (size_t)tile * kPix * qs.L * qs.PQ,
                            nrm2_out + (size_t)tile * kPix * qs.L);
  } else if constexpr (kDense) {
    // The tile's [kPix, channels] block at columns feat_c0.. of its
    // [kPix, feat_stride] rows.
    write_tile<kT>(acc, channels,
               static_cast<float*>(feat_out) +
                   (size_t)tile * kPix * feat_stride + feat_c0,
               (size_t)feat_stride);
  } else if (channels > 0) {
    const size_t base = (size_t)tile * kPix * channels;
    if (out_bf16)
      write_tile<kT>(acc, channels, static_cast<__nv_bfloat16*>(feat_out) + base,
                 (size_t)channels);
    else
      write_tile<kT>(acc, channels, static_cast<float*>(feat_out) + base,
                 (size_t)channels);
  }
}

// Typed nulls for the parameters a mode does not read.
constexpr const float* kNoF32 = nullptr;
constexpr const int* kNoIdx = nullptr;
constexpr const unsigned* kNoRows = nullptr;
constexpr float* kNoOut = nullptr;
constexpr const void* kNoFrag = nullptr;

// Sets the shared-memory size of one instantiation for `channels` and
// `topk` and launches it with the kernel's argument list `args`.
// Channels a block's accumulators hold (kQA = 2: half, rounded up).
template <int kQA>
__host__ __device__ constexpr int held_channels(int channels) {
  return kQA == 2 ? (channels + 1) / 2 : channels;
}

template <bool kFast16, bool kQuery, bool kCells, bool kDense, int kOwn,
          int kQA, typename... Args>
int launch_blend(int num_tiles, int channels, int topk, void* stream,
                 Args... args) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  constexpr int kB = batch_entries<kDense, kOwn>();
  if (kB * entry_words<kFast16, kDense>(channels, topk) >
      prefetch_words<kFast16, kDense, kOwn>() * kOwn * kPix)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      blend_smem<kDense, kOwn>(held_channels<kQA>(channels), topk);
  auto kernel = blend_kernel<kFast16, kQuery, kCells, kDense, kOwn, kQA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    if constexpr (kQA == 2) {   // a cluster of two blocks a tile
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 2;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(2 * num_tiles);
      cfg.blockDim = dim3(kOwn * kPix);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = static_cast<cudaStream_t>(stream);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, kernel, args...);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      kernel<<<num_tiles, kOwn * kPix, smem,
               static_cast<cudaStream_t>(stream)>>>(args...);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out: blocks an SM, dynamic shared bytes, registers a thread, local
// (spill and stack) bytes a thread, threads a block.
template <bool kFast16, bool kQuery, bool kCells, bool kDense, int kOwn,
          int kQA = 0>
int occupancy(int channels, int topk, int* out) {
  cudaGetLastError();
  const size_t smem =
      blend_smem<kDense, kOwn>(held_channels<kQA>(channels), topk);
  auto kernel = blend_kernel<kFast16, kQuery, kCells, kDense, kOwn, kQA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kOwn * kPix, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kOwn * kPix;
  return 0;
}

}  // namespace

// The f32 modes (rgb, quick) on num_tiles slots: slot t is grid tile
// tile_base + t (a strip of the grid, the Gaussian-sharded path's tile
// owner), and slots at or past grid_tiles blend as empty. The whole grid
// is tile_base 0, num_tiles = grid_tiles.
extern "C" int lsv2_blend_tiles(const int* g_sorted, const int* tile_start,
                                const int* tile_count, const float* geom,
                                const float* qw, const int* qi,
                                const float* bg, int num_tiles, int grid_x,
                                int topk, int channels, int tile_base,
                                int grid_tiles, float* rgb_out,
                                float* feat_out, float* t_out,
                                unsigned long long* stats, void* stream) {
  auto go = [&](auto owners) {
    return launch_blend<false, false, false, false, decltype(owners)::value,
                        0>(
        num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
        geom, qw, qi, kNoRows, bg, grid_x, topk, kNoF32, kNoF32, channels, 0,
        0, 0, rgb_out, static_cast<void*>(feat_out), kNoOut, t_out, stats, 0,
        kNoF32, 0, 0, kNoFrag, QShape{}, tile_base, grid_tiles);
  };
  return channels > 0 ? go(std::integral_constant<int, kOwners>{})
                      : go(std::integral_constant<int, 1>{});
}

// rows: [N, 16] 32-bit words, 64 bytes a Gaussian.
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
    return launch_blend<true, false, decltype(cells)::value, false, kOwners,
                        0>(
        num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
        kNoF32, kNoF32, kNoIdx, static_cast<const unsigned*>(rows), bg,
        grid_x, topk, kNoF32, kNoF32, channels, out_bf16, 0, 0, rgb_out,
        feat_out, kNoOut, t_out, stats, per_level, kNoF32, 0, 0, kNoFrag,
        QShape{}, 0, INT_MAX);
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
    return launch_blend<true, true, decltype(cells)::value, false, kOwners,
                        0>(
        num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
        kNoF32, kNoF32, kNoIdx, static_cast<const unsigned*>(rows), bg,
        grid_x, topk, phi, gram, channels, 0, levels, pq, rgb_out,
        static_cast<void*>(raw_out), nrm2_out, t_out, stats, per_level,
        kNoF32, 0, 0, kNoFrag, QShape{}, 0, INT_MAX);
  };
  return cells_bf16 ? go(std::true_type{}) : go(std::false_type{});
}

// Query mode at any levels, K and pq with levels * K <= 256 (fast16's u8
// indices): as lsv2_blend_tiles_query; frag: scratch of frag_words 32-bit
// words for B's fragments (query_frag.cuh, bf16).
extern "C" int lsv2_blend_tiles_query_any(
    const int* g_sorted, const int* tile_start, const int* tile_count,
    const void* rows, const float* bg, const float* phi, const float* gram,
    int num_tiles, int grid_x, int topk, int levels, int K, int pq,
    int per_level, int cells_bf16, float* rgb_out, float* raw_out,
    float* nrm2_out, float* t_out, unsigned long long* stats, void* frag,
    long long frag_words, void* stream) {
  cudaGetLastError();
  if (levels < 1 || K < 1 || pq < 1 || levels * K > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const QShape s = qf_shape(true, levels, K, pq);
  if (frag_words < qf_words(true, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      qf_split<true>(phi, gram, s, frag, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const int channels = levels * K;
  auto go = [&](auto cells, auto qa) {
    return launch_blend<true, true, decltype(cells)::value, false, kOwners,
                        decltype(qa)::value>(
        num_tiles, channels, topk, stream, g_sorted, tile_start, tile_count,
        kNoF32, kNoF32, kNoIdx, static_cast<const unsigned*>(rows), bg,
        grid_x, topk, phi, gram, channels, 0, levels, pq, rgb_out,
        static_cast<void*>(raw_out), nrm2_out, t_out, stats, per_level,
        kNoF32, 0, 0, static_cast<const void*>(frag), s, 0,
        INT_MAX);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  if (channels > kMaxLevels * kLevelK)
    return cells_bf16 ? go(std::true_type{}, Two{})
                      : go(std::false_type{}, Two{});
  return cells_bf16 ? go(std::true_type{}, One{})
                    : go(std::false_type{}, One{});
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
  auto go = [&](auto owners) {
    return launch_blend<false, false, false, true, decltype(owners)::value,
                        0>(
        num_tiles, channels, 0, stream, g_sorted, tile_start, tile_count,
        geom, kNoF32, kNoIdx, kNoRows, bg, grid_x, 0, kNoF32, kNoF32,
        channels, 0, 0, 0, rgb_out, static_cast<void*>(feat_out), kNoOut,
        t_out, stats, 0, feats, stride, c0, kNoFrag, QShape{}, 0,
        INT_MAX);
  };
  return channels <= kNarrowDense ? go(std::integral_constant<int, 1>{})
                                  : go(std::integral_constant<int, kOwners>{});
}

// Occupancy of one instantiation at `channels` and `topk` (see occupancy):
// mode 0 f32, 1 fast16, 2 query, 3 dense, 4 rgb only, 5 narrow dense (one
// thread a pixel), 6 query at any shape, 7 the same with a cluster of two
// blocks a tile (channels the tile's, not the block's); cells_bf16 for
// modes 1, 2, 6 and 7.
extern "C" int lsv2_blend_occupancy(int mode, int cells_bf16, int channels,
                                    int topk, int* out) {
  constexpr int k3 = kOwners;
  switch (mode * 2 + (cells_bf16 != 0)) {
    case 0: return occupancy<false, false, false, false, k3>(channels, topk, out);
    case 2: return occupancy<true, false, false, false, k3>(channels, topk, out);
    case 3: return occupancy<true, false, true, false, k3>(channels, topk, out);
    case 4: return occupancy<true, true, false, false, k3>(channels, topk, out);
    case 5: return occupancy<true, true, true, false, k3>(channels, topk, out);
    case 6: return occupancy<false, false, false, true, k3>(channels, topk, out);
    case 8: return occupancy<false, false, false, false, 1>(channels, topk, out);
    case 10: return occupancy<false, false, false, true, 1>(channels, topk, out);
    case 12: return occupancy<true, true, false, false, k3, 1>(channels, topk, out);
    case 13: return occupancy<true, true, true, false, k3, 1>(channels, topk, out);
    case 14: return occupancy<true, true, false, false, k3, 2>(channels, topk, out);
    case 15: return occupancy<true, true, true, false, k3, 2>(channels, topk, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
