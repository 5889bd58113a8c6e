// K8: order-preserving partition of the depth-ordered Gaussians into
// per-tile segments, with the exact cull at the last level.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_cascade.py::
// _partition_kernel (pallas_call at :376 in _run_level, driven by
// cascade_binning :411). There, each level compacts 256-entry chunks per
// child with an MXU one-hot matmul and streams 32-float rows through VMEM
// rings flushed at 128-lane offsets, because a TPU core has no gather or
// scatter, and needs four levels (8-tile bands, supertile columns, tile
// rows, tiles) to keep the fan-out of one pass small. Hopper scatters
// natively, so two levels suffice: the depth-ordered stream to tile rows
// (children y of the Gaussian's rect), then each row to its tiles
// (children x of the rect that the exact cull of csrc/cull.cuh keeps, the
// same code and -fmad=false build as K1, so the decisions are K1's bit for
// bit). Row-major (y, x) buckets are the blend's tile order.
//
// A level is a stable counting sort with up to 1,024 digits (children) in
// which an item may land in several digits: totals first, one exclusive
// scan of them, then a write pass over 256-item chunks. Level 0 has one
// bucket and is counted before the depth sort, so its write pass finds
// each child's offset inside the bucket by a decoupled look-back over the
// earlier chunks' published counts (chunks taken in order with an atomic
// ticket), as CUB's onesweep does a digit; level 1's cull pass keeps each
// chunk's per-child counts, so a scan launch gives its write pass every
// chunk's offsets (a look-back there waited on the chunks still at work
// and was slower). Five launches after the wrapper's one zero fill,
// around the depth sort (torch.sort, as JAX's lax.sort sits outside its
// kernel):
//   0 level0_count: the depth keys (bits & 0x7FFFFFFF) for the sort, each
//     Gaussian's 32-byte record (cull state and clamped rect, so that the
//     later passes gather one sector an item), and the rows' totals as a
//     difference array (counting is order-free, so it runs before the
//     sort); its last block (atomic ticket) scans them into the row bases
//     (disabled past the budget), the rows' item counts and level 1's
//     chunk starts;
//   1 level0_write: the sorted stream into the rows (a warp's bits a row
//     from one ballot each over the rows its items span);
//   2 level1_count: each (item, tile) pair of a row chunk culled once, the
//     pairs spread evenly over the block; the keep bits of an item's first
//     64 tiles stored for the write pass (a ballot, ORed in once a warp and
//     item); the chunk's counts and the tiles' totals; its last block
//     scans the totals into the outputs' starts, counts, total, overflow;
//   3 level1_offsets: each (row, tile)'s counts scanned over the row's
//     chunks into the chunks' offsets;
//   4 level1_write: the rows into the tiles from the keep bits (a rect
//     wider than 64 tiles re-decides the tiles past its 64th here), and the
//     output past the total zeroed.
// Every pass runs as many 256-thread blocks as the card holds at once, each
// looping over chunks. Ranks keep item order: each write block sets, per
// warp and child, a bit a lane (order-free); an item's rank is the
// chunk's offset + the earlier warps' popcounts + the popcount of
// its warp's bits below its lane. A child whose segment would end past the
// budget is disabled with every child after it (offset -1, nothing
// written), as JAX's _bases disables buckets; that sets the overflow flag.
//
// Bound on this card: bytes (the depth keys, the ids read and written once
// a level, the rects and cull state gathered once an item, the outputs) and
// the cull's ~60 f32 operations a (Gaussian, tile) pair of the rect, taken
// once. The look-back words and level 1's chunk counts ([chunks,
// children], 4 B each) are the design's own traffic. The passes are
// latency-bound (a chunk's dependent gathers, level 0's look-back):
// profile_cascade.py --phases splits the level-1 passes' cycles.
#include <cuda_runtime.h>

#include "cull.cuh"
#include "phase_marks.cuh"

// Phase marks of the level-1 passes (csrc/phase_marks.cuh; read by
// profile_cascade.py --phases): level1_count 0 staging, 1 the culled
// pairs, 2 the totals' atomics and the ticket, 3 the last block's scan;
// level1_write 4 staging and bits, 5 the chunk's offsets, 6 writes.
PHASE_STORAGE(g_cascade_phase, lsv2_cascade_phases)

namespace {

using lsv2::TileCull;

constexpr int kChunk = 256;            // items a block, one a thread
constexpr int kWarps = kChunk / 32;
constexpr int kMaxFan = 1024;          // children a bucket (tiles a side)
constexpr int kMaskBits = 64;          // tiles an item's keep bits cover
constexpr unsigned kFull = 0xffffffffu;
// Level 0's look-back word: 2 flag bits (0 not yet, 1 the chunk's own
// count, 2 the inclusive prefix through the chunk), 30 value bits.
constexpr unsigned kAggregate = 1u << 30, kInclusive = 2u << 30;
constexpr unsigned kValue = kAggregate - 1;

struct Args {
  int n, grid_x, grid_y, budget;
  const float* depth;        // [N]
  const int* rect_min;       // [N, 2] tile rect, inclusive
  const int* rect_max;       // [N, 2] exclusive
  const int* tiles_touched;  // [N]
  const float* xy;           // cull state
  const float* conic;
  const float* opacity;
  float inv_cull_alpha;
  const long long* order;    // [N] the depth order (torch.sort's indices)
  float4* gauss;             // [N, 2] each Gaussian's record (`Record`)
  int* zbuf;        // zeroed: row diffs [gy + 1], tickets [3], tiles [T]
  int* meta;        // row bases [gy], row counts [gy], chunk starts
                    // [gy + 1], level 0's overflow [1]
  int* keys;        // [N] depth keys
  unsigned* status0;             // [ceil(N / 256), gy]
  int* counts1;                  // [chunks1, gx] level 1's chunk counts,
                                 // then their offsets (-1: disabled)
  int* rows;                     // [budget] level 0's output
  unsigned long long* mask1;     // [budget] keep bits, by row position
  int* out;                      // [budget] Gaussian ids by tile
  int* start;                    // [T]
  int* count;                    // [T]
  int* total;                    // []
  bool* overflow;                // []

  __device__ int* row_diff() const { return zbuf; }
  __device__ unsigned* tickets() const {
    return reinterpret_cast<unsigned*>(zbuf + grid_y + 1);
  }
  // Level 1's per-tile totals; level1_count's scan overwrites them with
  // the tiles' offsets (-1: disabled).
  __device__ int* tiles() const { return zbuf + grid_y + 4; }
  __device__ int* row_base() const { return meta; }
  __device__ int* row_count() const { return meta + grid_y; }
  __device__ int* chunk_first() const { return meta + 2 * grid_y; }
  __device__ int* overflow0() const { return meta + 3 * grid_y + 1; }
};

// What the passes after level0_count read of a Gaussian, in one 32-byte
// sector (level0_count writes it, in Gaussian order): its cull state and
// its rect clamped to the grid, as 16-bit x and y ranges (the y range
// empty when tiles_touched is 0).
struct Record {
  TileCull cull;
  int x, y;  // lo | hi << 16

  __device__ static void store(float4* gauss, int g, const TileCull& c,
                               int x0, int x1, int y0, int y1) {
    gauss[2 * g] = make_float4(c.cx, c.cy, c.k.ca, c.k.cb);
    gauss[2 * g + 1] = make_float4(c.k.cc, c.thresh, __int_as_float(
        x0 | x1 << 16), __int_as_float(y0 | y1 << 16));
  }
  __device__ static Record load(const float4* gauss, int g) {
    const float4 p = __ldg(gauss + 2 * g), q = __ldg(gauss + 2 * g + 1);
    Record r;
    r.cull.cx = p.x;
    r.cull.cy = p.y;
    r.cull.k.ca = p.z;
    r.cull.k.cb = p.w;
    r.cull.k.cc = q.x;
    r.cull.thresh = q.y;
    r.x = __float_as_int(q.z);
    r.y = __float_as_int(q.w);
    return r;
  }
  __device__ int x0() const { return x & 0xFFFF; }
  __device__ int x1() const { return x >> 16; }
  __device__ int y0() const { return y & 0xFFFF; }
  __device__ int y1() const { return y >> 16; }
};

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Exclusive scan of one value a thread over the block; `sums` holds kWarps
// values of scratch. Returns the thread's prefix; `total` the block's sum.
template <typename T>
__device__ T block_exclusive_scan(T v, T* sums, T& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  total = all;
  return before + x - v;
}

// True in the block that finishes last of its grid (every other block's
// global writes and atomics are visible to it). One fence a block: the
// barrier orders the block's writes before thread 0's, whose fence is
// cumulative.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Level 0's scan, in level0_count's last block: the rows' totals (the
// inclusive scan of the difference array), their flat exclusive scan
// against the budget, and level 1's chunk starts. fan <= 4 x kChunk.
__device__ void scan_rows(const Args& a) {
  __shared__ long long sums[kWarps];
  const int fan = a.grid_y, per = (fan + kChunk - 1) / kChunk;
  const int f0 = static_cast<int>(threadIdx.x) * per;
  long long v[4], s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = f0 + k;
    v[k] = (k < per && f < fan) ? __ldcg(a.row_diff() + f) : 0;
    s += v[k];
  }
  long long all;
  long long run = block_exclusive_scan(s, sums, all);
  s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // v: the rows' totals
    run += v[k];
    v[k] = (k < per && f0 + k < fan) ? run : 0;
    s += v[k];
  }
  long long ends = block_exclusive_scan(s, sums, all);
  long long chunks[4], cs = 0;
  int over = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = f0 + k;
    chunks[k] = 0;
    if (k < per && f < fan) {
      const long long base = ends;
      ends += v[k];
      const bool on = ends <= a.budget;
      a.row_base()[f] = on ? static_cast<int>(base) : -1;
      a.row_count()[f] = on ? static_cast<int>(v[k]) : 0;
      over |= !on && v[k] > 0;
      chunks[k] = on ? (v[k] + kChunk - 1) / kChunk : 0;
    }
    cs += chunks[k];
  }
  long long c = block_exclusive_scan(cs, sums, all);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < per && f0 + k < fan)
      a.chunk_first()[f0 + k] = static_cast<int>(c);
    c += chunks[k];
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    a.chunk_first()[fan] = static_cast<int>(all);
    *a.overflow0() = over;
  }
}

// Level 1's scan, in level1_count's last block: the tiles' flat exclusive
// scan against the budget into start, count, total, overflow, and the
// tiles' offsets for level1_write (in place of their totals).
__device__ void scan_tiles(const Args& a) {
  __shared__ long long sums[kWarps];
  const int n_tiles = a.grid_x * a.grid_y;
  const int per = (n_tiles + kChunk - 1) / kChunk;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, n_tiles);
  const int t1 = min(t0 + per, n_tiles);
  int* tiles = a.tiles();
  long long s = 0;
  for (int t = t0; t < t1; ++t) s += __ldcg(tiles + t);
  long long all;
  long long run = block_exclusive_scan(s, sums, all);
  long long kept = 0;
  int over = 0;
  for (int t = t0; t < t1; ++t) {
    const int tot = __ldcg(tiles + t);
    const long long end = run + tot;
    const bool on = end <= a.budget;
    a.start[t] = on ? static_cast<int>(run) : 0;
    a.count[t] = on ? tot : 0;
    tiles[t] = on ? static_cast<int>(run) : -1;
    over |= !on && tot > 0;
    kept += on ? tot : 0;
    run = end;
  }
  long long kept_all;
  block_exclusive_scan(kept, sums, kept_all);
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    *a.total = static_cast<int>(kept_all);
    *a.overflow = over || __ldcg(a.overflow0());
  }
}

// Level 0's row bases, counts and chunk starts, staged in shared memory by
// the level-1 passes (rows <= kMaxFan).
struct RowMeta {
  int word[3 * kMaxFan + 1];

  __device__ void stage(const Args& a) {
    for (int i = threadIdx.x; i <= 3 * a.grid_y; i += kChunk)
      word[i] = __ldcg(a.meta + i);
  }
  // The row of level-1 chunk c: the last b with chunk_first[b] <= c.
  __device__ int row_of(int rows, int c) const {
    const int* first = word + 2 * rows;
    int lo = 0, hi = rows;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (first[mid] <= c) lo = mid; else hi = mid;
    }
    return lo;
  }
};

// Level 0's write block's offsets: from the per-warp child bits, each
// child's count in chunk c is published, its prefix over the earlier chunks
// found by look-back, and pre[w][f] set to where warp w's first item of
// child f goes (-1: disabled child). The look-back reads kLook earlier
// chunks' words at once.
__device__ void chunk_offsets(unsigned* status, int c, int fan,
                              const unsigned* bits, int* pre,
                              const int* base) {
  constexpr int kLook = 8;
  unsigned* row = status + static_cast<size_t>(c) * fan;
  for (int f = threadIdx.x; f < fan; f += kChunk) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int k = __popc(bits[w * fan + f]);
      pre[w * fan + f] = run;
      run += k;
    }
    store_status(row + f, (c == 0 ? kInclusive : kAggregate) | run);
  }
  for (int f = threadIdx.x; f < fan; f += kChunk) {
    unsigned excl = 0;
    if (c != 0) {
      for (int p = c - 1;;) {
        unsigned word[kLook];
#pragma unroll
        for (int q = 0; q < kLook; ++q)
          word[q] = load_status(status + static_cast<size_t>(max(p - q, 0))
                                             * fan + f);
        int used = 0;
        bool found = false;
#pragma unroll
        for (int q = 0; q < kLook; ++q) {
          const unsigned flag = word[q] & ~kValue;
          if (flag == 0) break;  // not yet published: read again from here
          excl += word[q] & kValue;
          ++used;
          if (flag == kInclusive) {
            found = true;
            break;
          }
        }
        if (found) break;
        p -= used;
      }
      const unsigned own = pre[(kWarps - 1) * fan + f]
                           + __popc(bits[(kWarps - 1) * fan + f]);
      store_status(row + f, kInclusive | min(excl + own, kValue));
    }
    const int b = base[f];
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      pre[w * fan + f] = b < 0 ? -1 : b + static_cast<int>(excl)
                                          + pre[w * fan + f];
  }
}

// The passes run as many blocks as the card holds at once (`resident`),
// each looping over chunks: level0_write takes them in order with a
// ticket (its look-back waits only on chunks already taken), the others
// stride over them.

__global__ void __launch_bounds__(kChunk)
    level0_count(const Args a) {
  __shared__ int diff[kMaxFan + 1];
  const int fan = a.grid_y, chunks = (a.n + kChunk - 1) / kChunk;
  for (int f = threadIdx.x; f <= fan; f += kChunk) diff[f] = 0;
  __syncthreads();
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    for (int f = threadIdx.x; f < fan; f += kChunk)  // level 0's write
      a.status0[static_cast<size_t>(c) * fan + f] = 0;
    const int i = c * kChunk + threadIdx.x;
    if (i < a.n) {
      a.keys[i] = __float_as_int(a.depth[i]) & 0x7FFFFFFF;
      int lo = 0, hi = 0;
      if (a.tiles_touched[i] > 0) {
        lo = max(a.rect_min[2 * i + 1], 0);
        hi = max(min(a.rect_max[2 * i + 1], fan), lo);
        if (lo < hi) {
          atomicAdd(&diff[lo], 1);
          atomicAdd(&diff[hi], -1);
        }
      }
      const int x0 = max(a.rect_min[2 * i], 0);
      const int x1 = max(min(a.rect_max[2 * i], a.grid_x), x0);
      Record::store(a.gauss, i, TileCull::of(a.xy, a.conic, a.opacity, i,
                                             a.inv_cull_alpha),
                    x0, x1, lo, hi);
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < fan; f += kChunk)
    if (diff[f]) atomicAdd(a.row_diff() + f, diff[f]);
  if (last_block(a.tickets() + 0)) scan_rows(a);
}

__global__ void __launch_bounds__(kChunk)
    level0_write(const Args a) {
  extern __shared__ unsigned smem[];  // bits [kWarps][fan], pre [kWarps][fan]
  __shared__ int chunk;
  const int fan = a.grid_y, chunks = (a.n + kChunk - 1) / kChunk;
  unsigned* bits = smem;
  int* pre = reinterpret_cast<int*>(smem + kWarps * fan);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  unsigned* wbits = bits + warp * fan;
  const int* wpre = pre + warp * fan;
  for (;;) {
    if (threadIdx.x == 0) chunk = atomicAdd(a.tickets() + 1, 1u);
    for (int i = threadIdx.x; i < kWarps * fan; i += kChunk) bits[i] = 0;
    __syncthreads();
    const int c = chunk;
    if (c >= chunks) break;  // uniform over the block
    const int pos = c * kChunk + threadIdx.x;
    int g = -1, lo = 0, hi = 0;
    if (pos < a.n) {
      g = static_cast<int>(a.order[pos]);
      const Record r = Record::load(a.gauss, g);
      lo = r.y0();
      hi = r.y1();
    }
    // The warp's bits a row, one ballot each over the rows its items span.
    const int y0 = __reduce_min_sync(kFull, lo < hi ? lo : fan);
    const int y1 = __reduce_max_sync(kFull, lo < hi ? hi : 0);
    for (int y = y0; y < y1; ++y) {
      const unsigned m = __ballot_sync(kFull, lo <= y && y < hi);
      if (lane == 0) wbits[y] = m;
    }
    __syncthreads();
    chunk_offsets(a.status0, c, fan, bits, pre, a.row_base());
    __syncthreads();
    for (int f = lo; f < hi; ++f) {
      const int b = wpre[f];
      if (b >= 0) a.rows[b + __popc(wbits[f] & lt)] = g;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kChunk)
    level1_count(const Args a) {
  __shared__ int hist[kMaxFan];
  __shared__ RowMeta meta;
  __shared__ int incl[kChunk];          // inclusive prefix of the widths
  __shared__ int first_tile[kChunk];
  __shared__ float cull[6][kChunk];     // cx, cy, ca, cb, cc, thresh
  __shared__ unsigned keep[2 * kChunk];  // an item's 64 keep bits
  __shared__ int sums[kWarps];
  PHASE_BEGIN
  const int fan = a.grid_x;
  const int gy = a.grid_y;
  meta.stage(a);
  __syncthreads();
  const int live = meta.word[3 * gy];
  for (int c = blockIdx.x; c < live; c += gridDim.x) {
    const int b = meta.row_of(gy, c);
    const int pos = (c - meta.word[2 * gy + b]) * kChunk + threadIdx.x;
    const bool valid = pos < meta.word[gy + b];
    const int at = meta.word[b] + pos;
    int width = 0;
    if (valid) {
      const Record r = Record::load(a.gauss, __ldcg(a.rows + at));
      width = r.x1() - r.x0();
      first_tile[threadIdx.x] = r.x0();
      cull[0][threadIdx.x] = r.cull.cx;
      cull[1][threadIdx.x] = r.cull.cy;
      cull[2][threadIdx.x] = r.cull.k.ca;
      cull[3][threadIdx.x] = r.cull.k.cb;
      cull[4][threadIdx.x] = r.cull.k.cc;
      cull[5][threadIdx.x] = r.cull.thresh;
    }
    keep[2 * threadIdx.x] = keep[2 * threadIdx.x + 1] = 0;
    for (int f = threadIdx.x; f < fan; f += kChunk) hist[f] = 0;
    int pairs;
    incl[threadIdx.x] = block_exclusive_scan(width, sums, pairs) + width;
    __syncthreads();
    PHASE_MARK(0)
    // The chunk's (item, tile) pairs, evenly over the block: lane l of a
    // warp takes pair base + 32 w + l, so an item's pairs in a warp are
    // consecutive lanes, whose keep bits the segment's first lane ORs in.
    const int lane = threadIdx.x % 32;
    for (int base = 0; base < pairs; base += kChunk) {
      const int q = base + threadIdx.x;
      int item = -1, j = 0;
      bool kept = false;
      if (q < pairs) {
        int lo = 0, hi = kChunk - 1;  // the first item with incl > q
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          if (incl[mid] > q) hi = mid; else lo = mid + 1;
        }
        item = lo;
        j = q - (item ? incl[item - 1] : 0);
        TileCull tc;
        tc.cx = cull[0][item];
        tc.cy = cull[1][item];
        tc.k.ca = cull[2][item];
        tc.k.cb = cull[3][item];
        tc.k.cc = cull[4][item];
        tc.thresh = cull[5][item];
        const int f = first_tile[item] + j;
        kept = tc.keeps(f, b);
        if (kept) atomicAdd(&hist[f], 1);
      }
      const unsigned bits = __ballot_sync(kFull, kept && j < kMaskBits);
      const int before = __shfl_up_sync(kFull, item, 1);
      const bool first = item >= 0 && (lane == 0 || before != item);
      const unsigned firsts = __ballot_sync(kFull, first);
      if (first && j < kMaskBits) {
        const unsigned later = lane == 31 ? 0u : firsts & (~0u << (lane + 1));
        const int end = later ? __ffs(later) - 1 : 32;
        const unsigned seg = (bits >> lane)
            & (end - lane == 32 ? ~0u : (1u << (end - lane)) - 1u);
        const unsigned long long word = static_cast<unsigned long long>(seg)
                                        << j;
        if (word & 0xFFFFFFFFull)
          atomicOr(&keep[2 * item], static_cast<unsigned>(word));
        if (word >> 32)
          atomicOr(&keep[2 * item + 1], static_cast<unsigned>(word >> 32));
      }
    }
    __syncthreads();
    PHASE_MARK(1)
    if (valid) {
      const unsigned long long hi_bits = keep[2 * threadIdx.x + 1];
      a.mask1[at] = keep[2 * threadIdx.x] | hi_bits << 32;
    }
    int* tiles = a.tiles() + b * fan;
    for (int f = threadIdx.x; f < fan; f += kChunk) {
      a.counts1[static_cast<size_t>(c) * fan + f] = hist[f];
      if (hist[f]) atomicAdd(tiles + f, hist[f]);
    }
    __syncthreads();
    PHASE_MARK(2)
    PHASE_COUNT()
  }
  if (last_block(a.tickets() + 2)) scan_tiles(a);
  PHASE_MARK(3)
  PHASE_END(g_cascade_phase)
}

// Level 1's chunk offsets: for each (row, tile), the exclusive scan of
// its counts over the row's chunks, plus the tile's offset (-1 stays -1
// for a disabled tile), in place. kScanLanes threads a (row, tile), each a
// segment of the chunks (its sum, a scan across the lanes, then its
// writes), kBatch chunks' counts read at once.
constexpr int kScanLanes = 8;

__global__ void __launch_bounds__(kChunk) level1_offsets(const Args a) {
  constexpr int kBatch = 8;
  const int fan = a.grid_x;
  const int t = (blockIdx.x * kChunk + threadIdx.x) / kScanLanes;
  const int j = threadIdx.x % kScanLanes;
  int c0 = 0, c1 = 0, base = -1;
  if (t < fan * a.grid_y) {  // the same for a group's lanes
    c0 = __ldcg(a.chunk_first() + t / fan);
    c1 = __ldcg(a.chunk_first() + t / fan + 1);
    base = __ldcg(a.tiles() + t);
  }
  const int per = (c1 - c0 + kScanLanes - 1) / kScanLanes;
  const int s0 = min(c0 + j * per, c1), s1 = min(s0 + per, c1);
  int* col = a.counts1 + t % fan;
  int sum = 0;
  for (int c = s0; c < s1; c += kBatch) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (c + q < s1) sum += __ldcg(col + static_cast<size_t>(c + q) * fan);
  }
  int run = sum;
#pragma unroll
  for (int d = 1; d < kScanLanes; d <<= 1) {
    const int y = __shfl_up_sync(kFull, run, d, kScanLanes);
    if (j >= d) run += y;
  }
  run -= sum;
  for (int c = s0; c < s1; c += kBatch) {
    int k[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      k[q] = c + q < s1 ? __ldcg(col + static_cast<size_t>(c + q) * fan) : 0;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (c + q < s1)
        col[static_cast<size_t>(c + q) * fan] = base < 0 ? -1 : base + run;
      run += k[q];
    }
  }
}

__global__ void __launch_bounds__(kChunk)
    level1_write(const Args a) {
  extern __shared__ unsigned smem[];  // bits [kWarps][fan], pre [kWarps][fan]
  __shared__ RowMeta meta;
  PHASE_BEGIN
  const int fan = a.grid_x;
  unsigned* bits = smem;
  int* pre = reinterpret_cast<int*>(smem + kWarps * fan);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  unsigned* wbits = bits + warp * fan;
  const int* wpre = pre + warp * fan;
  // The output past the kept total is zero.
  for (long long i = static_cast<long long>(__ldcg(a.total))
                     + static_cast<long long>(blockIdx.x) * kChunk
                     + threadIdx.x;
       i < a.budget; i += static_cast<long long>(gridDim.x) * kChunk)
    a.out[i] = 0;
  const int gy = a.grid_y;
  meta.stage(a);
  __syncthreads();
  for (int c = blockIdx.x; c < meta.word[3 * gy]; c += gridDim.x) {
    for (int i = threadIdx.x; i < kWarps * fan; i += kChunk) bits[i] = 0;
    __syncthreads();
    const int b = meta.row_of(gy, c);
    const int pos = (c - meta.word[2 * gy + b]) * kChunk + threadIdx.x;
    int g = -1, lo = 0, hi = 0;
    unsigned long long m = 0;
    Record r{};
    if (pos < meta.word[gy + b]) {
      const int at = meta.word[b] + pos;
      g = __ldcg(a.rows + at);
      m = __ldcg(a.mask1 + at);
      r = Record::load(a.gauss, g);
      lo = r.x0();
      hi = r.x1();
    }
    for (unsigned long long k = m; k; k &= k - 1)
      atomicOr(wbits + lo + __ffsll(static_cast<long long>(k)) - 1,
               1u << lane);
    for (int f = lo + kMaskBits; f < hi; ++f)  // rects past the keep bits
      if (r.cull.keeps(f, b)) atomicOr(wbits + f, 1u << lane);
    __syncthreads();
    PHASE_MARK(4)
    for (int f = threadIdx.x; f < fan; f += kChunk) {
      const int off = __ldcg(a.counts1 + static_cast<size_t>(c) * fan + f);
      int run = off;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int k = __popc(bits[w * fan + f]);
        pre[w * fan + f] = off < 0 ? -1 : run;
        run += k;
      }
    }
    __syncthreads();
    PHASE_MARK(5)
    for (unsigned long long k = m; k; k &= k - 1) {
      const int f = lo + __ffsll(static_cast<long long>(k)) - 1;
      const int base = wpre[f];
      if (base >= 0) a.out[base + __popc(wbits[f] & lt)] = g;
    }
    for (int f = lo + kMaskBits; f < hi; ++f) {
      const int base = wpre[f];
      if (base >= 0 && (wbits[f] >> lane) & 1u)
        a.out[base + __popc(wbits[f] & lt)] = g;
    }
    __syncthreads();
    PHASE_MARK(6)
    PHASE_COUNT()
  }
  PHASE_END(g_cascade_phase)
}

size_t write_smem(int fan) {
  return 2 * static_cast<size_t>(kWarps) * fan * sizeof(unsigned);
}

// Blocks of `kernel` the card holds at once, at most `most`, at least 1.
template <typename Kernel>
unsigned resident(Kernel kernel, size_t smem, long long most) {
  int device = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kChunk,
                                                smem);
  return static_cast<unsigned>(
      max(min(static_cast<long long>(max(per_sm, 1)) * sms, most), 1LL));
}

}  // namespace

// One launch of the cascade. stage 0: level0_count, 1: level0_write,
// 2: level1_count, 3: level1_offsets, 4: level1_write (chunks1: at least
// level 1's live chunks; the passes run at most that many blocks).
// zbuf must be zero before stage 0; `order` is read by stage 1 only;
// `gauss` ([n] 32-byte records, 16-byte aligned) is written by stage 0.
extern "C" int lsv2_cascade(
    int stage, int n, int grid_x, int grid_y, int budget, int chunks1,
    const float* depth, const int* rect_min, const int* rect_max,
    const int* tiles_touched, const float* xy, const float* conic,
    const float* opacity, float inv_cull_alpha, const long long* order,
    float4* gauss, int* zbuf, int* meta, int* keys, unsigned* status0,
    int* counts1, int* rows, unsigned long long* mask1, int* out,
    int* start, int* count, int* total, bool* overflow, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (grid_x < 1 || grid_x > kMaxFan || grid_y < 1 || grid_y > kMaxFan ||
      n < 0 || budget < 0 || budget > static_cast<int>(kValue) ||
      chunks1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{n, grid_x, grid_y, budget, depth, rect_min, rect_max,
               tiles_touched, xy, conic, opacity, inv_cull_alpha, order,
               gauss, zbuf, meta, keys, status0, counts1, rows, mask1, out,
               start, count, total, overflow};
  const auto s = static_cast<cudaStream_t>(stream);
  const long long chunks0 = (n + kChunk - 1) / kChunk;
  static bool attributes_set = false;
  if (!attributes_set) {  // the write passes' bits at 1,024 children: 64 KB
    const int most = static_cast<int>(write_smem(kMaxFan));
    cudaFuncSetAttribute(level0_write,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(level1_write,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    attributes_set = true;
  }
  switch (stage) {
    case 0:
      level0_count<<<resident(level0_count, 0, chunks0), kChunk, 0, s>>>(a);
      break;
    case 1:
      level0_write<<<resident(level0_write, write_smem(grid_y), chunks0),
                     kChunk, write_smem(grid_y), s>>>(a);
      break;
    case 2:
      level1_count<<<resident(level1_count, 0, chunks1), kChunk, 0, s>>>(a);
      break;
    case 3:
      level1_offsets<<<static_cast<unsigned>(
                           (grid_x * grid_y * kScanLanes + kChunk - 1) /
                           kChunk),
                       kChunk, 0, s>>>(a);
      break;
    case 4:
      level1_write<<<resident(level1_write, write_smem(grid_x), chunks1),
                     kChunk, write_smem(grid_x), s>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
