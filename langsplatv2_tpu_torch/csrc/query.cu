// K3: Gram relevancy query over weight-map tiles.
//
// Replaces the TPU kernel langsplatv2_tpu/ops/pallas_query.py::_query_kernel
// (pallas_call at :92, wrapper query_map_tiles). Per tile of the [T, 256, L*K]
// f32 weight map and per level l:
//   raw[t, p, l*PQ + q] = sum_k w[k] phi[l, k, q]
//   nrm2[t, p, l]       = sum_m w[m] (sum_k w[k] gram[l, k, m])
// without writing w @ gram anywhere. The Pallas kernel lifts phi and gram to
// block-diagonal [L*K, .] matrices so that each contraction is one MXU matmul;
// here each level is computed on its own, which is the same function without
// the zero blocks.
//
// Design: one block of 256 threads (one per pixel) walks tiles with a grid
// stride, so that gram [L, K, K] (transposed, rows contiguous) and phi
// [L, K, PQ] are loaded into shared memory once per block. For each tile and
// level, the [256, K] slice of the map is staged through shared memory with
// coalesced float4 loads, then each thread keeps its pixel's K weights in
// registers and does the K*K + K*PQ multiply-adds in f32 on CUDA cores (no
// tensor cores in this version).
//
// Bound on this card: bytes, the read of the f32 map (1.6 GB at 1080p:
// ~0.48 ms at 3.35 TB/s). The f32 products (2*L*K*(K + PQ + 1) flops a pixel)
// take ~0.34 ms at 1080p on tensor cores with f32-accurate 3xTF32 splitting (a
// third of the 495 TFLOP/s TF32 rate), so they need not limit it. This
// version does them on CUDA cores, where they take ~0.84 ms at 67 TFLOP/s:
// as written it is limited by operations, above its bound. The design reads
// the map once, keeps w @ gram in registers and the constants in shared
// memory. 3xTF32 tensor-core products and overlapping the staging with
// compute are later work.
//
// bf16 map (the fast16 serving tiles, feat_bf16): the kernel reads the map as
// bf16, 8 values a 16-byte load, and widens them in shared memory; the
// wrapper hands it phi and gram rounded to bf16 and widened, as the Pallas
// kernel casts them to the map's type (mm_dt). Each product of two bf16
// values is exact in f32, so the f32 sums are the bf16 matmul with f32
// accumulation of the Pallas kernel, in another order. The map read halves
// (0.8 GB at 1080p); the CUDA-core operations do not, so as written this
// mode is further above its bound than the f32 one. bf16 mma products are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 256;
constexpr int kK = 64;        // codebook rows per level
constexpr int kPad = kPix + 1;
constexpr int kMaxPQ = 16;

// Widen 4 (f32 map) or 8 (bf16 map) consecutive map values, one 16-byte load.
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <typename MapT>
__global__ void __launch_bounds__(kPix)
    query_kernel(const MapT* __restrict__ wm, const float* __restrict__ phi,
                 const float* __restrict__ gram, int n_tiles, int levels,
                 int pq, float* __restrict__ raw, float* __restrict__ nrm2) {
  extern __shared__ float smem[];
  float* s_gram_t = smem;                      // [L][m][k] = gram[l][k][m]
  float* s_phi = s_gram_t + levels * kK * kK;  // [L][k][q]
  float* s_w = s_phi + levels * kK * pq;       // [k][kPad]
  const int tid = threadIdx.x;
  const int C = levels * kK;

  for (int i = tid; i < levels * kK * kK; i += kPix) {
    const int l = i / (kK * kK);
    const int rem = i - l * kK * kK;
    const int k = rem / kK, m = rem - k * kK;
    s_gram_t[(l * kK + m) * kK + k] = gram[i];
  }
  for (int i = tid; i < levels * kK * pq; i += kPix) s_phi[i] = phi[i];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    constexpr int kVec = 16 / sizeof(MapT);   // map values a 16-byte load
    const MapT* src = wm + (size_t)tile * kPix * C;
    const size_t p = (size_t)tile * kPix + tid;
    for (int l = 0; l < levels; ++l) {
      __syncthreads();  // s_w is free (and the constants are loaded)
      // [256 px][kK] slice at column l*kK, kK / kVec loads a pixel row.
      for (int i = tid; i < kPix * (kK / kVec); i += kPix) {
        const int q = i / (kK / kVec), kv = i - q * (kK / kVec);
        float v[kVec];
        load_vec(src + (size_t)q * C + l * kK + kVec * kv, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) s_w[(kVec * kv + e) * kPad + q] = v[e];
      }
      __syncthreads();
      float w[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) w[k] = s_w[k * kPad + tid];

      const float* ph = s_phi + l * kK * pq;
      for (int q = 0; q < pq; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < kK; ++k) s += w[k] * ph[k * pq + q];
        raw[p * levels * pq + l * pq + q] = s;
      }
      const float* gt = s_gram_t + l * kK * kK;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < kK; ++m) {
        const float4* row = reinterpret_cast<const float4*>(gt + m * kK);
        float s = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < kK / 4; ++k4) {
          const float4 gv = row[k4];
          s += w[4 * k4] * gv.x;
          s += w[4 * k4 + 1] * gv.y;
          s += w[4 * k4 + 2] * gv.z;
          s += w[4 * k4 + 3] * gv.w;
        }
        acc += s * w[m];
      }
      nrm2[p * levels + l] = acc;
    }
  }
}

template <typename MapT>
int launch_query(const MapT* wm, const float* phi, const float* gram,
                 int n_tiles, int levels, int pq, float* raw, float* nrm2,
                 void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  if (pq < 1 || pq > kMaxPQ || levels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)levels * kK * kK +
                                       (size_t)levels * kK * pq +
                                       (size_t)kK * kPad);
  cudaError_t err = cudaFuncSetAttribute(
      query_kernel<MapT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, query_kernel<MapT>, kPix, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  if (grid > 0) {
    query_kernel<MapT>
        <<<grid, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
            wm, phi, gram, n_tiles, levels, pq, raw, nrm2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsv2_query_map_tiles(const float* wm, const float* phi,
                                    const float* gram, int n_tiles,
                                    int levels, int pq, float* raw,
                                    float* nrm2, void* stream) {
  return launch_query(wm, phi, gram, n_tiles, levels, pq, raw, nrm2, stream);
}

// wm: bf16 [T, 256, L*64]; phi and gram: f32 holding bf16-rounded values.
extern "C" int lsv2_query_map_tiles_bf16(const void* wm, const float* phi,
                                         const float* gram, int n_tiles,
                                         int levels, int pq, float* raw,
                                         float* nrm2, void* stream) {
  return launch_query(static_cast<const __nv_bfloat16*>(wm), phi, gram,
                      n_tiles, levels, pq, raw, nrm2, stream);
}
