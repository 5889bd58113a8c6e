// The preprocess: cull, EWA projection, conic, radius, opacity-aware
// extents, tile rect and SH colour of every Gaussian, in one launch.
//
// Replaces no Pallas kernel: the JAX package's preprocess
// (langsplatv2_tpu/ops/projection.py::preprocess) is XLA code, which XLA
// fuses on the TPU. The port ran it as ~350 plain-torch launches a frame
// (ops/projection.py::preprocess_plain), whose host time kept the card
// waiting; this kernel is the forward of every route that differentiates
// no geometry (ops/projection.py::preprocess's rule).
//
// Bound on this card: bytes. Each Gaussian reads its mean (12 B), scales
// and rotation (28 B) or covariance (24 B), opacity (4 B) and (deg + 1)^2
// SH rows of 12 B (192 B at degree 3), and writes 60 B (xy, depth, conic,
// radius, rgb, rect, tiles): ~300 B against ~470 f32 operations at SH 3.
//
// Design: one thread a Gaussian, 128 threads a block. The SH rows, the
// largest input, are read where they lie (features_dc [N, 1, 3] and
// features_rest [N, K - 1, 3], two pointers with row strides, so no
// concatenation runs first): each warp stages its 32 Gaussians' rows in
// shared memory with lane-consecutive loads (32 consecutive floats an
// instruction), then each lane reads its own row there (an odd row pitch,
// so no bank conflicts). The camera enters the launch by value (`Params`,
// from the host arrays with no device copy) or, for a caller that holds it
// on the card, through device pointers the block reads once. Outputs are
// the structure-of-arrays tensors K1 and blend.pack_gaussian_state read.
//
// Numerics: compiled with -fmad=false, so every f32 op rounds on its own,
// in the order of the plain PyTorch version on the card: a Python scalar
// enters as an f32 constant, `s / t` as reciprocal(t) * s, a division by
// a Python scalar b as the product with f32(1 / b), the reciprocal taken
// in double (torch's CUDA division by a CPU scalar), clamp / minimum
// propagate NaN as torch's do.
// The outputs are the plain version's bit for bit. Two sums are torch
// reductions whose order is replicated from ATen's CUDA reduce for a
// row of 3 or 4 (Reduce.cuh: lanes of one row split the row, the partial
// sums fold by a shuffle with falling offsets): |dir| =
// sqrt((x^2 + z^2) + y^2) and |q| = sqrt((r^2 + y^2) + (x^2 + z^2)).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kBlock = 16.0f;      // tile side in pixels
constexpr int kCamFloats = 35;       // view [16], proj [16], campos [3]
constexpr int kHostFloats = kCamFloats + 10;

// The camera and the scalars of one call, by value. Each scalar is the f32
// the plain version's Python float becomes.
struct Params {
  float cam[kCamFloats];
  float focal_x, focal_y;   // W / (2 tanfovx), H / (2 tanfovy)
  float lim_x, lim_y;       // 1.3 tanfovx, 1.3 tanfovy
  float width, height;      // ndc_to_pixel's sizes
  float grid_x, grid_y;     // tile_rect's clamp bounds
  float scale_modifier;
  float inv_cull_alpha;     // f32(1 / cull_alpha), the quotient in double
};
static_assert(sizeof(Params) == kHostFloats * sizeof(float), "layout");

// torch's CUDA clamp and minimum: a NaN operand is the result.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float minimum_t(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// A Python float constant as torch casts it: double, then f32.
#define F32(x) static_cast<float>(x)

// SH constants (utils/sh.py), as Python doubles.
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792;
constexpr double kC2_1 = -1.0925484305920792;
constexpr double kC2_2 = 0.31539156525252005;
constexpr double kC2_3 = -1.0925484305920792;
constexpr double kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435;
constexpr double kC3_1 = 2.890611442640554;
constexpr double kC3_2 = -0.4570457994644658;
constexpr double kC3_3 = 0.3731763325901154;
constexpr double kC3_4 = -0.4570457994644658;
constexpr double kC3_5 = 1.445305721320277;
constexpr double kC3_6 = -0.5900435899266435;
constexpr double kC4_0 = 2.5033429417967046;
constexpr double kC4_1 = -1.7701307697799304;
constexpr double kC4_2 = 0.9461746957575601;
constexpr double kC4_3 = -0.6690465435572892;
constexpr double kC4_4 = 0.10578554691520431;
constexpr double kC4_5 = -0.6690465435572892;
constexpr double kC4_6 = 0.47308734787878004;
constexpr double kC4_7 = -1.7701307697799304;
constexpr double kC4_8 = 0.6258357354491761;

// utils/sh.py::eval_sh for one channel; sh(k) is coefficient k.
template <int DEG, typename Coef>
__device__ __forceinline__ float eval_sh(float x, float y, float z,
                                         Coef sh) {
  float res = F32(kC0) * sh(0);
  if (DEG > 0) {
    res = res - (F32(kC1) * y) * sh(1);
    res = res + (F32(kC1) * z) * sh(2);
    res = res - (F32(kC1) * x) * sh(3);
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    res = res + (F32(kC2_0) * xy) * sh(4);
    res = res + (F32(kC2_1) * yz) * sh(5);
    res = res + (F32(kC2_2) * ((2.0f * zz - xx) - yy)) * sh(6);
    res = res + (F32(kC2_3) * xz) * sh(7);
    res = res + (F32(kC2_4) * (xx - yy)) * sh(8);
    if (DEG > 2) {
      res = res + ((F32(kC3_0) * y) * (3.0f * xx - yy)) * sh(9);
      res = res + ((F32(kC3_1) * xy) * z) * sh(10);
      res = res + ((F32(kC3_2) * y) * ((4.0f * zz - xx) - yy)) * sh(11);
      res = res + ((F32(kC3_3) * z) * ((2.0f * zz - 3.0f * xx)
                                         - 3.0f * yy)) * sh(12);
      res = res + ((F32(kC3_4) * x) * ((4.0f * zz - xx) - yy)) * sh(13);
      res = res + ((F32(kC3_5) * z) * (xx - yy)) * sh(14);
      res = res + ((F32(kC3_6) * x) * (xx - 3.0f * yy)) * sh(15);
    }
    if (DEG > 3) {
      res = res + ((F32(kC4_0) * xy) * (xx - yy)) * sh(16);
      res = res + ((F32(kC4_1) * yz) * (3.0f * xx - yy)) * sh(17);
      res = res + ((F32(kC4_2) * xy) * (7.0f * zz - 1.0f)) * sh(18);
      res = res + ((F32(kC4_3) * yz) * (7.0f * zz - 3.0f)) * sh(19);
      res = res + (F32(kC4_4) * (zz * (35.0f * zz - 30.0f) + 3.0f))
                      * sh(20);
      res = res + ((F32(kC4_5) * xz) * (7.0f * zz - 3.0f)) * sh(21);
      res = res + ((F32(kC4_6) * (xx - yy)) * (7.0f * zz - 1.0f))
                      * sh(22);
      res = res + ((F32(kC4_7) * xz) * (xx - 3.0f * yy)) * sh(23);
      res = res + (F32(kC4_8) * (xx * (xx - 3.0f * yy)
                                  - yy * (3.0f * xx - yy))) * sh(24);
    }
  }
  return clamp_min_t(res + 0.5f, 0.0f);
}

__host__ __device__ constexpr int sh_rest_floats(int deg) {
  return deg <= 0 ? 0 : 3 * ((deg + 1) * (deg + 1) - 1);
}

// DEG: the SH degree of the colour, -1 for none (colours_precomp or no
// colour: the wrapper hands those back itself). COV: the covariance comes
// from cov3d [N, 6] instead of scales and rotations.
template <int DEG, bool COV>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(
    Params p, const float* __restrict__ view_dev,
    const float* __restrict__ proj_dev,
    const float* __restrict__ campos_dev, const float* __restrict__ means,
    const float* __restrict__ scales, const float* __restrict__ rotations,
    const float* __restrict__ cov3d, const float* __restrict__ opacity,
    const float* __restrict__ sh_dc, const float* __restrict__ sh_rest,
    long long dc_stride, long long rest_stride, int n,
    float* __restrict__ xy_out, float* __restrict__ depth_out,
    float* __restrict__ conic_out, int* __restrict__ radius_out,
    float* __restrict__ rgb_out, int* __restrict__ rect_min_out,
    int* __restrict__ rect_max_out, int* __restrict__ tiles_out) {
  constexpr int kRest = sh_rest_floats(DEG);
  constexpr int kRestPitch = kRest | 1;          // odd: no bank conflicts
  __shared__ float s_cam[kCamFloats];
  __shared__ float s_dc[kWarps][DEG >= 0 ? 32 * 3 : 1];
  __shared__ float s_rest[kWarps][kRest > 0 ? 32 * kRestPitch : 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kCamFloats) {
    const int i = threadIdx.x;
    const float* dev = i < 16 ? view_dev : i < 32 ? proj_dev : campos_dev;
    const int j = i < 16 ? i : i < 32 ? i - 16 : i - 32;
    s_cam[i] = dev != nullptr ? dev[j] : p.cam[i];
  }
  const int g0 = blockIdx.x * kThreads + warp * 32;
  const int rows = min(32, n - g0);
  if constexpr (DEG >= 0) {
    // The warp's SH rows, lane-consecutive: element i of the warp's rows
    // is row i / width, column i % width (none when rows <= 0).
    const float* dc = sh_dc + (long long)g0 * dc_stride;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = lane + 32 * k;
      if (i < rows * 3) {
        const int r = i / 3, c = i - 3 * r;
        s_dc[warp][i] = dc[r * dc_stride + c];
      }
    }
    if constexpr (kRest > 0) {
      const float* rest = sh_rest + (long long)g0 * rest_stride;
#pragma unroll
      for (int k = 0; k < kRest; ++k) {
        const int i = lane + 32 * k;
        if (i < rows * kRest) {
          const int r = i / kRest, c = i - kRest * r;
          s_rest[warp][r * kRestPitch + c] = rest[r * rest_stride + c];
        }
      }
    }
  }
  __syncthreads();
  const int g = g0 + lane;
  if (g >= n) return;
  const float* view = s_cam;
  const float* proj = s_cam + 16;
  const float* campos = s_cam + 32;

  const float mx = means[3 * g], my = means[3 * g + 1],
              mz = means[3 * g + 2];
  // project_gaussians' hrow(m, j): column j of a transposed 4x4.
  auto hrow = [&](const float* m, int j) {
    return ((mx * m[j] + my * m[4 + j]) + mz * m[8 + j]) + m[12 + j];
  };
  const float pv_x = hrow(view, 0), pv_y = hrow(view, 1);
  const float depth = hrow(view, 2);
  const bool in_front = depth > F32(0.2);
  const float p_w = 1.0f / (hrow(proj, 3) + F32(1e-7));
  const float p_proj_x = hrow(proj, 0) * p_w;
  const float p_proj_y = hrow(proj, 1) * p_w;

  const float tz = depth;
  const float tx = clamp_t(pv_x / tz, -p.lim_x, p.lim_x) * tz;
  const float ty = clamp_t(pv_y / tz, -p.lim_y, p.lim_y) * tz;
  const float rz = 1.0f / tz;
  const float j0 = rz * p.focal_x;
  const float j2 = (tx * -p.focal_x) / (tz * tz);
  const float k1 = rz * p.focal_y;
  const float k2 = (ty * -p.focal_y) / (tz * tz);
  // m0 = j0 W[0] + j2 W[2], m1 = k1 W[1] + k2 W[2], W = view[:3, :3]^T.
  float m0[3], m1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m0[k] = j0 * view[4 * k] + j2 * view[4 * k + 2];
    m1[k] = k1 * view[4 * k + 1] + k2 * view[4 * k + 2];
  }
  float a, b, c;
  if constexpr (COV) {
    const float* s = cov3d + 6 * g;
    const float xx = s[0], xy = s[1], xz = s[2], yy = s[3], yz = s[4],
                zz = s[5];
    auto quad = [&](const float* u, const float* v) {
      return (((((u[0] * v[0]) * xx + (u[1] * v[1]) * yy)
                + (u[2] * v[2]) * zz)
               + (u[0] * v[1] + u[1] * v[0]) * xy)
              + (u[0] * v[2] + u[2] * v[0]) * xz)
             + (u[1] * v[2] + u[2] * v[1]) * yz;
    };
    a = quad(m0, m0) + F32(0.3);
    b = quad(m0, m1);
    c = quad(m1, m1) + F32(0.3);
  } else {
    const float q0 = rotations[4 * g], q1 = rotations[4 * g + 1],
                q2 = rotations[4 * g + 2], q3 = rotations[4 * g + 3];
    const float qn = sqrtf((q0 * q0 + q2 * q2) + (q1 * q1 + q3 * q3));
    const float r = q0 / qn, x = q1 / qn, y = q2 / qn, z = q3 / qn;
    const float R00 = 1.0f - 2.0f * (y * y + z * z);
    const float R01 = 2.0f * (x * y - r * z);
    const float R02 = 2.0f * (x * z + r * y);
    const float R10 = 2.0f * (x * y + r * z);
    const float R11 = 1.0f - 2.0f * (x * x + z * z);
    const float R12 = 2.0f * (y * z - r * x);
    const float R20 = 2.0f * (x * z - r * y);
    const float R21 = 2.0f * (y * z + r * x);
    const float R22 = 1.0f - 2.0f * (x * x + y * y);
    float s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = scales[3 * g + k] * p.scale_modifier;
      s2[k] = s * s;
    }
    const float u0 = (m0[0] * R00 + m0[1] * R10) + m0[2] * R20;
    const float u1 = (m0[0] * R01 + m0[1] * R11) + m0[2] * R21;
    const float u2 = (m0[0] * R02 + m0[1] * R12) + m0[2] * R22;
    const float v0 = (m1[0] * R00 + m1[1] * R10) + m1[2] * R20;
    const float v1 = (m1[0] * R01 + m1[1] * R11) + m1[2] * R21;
    const float v2 = (m1[0] * R02 + m1[1] * R12) + m1[2] * R22;
    a = (((s2[0] * u0) * u0 + (s2[1] * u1) * u1) + (s2[2] * u2) * u2)
        + F32(0.3);
    b = ((s2[0] * u0) * v0 + (s2[1] * u1) * v1) + (s2[2] * u2) * v2;
    c = (((s2[0] * v0) * v0 + (s2[1] * v1) * v1) + (s2[2] * v2) * v2)
        + F32(0.3);
  }

  const float det = a * c - b * b;
  const bool det_ok = det != 0.0f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  conic_out[3 * g] = c * inv_det;
  conic_out[3 * g + 1] = -b * inv_det;
  conic_out[3 * g + 2] = a * inv_det;

  const float mid = 0.5f * (a + c);
  const float lam = mid + sqrtf(clamp_min_t(mid * mid - det, F32(0.1)));
  const float radius_f = ceilf(3.0f * sqrtf(lam));
  const float px = (((p_proj_x + 1.0f) * p.width) - 1.0f) * 0.5f;
  const float py = (((p_proj_y + 1.0f) * p.height) - 1.0f) * 0.5f;
  const bool visible = in_front && det_ok;
  int radius = __float2int_rz(visible ? radius_f : 0.0f);
  float rx, ry;
  if (opacity != nullptr) {
    // The opacity-aware extents, intersected with the 3-sigma square.
    const float two_l =
        2.0f * logf(clamp_min_t(opacity[g], F32(1e-12)) * p.inv_cull_alpha);
    const bool dead = two_l <= 0.0f;
    float ext_x = ceilf(sqrtf(clamp_min_t(two_l * a, 0.0f))) + 1.0f;
    float ext_y = ceilf(sqrtf(clamp_min_t(two_l * c, 0.0f))) + 1.0f;
    ext_x = dead ? 0.0f : minimum_t(radius_f, ext_x);
    ext_y = dead ? 0.0f : minimum_t(radius_f, ext_y);
    const bool keep = visible && !dead;
    rx = keep ? ext_x : 0.0f;
    ry = keep ? ext_y : 0.0f;
    if (dead) radius = 0;
  } else {
    rx = ry = (float)radius;
  }

  // tile_rect: v / 16 as v * (1 / 16), then floor, clamp, truncate.
  auto cell = [](float v, float hi) {
    return __float2int_rz(clamp_t(floorf(v * (1.0f / kBlock)), 0.0f, hi));
  };
  const int x0 = cell(px - rx, p.grid_x), y0 = cell(py - ry, p.grid_y);
  const int x1 = cell(((px + rx) + kBlock) - 1.0f, p.grid_x);
  const int y1 = cell(((py + ry) + kBlock) - 1.0f, p.grid_y);
  int tiles = (x1 - x0) * (y1 - y0);
  if (rx <= 0.0f || ry <= 0.0f) tiles = 0;
  if (tiles <= 0) radius = 0;
  if (radius <= 0) tiles = 0;

  xy_out[2 * g] = px;
  xy_out[2 * g + 1] = py;
  depth_out[g] = depth;
  radius_out[g] = radius;
  rect_min_out[2 * g] = x0;
  rect_min_out[2 * g + 1] = y0;
  rect_max_out[2 * g] = x1;
  rect_max_out[2 * g + 1] = y1;
  tiles_out[g] = tiles;

  if constexpr (DEG >= 0) {
    // sh_to_color: the unit direction from the camera centre.
    const float dx = mx - campos[0], dy = my - campos[1], dz = mz - campos[2];
    const float dn = sqrtf((dx * dx + dz * dz) + dy * dy);
    const float x = dx / dn, y = dy / dn, z = dz / dn;
    const float* dc = s_dc[warp] + 3 * lane;
    const float* rest = s_rest[warp] + kRestPitch * lane;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      rgb_out[3 * g + ch] = eval_sh<DEG>(x, y, z, [&](int k) {
        return k == 0 ? dc[ch] : rest[3 * (k - 1) + ch];
      });
    }
  }
}

template <int DEG, bool COV>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&preprocess_kernel<DEG, COV>);
}

const void* kernel_for(int deg, bool cov) {
  switch (deg) {
    case -1: return cov ? kernel_of<-1, true>() : kernel_of<-1, false>();
    case 0: return cov ? kernel_of<0, true>() : kernel_of<0, false>();
    case 1: return cov ? kernel_of<1, true>() : kernel_of<1, false>();
    case 2: return cov ? kernel_of<2, true>() : kernel_of<2, false>();
    case 3: return cov ? kernel_of<3, true>() : kernel_of<3, false>();
    case 4: return cov ? kernel_of<4, true>() : kernel_of<4, false>();
    default: return nullptr;
  }
}

}  // namespace

// host_params: kHostFloats floats in host memory (`Params`' layout): the
// camera (view, proj, campos; a slot whose device pointer is given is not
// read) and the scalars. sh_degree -1: no SH colour. cov3d null: scales
// and rotations. opacity null: the 3-sigma extents. SH strides in floats.
extern "C" int lsv2_preprocess(
    const float* host_params, const float* view_dev, const float* proj_dev,
    const float* campos_dev, const float* means, const float* scales,
    const float* rotations, const float* cov3d, const float* opacity,
    const float* sh_dc, const float* sh_rest, long long dc_stride,
    long long rest_stride, int sh_degree, int n, float* xy, float* depth,
    float* conic, int* radius, float* rgb, int* rect_min, int* rect_max,
    int* tiles, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  const bool cov = cov3d != nullptr;
  if (kernel_for(sh_degree, cov) == nullptr || n < 0 ||
      host_params == nullptr || (!cov && (scales == nullptr ||
                                          rotations == nullptr)) ||
      (sh_degree >= 0 && (sh_dc == nullptr || rgb == nullptr ||
                          (sh_degree > 0 && sh_rest == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Params p;
  const float* src = host_params;
  float* dst = reinterpret_cast<float*>(&p);
  for (int i = 0; i < kHostFloats; ++i) dst[i] = src[i];
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LSV2_PRE(D, C)                                                       \
  preprocess_kernel<D, C><<<blocks, kThreads, 0, st>>>(                     \
      p, view_dev, proj_dev, campos_dev, means, scales, rotations, cov3d,   \
      opacity, sh_dc, sh_rest, dc_stride, rest_stride, n, xy, depth, conic, \
      radius, rgb, rect_min, rect_max, tiles)
#define LSV2_PRE_DEG(D) \
  if (cov) LSV2_PRE(D, true); else LSV2_PRE(D, false);
  switch (sh_degree) {
    case -1: LSV2_PRE_DEG(-1) break;
    case 0: LSV2_PRE_DEG(0) break;
    case 1: LSV2_PRE_DEG(1) break;
    case 2: LSV2_PRE_DEG(2) break;
    case 3: LSV2_PRE_DEG(3) break;
    default: LSV2_PRE_DEG(4) break;
  }
#undef LSV2_PRE_DEG
#undef LSV2_PRE
  return static_cast<int>(cudaGetLastError());
}

// The kernel's occupancy at one SH degree (scales / rotations): blocks an
// SM, static shared bytes, registers a thread, local bytes a thread,
// threads a block.
extern "C" int lsv2_preprocess_occupancy(int sh_degree, int* out) {
  cudaGetLastError();
  const void* fn = kernel_for(sh_degree, false);
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
