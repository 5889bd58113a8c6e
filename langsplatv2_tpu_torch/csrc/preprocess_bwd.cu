// The adjoint of the preprocess: the gradients of every Gaussian's mean,
// scales, rotation and SH rows from the cotangents of its screen state
// (xy, conic, rgb), in one launch.
//
// Replaces no Pallas kernel: the JAX package differentiates its XLA
// preprocess (langsplatv2_tpu/ops/projection.py) with jax.vjp. The port
// ran autograd through ops/projection.py::preprocess_plain, ~650 plain-
// torch launches a geometry step after the ~330 of the forward; this
// kernel is the backward of `PreprocessGrad` (ops/projection.py), whose
// forward is csrc/preprocess.cu. Its plain twin is
// `projection.preprocess_grads_plain`, op for op.
//
// Bound on this card: bytes. Each Gaussian reads its cotangents (8 floats),
// mean, scales and rotation (40 B) and (deg + 1)^2 SH rows of 12 B (192 B
// at degree 3), and writes the same widths of gradients: ~470 B against
// ~900 f32 operations at SH 3 (portbench/roofline_geometry.py's
// preprocess_bwd counts the same bytes and twice the forward's operations).
//
// Design: one thread a Gaussian, 128 threads a block, recomputing the
// forward from the inputs (nothing is saved between the two launches but
// the inputs themselves). A lane first reads its 8 cotangents (rows of
// any stride: the geometry step hands slices of K7's [N, 9] sums); a
// Gaussian whose cotangents are all 0 (culled, dead, or with no entry)
// writes zero gradients and skips the rest, its SH rows unread. The SH
// rows are staged a warp at a time in shared memory with lane-consecutive
// loads (only the rows of lanes with work), each lane turns its own row
// into its gradient there, and the warp writes the gradients out lane-
// consecutively, so the largest input and output move in whole sectors.
// The camera enters by value (`Params`, csrc/preprocess.cu's layout) or
// through device pointers.
//
// Numerics: compiled with -fmad=false. The masks of the plain path's
// autograd are reproduced from values recomputed exactly as
// csrc/preprocess.cu computes them (bit for bit the plain path's on the
// card): the tx / ty clamp at 1.3 tanfov (torch.clamp's gradient passes
// where lo <= v <= hi), det != 0 in inv_det, the SH colour's clamp at 0
// (passes where v >= 0). The gradients themselves agree with autograd's to
// summation order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCamFloats = 35;       // view [16], proj [16], campos [3]
constexpr int kHostFloats = kCamFloats + 10;

// csrc/preprocess.cu's `Params`, field for field: both launches of a call
// take the same host array.
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

// torch's CUDA clamp: a NaN operand is the result.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
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

// A lane's SH row in shared memory: coefficient k's 3 channels.
struct ShRow {
  float* dc;
  float* rest;
  __device__ __forceinline__ float* operator()(int k) const {
    return k == 0 ? dc : rest + 3 * (k - 1);
  }
};

// csrc/preprocess.cu's eval_sh of channel ch before its clamp: the value v
// whose clamp(v, min=0) is the colour, in the same op order (the mask
// v >= 0 must be the plain path's).
template <int DEG>
__device__ __forceinline__ float eval_sh_raw(float x, float y, float z,
                                             const ShRow& row, int ch) {
  float res = F32(kC0) * row(0)[ch];
  if (DEG > 0) {
    res = res - (F32(kC1) * y) * row(1)[ch];
    res = res + (F32(kC1) * z) * row(2)[ch];
    res = res - (F32(kC1) * x) * row(3)[ch];
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    res = res + (F32(kC2_0) * xy) * row(4)[ch];
    res = res + (F32(kC2_1) * yz) * row(5)[ch];
    res = res + (F32(kC2_2) * ((2.0f * zz - xx) - yy)) * row(6)[ch];
    res = res + (F32(kC2_3) * xz) * row(7)[ch];
    res = res + (F32(kC2_4) * (xx - yy)) * row(8)[ch];
    if (DEG > 2) {
      res = res + ((F32(kC3_0) * y) * (3.0f * xx - yy)) * row(9)[ch];
      res = res + ((F32(kC3_1) * xy) * z) * row(10)[ch];
      res = res + ((F32(kC3_2) * y) * ((4.0f * zz - xx) - yy)) * row(11)[ch];
      res = res + ((F32(kC3_3) * z) * ((2.0f * zz - 3.0f * xx)
                                         - 3.0f * yy)) * row(12)[ch];
      res = res + ((F32(kC3_4) * x) * ((4.0f * zz - xx) - yy)) * row(13)[ch];
      res = res + ((F32(kC3_5) * z) * (xx - yy)) * row(14)[ch];
      res = res + ((F32(kC3_6) * x) * (xx - 3.0f * yy)) * row(15)[ch];
    }
    if (DEG > 3) {
      res = res + ((F32(kC4_0) * xy) * (xx - yy)) * row(16)[ch];
      res = res + ((F32(kC4_1) * yz) * (3.0f * xx - yy)) * row(17)[ch];
      res = res + ((F32(kC4_2) * xy) * (7.0f * zz - 1.0f)) * row(18)[ch];
      res = res + ((F32(kC4_3) * yz) * (7.0f * zz - 3.0f)) * row(19)[ch];
      res = res + (F32(kC4_4) * (zz * (35.0f * zz - 30.0f) + 3.0f))
                      * row(20)[ch];
      res = res + ((F32(kC4_5) * xz) * (7.0f * zz - 3.0f)) * row(21)[ch];
      res = res + ((F32(kC4_6) * (xx - yy)) * (7.0f * zz - 1.0f))
                      * row(22)[ch];
      res = res + ((F32(kC4_7) * xz) * (xx - 3.0f * yy)) * row(23)[ch];
      res = res + (F32(kC4_8) * (xx * (xx - 3.0f * yy)
                                  - yy * (3.0f * xx - yy))) * row(24)[ch];
    }
  }
  return res + 0.5f;
}

// Basis function k of eval_sh at (x, y, z) and its gradient (bx, by, bz):
// eval_sh's polynomial as written (the unit length of the direction not
// used), so the gradient is autograd's.
template <int K>
__device__ __forceinline__ float basis(float x, float y, float z, float& bx,
                                       float& by, float& bz) {
  const float xx = x * x, yy = y * y, zz = z * z;
  bx = by = bz = 0.0f;
  switch (K) {
    case 0: return F32(kC0);
    case 1: by = -F32(kC1); return -F32(kC1) * y;
    case 2: bz = F32(kC1); return F32(kC1) * z;
    case 3: bx = -F32(kC1); return -F32(kC1) * x;
    case 4: bx = F32(kC2_0) * y; by = F32(kC2_0) * x;
      return F32(kC2_0) * (x * y);
    case 5: by = F32(kC2_1) * z; bz = F32(kC2_1) * y;
      return F32(kC2_1) * (y * z);
    case 6: bx = F32(kC2_2) * (-2.0f * x); by = F32(kC2_2) * (-2.0f * y);
      bz = F32(kC2_2) * (4.0f * z);
      return F32(kC2_2) * ((2.0f * zz - xx) - yy);
    case 7: bx = F32(kC2_3) * z; bz = F32(kC2_3) * x;
      return F32(kC2_3) * (x * z);
    case 8: bx = F32(kC2_4) * (2.0f * x); by = F32(kC2_4) * (-2.0f * y);
      return F32(kC2_4) * (xx - yy);
    case 9: bx = F32(kC3_0) * (6.0f * x * y);
      by = F32(kC3_0) * (3.0f * xx - 3.0f * yy);
      return F32(kC3_0) * y * (3.0f * xx - yy);
    case 10: bx = F32(kC3_1) * (y * z); by = F32(kC3_1) * (x * z);
      bz = F32(kC3_1) * (x * y);
      return F32(kC3_1) * (x * y) * z;
    case 11: bx = F32(kC3_2) * (-2.0f * x * y);
      by = F32(kC3_2) * ((4.0f * zz - xx) - 3.0f * yy);
      bz = F32(kC3_2) * (8.0f * y * z);
      return F32(kC3_2) * y * ((4.0f * zz - xx) - yy);
    case 12: bx = F32(kC3_3) * (-6.0f * x * z);
      by = F32(kC3_3) * (-6.0f * y * z);
      bz = F32(kC3_3) * ((6.0f * zz - 3.0f * xx) - 3.0f * yy);
      return F32(kC3_3) * z * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
    case 13: bx = F32(kC3_4) * ((4.0f * zz - 3.0f * xx) - yy);
      by = F32(kC3_4) * (-2.0f * x * y);
      bz = F32(kC3_4) * (8.0f * x * z);
      return F32(kC3_4) * x * ((4.0f * zz - xx) - yy);
    case 14: bx = F32(kC3_5) * (2.0f * x * z);
      by = F32(kC3_5) * (-2.0f * y * z);
      bz = F32(kC3_5) * (xx - yy);
      return F32(kC3_5) * z * (xx - yy);
    case 15: bx = F32(kC3_6) * (3.0f * xx - 3.0f * yy);
      by = F32(kC3_6) * (-6.0f * x * y);
      return F32(kC3_6) * x * (xx - 3.0f * yy);
    case 16: bx = F32(kC4_0) * y * (3.0f * xx - yy);
      by = F32(kC4_0) * x * (xx - 3.0f * yy);
      return F32(kC4_0) * (x * y) * (xx - yy);
    case 17: bx = F32(kC4_1) * (6.0f * x * y * z);
      by = F32(kC4_1) * z * (3.0f * xx - 3.0f * yy);
      bz = F32(kC4_1) * y * (3.0f * xx - yy);
      return F32(kC4_1) * (y * z) * (3.0f * xx - yy);
    case 18: bx = F32(kC4_2) * y * (7.0f * zz - 1.0f);
      by = F32(kC4_2) * x * (7.0f * zz - 1.0f);
      bz = F32(kC4_2) * (14.0f * x * y * z);
      return F32(kC4_2) * (x * y) * (7.0f * zz - 1.0f);
    case 19: by = F32(kC4_3) * z * (7.0f * zz - 3.0f);
      bz = F32(kC4_3) * y * (21.0f * zz - 3.0f);
      return F32(kC4_3) * (y * z) * (7.0f * zz - 3.0f);
    case 20: bz = F32(kC4_4) * z * (140.0f * zz - 60.0f);
      return F32(kC4_4) * (zz * (35.0f * zz - 30.0f) + 3.0f);
    case 21: bx = F32(kC4_5) * z * (7.0f * zz - 3.0f);
      bz = F32(kC4_5) * x * (21.0f * zz - 3.0f);
      return F32(kC4_5) * (x * z) * (7.0f * zz - 3.0f);
    case 22: bx = F32(kC4_6) * (2.0f * x) * (7.0f * zz - 1.0f);
      by = F32(kC4_6) * (-2.0f * y) * (7.0f * zz - 1.0f);
      bz = F32(kC4_6) * (14.0f * z) * (xx - yy);
      return F32(kC4_6) * (xx - yy) * (7.0f * zz - 1.0f);
    case 23: bx = F32(kC4_7) * z * (3.0f * xx - 3.0f * yy);
      by = F32(kC4_7) * (-6.0f * x * y * z);
      bz = F32(kC4_7) * x * (xx - 3.0f * yy);
      return F32(kC4_7) * (x * z) * (xx - 3.0f * yy);
    default: bx = F32(kC4_8) * (4.0f * x) * (xx - 3.0f * yy);
      by = F32(kC4_8) * (4.0f * y) * (yy - 3.0f * xx);
      return F32(kC4_8) * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
  }
}

// Coefficient K's part of the SH adjoint: its gradient d_res * B_K written
// over the coefficient's row in place, and sum_ch d_res_ch sh_K,ch times
// the basis' gradient added to the direction's.
template <int K, int DEG>
__device__ __forceinline__ void sh_coef_bwd(float x, float y, float z,
                                            const float (&d_res)[3],
                                            const ShRow& row,
                                            float (&d_dir)[3]) {
  if constexpr (K < (DEG + 1) * (DEG + 1)) {
    float bx, by, bz;
    const float b = basis<K>(x, y, z, bx, by, bz);
    float* c = row(K);
    const float w = (d_res[0] * c[0] + d_res[1] * c[1]) + d_res[2] * c[2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = d_res[ch] * b;
    d_dir[0] = d_dir[0] + w * bx;
    d_dir[1] = d_dir[1] + w * by;
    d_dir[2] = d_dir[2] + w * bz;
    sh_coef_bwd<K + 1, DEG>(x, y, z, d_res, row, d_dir);
  }
}

__host__ __device__ constexpr int sh_rest_floats(int deg) {
  return deg <= 0 ? 0 : 3 * ((deg + 1) * (deg + 1) - 1);
}

// DEG: the SH degree of the colour, -1 for none (colours_precomp or no
// colour: no rgb cotangent is read). COV: the covariance comes from
// cov3d [N, 6], which takes no gradient (scales and rotations unread,
// their gradients not written).
#define LSV2_BWD_PARAMS                                                      \
  Params p, const float* __restrict__ view_dev,                              \
      const float* __restrict__ proj_dev,                                    \
      const float* __restrict__ campos_dev, const float* __restrict__ means, \
      const float* __restrict__ scales, const float* __restrict__ rotations, \
      const float* __restrict__ cov3d, const float* __restrict__ sh_dc,      \
      const float* __restrict__ sh_rest, long long dc_stride,                \
      long long rest_stride, int n, const float* __restrict__ g_xy,          \
      const float* __restrict__ g_conic, const float* __restrict__ g_rgb,    \
      long long xy_stride, long long conic_stride, long long rgb_stride,     \
      float* __restrict__ d_means, float* __restrict__ d_scales,             \
      float* __restrict__ d_rotations, float* __restrict__ d_dc,             \
      float* __restrict__ d_rest, long long d_dc_stride,                     \
      long long d_rest_stride
#define LSV2_BWD_ARGS                                                        \
  p, view_dev, proj_dev, campos_dev, means, scales, rotations, cov3d, sh_dc, \
      sh_rest, dc_stride, rest_stride, n, g_xy, g_conic, g_rgb, xy_stride,   \
      conic_stride, rgb_stride, d_means, d_scales, d_rotations, d_dc,        \
      d_rest, d_dc_stride, d_rest_stride

template <int DEG, bool COV>
__device__ __forceinline__ void preprocess_bwd_body(LSV2_BWD_PARAMS) {
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
  const int g = g0 + lane;
  const bool live = g < n;

  // The cotangents; a null pointer is a zero cotangent.
  float gx[2] = {0.0f, 0.0f}, gc[3] = {0.0f, 0.0f, 0.0f},
        gr[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    if (g_xy != nullptr) {
      gx[0] = g_xy[g * xy_stride];
      gx[1] = g_xy[g * xy_stride + 1];
    }
    if (g_conic != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gc[k] = g_conic[g * conic_stride + k];
    }
    if (DEG >= 0 && g_rgb != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gr[k] = g_rgb[g * rgb_stride + k];
    }
  }
  const bool work = live && (gx[0] != 0.0f || gx[1] != 0.0f ||
                             gc[0] != 0.0f || gc[1] != 0.0f ||
                             gc[2] != 0.0f || gr[0] != 0.0f ||
                             gr[1] != 0.0f || gr[2] != 0.0f);
  const unsigned busy = __ballot_sync(0xffffffffu, work);
  if constexpr (DEG >= 0) {
    // The SH rows of the warp's lanes with work, lane-consecutive.
    const float* dc = sh_dc + (long long)g0 * dc_stride;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = lane + 32 * k;
      const int r = i / 3;
      if (i < rows * 3 && ((busy >> r) & 1u))
        s_dc[warp][i] = dc[r * dc_stride + (i - 3 * r)];
    }
    if constexpr (kRest > 0) {
      const float* rest = sh_rest + (long long)g0 * rest_stride;
#pragma unroll
      for (int k = 0; k < kRest; ++k) {
        const int i = lane + 32 * k;
        const int r = i / kRest;
        if (i < rows * kRest && ((busy >> r) & 1u))
          s_rest[warp][r * kRestPitch + (i - kRest * r)] =
              rest[r * rest_stride + (i - kRest * r)];
      }
    }
  }
  __syncthreads();
  const float* view = s_cam;
  const float* proj = s_cam + 16;
  const float* campos = s_cam + 32;
  float* my_dc = s_dc[warp] + 3 * lane;
  float* my_rest = s_rest[warp] + kRestPitch * lane;

  float dm[3] = {0.0f, 0.0f, 0.0f}, ds[3] = {0.0f, 0.0f, 0.0f},
        dq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (work) {
    const float mx = means[3 * g], my = means[3 * g + 1],
                mz = means[3 * g + 2];
    // --- the forward, as csrc/preprocess.cu computes it ----------------
    auto hrow = [&](const float* m, int j) {
      return ((mx * m[j] + my * m[4 + j]) + mz * m[8 + j]) + m[12 + j];
    };
    const float pv_x = hrow(view, 0), pv_y = hrow(view, 1);
    const float tz = hrow(view, 2);
    const float h_x = hrow(proj, 0), h_y = hrow(proj, 1);
    const float p_w = 1.0f / (hrow(proj, 3) + F32(1e-7));
    const float wx = pv_x / tz, wy = pv_y / tz;
    const float cx = clamp_t(wx, -p.lim_x, p.lim_x);
    const float cy = clamp_t(wy, -p.lim_y, p.lim_y);
    const float tx = cx * tz, ty = cy * tz;
    const float rz = 1.0f / tz;
    const float tz2 = tz * tz;
    const float j0 = rz * p.focal_x;
    const float j2 = (tx * -p.focal_x) / tz2;
    const float k1 = rz * p.focal_y;
    const float k2 = (ty * -p.focal_y) / tz2;
    float m0[3], m1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m0[k] = j0 * view[4 * k] + j2 * view[4 * k + 2];
      m1[k] = k1 * view[4 * k + 1] + k2 * view[4 * k + 2];
    }
    float a, b, c;
    // COV: the 3D covariance's entries; else the normalised rotation, its
    // matrix, s^2 and u = R^T m0, v = R^T m1.
    float sig[6];
    float qn[4], R[3][3], s2[3], u[3], v[3], rq = 0.0f;
    if constexpr (COV) {
      const float* s = cov3d + 6 * g;
#pragma unroll
      for (int k = 0; k < 6; ++k) sig[k] = s[k];
      const float xx = sig[0], xy = sig[1], xz = sig[2], yy = sig[3],
                  yz = sig[4], zz = sig[5];
      auto quad = [&](const float* e, const float* f) {
        return (((((e[0] * f[0]) * xx + (e[1] * f[1]) * yy)
                  + (e[2] * f[2]) * zz)
                 + (e[0] * f[1] + e[1] * f[0]) * xy)
                + (e[0] * f[2] + e[2] * f[0]) * xz)
               + (e[1] * f[2] + e[2] * f[1]) * yz;
      };
      a = quad(m0, m0) + F32(0.3);
      b = quad(m0, m1);
      c = quad(m1, m1) + F32(0.3);
    } else {
      const float q0 = rotations[4 * g], q1 = rotations[4 * g + 1],
                  q2 = rotations[4 * g + 2], q3 = rotations[4 * g + 3];
      const float qnorm = sqrtf((q0 * q0 + q2 * q2) + (q1 * q1 + q3 * q3));
      rq = 1.0f / qnorm;
      qn[0] = q0 / qnorm;
      qn[1] = q1 / qnorm;
      qn[2] = q2 / qnorm;
      qn[3] = q3 / qnorm;
      const float r = qn[0], x = qn[1], y = qn[2], z = qn[3];
      R[0][0] = 1.0f - 2.0f * (y * y + z * z);
      R[0][1] = 2.0f * (x * y - r * z);
      R[0][2] = 2.0f * (x * z + r * y);
      R[1][0] = 2.0f * (x * y + r * z);
      R[1][1] = 1.0f - 2.0f * (x * x + z * z);
      R[1][2] = 2.0f * (y * z - r * x);
      R[2][0] = 2.0f * (x * z - r * y);
      R[2][1] = 2.0f * (y * z + r * x);
      R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s = scales[3 * g + k] * p.scale_modifier;
        s2[k] = s * s;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        u[j] = (m0[0] * R[0][j] + m0[1] * R[1][j]) + m0[2] * R[2][j];
        v[j] = (m1[0] * R[0][j] + m1[1] * R[1][j]) + m1[2] * R[2][j];
      }
      a = (((s2[0] * u[0]) * u[0] + (s2[1] * u[1]) * u[1])
           + (s2[2] * u[2]) * u[2]) + F32(0.3);
      b = ((s2[0] * u[0]) * v[0] + (s2[1] * u[1]) * v[1])
          + (s2[2] * u[2]) * v[2];
      c = (((s2[0] * v[0]) * v[0] + (s2[1] * v[1]) * v[1])
           + (s2[2] * v[2]) * v[2]) + F32(0.3);
    }
    const float det = a * c - b * b;
    const bool det_ok = det != 0.0f;

    // --- xy = ((p_proj + 1) size - 1) / 2, p_proj = h p_w -------------
    const float dpx = (gx[0] * 0.5f) * p.width;
    const float dpy = (gx[1] * 0.5f) * p.height;
    const float dhx = dpx * p_w, dhy = dpy * p_w;
    const float dpw = dpx * h_x + dpy * h_y;
    const float dhw = -dpw * (p_w * p_w);

    // --- conic = (c, -b, a) inv_det, inv_det = det_ok ? 1 / det : 0 ----
    const float inv = det_ok ? 1.0f / det : 0.0f;
    const float dinv = (gc[0] * c - gc[1] * b) + gc[2] * a;
    const float ddet = det_ok ? -dinv * (inv * inv) : 0.0f;
    const float da = gc[2] * inv + ddet * c;
    const float db = -gc[1] * inv - 2.0f * (b * ddet);
    const float dc = gc[0] * inv + ddet * a;

    // --- a, b, c -> m0, m1 (and the covariance's factors) -------------
    float dm0[3], dm1[3];
    if constexpr (COV) {
      // d a = 2 Sigma m0 da, d b: Sigma m1 to m0 and Sigma m0 to m1.
      auto sig_mul = [&](const float* e, float* out) {
        out[0] = (sig[0] * e[0] + sig[1] * e[1]) + sig[2] * e[2];
        out[1] = (sig[1] * e[0] + sig[3] * e[1]) + sig[4] * e[2];
        out[2] = (sig[2] * e[0] + sig[4] * e[1]) + sig[5] * e[2];
      };
      float sm0[3], sm1[3];
      sig_mul(m0, sm0);
      sig_mul(m1, sm1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dm0[k] = 2.0f * da * sm0[k] + db * sm1[k];
        dm1[k] = db * sm0[k] + 2.0f * dc * sm1[k];
      }
    } else {
      float du[3], dv[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float ds2 = (da * (u[j] * u[j]) + db * (u[j] * v[j]))
                          + dc * (v[j] * v[j]);
        du[j] = s2[j] * (2.0f * da * u[j] + db * v[j]);
        dv[j] = s2[j] * (db * u[j] + 2.0f * dc * v[j]);
        // s2 = (s m)^2, s = scales * m.
        ds[j] = ((ds2 * 2.0f) * (scales[3 * g + j] * p.scale_modifier))
                * p.scale_modifier;
      }
      float dR[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dm0[k] = (du[0] * R[k][0] + du[1] * R[k][1]) + du[2] * R[k][2];
        dm1[k] = (dv[0] * R[k][0] + dv[1] * R[k][1]) + dv[2] * R[k][2];
#pragma unroll
        for (int j = 0; j < 3; ++j) dR[k][j] = m0[k] * du[j] + m1[k] * dv[j];
      }
      const float r = qn[0], x = qn[1], y = qn[2], z = qn[3];
      // dR's symmetric and antisymmetric parts.
      const float s01 = dR[0][1] + dR[1][0], s02 = dR[0][2] + dR[2][0],
                  s12 = dR[1][2] + dR[2][1];
      const float a10 = dR[1][0] - dR[0][1], a02 = dR[0][2] - dR[2][0],
                  a21 = dR[2][1] - dR[1][2];
      float dqn[4];
      dqn[0] = 2.0f * ((z * a10 + y * a02) + x * a21);
      dqn[1] = 2.0f * (((y * s01 + z * s02) + r * a21)
                       - 2.0f * x * (dR[1][1] + dR[2][2]));
      dqn[2] = 2.0f * (((x * s01 + z * s12) + r * a02)
                       - 2.0f * y * (dR[0][0] + dR[2][2]));
      dqn[3] = 2.0f * (((x * s02 + y * s12) + r * a10)
                       - 2.0f * z * (dR[0][0] + dR[1][1]));
      // qn = q / |q|: dq = (dqn - qn (qn . dqn)) / |q|.
      const float dot = (qn[0] * dqn[0] + qn[1] * dqn[1])
                        + (qn[2] * dqn[2] + qn[3] * dqn[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) dq[k] = (dqn[k] - qn[k] * dot) * rq;
    }

    // --- m0 = j0 W0 + j2 W2, m1 = k1 W1 + k2 W2 -> the J entries --------
    float dj0 = 0.0f, dj2 = 0.0f, dk1 = 0.0f, dk2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dj0 = dj0 + dm0[k] * view[4 * k];
      dj2 = dj2 + dm0[k] * view[4 * k + 2];
      dk1 = dk1 + dm1[k] * view[4 * k + 1];
      dk2 = dk2 + dm1[k] * view[4 * k + 2];
    }
    // j0 = fx / tz, j2 = -fx tx / tz^2 (and k1, k2 alike).
    const float rz2 = rz * rz;
    const float dtx = dj2 * (-p.focal_x * rz2);
    const float dty = dk2 * (-p.focal_y * rz2);
    float dtz = -(dj0 * j0 + dk1 * k1) * rz
                - 2.0f * (dj2 * j2 + dk2 * k2) * rz;
    // t = clamp(pv / tz, -lim, lim) tz: the clamp passes where
    // -lim <= pv / tz <= lim.
    dtz = dtz + (dtx * cx + dty * cy);
    const float dwx = (wx >= -p.lim_x && wx <= p.lim_x) ? dtx * tz : 0.0f;
    const float dwy = (wy >= -p.lim_y && wy <= p.lim_y) ? dty * tz : 0.0f;
    const float dpvx = dwx * rz, dpvy = dwy * rz;
    dtz = dtz - (dwx * wx + dwy * wy) * rz;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dm[k] = ((dpvx * view[4 * k] + dpvy * view[4 * k + 1])
               + dtz * view[4 * k + 2])
              + ((dhx * proj[4 * k] + dhy * proj[4 * k + 1])
                 + dhw * proj[4 * k + 3]);
    }

    if constexpr (DEG >= 0) {
      // --- rgb = clamp(eval_sh(dir) + 0.5, min=0), dir = d / |d| ------
      const float ex = mx - campos[0], ey = my - campos[1],
                  ez = mz - campos[2];
      const float dn = sqrtf((ex * ex + ez * ez) + ey * ey);
      const float x = ex / dn, y = ey / dn, z = ez / dn;
      const ShRow row{my_dc, my_rest};
      float d_res[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float raw = eval_sh_raw<DEG>(x, y, z, row, ch);
        d_res[ch] = raw >= 0.0f ? gr[ch] : 0.0f;
      }
      float d_dir[3] = {0.0f, 0.0f, 0.0f};
      sh_coef_bwd<0, DEG>(x, y, z, d_res, row, d_dir);
      if (DEG > 0) {
        const float rdn = 1.0f / dn;
        const float dot = (x * d_dir[0] + y * d_dir[1]) + z * d_dir[2];
        dm[0] = dm[0] + (d_dir[0] - x * dot) * rdn;
        dm[1] = dm[1] + (d_dir[1] - y * dot) * rdn;
        dm[2] = dm[2] + (d_dir[2] - z * dot) * rdn;
      }
    }
  } else if constexpr (DEG >= 0) {
    // No work: zero gradients for the lane's SH rows.
#pragma unroll
    for (int k = 0; k < 3; ++k) my_dc[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRest; ++k) my_rest[k] = 0.0f;
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d_means[3 * g + k] = dm[k];
    if constexpr (!COV) {
#pragma unroll
      for (int k = 0; k < 3; ++k) d_scales[3 * g + k] = ds[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) d_rotations[4 * g + k] = dq[k];
    }
  }
  if constexpr (DEG >= 0) {
    // The warp's SH gradients, lane-consecutive.
    __syncwarp();
    float* ddc = d_dc + (long long)g0 * d_dc_stride;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = lane + 32 * k;
      if (i < rows * 3) {
        const int r = i / 3;
        ddc[r * d_dc_stride + (i - 3 * r)] = s_dc[warp][i];
      }
    }
    if constexpr (kRest > 0) {
      float* drest = d_rest + (long long)g0 * d_rest_stride;
#pragma unroll
      for (int k = 0; k < kRest; ++k) {
        const int i = lane + 32 * k;
        if (i < rows * kRest) {
          const int r = i / kRest, c = i - kRest * r;
          drest[r * d_rest_stride + c] = s_rest[warp][r * kRestPitch + c];
        }
      }
    }
  }
}

template <int DEG, bool COV>
__global__ void __launch_bounds__(kThreads) preprocess_bwd_kernel(
    LSV2_BWD_PARAMS) {
  preprocess_bwd_body<DEG, COV>(LSV2_BWD_ARGS);
}

// SH degree 2 (the step-up to degree 3 runs it in training's second
// thousand iterations): left to itself ptxas keeps 4 blocks an SM at 128
// registers and spills; held to 3 blocks an SM it needs ~110, no spill.
template <bool COV>
__global__ void __launch_bounds__(kThreads, 3) preprocess_bwd_kernel_deg2(
    LSV2_BWD_PARAMS) {
  preprocess_bwd_body<2, COV>(LSV2_BWD_ARGS);
}

template <int DEG, bool COV>
const void* kernel_of() {
  if constexpr (DEG == 2)
    return reinterpret_cast<const void*>(&preprocess_bwd_kernel_deg2<COV>);
  else
    return reinterpret_cast<const void*>(&preprocess_bwd_kernel<DEG, COV>);
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

// host_params: csrc/preprocess.cu's `Params` in host memory (a camera slot
// whose device pointer is given is not read). sh_degree -1: no SH colour
// (g_rgb unread, no SH gradient). cov3d null: scales and rotations, whose
// gradients are written; else neither is read or written. A null
// cotangent is zero. Strides in floats: SH rows in and out, cotangent
// rows (each row's values contiguous). Every gradient output is written in
// full (the first (deg + 1)^2 SH coefficients of a row; the caller zeroes
// any further ones).
extern "C" int lsv2_preprocess_bwd(
    const float* host_params, const float* view_dev, const float* proj_dev,
    const float* campos_dev, const float* means, const float* scales,
    const float* rotations, const float* cov3d, const float* sh_dc,
    const float* sh_rest, long long dc_stride, long long rest_stride,
    int sh_degree, int n, const float* g_xy, const float* g_conic,
    const float* g_rgb, long long xy_stride, long long conic_stride,
    long long rgb_stride, float* d_means, float* d_scales,
    float* d_rotations, float* d_dc, float* d_rest, long long d_dc_stride,
    long long d_rest_stride, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  const bool cov = cov3d != nullptr;
  if (kernel_for(sh_degree, cov) == nullptr || n < 0 ||
      host_params == nullptr || means == nullptr || d_means == nullptr ||
      (!cov && (scales == nullptr || rotations == nullptr ||
                d_scales == nullptr || d_rotations == nullptr)) ||
      (sh_degree >= 0 && (sh_dc == nullptr || d_dc == nullptr ||
                          (sh_degree > 0 && (sh_rest == nullptr ||
                                             d_rest == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Params p;
  const float* src = host_params;
  float* dst = reinterpret_cast<float*>(&p);
  for (int i = 0; i < kHostFloats; ++i) dst[i] = src[i];
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LSV2_PRE_BWD(...)                                                    \
  __VA_ARGS__<<<blocks, kThreads, 0, st>>>(                                  \
      p, view_dev, proj_dev, campos_dev, means, scales, rotations, cov3d,   \
      sh_dc, sh_rest, dc_stride, rest_stride, n, g_xy, g_conic, g_rgb,      \
      xy_stride, conic_stride, rgb_stride, d_means, d_scales, d_rotations,  \
      d_dc, d_rest, d_dc_stride, d_rest_stride)
#define LSV2_PRE_BWD_DEG(D)                                                  \
  if (cov) LSV2_PRE_BWD(preprocess_bwd_kernel<D, true>);                     \
  else LSV2_PRE_BWD(preprocess_bwd_kernel<D, false>);
  switch (sh_degree) {
    case -1: LSV2_PRE_BWD_DEG(-1) break;
    case 0: LSV2_PRE_BWD_DEG(0) break;
    case 1: LSV2_PRE_BWD_DEG(1) break;
    case 2:
      if (cov) LSV2_PRE_BWD(preprocess_bwd_kernel_deg2<true>);
      else LSV2_PRE_BWD(preprocess_bwd_kernel_deg2<false>);
      break;
    case 3: LSV2_PRE_BWD_DEG(3) break;
    default: LSV2_PRE_BWD_DEG(4) break;
  }
#undef LSV2_PRE_BWD_DEG
#undef LSV2_PRE_BWD
  return static_cast<int>(cudaGetLastError());
}

// The kernel's occupancy at one SH degree (scales / rotations): blocks an
// SM, static shared bytes, registers a thread, local bytes a thread,
// threads a block.
extern "C" int lsv2_preprocess_bwd_occupancy(int sh_degree, int* out) {
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
