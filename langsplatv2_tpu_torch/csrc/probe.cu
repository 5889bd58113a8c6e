// K9: the elementwise cell-chain probe, f32 against bf16.
//
// Replaces the TPU kernel scripts/profile_vpu_bf16.py::kernel (pallas_call at
// :53), a probe of whether the TPU's vector unit runs bf16 cell math at twice
// the f32 rate. Each element runs kReps repetitions of
//   a = x * 1/2;  e = exp(-a * a);
//   m = (f32(e) <= 0.999) & (f32(a) >= -0.999);
//   acc += m ? e : 1/2;  x += e * step   (step = 1e-3 rounded to the type)
// and writes acc as f32. The Pallas kernel works on [256, 256] blocks; here
// the chain is elementwise, so a thread takes one element (f32) or one
// __nv_bfloat162 pair (bf16), the repetitions in registers.
//
// bf16 (mode 1) keeps a pair packed from end to end:
// - the muls and adds are packed bf16x2 instructions, each rounded once to
//   bf16, as XLA rounds each bf16 op;
// - s = a * a (so -a * a is -s exactly), and e = bf16(expf(-s)): XLA's bf16
//   exp is expf in f32, rounded. The kernel takes y = ex2.approx.ftz.f32(s *
//   -log2(e)) instead and rounds that, where that provably rounds the same
//   way (below);
// - the compares are packed set instructions on the bf16 values against
//   the bf16 neighbours of +-0.999: f32(e) <= 0.999f is e <= 0.99609375 and
//   f32(a) >= -0.999f is a >= -0.99609375 exactly (0.99609375 is the largest
//   bf16 value not above 0.999; the next is 1.0), which
//   tests/test_torch_port_probe.py checks over all 65,536 bf16 values;
// - the select is the compares' 0xFFFF half masks and one lop3.
// The exp's error: for 0 <= s < 2, y is within 12 f32 ulps (integer steps of
// its bits, counted in the smaller ulp where y and expf straddle a power of
// two: a relative error r is at most r * 2^24 steps) of CUDA's expf(-s):
// ex2.approx.ftz.f32 at most 2^-22 relative (CUDA's 2-ulp figure for
// ex2.approx, the constant term of __expf's 2 + floor(1.173 |x|) ulps), i.e.
// 4 steps; log2(e) rounded to f32 and the product s * -log2(e) rounded, each
// |u| * 2^-24 in u = s * log2(e), i.e. s * 2^-24 relative, 2 steps each; and
// expf's own 2 ulps, 4 steps. bf16 rounds y's bits at low 16 bits = 0x8000,
// so where those lie more than kNear = 16 steps from 0x8000, y and expf(-s)
// round to the same bf16 (ties included). The chain keeps, over its 64
// repetitions, the least distance of a y from a midpoint and the bits of s
// (at the first and last repetition, where s is largest); if a y came near
// a midpoint or an s left [0, 2), the pair runs the whole chain again with
// expf (out of line; counted when `stats` is given). Few of the 16,384
// bf16 s in [0, 2) have an expf that near a midpoint, and bf16 squares
// rarely hit them: on [512, 256, 256] inputs in [-1, 1) no pair runs
// again (chip_smoke.py phase 18). Mode 3 runs the exp and its check alone
// on given s pairs, so that a card test can hold it against torch's exp on
// every non-negative bf16 s. Mode 2 is a what-if that is not the TPU
// kernel's arithmetic and that no wrapper exposes: the exp as
// ex2.approx.ftz.bf16x2 (one special-function instruction a pair), timed by
// chip_smoke.py phase 18 only.
//
// Numerics: compiled with -fmad=false, so each f32 op rounds on its own as
// in the plain PyTorch version: a fused x + e * step moves e across the
// 0.999 compare on some of 33M elements, and acc by |e - 1/2|. A bf16x2 add
// of two bf16 values is exact in f32 before its rounding, so the packed
// adds give XLA's f32-then-bf16 result.
//
// Bound on this card: operations (chip_smoke.py phase 18 takes the largest
// of five floors: bytes, the MUFU's one exp a chain, the FP32 lanes, the
// packed lanes and the issue slots the chain needs). Both forms are
// issue-bound: f32 at 16.5 SASS instructions a chain (expf's sequence is 8
// of them), bf16 at 10 on its common path (the midpoint check 1.5 of them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kReps = 64;
constexpr float kLim = 0.999f;
constexpr float kNegLog2e = -1.4426950408889634f;
constexpr unsigned kNear = 16;            // f32 steps around a midpoint
constexpr unsigned kNearBias = (kNear - 0x8000u) << 16;
constexpr unsigned kNearSpan = (2 * kNear) << 16;

__global__ void __launch_bounds__(256)
    chain_f32(const float* __restrict__ in, float* __restrict__ out,
              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = in[i], acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    const float a = x * 0.5f;
    const float e = expf(-a * a);
    const bool m = (e <= kLim) & (a >= -kLim);
    acc = acc + (m ? e : 0.5f);
    x = x + e * 1e-3f;
  }
  out[i] = acc;
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 from_bits(unsigned u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ float ex2_approx(float u) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(u));
  return y;
}

// What decides whether a chain's approximate exps all round as expf would:
// the least midpoint distance over its ys ((bits << 16) + kNearBias, at most
// kNearSpan within kNear steps of a bf16 rounding midpoint) and the OR of
// its s pairs' bits (sign or exponent top bit set: s not in [0, 2)).
struct ExpCheck {
  unsigned near = 0xFFFFFFFFu, s_bits = 0;
  __device__ bool holds() const {
    return near > kNearSpan && (s_bits & 0xC000C000u) == 0;
  }
};

__device__ __forceinline__ unsigned midpoint_distance(float y) {
  return (__float_as_uint(y) << 16) + kNearBias;
}

// bf16(ex2.approx(-s log2 e)) of a pair s >= 0, recording in `check` what
// decides whether it is bf16(expf(-s)); with kRange, also s's bits.
template <bool kRange>
__device__ __forceinline__ __nv_bfloat162 exp_neg_approx(__nv_bfloat162 s,
                                                        ExpCheck& check) {
  const unsigned sb = bits_of(s);
  const float y0 = ex2_approx(__uint_as_float(sb << 16) * kNegLog2e);
  const float y1 = ex2_approx(__uint_as_float(sb & 0xFFFF0000u) * kNegLog2e);
  check.near = min(check.near,
                   min(midpoint_distance(y0), midpoint_distance(y1)));
  if (kRange) check.s_bits |= sb;
  return __floats2bfloat162_rn(y0, y1);
}

// bf16(expf(-s)) of a pair: XLA's bf16 exp.
__device__ __forceinline__ __nv_bfloat162 exp_neg_exact(__nv_bfloat162 s) {
  const unsigned sb = bits_of(s);
  return __floats2bfloat162_rn(expf(-__uint_as_float(sb << 16)),
                               expf(-__uint_as_float(sb & 0xFFFF0000u)));
}

__device__ __forceinline__ __nv_bfloat162 exp_ex2_bf16x2(__nv_bfloat162 t) {
  const __nv_bfloat162 log2e = __float2bfloat162_rn(1.4426950408889634f);
  const __nv_bfloat162 u = __hmul2(t, log2e);
  __nv_bfloat162 r;
  asm("ex2.approx.ftz.bf16x2 %0, %1;"
      : "=r"(*reinterpret_cast<unsigned*>(&r))
      : "r"(*reinterpret_cast<const unsigned*>(&u)));
  return r;
}

// The chain on a pair from x, its acc. kExp: 0 the approximate exp
// (recording `check`), 1 expf, 2 ex2.approx.bf16x2 (the what-if). x never
// falls (e * step >= 0 and bf16 rounding is monotone), so a = x / 2 only
// rises, and s = a * a is largest at the first or the last repetition:
// the check reads s's bits only there.
template <int kExp>
__device__ __forceinline__ __nv_bfloat162 bf16_chain(__nv_bfloat162 x,
                                                    ExpCheck& check) {
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 step = __float2bfloat162_rn(1e-3f);
  const __nv_bfloat162 lim = __float2bfloat162_rn(0.99609375f);
  const __nv_bfloat162 neg_lim = __float2bfloat162_rn(-0.99609375f);
  __nv_bfloat162 acc = __float2bfloat162_rn(0.0f);
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    const __nv_bfloat162 a = __hmul2(x, half);
    const __nv_bfloat162 s = __hmul2(a, a);  // -a * a is -s exactly
    __nv_bfloat162 e;
    if (kExp == 0)
      e = r == 0 || r == kReps - 1 ? exp_neg_approx<true>(s, check)
                                   : exp_neg_approx<false>(s, check);
    else if (kExp == 1)
      e = exp_neg_exact(s);
    else
      e = exp_ex2_bf16x2(__hneg2(s));
    const unsigned m = __hle2_mask(e, lim) & __hge2_mask(a, neg_lim);
    acc = __hadd2(acc, from_bits((m & bits_of(e)) | (~m & bits_of(half))));
    x = __hadd2(x, __hmul2(e, step));
  }
  return acc;
}

// The chain with expf, for the rare pair whose check fails (out of line).
__device__ __noinline__ __nv_bfloat162 bf16_chain_exact(__nv_bfloat162 x) {
  ExpCheck unused;
  return bf16_chain<1>(x, unused);
}

// Adds the warp's fallback counts to stats.
__device__ void add_stats(unsigned long long* stats, unsigned fell_back) {
  const unsigned active = __activemask();
  const unsigned n = __reduce_add_sync(active, fell_back);
  if (n && threadIdx.x % 32 == __ffs(active) - 1) atomicAdd(stats, n);
}

template <int kExp>
__global__ void __launch_bounds__(256)
    chain_bf16(const float2* __restrict__ in, float2* __restrict__ out,
               long long pairs, unsigned long long* stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const __nv_bfloat162 x = __float22bfloat162_rn(in[i]);
  ExpCheck check;
  __nv_bfloat162 acc = bf16_chain<kExp>(x, check);
  const unsigned fell_back = kExp == 0 && !check.holds();
#ifndef LSV2_PROBE_HOT_PATH  // a build profile tools make to count SASS
  if (fell_back) acc = bf16_chain_exact(x);  // rare: the chain with expf
#endif
  out[i] = __bfloat1622float2(acc);
  if (stats) add_stats(stats, fell_back);
}

// The bf16 form's exp alone: each pair of `in` (bf16 values s >= 0 held as
// f32) to bf16(expf(-s)) as f32, through the approximation and its check.
__global__ void __launch_bounds__(256)
    exp_only(const float2* __restrict__ in, float2* __restrict__ out,
             long long pairs, unsigned long long* stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const __nv_bfloat162 s = __float22bfloat162_rn(in[i]);
  ExpCheck check;
  __nv_bfloat162 e = exp_neg_approx<true>(s, check);
  const unsigned fell_back = !check.holds();
  if (fell_back) e = exp_neg_exact(s);
  out[i] = __bfloat1622float2(e);
  if (stats) add_stats(stats, fell_back);
}

}  // namespace

// mode 0: f32; 1: bf16 (K9's bf16 form); 2: bf16 with ex2.approx.bf16x2
// (a what-if, not the TPU kernel); 3: the bf16 form's exp alone on s pairs.
// n must be even for modes 1-3. stats (modes 1 and 3, may be null): adds
// the pairs whose exp fell back to expf and the warps' branches into it.
extern "C" int lsv2_cell_chain(const float* in, float* out, long long n,
                               int mode, unsigned long long* stats,
                               void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (mode == 0) {
    if (n > 0)
      chain_f32<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
          in, out, n);
  } else if (mode >= 1 && mode <= 3) {
    if (n % 2) return static_cast<int>(cudaErrorInvalidValue);
    const long long pairs = n / 2;
    const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
    const float2* in2 = reinterpret_cast<const float2*>(in);
    float2* out2 = reinterpret_cast<float2*>(out);
    if (pairs > 0) {
      if (mode == 1)
        chain_bf16<0><<<blocks, threads, 0, st>>>(in2, out2, pairs,
                                                      stats);
      else if (mode == 2)
        chain_bf16<2><<<blocks, threads, 0, st>>>(in2, out2, pairs,
                                                     nullptr);
      else
        exp_only<<<blocks, threads, 0, st>>>(in2, out2, pairs, stats);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
