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
// __nv_bfloat162 pair (bf16), the repetitions unrolled in registers.
//
// bf16 (mode 1): the muls and adds are packed bf16x2 instructions, each
// rounded once to bf16; the compares run in f32 on the bf16 values, as
// JAX's do; exp is expf in f32, rounded to bf16, which is what
// XLA does with a bf16 exp. Mode 2 is a what-if that is not the TPU
// kernel's arithmetic and that no wrapper exposes: the exp as
// ex2.approx.ftz.bf16x2 (one special-function instruction a pair), timed
// by chip_smoke.py phase 18 only.
//
// Numerics: compiled with -fmad=false, so each f32 op rounds on its own as
// in the plain PyTorch version: a fused x + e * step moves e across the
// 0.999 compare on some of 33M elements, and acc by |e - 1/2|. A bf16x2 add
// of two bf16 values is exact in f32 before its rounding, so the packed
// adds give XLA's f32-then-bf16 result.
//
// Bound on this card: operations. Per chain ~8 f32 operations and one exp;
// the exp runs on the special-function units (16 results a clock an SM,
// against 128 f32 lanes), so at the data sheet's rates the exp sets the
// bound. 8 B moved an element against 64 chains: bytes do not bind.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kReps = 64;
constexpr float kLim = 0.999f;

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

__device__ __forceinline__ __nv_bfloat162 exp_f32_rounded(__nv_bfloat162 t) {
  const float2 f = __bfloat1622float2(t);
  return __floats2bfloat162_rn(expf(f.x), expf(f.y));
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

template <bool kEx2>
__global__ void __launch_bounds__(256)
    chain_bf16(const float2* __restrict__ in, float2* __restrict__ out,
               long long pairs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  __nv_bfloat162 x = __float22bfloat162_rn(in[i]);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 step = __float2bfloat162_rn(1e-3f);
  __nv_bfloat162 acc = __float2bfloat162_rn(0.0f);
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    const __nv_bfloat162 a = __hmul2(x, half);
    const __nv_bfloat162 t = __hmul2(__hneg2(a), a);
    const __nv_bfloat162 e = kEx2 ? exp_ex2_bf16x2(t) : exp_f32_rounded(t);
    const float2 ef = __bfloat1622float2(e), af = __bfloat1622float2(a);
    const bool m0 = (ef.x <= kLim) & (af.x >= -kLim);
    const bool m1 = (ef.y <= kLim) & (af.y >= -kLim);
    acc = __hadd2(acc, __halves2bfloat162(m0 ? __low2bfloat16(e)
                                             : __low2bfloat16(half),
                                         m1 ? __high2bfloat16(e)
                                            : __high2bfloat16(half)));
    x = __hadd2(x, __hmul2(e, step));
  }
  out[i] = __bfloat1622float2(acc);
}

}  // namespace

// mode 0: f32; 1: bf16 (K9's bf16 form); 2: bf16 with ex2.approx.bf16x2
// (a what-if, not the TPU kernel). n must be even for modes 1 and 2.
extern "C" int lsv2_cell_chain(const float* in, float* out, long long n,
                               int mode, void* stream) {
  cudaGetLastError();  // drop a stale error so only this launch reports
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (mode == 0) {
    if (n > 0)
      chain_f32<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
          in, out, n);
  } else if (mode == 1 || mode == 2) {
    if (n % 2) return static_cast<int>(cudaErrorInvalidValue);
    const long long pairs = n / 2;
    const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
    const float2* in2 = reinterpret_cast<const float2*>(in);
    float2* out2 = reinterpret_cast<float2*>(out);
    if (pairs > 0) {
      if (mode == 1)
        chain_bf16<false><<<blocks, threads, 0, st>>>(in2, out2, pairs);
      else
        chain_bf16<true><<<blocks, threads, 0, st>>>(in2, out2, pairs);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
