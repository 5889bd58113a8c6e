// Tensor-core products (f32-accurate 3xTF32, and bf16) and asynchronous
// copies, shared by query.cu (K3), blend.cu (K2q), gram.cu (K6a, K6b),
// feature_bwd.cu (K4), rgb_bwd.cu (K7) and feature_bwd_topk.cu (K5, the
// copies only).
//
// 3xTF32: x = big + small, both TF32; a.b ~ as.bb + ab.bs + ab.bb on
// mma.sync m16n8k8 with f32 sums (the dropped as.bs is ~2^-22 of a.b).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// x = big + small for 3xTF32: big is x rounded to TF32 (half an ulp added,
// the 13 low bits cleared: two integer ops, where cvt.rna.tf32.f32 takes
// several), small = x - big exactly in f32; the tensor core drops small's
// own 13 low bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float* a, unsigned* ab,
                                       unsigned* as) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
}

// d += a . b: A 16x8 TF32 (row), B 8x8 TF32 (col), f32 sums. For lane
// (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b: A 16x16 bf16 (row), B 16x8 bf16 (col), f32 sums. For lane
// (g, t): a = A[g][2t, 2t+1], A[g+8][2t, 2t+1], A[g][2t+8, 2t+9],
// A[g+8][2t+8, 2t+9]; b = B[2t, 2t+1][g], B[2t+8, 2t+9][g] (the lower
// index in the low half); d as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 16 bytes, both addresses 16-byte aligned (bypasses L1).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 4 bytes (a gathered field), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kN of this thread's latest groups are in flight.
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

}  // namespace
