// clock64 phase marks of K3 and K6b, read by profile_query_gram.py
// --phases. They expand to nothing unless the source is built with
// -DLSV2_PHASES. Thread 0 of each block adds the cycles since its last mark
// to slot k of a per-source device array; slot 14 counts units of work,
// slot 15 the block's cycles in all. PHASE_TOUCH(r) waits for register r
// (an outstanding load) to land, so that the wait is charged to the mark
// before the products and not to them.
#pragma once

#ifdef LSV2_PHASES
#define PHASE_STORAGE(arr, readout)                                      \
  __device__ unsigned long long arr[16];                                 \
  extern "C" int readout(unsigned long long* out) {                      \
    const unsigned long long zero[16] = {};                              \
    cudaError_t e = cudaMemcpyFromSymbol(out, arr, sizeof(zero));        \
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(arr, zero, sizeof(zero)); \
    return static_cast<int>(e);                                          \
  }
#define PHASE_BEGIN                  \
  long long ph_prev = clock64();     \
  const long long ph_begin = ph_prev; \
  unsigned long long ph[16] = {};
#define PHASE_MARK(k)                        \
  if (threadIdx.x == 0) {                    \
    const long long ph_t = clock64();        \
    ph[k] += ph_t - ph_prev;                 \
    ph_prev = ph_t;                          \
  }
#define PHASE_COUNT() \
  if (threadIdx.x == 0) ph[14] += 1;
#define PHASE_TOUCH(r) asm volatile("mov.b32 %0, %0;\n" : "+r"(r));
#define PHASE_END(arr)                                        \
  if (threadIdx.x == 0) {                                     \
    ph[15] = clock64() - ph_begin;                            \
    for (int k = 0; k < 16; ++k) atomicAdd(&arr[k], ph[k]);   \
  }
#else
#define PHASE_STORAGE(arr, readout)
#define PHASE_BEGIN
#define PHASE_MARK(k)
#define PHASE_COUNT()
#define PHASE_TOUCH(r)
#define PHASE_END(arr)
#endif
