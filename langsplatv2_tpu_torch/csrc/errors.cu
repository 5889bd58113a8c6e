// Error text for the C entry points' cudaError_t return codes.
#include <cuda_runtime.h>

extern "C" const char* lsv2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
