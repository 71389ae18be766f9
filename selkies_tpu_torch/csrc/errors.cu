// The text of the CUDA error code that a C entry of the port's library
// returns (ops/_cuda.py:launch puts it in the exception it raises).
#include <cuda_runtime.h>

extern "C" const char* sk_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
