// The text of a cudaError_t returned by the kernels' C entry points.
#include <cuda_runtime.h>

extern "C" const char* smf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
