// Error text for the codes the kernel entries return.

#include <cuda_runtime.h>

extern "C" const char* probunet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
