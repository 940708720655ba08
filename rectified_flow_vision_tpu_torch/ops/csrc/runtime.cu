// Error text for the codes the kernel entry points return. The library links
// the CUDA runtime statically, so the strings come from that same runtime.
#include <cuda_runtime.h>

extern "C" const char* rfv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
