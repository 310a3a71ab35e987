// Error text for the cudaError_t codes the launch functions return, and an
// empty kernel whose launch chip_smoke.py times as the floor under any
// kernel's time (a launch that does no work).
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One block of one thread that does nothing, on `stream`; returns the
// launch's cudaError_t.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
