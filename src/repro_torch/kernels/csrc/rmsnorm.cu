// RMSNorm forward for Hopper: out = x * rsqrt(mean(x^2) + eps) * scale per row,
// fp32 inside.
//
// Replaces: repro/kernels/rmsnorm.py `_rmsnorm_kernel` (pallas_call in
// `rms_norm`).  The TPU kernel keeps a block of rows with the whole feature
// dim resident in VMEM.
//
// Bound on this card: at decode sizes ([slots, 2560]) the work is ~80 KB of
// traffic, so a call is bound by launch latency, not bytes or FLOPs.
// Design: one 256-thread block per row; a strided fp32 sum of squares, a
// warp-shuffle + shared-memory block reduction, then one scaled pass.  The
// row is read twice, the second time from L1/L2.  Fusing the norm into its
// consumer's prologue (or a CUDA graph over the decode step) is what removes
// the launch cost, in a later change.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ out, int d, float eps) {
  const float* xr = x + static_cast<size_t>(blockIdx.x) * d;
  float* orow = out + static_cast<size_t>(blockIdx.x) * d;
  __shared__ float part[kThreads / 32];

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = xr[i];
    ss = fmaf(v, v, ss);
  }
  ss = repro::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
    t = repro::warp_sum(t);
    if (threadIdx.x == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) orow[i] = xr[i] * r * scale[i];
}

}  // namespace

// x, out [n, d] row-major fp32; scale [d].  Launches on `stream`, allocates
// nothing; returns the launch's cudaError_t.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* out,
                           int n, int d, float eps, void* stream) {
  if (n <= 0) return 0;
  rmsnorm_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, out, d, eps);
  return static_cast<int>(cudaGetLastError());
}
