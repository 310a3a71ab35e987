// RMSNorm forward for Hopper: out = x * rsqrt(mean(x^2) + eps) * scale per row,
// fp32 inside.
//
// Replaces: repro/kernels/rmsnorm.py `_rmsnorm_kernel` (pallas_call in
// `rms_norm`).  The TPU kernel keeps a block of rows with the whole feature
// dim resident in VMEM.
//
// Bound on this card: bytes.  x is read once and out written once, 8 n d + 4
// d bytes against ~4 n d FLOPs; at decode ([slots, 2560], ~80 KB) a call is
// bound by launch latency, at a prefill or a large batch by those bytes.
// Design: one warp per row, kRows rows per block, so a large n fills the SMs
// and no block-wide barrier is needed.  A lane issues the loads of all its
// VEC float4s of x and of scale in one pass, keeps the row in registers,
// sums its squares, and one xor-butterfly reduces the warp; it then scales
// the registers and stores float4s.  One memory round trip per row.
// The same kernel's second path (VEC = 0) takes d % 4 != 0, an operand not
// 16-byte aligned, or a row too wide for registers (d > 32 * 4 * kMaxVec):
// a strided loop sums the squares and a second pass scales, reading the row
// again (from L1 / L2).  Both paths sum a lane's elements in the same order
// (4 (lane + 32 c) + k for c, then k, ascending) and reduce the warp the same
// way, so the sum order depends on d alone: a row's output is bitwise the
// same at any n and on either path.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRows = 4;                  // rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr int kMaxVec = 24;               // float4s per lane held in registers

template <int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ out, int n, int d, float eps) {
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  float* orow = out + static_cast<size_t>(row) * d;
  float ss = 0.f;
  if constexpr (VEC > 0) {
    const int d4 = d >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    float4 xv[VEC], sv[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const int i = lane + 32 * c;
      const bool ok = i < d4;
      xv[c] = ok ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      sv[c] = ok ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      ss = fmaf(xv[c].x, xv[c].x, ss);
      ss = fmaf(xv[c].y, xv[c].y, ss);
      ss = fmaf(xv[c].z, xv[c].z, ss);
      ss = fmaf(xv[c].w, xv[c].w, ss);
    }
    ss = repro::warp_sum(ss);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    float4* o4 = reinterpret_cast<float4*>(orow);
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const int i = lane + 32 * c;
      if (i < d4)
        o4[i] = make_float4(xv[c].x * r * sv[c].x, xv[c].y * r * sv[c].y,
                            xv[c].z * r * sv[c].z, xv[c].w * r * sv[c].w);
    }
  } else {
    for (int i0 = 4 * lane; i0 < d; i0 += 128)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e < d) {
          const float v = xr[i0 + e];
          ss = fmaf(v, v, ss);
        }
    ss = repro::warp_sum(ss);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int i = lane; i < d; i += 32) orow[i] = xr[i] * r * scale[i];
  }
}

}  // namespace

// x, out [n, d] row-major fp32; scale [d].  Launches on `stream`, allocates
// nothing; returns the launch's cudaError_t.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* out,
                           int n, int d, float eps, void* stream) {
  if (n <= 0) return 0;
  const int per_lane = (d / 4 + 31) / 32;
  const bool vec = d % 4 == 0 && per_lane <= kMaxVec && repro::aligned(x, 16) &&
                   repro::aligned(scale, 16) && repro::aligned(out, 16);
  const dim3 grid((n + kRows - 1) / kRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(VEC) rmsnorm_kernel<VEC><<<grid, kThreads, 0, s>>>(x, scale, out, n, d, eps)
  if (!vec) REPRO_LAUNCH(0);
  else if (per_lane <= 1) REPRO_LAUNCH(1);
  else if (per_lane <= 2) REPRO_LAUNCH(2);
  else if (per_lane <= 4) REPRO_LAUNCH(4);
  else if (per_lane <= 8) REPRO_LAUNCH(8);
  else if (per_lane <= 12) REPRO_LAUNCH(12);
  else if (per_lane <= 16) REPRO_LAUNCH(16);
  else if (per_lane <= 20) REPRO_LAUNCH(20);
  else REPRO_LAUNCH(24);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
