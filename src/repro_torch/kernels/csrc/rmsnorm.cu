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
// Design: one warp per row, up to kRows rows per block, so a large n fills
// the SMs.  Three paths, one template instance each (VEC):
//  * Registers (VEC > 0: d % 4 == 0, every operand 16-byte aligned, d <= 32
//    * 4 * kMaxVec = 3072): a lane issues the loads of all its VEC float4s
//    of x and of scale in one pass, keeps the row in registers, sums its
//    squares, and one xor-butterfly reduces the warp; it then scales the
//    registers and stores float4s.  One memory round trip per row.
//  * Staged (kStaged: the same, 3072 < d <= kStageMaxD; phi3's 5120,
//    qwen's 8192): a lane starts cp.async copies of all its float4s of the
//    warp's row into the warp's row of shared memory (the whole row in
//    flight), and the block's threads copy the scale into one shared row
//    beside them (a second group, still in flight while the squares are
//    summed); then the sum, and the float4 stores, read shared memory: x is
//    read from device memory once.  4 d bytes a warp and 4 d for the
//    scale: 4 warps a block at both widths (2 blocks an SM at 5120, 1 at
//    8192); fewer warps where a block would not fit.
//  * Strided (kStrided: d % 4 != 0, an operand not 16-byte aligned, or d >
//    kStageMaxD, wider than any model's norm): a strided loop sums the
//    squares and a second pass scales, reading the row again (from L1 /
//    L2).
// Every path sums a lane's elements in the same order (4 (lane + 32 c) + k
// for c, then k, ascending), reduces the warp the same way and writes x r
// scale with the same expression, so the sum order depends on d alone: a
// row's output is bitwise the same at any n and on any path (the staged
// path's is the strided one's, which wide rows took before it).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRows = 4;                  // rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr int kMaxVec = 24;               // float4s per lane held in registers
constexpr int kSmemMax = 232448;          // shared memory a block can use
// the widest row staged: one warp's row and the scale (8 d bytes)
constexpr int kStageMaxD = kSmemMax / 8;
constexpr int kStrided = 0, kStaged = -2; // the paths (VEC > 0: registers)

template <int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ out, int n, int d, float eps) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // the staged path's warps all take part in copying the scale
  if (VEC != kStaged && row >= n) return;
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
  } else if constexpr (VEC == kStaged) {
    // [scale | warp 0's row | warp 1's row | ...], d floats each
    extern __shared__ float4 smem4[];
    const int d4 = d >> 2;
    float4* const sc4 = smem4;
    float4* const xs4 = smem4 + static_cast<size_t>((threadIdx.x >> 5) + 1) * d4;
    const bool live = row < n;                 // the same for the whole warp
    if (live) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      for (int i = lane; i < d4; i += 32) repro::cp_async16(xs4 + i, x4 + i);
    }
    repro::cp_async_commit();
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    for (int i = threadIdx.x; i < d4; i += blockDim.x)
      repro::cp_async16(sc4 + i, s4 + i);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();                 // this lane's x has landed
    float r = 0.f;
    if (live) {                                // a lane reads what it copied
#pragma unroll 4
      for (int i = lane; i < d4; i += 32) {
        const float4 v = xs4[i];
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
      ss = repro::warp_sum(ss);
      r = rsqrtf(ss / static_cast<float>(d) + eps);
    }
    repro::cp_async_wait<0>();
    __syncthreads();                           // every thread's scale copies
    if (!live) return;
    float4* o4 = reinterpret_cast<float4*>(orow);
#pragma unroll 4
    for (int i = lane; i < d4; i += 32) {
      const float4 v = xs4[i], s = sc4[i];
      o4[i] = make_float4(v.x * r * s.x, v.y * r * s.y, v.z * r * s.z,
                          v.w * r * s.w);
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

// The staged instance's shared memory limit, raised once a device (the
// launch's current one) to all a block can use.
cudaError_t allow_staged_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(rmsnorm_kernel<kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// x, out [n, d] row-major fp32; scale [d].  Launches on `stream`, allocates
// nothing; returns the first failing call's cudaError_t.
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* out,
                           int n, int d, float eps, void* stream) {
  if (n <= 0) return 0;
  const int per_lane = (d / 4 + 31) / 32;
  const bool vec = d % 4 == 0 && repro::aligned(x, 16) &&
                   repro::aligned(scale, 16) && repro::aligned(out, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && per_lane > kMaxVec && d <= kStageMaxD) {
    const int fit = kSmemMax / (4 * d) - 1;   // warps' rows beside the scale
    const int warps = fit < kRows ? fit : kRows;
    const cudaError_t err = allow_staged_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    rmsnorm_kernel<kStaged><<<(n + warps - 1) / warps, 32 * warps,
                              4 * static_cast<size_t>(d) * (warps + 1), s>>>(
        x, scale, out, n, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((n + kRows - 1) / kRows);
#define REPRO_LAUNCH(VEC) rmsnorm_kernel<VEC><<<grid, kThreads, 0, s>>>(x, scale, out, n, d, eps)
  if (!vec || per_lane > kMaxVec) REPRO_LAUNCH(kStrided);
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
