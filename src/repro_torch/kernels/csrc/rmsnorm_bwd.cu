// RMSNorm backward for Hopper: the gradients of out = x * r * scale, r =
// rsqrt(mean(x^2) + eps) per row, for the output gradient dy, fp32 inside:
//   dx = r * scale * dy - x * r^3 * mean(dy * scale * x)   (per row)
//   dscale = sum over rows of dy * x * r
//
// Replaces: no TPU kernel.  The Pallas `rms_norm` of repro/kernels/rmsnorm.py
// has no VJP: the JAX package trains through autodiff of `ref.rms_norm`.
// The port's seam has no fallback on the card, so training an RMSNorm model
// there needs this kernel (wrapped as `_RmsNorm` in kernels/rmsnorm.py).
//
// Bound on this card: bytes.  x and dy are read once and dx written once,
// 12 n d bytes (+ 8 d for scale and dscale) against ~10 n d FLOPs.
// Design: the forward's (csrc/rmsnorm.cu): one warp per row, kWarps rows per
// block.  On the register path (VEC float4s a lane, d <= 32 * 4 * kMaxVec,
// d % 4 == 0, every operand 16-byte aligned) a lane issues the loads of all
// its x and dy float4s in one pass, keeps both in registers, sums x^2 in the
// forward's order (so r is bitwise the forward's) and dy * scale * x beside
// it, reduces the warp by one xor-butterfly each, then writes dx.  The
// strided path (VEC = 0) takes every other row: the same sums in the same
// order by a strided loop, then a second pass over the row (from L1 / L2).
// dscale is a sum over rows, taken without floating-point atomics: each
// warp adds its rows' dy * x * r into its own row of shared memory (a lane
// owns the same columns in every row), the block adds its warps' rows in
// warp order into one partial row of a [blocks, d] scratch, and a second
// launch sums the partials over the blocks in a fixed order (8 groups of
// strided blocks, then the groups in order).  Rows go to warps by a fixed
// rule from n, and the grid depends on n and d alone: a second call on the
// same inputs gives the same bits.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                  // rows (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVec = 24;                // float4s per lane held in registers
constexpr int kMaxBlocks = 2 * 132;        // partial rows of dscale: 2 per SM
constexpr int kSmemMax = 232448;           // shared memory a block can use
constexpr int kRedCols = 32;               // the reduce: columns per block
constexpr int kRedGroups = 8;              // ... and groups of partial rows

// Warps per block: kWarps, fewer where kWarps rows of d floats would not fit
// in shared memory (0: d too wide for one row).
int bwd_warps(int d) {
  const long long fit = kSmemMax / (4LL * d);
  return static_cast<int>(fit < kWarps ? fit : kWarps);
}

int bwd_blocks(int n, int d) {
  const int w = bwd_warps(d);
  if (w <= 0) return 0;
  const int want = (n + w - 1) / w;
  return want < kMaxBlocks ? want : kMaxBlocks;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ partial, int n, int d, float eps) {
  extern __shared__ float4 smem4[];
  float* const acc = reinterpret_cast<float*>(smem4);   // [warps][d]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const wacc = acc + static_cast<size_t>(warp) * d;
  const int d4 = d >> 2;

  // the lane's own columns of the warp's row: 4 (lane + 32 c) + k
  if constexpr (VEC > 0) {
    float4* w4 = reinterpret_cast<float4*>(wacc);
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (lane + 32 * c < d4) w4[lane + 32 * c] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i0 = 4 * lane; i0 < d; i0 += 128)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e < d) wacc[i0 + e] = 0.f;
  }

  for (int row = blockIdx.x * warps + warp; row < n; row += gridDim.x * warps) {
    const size_t off = static_cast<size_t>(row) * d;
    const float* xr = x + off;
    const float* gr = dy + off;
    float* dxr = dx + off;
    float ss = 0.f, dot = 0.f;
    if constexpr (VEC > 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* g4 = reinterpret_cast<const float4*>(gr);
      const float4* s4 = reinterpret_cast<const float4*>(scale);
      float4 xv[VEC], gv[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const int i = lane + 32 * c;
        const bool ok = i < d4;
        xv[c] = ok ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        gv[c] = ok ? __ldg(g4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) {     // the forward's order
        ss = fmaf(xv[c].x, xv[c].x, ss);
        ss = fmaf(xv[c].y, xv[c].y, ss);
        ss = fmaf(xv[c].z, xv[c].z, ss);
        ss = fmaf(xv[c].w, xv[c].w, ss);
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const int i = lane + 32 * c;
        if (i < d4) {
          const float4 s = __ldg(s4 + i);
          dot = fmaf(gv[c].x * s.x, xv[c].x, dot);
          dot = fmaf(gv[c].y * s.y, xv[c].y, dot);
          dot = fmaf(gv[c].z * s.z, xv[c].z, dot);
          dot = fmaf(gv[c].w * s.w, xv[c].w, dot);
        }
      }
      ss = repro::warp_sum(ss);
      dot = repro::warp_sum(dot);
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      const float c3 = r * r * r * (dot / static_cast<float>(d));
      float4* o4 = reinterpret_cast<float4*>(dxr);
      float4* w4 = reinterpret_cast<float4*>(wacc);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const int i = lane + 32 * c;
        if (i < d4) {
          const float4 s = __ldg(s4 + i);
          const float4 xc = xv[c], gc = gv[c];
          o4[i] = make_float4(r * (gc.x * s.x) - xc.x * c3,
                              r * (gc.y * s.y) - xc.y * c3,
                              r * (gc.z * s.z) - xc.z * c3,
                              r * (gc.w * s.w) - xc.w * c3);
          float4 a = w4[i];
          a.x += gc.x * xc.x * r;
          a.y += gc.y * xc.y * r;
          a.z += gc.z * xc.z * r;
          a.w += gc.w * xc.w * r;
          w4[i] = a;
        }
      }
    } else {
      for (int i0 = 4 * lane; i0 < d; i0 += 128)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i0 + e < d) {
            const float v = xr[i0 + e];
            ss = fmaf(v, v, ss);
            dot = fmaf(gr[i0 + e] * scale[i0 + e], v, dot);
          }
      ss = repro::warp_sum(ss);
      dot = repro::warp_sum(dot);
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      const float c3 = r * r * r * (dot / static_cast<float>(d));
      for (int i0 = 4 * lane; i0 < d; i0 += 128)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i0 + e < d) {
            const float v = xr[i0 + e], g = gr[i0 + e];
            dxr[i0 + e] = r * (g * scale[i0 + e]) - v * c3;
            wacc[i0 + e] += g * v * r;
          }
    }
  }

  // the block's partial row: its warps' rows added in warp order
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += acc[static_cast<size_t>(w) * d + col];
    partial[static_cast<size_t>(blockIdx.x) * d + col] = s;
  }
}

// dscale[col] = the sum of partial[b][col] over b: group k of 8 adds the
// blocks k, k + 8, ... in order, then the groups are added in order.  A warp
// reads 32 adjacent columns of a partial row (128 bytes).
__global__ void __launch_bounds__(kRedCols * kRedGroups)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ dscale, int blocks, int d) {
  __shared__ float red[kRedGroups][kRedCols];
  const int c = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + c;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int b = grp; b < blocks; b += kRedGroups)
      s += partial[static_cast<size_t>(b) * d + col];
  }
  red[grp][c] = s;
  __syncthreads();
  if (grp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kRedGroups; ++k) t += red[k][c];
    dscale[col] = t;
  }
}

template <int VEC>
cudaError_t launch_bwd(dim3 grid, int threads, size_t smem, cudaStream_t s,
                       const float* x, const float* scale, const float* dy,
                       float* dx, float* partial, int n, int d, float eps) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_kernel<VEC><<<grid, threads, smem, s>>>(x, scale, dy, dx, partial,
                                                      n, d, eps);
  return cudaGetLastError();
}

}  // namespace

// Floats of the [blocks, d] scratch `rmsnorm_bwd_f32` takes as `partial`
// (0 where d is too wide: more than kSmemMax / 4 floats).
extern "C" long long rmsnorm_bwd_scratch_floats(int n, int d) {
  if (n <= 0 || d <= 0) return 0;
  return static_cast<long long>(bwd_blocks(n, d)) * d;
}

// x, dy, dx [n, d] row-major fp32; scale, dscale [d]; partial the scratch
// `rmsnorm_bwd_scratch_floats` sizes.  Two launches on `stream` (the rows,
// then the reduce of dscale), allocates nothing; returns the first failing
// launch's cudaError_t.
extern "C" int rmsnorm_bwd_f32(const float* x, const float* scale,
                               const float* dy, float* dx, float* dscale,
                               float* partial, int n, int d, float eps,
                               void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const int warps = bwd_warps(d);
  if (warps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = bwd_blocks(n, d);
  const size_t smem = sizeof(float) * warps * static_cast<size_t>(d);
  const int per_lane = (d / 4 + 31) / 32;
  const bool vec = d % 4 == 0 && per_lane <= kMaxVec && repro::aligned(x, 16) &&
                   repro::aligned(scale, 16) && repro::aligned(dy, 16) &&
                   repro::aligned(dx, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks);
  const int threads = 32 * warps;
  cudaError_t err;
#define REPRO_LAUNCH(VEC) \
  err = launch_bwd<VEC>(grid, threads, smem, s, x, scale, dy, dx, partial, n, d, eps)
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
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_reduce_kernel<<<(d + kRedCols - 1) / kRedCols,
                              kRedCols * kRedGroups, 0, s>>>(partial, dscale,
                                                             blocks, d);
  return static_cast<int>(cudaGetLastError());
}
