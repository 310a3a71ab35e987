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
//
// Design: ONE cooperative launch of a persistent grid.  The grid is every
// block that can be resident at once (cudaOccupancyMaxActiveBlocksPerMulti-
// processor at the block's shared memory, times the device's SM count), at
// most one block per `warps` rows, so it depends on the card's SM count.
// One warp per row, up to kWarps warps a block (as many as shared memory
// holds); warp w of block b takes rows b warps + w + k (blocks warps), k =
// 0, 1, ...: a fixed rule from n.
//  * Register path (d % 4 == 0, every operand 16-byte aligned, d <= 32 * 4 *
//    kMaxVec = 3072): a lane starts the loads of all its VEC float4s of x and
//    dy at once and keeps them in registers.
//  * Staged path (the same, 3072 < d <= kStageMaxD = 19,370: phi3's 5120,
//    qwen's 8192): a lane starts cp.async copies of all its float4s of x and
//    dy into the warp's rows of shared memory at once (the whole row in
//    flight), then both passes read them there: 12 d bytes of shared memory
//    a warp with its dscale row, so 3 warps a block at d = 5120, 2 at 8192.
//  * Scalar path (d % 4 != 0, an operand not aligned, or d > kStageMaxD,
//    wider than any model's norm): 4-byte strided loops.
// Every path sums a lane's elements 4 (lane + 32 c) + k, c then k ascending,
// then one xor-butterfly (the forward's order, csrc/rmsnorm.cu), and writes
// dx = r (dy scale) - x c3 with the same expressions, so r is bitwise the
// forward's and dx bitwise the two-launch kernel's this one replaced.
// dscale, a sum over rows, takes no floating-point atomics: each warp keeps
// its rows' dy x r in its own row of shared memory (a lane owns the same
// columns in every row; the first row stores, the next ones add), the block
// adds the rows of its warps that took a row, in warp order, into one
// partial row of a [blocks, d] scratch, and after one grid barrier
// (cooperative_groups::this_grid().sync()) block b sums column stripes b, b
// + blocks, ... of kRedCols columns over the partial rows: group g of the
// block's threads adds rows g, g + G, ... in order (kRedBatch loads in
// flight), then the G groups are added in order.  The grid depends on n, d
// and the card alone: a second call on the same inputs gives the same bits.
// The caller sizes the grid once (`rmsnorm_bwd_grid`, which also sets the
// instance's shared memory limit) and passes it to the launch.  A
// cooperative launch that does not fit returns its error; there is no other
// launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;                  // rows (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVec = 24;                // float4s per lane held in registers
constexpr int kSmemMax = 232448;           // shared memory a block can use
// the widest row staged in shared memory (x, dy and the dscale row: 12 d
// bytes a warp); wider rows take the scalar path
constexpr int kStageMaxD = kSmemMax / 12;
constexpr int kRedCols = 8;                // the reduce: columns a stripe (32 B)
constexpr int kRedBatch = 16;              // ... partial rows loaded at once
constexpr int kRedStripes = 4;             // ... stripes of a block at once

// the paths (template VEC > 0: registers, VEC float4s a lane)
constexpr int kScalar = -1, kStaged = -2;

// The staged path: cp.async copies of a lane's float4s of row `row` of x
// and dy into the staging rows xs4, xs4 + d4 (the whole row in flight).
__device__ __forceinline__ void stage_row(const float* x, const float* dy,
                                          int row, int d, float4* xs4,
                                          int lane) {
  const int d4 = d >> 2;
  const size_t off = static_cast<size_t>(row) * d;
  const float4* x4 = reinterpret_cast<const float4*>(x + off);
  const float4* g4 = reinterpret_cast<const float4*>(dy + off);
  for (int i = lane; i < d4; i += 32) {
    repro::cp_async16(xs4 + i, x4 + i);
    repro::cp_async16(xs4 + d4 + i, g4 + i);
  }
}

// dscale's second stage: block b sums column stripes b, b + gridDim.x, ...
// (kRedStripes of them at once, every load in flight) over the `rows`
// partial rows, written by other blocks before the barrier (so read through
// L2, not the non-coherent path); `red` holds kRedStripes * blockDim.x
// floats of shared memory.
__device__ void reduce_stripes(const float* partial, float* __restrict__ dscale,
                               int rows, int d, float* red) {
  const int groups = blockDim.x / kRedCols;
  const int c = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int stripes = (d + kRedCols - 1) / kRedCols;
  for (int st0 = blockIdx.x; st0 < stripes; st0 += kRedStripes * gridDim.x) {
    float s[kRedStripes];
#pragma unroll
    for (int j = 0; j < kRedStripes; ++j) s[j] = 0.f;
    for (int b0 = grp; b0 < rows; b0 += groups * kRedBatch) {
      float v[kRedStripes][kRedBatch];
#pragma unroll
      for (int j = 0; j < kRedStripes; ++j) {
        const int col = (st0 + j * gridDim.x) * kRedCols + c;
#pragma unroll
        for (int k = 0; k < kRedBatch; ++k) {
          const int b = b0 + k * groups;
          v[j][k] = b < rows && col < d
                        ? __ldcg(partial + static_cast<size_t>(b) * d + col)
                        : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kRedStripes; ++j)
#pragma unroll
        for (int k = 0; k < kRedBatch; ++k) s[j] += v[j][k];
    }
#pragma unroll
    for (int j = 0; j < kRedStripes; ++j) red[j * blockDim.x + threadIdx.x] = s[j];
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < kRedStripes; ++j) {
        const int col = (st0 + j * gridDim.x) * kRedCols + c;
        if (col < d) {
          const float* rj = red + j * blockDim.x;
          float t = rj[c];
          for (int k = 1; k < groups; ++k) t += rj[k * kRedCols + c];
          dscale[col] = t;
        }
      }
    }
    __syncthreads();
  }
}

// VEC > 0: the register path; kStaged: rows staged in shared memory;
// kScalar.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ dscale, float* partial, int n, int d,
                   float eps) {
  extern __shared__ float4 smem4[];
  float* const acc = reinterpret_cast<float*>(smem4);   // [warps][d]: dscale
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const wacc = acc + static_cast<size_t>(warp) * d;
  float4* const w4 = reinterpret_cast<float4*>(wacc);
  const int d4 = d >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  bool first = true;
  for (int row = blockIdx.x * warps + warp; row < n;
       row += gridDim.x * warps, first = false) {
    const size_t off = static_cast<size_t>(row) * d;
    const float* xr = x + off;
    const float* gr = dy + off;
    float* dxr = dx + off;
    float ss = 0.f, dot = 0.f;
    if constexpr (VEC > 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* g4 = reinterpret_cast<const float4*>(gr);
      float4 xv[VEC], gv[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const int i = lane + 32 * c;
        const bool ok = i < d4;
        xv[c] = ok ? __ldg(x4 + i) : zero;
        gv[c] = ok ? __ldg(g4 + i) : zero;
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
          float4 a = make_float4(gc.x * xc.x * r, gc.y * xc.y * r,
                                 gc.z * xc.z * r, gc.w * xc.w * r);
          if (!first) {
            const float4 o = w4[i];
            a = make_float4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
          }
          w4[i] = a;
        }
      }
    } else if constexpr (VEC == kStaged) {
      // the whole row in flight at once, into the warp's [x | dy] staging
      // rows after the block's dscale rows; a lane reads back only what it
      // copied itself
      float4* const xs4 = reinterpret_cast<float4*>(
          acc + static_cast<size_t>(warps) * d + static_cast<size_t>(warp) * 2 * d);
      const float4* const gs4 = xs4 + d4;
      stage_row(x, dy, row, d, xs4, lane);
      repro::cp_async_commit();
      repro::cp_async_wait<0>();
#pragma unroll 4
      for (int i = lane; i < d4; i += 32) {   // the forward's order
        const float4 xv = xs4[i], gv = gs4[i], s = __ldg(s4 + i);
        ss = fmaf(xv.x, xv.x, ss);
        ss = fmaf(xv.y, xv.y, ss);
        ss = fmaf(xv.z, xv.z, ss);
        ss = fmaf(xv.w, xv.w, ss);
        dot = fmaf(gv.x * s.x, xv.x, dot);
        dot = fmaf(gv.y * s.y, xv.y, dot);
        dot = fmaf(gv.z * s.z, xv.z, dot);
        dot = fmaf(gv.w * s.w, xv.w, dot);
      }
      ss = repro::warp_sum(ss);
      dot = repro::warp_sum(dot);
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      const float c3 = r * r * r * (dot / static_cast<float>(d));
      float4* o4 = reinterpret_cast<float4*>(dxr);
#pragma unroll 4
      for (int i = lane; i < d4; i += 32) {
        const float4 s = __ldg(s4 + i);
        const float4 xc = xs4[i], gc = gs4[i];
        o4[i] = make_float4(r * (gc.x * s.x) - xc.x * c3,
                            r * (gc.y * s.y) - xc.y * c3,
                            r * (gc.z * s.z) - xc.z * c3,
                            r * (gc.w * s.w) - xc.w * c3);
        float4 a = make_float4(gc.x * xc.x * r, gc.y * xc.y * r,
                               gc.z * xc.z * r, gc.w * xc.w * r);
        if (!first) {
          const float4 o = w4[i];
          a = make_float4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
        }
        w4[i] = a;
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
            const float a = g * v * r;
            wacc[i0 + e] = first ? a : wacc[i0 + e] + a;
          }
    }
  }

  // the block's partial row: the rows of its warps that took a row (every
  // block's warp 0 did), added in warp order
  __syncthreads();
  const int live = min(warps, n - static_cast<int>(blockIdx.x) * warps);
  if constexpr (VEC != kScalar) {
    const float4* a4 = reinterpret_cast<const float4*>(acc);
    float4* p4 = reinterpret_cast<float4*>(partial) +
                 static_cast<size_t>(blockIdx.x) * d4;
    for (int c = threadIdx.x; c < d4; c += blockDim.x) {
      float4 s = a4[c];
      for (int w = 1; w < live; ++w) {
        const float4 o = a4[static_cast<size_t>(w) * d4 + c];
        s = make_float4(s.x + o.x, s.y + o.y, s.z + o.z, s.w + o.w);
      }
      p4[c] = s;
    }
  } else {
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float s = acc[col];
      for (int w = 1; w < live; ++w) s += acc[static_cast<size_t>(w) * d + col];
      partial[static_cast<size_t>(blockIdx.x) * d + col] = s;
    }
  }
  cg::this_grid().sync();     // also a block barrier: acc is free again
  reduce_stripes(partial, dscale, gridDim.x, d, acc);
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        float*, float*, int, int, float);

// A launch's instance, warps a block and dynamic shared memory: the
// warps' dscale rows (at least kRedStripes floats a thread for the reduce)
// and, staged, their x and dy rows; kWarps warps, fewer where they would
// not fit (0: d too wide for one warp).
struct Plan {
  Kernel kern;
  int warps;
  size_t smem;
};

// The plan for (d, vec): vec says d % 4 == 0 and every operand aligned.
Plan plan(int d, bool vec) {
  const int per_lane = (d / 4 + 31) / 32;
  const bool staged = vec && per_lane > kMaxVec && d <= kStageMaxD;
  const long long row = 4LL * (staged ? 3 * d : (d < 32 * kRedStripes
                                                     ? 32 * kRedStripes : d));
  const long long fit = kSmemMax / row;
  const int warps = static_cast<int>(fit < kWarps ? fit : kWarps);
  Kernel kern = rmsnorm_bwd_kernel<24>;
  if (staged) kern = rmsnorm_bwd_kernel<kStaged>;
  else if (!vec || per_lane > kMaxVec) kern = rmsnorm_bwd_kernel<kScalar>;
  else if (per_lane <= 1) kern = rmsnorm_bwd_kernel<1>;
  else if (per_lane <= 2) kern = rmsnorm_bwd_kernel<2>;
  else if (per_lane <= 4) kern = rmsnorm_bwd_kernel<4>;
  else if (per_lane <= 8) kern = rmsnorm_bwd_kernel<8>;
  else if (per_lane <= 12) kern = rmsnorm_bwd_kernel<12>;
  else if (per_lane <= 16) kern = rmsnorm_bwd_kernel<16>;
  else if (per_lane <= 20) kern = rmsnorm_bwd_kernel<20>;
  return {kern, warps, static_cast<size_t>(row) * (warps > 0 ? warps : 0)};
}

// Blocks of the plan's cooperative grid at n rows: every block resident at
// once on this device (its shared memory allowed first), at most one a
// `warps` rows, so that every block takes a row.
cudaError_t grid_blocks(const Plan& p, int n, int* blocks) {
  if (p.warps <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      p.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kern,
                                                      32 * p.warps, p.smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const long long want = (static_cast<long long>(n) + p.warps - 1) / p.warps;
  const long long fit = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<int>(want < fit ? want : fit);
  return cudaSuccess;
}

}  // namespace

// The cooperative grid `rmsnorm_bwd_f32` takes for n rows of d floats on
// the current device (vec: d % 4 == 0 and every operand 16-byte aligned),
// into *blocks; the scratch `partial` is [*blocks, d] floats.  Also sets
// the instance's shared memory limit, so it runs first on the launch's
// device.
extern "C" int rmsnorm_bwd_grid(int n, int d, int vec, int* blocks) {
  *blocks = 0;
  if (n <= 0 || d <= 0) return 0;
  return static_cast<int>(grid_blocks(plan(d, vec != 0), n, blocks));
}

// x, dy, dx [n, d] row-major fp32; scale, dscale [d]; partial [blocks, d];
// vec and blocks as `rmsnorm_bwd_grid` gave them (vec with an operand not
// aligned is an error).  One cooperative launch on `stream`, allocates
// nothing; returns the first failing call's cudaError_t.
extern "C" int rmsnorm_bwd_f32(const float* x, const float* scale,
                               const float* dy, float* dx, float* dscale,
                               float* partial, int n, int d, float eps,
                               int vec, int blocks, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (vec && !(d % 4 == 0 && repro::aligned(x, 16) &&
               repro::aligned(scale, 16) && repro::aligned(dy, 16) &&
               repro::aligned(dx, 16) && repro::aligned(partial, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(d, vec != 0);
  if (p.warps <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &scale, &dy, &dx, &dscale, &partial, &n, &d, &eps};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(p.kern), dim3(blocks), dim3(32 * p.warps),
      args, p.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
