// The per-hop requant pass of the re-quantizing int8 ring sync, for Hopper:
// ring_combine_f32 (receive side) and ring_quantize_f32 (send side).
//
// Replaces: repro/kernels/sync_update.py `_ring_combine_kernel` (pallas_call
// in `ring_combine`) and `_ring_quantize_kernel` (pallas_call in
// `ring_quantize`).  The TPU kernels stream one ring chunk through VMEM in
// 256K-element blocks; the combine writes one partial amax per block and the
// wrapper folds them with a max.
//
// ring_combine: acc = (k * q * s/127 + x) / (k + 1) from int8 codes q, the
// sender's scale s (a device scalar) and this worker's f32 chunk x; it
// writes acc and folds max|acc| into a device scalar.  ring_quantize: int8
// codes clip(rint(acc / s * 127), -127, 127) under a device scalar s.
//
// Bound on this card: combine reads 1 + 4 bytes and writes 4 per element,
// quantize reads 4 and writes 1, against a handful of FLOPs: device-memory
// bytes.  At ViT-B's ring chunk (C = 86,332,648 / 4 = 21,583,162 elements)
// that is 194 MB, 0.058 ms, and 108 MB, 0.032 ms, at 3.35 TB/s.
// Design: one grid-stride pass each, 4 elements per thread per iteration
// (char4 / float4) when every operand is aligned for it, a scalar pass
// otherwise: a ring chunk is a slice of the bucket's delta at an offset of
// c * C elements, which need not be 16-byte aligned.  The scale never leaves
// the device (no host sync inside the ring's 28 hops).  The amax is exact in
// any order: the bit patterns of non-negative floats order as the floats do,
// so each block reduces |acc|'s bits with __reduce_max_sync and folds them
// into the output with one atomicMax (a NaN's bits exceed +inf's, so a NaN
// propagates as torch.max's does).  Every op is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn), so nvcc contracts nothing into an
// FMA, and codes round with rintf (half to even, like torch.round): both
// kernels are bitwise their plain versions (repro_torch/kernels/ref.py).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float combine_one(signed char q, float x, float deq_scale,
                                             float kf, float k1) {
  const float deq = __fmul_rn(static_cast<float>(q), deq_scale);
  return __fdiv_rn(__fadd_rn(__fmul_rn(kf, deq), x), k1);
}

__device__ __forceinline__ unsigned int abs_bits(float a) {
  return __float_as_uint(fabsf(a));
}

__global__ void __launch_bounds__(kThreads)
ring_combine_kernel(const signed char* __restrict__ q, const float* __restrict__ s,
                    const float* __restrict__ x, float* __restrict__ acc,
                    unsigned int* __restrict__ amax, long long n, long long n4, int k) {
  const float deq_scale = __fdiv_rn(__ldg(s), 127.f);
  const float kf = static_cast<float>(k), k1 = static_cast<float>(k + 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned int m = 0u;
  for (long long i = t0; i < n4; i += stride) {
    const char4 qq = reinterpret_cast<const char4*>(q)[i];
    const float4 xx = reinterpret_cast<const float4*>(x)[i];
    float4 a;
    a.x = combine_one(static_cast<signed char>(qq.x), xx.x, deq_scale, kf, k1);
    a.y = combine_one(static_cast<signed char>(qq.y), xx.y, deq_scale, kf, k1);
    a.z = combine_one(static_cast<signed char>(qq.z), xx.z, deq_scale, kf, k1);
    a.w = combine_one(static_cast<signed char>(qq.w), xx.w, deq_scale, kf, k1);
    reinterpret_cast<float4*>(acc)[i] = a;
    m = max(max(m, abs_bits(a.x)), max(abs_bits(a.y), max(abs_bits(a.z), abs_bits(a.w))));
  }
  for (long long i = n4 * 4 + t0; i < n; i += stride) {
    const float a = combine_one(q[i], x[i], deq_scale, kf, k1);
    acc[i] = a;
    m = max(m, abs_bits(a));
  }
  __shared__ unsigned int warp_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0 && m != 0u) atomicMax(amax, m);
  }
}

__device__ __forceinline__ signed char quantize_one(float a, float s) {
  const float c = fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(a, s), 127.f)), -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(c));
}

__global__ void __launch_bounds__(kThreads)
ring_quantize_kernel(const float* __restrict__ acc, const float* __restrict__ s,
                     signed char* __restrict__ q, long long n, long long n4) {
  const float sc = __ldg(s);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = t0; i < n4; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(acc)[i];
    char4 c;
    c.x = quantize_one(a.x, sc);
    c.y = quantize_one(a.y, sc);
    c.z = quantize_one(a.z, sc);
    c.w = quantize_one(a.w, sc);
    reinterpret_cast<char4*>(q)[i] = c;
  }
  for (long long i = n4 * 4 + t0; i < n; i += stride) q[i] = quantize_one(acc[i], sc);
}

}  // namespace

// q [n] int8, s a device f32 scalar (> 0), x [n] f32: contiguous.  Writes
// acc [n] f32 and folds max|acc| into *amax, which the caller zeroes first
// (its bits are read as an unsigned int).  k >= 1 contributors so far.
// Allocates nothing; returns the launch's cudaError_t.
extern "C" int ring_combine_f32(const signed char* q, const float* s, const float* x,
                                float* acc, float* amax, long long n, int k,
                                void* stream) {
  if (n <= 0) return 0;
  const bool vec = repro::aligned(q, 4) && repro::aligned(x, 16) && repro::aligned(acc, 16);
  const long long n4 = vec ? n / 4 : 0;
  ring_combine_kernel<<<repro::grid_blocks(vec ? n4 : n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, s, x, acc, reinterpret_cast<unsigned int*>(amax), n, n4, k);
  return static_cast<int>(cudaGetLastError());
}

// acc [n] f32, s a device f32 scalar (> 0): contiguous.  Writes q [n] int8.
// Allocates nothing; returns the launch's cudaError_t.
extern "C" int ring_quantize_f32(const float* acc, const float* s, signed char* q,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = repro::aligned(acc, 16) && repro::aligned(q, 4);
  const long long n4 = vec ? n / 4 : 0;
  ring_quantize_kernel<<<repro::grid_blocks(vec ? n4 : n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, s, q, n, n4);
  return static_cast<int>(cudaGetLastError());
}
