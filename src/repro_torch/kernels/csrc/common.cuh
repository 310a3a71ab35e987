// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// True when `p` is null or `bytes`-aligned: the vector (float4 / char4)
// pass of an elementwise kernel needs every operand aligned.
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Blocks of `threads` for a grid-stride loop over `work` items: enough to
// cover them, at most 16 per SM of the H100's 132.
inline int grid_blocks(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async of 16 bytes from global into shared memory, past L1 (both
// addresses 16-byte aligned); the copies a thread issued complete, as a
// group, at `cp_async_commit` + `cp_async_wait<N>` (N groups may stay in
// flight)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace repro
