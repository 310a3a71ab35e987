// Fused SwiGLU for Hopper: out = silu(x @ wg) * (x @ wi), fp32 accumulation.
//
// Replaces: repro/kernels/swiglu.py `_swiglu_kernel` (pallas_call in
// `swiglu`).  The TPU kernel runs both products of a [256, 512] output tile
// on the MXU with the whole d_model contraction resident in VMEM.
//
// Bound on this card: at decode (N = slots <= 8 rows) the call must read all
// of wg and wi once — 2 * D * F * 4 bytes, 209.7 MB for gemma3-4b — against
// 4 * N * D * F FLOPs, ~2 FLOP per weight byte: far below the ~20 FLOP/byte
// where fp32 CUDA cores would take over.  So it is bound by device-memory
// bytes, and tensor cores would not help.
// Design: each block owns a tile of kTileF output columns for a tile of ROWS
// rows.  Its 256 threads are 8 column groups (4 adjacent columns each, read
// as one float4) x 32 k-groups that split the D contraction.  x is staged in
// shared memory in chunks of kChunk columns; wg/wi rows are read coalesced
// along F (each warp reads 4 rows x 128 contiguous bytes of each matrix) and
// every weight element is read exactly once per row tile.  Gate and up sums
// live in fp32 registers; the k-groups are reduced by warp shuffles and then
// through shared memory, and silu * mul is applied in the epilogue.  ROWS is
// picked from N (1, 2, 4 or 8) so decode keeps few registers and many blocks
// in flight.  For N in the hundreds (the training slice) the kernel stays
// right but re-reads the weights once per 8-row tile; a wgmma tile is the
// later fix.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                       // columns per thread (float4)
constexpr int kTileF = 32;                     // output columns per block
constexpr int kColGroups = kTileF / kCols;     // 8
constexpr int kKGroups = kThreads / kColGroups;  // 32
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                    // x columns staged per pass

__device__ __forceinline__ void fma4(float (&acc)[kCols], float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const float* __restrict__ x, const float* __restrict__ wg,
              const float* __restrict__ wi, float* __restrict__ out, int n,
              int d, int f) {
  __shared__ float xs[ROWS][kChunk];
  __shared__ float red[2][kWarps][ROWS][kTileF];

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kg = tid / kColGroups;
  const int col = blockIdx.x * kTileF + cg * kCols;
  const int row0 = blockIdx.y * ROWS;

  float ag[ROWS][kCols], au[ROWS][kCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) ag[r][c] = au[r][c] = 0.f;

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    __syncthreads();
    for (int i = tid; i < ROWS * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      xs[r][k] = (row0 + r < n && c0 + k < d)
                     ? x[static_cast<size_t>(row0 + r) * d + c0 + k]
                     : 0.f;
    }
    __syncthreads();
    const int kend = min(kChunk, d - c0);
    if (col < f) {
#pragma unroll 4
      for (int k = kg; k < kend; k += kKGroups) {
        const size_t off = static_cast<size_t>(c0 + k) * f + col;
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(wg + off));
        const float4 u4 = __ldg(reinterpret_cast<const float4*>(wi + off));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = xs[r][k];
          fma4(ag[r], xv, g4);
          fma4(au[r], xv, u4);
        }
      }
    }
  }

  // Reduce the 32 k-groups: the 4 inside a warp (lanes 8 apart) by shuffles,
  // then the 8 warps through shared memory.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float gs = ag[r][c], us = au[r][c];
      gs += __shfl_xor_sync(0xffffffffu, gs, 8);
      gs += __shfl_xor_sync(0xffffffffu, gs, 16);
      us += __shfl_xor_sync(0xffffffffu, us, 8);
      us += __shfl_xor_sync(0xffffffffu, us, 16);
      if (lane < kColGroups) {
        red[0][warp][r][cg * kCols + c] = gs;
        red[1][warp][r][cg * kCols + c] = us;
      }
    }
  __syncthreads();
  for (int i = tid; i < ROWS * kTileF; i += kThreads) {
    const int r = i / kTileF, c = i % kTileF;
    const int row = row0 + r, cc = blockIdx.x * kTileF + c;
    if (row >= n || cc >= f) continue;
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      gs += red[0][w][r][c];
      us += red[1][w][r][c];
    }
    const float silu = gs / (1.f + expf(-gs));
    out[static_cast<size_t>(row) * f + cc] = silu * us;
  }
}

template <int ROWS>
int launch(const float* x, const float* wg, const float* wi, float* out,
           int n, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kTileF - 1) / kTileF, (n + ROWS - 1) / ROWS);
  swiglu_kernel<ROWS><<<grid, kThreads, 0, stream>>>(x, wg, wi, out, n, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, d], wg/wi [d, f], out [n, f]: row-major fp32, f % 4 == 0 and every
// pointer 16-byte aligned (the wrapper checks).  Launches on `stream`,
// allocates nothing; returns the launch's cudaError_t.
extern "C" int swiglu_f32(const float* x, const float* wg, const float* wi,
                          float* out, int n, int d, int f, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 1) return launch<1>(x, wg, wi, out, n, d, f, s);
  if (n <= 2) return launch<2>(x, wg, wi, out, n, d, f, s);
  if (n <= 4) return launch<4>(x, wg, wi, out, n, d, f, s);
  return launch<8>(x, wg, wi, out, n, d, f, s);
}
