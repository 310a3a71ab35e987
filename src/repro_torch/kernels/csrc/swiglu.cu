// Fused SwiGLU for Hopper: out = silu(x @ wg) * (x @ wi), fp32 accumulation.
//
// Replaces: repro/kernels/swiglu.py `_swiglu_kernel` (pallas_call in
// `swiglu`).  The TPU kernel runs both products of a [256, 512] output tile
// on the MXU with the whole d_model contraction resident in VMEM.
//
// Two paths, picked from the row count N by `swiglu_f32`:
//
// Rows (N < kTileMinRows, decode).  The call must read all of wg and wi
// once, 2 * D * F * 4 bytes (209.7 MB for gemma3-4b), against 4 * N * D * F
// FLOPs, ~2 FLOP per weight byte: far below the ~20 FLOP/byte where fp32
// CUDA cores would take over.  So it is bound by device-memory bytes, and
// tensor cores would not help.
// Design: each block owns a tile of kTileF output columns for a tile of ROWS
// rows.  Its 256 threads are 8 column groups (4 adjacent columns each, read
// as one float4) x 32 k-groups that split the D contraction.  x is staged in
// shared memory in chunks of kChunk columns; wg/wi rows are read coalesced
// along F (each warp reads 4 rows x 128 contiguous bytes of each matrix) and
// every weight element is read exactly once per row tile.  Gate and up sums
// live in fp32 registers; the k-groups are reduced by warp shuffles and then
// through shared memory, and silu * mul is applied in the epilogue.  ROWS is
// picked from N (1, 2, 4 or 8) so decode keeps few registers and many blocks
// in flight.
//
// Tiles (N >= kTileMinRows, prefill).  At N rows the call does 1.5 N TF32
// FLOP (in 3xTF32, below) per weight byte: bound by bytes up to N ~ 64 at
// mma.sync's ~321 TFLOP/s (N ~ 100 at the data sheet's 495) and by the
// tensor cores above.  The row path re-read both weight matrices
// once per 8 rows (512 times at N = 4096), 4.2x slower than PyTorch's two
// products there; this path reads each weight element once per row tile of
// up to 128 rows and runs the products on the tensor cores.
// Numerics: 3xTF32 on mma.sync.m16n8k8 (csrc/tf32_mma.cuh): each product is
// lo*hi + hi*lo + hi*hi of the operands' TF32 parts, fp32 to ~1e-6
// relative; plain TF32 keeps 11 bits and would break the 2e-5 tolerance at
// D = 2560, and the global TF32 flags stay off.  The tensor core truncates
// as it accumulates, so a chain over all of D (3 x 320 products at D =
// 2560) would drift toward zero by ~1e-4 relative: every 8-wide k-step's
// three products start from a zero accumulator, and the step joins the
// running sum by an fp32 add (rounded to nearest), as the CUDA cores sum.
// (Chained over all of D the outputs missed the tolerance on the card by
// ~2x; the sums from zero cost ~12% of the time at N = 4096.)
// Design: a block of 8 warps owns BM rows x BN columns of BOTH products, so
// an x tile feeds the gate and the up accumulators.  It walks D in chunks
// of kK = 32 through a kStages-deep cp.async ring in shared memory (x tile,
// wg tile, wi tile; 16-byte copies, 4-byte x copies where D % 4 != 0, zero
// fill past N, D and F).  Rows are padded (x: kK + 4, weights: BN + 8
// floats) so every fragment load is free of bank conflicts.  A warp owns
// 16 MT rows x 8 NT columns of each product; each fragment is loaded from
// shared memory and split in hi and lo once per k-step and feeds all the
// warp's products with it.  silu * mul is applied in registers, and only
// [N, F] is written.  Blocks are numbered row tile fastest, so the blocks
// sharing a column tile run together and the repeats of its weights come
// from L2.  m16 tiles and warps wholly past N skip their products.
// Row tiles by N: 16, 32 and 64 rows (64 columns) where bytes bound the
// call: one row tile, each weight read once, 160 blocks at F = 10240; 64 x
// 64 tiles go on above 64 rows until 128 x 128 tiles give two waves of
// blocks (1 block an SM: 255 registers, 160 KB of ring).  D is never split
// across blocks and the k-order never depends on N or the tile: a row's
// output has the same bits in every call that takes this path.
// Measured times, the threshold and the rejected variants: PERF.md.
//
// Backward (`swiglu_bwd_gate_f32`).  Replaces no TPU kernel: the Pallas
// `swiglu` has no VJP, and the JAX package trains through autodiff of
// `ref.swiglu`.  The gradient's four large products (dx against wg and wi,
// dwg, dwi) are plain fp32 GEMMs outside any kernel, as XLA runs them there
// (kernels/swiglu.py); what the Pallas kernel computed in its own body, the
// products x@wg and x@wi, is recomputed here on the same tile kernel, with
// a second epilogue (`GateGrad`) that reads dh and writes dg = dh u
// sigma(g) (1 + g (1 - sigma(g))) (torch's `silu_backward` form, which
// keeps its value at large |g|) and du = dh silu(g), [N, F] each, in place
// of silu(g) u.  The epilogue is a template parameter: the forward's
// instances (`SiluMul`) keep their code and bits.  The backward takes the
// tiles at every N (N <= 8 too), so from 9 rows its g and u are bitwise
// the forward's (the same tile for the same N).  Bound: the recompute's
// 4 N D F operations in 3xTF32 beside 8 N F bytes more of dh, dg and du.
#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"
#include "tf32_mma.cuh"

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

// ------------------------------------------------------------ tile path --

constexpr int kTileMinRows = 9;    // N from which swiglu_f32 takes the tiles
constexpr int kTileThreads = 256;  // 8 warps
constexpr int kK = 32;             // D columns per ring stage

// A block of (WM x WN) warps, each owning MT m16 tiles x NT n8 tiles of
// both products, with a STAGES-deep cp.async ring; MIN_BLOCKS per SM.
template <int MT_, int WM_, int NT_, int WN_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int MT = MT_, WM = WM_, NT = NT_, WN = WN_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static constexpr int LDX = kK + 4;    // x tile row stride (floats)
  static constexpr int LDW = BN + 8;    // weight tile row stride (floats)
  static constexpr int STAGE = BM * LDX + 2 * kK * LDW;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
  static_assert(WM * WN * 32 == kTileThreads, "8 warps");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "shared memory");
};

using Tile16 = Tile<1, 1, 1, 8, 3, 2>;    // 16 x 64
using Tile32 = Tile<1, 2, 2, 4, 3, 2>;    // 32 x 64
using Tile64 = Tile<2, 2, 2, 4, 3, 2>;    // 64 x 64
using Tile128 = Tile<4, 2, 4, 4, 3, 1>;   // 128 x 128

// The tile kernel's epilogues, called for each pair of adjacent columns
// (idx = row * f + col, col even) with their gate and up sums.
// The forward: out = silu(g) * u.
struct SiluMul {
  float* out;
  __device__ __forceinline__ void operator()(size_t idx, float g0, float g1,
                                             float u0, float u1) const {
    float2 o;
    o.x = g0 / (1.f + expf(-g0)) * u0;
    o.y = g1 / (1.f + expf(-g1)) * u1;
    *reinterpret_cast<float2*>(out + idx) = o;
  }
};

// The backward's gate: reads dh, writes dg and du (see the top).
struct GateGrad {
  const float* __restrict__ dh;
  float* __restrict__ dg;
  float* __restrict__ du;
  static __device__ __forceinline__ void one(float h, float g, float u,
                                             float& dgo, float& duo) {
    const float e = 1.f + expf(-g);
    const float s = 1.f / e;
    dgo = h * u * s * (1.f + g * (1.f - s));
    duo = h * (g / e);
  }
  __device__ __forceinline__ void operator()(size_t idx, float g0, float g1,
                                             float u0, float u1) const {
    const float2 h = *reinterpret_cast<const float2*>(dh + idx);
    float2 a, b;
    one(h.x, g0, u0, a.x, b.x);
    one(h.y, g1, u1, a.y, b.y);
    *reinterpret_cast<float2*>(dg + idx) = a;
    *reinterpret_cast<float2*>(du + idx) = b;
  }
};

// Tag: every m16 tile of the warp lies before N (no per-tile test).
template <bool B>
struct Full {
  static constexpr bool value = B;
};

template <class T, class Epi>
__global__ void __launch_bounds__(kTileThreads, T::MIN_BLOCKS)
swiglu_tile_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                   const float* __restrict__ wi, Epi epi, int n, int d, int f,
                   int x_vec) {
  using repro::cp_async16;
  using repro::cp_async4;
  constexpr int MT = T::MT, NT = T::NT, BM = T::BM, BN = T::BN;
  constexpr int LDX = T::LDX, LDW = T::LDW, kStages = T::STAGES;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int tiles_m = (n + BM - 1) / BM;
  const int row0 = static_cast<int>(blockIdx.x % tiles_m) * BM;
  const int col0 = static_cast<int>(blockIdx.x / tiles_m) * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / T::WN) * 16 * MT;   // the warp's rows in the tile
  const int wcol = (warp % T::WN) * 8 * NT;    // and its columns
  // m16 tiles of this warp that hold a row before N (warp-uniform)
  const int mt_act = min(MT, max(0, (n - row0 - wrow + 15) / 16));
  const int nk = (d + kK - 1) / kK;

  // chunk `kc` of D into ring slot kc % kStages; one commit group each,
  // empty past the end
  auto load_stage = [&](int kc) {
    if (kc < nk) {
      float* xs = smem + (kc % kStages) * T::STAGE;
      float* gs = xs + BM * LDX;
      float* us = gs + kK * LDW;
      const int k0 = kc * kK;
      if (x_vec) {
        for (int i = tid; i < BM * kK / 4; i += kTileThreads) {
          const int r = i / (kK / 4), c = i % (kK / 4) * 4;
          const bool ok = row0 + r < n && k0 + c < d;
          cp_async16(xs + r * LDX + c,
                     ok ? x + static_cast<size_t>(row0 + r) * d + k0 + c : x, ok);
        }
      } else {
        for (int i = tid; i < BM * kK; i += kTileThreads) {
          const int r = i / kK, c = i % kK;
          const bool ok = row0 + r < n && k0 + c < d;
          cp_async4(xs + r * LDX + c,
                    ok ? x + static_cast<size_t>(row0 + r) * d + k0 + c : x, ok);
        }
      }
      for (int i = tid; i < kK * BN / 4; i += kTileThreads) {
        const int r = i / (BN / 4), c = i % (BN / 4) * 4;
        const bool ok = k0 + r < d && col0 + c < f;
        const size_t off = ok ? static_cast<size_t>(k0 + r) * f + col0 + c : 0;
        cp_async16(gs + r * LDW + c, wg + off, ok);
        cp_async16(us + r * LDW + c, wi + off, ok);
      }
    }
    repro::cp_commit();
  };

  float cg[MT][NT][4], cu[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cg[i][j][e] = cu[i][j][e] = 0.f;

  // the products of one ring slot: kK / 8 k-steps, each step's three TF32
  // products from zero, then an fp32 add into the running sums
  auto chunk = [&](auto full, const float* xs) {
    constexpr bool FULL = decltype(full)::value;
    const float* gs = xs + BM * LDX;
    const float* us = gs + kK * LDW;
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      repro::FragA a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (FULL || i < mt_act) {
          const float* ap = xs + (wrow + 16 * i + g) * LDX + 8 * ks + t;
          a[i] = repro::frag_a(ap[0], ap[8 * LDX], ap[4], ap[8 * LDX + 4]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int bo = (8 * ks + t) * LDW + wcol + 8 * j + g;
        const repro::FragB bg = repro::frag_b(gs[bo], gs[bo + 4 * LDW]);
        const repro::FragB bu = repro::frag_b(us[bo], us[bo + 4 * LDW]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (FULL || i < mt_act) {
            float p[4];
            repro::mma3_zero(p, a[i], bg);
#pragma unroll
            for (int e = 0; e < 4; ++e) cg[i][j][e] += p[e];
            repro::mma3_zero(p, a[i], bu);
#pragma unroll
            for (int e = 0; e < 4; ++e) cu[i][j][e] += p[e];
          }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_stage(s);
  for (int kc = 0; kc < nk; ++kc) {
    repro::cp_wait<kStages - 2>();   // chunk kc has landed (this thread's)
    __syncthreads();                  // ... every thread's; slot kc-1 is free
    load_stage(kc + kStages - 1);
    const float* xs = smem + (kc % kStages) * T::STAGE;
    if (mt_act == MT)
      chunk(Full<true>{}, xs);
    else if (mt_act > 0)
      chunk(Full<false>{}, xs);
  }
  repro::cp_wait<0>();

  // epilogue: rows g and g + 8, columns 2t and 2t + 1 of each tile
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + wcol + 8 * j + 2 * t;   // f % 4 == 0: col + 1 < f too
      if (col >= f) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wrow + 16 * i + g + 8 * h;
        if (row >= n) continue;
        epi(static_cast<size_t>(row) * f + col, cg[i][j][2 * h],
            cg[i][j][2 * h + 1], cu[i][j][2 * h], cu[i][j][2 * h + 1]);
      }
    }
}

template <class T, class Epi>
int launch_tile(const float* x, const float* wg, const float* wi, Epi epi,
                int n, int d, int f, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((n + T::BM - 1) / T::BM) *
                           ((f + T::BN - 1) / T::BN);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_tile_kernel<T, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // x's rows start 16-byte aligned (the wrapper checks the base) iff D % 4 == 0
  swiglu_tile_kernel<T, Epi><<<static_cast<unsigned>(blocks), kTileThreads,
                               T::SMEM, stream>>>(x, wg, wi, epi, n, d, f,
                                                  d % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

// Row tile by N: one tile of 16, 32 or 64 rows while the weights' bytes
// bound the call; 128 x 128 once that tile gives at least two waves of
// blocks over the 132 SMs (64 x 64 tiles until then).
template <class Epi>
int launch_tiles(const float* x, const float* wg, const float* wi, Epi epi,
                 int n, int d, int f, cudaStream_t s) {
  if (n <= 16) return launch_tile<Tile16>(x, wg, wi, epi, n, d, f, s);
  if (n <= 32) return launch_tile<Tile32>(x, wg, wi, epi, n, d, f, s);
  const long long big = static_cast<long long>((n + 127) / 128) * ((f + 127) / 128);
  if (n <= 64 || big < 2 * 132) return launch_tile<Tile64>(x, wg, wi, epi, n, d, f, s);
  return launch_tile<Tile128>(x, wg, wi, epi, n, d, f, s);
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
  if (n < kTileMinRows) return launch<8>(x, wg, wi, out, n, d, f, s);
  return launch_tiles(x, wg, wi, SiluMul{out}, n, d, f, s);
}

// The gate of swiglu's backward: x [n, d], wg/wi [d, f], dh, dg, du [n, f],
// under swiglu_f32's contract; the tile path at every n.  Launches on
// `stream`, allocates nothing; returns the launch's cudaError_t.
extern "C" int swiglu_bwd_gate_f32(const float* x, const float* wg,
                                   const float* wi, const float* dh, float* dg,
                                   float* du, int n, int d, int f, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  return launch_tiles(x, wg, wi, GateGrad{dh, dg, du}, n, d, f,
                      static_cast<cudaStream_t>(stream));
}

// The row count from which `swiglu_f32` takes the tile path.
extern "C" int swiglu_tile_min_rows() { return kTileMinRows; }
