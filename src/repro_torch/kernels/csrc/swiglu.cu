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
// Backward.  Replaces no TPU kernel: the Pallas `swiglu` has no VJP, and
// the JAX package trains through autodiff of `ref.swiglu`, which keeps g =
// x@wg and u = x@wi from its forward and runs four large products.  Under
// autograd the forward (`swiglu_fwd_pair_f32`) writes out as `swiglu_f32`
// does, through the same path and arithmetic (the tiles' third epilogue,
// `SiluMulPair`; the row kernel's SAVE instances below 9 rows), and also the
// pair p = u sigma(g) (1 + g (1 - sigma(g))), q = silu(g), [N, F] each, so
// that the backward's gate is dg = dh p, du = dh q: nothing is recomputed.
// `swiglu_bwd_f32` then runs the four products in two launches on the same
// 3xTF32 tensor-core numerics as the forward: dW ([dwg | dwi] = x^T [dg |
// du], K = N, the forward's shape: one x^T fragment feeds both products)
// and dX (dx = dg wg^T + du wi^T, one sum over K = 2F, two k-steps joined
// in fp32 before each running add: `kDxJoin`).  dg and du are written
// once by a small gate kernel into a [2, N, F] scratch (84 MB at [1024,
// 2560] x [2560, 10240]) that both launches read; formed inside the tiles
// instead, from dh and the pair as each operand fragment is read, they
// skip that round trip but cost the tiles a third ring chunk and two
// shared-memory reads and a multiply an operand element, and the backward
// ran 6% slower (PERF.md; `tools/kernel_variants.py` `sb_gate_in_tiles`).
// Bound: 8 N D F
// operations, 3 x that in TF32 on the tensor cores; the bytes (x, dh, p,
// q, wg, wi read, dx, dwg, dwi written once) are ~0.5 GB at [1024, 2560] x
// [2560, 10240], far below.  No float atomics, and every sum's order is
// fixed by the shape: a second call gives the same bits.
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

// The pair the backward reads (`swiglu_fwd_pair_f32`): p = u sigma(g) (1 +
// g (1 - sigma(g))) (torch's `silu_backward` form, which keeps its value at
// large |g|) and q = silu(g), so that dg = dh p and du = dh q.  q is the
// forward's own silu (the same expression), and out = q u.
__device__ __forceinline__ void silu_pair(float g, float u, float& out,
                                          float& p, float& q) {
  const float e = 1.f + expf(-g);
  q = g / e;
  out = q * u;
  const float s = 1.f / e;
  p = u * s * (1.f + g * (1.f - s));
}

// SAVE: also write the pair (pp, pq [n, f]) beside out.
template <int ROWS, bool SAVE>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const float* __restrict__ x, const float* __restrict__ wg,
              const float* __restrict__ wi, float* __restrict__ out,
              float* __restrict__ pp, float* __restrict__ pq, int n, int d,
              int f) {
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
    const size_t idx = static_cast<size_t>(row) * f + cc;
    if constexpr (SAVE) {
      silu_pair(gs, us, out[idx], pp[idx], pq[idx]);
    } else {
      const float silu = gs / (1.f + expf(-gs));
      out[idx] = silu * us;
    }
  }
}

template <int ROWS, bool SAVE = false>
int launch(const float* x, const float* wg, const float* wi, float* out,
           float* pp, float* pq, int n, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kTileF - 1) / kTileF, (n + ROWS - 1) / ROWS);
  swiglu_kernel<ROWS, SAVE><<<grid, kThreads, 0, stream>>>(x, wg, wi, out, pp,
                                                           pq, n, d, f);
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

// The forward under autograd: out as `SiluMul` writes it, and the pair
// the backward reads (`silu_pair`).
struct SiluMulPair {
  float* __restrict__ out;
  float* __restrict__ p;
  float* __restrict__ q;
  __device__ __forceinline__ void operator()(size_t idx, float g0, float g1,
                                             float u0, float u1) const {
    float2 o, a, b;
    silu_pair(g0, u0, o.x, a.x, b.x);
    silu_pair(g1, u1, o.y, a.y, b.y);
    *reinterpret_cast<float2*>(out + idx) = o;
    *reinterpret_cast<float2*>(p + idx) = a;
    *reinterpret_cast<float2*>(q + idx) = b;
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

// ------------------------------------------------------------- backward --

// The backward's product tiles: WM x WN warps, each owning MT m16 x NT n8
// tiles of the output, one block an SM, a STAGES-deep cp.async ring of
// kK-deep chunks of the contraction.
template <int MT_, int WM_, int NT_, int WN_, int STAGES_>
struct BwdTile {
  static constexpr int MT = MT_, WM = WM_, NT = NT_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static_assert(WM * WN * 32 == kTileThreads, "8 warps");
};

using Bwd64x64 = BwdTile<2, 2, 2, 4, 3>;
using Bwd64x128 = BwdTile<2, 2, 4, 4, 3>;
using Bwd128x128 = BwdTile<4, 2, 4, 4, 3>;
using Bwd128x160 = BwdTile<4, 2, 5, 4, 3>;

// dg = dh p and du = dh q, written once into the scratch the tiles read.
__global__ void gate_kernel(const float4* __restrict__ dh,
                            const float4* __restrict__ p,
                            const float4* __restrict__ q,
                            float4* __restrict__ dg, float4* __restrict__ du,
                            long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n4) return;
  const float4 h = dh[i], a = p[i], b = q[i];
  dg[i] = make_float4(h.x * a.x, h.y * a.y, h.z * a.z, h.w * a.w);
  du[i] = make_float4(h.x * b.x, h.y * b.y, h.z * b.z, h.w * b.w);
}

// dW's ring stage: x^T's chunk, k-major (kK rows of N x BM + 8 floats),
// then NP k-major chunks (kK x BN + 8) of the operands on the F side.
template <class T, int NP>
struct DwSmem {
  static constexpr int LDA = T::BM + 8, LDB = T::BN + 8;
  static constexpr int STAGE = kK * LDA + NP * kK * LDB;
  static constexpr size_t BYTES = sizeof(float) * T::STAGES * STAGE;
};

// dW: for each of the NP products, dw [d, f] = x^T s with K = n, s the
// gate's dg or du.  A block owns BM rows of D x BN columns of F of every
// product, so one x^T fragment feeds them all, as the forward's x tile
// feeds the gate and the up sums.  Blocks are numbered row tile fastest:
// the blocks sharing a column tile of s run together and its repeats come
// from L2 (x, 10 MB at [1024, 2560], stays there).
template <class T, int NP>
__global__ void __launch_bounds__(kTileThreads, 1)
swiglu_dw_kernel(const float* __restrict__ x, const float* __restrict__ s0,
                 const float* __restrict__ s1, float* __restrict__ dw0,
                 float* __restrict__ dw1, int n, int d, int f, int x_vec) {
  using repro::cp_async16;
  using repro::cp_async4;
  constexpr int MT = T::MT, NT = T::NT, BM = T::BM, BN = T::BN;
  using S = DwSmem<T, NP>;
  constexpr int LDA = S::LDA, LDB = S::LDB, kStages = T::STAGES;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int tiles_m = (d + BM - 1) / BM;
  const int row0 = static_cast<int>(blockIdx.x % tiles_m) * BM;  // of D
  const int col0 = static_cast<int>(blockIdx.x / tiles_m) * BN;  // of F
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / T::WN) * 16 * MT;
  const int wcol = (warp % T::WN) * 8 * NT;
  const int nk = (n + kK - 1) / kK;
  const float* const src[2] = {s0, s1};   // the F side, shared-memory order

  auto load_stage = [&](int kc) {
    if (kc < nk) {
      float* as = smem + (kc % kStages) * S::STAGE;
      float* bs = as + kK * LDA;
      const int k0 = kc * kK;
      if (x_vec) {
        for (int i = tid; i < kK * BM / 4; i += kTileThreads) {
          const int r = i / (BM / 4), c = i % (BM / 4) * 4;
          const bool ok = k0 + r < n && row0 + c < d;
          cp_async16(as + r * LDA + c,
                     ok ? x + static_cast<size_t>(k0 + r) * d + row0 + c : x, ok);
        }
      } else {
        for (int i = tid; i < kK * BM; i += kTileThreads) {
          const int r = i / BM, c = i % BM;
          const bool ok = k0 + r < n && row0 + c < d;
          cp_async4(as + r * LDA + c,
                    ok ? x + static_cast<size_t>(k0 + r) * d + row0 + c : x, ok);
        }
      }
      for (int i = tid; i < kK * BN / 4; i += kTileThreads) {
        const int r = i / (BN / 4), c = i % (BN / 4) * 4;
        const bool ok = k0 + r < n && col0 + c < f;
        const size_t off = ok ? static_cast<size_t>(k0 + r) * f + col0 + c : 0;
#pragma unroll
        for (int b = 0; b < NP; ++b)
          cp_async16(bs + (b * kK + r) * LDB + c, src[b] + off, ok);
      }
    }
    repro::cp_commit();
  };

  float acc[NP][MT][NT][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

  // kK / 8 k-steps, each step's three TF32 products from zero, then an
  // fp32 add into the running sums (the forward's numerics)
  auto chunk = [&](const float* as) {
    const float* bs = as + kK * LDA;
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      repro::FragA a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ap = as + (8 * ks + t) * LDA + wrow + 16 * i + g;
        a[i] = repro::frag_a(ap[0], ap[8], ap[4 * LDA], ap[4 * LDA + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int bo = (8 * ks + t) * LDB + wcol + 8 * j + g;
        repro::FragB b[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float* sp = bs + p * kK * LDB;
          b[p] = repro::frag_b(sp[bo], sp[bo + 4 * LDB]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            float c[4];
            repro::mma3_zero(c, a[i], b[p]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][i][j][e] += c[e];
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
    chunk(smem + (kc % kStages) * S::STAGE);
  }
  repro::cp_wait<0>();

  // rows g and g + 8 (of D), columns 2t and 2t + 1 (of F) of each tile
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + wcol + 8 * j + 2 * t;   // f % 4 == 0: col + 1 < f
      if (col >= f) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + wrow + 16 * i + g + 8 * hh;
        if (row >= d) continue;
        const size_t idx = static_cast<size_t>(row) * f + col;
        *reinterpret_cast<float2*>(dw0 + idx) =
            make_float2(acc[0][i][j][2 * hh], acc[0][i][j][2 * hh + 1]);
        if constexpr (NP == 2)
          *reinterpret_cast<float2*>(dw1 + idx) =
              make_float2(acc[1][i][j][2 * hh], acc[1][i][j][2 * hh + 1]);
      }
    }
}

// k-steps whose sums dX adds in fp32 before they join its running sums.
// Over K = 2F = 20,480 the running adds' rounding dominates dx's error:
// with one a step its RMS error against fp64 products was 9.2e-7, 1.4x
// cuBLAS fp32's, and gemma3's card-vs-CPU round moved past its gate; two
// give 6.5e-7 and run 5% faster, four 4.7e-7 but dX 22% slower (four
// steps' fragments overflow the registers; `tools/kernel_variants.py`
// `sb_dx_join1`, `sb_dx_join4`).  dW (K = N) keeps one a step.
constexpr int kDxJoin = 2;
static_assert(kK / 8 % kDxJoin == 0, "whole k-steps a chunk");

// dX's ring stage: the chunk of dg or du, m-major (BM rows x kK + 4
// floats), then the weights' chunk, n-major (BN rows of D x kK + 4 floats
// of F).
template <class T>
struct DxSmem {
  static constexpr int LDA = kK + 4, LDB = kK + 4;
  static constexpr int STAGE = T::BM * LDA + T::BN * LDB;
  static constexpr size_t BYTES = sizeof(float) * T::STAGES * STAGE;
};

// dX: dx [n, d] = dg wg^T + du wi^T as one sum over K = 2f, the wg half's
// chunks first, then the wi half's, into the same running sums (no second
// pass, no atomics).  The A operand is the gate's dg / du; the B operand
// w^T is read from wg / wi [d, f] along F.  A block owns BM rows of N x BN columns of D,
// numbered row tile fastest.
template <class T>
__global__ void __launch_bounds__(kTileThreads, 1)
swiglu_dx_kernel(const float* __restrict__ s0,
                 const float* __restrict__ s1, const float* __restrict__ wg,
                 const float* __restrict__ wi, float* __restrict__ dx, int n,
                 int d, int f) {
  using repro::cp_async16;
  constexpr int MT = T::MT, NT = T::NT, BM = T::BM, BN = T::BN;
  using S = DxSmem<T>;
  constexpr int LDA = S::LDA, LDB = S::LDB, kStages = T::STAGES;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int tiles_m = (n + BM - 1) / BM;
  const int row0 = static_cast<int>(blockIdx.x % tiles_m) * BM;  // of N
  const int col0 = static_cast<int>(blockIdx.x / tiles_m) * BN;  // of D
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / T::WN) * 16 * MT;
  const int wcol = (warp % T::WN) * 8 * NT;
  const int half = (f + kK - 1) / kK;   // chunks of each half of K
  const int nk = 2 * half;

  auto load_stage = [&](int kc) {
    if (kc < nk) {
      float* as = smem + (kc % kStages) * S::STAGE;
      float* bs = as + BM * LDA;
      const bool up = kc >= half;
      const int k0 = (up ? kc - half : kc) * kK;   // column of F
      const float* sa = up ? s1 : s0;
      const float* w = up ? wi : wg;
      for (int i = tid; i < BM * kK / 4; i += kTileThreads) {
        const int r = i / (kK / 4), c = i % (kK / 4) * 4;
        const bool ok = row0 + r < n && k0 + c < f;
        const size_t off = ok ? static_cast<size_t>(row0 + r) * f + k0 + c : 0;
        cp_async16(as + r * LDA + c, sa + off, ok);
      }
      for (int i = tid; i < BN * kK / 4; i += kTileThreads) {
        const int r = i / (kK / 4), c = i % (kK / 4) * 4;
        const bool ok = col0 + r < d && k0 + c < f;
        const size_t off = ok ? static_cast<size_t>(col0 + r) * f + k0 + c : 0;
        cp_async16(bs + r * LDB + c, w + off, ok);
      }
    }
    repro::cp_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // kDxJoin k-steps at a time: each step's three TF32 products from zero
  // (the forward's numerics), the steps' sums added in fp32, then that
  // into the running sums, so K = 2f takes 2f / (8 kDxJoin) running adds
  auto chunk = [&](const float* as) {
    const float* bs = as + BM * LDA;
#pragma unroll
    for (int ks0 = 0; ks0 < kK / 8; ks0 += kDxJoin) {
      repro::FragA a[kDxJoin][MT];
#pragma unroll
      for (int s = 0; s < kDxJoin; ++s)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int o = (wrow + 16 * i + g) * LDA + 8 * (ks0 + s) + t;
          a[s][i] = repro::frag_a(as[o], as[o + 8 * LDA], as[o + 4],
                                  as[o + 8 * LDA + 4]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        repro::FragB b[kDxJoin];
#pragma unroll
        for (int s = 0; s < kDxJoin; ++s) {
          const int bo = (wcol + 8 * j + g) * LDB + 8 * (ks0 + s) + t;
          b[s] = repro::frag_b(bs[bo], bs[bo + 4]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float c[4];
          repro::mma3_zero(c, a[0][i], b[0]);
#pragma unroll
          for (int s = 1; s < kDxJoin; ++s) {
            float c2[4];
            repro::mma3_zero(c2, a[s][i], b[s]);
#pragma unroll
            for (int e = 0; e < 4; ++e) c[e] += c2[e];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += c[e];
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_stage(s);
  for (int kc = 0; kc < nk; ++kc) {
    repro::cp_wait<kStages - 2>();
    __syncthreads();
    load_stage(kc + kStages - 1);
    chunk(smem + (kc % kStages) * S::STAGE);
  }
  repro::cp_wait<0>();

  // rows g and g + 8 (of N), columns 2t and 2t + 1 (of D, any d)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + wrow + 16 * i + g + 8 * hh;
        if (row >= n) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + wcol + 8 * j + 2 * t + e;
          if (col < d) dx[static_cast<size_t>(row) * d + col] = acc[i][j][2 * hh + e];
        }
      }
}

// Before a backward launch: the grid fits and the kernel may take `smem`.
template <class K>
int bwd_prepare(K kernel, size_t smem, long long blocks) {
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <class T, int NP>
int launch_dw(const float* x, const float* s0, const float* s1, float* dw0,
              float* dw1, int n, int d, int f, cudaStream_t stream) {
  const size_t smem = DwSmem<T, NP>::BYTES;
  const long long blocks = static_cast<long long>((d + T::BM - 1) / T::BM) *
                           ((f + T::BN - 1) / T::BN);
  const int err = bwd_prepare(swiglu_dw_kernel<T, NP>, smem, blocks);
  if (err) return err;
  // x's rows start 16-byte aligned (the wrapper checks the base) iff D % 4 == 0
  swiglu_dw_kernel<T, NP><<<static_cast<unsigned>(blocks), kTileThreads, smem,
                            stream>>>(x, s0, s1, dw0, dw1, n, d, f, d % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

// dW's tile: 128 x 128 from two waves of such blocks over the 132 SMs
// (1,600 blocks at [2560, 10240]), 64 x 64 below.
template <int NP>
int launch_dw_tiles(const float* x, const float* s0, const float* s1,
                    float* dw0, float* dw1, int n, int d, int f,
                    cudaStream_t s) {
  const long long big = static_cast<long long>((d + 127) / 128) * ((f + 127) / 128);
  if (big >= 2 * 132)
    return launch_dw<Bwd128x128, NP>(x, s0, s1, dw0, dw1, n, d, f, s);
  return launch_dw<Bwd64x64, NP>(x, s0, s1, dw0, dw1, n, d, f, s);
}

template <class T>
int launch_dx(const float* s0, const float* s1, const float* wg,
              const float* wi, float* dx, int n, int d, int f, cudaStream_t stream) {
  const size_t smem = DxSmem<T>::BYTES;
  const long long blocks = static_cast<long long>((n + T::BM - 1) / T::BM) *
                           ((d + T::BN - 1) / T::BN);
  const int err = bwd_prepare(swiglu_dx_kernel<T>, smem, blocks);
  if (err) return err;
  swiglu_dx_kernel<T><<<static_cast<unsigned>(blocks), kTileThreads, smem,
                        stream>>>(s0, s1, wg, wi, dx, n, d, f);
  return static_cast<int>(cudaGetLastError());
}

// The output elements of the whole waves a BM x BN tile takes over the
// 132 SMs (one block an SM): dX's time, up to the tile's own rate.
long long wave_cost(int n, int d, int bm, int bn) {
  const long long blocks = static_cast<long long>((n + bm - 1) / bm) * ((d + bn - 1) / bn);
  return (blocks + 131) / 132 * bm * bn;
}

// dX's tile: the candidate whose whole waves hold the fewest elements, the
// larger on a tie.  At [1024, 2560] 128 x 160 tiles make 128 blocks, one
// wave, where 128 x 128 make 160 (two waves, the second a fifth full).
int launch_dx_tiles(const float* s0, const float* s1, const float* wg,
                    const float* wi, float* dx, int n, int d, int f,
                    cudaStream_t s) {
  const long long c160 = wave_cost(n, d, 128, 160), c128 = wave_cost(n, d, 128, 128),
                  c64 = wave_cost(n, d, 64, 128);
  if (c160 <= c128 && c160 <= c64)
    return launch_dx<Bwd128x160>(s0, s1, wg, wi, dx, n, d, f, s);
  if (c128 <= c64) return launch_dx<Bwd128x128>(s0, s1, wg, wi, dx, n, d, f, s);
  return launch_dx<Bwd64x128>(s0, s1, wg, wi, dx, n, d, f, s);
}

}  // namespace

// x [n, d], wg/wi [d, f], out [n, f]: row-major fp32, f % 4 == 0 and every
// pointer 16-byte aligned (the wrapper checks).  Launches on `stream`,
// allocates nothing; returns the launch's cudaError_t.
extern "C" int swiglu_f32(const float* x, const float* wg, const float* wi,
                          float* out, int n, int d, int f, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 1) return launch<1>(x, wg, wi, out, nullptr, nullptr, n, d, f, s);
  if (n <= 2) return launch<2>(x, wg, wi, out, nullptr, nullptr, n, d, f, s);
  if (n <= 4) return launch<4>(x, wg, wi, out, nullptr, nullptr, n, d, f, s);
  if (n < kTileMinRows) return launch<8>(x, wg, wi, out, nullptr, nullptr, n, d, f, s);
  return launch_tiles(x, wg, wi, SiluMul{out}, n, d, f, s);
}

// swiglu_f32 under autograd: out as swiglu_f32 writes it (the same path
// and bits at every n), and the pair p, q [n, f] the backward reads.
extern "C" int swiglu_fwd_pair_f32(const float* x, const float* wg,
                                   const float* wi, float* out, float* p,
                                   float* q, int n, int d, int f, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 1) return launch<1, true>(x, wg, wi, out, p, q, n, d, f, s);
  if (n <= 2) return launch<2, true>(x, wg, wi, out, p, q, n, d, f, s);
  if (n <= 4) return launch<4, true>(x, wg, wi, out, p, q, n, d, f, s);
  if (n < kTileMinRows) return launch<8, true>(x, wg, wi, out, p, q, n, d, f, s);
  return launch_tiles(x, wg, wi, SiluMulPair{out, p, q}, n, d, f, s);
}

// Floats of scratch `swiglu_bwd_f32` needs: the gate's dg and du.
extern "C" long long swiglu_bwd_scratch_floats(int n, int f) {
  return 2LL * n * f;
}

// swiglu's backward from the pair: x [n, d], wg/wi [d, f], p, q, dh [n, f]
// -> dx [n, d], dwg, dwi [d, f], each skipped where its pointer is null;
// swiglu_f32's contract, and `scratch` of `swiglu_bwd_scratch_floats`
// floats.  The gate's launch, then dW's and dX's, on `stream`, allocating
// nothing; returns the first failed launch's cudaError_t.
extern "C" int swiglu_bwd_f32(const float* x, const float* wg, const float* wi,
                              const float* p, const float* q, const float* dh,
                              float* dx, float* dwg, float* dwi, float* scratch,
                              int n, int d, int f, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = static_cast<long long>(n) * f / 4;
  float* dg = scratch;
  float* du = scratch + static_cast<size_t>(n) * f;
  gate_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(dh), reinterpret_cast<const float4*>(p),
      reinterpret_cast<const float4*>(q), reinterpret_cast<float4*>(dg),
      reinterpret_cast<float4*>(du), n4);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (dwg && dwi)
    err = launch_dw_tiles<2>(x, dg, du, dwg, dwi, n, d, f, s);
  else if (dwg)
    err = launch_dw_tiles<1>(x, dg, nullptr, dwg, nullptr, n, d, f, s);
  else if (dwi)
    err = launch_dw_tiles<1>(x, du, nullptr, dwi, nullptr, n, d, f, s);
  if (err || !dx) return err;
  return launch_dx_tiles(dg, du, wg, wi, dx, n, d, f, s);
}

// The row count from which `swiglu_f32` takes the tile path.
extern "C" int swiglu_tile_min_rows() { return kTileMinRows; }
