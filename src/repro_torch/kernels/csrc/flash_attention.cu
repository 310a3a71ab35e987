// Full-sequence GQA flash attention for Hopper, forward and backward, fp32
// in and out, products on the tensor cores in 3xTF32.
//
// Replaces: repro/kernels/flash_attention.py `_flash_kernel` (pallas_call in
// `_call`, reached from `flash_attention`).  The TPU kernel walks the key
// blocks as its innermost sequential grid axis and carries the online-softmax
// state (running max, denominator, output accumulator) in VMEM scratch from
// one grid step to the next.  Hopper runs blocks in parallel and in no order,
// so here the walk over key tiles is a loop inside one block that owns a
// (batch row, query head, query tile).  The JAX package has no backward
// kernel (`jax.grad` cannot differentiate through its pallas_call); the
// backward here is the port's own, the FlashAttention-2 recurrence.
//
// Semantics follow repro/kernels/ref.py `_mask`/`attention`: query row i sits
// at qpos = q_offset + i, key j at j; a key is allowed iff (!causal || j <=
// qpos) && (window <= 0 || j > qpos - window), or j < prefix_len.  Disallowed
// keys score the finite -1e30, keys past Sk are excluded outright, so a row
// with no allowed key gets the mean of V over the Sk keys, as the reference
// does.  causal, window, prefix_len and q_offset are RUNTIME arguments: one
// build serves every layer's mask.  Query head h reads kv head h / g.
//
// Numerics: 3xTF32.  Every product runs on `mma.sync.m16n8k8` with TF32
// operands.  Each fp32 operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (x - hi is exact in fp32), and a product accumulates
// lo*hi + hi*lo + hi*hi in fp32, dropping lo*lo: each operand keeps ~22 of
// its 24 significand bits, so the sums agree with fp32 to ~1e-6 relative, as
// the CUDA-core kernels did.  One TF32 product (hi*hi alone) keeps 11 bits,
// ~5e-4 relative per product, which breaks the 2e-5 / 5e-5 tolerances the
// port holds attention to (tests/test_torch_tf32.py shows both in numpy).
// The instruction reads only the top 19 bits of a register, so every operand
// is rounded (`cvt.rna`) first, never truncated.  The tensor core also
// truncates as it aligns its accumulator, so no accumulator takes a long
// chain of products: a score product sums kChunk = 2 k-steps of 8 in a
// zero-started partial, a second product one streamed tile, and the
// partials join the running sums by fp32 adds (the softmax rescale rides on
// that fmaf).  Chained over a whole row, the outputs' error against the
// plain version was 6x the CUDA-core kernels'; with the partials it is
// 1.4x (forward) and 4x (backward), ~2e-6 absolute at ViT-B, and training
// on the card stays within its card-vs-CPU rules.  The global TF32 flags
// stay off (models/common.py).
//
// Bound on this card: at ViT-B's shapes ([32,196,12,64], non-causal) the
// forward does 4 S^2 D useful FLOPs per (batch row, head) against 16 S D
// bytes; in 3xTF32 that is 3 x 3.78e9 tensor-core FLOPs / 495 TFLOP/s =
// 0.023 ms against 77 MB / 3.35 TB/s = 0.023 ms, so the two bounds meet.
// The backward's 10 S^2 D FLOPs (S, dP, dV, dK, dQ) give 0.057 ms of
// operations against 154 MB (0.046 ms).  What holds the kernels above those
// bounds is mma.sync itself: it issues TF32 at ~321 TFLOP/s on an H100
// (tools/mma_tf32_peak.py: independent m16n8k8 products), not wgmma's 495,
// and every fragment is loaded from shared memory and split before its
// product.
// Measured times, per-kernel shares and the rejected variants: PERF.md.
//
// Design.  Blocks of 4 warps.  Fragments come from shared memory tiles with
// rows padded to D + 4 floats (16-byte aligned for cp.async, and every
// fragment load below is free of bank conflicts).  K and V (forward), Q, dO,
// lse and delta (dK/dV), or dS and K (dQ) stream through a 2-stage cp.async
// ring (16-byte copies, zero-filled past the end) so the next tile loads
// while this one computes; a third stage measured slower.  A warp owns 16
// rows of its block's tile; at large D, WD warps share the rows and split
// the output's D columns (each recomputes the 16-row score tile, which
// needs the full D).
//   * A score-shaped product (S = Q K^T, and the transposed S^T = K Q^T,
//     dP^T = V dO^T of the dK/dV kernel) reads A rows and B rows from two
//     row-major tiles: no transpose anywhere.
//   * The score tile stays in registers as the accumulator layout (rows g,
//     g + 8, columns 2t, 2t + 1 of each n8 group) and feeds the second
//     product (P V, P^T dO, dS^T Q) as its A operand without a shuffle: the
//     k-index t of the A fragment is taken as column 2t and t + 4 as 2t + 1,
//     and the B fragment reads the same permuted rows.
//   * Tiles wholly inside the sequence take a copy of the loop with no
//     bounds test (the tests kept mma.sync from overlapping its
//     neighbours: tested on every tile, 1.15-1.2x slower); the last tile
//     skips its n8 column groups wholly past Sk (or Sq), and a warp whose
//     16 rows lie wholly past the end skips its products: at S = 196 a
//     (query, key) tile pair costs (208 x 200) / 196^2 = 1.08x the useful
//     work, not 1.71x.
//   * Key tiles (forward, dQ) and query tiles (dK/dV) in which a causal or
//     window mask allows no pair are skipped (see `key_lo` below): half the
//     tiles of a causal square, all but ~1.5 window's worth of a long
//     sliding-window row.  The outputs' bits do not change.
//   * The D loop of a score product is unrolled by 2, not fully: fully
//     unrolled, the kernels were 1.1-1.15x slower (their code outgrew the
//     instruction cache, by the look of it).
// Tiles (rows per block x streamed rows per stage, warps sharing D):
//   forward: 64 x 32 keys (D 64, 128); 32 x 32 (D 256, 2 warps on D).
//   dK/dV:   64 keys (D 64), 32 (D 128, 2 on D), 16 (D 256, 4 on D), each
//            against 32-query stages; 70 KB of shared memory at D 64.
//   dQ:      64 queries x 32 keys of dS (D 64, 128); 32 x 32 (D 256, 2 on D).
// Registers per thread (`-Xptxas -v`, printed by chip_smoke.py's `build`
// phase):                       D 64   D 128   D 256
//   forward                      128    221     221
//   dK/dV (bounded to 3 blocks)  168    168     168
//     its spill stores / loads   72/96  24/4    0/0 bytes
//   dQ                           128    237     237
//   delta                        18     18      24
// So 4 forward blocks and 3 dK/dV blocks fit an SM at D 64.
//
// Forward: writes O and the per-row log-sum-exp [B, Hq, Sq] (m + log l).
// The softmax takes expf of scale * S, as the plain version does: exp2f of
// S * (scale * log2 e) rounds the product where scale = 1/8 is exact.
// Backward (five S x S x D products): (1) delta = rowsum(dO * O); (2) one
// block per (batch row, kv head, key tile) recomputes P^T = exp(S^T - lse)
// and dP^T for every query tile and every query head of its group,
// accumulates dV += P^T dO and dK += dS^T Q, dS = P * (dP - delta), and
// stores dS; (3) one block per (batch row, query head, query tile)
// accumulates dQ += dS K from the stored dS.  Storing dS costs a write and a
// read of it (~0.04 ms at ViT-B), where recomputing S and dP in the dQ
// launch cost ~0.2 ms.  Its scratch is bounded: while B*Hq*Sq*Sk floats fit
// 64 MiB (59 MB at ViT-B) one chunk holds every key and the backward is
// three launches; past that, (2) and (3) run once per chunk of keys that
// fits, dQ's sum carried through dq, with the same bits as one chunk
// (`launch_bwd`).  The scratch's size is defined here only
// (flash_attention_bwd_scratch_floats).
// No atomics: every output element has one owner and every sum runs in a
// fixed order, so the backward is bitwise the same from run to run.  A row
// with no allowed key (lse at -1e30) has P = 1/Sk on every key and dS = 0,
// as the reference's `where` gives it.
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDeltaThreads = 256;
constexpr int kStages = 2;             // depth of the cp.async ring
constexpr float kMasked = -1e30f;      // the score of a disallowed key
constexpr float kDeadRow = -1e29f;     // lse at or below: no allowed key

// Tiling per head dim (see the note above).  WD: warps that share 16 rows
// and split D; rows per block = 16 * (kWarps / WD).
template <int D>
struct Cfg {
  static constexpr int LD = D + 4;                 // smem row stride
  static constexpr int F_WD = D == 256 ? 2 : 1;
  static constexpr int F_BQ = 16 * (kWarps / F_WD);
  static constexpr int F_BK = 32;
  static constexpr int KV_WD = D / 64;
  static constexpr int KV_BK = 16 * (kWarps / KV_WD);
  static constexpr int KV_BQ = 32;
  static constexpr int Q_WD = D == 256 ? 2 : 1;
  static constexpr int Q_BQ = 16 * (kWarps / Q_WD);
  static constexpr int Q_BK = 32;
  static constexpr int LS = Q_BK + 8;              // smem row stride of a dS tile
};

__device__ __forceinline__ bool allowed(int kpos, int qpos, int causal,
                                        int window, int prefix_len) {
  bool ok = true;
  if (causal) ok = kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  if (prefix_len > 0) ok = ok || kpos < prefix_len;
  return ok;
}

// Key tiles and query tiles with no allowed (query, key) pair are skipped.
// Without the prefix, the keys a query at qpos may attend form the interval
// [key_lo, key_hi], both ends nondecreasing in qpos, so a run of queries
// attends the union [key_lo(first), key_hi(last)], and the queries with no
// allowed key ("dead" rows) lie before or after the live ones.  A skipped
// pair's products would add exact zeros (P = 0 and dS = 0, or, ahead of a
// row's first allowed key, a partial the first rescale by exp(-1e30 - m)
// = 0 wipes out), so skipping leaves every output's bits as they were.
// A dead row takes the mean of V over all Sk keys, so a tile with one
// skips nothing in the forward and in dK/dV (its dS, and so its dQ, is 0).
__device__ __forceinline__ int key_lo(int qpos, int window) {
  return window > 0 ? max(0, qpos - window + 1) : 0;
}

__device__ __forceinline__ int key_hi(int qpos, int sk, int causal) {
  return causal ? min(sk - 1, qpos) : sk - 1;
}

// the last key a query at qpos may attend, the prefix included
__device__ __forceinline__ int key_last(int qpos, int sk, int causal, int prefix_len) {
  return max(key_hi(qpos, sk, causal), min(prefix_len, sk) - 1);
}

__device__ __forceinline__ bool dead_row(int qpos, int sk, int causal, int window,
                                         int prefix_len) {
  return prefix_len <= 0 && key_lo(qpos, window) > key_hi(qpos, sk, causal);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- cp.async --

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) x columns [col0, col0 + COLS) of a row-major
// matrix (row_stride floats apart) into a smem tile [ROWS][LDT]; rows at or
// past n_rows and 4-float chunks at or past n_cols (a multiple of 4) are
// zero-filled.
template <int COLS, int ROWS, int LDT>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int row0, int n_rows,
                                          size_t row_stride, int col0, int n_cols) {
  constexpr int C4 = COLS / 4;
  for (int idx = threadIdx.x; idx < ROWS * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const bool ok = row0 + r < n_rows && col0 + c < n_cols;
    cp_async16(dst + r * LDT + c,
               ok ? base + static_cast<size_t>(row0 + r) * row_stride + col0 + c : base, ok);
  }
}

// Rows [row0, row0 + ROWS) of one head of a [*, S, H, D] tensor (base points
// at that batch row and head; row_stride = H * D) into a smem tile
// [ROWS][D + 4]; rows at or past s_len are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, int row0,
                                          int s_len, size_t row_stride) {
  load_tile<D, ROWS, D + 4>(dst, base, row0, s_len, row_stride, 0, D);
}

// src[i0, i0 + N) into dst[0, N), zeros past len.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int len) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool ok = i0 + i < len;
    cp_async4(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// ------------------------------------------------------------ 3xTF32 mma --

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// c += a b
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32, the small terms first.  Each B fragment goes
// through its three products before the next one loads: a row of loaded
// fragments issued term by term held ~30 more registers and was slower.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// k-steps of 8 that a score product sums in a zero-started partial before
// an fp32 add joins it to the running sum: a long chain of mma.sync on one
// accumulator drifts toward zero (the tensor core truncates as it aligns),
// where fp32 adds round to nearest (see the note at the top).  A second
// product's chunk is its streamed tile.
constexpr int kChunk = 2;

// c[j] = A B_j^T over D for a warp's 16 rows: A rows at `a`, B rows 8j ..
// 8j + 7 at `b` (both smem tiles, row stride D + 4).  Unless FULL, groups
// j >= nact are left at zero (they lie past the sequence's end); a FULL
// tile has no branch in its loops, so loads and products interleave.
template <int D, int NT, bool FULL>
__device__ __forceinline__ void rows_dot_rows(float (&c)[NT][4], const float* a,
                                              const float* b, int nact, int g, int t) {
  constexpr int LD = D + 4, KC = D / 8 < kChunk ? D / 8 : kChunk;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += KC) {
    float d[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll 2
    for (int kd = k0; kd < k0 + KC; ++kd) {
      const float* ap = a + g * LD + 8 * kd + t;
      const FragA fa = frag_a(ap[0], ap[8 * LD], ap[4], ap[8 * LD + 4]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* bp = b + (8 * j + g) * LD + 8 * kd + t;
        if (FULL || j < nact) mma3(d[j], fa, frag_b(bp[0], bp[4]));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += d[j][e];
  }
}

// acc[n] = acc[n] * al + P B over the P tile's columns (al0 for rows g, al1
// for rows g + 8: the forward's softmax rescale, 1 elsewhere): P [16 x 8 KS]
// in accumulator layout (p[ks]), B rows 8 ks .. at `b`, columns col0 + 8 n
// ...  The A fragment's k-index t is P's column 2t and t + 4 is 2t + 1, so B
// reads rows 2t and 2t + 1 of each 8-row step: no shuffle moves P.  The
// tile's product starts from zero and joins acc by one fmaf.
template <int D, int KS, int NT, bool FULL>
__device__ __forceinline__ void probs_times_rows(float (&acc)[NT][4], const float (&p)[KS][4],
                                                 const float* b, int col0, int nact, int g,
                                                 int t, float al0 = 1.f, float al1 = 1.f) {
  constexpr int LD = D + 4;
  float d[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (FULL || ks < nact) {
      const FragA fa = frag_a(p[ks][0], p[ks][2], p[ks][1], p[ks][3]);
      const float* bp = b + (8 * ks + 2 * t) * LD + col0 + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3(d[n], fa, frag_b(bp[8 * n], bp[LD + 8 * n]));
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = fmaf(acc[n][0], al0, d[n][0]);
    acc[n][1] = fmaf(acc[n][1], al0, d[n][1]);
    acc[n][2] = fmaf(acc[n][2], al1, d[n][2]);
    acc[n][3] = fmaf(acc[n][3], al1, d[n][3]);
  }
}

// Tag of a tile that lies wholly inside the sequence (no bounds checks).
template <bool B>
struct Full {
  static constexpr bool value = B;
};

// ------------------------------------------------------------- forward ----

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, int hq, int hkv,
              float scale, int causal, int window, int prefix_len,
              int q_offset) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, WD = C::F_WD, BQ = C::F_BQ, BK = C::F_BK;
  constexpr int DW = D / WD, NK = BK / 8, ND = DW / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;            // [kStages][BK][LD]
  float* vs = ks + kStages * BK * LD;  // [kStages][BK][LD]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / WD, col0 = (warp % WD) * DW;
  const size_t qstride = static_cast<size_t>(hq) * D;
  const size_t kstride = static_cast<size_t>(hkv) * D;
  const float* qb = q + static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  // the key tiles this block's queries attend (all of them if a row is dead)
  const int qpa = q_offset + q0, qpb = q_offset + min(q0 + BQ, sq) - 1;
  int t_begin = 0, t_end = (sk + BK - 1) / BK;
  if (!dead_row(qpa, sk, causal, window, prefix_len) &&
      !dead_row(qpb, sk, causal, window, prefix_len)) {
    if (prefix_len <= 0) t_begin = key_lo(qpa, window) / BK;
    t_end = min(t_end, key_last(qpb, sk, causal, prefix_len) / BK + 1);
  }
  auto load_stage = [&](int it) {       // key tile `it` into its ring slot
    if (it < t_end) {
      load_rows<D, BK>(ks + it % kStages * BK * LD, kb, it * BK, sk, kstride);
      load_rows<D, BK>(vs + it % kStages * BK * LD, vb, it * BK, sk, kstride);
    }
    cp_commit();                        // one group per tile, empty past the end
  };
  load_rows<D, BQ>(qs, qb, q0, sq, qstride);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) load_stage(t_begin + it);

  const int row0 = q0 + 16 * wr;
  const bool active = row0 < sq;       // warp-uniform
  const int qp0 = q_offset + row0 + g, qp1 = qp0 + 8;
  const float* qw = qs + 16 * wr * LD;
  // running max and this thread's share of the denominator
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // one key tile; FULL: every key of it lies before Sk
  auto tile = [&](auto full, const float* kt, const float* vt, int k0) {
    constexpr bool FULL = decltype(full)::value;
    const int nact = FULL ? NK : (sk - k0 + 7) / 8;
    float s[NK][4];
    rows_dot_rows<D, NK, FULL>(s, qw, kt, nact, g, t);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = allowed(key, e < 2 ? qp0 : qp1, causal, window, prefix_len)
                      ? s[j][e] * scale : kMasked;
        if (!FULL && key >= sk) x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - (e < 2 ? m0 : m1));    // exp(-inf) = 0
        s[j][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    probs_times_rows<D, NK, ND, FULL>(acc, s, vt, col0, nact, g, t, al0, al1);
  };

  for (int it = t_begin; it < t_end; ++it) {
    load_stage(it + kStages - 1);
    cp_wait<kStages - 1>();             // tile `it` has landed
    __syncthreads();
    if (active) {
      const int k0 = it * BK;
      const float* kt = ks + it % kStages * BK * LD;
      const float* vt = vs + it % kStages * BK * LD;
      if (k0 + BK <= sk) tile(Full<true>(), kt, vt, k0);
      else tile(Full<false>(), kt, vt, k0);
    }
    __syncthreads();
  }

  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + g + 8 * half;
    if (qi >= sq) continue;
    const float l = half ? l1 : l0;
    const float denom = l == 0.f ? 1.f : l;
    float* orow = o + static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(qi) * qstride +
                  static_cast<size_t>(h) * D + col0;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[n][2 * half] / denom, acc[n][2 * half + 1] / denom);
    if (t == 0 && col0 == 0)
      lse[(static_cast<size_t>(b) * hq + h) * sq + qi] = (half ? m1 : m0) + logf(denom);
  }
}

// ------------------------------------------------------------ backward ----

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
fa_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                    float* __restrict__ delta, int rows, int sq, int hq) {
  const int r = blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* orow = o + static_cast<size_t>(r) * D;
  const float* drow = dout + static_cast<size_t>(r) * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], drow[d], acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    const int b = r / (sq * hq), rem = r % (sq * hq);
    const int i = rem / hq, h = rem % hq;
    delta[(static_cast<size_t>(b) * hq + h) * sq + i] = acc;
  }
}

// One block per (key tile, kv head, batch row): dK and dV of its keys, over
// the query tiles that attend them, of every query head of the group, in
// the transposed domain (rows = keys, columns = queries).  Bounded to 168 registers so 3
// blocks fit an SM: that spills up to 72 bytes and still measured 8% faster
// than 2 blocks without the bound.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dsg,
                   int sq, int sk, int c0, int kc, int hq, int hkv, float scale, int causal,
                   int window, int prefix_len, int q_offset) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, WD = C::KV_WD, BK = C::KV_BK, BQ = C::KV_BQ;
  constexpr int DW = D / WD, NQ = BQ / 8, ND = DW / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;            // [kStages][BQ][LD]
  float* dos = qs + kStages * BQ * LD; // [kStages][BQ][LD]
  float* ls = dos + kStages * BQ * LD; // [kStages][BQ]
  float* dls = ls + kStages * BQ;      // [kStages][BQ]

  const int k0 = c0 + blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int gh = hq / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / WD, col0 = (warp % WD) * DW;
  const size_t qstride = static_cast<size_t>(hq) * D;
  const size_t kstride = static_cast<size_t>(hkv) * D;
  const size_t koff = static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  // the query tiles that attend this block's keys: every one if any row of
  // the sequence is dead or the keys lie in the prefix
  const int nqt = (sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nqt;
  if (!dead_row(q_offset, sk, causal, window, prefix_len) &&
      !dead_row(q_offset + sq - 1, sk, causal, window, prefix_len) && k0 >= prefix_len) {
    const long long klast = min(k0 + BK, sk) - 1;
    const long long i_lo = causal ? max(0LL, static_cast<long long>(k0) - q_offset) : 0LL;
    const long long i_hi =
        window > 0 ? min(sq - 1LL, klast + window - 1 - q_offset) : sq - 1LL;
    qt_begin = i_lo > i_hi ? 0 : static_cast<int>(i_lo / BQ);
    qt_end = i_lo > i_hi ? 0 : static_cast<int>(i_hi / BQ + 1);
  }
  const int nqn = qt_end - qt_begin, n_it = gh * nqn;
  auto load_stage = [&](int it) {       // (head, query tile) `it` into its slot
    if (it < n_it) {
      const int st = it % kStages, h = hk * gh + it / nqn, q0 = (qt_begin + it % nqn) * BQ;
      const size_t qoff = static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(h) * D;
      const size_t rowbase = (static_cast<size_t>(b) * hq + h) * sq;
      load_rows<D, BQ>(qs + st * BQ * LD, q + qoff, q0, sq, qstride);
      load_rows<D, BQ>(dos + st * BQ * LD, dout + qoff, q0, sq, qstride);
      load_vec<BQ>(ls + st * BQ, lse + rowbase, q0, sq);
      load_vec<BQ>(dls + st * BQ, delta + rowbase, q0, sq);
    }
    cp_commit();
  };
  load_rows<D, BK>(ks, k + koff, k0, sk, kstride);
  load_rows<D, BK>(vs, v + koff, k0, sk, kstride);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) load_stage(it);

  const int key0 = k0 + 16 * wr;
  const bool active = key0 < sk;       // warp-uniform
  const float inv_sk = 1.f / static_cast<float>(sk);
  const float* kw = ks + 16 * wr * LD;
  const float* vw = vs + 16 * wr * LD;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // one query tile; FULL: every query of it lies before Sq.  P of a key
  // past Sk needs no check (its dK / dV row is never written); its dS is
  // stored, as 0.  dsh: this head's dS [Sq, kc] of the chunk's keys.
  auto tile = [&](auto full, const float* qt, const float* dot, const float* lt,
                  const float* dlt, int q0, float* dsh) {
    constexpr bool FULL = decltype(full)::value;
    const int nact = FULL ? NQ : (sq - q0 + 7) / 8;
    float p[NQ][4], ds[NQ][4];
    rows_dot_rows<D, NQ, FULL>(p, kw, qt, nact, g, t);    // S^T
    rows_dot_rows<D, NQ, FULL>(ds, vw, dot, nact, g, t);  // dP^T
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1), key = key0 + g + 8 * (e >> 1);
        float pij = 0.f, dsij = 0.f;
        if (FULL || q0 + qi < sq) {
          const float lq = lt[qi];
          if (lq <= kDeadRow) {
            pij = inv_sk;            // no allowed key: uniform weights, no score gradient
          } else if (allowed(key, q_offset + q0 + qi, causal, window, prefix_len)) {
            pij = expf(p[j][e] * scale - lq);
            if (key < sk) dsij = pij * (ds[j][e] - dlt[qi]);
          }
          if (key - c0 < kc) dsh[static_cast<size_t>(q0 + qi) * kc + key - c0] = dsij;
        }
        p[j][e] = pij;
        ds[j][e] = dsij;
      }
    probs_times_rows<D, NQ, ND, FULL>(dva, p, dot, col0, nact, g, t);   // dV += P^T dO
    probs_times_rows<D, NQ, ND, FULL>(dka, ds, qt, col0, nact, g, t);   // dK += dS^T Q
  };

  for (int it = 0; it < n_it; ++it) {
    load_stage(it + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      const int st = it % kStages, q0 = (qt_begin + it % nqn) * BQ;
      const float* qt = qs + st * BQ * LD;
      const float* dot = dos + st * BQ * LD;
      float* dsh = dsg + (static_cast<size_t>(b) * hq + hk * gh + it / nqn) * sq * kc;
      if (q0 + BQ <= sq) tile(Full<true>(), qt, dot, ls + st * BQ, dls + st * BQ, q0, dsh);
      else tile(Full<false>(), qt, dot, ls + st * BQ, dls + st * BQ, q0, dsh);
    }
    __syncthreads();
  }

  // dS of the skipped query rows is 0: the dQ launch reads it in its tiles
  const int r_lo = qt_begin * BQ, r_hi = min(qt_end * BQ, sq), nskip = r_lo + sq - r_hi;
  for (int idx = threadIdx.x; idx < gh * nskip * BK; idx += kThreads) {
    const int kl = k0 + idx % BK - c0, r = idx / BK % nskip, hh = idx / (BK * nskip);
    if (kl < kc)
      dsg[((static_cast<size_t>(b) * hq + hk * gh + hh) * sq + (r < r_lo ? r : r - r_lo + r_hi)) *
              kc + kl] = 0.f;
  }

  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = key0 + g + 8 * half;
    if (kj >= sk) continue;
    const size_t off = koff + static_cast<size_t>(kj) * kstride + col0;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n + 2 * t) =
          make_float2(dka[n][2 * half] * scale, dka[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n + 2 * t) =
          make_float2(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

// One block per (query tile, query head, batch row): dQ += dS K over the
// nk keys [c0, c0 + nk) of one chunk, from the dS the dK/dV kernel stored
// ([Sq, kc] per head, keys past Sk zero).  The unscaled sum runs on through
// dq from chunk to chunk (`first` starts it at 0, `last` scales it), so it
// adds the key tiles in the same order and to the same bits as one chunk.
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ dsg, const float* __restrict__ k,
                 float* __restrict__ dq, int sq, int sk, int c0, int nk, int kc, int hq,
                 int hkv, float scale, int first, int last, int causal, int window,
                 int prefix_len, int q_offset) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, LS = C::LS, WD = C::Q_WD, BQ = C::Q_BQ, BK = C::Q_BK;
  constexpr int DW = D / WD, NK = BK / 8, ND = DW / 8;
  extern __shared__ float4 smem4[];
  float* dss = reinterpret_cast<float*>(smem4);  // [kStages][BQ][LS]
  float* ks = dss + kStages * BQ * LS;           // [kStages][BK][LD]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / WD, col0 = (warp % WD) * DW;
  const size_t qstride = static_cast<size_t>(hq) * D;
  const size_t kstride = static_cast<size_t>(hkv) * D;
  const float* dsh = dsg + (static_cast<size_t>(b) * hq + h) * sq * kc;
  const float* kb = k + (static_cast<size_t>(b) * sk + c0) * kstride + static_cast<size_t>(hk) * D;
  const int ncols = (nk + 3) / 4 * 4;
  // the chunk's key tiles that this block's queries attend (a dead row's dS
  // is 0, so it needs none)
  const int qpa = q_offset + q0, qpb = q_offset + min(q0 + BQ, sq) - 1;
  const int klo = max(prefix_len > 0 ? 0 : key_lo(qpa, window), c0) - c0;
  const int khi = min(key_last(qpb, sk, causal, prefix_len), c0 + nk - 1) - c0;
  const int t_begin = klo > khi ? 0 : klo / BK, t_end = klo > khi ? 0 : khi / BK + 1;
  auto load_stage = [&](int it) {       // key tile `it` into its ring slot
    if (it < t_end) {
      const int st = it % kStages;
      load_tile<BK, BQ, LS>(dss + st * BQ * LS, dsh, q0, sq, kc, it * BK, ncols);
      load_rows<D, BK>(ks + st * BK * LD, kb, it * BK, nk, kstride);
    }
    cp_commit();
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) load_stage(t_begin + it);

  const int row0 = q0 + 16 * wr;
  const bool active = row0 < sq;       // warp-uniform
  const size_t qoff = static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(h) * D;
  float dqa[ND][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + g + 8 * half;
    const float* row = dq + qoff + static_cast<size_t>(qi) * qstride + col0;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float2 prev = make_float2(0.f, 0.f);
      if (!first && qi < sq) prev = *reinterpret_cast<const float2*>(row + 8 * n + 2 * t);
      dqa[n][2 * half] = prev.x;
      dqa[n][2 * half + 1] = prev.y;
    }
  }

  // one key tile; FULL: every key of it lies before the chunk's end
  auto tile = [&](auto full, const float* dt, const float* kt, int k0) {
    constexpr bool FULL = decltype(full)::value;
    const int nact = FULL ? NK : (nk - k0 + 7) / 8;
    // dS in the accumulator layout probs_times_rows takes: rows g, g + 8,
    // columns 2t, 2t + 1 of each 8-key step
    float p[NK][4];
    const float* r = dt + 16 * wr * LS + g * LS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const float2 lo = *reinterpret_cast<const float2*>(r + 8 * ks);
      const float2 hi = *reinterpret_cast<const float2*>(r + 8 * LS + 8 * ks);
      p[ks][0] = lo.x;
      p[ks][1] = lo.y;
      p[ks][2] = hi.x;
      p[ks][3] = hi.y;
    }
    probs_times_rows<D, NK, ND, FULL>(dqa, p, kt, col0, nact, g, t);   // dQ += dS K
  };

  for (int it = t_begin; it < t_end; ++it) {
    load_stage(it + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      const int k0 = it * BK, st = it % kStages;
      if (k0 + BK <= nk) tile(Full<true>(), dss + st * BQ * LS, ks + st * BK * LD, k0);
      else tile(Full<false>(), dss + st * BQ * LS, ks + st * BK * LD, k0);
    }
    __syncthreads();
  }

  if (!active) return;
  const float sc = last ? scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + g + 8 * half;
    if (qi >= sq) continue;
    float* row = dq + qoff + static_cast<size_t>(qi) * qstride + col0;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(dqa[n][2 * half] * sc, dqa[n][2 * half + 1] * sc);
  }
}

// ------------------------------------------------------------- launches ---

template <int D>
size_t fwd_smem() {
  using C = Cfg<D>;
  return sizeof(float) * (C::F_BQ + 2 * kStages * C::F_BK) * C::LD;
}

template <int D>
size_t dkdv_smem() {
  using C = Cfg<D>;
  return sizeof(float) * ((2 * C::KV_BK + 2 * kStages * C::KV_BQ) * C::LD +
                          2 * kStages * C::KV_BQ);
}

template <int D>
size_t dq_smem() {
  using C = Cfg<D>;
  return sizeof(float) * kStages * (C::Q_BQ * C::LS + C::Q_BK * C::LD);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o,
                       float* lse, int b, int sq, int sk, int hq, int hkv,
                       float scale, int causal, int window, int prefix_len,
                       int q_offset, cudaStream_t s) {
  const size_t shmem = fwd_smem<D>();
  cudaError_t err = set_smem(fa_fwd_kernel<D>, shmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Cfg<D>::F_BQ - 1) / Cfg<D>::F_BQ, hq, b);
  fa_fwd_kernel<D><<<grid, kThreads, shmem, s>>>(q, k, v, o, lse, sq, sk, hq, hkv, scale, causal,
                                                 window, prefix_len, q_offset);
  return cudaGetLastError();
}

// The backward's scratch: delta [b, hq, sq] rounded up to 4 floats (so dS
// starts 16-byte aligned), then dS [b, hq, sq, kc] for one chunk of kc keys.
// kc is every key (Sk rounded up to 4) while that dS fits kMaxDsFloats
// (64 MiB), else the most multiples of 64 keys that fit, at least 64: a
// multiple of every key tile, so the chunks split no tile.  The scratch is
// then at most 64 MiB or 64 floats per query row, whichever is more.
constexpr size_t kMaxDsFloats = size_t{1} << 24;
constexpr int kChunkAlign = 64;

int ds_chunk_keys(size_t rows, int sk) {
  const size_t kp = (static_cast<size_t>(sk) + 3) / 4 * 4;
  if (rows * kp <= kMaxDsFloats) return static_cast<int>(kp);
  const size_t fit = kMaxDsFloats / rows / kChunkAlign * kChunkAlign;
  return static_cast<int>(std::min(kp, std::max<size_t>(fit, kChunkAlign)));
}

size_t delta_floats(size_t rows) { return (rows + 3) / 4 * 4; }

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* lse, const float* dout, float* dq, float* dk,
                       float* dv, float* scratch, int b, int sq, int sk, int hq,
                       int hkv, float scale, int causal, int window,
                       int prefix_len, int q_offset, cudaStream_t s) {
  const size_t rows = static_cast<size_t>(b) * sq * hq;
  const int kc = ds_chunk_keys(rows, sk);
  float* delta = scratch;
  float* ds = scratch + delta_floats(rows);
  const int warps = kDeltaThreads / 32;
  fa_bwd_delta_kernel<D><<<static_cast<unsigned>((rows + warps - 1) / warps), kDeltaThreads, 0, s>>>(
      o, dout, delta, static_cast<int>(rows), sq, hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t sm_kv = dkdv_smem<D>(), sm_q = dq_smem<D>();
  err = set_smem(fa_bwd_dkdv_kernel<D>, sm_kv);
  if (err != cudaSuccess) return err;
  err = set_smem(fa_bwd_dq_kernel<D>, sm_q);
  if (err != cudaSuccess) return err;

  // per chunk: dK, dV of its keys and their dS, then dQ of those keys
  for (int c0 = 0; c0 < sk; c0 += kc) {
    const int nk = std::min(kc, sk - c0);
    const dim3 gkv((nk + Cfg<D>::KV_BK - 1) / Cfg<D>::KV_BK, hkv, b);
    fa_bwd_dkdv_kernel<D><<<gkv, kThreads, sm_kv, s>>>(q, k, v, dout, lse, delta, dk, dv, ds, sq,
                                                       sk, c0, kc, hq, hkv, scale, causal, window,
                                                       prefix_len, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 gq((sq + Cfg<D>::Q_BQ - 1) / Cfg<D>::Q_BQ, hq, b);
    fa_bwd_dq_kernel<D><<<gq, kThreads, sm_q, s>>>(ds, k, dq, sq, sk, c0, nk, kc, hq, hkv, scale,
                                                   c0 == 0, c0 + kc >= sk, causal, window,
                                                   prefix_len, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q, o [b, sq, hq, d]; k, v [b, sk, hkv, d]; lse [b, hq, sq]: contiguous
// fp32, 16-byte aligned, d in {64, 128, 256}, hq % hkv == 0, sq, sk >= 1.
// The wrapper checks all of this.  Launches on `stream`, allocates nothing;
// returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                       float* o, float* lse, int b, int sq, int sk,
                                       int hq, int hkv, int d, float scale, int causal,
                                       int window, int prefix_len, int q_offset,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_fwd<64>(q, k, v, o, lse, b, sq, sk, hq, hkv, scale, causal, window, prefix_len, q_offset, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, b, sq, sk, hq, hkv, scale, causal, window, prefix_len, q_offset, s);
    case 256: return launch_fwd<256>(q, k, v, o, lse, b, sq, sk, hq, hkv, scale, causal, window, prefix_len, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of fp32 scratch flash_attention_bwd_f32 takes as `delta` (see
// launch_bwd): the wrapper allocates it at this size.
extern "C" long long flash_attention_bwd_scratch_floats(int b, int sq, int sk, int hq) {
  const size_t rows = static_cast<size_t>(b) * sq * hq;
  return static_cast<long long>(delta_floats(rows) + rows * ds_chunk_keys(rows, sk));
}

// The forward's operands plus dout (like o), lse from the forward, and the
// outputs dq (like q), dk, dv (like k).  `delta` is fp32 scratch of
// flash_attention_bwd_scratch_floats(b, sq, sk, hq) floats that the wrapper
// allocates.  1 + 2 x (chunks of dS) launches on `stream`, 3 while dS fits
// 64 MiB; returns the first failing launch's cudaError_t, or 0.
extern "C" int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                       const float* o, const float* lse, const float* dout,
                                       float* dq, float* dk, float* dv, float* delta,
                                       int b, int sq, int sk, int hq, int hkv, int d,
                                       float scale, int causal, int window,
                                       int prefix_len, int q_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, hq, hkv, scale, causal, window, prefix_len, q_offset, s);
    case 128: return launch_bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, hq, hkv, scale, causal, window, prefix_len, q_offset, s);
    case 256: return launch_bwd<256>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, hq, hkv, scale, causal, window, prefix_len, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
