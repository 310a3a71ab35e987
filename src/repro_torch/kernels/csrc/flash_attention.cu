// Full-sequence GQA flash attention for Hopper, forward and backward, fp32.
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
// Bound on this card: at ViT-B's shapes ([32,196,12,64]) the forward does
// 4 * S^2 * D FLOPs per (batch row, head) against 16 * S * D bytes, ~50
// FLOP/B — above the fp32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20), so
// it is bound by operations.
// Design: 256 threads as a 16 x 16 grid; tiles of 64 queries x 64 keys (32 x
// 32 at head_dim 256) staged in shared memory with rows padded to D + 1
// floats, so the strided column reads below are free of bank conflicts.
// Each thread owns a (BQ/16) x (BK/16) block of the score tile and a
// (BQ/16) x (D/16) block of the output, rows and columns interleaved by 16.
// The products run on the fp32 CUDA cores from shared memory (about two
// FMAs per shared load), which holds the kernel to a fraction of the fp32
// peak; wgmma tiles (TF32 or bf16) are the later step, and they change the
// numerics, which is why this one does not take them.
//
// Forward: writes O and the per-row log-sum-exp [B, Hq, Sq] (m + log l).
// Backward (three launches): (1) D = rowsum(dO * O); (2) one block per (batch
// row, kv head, key tile) recomputes P = exp(S - lse) for every query tile
// and every query head of its group and accumulates dV += P^T dO and dK +=
// dS^T Q, dS = P * (dO V^T - D); (3) one block per (batch row, query head,
// query tile) accumulates dQ += dS K.  No atomics: every output element has
// one owner, so the backward is deterministic.  A row with no allowed key
// (lse at -1e30) has P = 1/Sk on every key and dS = 0, as the reference's
// `where` gives it.
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;
constexpr float kDeadRow = -1e29f;     // lse at or below: no allowed key

template <int D>
struct Tiles {
  static constexpr int BQ = D <= 128 ? 64 : 32;
  static constexpr int BK = BQ;
  static constexpr int LD = D + 1;     // smem row stride of a [*, D] tile
  static constexpr int LP = BK + 1;    // smem row stride of a [BQ, BK] tile
  static constexpr int RQ = BQ / 16;   // query rows per thread
  static constexpr int RK = BK / 16;   // key rows per thread (dK/dV)
  static constexpr int CK = BK / 16;   // key columns per thread (scores)
  static constexpr int CD = D / 16;    // head-dim columns per thread
};

__device__ __forceinline__ bool allowed(int kpos, int qpos, int causal,
                                        int window, int prefix_len) {
  bool ok = true;
  if (causal) ok = kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  if (prefix_len > 0) ok = ok || kpos < prefix_len;
  return ok;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + rows) of one head of a [*, S, H, D] tensor (base points
// at that batch row and head; row_stride = H * D) into a padded smem tile
// [rows][D + 1]; rows at or past s_len read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int row0, int rows, int s_len,
                                          size_t row_stride) {
  constexpr int D4 = D / 4;
  for (int idx = threadIdx.x; idx < rows * D4; idx += kThreads) {
    const int r = idx / D4, c = (idx % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s_len)
      x = __ldg(reinterpret_cast<const float4*>(base + static_cast<size_t>(row0 + r) * row_stride + c));
    float* t = dst + r * (D + 1) + c;
    t[0] = x.x; t[1] = x.y; t[2] = x.z; t[3] = x.w;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over padded smem tiles.
template <int D, int R, int C>
__device__ __forceinline__ void tile_dot(float (&s)[R][C], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, int hq, int hkv,
              float scale, int causal, int window, int prefix_len,
              int q_offset) {
  using T = Tiles<D>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + T::BQ * T::LD;
  float* vs = ks + T::BK * T::LD;
  float* ps = vs + T::BK * T::LD;

  const int q0 = blockIdx.x * T::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qstride = static_cast<size_t>(hq) * D;
  const size_t kstride = static_cast<size_t>(hkv) * D;
  const float* qb = q + static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  load_tile<D>(qs, qb, q0, T::BQ, sq, qstride);

  float m[T::RQ], l[T::RQ], acc[T::RQ][T::CD];
#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::CD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += T::BK) {
    __syncthreads();
    load_tile<D>(ks, kb, k0, T::BK, sk, kstride);
    load_tile<D>(vs, vb, k0, T::BK, sk, kstride);
    __syncthreads();

    float s[T::RQ][T::CK];
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < T::RQ; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < T::CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = kj >= sk ? -INFINITY
                           : (allowed(kj, qpos, causal, window, prefix_len) ? s[i][j] * scale : kMasked);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < T::CK; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * T::LP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < T::CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < T::BK; ++kk) {
      float pv[T::RQ], vv[T::CD];
#pragma unroll
      for (int i = 0; i < T::RQ; ++i) pv[i] = ps[(ty + 16 * i) * T::LP + kk];
#pragma unroll
      for (int c = 0; c < T::CD; ++c) vv[c] = vs[kk * T::LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < T::RQ; ++i)
#pragma unroll
        for (int c = 0; c < T::CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(qi) * qstride +
                  static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < T::CD; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
    if (tx == 0) lse[(static_cast<size_t>(b) * hq + h) * sq + qi] = m[i] + logf(denom);
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row.
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                    float* __restrict__ delta, int rows, int sq, int hq) {
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
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

// P and dS of one (query tile, key tile) pair for this thread's block of the
// tile.  lse_r / dl_r are the rows' log-sum-exp and delta.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    float (&p)[Tiles<D>::RQ][Tiles<D>::CK], float (&ds)[Tiles<D>::RQ][Tiles<D>::CK],
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_r, const float* dl_r, int q0, int k0, int sq, int sk,
    float scale, int causal, int window, int prefix_len, int q_offset,
    int ty, int tx) {
  using T = Tiles<D>;
  float dp[T::RQ][T::CK];
  tile_dot<D>(p, qs, ks, ty, tx);
  tile_dot<D>(dp, dos, vs, ty, tx);
  const float inv_sk = 1.f / static_cast<float>(sk);
#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < T::CK; ++j) {
      const int kj = k0 + tx + 16 * j;
      float pij = 0.f, dsij = 0.f;
      if (qi < sq && kj < sk) {
        if (lse_r[i] <= kDeadRow) {
          pij = inv_sk;             // no allowed key: uniform weights, no score gradient
        } else if (allowed(kj, q_offset + qi, causal, window, prefix_len)) {
          pij = expf(p[i][j] * scale - lse_r[i]);
          dsij = pij * (dp[i][j] - dl_r[i]);
        }
      }
      p[i][j] = pij;
      ds[i][j] = dsij;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                   int hq, int hkv, float scale, int causal, int window,
                   int prefix_len, int q_offset) {
  using T = Tiles<D>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + T::BK * T::LD;
  float* qs = vs + T::BK * T::LD;
  float* dos = qs + T::BQ * T::LD;
  float* ps = dos + T::BQ * T::LD;
  float* dss = ps + T::BQ * T::LP;

  const int k0 = blockIdx.x * T::BK, hk = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qstride = static_cast<size_t>(hq) * D;
  const size_t kstride = static_cast<size_t>(hkv) * D;
  const size_t koff = static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  load_tile<D>(ks, k + koff, k0, T::BK, sk, kstride);
  load_tile<D>(vs, v + koff, k0, T::BK, sk, kstride);

  float dka[T::RK][T::CD], dva[T::RK][T::CD];
#pragma unroll
  for (int i = 0; i < T::RK; ++i)
#pragma unroll
    for (int c = 0; c < T::CD; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    const size_t qoff = static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(h) * D;
    const float* lse_h = lse + (static_cast<size_t>(b) * hq + h) * sq;
    const float* dl_h = delta + (static_cast<size_t>(b) * hq + h) * sq;
    for (int q0 = 0; q0 < sq; q0 += T::BQ) {
      __syncthreads();
      load_tile<D>(qs, q + qoff, q0, T::BQ, sq, qstride);
      load_tile<D>(dos, dout + qoff, q0, T::BQ, sq, qstride);
      __syncthreads();

      float lse_r[T::RQ], dl_r[T::RQ];
#pragma unroll
      for (int i = 0; i < T::RQ; ++i) {
        const int qi = q0 + ty + 16 * i;
        lse_r[i] = qi < sq ? lse_h[qi] : 0.f;
        dl_r[i] = qi < sq ? dl_h[qi] : 0.f;
      }
      float p[T::RQ][T::CK], ds[T::RQ][T::CK];
      probs_and_dscores<D>(p, ds, qs, dos, ks, vs, lse_r, dl_r, q0, k0, sq, sk,
                           scale, causal, window, prefix_len, q_offset, ty, tx);
#pragma unroll
      for (int i = 0; i < T::RQ; ++i)
#pragma unroll
        for (int j = 0; j < T::CK; ++j) {
          ps[(ty + 16 * i) * T::LP + tx + 16 * j] = p[i][j];
          dss[(ty + 16 * i) * T::LP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV[key][d] += P[r][key] dO[r][d]; dK[key][d] += dS[r][key] Q[r][d]
#pragma unroll 4
      for (int r = 0; r < T::BQ; ++r) {
        float pv[T::RK], dsv[T::RK], dov[T::CD], qv[T::CD];
#pragma unroll
        for (int i = 0; i < T::RK; ++i) {
          pv[i] = ps[r * T::LP + ty + 16 * i];
          dsv[i] = dss[r * T::LP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < T::CD; ++c) {
          dov[c] = dos[r * T::LD + tx + 16 * c];
          qv[c] = qs[r * T::LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < T::RK; ++i)
#pragma unroll
          for (int c = 0; c < T::CD; ++c) {
            dva[i][c] = fmaf(pv[i], dov[c], dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < T::RK; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= sk) continue;
    const size_t off = koff + static_cast<size_t>(kj) * kstride;
#pragma unroll
    for (int c = 0; c < T::CD; ++c) {
      dk[off + tx + 16 * c] = dka[i][c] * scale;
      dv[off + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int sq, int sk, int hq, int hkv,
                 float scale, int causal, int window, int prefix_len,
                 int q_offset) {
  using T = Tiles<D>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + T::BQ * T::LD;
  float* ks = dos + T::BQ * T::LD;
  float* vs = ks + T::BK * T::LD;
  float* dss = vs + T::BK * T::LD;

  const int q0 = blockIdx.x * T::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qstride = static_cast<size_t>(hq) * D;
  const size_t kstride = static_cast<size_t>(hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * sq * qstride + static_cast<size_t>(h) * D;
  const size_t koff = static_cast<size_t>(b) * sk * kstride + static_cast<size_t>(hk) * D;
  load_tile<D>(qs, q + qoff, q0, T::BQ, sq, qstride);
  load_tile<D>(dos, dout + qoff, q0, T::BQ, sq, qstride);

  float lse_r[T::RQ], dl_r[T::RQ], dqa[T::RQ][T::CD];
#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    const size_t row = (static_cast<size_t>(b) * hq + h) * sq + qi;
    lse_r[i] = qi < sq ? lse[row] : 0.f;
    dl_r[i] = qi < sq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < T::CD; ++c) dqa[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += T::BK) {
    __syncthreads();
    load_tile<D>(ks, k + koff, k0, T::BK, sk, kstride);
    load_tile<D>(vs, v + koff, k0, T::BK, sk, kstride);
    __syncthreads();
    float p[T::RQ][T::CK], ds[T::RQ][T::CK];
    probs_and_dscores<D>(p, ds, qs, dos, ks, vs, lse_r, dl_r, q0, k0, sq, sk,
                         scale, causal, window, prefix_len, q_offset, ty, tx);
#pragma unroll
    for (int i = 0; i < T::RQ; ++i)
#pragma unroll
      for (int j = 0; j < T::CK; ++j) dss[(ty + 16 * i) * T::LP + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < T::BK; ++kk) {
      float dsv[T::RQ], kv[T::CD];
#pragma unroll
      for (int i = 0; i < T::RQ; ++i) dsv[i] = dss[(ty + 16 * i) * T::LP + kk];
#pragma unroll
      for (int c = 0; c < T::CD; ++c) kv[c] = ks[kk * T::LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < T::RQ; ++i)
#pragma unroll
        for (int c = 0; c < T::CD; ++c) dqa[i][c] = fmaf(dsv[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < T::RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    float* row = dq + qoff + static_cast<size_t>(qi) * qstride;
#pragma unroll
    for (int c = 0; c < T::CD; ++c) row[tx + 16 * c] = dqa[i][c] * scale;
  }
}

template <int D>
size_t fwd_smem() {
  using T = Tiles<D>;
  return sizeof(float) * (T::BQ * T::LD + 2 * T::BK * T::LD + T::BQ * T::LP);
}

template <int D>
size_t dkdv_smem() {
  using T = Tiles<D>;
  return sizeof(float) * (2 * T::BK * T::LD + 2 * T::BQ * T::LD + 2 * T::BQ * T::LP);
}

template <int D>
size_t dq_smem() {
  using T = Tiles<D>;
  return sizeof(float) * (2 * T::BQ * T::LD + 2 * T::BK * T::LD + T::BQ * T::LP);
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o,
                       float* lse, int b, int sq, int sk, int hq, int hkv,
                       float scale, int causal, int window, int prefix_len,
                       int q_offset, cudaStream_t s) {
  const size_t shmem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Tiles<D>::BQ - 1) / Tiles<D>::BQ, hq, b);
  fa_fwd_kernel<D><<<grid, kThreads, shmem, s>>>(q, k, v, o, lse, sq, sk, hq, hkv, scale, causal,
                                                 window, prefix_len, q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* lse, const float* dout, float* dq, float* dk,
                       float* dv, float* delta, int b, int sq, int sk, int hq,
                       int hkv, float scale, int causal, int window,
                       int prefix_len, int q_offset, cudaStream_t s) {
  const int rows = b * sq * hq;
  const int warps = kThreads / 32;
  fa_bwd_delta_kernel<D><<<(rows + warps - 1) / warps, kThreads, 0, s>>>(o, dout, delta, rows, sq, hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t sm_kv = dkdv_smem<D>();
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm_kv));
  if (err != cudaSuccess) return err;
  const dim3 gkv((sk + Tiles<D>::BK - 1) / Tiles<D>::BK, hkv, b);
  fa_bwd_dkdv_kernel<D><<<gkv, kThreads, sm_kv, s>>>(q, k, v, dout, lse, delta, dk, dv, sq, sk, hq,
                                                     hkv, scale, causal, window, prefix_len, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t sm_q = dq_smem<D>();
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm_q));
  if (err != cudaSuccess) return err;
  const dim3 gq((sq + Tiles<D>::BQ - 1) / Tiles<D>::BQ, hq, b);
  fa_bwd_dq_kernel<D><<<gq, kThreads, sm_q, s>>>(q, k, v, dout, lse, delta, dq, sq, sk, hq, hkv,
                                                 scale, causal, window, prefix_len, q_offset);
  return cudaGetLastError();
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

// The forward's operands plus dout (like o), lse from the forward, and the
// outputs dq (like q), dk, dv (like k); delta [b, hq, sq] fp32 is scratch the
// wrapper allocates.  Three launches on `stream`; returns the first failing
// launch's cudaError_t, or 0.
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
