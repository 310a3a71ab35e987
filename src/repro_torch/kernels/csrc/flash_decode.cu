// Single-query GQA decode attention for Hopper: split-K over the SMs, fp32.
//
// Replaces: repro/kernels/flash_attention.py `_decode_kernel` (pallas_call in
// `flash_decode`).  The TPU kernel walks the key blocks as its innermost
// sequential grid axis and carries the softmax state in VMEM scratch from one
// grid step to the next.  Hopper runs blocks in parallel and in no order, so
// here the keys of one (batch row, kv head) are cut into splits, each split
// is a block that walks its key tiles in a loop, and a second kernel merges
// the splits' partial states.
//
// Semantics follow repro/kernels/ref.py `_mask`/`attention`: key position
// kpos = k_positions[j] (or j when null; -1 marks an empty ring slot), valid
// = kpos >= 0, ok = valid && (!causal || kpos <= qpos) && (window <= 0 ||
// kpos > qpos - window), or valid && kpos < prefix_len.  Masked scores are
// the finite -1e30, so a row with no valid key gets the mean of V over the Sk
// keys, as the reference does.  Query head h reads kv head h / g.  window,
// q_offset ([B]), k_positions and prefix_len are runtime arguments: one
// kernel serves every layer, slot and ring state.
//
// Bound on this card: each K and V row a row's mask allows is read once,
// 8 * D bytes per key and kv head against ~4 * g * D FLOPs, so the kernel is
// bound by device-memory bytes.  What the design does about it:
//
// * Split-K.  A call launches `splits` blocks per (batch row, kv head), a
//   number taken from Sk alone (`num_splits`: one per 2 units of 64 keys,
//   at most 64), so a long cache fills the 132 SMs at any batch.  Each block
//   writes its partial (m, l, acc[g, D]) to a scratch the wrapper allocates;
//   `decode_merge_kernel` joins them in split order and divides by l.  A row
//   whose keys fit one split (Sk <= 128, or a short window) is stored by
//   that block, and with one split per row the call is one launch.
//   tools/kernel_variants.py measured the other choices (PERF.md): finer or
//   coarser splits, a deeper ring, the merge by the last block to finish.
// * Masked tiles skipped.  With no ring positions the keys a row may attend
//   are [lo, hi] = [max(0, qpos - window + 1), min(qpos, Sk - 1)] and [0,
//   prefix_len), from q_offset[b] read on the device.  The splits cover only
//   the hull of those keys, and a split skips each tile that holds none of
//   them.  A row with no allowed key, or a ring cache (positions in no
//   order), walks all Sk.
// * Batched equals solo.  The split boundaries are a function of Sk and of
//   the row's own interval only (`split_range`; the wrapper's
//   `decode_split_plan` is a Python model of it for the CPU tests, held
//   against `flash_decode_split_range` on the card), and each split and the
//   merge sum in a fixed order, so a row's output is bitwise the same at
//   any B and beside any other rows.
// * cp.async.  K and V tiles stream through a 2-stage shared-memory ring of
//   16-byte copies (zero-filled past Sk): the next tile is in flight while
//   this one is reduced.  The GQA group's g query heads share each tile.
// * Per tile, when the group's query and P.V sum fit 16 registers a lane
//   (kPerWarp, G x NV <= 4: g <= 2 at D <= 256, as gemma3-4b has; g <= 4 at
//   D <= 128; g = 1 at D <= 512): warp w owns kTile / 8 keys of every tile
//   and keeps its own running max, denominator and P.V sum in registers, the
//   query in registers too, so a tile costs no barrier but the ring's; the
//   8 warps' states join through shared memory at the end, in warp order.  A
//   live row's masked keys score -inf there (weight 0).  Otherwise (the
//   block-wide loop): (1) each warp reduces g dot products for its keys with
//   shuffles; (2) warp gi updates query head gi's running max and
//   denominator; (3) threads own float4 columns of D and accumulate P.V over
//   groups of keys, summed through shared memory at the end.  Every tile
//   that loop walks holds an allowed key, so a masked key's weight is
//   exp(-1e30 - m) = 0 exactly.  Both skip zero weights, so a masked key's
//   V row is never multiplied, even when it is not finite.
// * Groups up to 16 query heads per kv head: instances G = 1, 2, 4, 8 and
//   16, g rounded up (starcoder2-3b's g = 12 runs G = 16, 4 heads idle).
//   At D <= 128 the G = 16 block-wide loop keeps the query, its P.V sums
//   and the dot products in registers (ptxas: 203 a thread, no spill).
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;          // query heads per kv head
constexpr int kSplitKeys = 64;     // split boundaries fall on multiples of this
constexpr int kUnitsPerSplit = 2;  // a split's share of kSplitKeys units
constexpr int kMaxSplits = 64;     // blocks per (batch row, kv head) at most
constexpr int kStages = 2;         // depth of the cp.async ring
constexpr int kPerWarpMax = 4;     // G * NV up to which warps own whole keys
constexpr float kMasked = -1e30f;

// Blocks per (batch row, kv head) at a cache of sk rows: one per
// kUnitsPerSplit units of kSplitKeys keys, at most kMaxSplits.
__host__ __device__ int num_splits(int sk) {
  const int units = (sk + kSplitKeys - 1) / kSplitKeys;
  const int want = (units + kUnitsPerSplit - 1) / kUnitsPerSplit;
  return want < kMaxSplits ? (want > 0 ? want : 1) : kMaxSplits;
}

// keys per tile: 32 KB of K and V per stage at D = 128 / 256 / 512, 64 KB at
// D = 1024 (NV = float4s of one K row per lane)
template <int NV>
__host__ __device__ constexpr int tile_keys() { return NV == 1 ? 32 : NV == 2 ? 16 : 8; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The keys a row may attend when the cache has no ring positions: [lo, hi]
// (empty when lo > hi) joined with [0, pre).  `skip`: the row has one, so the
// kernel walks only the tiles that hold one.
struct Allowed {
  long long lo, hi;
  int pre;
  bool skip;
};

__host__ __device__ Allowed allowed_keys(int sk, int qpos, int causal, int window,
                                         int prefix_len, bool ring) {
  Allowed a;
  const long long from = static_cast<long long>(qpos) - window + 1, last = sk - 1LL;
  a.lo = window > 0 && from > 0 ? from : 0LL;
  a.hi = causal && qpos < last ? static_cast<long long>(qpos) : last;
  a.pre = prefix_len > 0 ? (prefix_len < sk ? prefix_len : sk) : 0;
  a.skip = !ring && (a.lo <= a.hi || a.pre > 0);
  return a;
}

// The row's active splits na, and the keys [k0, k1) of split s < na: the
// row's n units of kSplitKeys keys (the hull of its allowed keys when it
// skips, else all Sk) spread over na = min(splits, ceil(n / kUnitsPerSplit))
// splits, split s taking units [u0 + s n / na, u0 + (s + 1) n / na).
__host__ __device__ int split_range(int s, int splits, int sk, const Allowed& a, int* k0,
                                    int* k1) {
  long long first = 0, last = sk - 1;
  if (a.skip) {
    if (a.pre > 0) {
      last = a.lo <= a.hi && a.hi > a.pre - 1 ? a.hi : a.pre - 1;
    } else {
      first = a.lo;
      last = a.hi;
    }
  }
  const int u0 = static_cast<int>(first / kSplitKeys);
  const int n = static_cast<int>(last / kSplitKeys) - u0 + 1;
  const int want = (n + kUnitsPerSplit - 1) / kUnitsPerSplit;
  const int na = splits < want ? splits : want;
  const int end = (u0 + (s + 1) * n / na) * kSplitKeys;
  *k0 = (u0 + s * n / na) * kSplitKeys;
  *k1 = end < sk ? end : sk;
  return na;
}

// The first tile start >= t (a multiple of TK) that holds an allowed key, or
// k1 when none is left before it.
template <int TK>
__host__ __device__ __forceinline__ int next_tile(int t, int k1, const Allowed& a) {
  if (!a.skip || t < a.pre) return t;
  if (a.lo > a.hi || t > a.hi) return k1;
  if (t + TK - 1 < a.lo) t = static_cast<int>(a.lo / TK) * TK;
  return t;
}

// The merge of query head gi of one (batch row, kv head):
// out = sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - M), M = max_s
// m_s, over the splits in order; a split marked m = -inf (every tile
// skipped) adds nothing.  Warp 0 finds the weights and the denominator (two
// splits per lane, then the butterfly); then `parts` threads share each
// float4 column, each a contiguous run of the splits read kBatch at a time,
// and the runs' sums join in run order.
__device__ void merge_head(const float* pacc, const float* pml, float* ob, int gi, int g,
                           int d, int splits) {
  constexpr int kBatch = 8;
  static_assert(kMaxSplits <= 64, "the merge reads two splits per lane");
  __shared__ float w_s[64], den_s;
  __shared__ float4 part_s[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, d4 = d >> 2;
  if (tid < 32) {
    float m[2], l[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = lane + 32 * u;
      m[u] = s < splits ? pml[s * 2 * g + gi] : -INFINITY;
      l[u] = m[u] != -INFINITY ? pml[s * 2 * g + g + gi] : 0.f;
    }
    const float mx = repro::warp_max(fmaxf(m[0], m[1]));
    const float w0 = m[0] == -INFINITY ? 0.f : expf(m[0] - mx);
    const float w1 = m[1] == -INFINITY ? 0.f : expf(m[1] - mx);
    const float den = repro::warp_sum(fmaf(w1, l[1], w0 * l[0]));
    w_s[lane] = w0;
    w_s[lane + 32] = w1;
    if (lane == 0) den_s = den == 0.f ? 1.f : den;
  }
  __syncthreads();
  const int parts = d4 >= kThreads ? 1 : min(kThreads / d4, 4);
  const int stride = kThreads / parts, per = (splits + parts - 1) / parts;
  const float4* pa = reinterpret_cast<const float4*>(pacc) + gi * d4;
  float4* o4 = reinterpret_cast<float4*>(ob) + gi * d4;
  for (int c0 = 0; c0 < d4; c0 += stride) {
    const int c = c0 + tid % stride, run = tid / stride;
    const bool mine = c < d4 && run < parts;
    const int s_end = min(splits, (run + 1) * per);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = run * per; mine && s0 < s_end; s0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u;
        x[u] = s < s_end && w_s[s] != 0.f ? pa[static_cast<size_t>(s) * g * d4 + c]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u;
        const float w = s < s_end ? w_s[s] : 0.f;
        if (w != 0.f) {
          num.x = fmaf(w, x[u].x, num.x);
          num.y = fmaf(w, x[u].y, num.y);
          num.z = fmaf(w, x[u].z, num.z);
          num.w = fmaf(w, x[u].w, num.w);
        }
      }
    }
    part_s[tid] = num;
    __syncthreads();
    if (mine && run == 0) {
      for (int r = 1; r < parts; ++r) {
        const float4 y = part_s[tid + r * stride];
        num.x += y.x; num.y += y.y; num.z += y.z; num.w += y.w;
      }
      o4[c] = make_float4(num.x / den_s, num.y / den_s, num.z / den_s, num.w / den_s);
    }
    __syncthreads();
  }
}

// NV: float4s of one K row per lane (ceil(D / 128)); G: query heads per kv
// head rounded up to a power of two (g <= G; heads >= g are idle).
template <int NV, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ part, const int* __restrict__ q_offset,
                    const int* __restrict__ k_positions, int sk, int hkv, int g, int d,
                    int window, int prefix_len, float scale, int causal, int splits) {
  constexpr int TK = tile_keys<NV>();
  constexpr int kKeysPerWarp = TK / kWarps;
  constexpr bool kQInRegs = G * NV <= 16;
  constexpr bool kPerWarp = G * NV <= kPerWarpMax;   // see the per-warp loop
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);   // [kStages][K, V][TK][d]
  float* const qs = ring + kStages * 2 * TK * d;           // [g][d]: q, then the sum
  float* const ps = qs + G * d;                            // [G][TK] scores, then P
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = hkv * g, d4 = d >> 2;
  const size_t key_stride = static_cast<size_t>(hkv) * d;
  const size_t bh = static_cast<size_t>(b) * hkv + h;
  const float* qb = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  float4 qr[G][NV];                        // the query, when kQInRegs: asked for
  if constexpr (kQInRegs) {                // beside q_offset, which the plan needs
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int i = lane + 32 * c;
        qr[gi][c] = gi < g && i < d4 ? __ldg(reinterpret_cast<const float4*>(qb + gi * d) + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  }
  const int qpos = q_offset[b];
  const Allowed a = allowed_keys(sk, qpos, causal, window, prefix_len, k_positions != nullptr);
  float* const ob = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  float* const pacc = part + bh * splits * g * d;          // [splits][g][d]
  float* const pml = part + static_cast<size_t>(gridDim.y) * hkv * splits * g * d +
                     bh * splits * 2 * g;                  // [splits][m[g], l[g]]
  int k0 = 0, k1 = 0;
  const int na = split_range(s, splits, sk, a, &k0, &k1);
  if (s >= na) return;                     // the row needs fewer splits
  {
    const float* kb = k + static_cast<size_t>(b) * sk * key_stride + static_cast<size_t>(h) * d;
    const float* vb = v + static_cast<size_t>(b) * sk * key_stride + static_cast<size_t>(h) * d;

    // this thread's 16-byte copies of a tile, the same for every tile:
    // row r_u of the tile, float column c_u (r_u = TK: no copy)
    constexpr int kCopies = (TK * 32 * NV + kThreads - 1) / kThreads;
    int r_u[kCopies], c_u[kCopies];
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int i = tid + u * kThreads, r = i / d4;
      r_u[u] = i < TK * d4 ? r : TK;
      c_u[u] = (i - r * d4) * 4;
    }
    auto load = [&](int t0, int stage) {
      float* ks = ring + stage * 2 * TK * d;
      float* vs = ks + TK * d;
      const float* kt = kb + static_cast<size_t>(t0) * key_stride;
      const float* vt = vb + static_cast<size_t>(t0) * key_stride;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        if (r_u[u] < TK) {
          const bool ok = t0 + r_u[u] < sk;
          const size_t off = ok ? static_cast<size_t>(r_u[u]) * key_stride + c_u[u] : 0;
          cp_async16(ks + r_u[u] * d + c_u[u], (ok ? kt : kb) + off, ok);
          cp_async16(vs + r_u[u] * d + c_u[u], (ok ? vt : vb) + off, ok);
        }
      }
    };

    // the ring: tile i of the split's walk computes from stage i % kStages
    // while tiles i + 1 .. i + kStages - 1 are in flight
    int t = next_tile<TK>(k0, k1, a), t_load = t;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (t_load < k1) {
        load(t_load, i);
        t_load = next_tile<TK>(t_load + TK, k1, a);
      }
      cp_commit();
    }

    if constexpr (kPerWarp) {
      // warp w owns keys [w kKeysPerWarp, (w + 1) kKeysPerWarp) of every
      // tile, with its own softmax state and P.V sum in registers: a tile
      // costs no barrier but the ring's.  A live row's masked keys score
      // -inf (weight 0, V row never multiplied); a dead or ring row's the
      // finite -1e30 (the mean of V when no key is valid).
      const float masked = a.skip ? -INFINITY : kMasked;
      float mw[G], lw[G];
      float4 aw[G][NV];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        mw[gi] = -INFINITY;
        lw[gi] = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) aw[gi][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int it = 0; t < k1; ++it) {
        cp_wait<kStages - 2>();
        __syncthreads();
        if (t_load < k1) {
          load(t_load, (it + kStages - 1) % kStages);
          t_load = next_tile<TK>(t_load + TK, k1, a);
        }
        cp_commit();
        const float* ks = ring + (it % kStages) * 2 * TK * d;
        const float* vs = ks + TK * d;
        const int nk = min(TK, sk - t);
        float p[kKeysPerWarp][G];
#pragma unroll
        for (int u = 0; u < kKeysPerWarp; ++u) {
          const int j = warp * kKeysPerWarp + u;
          const float4* kr = reinterpret_cast<const float4*>(ks + j * d);
          float dot[G];
#pragma unroll
          for (int gi = 0; gi < G; ++gi) dot[gi] = 0.f;
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            const int i = lane + 32 * c;
            if (i < d4) {
              const float4 kv = kr[i];
#pragma unroll
              for (int gi = 0; gi < G; ++gi) {
                dot[gi] = fmaf(qr[gi][c].x, kv.x, dot[gi]);
                dot[gi] = fmaf(qr[gi][c].y, kv.y, dot[gi]);
                dot[gi] = fmaf(qr[gi][c].z, kv.z, dot[gi]);
                dot[gi] = fmaf(qr[gi][c].w, kv.w, dot[gi]);
              }
            }
          }
          bool ok = false;
          if (j < nk) {
            const int kpos = k_positions ? k_positions[t + j] : t + j;
            const bool valid = kpos >= 0;
            ok = valid;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (prefix_len > 0) ok = ok || (valid && kpos < prefix_len);
          }
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float sc = repro::warp_sum(dot[gi]);
            p[u][gi] = j >= nk ? -INFINITY : (ok ? sc * scale : masked);
          }
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float mx = mw[gi];
#pragma unroll
          for (int u = 0; u < kKeysPerWarp; ++u) mx = fmaxf(mx, p[u][gi]);
          const float al = mx == -INFINITY ? 1.f : expf(mw[gi] - mx);
          float psum = 0.f;
#pragma unroll
          for (int u = 0; u < kKeysPerWarp; ++u) {
            p[u][gi] = p[u][gi] == -INFINITY ? 0.f : expf(p[u][gi] - mx);
            psum += p[u][gi];
          }
          lw[gi] = lw[gi] * al + psum;
          mw[gi] = mx;
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            aw[gi][c].x *= al; aw[gi][c].y *= al; aw[gi][c].z *= al; aw[gi][c].w *= al;
          }
        }
#pragma unroll
        for (int u = 0; u < kKeysPerWarp; ++u) {
          const int j = warp * kKeysPerWarp + u;
          const float4* vr = reinterpret_cast<const float4*>(vs + j * d);
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            const int i = lane + 32 * c;
            if (j < nk && i < d4) {
              const float4 vv = vr[i];
#pragma unroll
              for (int gi = 0; gi < G; ++gi) {
                const float pw = p[u][gi];
                if (pw != 0.f) {
                  aw[gi][c].x = fmaf(pw, vv.x, aw[gi][c].x);
                  aw[gi][c].y = fmaf(pw, vv.y, aw[gi][c].y);
                  aw[gi][c].z = fmaf(pw, vv.z, aw[gi][c].z);
                  aw[gi][c].w = fmaf(pw, vv.w, aw[gi][c].w);
                }
              }
            }
          }
        }
        t = next_tile<TK>(t + TK, k1, a);
      }
      cp_wait<0>();
      __syncthreads();                     // the ring is free: the warps' sums
      __shared__ float mw_s[kWarps][kMaxG], lw_s[kWarps][kMaxG];
      float* red = ring;                   // [kWarps][g][d]
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < g) {
          if (lane == 0) {
            mw_s[warp][gi] = mw[gi];
            lw_s[warp][gi] = lw[gi];
          }
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            const int i = lane + 32 * c;
            if (i < d4) reinterpret_cast<float4*>(red + (warp * g + gi) * d)[i] = aw[gi][c];
          }
        }
      }
      __syncthreads();
      // joined in warp order as the splits are: weights exp(m_w - M)
      for (int e = tid; e < g * d4; e += kThreads) {
        const int gi = e / d4, col = e - gi * d4;
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw_s[w][gi]);
        float den = 0.f;
        float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (mw_s[w][gi] != -INFINITY) {
            const float ew = expf(mw_s[w][gi] - mx);
            const float4 x = reinterpret_cast<const float4*>(red + (w * g + gi) * d)[col];
            den = fmaf(ew, lw_s[w][gi], den);
            num.x = fmaf(ew, x.x, num.x);
            num.y = fmaf(ew, x.y, num.y);
            num.z = fmaf(ew, x.z, num.z);
            num.w = fmaf(ew, x.w, num.w);
          }
        }
        if (na == 1) {                     // the whole row: divide and store
          const float dv = den == 0.f ? 1.f : den;
          reinterpret_cast<float4*>(ob)[e] =
              make_float4(num.x / dv, num.y / dv, num.z / dv, num.w / dv);
        } else {
          reinterpret_cast<float4*>(pacc + s * g * d)[e] = num;
          if (col == 0) {
            pml[s * 2 * g + gi] = mx;      // -inf when nothing was walked
            pml[s * 2 * g + g + gi] = den;
          }
        }
      }
      if (na == 1) return;
    } else {
      const bool any = t < k1;
      if constexpr (!kQInRegs)
        for (int i = tid; i < g * d; i += kThreads) qs[i] = qb[i];
      if (tid < g) {
        m_s[tid] = kMasked;
        l_s[tid] = 0.f;
      }

      // step-3 layout: `groups` key groups of d4 threads, one float4 column each
      const int groups = kThreads / d4;
      const int grp = tid / d4, col4 = tid % d4;
      float4 acc[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) acc[gi] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();

      for (int it = 0; t < k1; ++it) {
        // tile it has landed, and every thread is done with tile it - 1, whose
        // stage takes tile it + kStages - 1
        cp_wait<kStages - 2>();
        __syncthreads();
        if (t_load < k1) {
          load(t_load, (it + kStages - 1) % kStages);
          t_load = next_tile<TK>(t_load + TK, k1, a);
        }
        cp_commit();
        const float* ks = ring + (it % kStages) * 2 * TK * d;
        const float* vs = ks + TK * d;
        const int nk = min(TK, sk - t);

        // (1) scores: warp w owns keys [w * kKeysPerWarp, (w + 1) * kKeysPerWarp)
#pragma unroll
        for (int u = 0; u < kKeysPerWarp; ++u) {
          const int j = warp * kKeysPerWarp + u;
          const float4* kr = reinterpret_cast<const float4*>(ks + j * d);
          float dot[G];
#pragma unroll
          for (int gi = 0; gi < G; ++gi) dot[gi] = 0.f;
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            const int i = lane + 32 * c;
            if (i < d4) {
              const float4 kv = kr[i];
#pragma unroll
              for (int gi = 0; gi < G; ++gi) {
                if (gi < g) {
                  float4 q4;
                  if constexpr (kQInRegs) q4 = qr[gi][c];
                  else q4 = reinterpret_cast<const float4*>(qs + gi * d)[i];
                  dot[gi] = fmaf(q4.x, kv.x, dot[gi]);
                  dot[gi] = fmaf(q4.y, kv.y, dot[gi]);
                  dot[gi] = fmaf(q4.z, kv.z, dot[gi]);
                  dot[gi] = fmaf(q4.w, kv.w, dot[gi]);
                }
              }
            }
          }
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            if (gi < g) dot[gi] = repro::warp_sum(dot[gi]);
          if (lane == 0) {
            const bool in_range = j < nk;
            bool ok = false;
            if (in_range) {
              const int kpos = k_positions ? k_positions[t + j] : t + j;
              const bool valid = kpos >= 0;
              ok = valid;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              if (prefix_len > 0) ok = ok || (valid && kpos < prefix_len);
            }
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              if (gi < g) ps[gi * TK + j] = !in_range ? -INFINITY : (ok ? dot[gi] * scale : kMasked);
          }
        }
        __syncthreads();

        // (2) online softmax: warp gi owns query head gi
        for (int gi = warp; gi < g; gi += kWarps) {
          float* row = ps + gi * TK;
          const float sv = lane < TK ? row[lane] : -INFINITY;
          const float m_old = m_s[gi];
          const float m_new = fmaxf(m_old, repro::warp_max(sv));
          const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
          const float psum = repro::warp_sum(p);
          if (lane < TK) row[lane] = p;
          if (lane == 0) {
            const float al = expf(m_old - m_new);
            alpha_s[gi] = al;
            l_s[gi] = l_s[gi] * al + psum;
            m_s[gi] = m_new;
          }
        }
        __syncthreads();

        // (3) rescale and accumulate P.V
        if (grp < groups) {
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (gi < g) {
              const float al = alpha_s[gi];
              acc[gi].x *= al; acc[gi].y *= al; acc[gi].z *= al; acc[gi].w *= al;
            }
          }
          for (int j = grp; j < nk; j += groups) {
            const float4 vv = reinterpret_cast<const float4*>(vs + j * d)[col4];
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
              if (gi < g) {
                const float p = ps[gi * TK + j];
                if (p != 0.f) {
                  acc[gi].x = fmaf(p, vv.x, acc[gi].x);
                  acc[gi].y = fmaf(p, vv.y, acc[gi].y);
                  acc[gi].z = fmaf(p, vv.z, acc[gi].z);
                  acc[gi].w = fmaf(p, vv.w, acc[gi].w);
                }
              }
            }
          }
        }
        t = next_tile<TK>(t + TK, k1, a);
      }
      cp_wait<0>();

      // sum the key groups into qs (the query tile is no longer needed)
      for (int r = 0; r < groups; ++r) {
        if (grp == r) {
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (gi < g) {
              float4* dst = reinterpret_cast<float4*>(qs + gi * d) + col4;
              if (r == 0) {
                *dst = acc[gi];
              } else {
                float4 x = *dst;
                x.x += acc[gi].x; x.y += acc[gi].y; x.z += acc[gi].z; x.w += acc[gi].w;
                *dst = x;
              }
            }
          }
        }
        __syncthreads();
      }
      if (na == 1) {                         // the whole row: divide and store
        for (int i = tid; i < g * d; i += kThreads) {
          const float l = l_s[i / d];
          ob[i] = qs[i] / (l == 0.f ? 1.f : l);
        }
        return;
      }
      for (int i = tid; i < g * d; i += kThreads) pacc[s * g * d + i] = qs[i];
      if (tid < g) {
        pml[s * 2 * g + tid] = any ? m_s[tid] : -INFINITY;   // -inf: merge skips it
        pml[s * 2 * g + g + tid] = l_s[tid];
      }
    }
  }
}

// The second launch: one block per (kv head, batch row, query head of the
// group) merges that head's partials over the row's na active splits.  A
// row with one active split stored its output itself.
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                    const int* __restrict__ q_offset, const int* __restrict__ k_positions,
                    int sk, int hkv, int g, int d, int window, int prefix_len, int causal,
                    int splits) {
  const int h = blockIdx.x, b = blockIdx.y, gi = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * hkv + h;
  const Allowed a = allowed_keys(sk, q_offset[b], causal, window, prefix_len,
                                 k_positions != nullptr);
  int k0, k1;
  const int na = split_range(0, splits, sk, a, &k0, &k1);
  if (na == 1) return;                     // its one split stored the output
  merge_head(part + bh * splits * g * d,
             part + static_cast<size_t>(gridDim.y) * hkv * splits * g * d + bh * splits * 2 * g,
             out + bh * g * d, gi, g, d, na);
}

template <int NV, int G>
cudaError_t launch_split(const float* q, const float* k, const float* v, float* out,
                         float* part, const int* q_offset, const int* k_positions, int b,
                         int sk, int hkv, int g, int d, int window, int prefix_len,
                         float scale, int causal, int splits, cudaStream_t s) {
  constexpr int TK = tile_keys<NV>();
  const size_t shmem = sizeof(float) * (kStages * 2 * TK * d + G * d + G * TK);
  const auto kernel = decode_split_kernel<NV, G>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(hkv, b, splits), kThreads, shmem, s>>>(
      q, k, v, out, part, q_offset, k_positions, sk, hkv, g, d, window, prefix_len, scale,
      causal, splits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  decode_merge_kernel<<<dim3(hkv, b, g), kThreads, 0, s>>>(
      part, out, q_offset, k_positions, sk, hkv, g, d, window, prefix_len, causal, splits);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_nv(const float* q, const float* k, const float* v, float* out,
                      float* part, const int* q_offset, const int* k_positions, int b,
                      int sk, int hkv, int g, int d, int window, int prefix_len, float scale,
                      int causal, int splits, cudaStream_t s) {
#define REPRO_LAUNCH(G)                                                                      \
  launch_split<NV, G>(q, k, v, out, part, q_offset, k_positions, b, sk, hkv, g, d, window, \
                      prefix_len, scale, causal, splits, s)
  if (g <= 1) return REPRO_LAUNCH(1);
  if (g <= 2) return REPRO_LAUNCH(2);
  if (g <= 4) return REPRO_LAUNCH(4);
  if (g <= 8) return REPRO_LAUNCH(8);
  return REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

}  // namespace

// q, out [b, 1, hq, d]; k, v [b, sk, hkv, d]: contiguous fp32, 16-byte
// aligned, d % 4 == 0, 4 <= d <= 1024, hq = hkv * g with g <= 16.  q_offset
// int32 [b]; k_positions int32 [sk] or null (= arange).  num_splits(sk)
// blocks per (batch row, kv head); with more than one, `part` is fp32
// scratch of flash_decode_scratch_floats(b, hq, sk, d) floats (the partial
// accumulators [b][hkv][splits][g][d], then m and l [b][hkv][splits][2][g])
// and a second launch merges them.  The wrapper checks the rest.  Launches
// on `stream`, allocates nothing; returns the first failing launch's
// cudaError_t, or 0.
extern "C" int flash_decode_f32(const float* q, const float* k, const float* v,
                                float* out, float* part, const int* q_offset,
                                const int* k_positions, int b, int sk, int hq, int hkv,
                                int d, int window, int prefix_len, float scale,
                                int causal, void* stream) {
  if (b <= 0) return 0;
  const int splits = num_splits(sk);
  if (splits > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv, d4 = d / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define REPRO_ARGS q, k, v, out, part, q_offset, k_positions, b, sk, hkv, g, d, window, \
                   prefix_len, scale, causal, splits, s
  if (d4 <= 32) e = launch_nv<1>(REPRO_ARGS);
  else if (d4 <= 64) e = launch_nv<2>(REPRO_ARGS);
  else if (d4 <= 128) e = launch_nv<4>(REPRO_ARGS);
  else e = launch_nv<8>(REPRO_ARGS);
#undef REPRO_ARGS
  return static_cast<int>(e);
}

// Floats of the scratch `part` that flash_decode_f32 needs (0: none).
extern "C" long long flash_decode_scratch_floats(int b, int hq, int sk, int d) {
  const int splits = num_splits(sk);
  return splits > 1 ? static_cast<long long>(b) * hq * splits * (d + 2) : 0;
}

// The plan, on the host, for a row at query position qpos: the keys [k0,
// k1) of split s, and the row's active splits as the return value.
extern "C" int flash_decode_split_range(int sk, int qpos, int causal, int window,
                                        int prefix_len, int ring, int s, int* k0, int* k1) {
  const Allowed a = allowed_keys(sk, qpos, causal, window, prefix_len, ring != 0);
  return split_range(s, num_splits(sk), sk, a, k0, k1);
}

// The plan, on the host: the first tile start >= t of `tk` keys (32, 16 or
// 8: tile_keys at the row's head dim) that the row walks before k1, or k1.
extern "C" int flash_decode_next_tile(int t, int k1, int tk, int sk, int qpos, int causal,
                                      int window, int prefix_len, int ring) {
  const Allowed a = allowed_keys(sk, qpos, causal, window, prefix_len, ring != 0);
  if (tk == 32) return next_tile<32>(t, k1, a);
  if (tk == 16) return next_tile<16>(t, k1, a);
  return next_tile<8>(t, k1, a);
}
