// Single-query GQA decode attention for Hopper (online softmax, fp32).
//
// Replaces: repro/kernels/flash_attention.py `_decode_kernel` (pallas_call in
// `flash_decode`).  The TPU kernel walks the key blocks as its innermost
// sequential grid axis and carries the softmax state in VMEM scratch from one
// grid step to the next.  Hopper runs blocks in parallel and in no order, so
// here the walk over key tiles is a loop inside one block.
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
// Bound on this card: every K and V row of the cache is read once, 8 * Sk *
// Hkv * D bytes per batch row against ~4 * g * D FLOPs per key, so the kernel
// is bound by device-memory bytes.
// Design: one 256-thread block per (batch row, kv head).  The block keeps its
// whole GQA group's [g, D] query tile in shared memory, so the g query heads
// share one read of each K/V row.  Per tile of kTileK keys: (1) each warp
// takes 8 adjacent keys, issues all their K loads (float4s) before any
// arithmetic, then reduces g dot products per key with shuffles; (2) warp gi
// updates query head gi's running max / denominator and turns its scores into
// probabilities; (3) threads own float4 columns of D, split the tile's keys
// into groups, load 8 V rows at a time and rescale + accumulate P.V in fp32
// registers.  The key groups are summed through shared memory at the end.
// Issuing the loads in batches keeps ~16 loads in flight per thread: with so
// few blocks, memory latency, not bandwidth, is what a block waits on.
// Known limit: B * Hkv blocks (16 at 4 slots of gemma3-4b) fill few of the
// 132 SMs, so a long cache cannot reach the bytes bound; splitting the keys
// across blocks (split-K with a merge pass) is the first thing a later
// change should add.
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;        // keys per tile (2 per lane in step 2)
constexpr int kMaxG = 8;          // query heads per kv head
constexpr int kKeysPerWarp = kTileK / kWarps;   // 8 keys per warp in step 1
constexpr int kVBatch = 8;        // V rows loaded together in step 3
constexpr float kMasked = -1e30f;

// NV: float4s of one K row per lane (ceil(D / 128)), a template argument so
// the batched loads stay in registers.
template <int NV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    const int* __restrict__ q_offset,
                    const int* __restrict__ k_positions, int sk, int hkv,
                    int g, int d, int window, int prefix_len, float scale,
                    int causal) {
  extern __shared__ float smem[];
  float* qs = smem;               // [g][d]; reused for the final reduction
  float* ps = smem + g * d;       // [g][kTileK] scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = hkv * g, d4 = d >> 2;
  const size_t key_stride = static_cast<size_t>(hkv) * d;
  const float* qb = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  const float* kb = k + static_cast<size_t>(b) * sk * key_stride + static_cast<size_t>(h) * d;
  const float* vb = v + static_cast<size_t>(b) * sk * key_stride + static_cast<size_t>(h) * d;
  const int qpos = q_offset[b];

  for (int i = tid; i < g * d; i += kThreads) qs[i] = qb[i];
  if (tid < g) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }

  // step-3 layout: `groups` key groups of d4 threads, one float4 column each
  const int groups = kThreads / d4;
  const int grp = tid / d4, col4 = tid % d4;
  float4 acc[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  for (int t0 = 0; t0 < sk; t0 += kTileK) {
    const int nk = min(kTileK, sk - t0);

    // (1) scores of this tile: warp w owns keys [8w, 8w + 8); all K loads
    // of a batch of keys are issued before the first dot product
    constexpr int kBatch = (16 / NV) < kKeysPerWarp ? (16 / NV) : kKeysPerWarp;
#pragma unroll
    for (int jb = 0; jb < kKeysPerWarp; jb += kBatch) {
      float4 kv[kBatch][NV];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = warp * kKeysPerWarp + jb + u;
        const float4* kr = reinterpret_cast<const float4*>(kb + (t0 + j) * key_stride);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int i = lane + 32 * c;
          kv[u][c] = (j < nk && i < d4) ? __ldg(kr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = warp * kKeysPerWarp + jb + u;
        float dot[kMaxG];
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) dot[gi] = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int i = lane + 32 * c;
          if (i < d4) {
#pragma unroll
            for (int gi = 0; gi < kMaxG; ++gi) {
              if (gi < g) {
                const float4 q4 = reinterpret_cast<const float4*>(qs + gi * d)[i];
                dot[gi] = fmaf(q4.x, kv[u][c].x, dot[gi]);
                dot[gi] = fmaf(q4.y, kv[u][c].y, dot[gi]);
                dot[gi] = fmaf(q4.z, kv[u][c].z, dot[gi]);
                dot[gi] = fmaf(q4.w, kv[u][c].w, dot[gi]);
              }
            }
          }
        }
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < g) dot[gi] = repro::warp_sum(dot[gi]);
        if (lane == 0) {
          const bool in_range = j < nk;
          bool ok = false;
          if (in_range) {
            const int kpos = k_positions ? k_positions[t0 + j] : t0 + j;
            const bool valid = kpos >= 0;
            ok = valid;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (prefix_len > 0) ok = ok || (valid && kpos < prefix_len);
          }
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi)
            if (gi < g)
              ps[gi * kTileK + j] = !in_range ? -INFINITY : (ok ? dot[gi] * scale : kMasked);
        }
      }
    }
    __syncthreads();

    // (2) online softmax: warp gi owns query head gi
    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = ps + gi * kTileK;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(s0, s1)));
      const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
      const float psum = repro::warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[gi] = a;
        l_s[gi] = l_s[gi] * a + psum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // (3) rescale and accumulate P.V
    if (grp < groups) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float a = alpha_s[gi];
          acc[gi].x *= a; acc[gi].y *= a; acc[gi].z *= a; acc[gi].w *= a;
        }
      }
      for (int jb = grp; jb < nk; jb += groups * kVBatch) {
        float4 vv[kVBatch];
#pragma unroll
        for (int u = 0; u < kVBatch; ++u) {
          const int j = jb + groups * u;
          vv[u] = j < nk ? __ldg(reinterpret_cast<const float4*>(vb + (t0 + j) * key_stride) + col4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kVBatch; ++u) {
          const int j = jb + groups * u;
          if (j < nk) {
#pragma unroll
            for (int gi = 0; gi < kMaxG; ++gi) {
              if (gi < g) {
                const float p = ps[gi * kTileK + j];
                acc[gi].x = fmaf(p, vv[u].x, acc[gi].x);
                acc[gi].y = fmaf(p, vv[u].y, acc[gi].y);
                acc[gi].z = fmaf(p, vv[u].z, acc[gi].z);
                acc[gi].w = fmaf(p, vv[u].w, acc[gi].w);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the key groups into qs (the query tile is no longer needed)
  for (int r = 0; r < groups; ++r) {
    if (grp == r) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          float4* dst = reinterpret_cast<float4*>(qs + gi * d) + col4;
          if (r == 0) {
            *dst = acc[gi];
          } else {
            float4 t = *dst;
            t.x += acc[gi].x; t.y += acc[gi].y; t.z += acc[gi].z; t.w += acc[gi].w;
            *dst = t;
          }
        }
      }
    }
    __syncthreads();
  }
  float* ob = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    const float l = l_s[i / d];
    ob[i] = qs[i] / (l == 0.f ? 1.f : l);
  }
}

}  // namespace

// q, out [b, 1, hq, d]; k, v [b, sk, hkv, d]: contiguous fp32, 16-byte
// aligned, d % 4 == 0, 4 <= d <= 1024, hq = hkv * g with g <= 8.  q_offset
// int32 [b]; k_positions int32 [sk] or null (= arange).  The wrapper checks
// all of this.  Launches on `stream`, allocates nothing; returns the
// launch's cudaError_t.
extern "C" int flash_decode_f32(const float* q, const float* k, const float* v,
                                float* out, const int* q_offset,
                                const int* k_positions, int b, int sk, int hq,
                                int hkv, int d, int window, int prefix_len,
                                float scale, int causal, void* stream) {
  if (b <= 0) return 0;
  const int g = hq / hkv;
  const size_t shmem = static_cast<size_t>(g) * (d + kTileK) * sizeof(float);
  const dim3 grid(hkv, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d4 = d / 4;
#define REPRO_LAUNCH(NV)                                                     \
  flash_decode_kernel<NV><<<grid, kThreads, shmem, s>>>(                     \
      q, k, v, out, q_offset, k_positions, sk, hkv, g, d, window, prefix_len, \
      scale, causal)
  if (d4 <= 32) REPRO_LAUNCH(1);
  else if (d4 <= 64) REPRO_LAUNCH(2);
  else if (d4 <= 128) REPRO_LAUNCH(4);
  else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
