// The flat-bucket sync kernels for Hopper.
//
// 1. sync_flat_update_f32, in place: the worker mean of one dtype bucket's
// replicas (optionally as int8 codes), the optional Nesterov outer step, the
// new anchor, and its broadcast back into every worker lane.
//
// Replaces: repro/kernels/sync_update.py `_kernel` (pallas_call in
// `sync_flat_update`).  The TPU kernel holds a [W, blk] tile of the replicas
// in VMEM and reduces over the worker axis inside the block; it writes new
// p, anchor and mu arrays.
//
// Bound on this card: per element it reads W replicas, the anchor, and the
// scale and mu when in use, and writes W replicas, the anchor and mu: (2W +
// 3) x 4 bytes quantized without momentum, against a handful of FLOPs per
// lane, so it is bound by device-memory bytes.  At ViT-B (86.3 M elements, W
// = 4) that is 3.80 GB, 1.13 ms at 3.35 TB/s.
// Design: thread v owns vector v of every operand (a float4 when n % 4 ==
// 0 and every pointer is 16-byte aligned, one float otherwise), so a warp's
// accesses are coalesced and every byte moves once.  W is a template
// argument (one instance each for W = 1..8): a thread issues the anchor's,
// the scale's, mu's and every lane's load before any arithmetic, W + 2 (W +
// 3 with mu) 16-byte loads in flight.  W > 8 takes one instance that walks
// the lanes in groups of 8, loads first within each group.  One block of
// 256 threads per 256 vectors, no grid-stride loop: blocks retire and new
// ones start as the memory system drains them.  A resident grid walking the
// buffer in a grid-stride loop streamed slower on an H100 80GB HBM3 at 700 W
// (1.52 against 1.28 ms at ViT-B W = 4, PERF.md), and no cache hint won
// (tools/kernel_variants.py).  The op sequence is
// fixed: per lane __fsub_rn, then (when quantized) __fdiv_rn by the scale,
// __fmul_rn by 127, rintf and the clip, then __fadd_rn into the lane sum in
// the order 0..W-1, __fdiv_rn by W, and apply_one below, which
// sync_apply_kernel runs too.  Every op is rounded on its own, so nvcc
// contracts nothing into an FMA: the quantized sync is bitwise its plain
// version (repro_torch/kernels/ref.py sync_flat_update; the codes are
// integers, so their sum is exact in any order, and rintf rounds halves to
// even as torch.round and jnp.round do), and the unquantized one bitwise
// the same ops taken lane by lane in that order (ref.py
// sync_flat_update_lane_order).
//
// 2. sync_apply_update_f32, out of place: the gather-leg apply of the split
// sync (overlap, partial and ring-int8): dequantize the worker-mean codes,
// the optional Nesterov outer step, and the new anchor.
//
// Replaces: repro/kernels/sync_update.py `_apply_kernel` (pallas_call in
// `sync_apply_update`), which streams [N] operands through VMEM in 256K-
// element blocks and writes new anchor and mu arrays.
//
// Bound on this card: it reads step_in and the anchor (+ scale, + mu) and
// writes the anchor (+ mu): 16 bytes per element quantized without
// momentum, 24 with it, against a few FLOPs, so device-memory bytes bound it.
// At ViT-B (86.3 M elements) that is 1.38 GB, 0.412 ms at 3.35 TB/s (2.07
// GB, 0.618 ms with momentum).
// Design: one grid-stride pass, float4 loads and stores when every operand
// is 16-byte aligned (a scalar pass otherwise).  It writes NEW anchor and mu
// buffers and leaves its inputs as they are: `RoundEngine.synced_view` runs
// this apply on the live state and must not advance the anchor or mu.  The
// op sequence after the mean is sync_flat_update_f32's, each op rounded on
// its own, so the overlap sync at depth 0 stays bitwise the blocking one.
//
// 3. sync_flat_update_bf16 / sync_apply_update_bf16: the same two passes
// on a bfloat16 bucket (the TPU kernels take the params and the anchor in
// the bucket's dtype and compute in fp32).  They load the bf16 replicas and
// anchor, run the fp32 op sequence above, and store the new anchor (and,
// for the flat sync, every lane) with round-to-nearest-even
// (__float2bfloat16_rn), as the plain versions' `.to(torch.bfloat16)`
// does; mu, the scales and step_in stay fp32.  So each is bitwise its plain
// version (the unquantized flat sync in lane order, as above).
// Bound: per element the flat sync reads W replicas and the anchor at 2
// bytes and the scale (and mu) at 4, and writes W replicas and the anchor
// at 2 (and mu at 4): (4W + 8) bytes quantized without momentum; the apply
// reads step_in and the scale at 4 and the anchor at 2 and writes the
// anchor at 2: 12 bytes.  Device-memory bytes bound both.
// Design: a simple grid-stride pass, one element a thread an iteration
// (2-byte loads); the bf16 buckets of the repo's configs are small.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kQuant, bool kMom>
__device__ __forceinline__ float apply_one(float step, float a, float s, float mu,
                                           float& mu1, float momentum) {
  if (kQuant) step = __fmul_rn(step, __fdiv_rn(s, 127.f));
  if (kMom) {
    mu1 = __fadd_rn(__fmul_rn(momentum, mu), step);
    step = __fadd_rn(__fmul_rn(momentum, mu1), step);     // Nesterov
  }
  return __fadd_rn(a, step);
}

constexpr int kFlatThreads = 256;
constexpr int kLaneGroup = 8;       // lanes a W > 8 instance loads at once

// Every global access of the flat sync goes through these two (the cache
// hints tools/kernel_variants.py times are edits of them).
template <typename T>
__device__ __forceinline__ T ld_global(const T* p) { return *p; }
template <typename T>
__device__ __forceinline__ void st_global(T* p, T v) { *p = v; }

// V = 4 floats of one operand as a float4, or V = 1 as a float.
template <int V>
__device__ __forceinline__ void load(const float* src, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = ld_global(reinterpret_cast<const float4*>(src));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = ld_global(src);
  }
}

template <int V>
__device__ __forceinline__ void store(float* dst, const float (&x)[V]) {
  if constexpr (V == 4)
    st_global(reinterpret_cast<float4*>(dst), make_float4(x[0], x[1], x[2], x[3]));
  else
    st_global(dst, x[0]);
}

struct FlatArgs {
  float* p;                 // [w, n]
  float* anchor;            // [n]
  const float* scale;       // [n] or null
  float* mu;                // [n] or null
  long long n;
  int w;
  float momentum;
};

// W lanes (W = 0: args.w, in groups of kLaneGroup), V floats an access;
// thread v owns floats [v V, v V + V) of every operand.
template <int W, int V, bool kQuant, bool kMom>
__global__ void __launch_bounds__(kFlatThreads)
sync_flat_kernel(const FlatArgs args) {
  constexpr int G = W > 0 ? W : kLaneGroup;
  float* __restrict__ p = args.p;
  float* __restrict__ anchor = args.anchor;
  const float* __restrict__ scale = args.scale;
  float* __restrict__ mu = args.mu;
  const long long n = args.n;
  const int w = W > 0 ? W : args.w;
  const float wf = static_cast<float>(w);
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v < n / V) {
    const long long i = v * V;
    float a[V], s[V] = {}, m[V] = {}, acc[V] = {};
    load<V>(anchor + i, a);
    if (kQuant) load<V>(scale + i, s);
    if (kMom) load<V>(mu + i, m);
    for (int l0 = 0; l0 < w; l0 += G) {
      float x[G][V];
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (W > 0 || l0 + j < w) load<V>(p + (l0 + j) * n + i, x[j]);
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (W > 0 || l0 + j < w) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float d = __fsub_rn(x[j][k], a[k]);
            if (kQuant)
              d = fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(d, s[k]), 127.f)), -127.f), 127.f);
            acc[k] = __fadd_rn(acc[k], d);
          }
        }
    }
    float a1[V], m1[V] = {};
#pragma unroll
    for (int k = 0; k < V; ++k)
      a1[k] = apply_one<kQuant, kMom>(__fdiv_rn(acc[k], wf), a[k], s[k], m[k], m1[k],
                                      args.momentum);
    store<V>(anchor + i, a1);
    if (kMom) store<V>(mu + i, m1);
    for (int l0 = 0; l0 < w; l0 += G)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (W > 0 || l0 + j < w) store<V>(p + (l0 + j) * n + i, a1);
  }
}

template <bool kQuant, bool kMom>
__global__ void __launch_bounds__(kThreads)
sync_apply_kernel(const float* __restrict__ step, const float* __restrict__ anchor,
                  const float* __restrict__ scale, const float* __restrict__ mu,
                  float* __restrict__ anchor_out, float* __restrict__ mu_out,
                  long long n, long long n4, float momentum) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = t0; i < n4; i += stride) {
    const float4 st = reinterpret_cast<const float4*>(step)[i];
    const float4 a = reinterpret_cast<const float4*>(anchor)[i];
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), m = s, m1 = s, a1;
    if (kQuant) s = reinterpret_cast<const float4*>(scale)[i];
    if (kMom) m = reinterpret_cast<const float4*>(mu)[i];
    a1.x = apply_one<kQuant, kMom>(st.x, a.x, s.x, m.x, m1.x, momentum);
    a1.y = apply_one<kQuant, kMom>(st.y, a.y, s.y, m.y, m1.y, momentum);
    a1.z = apply_one<kQuant, kMom>(st.z, a.z, s.z, m.z, m1.z, momentum);
    a1.w = apply_one<kQuant, kMom>(st.w, a.w, s.w, m.w, m1.w, momentum);
    reinterpret_cast<float4*>(anchor_out)[i] = a1;
    if (kMom) reinterpret_cast<float4*>(mu_out)[i] = m1;
  }
  for (long long i = n4 * 4 + t0; i < n; i += stride) {
    float m1 = 0.f;
    anchor_out[i] = apply_one<kQuant, kMom>(step[i], anchor[i], kQuant ? scale[i] : 0.f,
                                            kMom ? mu[i] : 0.f, m1, momentum);
    if (kMom) mu_out[i] = m1;
  }
}

template <int W, int V, bool kQuant, bool kMom>
int launch_flat(const FlatArgs& args, cudaStream_t stream) {
  const long long blocks = (args.n / V + kFlatThreads - 1) / kFlatThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sync_flat_kernel<W, V, kQuant, kMom>
      <<<static_cast<unsigned>(blocks), kFlatThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int V>
int launch_mode(const FlatArgs& args, cudaStream_t stream) {
  const bool quant = args.scale != nullptr, mom = args.mu != nullptr;
  if (quant && mom) return launch_flat<W, V, true, true>(args, stream);
  if (quant) return launch_flat<W, V, true, false>(args, stream);
  if (mom) return launch_flat<W, V, false, true>(args, stream);
  return launch_flat<W, V, false, false>(args, stream);
}

template <int V>
int launch_w(const FlatArgs& args, cudaStream_t stream) {
  switch (args.w) {
    case 1: return launch_mode<1, V>(args, stream);
    case 2: return launch_mode<2, V>(args, stream);
    case 3: return launch_mode<3, V>(args, stream);
    case 4: return launch_mode<4, V>(args, stream);
    case 5: return launch_mode<5, V>(args, stream);
    case 6: return launch_mode<6, V>(args, stream);
    case 7: return launch_mode<7, V>(args, stream);
    case 8: return launch_mode<8, V>(args, stream);
    default: return launch_mode<0, V>(args, stream);
  }
}

template <bool kQuant, bool kMom>
__global__ void __launch_bounds__(kThreads)
sync_flat_bf16_kernel(__nv_bfloat16* __restrict__ p, __nv_bfloat16* __restrict__ anchor,
                      const float* __restrict__ scale, float* __restrict__ mu, long long n,
                      int w, float momentum) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float wf = static_cast<float>(w);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = __bfloat162float(anchor[i]);
    const float s = kQuant ? scale[i] : 0.f;
    float acc = 0.f;
    for (int l = 0; l < w; ++l) {
      float d = __fsub_rn(__bfloat162float(p[l * n + i]), a);
      if (kQuant) d = fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(d, s), 127.f)), -127.f), 127.f);
      acc = __fadd_rn(acc, d);
    }
    float m1 = 0.f;
    const float a1 = apply_one<kQuant, kMom>(__fdiv_rn(acc, wf), a, s, kMom ? mu[i] : 0.f, m1,
                                             momentum);
    const __nv_bfloat16 b1 = __float2bfloat16_rn(a1);
    anchor[i] = b1;
    if (kMom) mu[i] = m1;
    for (int l = 0; l < w; ++l) p[l * n + i] = b1;
  }
}

template <bool kQuant, bool kMom>
__global__ void __launch_bounds__(kThreads)
sync_apply_bf16_kernel(const float* __restrict__ step, const __nv_bfloat16* __restrict__ anchor,
                       const float* __restrict__ scale, const float* __restrict__ mu,
                       __nv_bfloat16* __restrict__ anchor_out, float* __restrict__ mu_out,
                       long long n, float momentum) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float m1 = 0.f;
    const float a1 = apply_one<kQuant, kMom>(step[i], __bfloat162float(anchor[i]),
                                             kQuant ? scale[i] : 0.f, kMom ? mu[i] : 0.f, m1,
                                             momentum);
    anchor_out[i] = __float2bfloat16_rn(a1);
    if (kMom) mu_out[i] = m1;
  }
}

}  // namespace

// p [w, n], anchor [n]: contiguous fp32.  scale [n] fp32 or null (no
// quantization); mu [n] fp32 or null (no outer momentum; momentum > 0 iff mu
// is given).  Updates p, anchor and mu in place on `stream`, allocates
// nothing; returns the launch's cudaError_t.  Lane l starts at p + l * n,
// so the float4 pass needs n % 4 == 0 as well as aligned pointers.
extern "C" int sync_flat_update_f32(float* p, float* anchor, const float* scale,
                                    float* mu, long long n, int w, float momentum,
                                    void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const FlatArgs args{p, anchor, scale, mu, n, w, momentum};
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && repro::aligned(p, 16) && repro::aligned(anchor, 16) &&
                   repro::aligned(scale, 16) && repro::aligned(mu, 16);
  return vec ? launch_w<4>(args, s) : launch_w<1>(args, s);
}

// step_in, anchor [n] fp32, contiguous; scale [n] fp32 or null (step_in is
// then the mean delta itself); mu [n] fp32 or null (momentum > 0 iff mu is
// given).  Writes anchor_out [n] and, with mu, mu_out [n]; reads nothing it
// writes.  Allocates nothing; returns the launch's cudaError_t.
extern "C" int sync_apply_update_f32(const float* step_in, const float* anchor,
                                     const float* scale, const float* mu,
                                     float* anchor_out, float* mu_out, long long n,
                                     float momentum, void* stream) {
  if (n <= 0) return 0;
  const bool vec = repro::aligned(step_in, 16) && repro::aligned(anchor, 16) &&
                   repro::aligned(scale, 16) && repro::aligned(mu, 16) &&
                   repro::aligned(anchor_out, 16) && repro::aligned(mu_out, 16);
  const long long n4 = vec ? n / 4 : 0;
  const int blocks = repro::grid_blocks(vec ? n4 : n, kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const bool quant = scale != nullptr, mom = mu != nullptr;
  if (quant && mom)
    sync_apply_kernel<true, true><<<blocks, kThreads, 0, s>>>(step_in, anchor, scale, mu, anchor_out, mu_out, n, n4, momentum);
  else if (quant)
    sync_apply_kernel<true, false><<<blocks, kThreads, 0, s>>>(step_in, anchor, scale, mu, anchor_out, mu_out, n, n4, momentum);
  else if (mom)
    sync_apply_kernel<false, true><<<blocks, kThreads, 0, s>>>(step_in, anchor, scale, mu, anchor_out, mu_out, n, n4, momentum);
  else
    sync_apply_kernel<false, false><<<blocks, kThreads, 0, s>>>(step_in, anchor, scale, mu, anchor_out, mu_out, n, n4, momentum);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 instances: p [w, n] and anchor [n] contiguous bf16 (step_in,
// scale, mu fp32); otherwise as the fp32 entry points above.
extern "C" int sync_flat_update_bf16(void* p, void* anchor, const float* scale, float* mu,
                                     long long n, int w, float momentum, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* pb = static_cast<__nv_bfloat16*>(p);
  auto* ab = static_cast<__nv_bfloat16*>(anchor);
  const int blocks = repro::grid_blocks(n, kThreads);
  const bool quant = scale != nullptr, mom = mu != nullptr;
  if (quant && mom)
    sync_flat_bf16_kernel<true, true><<<blocks, kThreads, 0, s>>>(pb, ab, scale, mu, n, w, momentum);
  else if (quant)
    sync_flat_bf16_kernel<true, false><<<blocks, kThreads, 0, s>>>(pb, ab, scale, mu, n, w, momentum);
  else if (mom)
    sync_flat_bf16_kernel<false, true><<<blocks, kThreads, 0, s>>>(pb, ab, scale, mu, n, w, momentum);
  else
    sync_flat_bf16_kernel<false, false><<<blocks, kThreads, 0, s>>>(pb, ab, scale, mu, n, w, momentum);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sync_apply_update_bf16(const float* step_in, const void* anchor,
                                      const float* scale, const float* mu, void* anchor_out,
                                      float* mu_out, long long n, float momentum,
                                      void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ab = static_cast<const __nv_bfloat16*>(anchor);
  auto* ob = static_cast<__nv_bfloat16*>(anchor_out);
  const int blocks = repro::grid_blocks(n, kThreads);
  const bool quant = scale != nullptr, mom = mu != nullptr;
  if (quant && mom)
    sync_apply_bf16_kernel<true, true><<<blocks, kThreads, 0, s>>>(step_in, ab, scale, mu, ob, mu_out, n, momentum);
  else if (quant)
    sync_apply_bf16_kernel<true, false><<<blocks, kThreads, 0, s>>>(step_in, ab, scale, mu, ob, mu_out, n, momentum);
  else if (mom)
    sync_apply_bf16_kernel<false, true><<<blocks, kThreads, 0, s>>>(step_in, ab, scale, mu, ob, mu_out, n, momentum);
  else
    sync_apply_bf16_kernel<false, false><<<blocks, kThreads, 0, s>>>(step_in, ab, scale, mu, ob, mu_out, n, momentum);
  return static_cast<int>(cudaGetLastError());
}
