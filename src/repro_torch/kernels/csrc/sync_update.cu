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
// Design: one grid-stride pass; thread i owns element i of every lane, so it
// reads the W lanes (coalesced across the warp), reduces them in registers in
// the fixed order 0..W-1, and writes the new anchor to all W lanes: every
// byte moves once and nothing is allocated.  Quantized, the codes
// clip(rint(d / s * 127)) are integers, so their sum is exact in any order;
// rintf rounds halves to even as torch.round and jnp.round do.  Every op is
// rounded on its own (__fsub_rn / __fdiv_rn / __fmul_rn / __fadd_rn) so nvcc
// contracts nothing into an FMA: the quantized sync is then bitwise equal to
// its plain version (repro_torch/kernels/ref.py sync_flat_update).
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
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sync_flat_kernel(float* __restrict__ p, float* __restrict__ anchor,
                 const float* __restrict__ scale, float* __restrict__ mu,
                 long long n, int w, float momentum) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float wf = static_cast<float>(w);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float a = anchor[i];
    float acc = 0.f, step;
    if (scale != nullptr) {
      const float s = scale[i];
      for (int lane = 0; lane < w; ++lane) {
        const float d = __fsub_rn(p[static_cast<size_t>(lane) * n + i], a);
        const float code = fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(d, s), 127.f)), -127.f), 127.f);
        acc = __fadd_rn(acc, code);
      }
      step = __fmul_rn(__fdiv_rn(acc, wf), __fdiv_rn(s, 127.f));
    } else {
      for (int lane = 0; lane < w; ++lane)
        acc = __fadd_rn(acc, __fsub_rn(p[static_cast<size_t>(lane) * n + i], a));
      step = __fdiv_rn(acc, wf);
    }
    if (mu != nullptr) {
      const float mu1 = __fadd_rn(__fmul_rn(momentum, mu[i]), step);
      mu[i] = mu1;
      step = __fadd_rn(__fmul_rn(momentum, mu1), step);     // Nesterov
    }
    const float a1 = __fadd_rn(a, step);
    anchor[i] = a1;
    for (int lane = 0; lane < w; ++lane) p[static_cast<size_t>(lane) * n + i] = a1;
  }
}

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

}  // namespace

// p [w, n], anchor [n]: contiguous fp32.  scale [n] fp32 or null (no
// quantization); mu [n] fp32 or null (no outer momentum; momentum > 0 iff mu
// is given).  Updates p, anchor and mu in place on `stream`, allocates
// nothing; returns the launch's cudaError_t.
extern "C" int sync_flat_update_f32(float* p, float* anchor, const float* scale,
                                    float* mu, long long n, int w, float momentum,
                                    void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sync_flat_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, anchor, scale, mu, n, w, momentum);
  return static_cast<int>(cudaGetLastError());
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
