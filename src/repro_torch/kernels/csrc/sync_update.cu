// Fused flat-bucket sync for Hopper, in place: the worker mean of one dtype
// bucket's replicas (optionally as int8 codes), the optional Nesterov outer
// step, the new anchor, and its broadcast back into every worker lane.
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
#include <cuda_runtime.h>

#include <cmath>

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
