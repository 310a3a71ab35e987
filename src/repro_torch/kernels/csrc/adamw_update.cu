// Fused AdamW update for Hopper, in place: p, m, v <- AdamW(p, m, v, g).
//
// Replaces: repro/kernels/adamw_update.py `_adamw_kernel` (pallas_call in
// `adamw_update`).  The TPU kernel streams p, m, v, g through VMEM in 64K-
// element blocks and writes new p, m, v arrays; lr and step ride in as a
// runtime scalar operand so the kernel is not respecialised per step.
//
// Bound on this card: 28 bytes per element (read p, m, v, g; write p, m, v)
// against ~15 FLOPs, so it is bound by device-memory bytes; at ViT-B's
// 86.3 M parameters x 4 workers that is 9.67 GB, 2.89 ms at 3.35 TB/s.
// Design: one grid-stride pass, 16-byte (float4) loads and stores, updating
// in place so no output buffer is allocated and every byte moves once.  lr,
// step and the betas are runtime arguments.  The arithmetic is the
// reference's op order (repro/kernels/ref.py adamw_update), each op rounded
// on its own (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn): nvcc would
// otherwise contract a*b + c into one FMA, which the plain version's separate
// torch ops do not do.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, wd, step;
};

__device__ __forceinline__ void adamw_one(float& p, float& m, float& v, float g,
                                          const Hyper& h, float bc1, float bc2) {
  const float m1 = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.one_minus_beta1, g));
  const float v1 = __fadd_rn(__fmul_rn(h.beta2, v), __fmul_rn(h.one_minus_beta2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(__fdiv_rn(m1, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), h.eps));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(upd, __fmul_rn(h.wd, p))));
  m = m1;
  v = v1;
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ g, long long n, Hyper h) {
  const float bc1 = 1.f - powf(h.beta1, h.step);
  const float bc2 = 1.f - powf(h.beta2, h.step);
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = __ldg(g4 + i);
    adamw_one(pp.x, mm.x, vv.x, gg.x, h, bc1, bc2);
    adamw_one(pp.y, mm.y, vv.y, gg.y, h, bc1, bc2);
    adamw_one(pp.z, mm.z, vv.z, gg.z, h, bc1, bc2);
    adamw_one(pp.w, mm.w, vv.w, gg.w, h, bc1, bc2);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (long long i = n4 * 4 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    adamw_one(p[i], m[i], v[i], g[i], h, bc1, bc2);
}

}  // namespace

// p, m, v, g: n contiguous fp32 elements each, 16-byte aligned (the wrapper
// checks).  step is the 1-based update count as a float; one_minus_beta* are
// 1 - beta* rounded once from double, as the plain version's Python floats
// are.  Updates p, m, v in place on `stream`, allocates nothing; returns the
// launch's cudaError_t.
extern "C" int adamw_update_f32(float* p, float* m, float* v, const float* g,
                                long long n, float lr, float beta1, float beta2,
                                float one_minus_beta1, float one_minus_beta2,
                                float eps, float weight_decay, float step,
                                void* stream) {
  if (n <= 0) return 0;
  const Hyper h{lr, beta1, beta2, one_minus_beta1, one_minus_beta2, eps, weight_decay, step};
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  adamw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, m, v, g, n, h);
  return static_cast<int>(cudaGetLastError());
}
