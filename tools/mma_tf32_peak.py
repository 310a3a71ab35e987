#!/usr/bin/env python3
"""Peak rate of `mma.sync.m16n8k8` with TF32 operands on one NVIDIA GPU.

    python3 tools/mma_tf32_peak.py

The attention kernels (`src/repro_torch/kernels/csrc/flash_attention.cu`)
run every product on this instruction in 3xTF32, so its rate caps them.
A kernel issues independent m16n8k8 products (1, 2, 4 or 8 accumulators per
warp, register operands, no memory traffic) on 4 to 32 warps per SM over
every SM; the script prints TFLOP/s and cycles per product per SM
sub-partition (at 1.755 GHz) for each, and the card's name and power limit.
Builds with `nvcc` into `src/repro_torch/kernels/_build/` (git ignores it).
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "src", "repro_torch", "kernels", "_build")
SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int CH>
__global__ void __launch_bounds__(128) mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  float c[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int iters, int ch) {
  if (ch == 1) mma_peak<1><<<blocks, 128>>>(out, iters);
  if (ch == 2) mma_peak<2><<<blocks, 128>>>(out, iters);
  if (ch == 4) mma_peak<4><<<blocks, 128>>>(out, iters);
  if (ch == 8) mma_peak<8><<<blocks, 128>>>(out, iters);
  return cudaGetLastError();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_peak: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(BUILD, exist_ok=True)
    src, lib_path = os.path.join(BUILD, "mma_peak.cu"), os.path.join(BUILD, "mma_peak.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 128, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    rows = []
    for ch in (1, 2, 4, 8):
        for per_sm in (1, 2, 4, 8):
            blocks, iters = sms * per_sm, 4096
            err = lib.run(out.data_ptr(), blocks, 64, ch)
            if err:
                raise RuntimeError(f"mma_peak launch failed: cudaError {err}")
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            lib.run(out.data_ptr(), blocks, iters, ch)
            e.record()
            torch.cuda.synchronize()
            ms = s.elapsed_time(e)
            n = blocks * 4 * iters * ch              # products, 4 warps a block
            rows.append(dict(accumulators=ch, warps_per_sm=4 * per_sm,
                             tflops=n * 2048 / ms / 1e9,
                             cycles_per_mma_per_subpartition=ms * 1.755e6 * sms * 4 / n))
            print(json.dumps(rows[-1]), flush=True)
    print(smi.stdout.strip())
    print(json.dumps({"peak_tflops": max(r["tflops"] for r in rows),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
