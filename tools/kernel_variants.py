#!/usr/bin/env python3
"""Build variants of the serving kernels (`flash_decode`, `rms_norm`,
`swiglu`), of the backward kernels (`rms_norm_bwd`, `swiglu_bwd`) and of
the flat sync (`sync_flat_update`) and time them side by side with the
source.

    python3 tools/kernel_variants.py [--step] [--only=KERNEL] \
        [VARIANT | file:PATH[,PATH] ...]

A variant is `src/repro_torch/kernels/csrc/flash_decode.cu`, `rmsnorm.cu`,
`rmsnorm_bwd.cu`, `swiglu.cu` or `sync_update.cu` with a few regex
substitutions (`VARIANTS`
below), or `file:PATH`, whole other sources of these kernels (which one: the C
function a source defines; several joined by commas form one variant), such
as an earlier commit's, written out first with `git show REV:src/
repro_torch/kernels/csrc/flash_decode.cu > _dev/fd.cu` (a copy of the tree
without `.git` cannot run it).  A `flash_decode_f32` from before split-K (no
`flash_decode_scratch_floats` beside it) is called with its own interface.  The
patterns match the source's text: after an edit of a kernel a variant that
no longer matches stops the run with its pattern.  Each variant is compiled
by its own `nvcc` into `src/repro_torch/kernels/_build/variants/` (git
ignores it), all at once, with the source's headers beside it, and loaded
with ctypes beside the unchanged library (`base`).

For every `rms_norm`, `swiglu` and `flash_decode` case of chip_smoke.py, and
`swiglu` at gemma3-4b's widths at the row counts where its row and tile
paths meet (`SWIGLU_ROWS`), each variant
is held against the plain version at chip_smoke's tolerance (`rms_norm`
also bitwise against the base: `rf_*` variants of its rows past 3072
floats, or the parent's source as `file:`, keep the base's sum order, so
their output is bitwise the same); at every case
chip_smoke times, the variants and the source are timed in turns (each
variant, the source, the source, each variant again) with chip_smoke's
`Timer`, the library call once beside them, and a read-only sum over 64
MiB with the same `Timer` as the rate a plain stream of reads reaches
after its flush; at the long decode shapes each launch's device time is
read from `torch.profiler`.  With `--step`, the device ms of one
full-width gemma3-4b decode step (chip_smoke's `device_step_ms`, a CUDA
graph) at the main path's 2 slots x 64 and at the long 8 slots x 4096 is
taken with each variant's kernels in the wrappers' place, in the same
turns.  `sync_flat_update` is held and timed at chip_smoke's rows (the four
modes at [4, 86,332,648] and the quantized one at W = 2): quantized
bitwise against the plain version, unquantized bitwise against its ops in
lane order (`ref.sync_flat_update_lane_order`), timed in the same turns as
chip_smoke times it (`ms`: the lanes already equal to the anchor after the
first call) and on fresh deltas (`fresh_ms`: the lanes and anchor restored
before each launch, outside the events), beside a copy of as many bytes
(half read, half written) with the same `Timer`: the streaming rate this
card reaches.  `swiglu_bwd` (`sb_*` variants, or the `swiglu` ones, which
touch its source too) is held at gemma3-4b's [1024, 2560] x [2560, 10240]
and [2048, ...] from the pair the base's forward keeps, against the plain
backward on it and bitwise against the base (the k-order of every sum is
the tile's own, so a variant that changes only where the gate is formed or
which tile runs keeps the bits), and timed in the same turns whole, with
only dW's products asked for (`gate_dw_ms`: the gate's launch, where the
variant has one, and dW's) and with only dX's (`gate_dx_ms`), beside the
library's grad.  `rms_norm_bwd` (`rb_*` variants, or an earlier source as
`file:`, e.g. `git show HEAD~1:src/repro_torch/kernels/csrc/rmsnorm_bwd.cu
> _dev/rb_parent.cu`) is held at [1024, d] for d = 2560, 5120 and 8192:
dx against the plain version and bitwise against the base, dscale within
chip_smoke's `dscale_tol` and by its RMS error against an fp64 sum, a
second call bitwise; timed in the same turns beside `F.rms_norm`'s grad,
with each launch's device time from a profile (`launch_ms`).
`--only=KERNEL` (`rms_norm`, `swiglu`, `flash_decode`, `sync_flat_update`,
`rms_norm_bwd` or `swiglu_bwd`) keeps that kernel's cases alone, and with
no variant named builds only the variants of that kernel's source.  One
JSON line per variant, then the library and copy times and the card's
name and power limit.  Needs one CUDA card.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "src", "repro_torch", "kernels", "_build", "variants")
FD, RN, RB, SW, SU = ("flash_decode.cu", "rmsnorm.cu", "rmsnorm_bwd.cu",
                      "swiglu.cu", "sync_update.cu")
# C function of each kernel file, and the kernel chip_smoke names it by
ENTRY = {FD: "flash_decode_f32", RB: "rmsnorm_bwd_f32", RN: "rmsnorm_f32",
         SW: "swiglu_f32", SU: "sync_flat_update_f32"}
KERNEL = {"flash_decode": FD, "rms_norm": RN, "rms_norm_bwd": RB,
          "swiglu": SW, "sync_flat_update": SU, "swiglu_bwd": SW}
# rms_norm_bwd's rows: gemma3-4b's, phi3-medium-14b's and qwen1.5-110b's
# widths at one lane's 1 x 1024 tokens
RMS_BWD_D = (2560, 5120, 8192)
# sync_flat_update's rows: (W, quantize, momentum) at chip_smoke's N
SYNC_ROWS = ((4, True, 0.0), (4, False, 0.0), (4, True, 0.9),
             (4, False, 0.9), (2, True, 0.0))
# swiglu row counts timed beside chip_smoke's (16, 48, 128, 256, 4096): the
# threshold between the row kernel and the tiles lies among them
SWIGLU_ROWS = (9, 12, 32, 64)
SW_CVT_SPLIT = """
__device__ __forceinline__ void split_cvt(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}
__device__ __forceinline__ repro::FragA frag_a_cvt(float a0, float a1, float a2,
                                                   float a3) {
  repro::FragA f;
  split_cvt(a0, f.hi[0], f.lo[0]);
  split_cvt(a1, f.hi[1], f.lo[1]);
  split_cvt(a2, f.hi[2], f.lo[2]);
  split_cvt(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ repro::FragB frag_b_cvt(float b0, float b1) {
  repro::FragB f;
  split_cvt(b0, f.hi[0], f.lo[0]);
  split_cvt(b1, f.hi[1], f.lo[1]);
  return f;
}
"""
SU_LD = r"T ld_global\(const T\* p\) \{ return \*p; \}"
SU_ST = r"void st_global\(T\* p, T v\) \{ \*p = v; \}"
# loads that allocate no L1 line (inline PTX; the template's overloads)
SU_NO_ALLOCATE = """\
__device__ __forceinline__ float4 ld_global(const float4* p) {
  float4 r;
  asm("ld.global.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(p));
  return r;
}
__device__ __forceinline__ float ld_global(const float* p) {
  float r;
  asm("ld.global.L1::no_allocate.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}"""
SW_SUM2_HELPER = """
__device__ __forceinline__ void mma3_acc(float (&d)[4], const repro::FragA& a,
                                         const repro::FragB& b) {
  repro::mma_tf32(d, a.lo, b.hi);
  repro::mma_tf32(d, a.hi, b.lo);
  repro::mma_tf32(d, a.hi, b.hi);
}
"""
SW_SUM2_BODY = """#pragma unroll
    for (int ks = 0; ks < kK / 8; ks += 2) {
      repro::FragA a[2][MT];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (FULL || i < mt_act) {
            const float* ap = xs + (wrow + 16 * i + g) * LDX + 8 * (ks + s) + t;
            a[s][i] = repro::frag_a(ap[0], ap[8 * LDX], ap[4], ap[8 * LDX + 4]);
          }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        repro::FragB bg[2], bu[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int bo = (8 * (ks + s) + t) * LDW + wcol + 8 * j + g;
          bg[s] = repro::frag_b(gs[bo], gs[bo + 4 * LDW]);
          bu[s] = repro::frag_b(us[bo], us[bo + 4 * LDW]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (FULL || i < mt_act) {
            float p[4];
            repro::mma3_zero(p, a[0][i], bg[0]);
            mma3_acc(p, a[1][i], bg[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) cg[i][j][e] += p[e];
            repro::mma3_zero(p, a[0][i], bu[0]);
            mma3_acc(p, a[1][i], bu[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) cu[i][j][e] += p[e];
          }
      }
    }
  };
"""
# swiglu_bwd's operand split with lo rounded to nearest too (not left for
# the tensor core to truncate), and a fourth product lo*lo
SB_RN_SPLIT = """
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ repro::FragA frag_a_rn(float a0, float a1, float a2,
                                                  float a3) {
  repro::FragA f;
  split_rn(a0, f.hi[0], f.lo[0]);
  split_rn(a1, f.hi[1], f.lo[1]);
  split_rn(a2, f.hi[2], f.lo[2]);
  split_rn(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ repro::FragB frag_b_rn(float b0, float b1) {
  repro::FragB f;
  split_rn(b0, f.hi[0], f.lo[0]);
  split_rn(b1, f.hi[1], f.lo[1]);
  return f;
}
__device__ __forceinline__ void mma4_zero(float (&d)[4], const repro::FragA& a,
                                          const repro::FragB& b) {
  repro::mma_tf32_zero(d, a.lo, b.lo);
  repro::mma_tf32(d, a.lo, b.hi);
  repro::mma_tf32(d, a.hi, b.lo);
  repro::mma_tf32(d, a.hi, b.hi);
}
"""
SB_RN = {r"repro::frag_a\((?=ap\[0\], ap\[8\],|hs\[o\]|as\[o\])": "frag_a_rn(",
         r"repro::frag_b\((?=bs\[bo\]|sp\[bo\])": "frag_b_rn(",
         r"// Tag: every m16 tile": SB_RN_SPLIT + "// Tag: every m16 tile"}
# swiglu_bwd with dg = dh p and du = dh q formed in the product tiles, as
# each operand fragment is read from shared memory, in place of written
# once by the gate kernel into the scratch: the kernels take dh (from a
# host-side static the C entry sets) as a third ring chunk, and read p and
# q where they read dg and du
SB_GATE_IN_TILES = {
    r"// dg = dh p and du = dh q, written once":
        "static const float* sb_dh;   // dh, for the launches below\n\n"
        "// dg = dh p and du = dh q, written once",
    r"swiglu_dw_kernel\(const float\* __restrict__ x,":
        "swiglu_dw_kernel(const float* __restrict__ sb_h, "
        "const float* __restrict__ x,",
    r"swiglu_dx_kernel\(const float\* __restrict__ s0,":
        "swiglu_dx_kernel(const float* __restrict__ sb_h, "
        "const float* __restrict__ s0,",
    r"stream>>>\(x, s0, s1, dw0, dw1": "stream>>>(sb_dh, x, s0, s1, dw0, dw1",
    r"stream>>>\(s0, s1, wg, wi, dx": "stream>>>(sb_dh, s0, s1, wg, wi, dx",
    # dW: dh's chunk after the NP operands' chunks, multiplied in
    r"DwSmem<T, NP>": "DwSmem<T, NP + 1>",
    r"(cp_async16\(bs \+ \(b \* kK \+ r\) \* LDB \+ c, src\[b\] \+ off, ok\);)":
        r"\1" "\n        cp_async16(bs + (NP * kK + r) * LDB + c, sb_h + off, ok);",
    r"b\[p\] = repro::frag_b\(sp\[bo\], sp\[bo \+ 4 \* LDB\]\);":
        "b[p] = repro::frag_b(bs[NP * kK * LDB + bo] * sp[bo],\n"
        "                     bs[NP * kK * LDB + bo + 4 * LDB] * sp[bo + 4 * LDB]);",
    # dX: dh's chunk after the operand's, multiplied in
    r"STAGE = T::BM \* LDA \+ T::BN \* LDB;": "STAGE = 2 * T::BM * LDA + T::BN * LDB;",
    r"float\* bs = as \+ BM \* LDA;": "float* bs = as + 2 * BM * LDA;",
    r"(cp_async16\(as \+ r \* LDA \+ c, sa \+ off, ok\);)":
        r"\1" "\n        cp_async16(as + BM * LDA + r * LDA + c, sb_h + off, ok);",
    r"a\[s\]\[i\] = repro::frag_a\(as\[o\], as\[o \+ 8 \* LDA\], as\[o \+ 4\],\n"
    r"\s*as\[o \+ 8 \* LDA \+ 4\]\);":
        "a[s][i] = repro::frag_a(\n"
        "              as[BM * LDA + o] * as[o],\n"
        "              as[BM * LDA + o + 8 * LDA] * as[o + 8 * LDA],\n"
        "              as[BM * LDA + o + 4] * as[o + 4],\n"
        "              as[BM * LDA + o + 8 * LDA + 4] * as[o + 8 * LDA + 4]);",
    # no gate launch: the tiles read p and q with dh
    r"float\* dg = scratch;\n  float\* du = scratch \+ static_cast<size_t>\(n\) \* f;\n"
    r"  gate_kernel<<<[^;]*;\n  int err = static_cast<int>\(cudaGetLastError\(\)\);":
        "const float* dg = p;\n  const float* du = q;\n  sb_dh = dh;\n"
        "  int err = 0;\n  (void)n4;",
}
# rms_norm_bwd in two launches: the rows (and each block's partial row) in
# an ordinary launch, then dscale's column stripes in a second, one block a
# stripe
RB_TWO_LAUNCH = {
    re.escape("  cg::this_grid().sync();     // also a block barrier: acc "
              "is free again\n  reduce_stripes(partial, dscale, gridDim.x, "
              "d, acc);"): "",
    re.escape("using Kernel = void (*)("):
        "__global__ void __launch_bounds__(kThreads)\n"
        "rb_reduce_kernel(const float* partial, float* dscale, int rows, "
        "int d) {\n  __shared__ float red[kRedStripes * kThreads];\n"
        "  reduce_stripes(partial, dscale, rows, d, red);\n}\n\n"
        "using Kernel = void (*)(",
    r"err = cudaLaunchCooperativeKernel\(": "err = cudaLaunchKernel(",
    re.escape("  if (err != cudaSuccess) return static_cast<int>(err);\n"
              "  return static_cast<int>(cudaGetLastError());"):
        "  if (err != cudaSuccess) return static_cast<int>(err);\n"
        "  rb_reduce_kernel<<<(d + kRedCols - 1) / kRedCols, kThreads, 0,\n"
        "                     static_cast<cudaStream_t>(stream)>>>(\n"
        "      partial, dscale, blocks, d);\n"
        "  return static_cast<int>(cudaGetLastError());"}
RB_ONE_PER_SM = {re.escape("const long long fit = static_cast<long long>"
                           "(per_sm) * sms;"): "const long long fit = sms;"}
# rms_norm_bwd's wide rows (past 3072 floats) read twice from global
# memory in float4 chunks of kChunk a lane, each chunk's loads in flight
# before its sums, the second pass mostly from L2, in place of staged in
# shared memory
RB_REREAD_BODY = """\
    } else if constexpr (VEC == kWide) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* g4 = reinterpret_cast<const float4*>(gr);
      const int per_lane = (d4 + 31) / 32;
      for (int c0 = 0; c0 < per_lane; c0 += kChunk) {
        float4 xv[kChunk], gv[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int i = lane + 32 * (c0 + c);
          const bool ok = i < d4;
          xv[c] = ok ? __ldg(x4 + i) : zero;
          gv[c] = ok ? __ldg(g4 + i) : zero;
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {   // the forward's order
          ss = fmaf(xv[c].x, xv[c].x, ss);
          ss = fmaf(xv[c].y, xv[c].y, ss);
          ss = fmaf(xv[c].z, xv[c].z, ss);
          ss = fmaf(xv[c].w, xv[c].w, ss);
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int i = lane + 32 * (c0 + c);
          if (i < d4) {
            const float4 s = __ldg(s4 + i);
            dot = fmaf(gv[c].x * s.x, xv[c].x, dot);
            dot = fmaf(gv[c].y * s.y, xv[c].y, dot);
            dot = fmaf(gv[c].z * s.z, xv[c].z, dot);
            dot = fmaf(gv[c].w * s.w, xv[c].w, dot);
          }
        }
      }
      ss = repro::warp_sum(ss);
      dot = repro::warp_sum(dot);
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      const float c3 = r * r * r * (dot / static_cast<float>(d));
      float4* o4 = reinterpret_cast<float4*>(dxr);
      for (int c0 = 0; c0 < per_lane; c0 += kChunk) {
        float4 xv[kChunk], gv[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int i = lane + 32 * (c0 + c);
          const bool ok = i < d4;
          xv[c] = ok ? __ldg(x4 + i) : zero;
          gv[c] = ok ? __ldg(g4 + i) : zero;
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int i = lane + 32 * (c0 + c);
          if (i < d4) {
            const float4 s = __ldg(s4 + i);
            const float4 xc = xv[c], gc = gv[c];
            o4[i] = make_float4(r * (gc.x * s.x) - xc.x * c3,
                                r * (gc.y * s.y) - xc.y * c3,
                                r * (gc.z * s.z) - xc.z * c3,
                                r * (gc.w * s.w) - xc.w * c3);
            float4 a = make_float4(gc.x * xc.x * r, gc.y * xc.y * r,
                                   gc.z * xc.z * r, gc.w * xc.w * r);
            if (!first) {
              const float4 o = w4[i];
              a = make_float4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
            }
            w4[i] = a;
          }
        }
      }
"""
RB_REREAD = {
    re.escape("constexpr int kScalar = -1, kStaged = -2;"):
        "constexpr int kScalar = -1, kStaged = -2, kWide = 0;\n"
        "constexpr int kChunk = 16;",
    re.escape("    } else {\n      for (int i0 = 4 * lane; i0 < d; i0 += 128)"):
        RB_REREAD_BODY + "    } else {\n      for (int i0 = 4 * lane; i0 < d; i0 += 128)",
    re.escape("const bool staged = vec && per_lane > kMaxVec && d <= kStageMaxD;"):
        "const bool staged = false;",
    re.escape("else if (!vec || per_lane > kMaxVec) kern = "
              "rmsnorm_bwd_kernel<kScalar>;"):
        "else if (!vec) kern = rmsnorm_bwd_kernel<kScalar>;\n"
        "  else if (per_lane > kMaxVec) kern = rmsnorm_bwd_kernel<kWide>;"}
# the forward rms_norm's wide rows (past 3072 floats) read twice from
# global memory in float4 chunks of kChunk a lane (each chunk's loads in
# flight before its sums, the second pass mostly from L2), in place of
# staged in shared memory
RF_REREAD_BODY = """\
  } else if constexpr (VEC == kWide) {
    const int d4 = d >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* s4 = reinterpret_cast<const float4*>(scale);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int per_lane = (d4 + 31) / 32;
    for (int c0 = 0; c0 < per_lane; c0 += kChunk) {
      float4 xv[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = lane + 32 * (c0 + c);
        xv[c] = i < d4 ? __ldg(x4 + i) : zero;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        ss = fmaf(xv[c].x, xv[c].x, ss);
        ss = fmaf(xv[c].y, xv[c].y, ss);
        ss = fmaf(xv[c].z, xv[c].z, ss);
        ss = fmaf(xv[c].w, xv[c].w, ss);
      }
    }
    ss = repro::warp_sum(ss);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int c0 = 0; c0 < per_lane; c0 += kChunk) {
      float4 xv[kChunk], sv[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = lane + 32 * (c0 + c);
        xv[c] = i < d4 ? __ldg(x4 + i) : zero;
        sv[c] = i < d4 ? __ldg(s4 + i) : zero;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = lane + 32 * (c0 + c);
        if (i < d4)
          o4[i] = make_float4(xv[c].x * r * sv[c].x, xv[c].y * r * sv[c].y,
                              xv[c].z * r * sv[c].z, xv[c].w * r * sv[c].w);
      }
    }
"""
RF_REREAD = {
    re.escape("constexpr int kStrided = 0, kStaged = -2;"):
        "constexpr int kStrided = 0, kStaged = -2, kWide = -3;\n"
        "constexpr int kChunk = 16;",
    re.escape("  } else {\n    for (int i0 = 4 * lane; i0 < d; i0 += 128)"):
        RF_REREAD_BODY + "  } else {\n    for (int i0 = 4 * lane; i0 < d; i0 += 128)",
    re.escape("if (vec && per_lane > kMaxVec && d <= kStageMaxD) {"):
        "if (false) {",
    re.escape("if (!vec || per_lane > kMaxVec) REPRO_LAUNCH(kStrided);"):
        "if (!vec) REPRO_LAUNCH(kStrided);\n"
        "  else if (per_lane > kMaxVec) REPRO_LAUNCH(kWide);"}
# the forward rms_norm's staged rows with the scale read through L1
# (__ldg) in the second pass, in place of staged once a block beside them
RF_SCALE_LDG = {
    re.escape("    for (int i = threadIdx.x; i < d4; i += blockDim.x)\n"
              "      repro::cp_async16(sc4 + i, s4 + i);\n"): "",
    re.escape("const float4 v = xs4[i], s = sc4[i];"):
        "const float4 v = xs4[i], s = __ldg(s4 + i);",
    re.escape("smem4 + static_cast<size_t>((threadIdx.x >> 5) + 1) * d4;"):
        "smem4 + static_cast<size_t>(threadIdx.x >> 5) * d4;",
    re.escape("const int fit = kSmemMax / (4 * d) - 1;"):
        "const int fit = kSmemMax / (4 * d);",
    re.escape("4 * static_cast<size_t>(d) * (warps + 1), s>>>("):
        "4 * static_cast<size_t>(d) * warps, s>>>("}
VARIANTS = {
    "base": {},
    # rms_norm's rows past the registers: read twice from global memory in
    # float4 chunks; staged with the scale read through L1
    "rf_reread": {RN: RF_REREAD},
    "rf_scale_ldg": {RN: RF_SCALE_LDG},
    # rms_norm_bwd: two launches with one resident block an SM (fewer
    # partial rows, more rows a warp); the cooperative launch with one block
    # an SM; wide rows read twice from global memory (in float4 chunks, the
    # second pass mostly from L2) in place of staged in shared memory; rows
    # of up to 3072 floats staged too, in place of held in registers
    "rb_two_launch": {RB: {**RB_TWO_LAUNCH, **RB_ONE_PER_SM}},
    "rb_one_per_sm": {RB: RB_ONE_PER_SM},
    "rb_reread": {RB: RB_REREAD},
    "rb_stage_all": {RB: {r"vec && per_lane > kMaxVec && d <= kStageMaxD":
                          "vec && d <= kStageMaxD"}},
    # the split policy: units of 64 keys per split
    "units_1": {FD: {r"kUnitsPerSplit = 2;": "kUnitsPerSplit = 1;"}},
    "units_4": {FD: {r"kUnitsPerSplit = 2;": "kUnitsPerSplit = 4;"}},
    # the ring's depth; the block-wide loop in place of the per-warp one
    "three_stages": {FD: {r"kStages = 2;": "kStages = 3;"}},
    "block_wide": {FD: {r"kPerWarpMax = 4;": "kPerWarpMax = 0;"}},
    # diagnostic: the tiles stream in, no arithmetic (the output is wrong)
    "no_compute": {FD: {
        r"        const int nk = min\(TK, sk - t\);\n        float p\[":
        "        if (k_positions == q_offset) {   // never\n"
        "        const int nk = min(TK, sk - t);\n        float p[",
        r"        t = next_tile<TK>\(t \+ TK, k1, a\);\n      \}\n      cp_wait<0>\(\);\n      __syncthreads\(\);  ":
        "        }\n        t = next_tile<TK>(t + TK, k1, a);\n      }\n      cp_wait<0>();\n      __syncthreads();  "}},
    # rms_norm: rows (warps) per block, on every path (the staged one: 8
    # warps a block at 5120, 6 at 8192, one block an SM)
    "rms_2_rows": {RN: {r"kRows = 4;": "kRows = 2;"}},
    "rms_8_rows": {RN: {r"kRows = 4;": "kRows = 8;"}},
    # swiglu's tile path: the rings' depth; the k-steps of a chunk not
    # unrolled; both parts split by cvt.rna; 64 x 128 tiles in the middle
    # rows; 128 x 128 tiles from one wave of blocks
    "sw_stages2": {SW: {r"(using Tile\d+ = Tile<\d, \d, \d, \d, )3,":
                        r"\g<1>2,"}},
    "sw_stages4": {SW: {r"(using Tile\d+ = Tile<\d, \d, \d, \d, )3,":
                        r"\g<1>4,"}},
    "sw_rolled": {SW: {r"#pragma unroll\n    for \(int ks":
                       "#pragma unroll 1\n    for (int ks"}},
    "sw_cvt_split": {SW: {
        r"repro::frag_a\(": "frag_a_cvt(", r"repro::frag_b\(": "frag_b_cvt(",
        r"// Tag: every m16 tile": SW_CVT_SPLIT + "// Tag: every m16 tile"}},
    "sw_mid_64x128": {SW: {r"using Tile64 = Tile<2, 2, 2, 4, 3, 2>;":
                           "using Tile64 = Tile<2, 2, 4, 4, 3, 1>;"}},
    "sw_big_sooner": {SW: {r"big < 2 \* 132\)": "big < 132)"}},
    "sw_mid_tile32": {SW: {r"if \(n <= 32\) return": "if (n <= 128) return"}},
    "sw_tile64_1blk": {SW: {r"using Tile64 = Tile<2, 2, 2, 4, 3, 2>;":
                            "using Tile64 = Tile<2, 2, 2, 4, 3, 1>;"}},
    # two k-steps (six products) in each zero-started sum: half the adds
    "sw_sum2": {SW: {
        r"(?s)#pragma unroll\n    for \(int ks = 0; ks < kK / 8; \+\+ks\) \{"
        r"\n      repro::FragA a\[MT\];\n#pragma unroll\n      for \(int i = 0; "
        r"i < MT; \+\+i\)\n        if \(FULL.*?\n  \};\n":
        SW_SUM2_BODY,
        r"// Tag: every m16 tile": SW_SUM2_HELPER + "// Tag: every m16 tile"}},
    # diagnostics (the output is wrong): one chained accumulator, no fp32
    # adds; the ring streams, no products; the products, no loads
    "sw_chain": {SW: {
        r"repro::mma3_zero\(p, a\[i\], (b[gu])\);\n#pragma unroll\n"
        r"            for \(int e = 0; e < 4; \+\+e\) (c[gu])\[i\]\[j\]\[e\]"
        r" \+= p\[e\];":
        r"repro::mma_tf32(\2[i][j], a[i].lo, \1.hi); "
        r"repro::mma_tf32(\2[i][j], a[i].hi, \1.lo); "
        r"repro::mma_tf32(\2[i][j], a[i].hi, \1.hi);"}},
    "sw_no_compute": {SW: {r"    if \(mt_act == MT\)\n      chunk\(Full<true>\{\}, xs\);\n"
                           r"    else if \(mt_act > 0\)":
                           "    if (mt_act < 0)\n      chunk(Full<true>{}, xs);\n"
                           "    else if (mt_act < 0)"}},
    "sw_no_load": {SW: {r"    if \(kc < nk\) \{\n      float\* xs":
                        "    if (kc < 0) {\n      float* xs"}},
    # swiglu_bwd: dg and du formed in the product tiles from dh and the
    # pair, in place of written once by a gate kernel into a scratch that
    # the tiles read; dX on 128 x 128 or on 64 x 128 tiles whatever the
    # waves
    "sb_gate_in_tiles": {SW: SB_GATE_IN_TILES},
    # swiglu_bwd's numerics: lo rounded to nearest; and lo*lo added
    "sb_rn": {SW: SB_RN},
    "sb_rn4": {SW: {**SB_RN, r"repro::mma3_zero\(c, a\[i\], b": "mma4_zero(c, a[i], b"}},
    # dX's k-steps joined in fp32 before the running sums: one, or four
    "sb_dx_join1": {SW: {r"constexpr int kDxJoin = 2;": "constexpr int kDxJoin = 1;"}},
    "sb_dx_join4": {SW: {r"constexpr int kDxJoin = 2;": "constexpr int kDxJoin = 4;"}},
    "sb_dx_128x128": {SW: {r"if \(c160 <= c128 && c160 <= c64\)": "if (false)",
                           r"if \(c128 <= c64\)": "if (true)"}},
    "sb_dx_64x128": {SW: {r"if \(c160 <= c128 && c160 <= c64\)": "if (false)",
                          r"if \(c128 <= c64\)": "if (false)"}},
    # sync_flat_update: streaming cache hints on its loads (__ldcs: evict
    # first; __ldlu: last use; no L1 line), its stores (__stcs) or both;
    # 128 or 512 threads a block; a grid-stride loop over 132 x 5 blocks
    # (the main row's instance resident at once, 46 registers) in place of
    # one block per 256 vectors
    "su_ldcs": {SU: {SU_LD: "T ld_global(const T* p) { return __ldcs(p); }"}},
    "su_ldlu": {SU: {SU_LD: "T ld_global(const T* p) { return __ldlu(p); }"}},
    "su_no_allocate": {SU: {
        r"template <typename T>\n__device__ __forceinline__ " + SU_LD:
        SU_NO_ALLOCATE}},
    "su_stcs": {SU: {SU_ST: "void st_global(T* p, T v) { __stcs(p, v); }"}},
    "su_cs": {SU: {
        SU_LD: "T ld_global(const T* p) { return __ldcs(p); }",
        SU_ST: "void st_global(T* p, T v) { __stcs(p, v); }"}},
    "su_threads128": {SU: {r"kFlatThreads = 256;": "kFlatThreads = 128;"}},
    "su_threads512": {SU: {r"kFlatThreads = 256;": "kFlatThreads = 512;"}},
    "su_grid_stride": {SU: {
        r"const long long v = (.*);\n  if \(v < n / V\) \{":
        r"for (long long v = \1; v < n / V;\n"
        r"       v += static_cast<long long>(gridDim.x) * blockDim.x) {",
        r"const long long blocks = (.*);":
        r"const long long want = \1,\n"
        r"                  blocks = want < 132 * 5 ? want : 132 * 5;"}},
}


def decode_interface(src: str) -> str:
    """Which C interface a flash_decode source has: `split` (split-K with a
    scratch) or `single` (the kernel before split-K)."""
    return "split" if "flash_decode_scratch_floats" in src else "single"


def variant_sources(name: str) -> dict[str, str]:
    """{kernel file: CUDA source} of variant `name`."""
    if name.startswith("file:"):
        out = {}
        for path in name[5:].split(","):
            with open(path) as f:
                src = f.read()
            out[next(k for k, fn in ENTRY.items() if fn in src)] = src
        return out
    out = {}
    for fname, subs in VARIANTS[name].items():
        with open(os.path.join(CSRC, fname)) as f:
            src = f.read()
        for pat, rep in subs.items():
            src, n = re.subn(pat, rep, src)
            if not n:
                raise SystemExit(f"variant {name}: no match for {pat!r}")
        out[fname] = src
    return out


def build(names):
    """{name: (CDLL, ptxas lines)} of every variant but `base`."""
    from repro_torch.kernels import build as kb
    procs = {}
    for name in names:
        if name == "base":
            continue
        d = os.path.join(OUT, re.sub(r"\W", "_", name))
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(CSRC, h), d)
        files = []
        for fname, src in variant_sources(name).items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(src)
            files.append(os.path.join(d, fname))
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), *files],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name} does not build:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, re.sub(r"\W", "_", name),
                                       "lib.so"))
        fd = variant_sources(name).get(FD)
        lib.interface = decode_interface(fd) if fd else None
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return libs


class Kernels:
    """The wrappers' library with a variant's `rmsnorm_f32`, `swiglu_f32`
    and `flash_decode_f32` in place of the source's, called with the
    wrappers' arguments (the scratch the wrapper sized from the base is left
    unused): a split-K variant gets the scratch its own split count needs,
    an older one the interface it had."""

    def __init__(self, base, lib):
        self.base, self.lib, self.keep = base, lib, None
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.has_rn = hasattr(lib, "rmsnorm_f32")
        self.has_sw = hasattr(lib, "swiglu_f32")
        self.has_su = hasattr(lib, "sync_flat_update_f32")
        self.has_rb = hasattr(lib, "rmsnorm_bwd_f32")
        # an rms_norm_bwd source from before `rmsnorm_bwd_grid` sizes its
        # own scratch and grid
        self.rb_old = self.has_rb and not hasattr(lib, "rmsnorm_bwd_grid")
        if self.rb_old:
            lib.rmsnorm_bwd_f32.argtypes = [P] * 6 + [I, I, F, P]
            lib.rmsnorm_bwd_scratch_floats.argtypes = [I, I]
            lib.rmsnorm_bwd_scratch_floats.restype = ctypes.c_longlong
        elif self.has_rb:
            lib.rmsnorm_bwd_f32.argtypes = [P] * 6 + [I, I, F, I, I, P]
            lib.rmsnorm_bwd_grid.argtypes = [I] * 3 + [ctypes.POINTER(I)]
        self.has_fd = lib.interface is not None
        if self.has_rn:
            lib.rmsnorm_f32.argtypes = [P, P, P, I, I, F, P]
        # swiglu's backward from the pair, where the source has it
        self.has_sb = hasattr(lib, "swiglu_bwd_f32")
        if self.has_sw:
            lib.swiglu_f32.argtypes = [P, P, P, P, I, I, I, P]
        if self.has_sb:
            lib.swiglu_fwd_pair_f32.argtypes = [P] * 6 + [I, I, I, P]
            lib.swiglu_bwd_f32.argtypes = [P] * 10 + [I, I, I, P]
            lib.swiglu_bwd_scratch_floats.argtypes = [I, I]
            lib.swiglu_bwd_scratch_floats.restype = ctypes.c_longlong
        if self.has_su:
            lib.sync_flat_update_f32.argtypes = [P] * 4 + [
                ctypes.c_longlong, I, F, P]
        if lib.interface == "split":
            lib.flash_decode_scratch_floats.argtypes = [I] * 4
            lib.flash_decode_scratch_floats.restype = ctypes.c_longlong
            lib.flash_decode_f32.argtypes = [P] * 7 + [I] * 7 + [F, I, P]
        elif self.has_fd:
            lib.flash_decode_f32.argtypes = [P] * 6 + [I] * 7 + [F, I, P]

    def __getattr__(self, name):
        return getattr(self.base, name)

    def rmsnorm_f32(self, *args):
        return (self.lib if self.has_rn else self.base).rmsnorm_f32(*args)

    def rmsnorm_bwd_grid(self, n, d, vec, blocks):
        if not self.rb_old:
            return (self.lib if self.has_rb else self.base).rmsnorm_bwd_grid(
                n, d, vec, blocks)
        blocks.value = self.lib.rmsnorm_bwd_scratch_floats(n, d) // d
        return 0

    def rmsnorm_bwd_f32(self, *args):
        if self.rb_old:
            return self.lib.rmsnorm_bwd_f32(*args[:9], args[-1])
        return (self.lib if self.has_rb else self.base).rmsnorm_bwd_f32(*args)

    def swiglu_f32(self, *args):
        return (self.lib if self.has_sw else self.base).swiglu_f32(*args)

    def swiglu_fwd_pair_f32(self, *args):
        return (self.lib if self.has_sb else self.base).swiglu_fwd_pair_f32(
            *args)

    def swiglu_bwd_f32(self, *args):
        return (self.lib if self.has_sb else self.base).swiglu_bwd_f32(*args)

    def swiglu_bwd_scratch_floats(self, *args):
        return (self.lib if self.has_sb else
                self.base).swiglu_bwd_scratch_floats(*args)

    def sync_flat_update_f32(self, *args):
        return (self.lib if self.has_su else self.base).sync_flat_update_f32(
            *args)

    def has(self, kernel: str) -> bool:
        return {"rms_norm": self.has_rn, "rms_norm_bwd": self.has_rb,
                "swiglu": self.has_sw,
                "flash_decode": self.has_fd,
                "sync_flat_update": self.has_su,
                "swiglu_bwd": self.has_sb}[kernel]

    def flash_decode_f32(self, q, k, v, out, part, qoff, kpos, b, sk, hq, hkv,
                         d, window, prefix_len, scale, causal, stream):
        mask = (window, prefix_len, scale, causal)
        if not self.has_fd:
            return self.base.flash_decode_f32(
                q, k, v, out, part, qoff, kpos, b, sk, hq, hkv, d, *mask,
                stream)
        if self.lib.interface == "single":
            return self.lib.flash_decode_f32(
                q, k, v, out, qoff, kpos, b, sk, hq, hkv, d, *mask, stream)
        import torch
        floats = self.lib.flash_decode_scratch_floats(b, hq, sk, d)
        self.keep = torch.empty(floats, device="cuda") if floats else None
        part = None if self.keep is None else self.keep.data_ptr()
        return self.lib.flash_decode_f32(
            q, k, v, out, part, qoff, kpos, b, sk, hq, hkv, d, *mask, stream)


def swiglu_cases(torch):
    """chip_smoke.kernel_cases' tuples for swiglu at gemma3-4b's widths at
    SWIGLU_ROWS rows, timed."""
    g = torch.Generator(device="cuda").manual_seed(99)
    d, f = 2560, 10240
    wg, wi = (torch.randn(d, f, generator=g, device="cuda") * d ** -0.5
              for _ in range(2))
    return [("swiglu", f"[{n},{d}]x[{d},{f}]",
             dict(x=torch.randn(n, d, generator=g, device="cuda"), wg=wg,
                  wi=wi), False, True) for n in SWIGLU_ROWS]


def sync_flat_rows(torch, cs, names, kern, turns, timer, res) -> dict:
    """sync_flat_update's SYNC_ROWS held and timed per variant (into `res`);
    returns {row: the copy ceiling's ms and the bytes bound}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sync_update as _su
    g = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std
    n = cs.VIT_PARAMS
    anchor = rnd(n, std=0.02)
    p = anchor[None] + rnd(4, n, std=1e-3)
    scale = (rnd(n).abs_() + 0.1) * 3e-3
    mu0 = rnd(n, std=1e-4)
    users = [v for v in names
             if v == "base" or kern[v].has("sync_flat_update")]
    base = kern["base"]
    ceiling = {}
    for w, quantize, momentum in SYNC_ROWS:
        pw = p[:w]
        kw = dict(scale=scale if quantize else None,
                  mu=mu0 if momentum else None, momentum=momentum)
        key = (f"sync_flat_update [{w},{n}] quantize "
               f"{'on' if quantize else 'off'} momentum {momentum}")
        plain = ref.sync_flat_update if quantize else \
            ref.sync_flat_update_lane_order
        want = plain(pw, anchor, **kw)
        for v in users:
            using(kern[v])
            got = _su.sync_flat_update(
                pw.clone(), anchor.clone(), scale=kw["scale"],
                mu=None if kw["mu"] is None else mu0.clone(),
                momentum=momentum)
            torch.cuda.synchronize()
            res[v]["cases"][key] = dict(
                bitwise=all(x is None or torch.equal(x, y)
                            for x, y in zip(got, want)), ms=[], fresh_ms=[])
            del got
        del want
        pk, ak = pw.clone(), anchor.clone()
        muk = None if kw["mu"] is None else mu0.clone()

        def call():
            _su.sync_flat_update(pk, ak, scale=kw["scale"], mu=muk,
                                 momentum=momentum)

        def restore():
            pk.copy_(pw)
            ak.copy_(anchor)
        for v in turns:
            if v in users:
                using(kern[v])
                res[v]["cases"][key]["ms"].append(timer(call))
                res[v]["cases"][key]["fresh_ms"].append(
                    timer(call, setup=restore))
        using(base)
        words = 2 * w + 2 + quantize + 2 * (momentum > 0)
        src = torch.empty(words * n // 2, device="cuda")
        dst = torch.empty_like(src)
        ceiling[key] = dict(copy_ms=timer(lambda: dst.copy_(src)),
                            bound_ms=cs.bound_ms(4.0 * n * words, 0.0)[0])
        del pk, ak, muk, src, dst
    return ceiling


def swiglu_bwd_rows(torch, names, kern, turns, timer, res) -> dict:
    """swiglu_bwd at gemma3-4b's widths, 1024 and 2048 rows, held and timed
    per variant (into `res`), each gradient's RMS error against fp64
    products beside the plain (cuBLAS fp32) version's; returns {row: the
    library's grad ms, and the plain version's errors}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swiglu as _sw
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(2468)
    d, f = 2560, 10240
    users = [v for v in names if v == "base" or kern[v].has("swiglu_bwd")]
    library = {}
    for n in (1024, 2048):
        x, dh = (torch.randn(*shape, generator=g, device="cuda")
                 for shape in ((n, d), (n, f)))
        wg, wi = (torch.randn(d, f, generator=g, device="cuda") * d ** -0.5
                  for _ in range(2))
        using(kern["base"])
        _, p, q = _sw.swiglu_fwd(x, wg, wi)
        base = _sw.swiglu_bwd(x, wg, wi, p, q, dh)
        want = ref.swiglu_bwd(x, wg, wi, p, q, dh)
        xd, wgd, wid, dgd, dud = (t.double() for t in (x, wg, wi, dh * p,
                                                         dh * q))
        exact = (dgd @ wgd.T + dud @ wid.T, xd.T @ dgd, xd.T @ dud)
        del xd, wgd, wid, dgd, dud

        def rms_err(got):
            """Each gradient's RMS error against the fp64 products over
            its RMS: the sum-order noise the variant adds."""
            return [float((a.double() - b).square().mean().sqrt()
                          / b.square().mean().sqrt())
                    for a, b in zip(got, exact)]
        key = f"swiglu_bwd [{n},{d}]x[{d},{f}]"
        library[key + " plain_rms_err_vs_fp64"] = rms_err(want)
        for v in users:
            using(kern[v])
            got = _sw.swiglu_bwd(x, wg, wi, p, q, dh)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                       1.0)
                      for a, b in zip(got, want))
            res[v]["cases"][key] = dict(
                max_rel_err=err, within_tol=err <= 2e-5,
                rms_err_vs_fp64=rms_err(got),
                bitwise_base=all(bool(torch.equal(a, b))
                                 for a, b in zip(got, base)),
                ms=[], gate_dw_ms=[], gate_dx_ms=[])
            del got
        for v in turns:
            if v in users:
                using(kern[v])
                case = res[v]["cases"][key]
                for field, need in (("ms", (True, True, True)),
                                    ("gate_dw_ms", (False, True, True)),
                                    ("gate_dx_ms", (True, False, False))):
                    case[field].append(timer(lambda: _sw.swiglu_bwd(
                        x, wg, wi, p, q, dh, need=need)))
        using(kern["base"])
        xr, gr, ir = (t.clone().requires_grad_(True) for t in (x, wg, wi))
        lib_out = F.silu(xr @ gr) * (xr @ ir)
        library[key] = timer(lambda: torch.autograd.grad(
            lib_out, (xr, gr, ir), dh, retain_graph=True))
        del x, dh, wg, wi, p, q, base, want, exact, xr, gr, ir, lib_out
    return library


def rms_norm_bwd_rows(torch, cs, names, kern, turns, timer, res) -> dict:
    """rms_norm_bwd at [1024, d] for d in RMS_BWD_D, held and timed per
    variant (into `res`): dx against the plain version at chip_smoke's
    tolerance and bitwise against the base, dscale within chip_smoke's
    `dscale_tol`, a second call bitwise, dscale's RMS error against an
    fp64 sum over the rows, timed in turns, and each launch's device time
    from a profile of 5 calls (chip_smoke's `profile_device_ms`); returns {row: the library's grad ms and the
    plain version's dscale error against fp64}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as _rn
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(1357)
    users = [v for v in names if v == "base" or kern[v].has("rms_norm_bwd")]
    library = {}
    for d in RMS_BWD_D:
        n = cs.BWD_ROWS
        x, sc, dy = (torch.randn(*shape, generator=g, device="cuda")
                     for shape in ((n, d), (d,), (n, d)))
        using(kern["base"])
        base = _rn.rms_norm_bwd(x, sc, dy)
        wdx, wds = ref.rms_norm_bwd(x, sc, dy)
        xd = x.double()
        r = torch.rsqrt(torch.mean(xd * xd, -1, keepdim=True) + 1e-6)
        exact = (dy.double() * xd * r).sum(0)
        ds_tol = cs.dscale_tol(torch, x, dy)
        dx_tol = cs.TOL["rms_norm_bwd"] * max(float(wdx.abs().max()), 1.0)

        def rms_err(ds):
            """dscale's RMS error against the fp64 sum over its RMS."""
            return float((ds.double() - exact).square().mean().sqrt()
                         / exact.square().mean().sqrt())
        key = f"rms_norm_bwd [{n},{d}]"
        library[key + " plain_dscale_rms_err_vs_fp64"] = rms_err(wds)
        for v in users:
            using(kern[v])
            dx, ds = _rn.rms_norm_bwd(x, sc, dy)
            dx2, ds2 = _rn.rms_norm_bwd(x, sc, dy)
            torch.cuda.synchronize()
            ds_err = float((ds - wds).abs().max())
            dx_err = float((dx - wdx).abs().max())
            prof = cs.profile_device_ms(torch, lambda: [
                _rn.rms_norm_bwd(x, sc, dy) for _ in range(5)],
                count=("rmsnorm_bwd",))
            res[v]["cases"][key] = dict(
                dx_max_abs_err=dx_err, dscale_max_abs_err=ds_err,
                within_tol=dx_err <= dx_tol and ds_err <= ds_tol,
                dscale_tol=ds_tol, dx_bitwise_base=bool(torch.equal(
                    dx, base[0])),
                dscale_bitwise_base=bool(torch.equal(ds, base[1])),
                bitwise_repeat=bool(torch.equal(dx, dx2)
                                    and torch.equal(ds, ds2)),
                dscale_rms_err_vs_fp64=rms_err(ds),
                launch_ms={t["name"][:80]: t["ms"] / t["calls"]
                           for t in prof["top"]},
                ms=[])
            del dx, ds, dx2, ds2
        for v in turns:
            if v in users:
                using(kern[v])
                res[v]["cases"][key]["ms"].append(timer(
                    lambda: _rn.rms_norm_bwd(x, sc, dy)))
        using(kern["base"])
        xr, sr = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
        lib_out = F.rms_norm(xr, (d,), sr, 1e-6)
        library[key] = timer(lambda: torch.autograd.grad(
            lib_out, (xr, sr), dy, retain_graph=True))
        library[key + " bound_ms"] = cs.bound_ms(4.0 * (3 * n * d + 2 * d),
                                                 10.0 * n * d)[0]
        del x, sc, dy, base, wdx, wds, xd, r, exact, xr, sr, lib_out
    return library


def using(kernels):
    """Point the wrappers at `kernels` (a Kernels or the base library)."""
    from repro_torch.kernels import build as kb
    kb._lib = kernels


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as _rn
    from repro_torch.kernels import swiglu as _sw
    from repro_torch.models import common  # noqa: F401  (turns TF32 off)
    from torch.profiler import ProfilerActivity, profile

    step = "--step" in argv
    only = [a.split("=", 1)[1] for a in argv if a.startswith("--only=")]
    argv = [a for a in argv if a != "--step" and not a.startswith("--only=")]
    # no variant named: every variant, or with --only those of its files
    names = ["base"] + [n for n in (argv or VARIANTS) if n != "base" and (
        argv or not only or any(KERNEL[k] in VARIANTS[n] for k in only))]
    base = kb.library()
    libs = build(names)
    kern = {n: base if n == "base" else Kernels(base, libs[n][0])
            for n in names}
    order = [n for n in names if n != "base"]
    turns = order + ["base", "base"] + order[::-1]
    timer = cs.Timer(torch)
    res = {n: dict(variant=n, ptxas=libs[n][1] if n in libs else [],
                   cases={}) for n in names}
    res["base"]["launch_floor_ms"] = cs.launch_floor_ms(torch, timer)
    # a read-only sum over 64 MiB: what a plain stream of reads reaches
    # after the Timer's flush
    x = torch.ones(16 * 1024 * 1024, device="cuda")
    res["base"]["sum_64MiB_ms"] = timer(x.sum)
    del x
    plain = {"rms_norm": ref.rms_norm, "swiglu": ref.swiglu,
             "flash_decode": ref.attention}
    wrap = {"rms_norm": _rn.rms_norm, "swiglu": _sw.swiglu,
            "flash_decode": _fa.flash_decode}
    library = {}
    serving = [k for k in wrap if not only or k in only]
    cases = (cs.kernel_cases(torch, 64) + swiglu_cases(torch)
             if serving else [])
    for name, label, a, main_shape, timed in cases:
        if name not in serving:
            continue
        want = cs.run_kernel(torch, plain, name, a)
        tol = cs.TOL[name] * max(float(want.abs().max()), 1.0)
        users = [n for n in names if n == "base" or kern[n].has(name)]
        base_out = None
        for n in users:
            using(kern[n])
            got = cs.run_kernel(torch, wrap, name, a)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            res[n]["cases"][f"{name} {label}"] = dict(
                max_abs_err=err, within_tol=err <= tol, ms=[])
            if n == "base":
                base_out = got
            elif name == "rms_norm":
                res[n]["cases"][f"{name} {label}"]["bitwise_base"] = bool(
                    torch.equal(got, base_out))
        del base_out
        if timed:
            for n in turns:
                if n in users:
                    using(kern[n])
                    res[n]["cases"][f"{name} {label}"]["ms"].append(timer(
                        lambda: cs.run_kernel(torch, wrap, name, a)))
            library[f"{name} {label}"] = timer(cs.library_call(torch, name,
                                                               a))
            if name == "flash_decode" and a["q"].shape[0] == cs.LONG_SLOTS:
                for n in users:
                    using(kern[n])
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(5):
                            cs.run_kernel(torch, wrap, name, a)
                        torch.cuda.synchronize()
                    res[n]["cases"][f"{name} {label}"]["launch_us"] = {
                        e.key[:80]: e.device_time_total / e.count
                        for e in prof.key_averages()
                        if e.device_time_total > 0}
        using(base)
    del cases
    if not only or "rms_norm_bwd" in only:
        library.update(rms_norm_bwd_rows(torch, cs, names, kern, turns,
                                         timer, res))
    if not only or "swiglu_bwd" in only:
        library.update(swiglu_bwd_rows(torch, names, kern, turns, timer,
                                       res))
    ceiling = {}
    if not only or "sync_flat_update" in only:
        ceiling = sync_flat_rows(torch, cs, names, kern, turns, timer, res)
    if step:
        from repro_torch.configs import registry as R
        from repro_torch.launch import weights as W
        cfg = R.get_config(cs.ARCH)
        weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
        for slots, max_len, pos in ((cs.SLOTS, 64, [32, 63]),
                                    (cs.LONG_SLOTS, cs.LONG_LEN,
                                     cs.LONG_POS)):
            key = f"{slots}x{max_len}"
            for n in turns:
                using(kern[n])
                res[n].setdefault("step_ms", {}).setdefault(key, []).append(
                    cs.device_step_ms(torch, cfg, weights, slots, max_len,
                                      pos))
            using(base)
        del weights
    for n in names:
        print(json.dumps(res[n]), flush=True)
    print(json.dumps({"library_ms": library, "copy_ceiling": ceiling}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
