#!/usr/bin/env python3
"""Build variants of the attention kernels and time them side by side.

    python3 tools/attention_variants.py [VARIANT | file:PATH ...]

A variant is `src/repro_torch/kernels/csrc/flash_attention.cu` with a few
regex substitutions (`VARIANTS` below: the designs PERF.md's table of
attention designs names, and two diagnostics that drop part of the work),
or `file:PATH`, another whole source with the same C interface (an earlier
version of the kernel, say, from `git show REV:src/...`).  The patterns
match the source's text: after an edit of the kernel a variant that no
longer matches stops the run with its pattern.  Each is compiled by its own
`nvcc` into `src/repro_torch/kernels/_build/variants/` (git ignores it) and
loaded with ctypes beside the unchanged source (`base`).  For every
attention case of chip_smoke.py each variant is held against the plain
version at chip_smoke's tolerances (a diagnostic variant may fail them: it
reports its error); at every case chip_smoke times, the forward and
backward are timed twice with chip_smoke's `Timer` (L2 flushed), and SDPA
once beside them; at ViT-B/16's [32,196,12,64] the device time of each
launch is read from `torch.profiler`, SDPA's kernels too.  One JSON line
per variant; no argument runs them all.  Needs one CUDA card.
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
UNROLL = r"#pragma unroll 2\n    for \(int kd = k0; kd < k0 \+ KC; \+\+kd\)"
FRAGMENT_ROWS = {     # the layout before: a row of B fragments, then term by term
    r"// c \+= a \* b in 3xTF32, the small terms first\.":
    "template <int NT, bool FULL>\n"
    "__device__ __forceinline__ void mma3_row(float (&c)[NT][4], const FragA& a,\n"
    "                                         const FragB (&b)[NT], int nact) {\n"
    "#pragma unroll\n  for (int j = 0; j < NT; ++j)\n"
    "    if (FULL || j < nact) mma_tf32(c[j], a.lo, b[j].hi);\n"
    "#pragma unroll\n  for (int j = 0; j < NT; ++j)\n"
    "    if (FULL || j < nact) mma_tf32(c[j], a.hi, b[j].lo);\n"
    "#pragma unroll\n  for (int j = 0; j < NT; ++j)\n"
    "    if (FULL || j < nact) mma_tf32(c[j], a.hi, b[j].hi);\n}\n\n"
    "// c += a * b in 3xTF32, the small terms first.",
    r"#pragma unroll\n      for \(int j = 0; j < NT; \+\+j\) \{\n"
    r"        const float\* bp = b \+ \(8 \* j \+ g\) \* LD \+ 8 \* kd \+ t;\n"
    r"        if \(FULL \|\| j < nact\) mma3\(d\[j\], fa, frag_b\(bp\[0\], bp\[4\]\)\);\n      \}":
    "      FragB fb[NT];\n#pragma unroll\n      for (int j = 0; j < NT; ++j) {\n"
    "        const float* bp = b + (8 * j + g) * LD + 8 * kd + t;\n"
    "        if (FULL || j < nact) fb[j] = frag_b(bp[0], bp[4]);\n      }\n"
    "      mma3_row<NT, FULL>(d, fa, fb, nact);",
    r"#pragma unroll\n      for \(int n = 0; n < NT; \+\+n\) "
    r"mma3\(d\[n\], fa, frag_b\(bp\[8 \* n\], bp\[LD \+ 8 \* n\]\)\);":
    "      FragB fb[NT];\n#pragma unroll\n      for (int n = 0; n < NT; ++n) "
    "fb[n] = frag_b(bp[8 * n], bp[LD + 8 * n]);\n      mma3_row<NT, true>(d, fa, fb, NT);",
}
VARIANTS = {
    "base": {},
    # diagnostics: how much of the time the 3xTF32 products take
    "one_tf32_product": {
        r"  mma_tf32\(c, a.lo, b.hi\);\n  mma_tf32\(c, a.hi, b.lo\);\n": ""},
    # the first design's accumulation: every product of a row chained on
    # one accumulator (the forward rescales it before each tile)
    "chained_accumulators": {
        r"constexpr int kChunk = 2;": "constexpr int kChunk = 32;",
        r"  for \(int n = 0; n < NT; \+\+n\) d\[n\]\[0\] = d\[n\]\[1\] = d\[n\]\[2\] = d\[n\]\[3\] = 0.f;":
        "  for (int n = 0; n < NT; ++n) {\n    acc[n][0] *= al0;\n    acc[n][1] *= al0;\n"
        "    acc[n][2] *= al1;\n    acc[n][3] *= al1;\n  }",
        r"mma3\(d\[n\], fa, frag_b": "mma3(acc[n], fa, frag_b",
        r"    acc\[n\]\[\d\] = fmaf\(acc\[n\]\[\d\], al\d, d\[n\]\[\d\]\);\n": ""},
    # partial sums of the score products: all D chained, or flushed every 4
    # or every k-step
    "score_chunk_all": {r"constexpr int kChunk = 2;": "constexpr int kChunk = 32;"},
    "score_chunk_4": {r"constexpr int kChunk = 2;": "constexpr int kChunk = 4;"},
    "score_chunk_1": {r"constexpr int kChunk = 2;": "constexpr int kChunk = 1;"},
    "no_key_loads": {   # the forward computes on stale K / V tiles
        r"      load_rows<D, BK>\(ks \+ it % kStages \* BK \* LD, kb, it \* BK, sk, kstride\);\n"
        r"      load_rows<D, BK>\(vs \+ it % kStages \* BK \* LD, vb, it \* BK, sk, kstride\);\n":
        "      if (it == 0) {\n"
        "        load_rows<D, BK>(ks, kb, 0, sk, kstride);\n"
        "        load_rows<D, BK>(vs, vb, 0, sk, kstride);\n      }\n"},
    # designs measured and not taken
    "full_unroll": {UNROLL: "#pragma unroll\n    for (int kd = k0; kd < k0 + KC; ++kd)",
                    r"#pragma unroll 1\n  for \(int k0 = 0;": "#pragma unroll\n  for (int k0 = 0;"},
    "no_unroll": {UNROLL: "#pragma unroll 1\n    for (int kd = k0; kd < k0 + KC; ++kd)"},
    "bounds_tested_everywhere": {
        r"if \((k0|q0) \+ (BK|BQ) <= (sk|sq|nk)\) tile\(Full<true>\(\), ([^;]*);\n      else ": ""},
    "three_stages": {r"constexpr int kStages = 2;": "constexpr int kStages = 3;"},
    "fwd_64_keys": {r"F_BK = 32;": "F_BK = D == 64 ? 64 : 32;"},
    "dkdv_64_queries": {r"KV_BQ = 32": "KV_BQ = D == 64 ? 64 : 32"},
    "dkdv_16_queries": {r"KV_BQ = 32": "KV_BQ = 16"},
    "dkdv_2_blocks": {r"__launch_bounds__\(kThreads, 3\)\nfa_bwd_dkdv_kernel":
                      "__launch_bounds__(kThreads)\nfa_bwd_dkdv_kernel"},
    "fragment_rows": FRAGMENT_ROWS,
}


def variant_source(name: str) -> str:
    """The CUDA source of variant `name` (a `VARIANTS` key or file:PATH)."""
    if name.startswith("file:"):
        with open(name[5:]) as f:
            return f.read()
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        s = f.read()
    for pat, rep in VARIANTS[name].items():
        s, n = re.subn(pat, rep, s)
        if not n:
            raise SystemExit(f"variant {name}: no match for {pat!r}")
    return s


def build(names):
    from repro_torch.kernels import build as kb
    procs = {}
    for name in names:
        d = os.path.join(OUT, re.sub(r"\W", "_", name))
        os.makedirs(d, exist_ok=True)
        s = variant_source(name)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(s)
        shutil.copy(os.path.join(CSRC, "common.cuh"), d)
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, P, I, F = {}, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name} does not build:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, re.sub(r"\W", "_", name), "lib.so"))
        lib.flash_attention_fwd_f32.argtypes = [P] * 5 + [I] * 6 + [F] + [I] * 4 + [P]
        lib.flash_attention_bwd_f32.argtypes = [P] * 10 + [I] * 6 + [F] + [I] * 4 + [P]
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return libs


def launchers(torch, lib, a):
    """fwd(), bwd() on the inputs `a`, writing into buffers made here (the
    scratch as `kernels/flash_attention.py` sizes it, which is at least what
    any earlier version of the kernel took)."""
    from repro_torch.kernels import flash_attention as _fa
    q, k, v, do = a["q"], a["k"], a["v"], a["dout"]
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    m = (int(a["causal"]), a["window"], a["prefix_len"], a["q_offset"])
    scale, stream = d ** -0.5, torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty(b, hq, sq, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(_fa.bwd_scratch_floats(b, hq, sq, sk), device="cuda")

    def fwd():
        err = lib.flash_attention_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          lse.data_ptr(), b, sq, sk, hq, hkv, d, scale, *m,
                                          stream)
        if err:
            raise RuntimeError(f"forward launch failed: cudaError {err}")

    def bwd():
        err = lib.flash_attention_bwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                          dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b,
                                          sq, sk, hq, hkv, d, scale, *m, stream)
        if err:
            raise RuntimeError(f"backward launch failed: cudaError {err}")
    return fwd, bwd, o, (dq, dk, dv)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.models import common  # noqa: F401  (turns TF32 off)
    from torch.profiler import ProfilerActivity, profile

    names = ["base"] + [n for n in (argv or VARIANTS) if n != "base"]
    libs = build(names)
    g = torch.Generator(device="cuda").manual_seed(4321)
    cases = cs.attention_cases(
        lambda *s, std=1.0: torch.randn(*s, generator=g, device="cuda") * std)
    timer = cs.Timer(torch)
    F = torch.nn.functional
    res = {n: dict(variant=n, ptxas=libs[n][1], worst_fwd_err=0.0,
                   worst_bwd_err=0.0, timed={}) for n in names}
    sdpa = {}
    for label, a, main_shape, timed in cases:
        ins = [a[x].clone().requires_grad_(True) for x in ("q", "k", "v")]
        mask = {x: a[x] for x in ("causal", "window", "prefix_len", "q_offset")}
        want = ref.attention(*ins, **mask)
        want_g = torch.autograd.grad(want, ins, a["dout"])
        want = want.detach()
        sf = max(float(want.abs().max()), 1.0)
        sb = max(max(float(y.abs().max()) for y in want_g), 1.0)
        for n in names:
            r = res[n]
            try:
                fwd, bwd, o, grads = launchers(torch, libs[n][0], a)
                fwd()
                bwd()
                torch.cuda.synchronize()
            except RuntimeError as e:
                r.setdefault("launch_errors", []).append(f"{label}: {e}")
                continue
            ef = float((o - want).abs().max())
            eb = max(float((x - y).abs().max()) for x, y in zip(grads, want_g))
            r["worst_fwd_err"] = max(r["worst_fwd_err"], ef / sf)
            r["worst_bwd_err"] = max(r["worst_bwd_err"], eb / sb)
            if not timed:
                continue
            t = r["timed"][label] = dict(fwd_abs_err=ef, bwd_abs_err=eb,
                                         fwd_ms=[], bwd_ms=[])
            for _ in range(2):
                t["fwd_ms"].append(timer(fwd))
                t["bwd_ms"].append(timer(bwd))
            if main_shape:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fwd()
                        bwd()
                    torch.cuda.synchronize()
                r["launch_us"] = {e.key[e.key.find("fa_"):e.key.find(">") + 1]:
                                  e.device_time_total / e.count
                                  for e in prof.key_averages() if "fa_" in e.key}
        if timed:
            qt, kt, vt, am = cs.sdpa_inputs(torch, a)
            dot = a["dout"].transpose(1, 2)
            lib_o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
            with torch.no_grad():
                s_fwd = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=am))
            s_bwd = timer(lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), dot, retain_graph=True))
            sdpa[label] = dict(fwd_ms=s_fwd, bwd_ms=s_bwd)
            if main_shape:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        out = F.scaled_dot_product_attention(qt, kt, vt)
                        torch.autograd.grad(out, (qt, kt, vt), dot)
                    torch.cuda.synchronize()
                sdpa["launch_us"] = {e.key[:160]: e.device_time_total / e.count
                                     for e in prof.key_averages()
                                     if e.device_time_total > 0}
            del lib_o, qt, kt, vt
    for n in names:
        r = res[n]
        r["within_tol"] = (r["worst_fwd_err"] <= cs.TOL["flash_attention_fwd"]
                           and r["worst_bwd_err"] <= cs.TOL["flash_attention_bwd"]
                           and "launch_errors" not in r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"sdpa": sdpa}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
