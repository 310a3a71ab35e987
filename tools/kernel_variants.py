#!/usr/bin/env python3
"""Build variants of the serving kernels (`flash_decode`, `rms_norm`) and time
them side by side with the source.

    python3 tools/kernel_variants.py [--step] [VARIANT | file:PATH[,PATH] ...]

A variant is `src/repro_torch/kernels/csrc/flash_decode.cu` or `rmsnorm.cu`
with a few regex substitutions (`VARIANTS` below), or `file:PATH`, whole
other sources of either kernel (which one: the C function a source
defines; several joined by commas form one variant), such as an earlier
commit's, written out first with `git show REV:src/repro_torch/kernels/
csrc/flash_decode.cu > _dev/fd.cu` (a copy of the tree without `.git`
cannot run it).  A `flash_decode_f32` from before split-K (no
`flash_decode_scratch_floats` beside it) is called with its own interface.  The
patterns match the source's text: after an edit of a kernel a variant that
no longer matches stops the run with its pattern.  Each variant is compiled
by its own `nvcc` into `src/repro_torch/kernels/_build/variants/` (git
ignores it), all at once, and loaded with ctypes beside the unchanged
library (`base`).

For every `rms_norm` and `flash_decode` case of chip_smoke.py each variant
is held against the plain version at chip_smoke's tolerance; at every case
chip_smoke times, the variants and the source are timed in turns (each
variant, the source, the source, each variant again) with chip_smoke's
`Timer`, the library call once beside them, and a read-only sum over 64
MiB with the same `Timer` as the rate a plain stream of reads reaches
after its flush; at the long decode shapes each launch's device time is
read from `torch.profiler`.  With `--step`, the device ms of one
full-width gemma3-4b decode step (chip_smoke's `device_step_ms`, a CUDA
graph) at the main path's 2 slots x 64 and at the long 8 slots x 4096 is
taken with each variant's kernels in the wrappers' place, in the same
turns.  One JSON line per variant, then the library times and the card's
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
FD, RN = "flash_decode.cu", "rmsnorm.cu"
VARIANTS = {
    "base": {},
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
    # rms_norm: rows (warps) per block
    "rms_2_rows": {RN: {r"kRows = 4;": "kRows = 2;"}},
    "rms_8_rows": {RN: {r"kRows = 4;": "kRows = 8;"}},
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
            out[FD if "flash_decode_f32" in src else RN] = src
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
        shutil.copy(os.path.join(CSRC, "common.cuh"), d)
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
    """The wrappers' library with a variant's `rmsnorm_f32` and
    `flash_decode_f32` in place of the source's, called with the wrappers'
    arguments (the scratch the wrapper sized from the base is left unused):
    a split-K variant gets the scratch its own split count needs, an older
    one the interface it had."""

    def __init__(self, base, lib):
        self.base, self.lib, self.keep = base, lib, None
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.has_rn = hasattr(lib, "rmsnorm_f32")
        self.has_fd = lib.interface is not None
        if self.has_rn:
            lib.rmsnorm_f32.argtypes = [P, P, P, I, I, F, P]
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
    from repro_torch.models import common  # noqa: F401  (turns TF32 off)
    from torch.profiler import ProfilerActivity, profile

    step = "--step" in argv
    argv = [a for a in argv if a != "--step"]
    names = ["base"] + [n for n in (argv or VARIANTS) if n != "base"]
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
    plain = {"rms_norm": ref.rms_norm, "flash_decode": ref.attention}
    wrap = {"rms_norm": _rn.rms_norm, "flash_decode": _fa.flash_decode}
    library = {}
    for name, label, a, main_shape, timed in cs.kernel_cases(torch, 64):
        if name not in wrap:
            continue
        want = cs.run_kernel(torch, plain, name, a)
        tol = cs.TOL[name] * max(float(want.abs().max()), 1.0)
        users = [n for n in names if n == "base"
                 or (kern[n].has_rn if name == "rms_norm" else kern[n].has_fd)]
        for n in users:
            using(kern[n])
            got = cs.run_kernel(torch, wrap, name, a)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            res[n]["cases"][f"{name} {label}"] = dict(
                max_abs_err=err, within_tol=err <= tol, ms=[])
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
    print(json.dumps({"library_ms": library}))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
