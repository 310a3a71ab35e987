#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/` and
holds each against its plain PyTorch version at its path's full-width
shapes.  Then it drives both of the port's paths on the card:

* serving: gemma3-4b at full width (random weights drawn on the card from
  a seed) through the continuous-batching loop, the card against the CPU
  at 2 layers, and a hot weight swap;
* training: ViT-B/16 at full width with Local AdamW under the QSR schedule
  through `train()` (W = 4 workers, 32 images each, 10 rounds), the flat
  layout with the quantized sync for 2 rounds, and the card against the
  CPU at 2 layers;
* the sync variants of that training path at full width, flat layout,
  int8 sync, 2 rounds each: overlap at depth 0 (bitwise the blocking flat
  run) and depth 1 (`synced_view` pure, `flush` clears the pending sync),
  partial participation with the mask [1, 1, 0, 1] (every lane
  re-anchored), and the ring-int8 wire (16 + 12 + 1 launches per sync, the
  card's ring codes equal the CPU's, the mean within `ring_tolerance`);
  and overlap at depth 1 on the card against the CPU at 2 layers.

Each path runs with the kernels' launch counters set to 0 just before it
and read just after, and fails unless every kernel of the path ran.  One
JSON line per phase; any mismatch or error raises, so the exit code is not
0.  The last line is `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of the JAX package.  Needs one CUDA card; without
one (or without the rest of the repository beside it) it exits non-zero
before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet (the published peaks the bounds are computed against)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12         # dense TF32 on the tensor cores
# the attention kernels' times before they moved onto the tensor cores (fp32
# FMAs on the CUDA cores), from this script on an NVIDIA H100 80GB HBM3 at
# 700 W, ViT-B/16's [32,196,12,64]: printed beside this run's for comparison
CUDA_CORE_MS = {"flash_attention_fwd": 0.2834, "flash_attention_bwd": 0.9132}
ARCH = "gemma3-4b"
SLOTS, MAX_NEW = 2, 16
PROMPT_LENS = (16, 48, 32, 24)        # 4 requests, 16-48 tokens: slots recycle
# tolerances x max(|plain|, 1): fp32 sums in another order (the attention
# gradients go through two more contractions); AdamW's bias-correction pow
# may differ by an ulp; the quantized sync is held bitwise
# (the unquantized sync sums fp32 deltas in another order: 1e-6); the
# split sync's apply and the ring's combine and quantize are held bitwise
TOL = {"rms_norm": 1e-5, "swiglu": 2e-5, "flash_decode": 2e-5,
       "flash_attention_fwd": 2e-5, "flash_attention_bwd": 5e-5,
       "adamw_update": 1e-6, "sync_flat_update": 1e-6,
       "sync_apply_update": 0.0, "ring_combine": 0.0, "ring_quantize": 0.0}
REPLACES = {
    "rms_norm": "src/repro/kernels/rmsnorm.py:36",
    "swiglu": "src/repro/kernels/swiglu.py:44",
    "flash_decode": "src/repro/kernels/flash_attention.py:239",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:128",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:128",
    "adamw_update": "src/repro/kernels/adamw_update.py:57",
    "sync_flat_update": "src/repro/kernels/sync_update.py:87",
    "sync_apply_update": "src/repro/kernels/sync_update.py:147",
    "ring_combine": "src/repro/kernels/sync_update.py:186",
    "ring_quantize": "src/repro/kernels/sync_update.py:212",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "rms_norm": CSRC + "rmsnorm.cu",
    "swiglu": CSRC + "swiglu.cu",
    "flash_decode": CSRC + "flash_decode.cu",
    "flash_attention_fwd": CSRC + "flash_attention.cu",
    "flash_attention_bwd": CSRC + "flash_attention.cu",
    "adamw_update": CSRC + "adamw_update.cu",
    "sync_flat_update": CSRC + "sync_update.cu",
    "sync_apply_update": CSRC + "sync_update.cu",
    "ring_combine": CSRC + "ring.cu",
    "ring_quantize": CSRC + "ring.cu",
}
SERVING_KERNELS = ("flash_decode", "rms_norm", "swiglu")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                    "adamw_update", "sync_flat_update")
SYNC_KERNELS = ("sync_apply_update", "ring_combine", "ring_quantize")

# the training main path: examples/vit_local_adamw.py's recipe at full width
TRAIN_ARCH = "vit-b16"
W, B_LOC, IMAGE = 4, 32, 224
TRAIN_RUN = dict(schedule="qsr", optimizer="adamw", total_steps=24,
                 warmup_steps=2, peak_lr=6e-3, end_lr=1e-5, h_base=2,
                 alpha=3.5e-3, weight_decay=0.01, remat=False)
QSR_TRACE = [(t, 2) for t in range(0, 16, 2)] + [(16, 3), (19, 5)]
VIT_PARAMS = 86_332_648


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing --

class Timer:
    """Median device time of one call, from CUDA events around each launch.
    A 256 MB buffer is zeroed before every timed launch so that no input is
    left in the 50 MB L2 by the previous launch: the serving path reads
    every layer's weights and cache cold.  A ~1 ms sleep kernel after the
    flush keeps the device busy while the host enqueues the start event and
    the call, so the host's own time never falls between the events."""

    def __init__(self, torch, iters: int = 25):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)          # ~1 ms of GPU clock cycles
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float,
             peak: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def tensor_core_bound(row) -> None:
    """The attention kernels run every product in 3xTF32 on the tensor cores
    (three TF32 products for each fp32 one), so their bound is that
    arithmetic's against the same bytes.  The fp32 CUDA-core bound the
    kernels had before stays beside it as `bound_fp32_ms`."""
    row["bound_fp32_ms"], row["bound_fp32_by"] = row["bound_ms"], row["bound_by"]
    row["bound_ms"], row["bound_by"] = bound_ms(
        row["bytes"], 3.0 * row["flops"], PEAK_TF32_FLOP_PER_S)
    row["bound_share"] = row["bound_ms"] / row["ms"]


# ------------------------------------------------------- kernel cases ------

def kernel_cases(torch, main_len: int):
    """(kernel, label, inputs dict, is_main_path_shape, timed).  Shapes are
    gemma3-4b's: D 2560, F 10240, Hq 8, Hkv 4, head_dim 256."""
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def ragged(b, hi):
        return torch.randint(0, hi, (b,), generator=g, device="cuda",
                             dtype=torch.int32)

    d, f, hq, hkv, hd = 2560, 10240, 8, 4, 256
    cases = []
    for n, main in ((4, False), (SLOTS, True)):
        cases.append(("rms_norm", f"[{n},{d}]",
                      dict(x=rnd(n, d), scale=rnd(d)), main, True))
    for n, main in ((4, False), (SLOTS, True), (256, False)):
        cases.append(("swiglu", f"[{n},{d}]x[{d},{f}]",
                      dict(x=rnd(n, d), wg=rnd(d, f, std=d ** -0.5),
                           wi=rnd(d, f, std=d ** -0.5)), main, True))

    def fd(b, sk, *, window, prefix_len=0, ring=False, main=False, timed=True):
        kpos = None
        if ring:        # a ring after wrap-around, with empty (-1) slots
            kpos = torch.arange(sk, device="cuda", dtype=torch.int32) + 300
            kpos[: sk // 8] = -1
        label = (f"q[{b},1,{hq},{hd}] kv[{b},{sk},{hkv},{hd}] w{window}"
                 f" p{prefix_len}{' ring' if ring else ''}")
        hi = sk + 300 if ring else sk
        args = dict(q=rnd(b, 1, hq, hd), k=rnd(b, sk, hkv, hd),
                    v=rnd(b, sk, hkv, hd), window=window,
                    prefix_len=prefix_len, q_offset=ragged(b, hi),
                    k_positions=kpos)
        cases.append(("flash_decode", label, args, main, timed))

    fd(4, 512, window=1024)
    fd(4, 512, window=0, timed=False)
    fd(4, 512, window=64, timed=False)
    fd(4, 500, window=1024, ring=True, timed=False)   # Sk % 64 != 0
    fd(4, 500, window=0, prefix_len=37, timed=False)
    fd(SLOTS, main_len, window=1024, main=True)
    return cases


def run_kernel(torch, kernels, name, a):
    if name == "rms_norm":
        return kernels[name](a["x"], a["scale"])
    if name == "swiglu":
        return kernels[name](a["x"], a["wg"], a["wi"])
    return kernels[name](a["q"], a["k"], a["v"], window=a["window"],
                         prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                         k_positions=a["k_positions"])


def library_call(torch, name, a):
    """One PyTorch call computing the same function: timed as a yardstick,
    never used by the port."""
    F = torch.nn.functional
    if name == "rms_norm":
        d = a["x"].shape[-1]
        return lambda: F.rms_norm(a["x"], (d,), a["scale"], 1e-6)
    if name == "swiglu":
        return lambda: F.silu(a["x"] @ a["wg"]) * (a["x"] @ a["wi"])
    from repro_torch.kernels import ref
    q, k, v = a["q"], a["k"], a["v"]
    b, _, hq, hd = q.shape
    sk = k.shape[1]
    mask = ref._mask(1, sk, causal=True, window=a["window"],
                     prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                     k_positions=a["k_positions"], device=q.device)
    mask = mask[:, None]                               # [B,1,1,Sk]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def work(torch, name, a) -> tuple[float, float]:
    """(bytes the function must move, operations it does) for this input."""
    if name == "rms_norm":
        n, d = a["x"].shape
        return 4.0 * (2 * n * d + d), 4.0 * n * d
    if name == "swiglu":
        n, d = a["x"].shape
        f = a["wg"].shape[1]
        return 4.0 * (n * d + 2 * d * f + n * f), 4.0 * n * d * f + 5.0 * n * f
    from repro_torch.kernels import ref
    b, _, hq, hd = a["q"].shape
    sk, hkv = a["k"].shape[1], a["k"].shape[2]
    mask = ref._mask(1, sk, causal=True, window=a["window"],
                     prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                     k_positions=a["k_positions"], device=a["q"].device)
    need = mask[:, 0].sum(-1)                          # keys each row needs
    need = torch.where(need == 0, torch.full_like(need, sk), need)
    keys = float(need.sum())
    nbytes = 4.0 * (2 * b * hq * hd + keys * hkv * hd * 2 + b
                    + (sk if a["k_positions"] is not None else 0))
    flops = keys * hq * (4.0 * hd + 5.0)
    return nbytes, flops


def check_row(name, label, err, scale, main, **extra) -> dict:
    tol = TOL[name] * max(scale, 1.0)
    row = dict(kernel=name, shape=label, main_path_shape=main,
               max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol=tol,
               **extra)
    check(err <= tol, f"{name} {label}: max abs err {err} > tol {tol}")
    return row


def timed_row(row, timer, kernel, plain, library, nbytes, flops) -> dict:
    b_ms, b_by = bound_ms(nbytes, flops)
    row.update(ms=timer(kernel), plain_ms=timer(plain),
               library_ms=None if library is None else timer(library),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    row["kernel_ms"] = row["ms"]
    row["bound_share"] = b_ms / row["ms"]
    return row


def phase_kernels(torch, main_len):
    from repro_torch.kernels import ops, ref
    timer = Timer(torch)
    summary = {}
    for name, label, a, main, timed in kernel_cases(torch, main_len):
        plain = {"rms_norm": ref.rms_norm, "swiglu": ref.swiglu,
                 "flash_decode": ref.attention}[name]
        got = run_kernel(torch, ops.KERNELS, name, a)
        want = run_kernel(torch, {name: plain}, name, a)
        torch.cuda.synchronize()
        row = check_row(name, label, float((got - want).abs().max()),
                        float(want.abs().max()), main)
        if timed:
            lib = library_call(torch, name, a)
            row["library_max_abs_err"] = float((lib() - want).abs().max())
            timed_row(row, timer,
                      lambda: run_kernel(torch, ops.KERNELS, name, a),
                      lambda: run_kernel(torch, {name: plain}, name, a),
                      lib, *work(torch, name, a))
            if main:
                summary[name] = row
        emit("kernel_check", **row)
    return summary


# ------------------------------------------------ training kernels ---------

def attention_work(torch, a, backward: bool) -> tuple[float, float]:
    """(bytes, operations) attention needs at these inputs: each row's
    allowed (query, key) pairs, all Sk keys for a row with none.  Forward:
    read q, k, v, write o and lse; 4 D operations per pair.  Backward: read
    q, k, v, o, dout, lse, write dq, dk, dv; 10 D per pair (S, dP, dV, dK,
    dQ)."""
    from repro_torch.kernels import ref
    b, sq, hq, d = a["q"].shape
    sk, hkv = a["k"].shape[1], a["k"].shape[2]
    m = ref._mask(sq, sk, causal=a["causal"], window=a["window"],
                  prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                  device=a["q"].device)
    need = m.sum(-1)
    need = torch.where(need == 0, torch.full_like(need, sk), need)
    pairs = float(need.sum()) * b * hq
    qo, kv, lse = 4.0 * b * sq * hq * d, 4.0 * b * sk * hkv * d, 4.0 * b * hq * sq
    if backward:
        return 4 * qo + 4 * kv + lse, pairs * 10.0 * d
    return 2 * qo + 2 * kv + lse, pairs * 4.0 * d


def attention_cases(rnd):
    """(label, inputs, main-path shape?, timed?).  The main path's: ViT-B/16,
    [32,196,12,64] non-causal (196 tokens: no tile divides it).  Also timed:
    a gemma3-4b prefill of 2048 tokens through a sliding-window layer (D =
    256, GQA 2), and a causal D = 128 case with GQA 4."""
    def fa(label, b, sq, sk, hkv, g, d, causal, window=0, prefix_len=0,
           q_offset=0, main=False, timed=False):
        return (label, dict(q=rnd(b, sq, hkv * g, d), k=rnd(b, sk, hkv, d),
                            v=rnd(b, sk, hkv, d), dout=rnd(b, sq, hkv * g, d),
                            causal=causal, window=window,
                            prefix_len=prefix_len, q_offset=q_offset), main,
                main or timed)
    return [
        fa("vit-b q[32,196,12,64] non-causal", 32, 196, 196, 12, 1, 64,
           False, main=True),
        fa("gemma3-4b prefill q[1,2048,8,256] kv[.,.,4,.] causal window 1024",
           1, 2048, 2048, 4, 2, 256, True, window=1024, timed=True),
        fa("q[4,1024,16,128] kv[.,.,4,.] gqa 4 causal", 4, 1024, 1024, 4, 4,
           128, True, timed=True),
        fa("q[4,300,8,64] causal", 4, 300, 300, 8, 1, 64, True),
        fa("q[4,300,8,64] causal window 64", 4, 300, 300, 8, 1, 64, True,
           window=64),
        fa("q[4,300,8,64] causal prefix 17", 4, 300, 300, 8, 1, 64, True,
           prefix_len=17),
        fa("q[2,300,8,64] kv 500 causal q_offset 200", 2, 300, 500, 8, 1, 64,
           True, q_offset=200),
        fa("q[2,256,8,128] kv[.,.,4,.] gqa 2 causal", 2, 256, 256, 4, 2, 128,
           True),
        fa("q[2,256,8,128] kv[.,.,2,.] gqa 4 causal", 2, 256, 256, 2, 4, 128,
           True),
        fa("q[1,130,4,256] gqa 2 window 32 prefix 5", 1, 130, 130, 2, 2, 256,
           True, window=32, prefix_len=5),
    ]


def sdpa_inputs(torch, a):
    """SDPA's operands for the same function as the attention case `a`:
    [B,H,S,D] views that require grad, the kv heads repeated for GQA, and
    the mask as a boolean attn_mask (None where every key is allowed)."""
    from repro_torch.kernels import ref
    q, k, v = a["q"], a["k"], a["v"]
    gh = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if gh > 1:
        kt, vt = (x.repeat_interleave(gh, dim=1) for x in (kt, vt))
    am = None
    if a["causal"] or a["window"] or a["prefix_len"]:
        am = ref._mask(q.shape[1], k.shape[1], causal=a["causal"],
                       window=a["window"], prefix_len=a["prefix_len"],
                       q_offset=a["q_offset"], device=q.device)
    return (*(x.detach().requires_grad_(True) for x in (qt, kt, vt)), am)


def phase_training_kernels(torch):
    """flash_attention forward and backward, adamw_update and
    sync_flat_update against their plain versions at the training path's
    shapes, with kernel / plain / library / bound times at the main path's."""
    from repro_torch.kernels import adamw_update as _ad
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import sync_update as _su
    F = torch.nn.functional
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    summary = {}
    for label, a, main, timed in attention_cases(rnd):
        q, k, v, do = a["q"], a["k"], a["v"], a["dout"]
        mask = {key: a[key] for key in ("causal", "window", "prefix_len",
                                        "q_offset")}
        kw = dict(mask, scale=q.shape[-1] ** -0.5)
        o, lse = _fa.flash_attention_fwd(q, k, v, **kw)
        grads = _fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = ref.attention(*ins, **mask)
        want_g = torch.autograd.grad(want, ins, do, retain_graph=True)
        torch.cuda.synchronize()
        err = float((o - want.detach()).abs().max())
        fwd = check_row("flash_attention_fwd", label, err,
                        float(want.detach().abs().max()), main)
        gerr = max(float((x - y).abs().max()) for x, y in zip(grads, want_g))
        bwd = check_row("flash_attention_bwd", label, gerr,
                        max(float(y.abs().max()) for y in want_g), main)
        if timed:
            qt, kt, vt, am = sdpa_inputs(torch, a)
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
            dot = do.transpose(1, 2)
            with torch.no_grad():
                timed_row(fwd, timer,
                          lambda: _fa.flash_attention_fwd(q, k, v, **kw),
                          lambda: ref.attention(q, k, v, **mask),
                          lambda: F.scaled_dot_product_attention(
                              qt, kt, vt, attn_mask=am),
                          *attention_work(torch, a, False))
            timed_row(bwd, timer,
                      lambda: _fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw),
                      lambda: torch.autograd.grad(want, ins, do,
                                                  retain_graph=True),
                      lambda: torch.autograd.grad(lib, (qt, kt, vt), dot,
                                                  retain_graph=True),
                      *attention_work(torch, a, True))
            tensor_core_bound(fwd)
            tensor_core_bound(bwd)
        if main:
            # no atomics, a fixed summation order: a second run on the same
            # inputs gives the same bits (the overlap gate rests on it)
            o2, lse2 = _fa.flash_attention_fwd(q, k, v, **kw)
            grads2 = _fa.flash_attention_bwd(q, k, v, o2, lse2, do, **kw)
            torch.cuda.synchronize()
            same = all(bool(torch.equal(x, y)) for x, y in
                       zip((o, lse, *grads), (o2, lse2, *grads2)))
            check(same, f"flash_attention {label}: a second run differs")
            fwd["bitwise_repeat"] = bwd["bitwise_repeat"] = same
            del o2, lse2, grads2

            def fwd_bwd(fn, xs, d_out):
                out = fn(*xs)
                return torch.autograd.grad(out, xs, d_out)
            kq = [x.detach().requires_grad_(True) for x in (q, k, v)]
            bwd["kernel_fwd_bwd_ms"] = timer(lambda: fwd_bwd(
                lambda *x: _fa.flash_attention(*x, **mask), kq, do))
            bwd["library_fwd_bwd_ms"] = timer(lambda: fwd_bwd(
                F.scaled_dot_product_attention, (qt, kt, vt), dot))
            summary["flash_attention_fwd"], summary["flash_attention_bwd"] = \
                fwd, bwd
        if timed:
            del lib
        emit("kernel_check", **fwd)
        emit("kernel_check", **bwd)
        del o, lse, grads, ins, want, want_g

    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                 step=torch.tensor(5.0))
    for label, shape, main in (
            ("largest tree leaf [4,12,768,3072]", (W, 12, 768, 3072), True),
            (f"flat bucket [4,{VIT_PARAMS}]", (W, VIT_PARAMS), False)):
        p, m, grad = rnd(*shape, std=0.02), rnd(*shape, std=1e-3), \
            rnd(*shape, std=1e-2)
        v = rnd(*shape, std=1e-3).abs_()
        want = ref.adamw_update(p, m, v, grad, **hyper)
        got = _ad.adamw_update(p.clone(), m.clone(), v.clone(), grad, **hyper)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        row = check_row("adamw_update", label, err,
                        max(float(y.abs().max()) for y in want), main)
        del want, got
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = grad
        lib = torch.optim.AdamW([lib_p], lr=3e-3, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.01, fused=True)
        n = p.numel()
        timed_row(row, timer,
                  lambda: _ad.adamw_update(p, m, v, grad, **hyper),
                  lambda: ref.adamw_update(p, m, v, grad, **hyper),
                  lib.step, 28.0 * n, 16.0 * n)
        if main:
            summary["adamw_update"] = row
        emit("kernel_check", **row)
        del p, m, v, grad, lib_p, lib

    n = VIT_PARAMS
    anchor = rnd(n, std=0.02)
    p = anchor[None] + rnd(W, n, std=1e-3)
    scale = (rnd(n).abs_() + 0.1) * 3e-3
    mu0 = rnd(n, std=1e-4)
    for quantize, momentum in ((True, 0.0), (False, 0.0), (True, 0.9),
                               (False, 0.9)):
        kw = dict(scale=scale if quantize else None,
                  mu=mu0 if momentum else None, momentum=momentum)
        label = (f"[{W},{n}] quantize {'on' if quantize else 'off'} "
                 f"momentum {momentum}")
        want = ref.sync_flat_update(p, anchor, **kw)
        got = _su.sync_flat_update(
            p.clone(), anchor.clone(), scale=kw["scale"],
            mu=None if kw["mu"] is None else mu0.clone(), momentum=momentum)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want)
                  if y is not None)
        if quantize:        # integer codes, no FMA: bitwise
            check(err == 0.0, f"sync_flat_update {label}: not bitwise "
                  f"({err})")
        row = check_row("sync_flat_update", label, err,
                        float(want[0].abs().max()), quantize and not momentum,
                        bitwise=err == 0.0)
        del want, got
        pk, ak = p.clone(), anchor.clone()
        muk = None if kw["mu"] is None else mu0.clone()
        words = 2 * W + 2 + quantize + 2 * (momentum > 0)
        timed_row(row, timer,
                  lambda: _su.sync_flat_update(pk, ak, scale=kw["scale"],
                                               mu=muk, momentum=momentum),
                  lambda: ref.sync_flat_update(p, anchor, **kw), None,
                  4.0 * n * words, n * (W * (5.0 if quantize else 2.0) + 6))
        if quantize and not momentum:
            summary["sync_flat_update"] = row
        emit("kernel_check", **row)
        del pk, ak, muk
    del p, anchor, scale, mu0
    torch.cuda.empty_cache()
    return summary


def phase_sync_kernels(torch):
    """sync_apply_update on the flat bucket [86,332,648] and the ring's
    combine and quantize on one ring chunk [21,583,162] (the main path's
    shapes), each held bitwise against its plain version, with kernel /
    plain / bound times.  The ring chunks of the main path sit at offsets
    of c x C elements in the bucket's delta, so half of them are not
    16-byte aligned: the combine is also timed on such a view."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sync_update as _su
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2468)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def bitwise(name, label, got, want, main):
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want) if y is not None)
        same = all(bool(torch.equal(x, y)) for x, y in zip(got, want)
                   if y is not None)
        check(same, f"{name} {label}: not bitwise ({err})")
        return check_row(name, label, err, max(float(y.float().abs().max())
                                               for y in want
                                               if y is not None), main,
                         bitwise=True)

    summary = {}
    n = VIT_PARAMS
    anchor = rnd(n, std=0.02)
    codes = torch.round(rnd(n) * 40).clamp_(-127, 127)  # a W = 4 code mean
    qmean = ref.true_div(codes, 4.0)
    scale = (rnd(n).abs_() + 0.1) * 3e-3
    delta = rnd(n, std=1e-3)
    mu0 = rnd(n, std=1e-4)
    for quantize, momentum in ((True, 0.0), (True, 0.9), (False, 0.9)):
        step = qmean if quantize else delta
        kw = dict(scale=scale if quantize else None,
                  mu=mu0 if momentum else None, momentum=momentum)
        label = (f"[{n}] quantize {'on' if quantize else 'off'} "
                 f"momentum {momentum}")
        want = ref.sync_apply_update(step, anchor, **kw)
        got = _su.sync_apply_update(step, anchor, **kw)
        torch.cuda.synchronize()
        row = bitwise("sync_apply_update", label, got, want, True)
        del want, got
        words = 3 + quantize + 2 * (momentum > 0)
        timed_row(row, timer,
                  lambda: _su.sync_apply_update(step, anchor, **kw),
                  lambda: ref.sync_apply_update(step, anchor, **kw), None,
                  4.0 * n * words,
                  n * (1.0 + 2 * quantize + 4 * (momentum > 0)))
        if quantize and not momentum:
            summary["sync_apply_update"] = row
        emit("kernel_check", **row)
    del anchor, codes, qmean, scale, delta, mu0

    c = VIT_PARAMS // W
    buf = rnd(2 * c + 2, std=1e-3)
    x, x_off = buf[:c], buf[c + 2 + 1:][:c - 1]
    acc = rnd(c, std=1e-3)
    s = acc.abs().max()
    want = ref.ring_quantize_codes(acc, s)
    got = _su.ring_quantize(acc, s)
    torch.cuda.synchronize()
    row = bitwise("ring_quantize", f"[{c}]", (got,), (want,), True)
    timed_row(row, timer, lambda: _su.ring_quantize(acc, s),
              lambda: ref.ring_quantize_codes(acc, s), None, 5.0 * c + 4,
              4.0 * c)
    summary["ring_quantize"] = row
    emit("kernel_check", **row)
    q = got
    for k in (1, 2, 3):
        want = ref.ring_combine(q, s, x, k)
        got = _su.ring_combine(q, s, x, k)
        got_off = _su.ring_combine(q[:c - 1], s, x_off, k)
        want_off = ref.ring_combine(q[:c - 1], s, x_off, k)
        torch.cuda.synchronize()
        row = bitwise("ring_combine", f"[{c}] k {k}", got + got_off,
                      want + want_off, True)
        if k == 1:
            timed_row(row, timer, lambda: _su.ring_combine(q, s, x, k),
                      lambda: ref.ring_combine(q, s, x, k), None,
                      9.0 * c + 8, 6.0 * c)
            row["ms_unaligned_x"] = timer(
                lambda: _su.ring_combine(q[:c - 1], s, x_off, k))
            summary["ring_combine"] = row
        emit("kernel_check", **row)
        del want, got, got_off, want_off
    del buf, acc, q
    torch.cuda.empty_cache()
    return summary


# ----------------------------------------------------------- serving -------

def prompts_for(cfg, np):
    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in PROMPT_LENS]


def phase_service(torch, np):
    from repro_torch.configs import registry as R
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.launch.serve import run_service

    cfg = R.get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = prompts_for(cfg, np)
    max_len = max(PROMPT_LENS) + MAX_NEW

    # the main path: counts at 0 just before, read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs, audit = run_service(cfg, weights, prompts, slots=SLOTS,
                              max_new=MAX_NEW, max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = audit["decode_steps"]

    check(all(r.done and len(r.out) == MAX_NEW for r in reqs),
          "not every request finished with its tokens")
    want = {k: 0 for k in counts}
    want.update(rms_norm=(2 * cfg.n_layers + 1) * steps,
                swiglu=cfg.n_layers * steps,
                flash_decode=cfg.n_layers * steps)
    check(counts == want, f"launch counts {counts} != expected {want}")
    per_step = {k: v / steps for k, v in counts.items()}

    # each request served alone in 1 slot must emit the same tokens
    for r, p in zip(reqs, prompts):
        solo, _ = run_service(cfg, weights, [p], slots=1, max_new=MAX_NEW,
                              max_len=max_len)
        check(solo[0].out == r.out,
              f"request {r.rid}: batched {r.out} != solo {solo[0].out}")

    device_ms = device_step_ms(torch, cfg, weights, max_len)

    # bytes one decode step must read: every weight once + the whole cache
    w_bytes = sum(b.numel() * b.element_size() for b in weights.bufs.values())
    kv_bytes = 2 * cfg.n_layers * SLOTS * max_len * cfg.n_kv_heads * cfg.hd * 4
    floor_ms = (w_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    # the card's own copy rate: read + write of a 4 GiB buffer
    src = torch.empty(1 << 30, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dst.copy_(src)
    torch.cuda.synchronize()
    copy_rate = 5 * 2 * src.numel() * 4 / (time.perf_counter() - t0)
    del src, dst
    tokens = audit["tokens_emitted"]
    emit("service", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=sum(b.numel() for b in weights.bufs.values()),
         weight_init_s=init_s, slots=SLOTS, requests=len(reqs),
         prompt_lens=list(PROMPT_LENS), max_new=MAX_NEW, decode_steps=steps,
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         ms_per_step=wall / steps * 1e3, device_ms_per_step=device_ms,
         device_busy_share=device_ms / (wall / steps * 1e3),
         step_bytes=w_bytes + kv_bytes,
         floor_ms_datasheet=floor_ms,
         floor_ms_measured_copy_rate=(w_bytes + kv_bytes) / copy_rate * 1e3,
         copy_rate_bytes_per_s=copy_rate, launches=counts,
         launches_per_step=per_step, solo_match=True,
         peak_mem_gb=peak_gb)
    del weights, reqs
    torch.cuda.empty_cache()
    return counts


def device_step_ms(torch, cfg, weights, max_len, reps: int = 10) -> float:
    """Device time of one full-width decode step without the host's launch
    gaps: the step is captured once in a CUDA graph and the graph replayed
    back to back between two events.  Measurement only — the port itself
    launches eagerly."""
    from repro_torch.models import api
    mod = api.get_module(cfg)
    cache = mod.init_cache(cfg, SLOTS, max_len, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.long, device="cuda")
    pos = torch.tensor([max_len // 2, max_len - 1], dtype=torch.int32,
                       device="cuda")
    tree = weights.as_tree()
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                mod.decode_step(cfg, tree, tok, cache, pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            mod.decode_step(cfg, tree, tok, cache, pos)
        graph.replay()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
    del graph
    return ev[0].elapsed_time(ev[1]) / reps


def phase_card_vs_cpu(torch, np):
    """gemma3-4b widths at 2 layers: same weights on the card (kernels) and
    on the CPU (plain versions), teacher-forced decode steps."""
    from repro_torch.configs import registry as R
    from repro_torch.launch import weights as W
    from repro_torch.models import api

    cfg = dataclasses.replace(R.get_config(ARCH), n_layers=2)
    mod = api.get_module(cfg)
    card = W.ServingWeights.from_seed(cfg, 3, device="cuda")
    host = card.spec.unflatten({b: v.cpu() for b, v in card.bufs.items()})
    cpu = W.ServingWeights(cfg, host, device="cpu")
    b, max_len, n_steps = SLOTS, 16, 6
    caches = {dev: mod.init_cache(cfg, b, max_len, device=dev)
              for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(11)
    # fp32 sums over D=2560 / F=10240 in another order on each side: ~1e-6
    # relative per product, through 2 layers and the 262144-way unembed
    tol = 2e-4
    worst, agree, decided = 0.0, 0, 0
    with torch.no_grad():
        for i in range(n_steps):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, b))
            pos = torch.tensor([i, i + 3], dtype=torch.int32)
            lc, _ = mod.decode_step(cfg, card.as_tree(), tok.cuda(),
                                    caches["cuda"], pos.cuda())
            lh, _ = mod.decode_step(cfg, cpu.as_tree(), tok, caches["cpu"],
                                    pos)
            lc = lc.cpu()
            worst = max(worst, float((lc - lh).abs().max()))
            top2 = torch.topk(lh, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
            same = lc.argmax(-1) == lh.argmax(-1)
            decided += int(sure.sum())
            agree += int((same & sure).sum())
    check(worst <= tol, f"card vs CPU logits differ by {worst} > {tol}")
    check(agree == decided, f"greedy tokens differ: {agree}/{decided}")
    emit("card_vs_cpu", layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, steps=n_steps, batch=b, max_abs_logit_err=worst,
         tol=tol, greedy_agree=agree, greedy_decided=decided)
    del card, cpu, caches
    torch.cuda.empty_cache()


def phase_hot_swap(torch, np):
    """Smoke config on the card: an in-process publish mid-sequence; the
    post-swap tokens equal a server restarted on the new weights."""
    from repro_torch.configs import registry as R
    from repro_torch.launch import weights as W
    from repro_torch.launch.batching import ContinuousBatcher, Request

    cfg = R.get_smoke_config(ARCH)
    w0 = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    w1 = W.ServingWeights.from_seed(cfg, 7, device="cuda").as_tree()
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 5,
                                               dtype=np.int32)
    sub = W.WeightSubscriber()
    batcher = ContinuousBatcher(cfg, w0, slots=2, max_len=48, subscriber=sub)
    req = Request(rid=0, prompt=prompt, max_new=8)
    batcher.submit(req)
    while len(req.out) < 3:
        batcher.step()
    sub.publish(1, w1)
    batcher.run()
    check(req.done and len(req.out) == 8 and batcher.swaps == 1,
          "hot swap did not complete")
    check(req.epochs == [0] * 3 + [1] * 5, f"epochs {req.epochs}")
    restart = ContinuousBatcher(cfg, W.ServingWeights(cfg, w1, device="cuda"),
                                slots=2, max_len=48)
    rref = Request(rid=0, prompt=np.concatenate(
        [prompt, np.asarray(req.out[:3], np.int32)]), max_new=5)
    restart.submit(rref)
    restart.run()
    check(rref.out == req.out[3:],
          f"post-swap {req.out[3:]} != restart {rref.out}")
    emit("hot_swap", arch=cfg.name, tokens=req.out, epochs=req.epochs,
         restart_tokens=rref.out, match=True)


# ---------------------------------------------------------- training -------

def train_setup(torch, *, layout="tree", n_layers=None, workers=None,
                b_loc=None, device="cuda", sync="blocking", overlap_depth=0,
                **run_overrides):
    """(cfg, run config, stream, batch_fn, engine) of the ViT-B/16 recipe
    (W workers x B_LOC images unless given)."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.engine import RoundEngine
    from repro_torch.data.synthetic import VisionStream, vision_batch_fn

    cfg = R.get_config(TRAIN_ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    run = RunConfig(**{**TRAIN_RUN, **run_overrides})
    workers, b_loc = workers or W, b_loc or B_LOC
    stream = VisionStream(n_classes=cfg.n_classes, image=IMAGE, seed=42)
    batch_fn = vision_batch_fn(stream, workers, b_loc)
    eng = RoundEngine(cfg, run, workers=workers, b_loc=b_loc, seq=1,
                      data="host", layout=layout, batch_fn=batch_fn,
                      sync=sync, overlap_depth=overlap_depth, device=device)
    return cfg, run, stream, batch_fn, eng


def step_flops(cfg, images: int, tokens: int) -> float:
    """Matmul + attention FLOPs of one local step (forward + backward = 3x
    the forward) over `images` images, from the shapes."""
    d, f, pd = cfg.d_model, cfg.d_ff, 16 * 16 * 3
    per_image = (2 * tokens * pd * d
                 + cfg.n_layers * (2 * tokens * d * 4 * d      # q, k, v, o
                                   + 2 * tokens * d * 2 * f    # wi, wo
                                   + 4 * tokens * tokens * d)  # QK^T, PV
                 + 2 * d * cfg.n_classes)
    return 3.0 * per_image * images


def lanes_equal(torch, state, anchor=None) -> bool:
    """Every worker lane of every params leaf bitwise equal (to the
    anchor, when given)."""
    from repro_torch import tree as T
    if anchor is None:
        return all(bool(torch.equal(x, x[:1].expand_as(x)))
                   for x in T.leaves(state["params"]))
    return all(bool(torch.equal(state["params"][b], anchor[b][None]
                                .expand_as(state["params"][b])))
               for b in anchor)


def phase_train(torch, np):
    """The training main path: ViT-B/16 at full width, Local AdamW under
    QSR through `train()`, W = 4 x 32 images of 224^2, 10 rounds."""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import vit

    cfg, run, stream, batch_fn, eng = train_setup(torch)
    check_s = [0.0]

    def eval_fn(t, state):                # after each round's sync
        t0 = time.perf_counter()
        check(lanes_equal(torch, state), f"lanes differ after the sync at {t}")
        check_s[0] += time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()             # the main path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = train(cfg, run, workers=W, b_loc=B_LOC, seq=1, data="host",
                        eng=eng, eval_fn=eval_fn, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    counts = ops.launch_counts()          # ... read just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = run.total_steps
    rounds = [dict(t_end=t, h=h, lr=lr, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   divergence=float(m["divergence"]))
              for (t, h, _, lr), m in zip(hist, eng.round_metrics)]
    check([(t - h, h) for t, h, _, _ in hist] == QSR_TRACE,
          f"H trace {[(t - h, h) for t, h, _, _ in hist]} != {QSR_TRACE}")
    check(eng.h_trace == QSR_TRACE, f"engine trace {eng.h_trace}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rounds), "a non-finite loss or grad norm")
    check(all(r["divergence"] > 0 for r in rounds),
          "zero worker divergence before a sync")
    attn = cfg.n_layers * W * steps       # one call per layer per worker
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=attn, flash_attention_bwd=attn,
                adamw_update=16 * steps)  # one per leaf per step (tree)
    check(counts == want, f"launch counts {counts} != expected {want}")
    for r in rounds:
        emit("train_round", **r)

    # held-out accuracy of the final params, as the example computes it
    final = eng.params_single(state)
    with torch.no_grad():
        accs = []
        for i in range(8):
            xs, ys = stream.batch(50_000 + i, 0, 64, noisy=False)
            accs.append(float(vit.accuracy(cfg, final, {
                "images": xs.cuda(), "labels": ys.cuda()})))

    # device time of one local step (CUDA events, data already on the card)
    # and of one sync, on the final state
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    batch = T.map(lambda x: x.cuda(), batch_fn(0))
    state, _ = step_fn(state, batch, 1e-5)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(3):
        state, _ = step_fn(state, batch, 1e-5)
    ev[1].record()
    sync = make_sync(run)
    with torch.no_grad():
        ev[2].record()
        for _ in range(3):
            state = sync(state)
        ev[3].record()
    torch.cuda.synchronize()
    device_ms = ev[0].elapsed_time(ev[1]) / 3
    sync_ms = ev[2].elapsed_time(ev[3]) / 3

    images = W * B_LOC
    flops = step_flops(cfg, images, (IMAGE // 16) ** 2)
    wall_ms = wall / steps * 1e3
    data_ms = eng.data_seconds / steps * 1e3
    emit("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=VIT_PARAMS, workers=W, b_loc=B_LOC, image=IMAGE,
         steps=steps, rounds=len(rounds), h_trace=eng.h_trace,
         wall_s=wall, wall_ms_per_step=wall_ms, data_ms_per_step=data_ms,
         device_ms_per_step=device_ms,
         device_busy_share=device_ms / wall_ms,
         images_per_s=images * steps / wall, sync_ms=sync_ms,
         flop_per_step=flops,
         flop_floor_ms_per_step=flops / PEAK_FP32_FLOP_PER_S * 1e3,
         achieved_tflop_s=flops / device_ms / 1e9,
         launches=counts,
         launches_per_step={k: v / steps for k, v in counts.items()},
         peak_mem_gb=peak_gb, heldout_acc=float(np.mean(accs)),
         final_loss=rounds[-1]["loss"], lanes_equal_after_sync=True)
    del state, final, eng
    torch.cuda.empty_cache()
    return counts


def phase_train_flat_quantized(torch, np):
    """The same model and data at full width, layout flat with the int8
    sync, 2 rounds of H = 2: one adamw_update per step and one
    sync_flat_update per round, all lanes equal to the anchor after it.
    Returns the counts and the final state (the overlap phase's bitwise
    reference)."""
    from repro_torch import tree as T
    from repro_torch.core import sync as S

    def eval_fn(t, state):
        check(lanes_equal(torch, state, state["anchor"]),
              f"flat lanes differ from the anchor after the sync at {t}")

    eng, state, hist, counts, wall = run_variant(
        torch, np, "train_flat_quantized", sync="blocking", eval_fn=eval_fn)
    expect_counts("train_flat_quantized", eng.cfg, counts, sync_flat_update=2)
    sync = S.make_sync(eng.run_cfg, spec=eng.spec)
    scratch = T.map(torch.clone, state)     # the fused sync works in place
    with torch.no_grad():
        ms = sync_ms(torch, lambda: sync(scratch))
    emit("train_flat_quantized", arch=eng.cfg.name, layout="flat",
         buckets=list(eng.spec.sizes.items()), sync_quantize=True,
         rounds=[dict(t_end=t, h=h, loss=loss,
                      divergence=float(m["divergence"]))
                 for (t, h, loss, _), m in zip(hist, eng.round_metrics)],
         wall_s=wall, launches=counts, lanes_equal_anchor=True,
         sync_wall_ms=ms[0], sync_device_ms=ms[1])
    del eng, scratch
    torch.cuda.empty_cache()
    return counts, state


def sync_ms(torch, fn, reps: int = 3) -> tuple[float, float]:
    """(host wall ms, device ms from CUDA events) of one call of `fn`,
    averaged over `reps` back-to-back calls after a warm-up call, with the
    device synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / reps * 1e3,
            ev[0].elapsed_time(ev[1]) / reps)


def run_variant(torch, np, phase, *, sync, depth=0, mask=None, eval_fn=None,
                **run_overrides):
    """2 rounds of H = 2 of the full-width recipe on the flat layout with
    the int8 sync, through `train()`; launch counts at 0 just before, read
    just after.  Returns (engine, flushed state, history, counts, wall s)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    cfg, run, _, _, eng = train_setup(
        torch, layout="flat", schedule="constant", total_steps=4,
        sync_quantize=True, sync=sync, overlap_depth=depth, **run_overrides)
    if mask is not None:
        eng.membership_epoch(mask)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = train(cfg, run, workers=W, b_loc=B_LOC, seq=1, data="host",
                        layout="flat", sync=sync, overlap_depth=depth,
                        eng=eng, eval_fn=eval_fn, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check([(t - h, h) for t, h, _, _ in hist] == [(0, 2), (2, 2)],
          f"{phase}: rounds {hist}")
    check(all(np.isfinite(loss) for _, _, loss, _ in hist),
          f"{phase}: a non-finite loss")
    check(eng._pending is None, f"{phase}: a sync still pending after train()")
    return eng, state, hist, counts, wall


def expect_counts(phase, cfg, counts, **sync_launches):
    """4 local steps of W workers: 4 AdamW launches (one flat bucket) and
    one attention forward and backward per layer per worker per step."""
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=cfg.n_layers * W * 4,
                flash_attention_bwd=cfg.n_layers * W * 4, adamw_update=4,
                **sync_launches)
    check(counts == want, f"{phase}: launch counts {counts} != {want}")


def states_equal(torch, a, b) -> bool:
    from repro_torch import tree as T
    la, ta = T.flatten(a)
    lb, tb = T.flatten(b)
    return ta == tb and all(bool(torch.equal(x, y)) for x, y in zip(la, lb))


def phase_train_overlap(torch, np, blocking_state):
    """sync="overlap" on the full-width flat quantized run.  Depth 0: the
    final state bitwise the blocking phase's (same seed and data), with one
    sync_apply_update per sync and no fused sync.  Depth 1 with outer
    momentum 0.9: finite, nothing pending after `train()`; then on 2 more
    rounds driven through the engine, `synced_view` twice and `flush` agree
    bitwise and leave the state untouched."""
    from repro_torch import tree as T
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops

    eng, state, hist, counts, wall = run_variant(torch, np, "train_overlap",
                                                 sync="overlap", depth=0)
    expect_counts("train_overlap d0", eng.cfg, counts, sync_apply_update=2)
    check(states_equal(torch, state, blocking_state),
          "overlap at depth 0 is not bitwise the blocking flat run")
    begin = S.make_sync_begin(eng.run_cfg, eng.spec)
    apply_ = S.make_sync_apply(eng.run_cfg, eng.spec)
    with torch.no_grad():
        pending = begin(state)
        begin_ms = sync_ms(torch, lambda: begin(state))
        apply_ms = sync_ms(torch, lambda: apply_(state, pending))
    del state, pending, eng

    eng1, state1, hist1, counts1, wall1 = run_variant(
        torch, np, "train_overlap", sync="overlap", depth=1,
        outer_momentum=0.9)
    expect_counts("train_overlap d1", eng1.cfg, counts1, sync_apply_update=2)
    st = state1
    for t in (4, 6):
        st, _ = eng1.run_round(st, t, 2, lambda i: 1e-4)
    before = [x.clone() for x in T.leaves(st)]
    ops.reset_launch_counts()
    v1, v2 = eng1.synced_view(st), eng1.synced_view(st)
    check(all(bool(torch.equal(a, b)) for a, b in zip(T.leaves(st), before)),
          "synced_view changed the training state")
    fl = eng1.flush(st)
    check(states_equal(torch, v1, v2) and states_equal(torch, v1, fl),
          "synced_view twice and flush disagree")
    check(ops.launch_counts()["sync_apply_update"] == 3,
          f"views + flush launches {ops.launch_counts()}")
    check(all(bool(torch.isfinite(x).all()) for x in T.leaves(fl["params"])),
          "overlap depth 1: non-finite params")
    emit("train_overlap", arch=eng1.cfg.name, layout="flat",
         sync_quantize=True,
         depth0=dict(rounds=[(t, h, loss) for t, h, loss, _ in hist],
                     wall_s=wall, launches=counts,
                     bitwise_blocking=True, begin_wall_ms=begin_ms[0],
                     begin_device_ms=begin_ms[1], apply_wall_ms=apply_ms[0],
                     apply_device_ms=apply_ms[1]),
         depth1_momentum09=dict(rounds=[(t, h, loss)
                                        for t, h, loss, _ in hist1],
                                wall_s=wall1, launches=counts1,
                                synced_view_pure=True,
                                flush_equals_views=True))
    del eng1, state1, st, before, v1, v2, fl
    torch.cuda.empty_cache()
    return counts


def phase_train_partial(torch, np):
    """sync="partial" with the mask [1, 1, 0, 1]: the mean over lanes 0, 1
    and 3, every lane (lane 2 too) equal to the anchor after each sync, one
    sync_apply_update per sync."""
    from repro_torch.core import sync as S

    def eval_fn(t, state):
        check(lanes_equal(torch, state, state["anchor"]),
              f"partial: a lane differs from the anchor after the sync at {t}")

    mask = [1.0, 1.0, 0.0, 1.0]
    eng, state, hist, counts, wall = run_variant(
        torch, np, "train_partial", sync="partial", mask=mask,
        eval_fn=eval_fn)
    expect_counts("train_partial", eng.cfg, counts, sync_apply_update=2)
    sync = S.make_sync_partial(eng.run_cfg, eng.spec)
    m = torch.tensor(mask, device="cuda")
    with torch.no_grad():
        ms = sync_ms(torch, lambda: sync(state, m))
    emit("train_partial", arch=eng.cfg.name, membership=mask,
         epochs=[dataclasses.asdict(e) for e in eng.epochs],
         rounds=[(t, h, loss) for t, h, loss, _ in hist], wall_s=wall,
         launches=counts, lanes_equal_anchor=True, sync_wall_ms=ms[0],
         sync_device_ms=ms[1])
    del eng, state
    torch.cuda.empty_cache()
    return counts


def phase_train_ring(torch, np):
    """sync_wire="ring-int8", blocking: per sync exactly 16 ring_quantize +
    12 ring_combine + 1 sync_apply_update launches; the first sync's codes
    and scales on the card equal `ring_codes_host` on the CPU for the same
    delta, bitwise; its dequantized mean within `ring_tolerance(4, amax)`
    of the exact mean."""
    from repro_torch.core import sync as S

    real, seen = S.ring_codes_host, []

    def record(d, w=None):
        out = real(d, w)
        if not seen:
            seen.append((d.cpu(), out[0].cpu(), out[1].cpu()))
        return out

    S.ring_codes_host = record
    try:
        eng, state, hist, counts, wall = run_variant(
            torch, np, "train_ring", sync="blocking",
            sync_wire="ring-int8")
    finally:
        S.ring_codes_host = real
    expect_counts("train_ring", eng.cfg, counts, ring_quantize=2 * 16,
                  ring_combine=2 * 12, sync_apply_update=2)
    d, q, s = seen[0]
    qc, sc = S.ring_codes_host(d)
    check(bool(torch.equal(q, qc)) and bool(torch.equal(s, sc)),
          "ring codes on the card differ from the CPU's")
    n = d.shape[1]
    mean = q.reshape(-1)[:n].float() * s[:, None].expand(q.shape).reshape(
        -1)[:n] / 127.0
    err = float((mean - d.mean(0)).abs().max())
    amax = float(d.abs().max())
    tol = S.ring_tolerance(W, amax)
    check(err <= tol, f"ring mean off the exact mean by {err} > {tol}")
    sync = S.make_sync(eng.run_cfg, spec=eng.spec)
    with torch.no_grad():
        ms = sync_ms(torch, lambda: sync(state))
    emit("train_ring", arch=eng.cfg.name, wire="ring-int8",
         rounds=[(t, h, loss) for t, h, loss, _ in hist], wall_s=wall,
         launches=counts, launches_per_sync={k: v / 2 for k, v in
                                             counts.items() if k in
                                             SYNC_KERNELS},
         codes_card_equal_cpu=True, chunk=q.shape[1], mean_err=err,
         delta_amax=amax, ring_tolerance=tol, sync_wall_ms=ms[0],
         sync_device_ms=ms[1])
    del eng, state, seen, d, q, s, qc, sc, mean
    torch.cuda.empty_cache()
    return counts


def phase_train_card_vs_cpu(torch, np):
    """ViT-B widths at 2 layers, W = 2, 2 images of 224^2 each, one round of
    H = 2: the same weights and batches on the card (kernels) and on the
    CPU (plain versions)."""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync
    from repro_torch.models import api, param as pm

    cfg, run, _, batch_fn, _ = train_setup(torch, n_layers=2, workers=2,
                                           b_loc=2, schedule="constant",
                                           total_steps=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    card_p = pm.init_params(api.get_module(cfg).param_defs(cfg), gen,
                            device="cuda")
    host_p = T.map(lambda x: x.cpu(), card_p)
    states = {"cuda": LU.init_state(cfg, run, card_p, 2),
              "cpu": LU.init_state(cfg, run, host_p, 2)}
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    sync = make_sync(run)
    losses = {"cuda": [], "cpu": []}
    for t in range(2):
        batch = batch_fn(t)
        for dev in ("cuda", "cpu"):
            b = T.map(lambda x: x.to(dev), batch)
            states[dev], (loss, _) = step_fn(states[dev], b, 6e-3)
            losses[dev].append(float(loss))
    with torch.no_grad():
        for dev in states:
            states[dev] = sync(states[dev])
    # losses: fp32 sums in another order, ~1e-6 relative; 1e-4 stated.
    # params after 2 AdamW steps: m / sqrt(v) flips where a gradient element
    # sits at the sum-order noise, so a few elements in 1e4 may move by up to
    # 2 lr per step differently: at most 1 in 2,000 beyond 1e-5, none beyond
    # 4 lr.
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    check(loss_err <= 1e-4, f"card vs CPU loss rel err {loss_err}")
    worst, n_off, n_all = 0.0, 0, 0
    for a, b in zip(T.leaves(states["cuda"]["params"]),
                    T.leaves(states["cpu"]["params"])):
        d = (a.cpu() - b).abs()
        off = int((d > 1e-5 * (1 + b.abs())).sum())
        check(off <= max(1, b.numel() // 2000),
              f"card vs CPU: {off} of {b.numel()} elements beyond 1e-5")
        worst = max(worst, float(d.max()))
        n_off, n_all = n_off + off, n_all + b.numel()
    check(worst <= 4 * 6e-3, f"card vs CPU params differ by {worst}")
    emit("train_card_vs_cpu", layers=cfg.n_layers, d_model=cfg.d_model,
         workers=2, b_loc=2, image=IMAGE, steps=2, losses_card=losses["cuda"],
         losses_cpu=losses["cpu"], max_loss_rel_err=loss_err,
         max_param_abs_err=worst, params_beyond_1e5=n_off, params=n_all)
    del states, card_p
    torch.cuda.empty_cache()


def phase_train_card_vs_cpu_overlap(torch, np):
    """sync="overlap" at depth 1 (int8 sync, outer momentum 0.9), ViT-B
    widths at 2 layers, W = 2, 2 images of 224^2 each, 2 rounds of H = 2 and
    the flush: the card (kernels, AdamW in place) against the CPU (plain
    versions) from the same weights.  Had the boundary params not been
    cloned before the stale step, the card's correction would collapse
    every lane onto the consensus and lose that step.  Same rules as
    `train_card_vs_cpu` on losses and the largest difference; the int8
    sync turns AdamW's sum-order noise into whole code levels where a
    delta sits near a rounding boundary, so the count is held at 1 in 100
    elements beyond 1e-5 (not 1 in 2,000) and the relative L2 within 1e-3.
    A lost stale step moves nearly every element."""
    from repro_torch import tree as T
    kw = dict(n_layers=2, workers=2, b_loc=2, layout="flat",
              schedule="constant", total_steps=4, sync_quantize=True,
              outer_momentum=0.9, sync="overlap", overlap_depth=1)
    cfg, _, _, _, eng_c = train_setup(torch, **kw)
    _, _, _, _, eng_h = train_setup(torch, device="cpu", **kw)
    card = eng_c.init_state()
    states = {"cuda": card,
              "cpu": T.map(lambda x: x.to("cpu", copy=True), card)}
    lr = 6e-3
    losses = {"cuda": [], "cpu": []}
    for dev, eng in (("cuda", eng_c), ("cpu", eng_h)):
        st = states[dev]
        for t in (0, 2):
            st, m = eng.run_round(st, t, 2, lambda i: lr)
            losses[dev].append(float(m["loss"]))
        states[dev] = eng.flush(st)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    a = states["cuda"]["params"]["float32"].cpu()
    b = states["cpu"]["params"]["float32"]
    d = (a - b).abs()
    off = int((d > 1e-5 * (1 + b.abs())).sum())
    worst, rel_l2 = float(d.max()), float(d.norm() / b.norm())
    emit("train_card_vs_cpu_overlap", layers=cfg.n_layers,
         d_model=cfg.d_model, workers=2, b_loc=2, image=IMAGE, depth=1,
         outer_momentum=0.9, losses_card=losses["cuda"],
         losses_cpu=losses["cpu"], max_loss_rel_err=loss_err,
         max_param_abs_err=worst, param_rel_l2=rel_l2,
         params_beyond_1e5=off, params=b.numel())
    check(loss_err <= 1e-4, f"overlap card vs CPU loss rel err {loss_err}")
    check(off <= b.numel() // 100,
          f"overlap card vs CPU: {off} of {b.numel()} elements beyond 1e-5")
    check(rel_l2 <= 1e-3, f"overlap card vs CPU params rel L2 {rel_l2}")
    check(worst <= 4 * lr, f"overlap card vs CPU params differ by {worst}")
    del states, card, eng_c, eng_h
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import common  # noqa: F401  (turns TF32 off)

    smi = nvidia_smi()
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    build.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.build_seconds,
         sources=[str(p.relative_to(ROOT)) for p in build.sources()],
         ptxas=[ln.strip() for ln in build.ptxas_log.splitlines()
                if "entry function" in ln or "registers" in ln
                or "spill" in ln])
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    max_len = max(PROMPT_LENS) + MAX_NEW
    timed = phase_kernels(torch, max_len)
    timed.update(phase_training_kernels(torch))
    timed.update(phase_sync_kernels(torch))
    counts = {}
    serve = phase_service(torch, np)
    counts.update({k: serve[k] for k in SERVING_KERNELS})
    phase_card_vs_cpu(torch, np)
    phase_hot_swap(torch, np)
    trained = phase_train(torch, np)
    counts.update({k: trained[k] for k in TRAINING_KERNELS[:3]})
    flat, flat_state = phase_train_flat_quantized(torch, np)
    counts["sync_flat_update"] = flat["sync_flat_update"]
    phase_train_card_vs_cpu(torch, np)
    # the sync variants: each path's counts at 0 just before it, read after
    overlap = phase_train_overlap(torch, np, flat_state)
    del flat_state
    partial = phase_train_partial(torch, np)
    ring = phase_train_ring(torch, np)
    counts["sync_apply_update"] = (overlap["sync_apply_update"]
                                   + partial["sync_apply_update"]
                                   + ring["sync_apply_update"])
    counts.update({k: ring[k] for k in ("ring_combine", "ring_quantize")})
    phase_train_card_vs_cpu_overlap(torch, np)
    check(all(counts[k] > 0 for k in SOURCES),
          f"a kernel of a path never launched: {counts}")

    emit("attention_vs_cuda_core", **{name: dict(
        ms=timed[name]["ms"], cuda_core_ms=CUDA_CORE_MS[name],
        library_ms=timed[name]["library_ms"],
        bound_ms=timed[name]["bound_ms"],
        bound_fp32_ms=timed[name]["bound_fp32_ms"],
        speedup_vs_cuda_core=CUDA_CORE_MS[name] / timed[name]["ms"],
        speedup_vs_library=timed[name]["library_ms"] / timed[name]["ms"])
        for name in CUDA_CORE_MS})
    kernels = []
    for name in SERVING_KERNELS + TRAINING_KERNELS + SYNC_KERNELS:
        t = timed[name]
        extra = {key: t[key] for key in ("bound_fp32_ms", "bound_fp32_by")
                 if key in t}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], **extra))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
