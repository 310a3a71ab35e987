#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each against its plain PyTorch version at the serving path's full-width
shapes, serves gemma3-4b at full width (random weights drawn on the card
from a seed) through the continuous-batching loop, compares the card with
the CPU at full width and 2 layers, checks a hot weight swap, and prints one
JSON line per phase.  Any mismatch or error raises, so the exit code is not
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
ARCH = "gemma3-4b"
SLOTS, MAX_NEW = 2, 16
PROMPT_LENS = (16, 48, 32, 24)        # 4 requests, 16-48 tokens: slots recycle
TOL = {"rms_norm": 1e-5, "swiglu": 2e-5, "flash_decode": 2e-5}  # x max|plain|
REPLACES = {
    "rms_norm": "src/repro/kernels/rmsnorm.py:36",
    "swiglu": "src/repro/kernels/swiglu.py:44",
    "flash_decode": "src/repro/kernels/flash_attention.py:239",
}
SOURCES = {
    "rms_norm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "swiglu": "src/repro_torch/kernels/csrc/swiglu.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
}


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = TOL[name] * max(scale, 1.0)
        row = dict(kernel=name, shape=label, main_path_shape=main,
                   max_abs_err=err, max_rel_err=err / max(scale, 1e-30),
                   tol=tol)
        check(err <= tol, f"{name} {label}: max abs err {err} > tol {tol}")
        if timed:
            lib = library_call(torch, name, a)
            lib_err = float((lib() - want).abs().max())
            nbytes, flops = work(torch, name, a)
            b_ms, b_by = bound_ms(nbytes, flops)
            row.update(
                ms=timer(lambda: run_kernel(torch, ops.KERNELS, name, a)),
                plain_ms=timer(lambda: run_kernel(torch, {name: plain},
                                                  name, a)),
                library_ms=timer(lib), library_max_abs_err=lib_err,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
            row["bound_share"] = b_ms / row["ms"]
            if main:
                summary[name] = row
        emit("kernel_check", **row)
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
    want = {"rms_norm": (2 * cfg.n_layers + 1) * steps,
            "swiglu": cfg.n_layers * steps,
            "flash_decode": cfg.n_layers * steps}
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
    regs = [ln.strip() for ln in build.ptxas_log.splitlines()
            if "registers" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.build_seconds,
         sources=[str(p.relative_to(ROOT)) for p in build.sources()],
         ptxas=regs)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    max_len = max(PROMPT_LENS) + MAX_NEW
    timed = phase_kernels(torch, max_len)
    counts = phase_service(torch, np)
    phase_card_vs_cpu(torch, np)
    phase_hot_swap(torch, np)

    kernels = []
    for name in ("flash_decode", "rms_norm", "swiglu"):
        t = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
