"""Serving driver (port of `repro/launch/serve.py`).  Two modes:

  * one-shot batched `generate`: prefill every prompt in one full-sequence
    pass, then one `decode_step` per new token —
      PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
          --batch 4 --prompt-len 32 --gen 16
  * the continuous-batching service loop (`--slots N`): requests flow
    through `launch/batching.py` —
      PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
          --slots 2 --batch 4 --gen 16

Both serve `--batch` requests of `--prompt-len` random tokens on the card,
with weights drawn on the device from `--seed`.  In one-shot mode a VLM
(paligemma-3b) gets a stub image prefix (`image_prefix`) and an audio
model (whisper-base) stub frames (`audio_frames`); the service loop serves
the decoder families (dense, moe, ssm) and refuses vlm, audio and vision
configs, as
the reference's does (the batcher carries no per-request extras), and
the hybrid family (zamba2), whose decode step takes one position for the
whole batch (the reference's batcher fails on its first step there).
The MoE family (dbrx-132b, kimi-k2-1t-a32b) runs both modes with the
global dispatch; in the service loop every lane's token, a retired one's
too, takes expert capacity, so lanes share it, as in the reference.
`--smoke` takes the arch's smoke config, `--device cpu` runs the plain
versions on the CPU (the default is CUDA, and no card is an error).
With `--slots`: `--watch DIR` polls DIR between decode steps for weights
a training run published there (`launch/weights.py publish_weights`,
for example from `train(..., async_observer=True)`) and hot-swaps them; `--swap-demo` publishes fresh
weights into the watch dir (a temporary one without `--watch`) mid-decode;
`--audit FILE` writes the swap-epoch audit trail as JSON.  `--window W`
serves one-shot `generate` from a ring-buffer KV cache of at most W rows a
layer (a sliding-window layer keeps its own window); with `--slots` it
raises, since ragged positions and a ring cache do not go together (the
reference's service loop ignores the flag).
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import registry as R
from repro_torch.errors import ConfigError
from repro_torch.launch import weights as W
from repro_torch.launch.batching import (HYBRID_SLOTS, ContinuousBatcher,
                                         Request)
from repro_torch.models import api


def generate(cfg, params, prompts, *, gen_len: int, max_len: int | None = None,
             window_override: int = 0, temperature: float = 0.0,
             seed: int = 0, extra: dict | None = None) -> torch.Tensor:
    """prompts [B, P] int -> tokens [B, P + gen_len] (int32, on the params'
    device).

    params: the model tree (for example `ServingWeights.as_tree()`); the
    prompts, and `extra` (prefill's keyword inputs: a VLM's
    `prefix_embeds` [B, n_img_tokens, D], an audio model's `frames` [B,
    enc_seq, D]), move to its device.  A VLM's prefix takes the cache's
    first `n_img_tokens` rows: it counts in the default `max_len` and in
    every decode position, as the reference's.  `window_override > 0`
    caps the KV cache (`init_cache`); when that leaves it shorter than
    `max_len` it is a ring buffer the decode steps wrap around, and only
    the prefill, which writes the prefix and prompt whole from row 0, must
    fit it.  Greedy at temperature 0; above it, one categorical draw per
    row and step from a `torch.Generator` seeded with `seed` — the
    reference's distribution, not its samples (`jax.random` has no twin).
    Runs without autograd.

    The SSM families (mamba2, zamba2) prefill the prompt in SSD chunks of
    `min(ssm_chunk, P)` tokens: a prompt of fewer than `ssm_conv - 1` (3)
    tokens, or one longer than `ssm_chunk` (256 in the full configs) whose
    length it does not divide, raises ShapeError before any layer runs.
    mamba2's state has no sequence axis, so it takes no max_len or ring;
    zamba2's shared block keeps a KV cache (`attn_k`) like a transformer's."""
    mod = api.get_module(cfg)
    dev = next(iter(params["embed"].values())).device
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    extra = {k: torch.as_tensor(v, device=dev)
             for k, v in (extra or {}).items()}
    b, plen = prompts.shape
    prefix_len = cfg.n_img_tokens if cfg.family == "vlm" else 0
    need = plen + prefix_len + gen_len
    max_len = max_len or need
    cache = mod.init_cache(cfg, b, max_len, device=dev,
                           window_override=window_override)
    kv_len = None                # an SSM's state has no sequence axis
    for key in ("k", "attn_k"):
        if key in cache:
            kv_len = cache[key].shape[2]
    ring = window_override > 0 and kv_len is not None and kv_len < max_len
    if not ring and kv_len is not None and need > kv_len:
        raise ValueError(
            f"prompt ({plen}) + prefix ({prefix_len}) + gen_len ({gen_len}) "
            f"= {need} tokens exceed the KV cache length {kv_len}; raise "
            "max_len or serve with a ring window")
    if ring and plen + prefix_len > kv_len:
        raise ValueError(
            f"prompt ({plen}) + prefix ({prefix_len}) = "
            f"{plen + prefix_len} tokens exceed the ring KV cache length "
            f"{kv_len}: the prefill writes them whole from row 0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [prompts.to(torch.int32)]
    with torch.no_grad():
        logits, cache = mod.prefill(cfg, params, prompts, cache, **extra)
        for i in range(gen_len):
            if temperature > 0:
                probs = torch.softmax(logits / temperature, -1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, -1)
            tok = tok.to(torch.int32)
            out.append(tok[:, None])
            logits, cache = mod.decode_step(cfg, params, tok, cache,
                                            plen + prefix_len + i,
                                            prefix_len=prefix_len, ring=ring)
    return torch.cat(out, 1)


def image_prefix(cfg, batch: int, device) -> dict:
    """The one-shot CLI's stub image prefix for a VLM: {"prefix_embeds":
    0.02 · normal [batch, n_img_tokens, D]} from a generator seeded with 2
    (the reference's `PRNGKey(2)`: its distribution, not its bits); {} for
    any other family."""
    if cfg.family != "vlm":
        return {}
    gen = torch.Generator(device=device).manual_seed(2)
    return {"prefix_embeds": 0.02 * torch.randn(
        (batch, cfg.n_img_tokens, cfg.d_model), generator=gen,
        device=device)}


def audio_frames(cfg, batch: int, device) -> dict:
    """The one-shot CLI's stub frames for an audio model: {"frames": 0.1 ·
    normal [batch, enc_seq, D]} from a generator seeded with 3 (the
    reference's `PRNGKey(3)`: its distribution, not its bits); {} for any
    other family."""
    if cfg.family != "audio":
        return {}
    gen = torch.Generator(device=device).manual_seed(3)
    return {"frames": 0.1 * torch.randn(
        (batch, cfg.enc_seq, cfg.d_model), generator=gen, device=device)}


def run_service(cfg, weights, prompts, *, slots: int, max_new: int,
                max_len: int | None = None, temperature: float = 0.0,
                seed: int = 0, subscriber=None, hooks=(),
                max_steps: int = 100_000):
    """Drive the continuous-batching service loop to completion.

    weights: a `ServingWeights` (its device is the run's).  prompts: list of
    [P] int arrays, one request each.  hooks: iterable of (step_index,
    fn(batcher)) one-shot callbacks fired after that many decode steps —
    `--swap-demo` uses one to publish new weights mid-decode.  Returns
    (requests, audit dict)."""
    max_len = max_len or (max(len(p) for p in prompts) + max_new)
    batcher = ContinuousBatcher(cfg, weights, slots=slots, max_len=max_len,
                                temperature=temperature, seed=seed,
                                subscriber=subscriber)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    pending = sorted(hooks, key=lambda h: h[0])
    steps = 0
    while steps < max_steps:
        n = batcher.step()
        steps += 1
        while pending and pending[0][0] <= steps:
            pending.pop(0)[1](batcher)
        if n == 0 and not batcher.queue and not pending:
            break
    audit = {
        "arch": cfg.name,
        "family": cfg.family,
        "device": str(batcher.device),
        "slots": slots,
        "decode_steps": batcher.decode_steps,
        "tokens_emitted": batcher.tokens_emitted,
        "swaps": batcher.swaps,
        "swap_epochs": batcher.weights.audit(),
        "requests": [{"rid": r.rid, "prompt_len": len(r.prompt),
                      "tokens": len(r.out), "epochs": r.epochs}
                     for r in reqs],
    }
    return reqs, audit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help="ring-buffer KV window (long-context serving; "
                         "one-shot mode only)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots of the continuous-batching loop")
    ap.add_argument("--watch", default=None,
                    help="poll this dir for published serving checkpoints "
                         "and hot-swap them between decode steps")
    ap.add_argument("--audit", default=None,
                    help="write the swap-epoch audit JSON here")
    ap.add_argument("--swap-demo", action="store_true",
                    help="publish fresh weights into the watch dir "
                         "mid-decode and hot-swap them")
    args = ap.parse_args(argv)
    if args.slots > 0 and args.window > 0:
        raise ConfigError("--window with --slots: the service loop's ragged "
                          "positions do not run on a ring cache; serve "
                          "--window one-shot (without --slots)")

    cfg = R.get_smoke_config(args.arch) if args.smoke else R.get_config(args.arch)
    if args.slots > 0 and cfg.family in ("vlm", "audio", "vision"):
        raise SystemExit(f"--slots serves decoder families; {cfg.family} "
                         "prompts need per-request extras the batcher does "
                         "not carry yet")
    if args.slots > 0 and cfg.family == "hybrid":
        raise SystemExit(HYBRID_SLOTS)
    weights = W.ServingWeights.from_seed(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len, dtype=np.int32)
               for _ in range(args.batch)]
    if weights.device.type == "cuda":
        from repro_torch.kernels import build
        build.library()       # set-up: build/load the kernels before timing
    if args.slots <= 0:
        return _generate_main(cfg, weights, np.stack(prompts), args)
    watch, own_watch = args.watch, False
    if args.swap_demo and watch is None:
        watch, own_watch = tempfile.mkdtemp(prefix="repro-serve-watch-"), True
    try:
        reqs, audit, dt = _service(cfg, weights, prompts, watch, args)
    finally:
        if own_watch:
            shutil.rmtree(watch, ignore_errors=True)
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) with {args.slots} slots on "
          f"{weights.device}; decode_steps={audit['decode_steps']} "
          f"swaps={audit['swaps']}")
    if args.swap_demo and audit["swaps"] < 1:
        raise SystemExit("--swap-demo: no swap happened (requests finished "
                         "before the publish hook fired)")
    for r in reqs[:2]:
        print(f"  rid={r.rid} tokens={r.out[:8]}... epochs={r.epochs[:8]}...")
    if args.audit:
        with open(args.audit, "w") as f:
            json.dump(audit, f, indent=2)
        print(f"swap-epoch audit -> {args.audit}")
    return audit


def _service(cfg, weights, prompts, watch, args):
    """The --slots loop, subscribed to `watch` (if any); with --swap-demo a
    hook publishes fresh weights there mid-decode, as a training run
    would.  Returns (requests, audit, wall seconds)."""
    sub = None
    hooks = []
    if watch is not None:
        sub = W.WeightSubscriber(watch_dir=watch, like=W.params_like(cfg))
    if args.swap_demo:
        fresh = W.ServingWeights.from_seed(cfg, args.seed + 17,
                                           device=weights.device).as_tree()
        # fire after the first requests have cleared slot-local prefill and
        # emitted a few tokens, so the swap lands mid-sequence and the audit
        # shows tokens on both sides of it
        trigger = args.prompt_len + max(2, args.gen // 2)
        hooks.append((trigger, lambda b: W.publish_weights(
            watch, fresh, step=1, extra={"demo": True})))
    t0 = time.perf_counter()
    reqs, audit = run_service(cfg, weights, prompts, slots=args.slots,
                              max_new=args.gen, temperature=args.temperature,
                              seed=args.seed, subscriber=sub, hooks=hooks)
    return reqs, audit, time.perf_counter() - t0


def _generate_main(cfg, weights, prompts, args):
    """The one-shot entry: returns the tokens [B, P + gen] on the host."""
    extra = {**image_prefix(cfg, len(prompts), weights.device),
             **audio_frames(cfg, len(prompts), weights.device)}
    t0 = time.perf_counter()
    toks = generate(cfg, weights.as_tree(), prompts, gen_len=args.gen,
                    window_override=args.window,
                    temperature=args.temperature, seed=args.seed,
                    extra=extra).cpu()
    dt = time.perf_counter() - t0
    print(f"generated {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {weights.device}")
    print("sample:", toks[0, :args.prompt_len + 8].tolist())
    return toks


if __name__ == "__main__":
    main()
