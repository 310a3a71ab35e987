"""Serving driver: the continuous-batching service loop (port of
`repro/launch/serve.py`, `--slots N` mode).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --slots 2 --batch 4 --gen 16

serves `--batch` requests of `--prompt-len` random tokens through
`--slots` decode slots on the card, with weights drawn on the device from
`--seed`.  `--smoke` takes the arch's smoke config, `--device cpu` runs the
plain versions on the CPU (the default is CUDA, and no card is an error),
`--swap-demo` publishes fresh weights in process mid-decode and hot-swaps
them, and `--audit FILE` writes the swap-epoch audit trail as JSON.

The one-shot batched `generate` of the reference waits for the next slice:
its prefill is full-sequence attention, the `flash_attention` kernel.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import registry as R
from repro_torch.launch import weights as W
from repro_torch.launch.batching import ContinuousBatcher, Request


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots of the continuous-batching loop")
    ap.add_argument("--audit", default=None,
                    help="write the swap-epoch audit JSON here")
    ap.add_argument("--swap-demo", action="store_true",
                    help="publish fresh weights in process mid-decode and "
                         "hot-swap them")
    args = ap.parse_args(argv)
    if args.slots <= 0:
        raise SystemExit("one-shot generate is not ported yet (its prefill "
                         "needs the flash_attention kernel); use --slots N")

    cfg = R.get_smoke_config(args.arch) if args.smoke else R.get_config(args.arch)
    weights = W.ServingWeights.from_seed(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len, dtype=np.int32)
               for _ in range(args.batch)]
    sub = None
    hooks = []
    if args.swap_demo:
        sub = W.WeightSubscriber()
        # fire after the first requests have cleared slot-local prefill and
        # emitted a few tokens, so the swap lands mid-sequence and the audit
        # shows tokens on both sides of it
        trigger = args.prompt_len + max(2, args.gen // 2)
        hooks.append((trigger, lambda b: sub.publish(1, W.ServingWeights.from_seed(
            cfg, args.seed + 17, device=weights.device).as_tree())))

    if weights.device.type == "cuda":
        from repro_torch.kernels import build
        build.library()       # set-up: build/load the kernels before timing
    t0 = time.perf_counter()
    reqs, audit = run_service(cfg, weights, prompts, slots=args.slots,
                              max_new=args.gen, temperature=args.temperature,
                              seed=args.seed, subscriber=sub, hooks=hooks)
    dt = time.perf_counter() - t0
    audit["wall_seconds"] = dt
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


if __name__ == "__main__":
    main()
