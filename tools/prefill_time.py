#!/usr/bin/env python3
"""Device time of chip_smoke's gemma3-4b prefill (34 layers at full width,
weights from seed 0, 4 x 1024 tokens) in one process, for comparing two
trees of the port on one card.

    python3 tools/prefill_time.py [--root DIR] [--import-dynamo] [--calls N]

`--root`: the tree whose `src/repro_torch` runs (default this checkout),
for example an earlier commit unpacked with `git archive REV | tar -x -C
DIR`; its kernels build under its own `src/repro_torch/kernels/_build/`.
`--import-dynamo` imports `torch._dynamo` before the port (a server's
modules do not; the training step's does, and so does torch.profiler on
its first use: `dynamo_loaded` says whether it was loaded while the timed
calls ran).  After one warm-up, N prefills (default 10) are timed one by
one with CUDA events around each call, as chip_smoke times its one; then
one call is profiled: the sum of its kernels' device times and its device
span (first kernel's start to last one's end), so that a slower call can
be told apart as slower kernels or as gaps between them.  Prints one JSON
line, then the card's name and power limit.  Runs from two roots in turns
(A B B A) compare them.  Needs one CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--import-dynamo", action="store_true")
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefill_time: no CUDA device", file=sys.stderr)
        return 1
    if args.import_dynamo:
        import torch._dynamo  # noqa: F401
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as R
    from repro_torch.launch import weights as W
    from repro_torch.models import api, common  # noqa: F401  (TF32 off)

    cfg = R.get_config("gemma3-4b")
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    mod = api.get_module(cfg)
    tree = weights.as_tree()
    rng = np.random.default_rng(9)
    pt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1024),
                                       dtype=np.int32)).cuda()
    cache = mod.init_cache(cfg, 4, 1024, device="cuda")
    times = []
    with torch.no_grad():
        mod.prefill(cfg, tree, pt, cache)          # warm-up
        torch.cuda.synchronize()
        for _ in range(args.calls):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            mod.prefill(cfg, tree, pt, cache)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        dynamo_loaded = "torch._dynamo" in sys.modules
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mod.prefill(cfg, tree, pt, cache)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(json.dumps(dict(
        root=os.path.relpath(root, ROOT), import_dynamo=args.import_dynamo,
        dynamo_loaded=dynamo_loaded, device_ms=times,
        median_ms=statistics.median(times),
        profiled_kernel_ms=sum(e.time_range.elapsed_us() for e in kernels)
        / 1e3,
        profiled_span_ms=(max(e.time_range.end for e in kernels)
                          - min(e.time_range.start for e in kernels)) / 1e3)),
        flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
