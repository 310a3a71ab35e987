#!/usr/bin/env python3
"""How often chip_smoke's `profile_device_ms` loses kernel records of the
call it profiles, with and without the host's wait at the capture window's
edges (`PROFILE_MARGIN_S`).

    python3 tools/profile_window.py [--profiles N]

For `rms_norm_bwd` at [1024, 2560] and [1024, 8192] (chip_smoke's rows),
profiles 5 calls back to back N times (default 150) with the wait at 0,
at chip_smoke's value, then at 0 again, and counts the profiles that saw
other than 5 launches.  Each profile also reports the offset of its first
kernel's start from the start of its first launch call, on the profiler's
clock (a kernel cannot start before its launch: a negative offset is the
error of mapping device time onto the host's clock).  Prints one JSON line
a setting, then the card's name and power limit.  Needs one CUDA card.
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
    ap.add_argument("--profiles", type=int, default=150)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from repro_torch.kernels import rmsnorm as _rn

    # keep the events of the last profile, so that its offset can be read
    real_profile = torch.profiler.profile
    last = {}

    class Kept(real_profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            last["events"] = self.events()
            return out

    torch.profiler.profile = Kept
    margin_s = cs.PROFILE_MARGIN_S
    g = torch.Generator(device="cuda").manual_seed(1)
    for d in (2560, 8192):
        x, sc, dy = (torch.randn(*s, device="cuda", generator=g)
                     for s in ((1024, d), (d,), (1024, d)))

        def fn():
            return [_rn.rms_norm_bwd(x, sc, dy) for _ in range(5)]

        fn()
        torch.cuda.synchronize()
        for margin in (0.0, margin_s, 0.0):
            cs.PROFILE_MARGIN_S = margin
            counts, offsets = [], []
            for _ in range(args.profiles):
                prof = cs.profile_device_ms(torch, fn, count=("rmsnorm_bwd",))
                counts.append(prof["calls"]["rmsnorm_bwd"])
                ev = last["events"]
                ks = [e.time_range.start for e in ev
                      if e.device_type == DeviceType.CUDA
                      and "rmsnorm_bwd" in e.name]
                ls = [e.time_range.start for e in ev
                      if e.device_type == DeviceType.CPU
                      and "LaunchCooperativeKernel" in e.name]
                if ks and ls:
                    offsets.append(min(ks) - min(ls))
            print(json.dumps(dict(
                shape=[1024, d], margin_s=margin, profiles=len(counts),
                lost=sum(c != 5 for c in counts),
                launches_seen={c: counts.count(c) for c in sorted(set(counts))},
                first_kernel_offset_us=dict(
                    min=min(offsets), median=statistics.median(offsets),
                    max=max(offsets)) if offsets else None)), flush=True)
    cs.PROFILE_MARGIN_S = margin_s
    torch.profiler.profile = real_profile
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
