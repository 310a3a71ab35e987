#!/usr/bin/env python3
"""Digests of `flash_decode`'s outputs at GQA groups of 1-8, from the
kernel sources of this checkout or of another directory.

    python3 tools/decode_digests.py [CSRC_DIR ...]

Builds the kernel library from each CSRC_DIR (a copy of
`src/repro_torch/kernels/csrc/`, for example an earlier commit's, written
out with `git archive REV src/repro_torch/kernels/csrc | tar -x -C DIR`),
or from this checkout's sources when none is given, into its own directory
under `src/repro_torch/kernels/_build/digests/` (git ignores it), runs
`flash_decode` on the cases of `tests/test_torch_cuda.py`
`decode_digest_cases` and prints one JSON line per source: the sha256
(first 16 hex digits) of each output, keyed "g,d,sk", and whether every
digest equals the test's `DECODE_DIGESTS`.  Then the card's name and power
limit.  Needs one CUDA card.
"""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_digests: no CUDA device", file=sys.stderr)
        return 1
    import test_torch_cuda as tc
    from repro_torch.kernels import build

    cases = tc.decode_digest_cases()
    for src in argv or [str(build.CSRC)]:
        src = Path(src).resolve()
        build.CSRC = src
        build.BUILD_DIR = (ROOT / "src/repro_torch/kernels/_build/digests" /
                           hashlib.sha256(str(src).encode()).hexdigest()[:8])
        build._lib = None
        build.library()
        got = {f"{g},{d},{sk}": tc.decode_digest(*case)
               for (g, d, sk), case in cases.items()}
        want = {f"{g},{d},{sk}": x for (g, d, sk), x in
                tc.DECODE_DIGESTS.items()}
        print(json.dumps({"source": os.path.relpath(src, ROOT),
                          "digests": got, "equal_to_test": got == want}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
